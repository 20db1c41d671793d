"""Training: pixel-loss gradient steps over scene parameters (one device)."""
