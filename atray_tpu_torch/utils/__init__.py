"""Run-time helpers: phase timers and device traces."""
