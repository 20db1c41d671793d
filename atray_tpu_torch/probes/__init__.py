"""The lane-routing probes on the card: the port's counterparts of the TPU
probe scripts ``scripts/probe_r18.py``-``probe_r22.py``.

Each script asks what one piece of the lane take's TPU design costs; each
module here asks the same question of this card, over a hand-written kernel
in ``csrc/`` with its plain PyTorch version beside it:

- ``probe_r18`` (P1-P3) and ``probe_r19`` (P4, P5), ``csrc/probe_dot.cu``:
  one block's cost of a small matrix product, by orientation, type,
  contraction width and independence;
- ``probe_r20`` (P6-P9), ``csrc/probe_route.cu``: one routing step of a
  loop with a run-time bound, piece by piece;
- ``probe_r21`` (P10), ``csrc/probe_take_rm.cu``: the take over a ray-major
  layout, against ``csrc/lane_take.cu``'s plane-major one;
- ``probe_r22`` (P11), ``csrc/probe_stream_take.cu``: the take with source
  rows staged through shared memory, bisected into full, no-copy and
  no-compute runs, against the direct gather.

Run one on the card with ``python -m atray_tpu_torch.probes.probe_r20``: it
prints the card's name and power limit, then the script's table. Nothing
runs at import.
"""
