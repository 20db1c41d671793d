"""The yardstick of the kernels: the card's published peaks and the bytes
a hit kernel's launch has to move, frozen from ``chip_smoke.py`` (its
``HBM_BYTES_PER_S``, ``_bound`` and the byte counts of phase 3's
``_compare_hits`` and phase 7's ``_exact_compare``).

A launch's least time is its bytes over the memory rate: each input and
output plane read or written once, and the accel's tables once. Only the
bytes bound is kept: the operations of a walk depend on the node pops and
records the rays need, which the window does not count.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # one H100 SXM, NVIDIA's data sheet, at 700 W


def wide_shade_bytes(rays: int, tables: int) -> int:
    """A ``wide_shade`` launch over ``rays`` lanes, all live (a dead lane
    reads only its alive byte): six float32 ray planes and the bool alive
    mask in, the t, id, normal and material planes out
    (six 4-byte planes), and ``tables`` bytes of ``cboxes``, ``clinks``,
    ``caxis`` and ``tris``."""
    return rays * (6 * 4 + 1 + 6 * 4) + tables


def wide_exact_bytes(rays: int, tables: int) -> int:
    """A ``wide_exact`` launch over ``rays`` rays: (R, 3) origins and
    directions in, t, u, v and the face id out, and ``tables`` bytes of
    ``cboxes``, ``clinks`` and ``tris``."""
    return rays * (2 * 3 * 4 + 4 * 4) + tables


def bound_s(nbytes: float) -> float:
    """The least seconds to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
