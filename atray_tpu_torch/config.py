"""Typed runtime configuration (copy of ``atray_tpu/config.py``).

Copied rather than imported: importing ``atray_tpu.config`` runs
``atray_tpu/__init__.py``, which imports jax. Field names and defaults are
the reference's, so a settings object reads the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Film and path-tracing options.

    resolution: (width, height) of the film.
    samples_per_pixel: stochastic samples averaged per pixel.
    bounce_limit: max path length (camera ray = bounce 0).
    anti_aliasing: jitter the film point within the pixel, by the bits of
        ``jax.random.uniform`` under the key's first split half.
    use_accel: read by the reference's command line only (whether it builds
        an accel); ``render`` traverses the accel it is given, and with
        ``accel=None`` tests every triangle by brute force.
    ray_chunk: trace rays in chunks of this many; 0 means one chunk.
    sort_bounces: one-shot compaction after the first diffuse bounce (dead
        rays last, live rays grouped by origin cell). Film-identical to the
        unsorted render: random numbers are keyed by global ray id.
    nee: next-event estimation: a shadow ray to one light a hit, picked from
        the spheres and the emissive triangles.
    lane_pack: on top of sort_bounces, pack live rays to a dense prefix with
        the lane-take kernel. Film-identical.
    pair_bounces: with a ``ShadedWideBVH`` that has a treelet view, the
        bounces after the camera bounce take the pair-binned traversal
        (``kernels/treelet_pairs.py``). Film-identical; other accels ignore
        it.
    """

    resolution: Tuple[int, int] = (1280, 720)
    samples_per_pixel: int = 5
    bounce_limit: int = 5
    anti_aliasing: bool = False
    use_accel: bool = True
    ray_chunk: int = 0
    sort_bounces: bool = True
    nee: bool = False
    lane_pack: bool = True
    pair_bounces: bool = False

    @property
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]


@dataclasses.dataclass(frozen=True)
class KDTreeConfig:
    """Acceleration-structure build options: leaf_size is the padded
    triangle count per leaf, sah_bins the split-search resolution,
    leaves_per_treelet the treelet granularity of ``tboxes``."""

    leaf_size: int = 4
    sah_bins: int = 16
    max_depth: int = 40
    leaves_per_treelet: int = 16


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape, parsed from a scene TOML's ``[mesh]`` table.
    ``num_devices`` 0 means no mesh (one process renders alone), -1 every
    rank of the process group, N > 0 a mesh of N ranks, which must be the
    world size (``dist.mesh.make_device_mesh``; a process is a rank in the
    port, where the reference's one controller takes N of its devices)."""

    num_devices: int = 0
    axis_name: str = "rays"
