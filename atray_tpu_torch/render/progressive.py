"""Progressive rendering with checkpoint and resume
(``atray_tpu/render/progressive.py``).

The film is accumulated over batches of samples. The accumulator (film
sum, batches done, samples a batch, seed) is written to an ``.npz`` after
every batch, under the reference's keys, so a stopped job resumes where it
stopped, and a checkpoint written by either package loads in the other.
Batch b renders with the key ``fold_in(prng_key(seed), b)``, the
reference's, so a resumed run equals one without a stop bit for bit, and
its films are the reference's. With a ray mesh every batch is a sharded
render (``render(mesh=)``, the reference's ``render_fn`` bound to a mesh):
every rank accumulates the same film, and rank 0 alone writes the
checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np

from atray_tpu_torch.config import RenderSettings
from atray_tpu_torch.core.camera import Camera
from atray_tpu_torch.core.threefry import fold_in, prng_key
from atray_tpu_torch.device import resolve_device
from atray_tpu_torch.render.wavefront import _accel_on, render
from atray_tpu_torch.scene.data import to_numpy


@dataclasses.dataclass
class FilmState:
    """The accumulator, on the host as numpy."""

    film_sum: np.ndarray      # (H, W, 3) running sum of the batch films
    batches_done: int
    spp_per_batch: int
    seed: int

    @property
    def spp_total(self) -> int:
        return self.batches_done * self.spp_per_batch

    def film(self) -> np.ndarray:
        if self.batches_done == 0:
            return np.zeros_like(self.film_sum)
        return np.clip(self.film_sum / self.batches_done, 0.0, 1.0)


def save_checkpoint(path: str, state: FilmState) -> None:
    """Write ``state`` to ``path`` through a temporary file and a rename,
    so a stop while writing leaves the last checkpoint whole."""
    tmp = path + ".tmp"
    np.savez(tmp, film_sum=state.film_sum, batches_done=state.batches_done,
             spp_per_batch=state.spp_per_batch, seed=state.seed)
    # numpy appends .npz to a name that lacks it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_checkpoint(path: str) -> Optional[FilmState]:
    """The state at ``path``, or None where there is no file."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return FilmState(film_sum=z["film_sum"], batches_done=int(z["batches_done"]),
                     spp_per_batch=int(z["spp_per_batch"]), seed=int(z["seed"]))


def render_progressive(scene, camera: Camera, settings: RenderSettings, total_spp: int,
                       accel=None, seed: int = 0, checkpoint_path: Optional[str] = None,
                       on_batch: Optional[Callable[[FilmState], None]] = None,
                       device=None, mesh=None) -> FilmState:
    """Render ``total_spp`` samples in batches of
    ``settings.samples_per_pixel`` on ``device`` (None: "cuda"), resuming
    from ``checkpoint_path`` where it holds a state and writing it after
    every batch. ``on_batch(state)`` runs after each batch (the live
    progress hook). ``mesh`` (a ``dist.mesh.RayMesh``) shards each batch's
    rays over its ranks, on the mesh's device; only its rank 0 writes."""
    spb = settings.samples_per_pixel
    nbatches = -(-total_spp // spb)
    state = load_checkpoint(checkpoint_path) if checkpoint_path else None
    if state is not None:
        if state.spp_per_batch != spb or state.seed != seed:
            raise ValueError("checkpoint was created with different spp_per_batch/seed")
    else:
        w, h = settings.resolution
        state = FilmState(film_sum=np.zeros((h, w, 3), np.float32), batches_done=0,
                          spp_per_batch=spb, seed=seed)
    # the scene and accel go to the card once, not once a batch
    dev = resolve_device(device) if mesh is None else mesh.device
    scene, accel = scene.to(dev), _accel_on(accel, dev)
    write = checkpoint_path and (mesh is None or mesh.rank == 0)
    base = prng_key(seed)
    for b in range(state.batches_done, nbatches):
        film = render(scene, camera, settings, fold_in(base, b), accel=accel, device=dev,
                      mesh=mesh)
        state.film_sum = state.film_sum + to_numpy(film)
        state.batches_done = b + 1
        if write:
            save_checkpoint(checkpoint_path, state)
        if on_batch is not None:
            on_batch(state)
    if write:
        save_checkpoint(checkpoint_path, state)
    return state
