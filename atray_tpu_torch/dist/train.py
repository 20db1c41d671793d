"""Inverse rendering (``atray_tpu/dist/train.py``): optimize scene
parameters (vertices, vertex normals, emission, albedo, scatter) from
target images by gradient descent, on one device or with the rays and
targets sharded over the ranks of a ``RayMesh``.

With a mesh every rank holds the global rays and targets (as
``trace_sharded`` does), traces its contiguous slice under its global ray
ids, and takes the gradient of its share of the loss; ``reduce_grads`` then
sums the loss and the gradients over the ranks with one ``all_reduce`` of a
flat buffer, the reference's ``psum``. Every rank applies the same
optimizer step to the same sums, so the replicated parameters stay equal on
every rank bit for bit.

Parameters are a ``SceneParams`` of leaf tensors; leaves that require grad
get gradients. The optimizer is a ``torch.optim.Adam`` with one parameter
group per learning rate; leaves the reference freezes
(``optax.set_to_zero``) are simply not in it. Train state (parameters,
Adam moments, step, seed) goes to an npz written with an atomic replace,
and per-step keys are ``fold_in(prng_key(seed), step)``, so a run killed
and resumed from its checkpoint reproduces the uninterrupted run.

Deliberate differences from the reference, which is one controller over
every device: here each rank is a process, so ``autograd.grad`` returns the
rank's own share and ``reduce_grads`` is an explicit step after it (the
reference's ``jax.grad`` inside ``shard_map`` returns reduced gradients);
and ``save_train_state`` writes from rank 0 only, then waits at a barrier,
while every rank reads the checkpoint.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from atray_tpu_torch.accel.shaded import ShadedWideBVH, refit_shaded
from atray_tpu_torch.accel.wide import refit_wide
from atray_tpu_torch.device import resolve_device
from atray_tpu_torch.dist.mesh import RayMesh, check_axis, shard_slice
from atray_tpu_torch.dist.multihost import process_info
from atray_tpu_torch.render.rng import fold_in, prng_key
from atray_tpu_torch.render.wavefront import _accel_on, trace_radiance
from atray_tpu_torch.scene.data import Scene, SceneParams


def reduce_grads(grads: Sequence[Optional[torch.Tensor]],
                 mesh: Optional[RayMesh]) -> List[Optional[torch.Tensor]]:
    """Each tensor of ``grads`` (float32; None passes through) summed over
    the mesh's ranks, in place of the reference's ``psum``: one
    ``all_reduce`` over a flat buffer of them all, so every rank gets the
    same sums bit for bit (gloo's ``all_reduce`` takes CUDA tensors, so
    two ranks sharing one card stage nothing). Without a mesh or a group,
    ``grads`` as given.
    Every rank must call it with the same shapes. Only replicated leaves
    are summed: a leaf that is sharded over the ranks (``TreeletShard``'s
    vertices and normals) already holds its whole gradient."""
    grads = list(grads)
    if mesh is None or mesh.group is None:
        return grads
    live = [g for g in grads if g is not None]
    if not live:
        return grads
    flat = torch.cat([g.detach().reshape(-1) for g in live])
    dist.all_reduce(flat, group=mesh.group)
    out, at = [], 0
    for g in grads:
        if g is None:
            out.append(None)
            continue
        out.append(flat[at:at + g.numel()].view(g.shape))
        at += g.numel()
    return out


def make_loss_and_grad(scene_template: Scene, bounce_limit: int, accel=None,
                       refit: bool = False, device=None, mesh: Optional[RayMesh] = None,
                       axis_name: str = "rays") -> Callable:
    """Returns ``f(params, orig, dirn, target, key) -> (loss, grads)``.

    orig, dirn and target are the global (N, 3) tensors on ``device``
    (None: the mesh's device, else "cuda"); the loss is
    ``sum((color - target)**2) / (3 N)``; ``grads`` is a ``SceneParams``
    holding the gradient of each leaf that requires grad (zeros where the
    trace does not reach it) and None for the others. With ``refit`` the accel (``WideBVH`` or ``ShadedWideBVH``) is
    recomputed from the current vertices at every evaluation, so the walk
    follows the moving geometry.

    With ``mesh`` (N must divide over its ranks) each rank traces its
    ``shard_slice`` of the rays under their global ids and differentiates
    its share of the loss; loss and gradients are then summed over the
    ranks (``reduce_grads``), so every rank returns the same full loss and
    gradients. Without a mesh, this device traces every ray."""
    if mesh is not None:
        check_axis(mesh, axis_name)
    dev = resolve_device(mesh.device if device is None and mesh is not None else device)
    template = scene_template.to(dev)
    accel = _accel_on(accel, dev)

    def loss_and_grad(params: SceneParams, orig, dirn, target, key):
        leaves = params.leaves()
        wrt = [p for p in leaves if p.requires_grad]
        n = orig.shape[0]
        part = slice(0, n) if mesh is None else shard_slice(n, mesh)
        with torch.enable_grad():
            scene = template.with_params(params)
            acc = accel
            if refit and accel is not None:
                if isinstance(accel, ShadedWideBVH):
                    acc = refit_shaded(accel, scene)
                else:
                    acc = refit_wide(accel, scene.mesh.vertices, scene.mesh.faces)
            ids = torch.arange(part.start, part.stop, dtype=torch.int32, device=dev)
            color = trace_radiance(scene, orig[part], dirn[part], bounce_limit, key, accel=acc,
                                   ray_ids=ids)
            loss = torch.sum((color - target[part]) ** 2) / (3.0 * n)
            grads = torch.autograd.grad(loss, wrt, allow_unused=True) if wrt else ()
            # a leaf the trace does not reach (scatter at 2 bounces) gets
            # zeros, as the reference's gradient has them
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(wrt, grads)]
        loss, *grads = reduce_grads([loss.detach(), *grads], mesh)
        grads = iter(grads)
        return loss, SceneParams(*(next(grads) if p.requires_grad else None for p in leaves))

    return loss_and_grad


def _optimized(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def make_train_step(scene_template: Scene, bounce_limit: int, optimizer: torch.optim.Optimizer,
                    accel=None, refit: bool = False, device=None,
                    mesh: Optional[RayMesh] = None, axis_name: str = "rays") -> Callable:
    """Returns ``step(params, orig, dirn, target, key) -> loss``: one
    gradient evaluation and one optimizer step, updating the optimizer's
    leaves of ``params`` in place. With ``mesh`` the rays and targets are
    sharded over its ranks and the gradients summed
    (``make_loss_and_grad``); every rank steps on the same sums."""
    loss_grad = make_loss_and_grad(scene_template, bounce_limit, accel=accel, refit=refit,
                                   device=device, mesh=mesh, axis_name=axis_name)
    owned = {id(p) for p in _optimized(optimizer)}

    def step(params: SceneParams, orig, dirn, target, key):
        loss, grads = loss_grad(params, orig, dirn, target, key)
        for p, g in zip(params.leaves(), grads.leaves()):
            if id(p) in owned:
                p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss

    return step


def save_train_state(path: str, params: SceneParams, optimizer: torch.optim.Optimizer,
                     step: int, seed: int) -> None:
    """Checkpoint the full optimization state (parameter leaves, optimizer
    state, step, base seed) to an npz, written to a temporary file and
    moved into place, so a kill mid-write leaves the old checkpoint.
    Under a process group every rank calls it: rank 0 writes (the ranks'
    states are equal), then all wait at a barrier, so that no rank reads
    the file before it is whole."""
    rank, world = process_info()
    if rank == 0:
        _write_state(path, params, optimizer, step, seed)
    if world > 1:
        dist.barrier()


def _write_state(path: str, params: SceneParams, optimizer: torch.optim.Optimizer,
                 step: int, seed: int) -> None:
    payload = {f"p{i}": x.detach().cpu().numpy() for i, x in enumerate(params.leaves())}
    for i, st in optimizer.state_dict()["state"].items():
        for k, v in st.items():
            payload[f"o{i}_{k}"] = torch.as_tensor(v).detach().cpu().numpy()
    payload["step"] = np.int64(step)
    payload["seed"] = np.int64(seed)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)


def load_train_state(path: str, params: SceneParams,
                     optimizer: torch.optim.Optimizer) -> Optional[Tuple[int, int]]:
    """Restore ``save_train_state``'s checkpoint into ``params`` (copied
    into its leaves in place) and ``optimizer``; returns (step, seed), or
    None when there is no checkpoint. The template's shapes must match."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        leaves = params.leaves()
        for i, p in enumerate(leaves):
            got = z[f"p{i}"]
            if got.shape != tuple(p.shape):
                raise ValueError(f"checkpoint param leaf {i} shape {got.shape} != "
                                 f"template {tuple(p.shape)}")
        with torch.no_grad():
            for i, p in enumerate(leaves):
                p.copy_(torch.from_numpy(z[f"p{i}"]))
        sd = optimizer.state_dict()
        state = {}
        for i in range(len(_optimized(optimizer))):
            pre = f"o{i}_"
            entry = {k[len(pre):]: torch.from_numpy(z[k]) for k in z.files if k.startswith(pre)}
            if entry:
                state[i] = entry
        optimizer.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
        return int(z["step"]), int(z["seed"])


def run_training(step_fn: Callable, optimizer: torch.optim.Optimizer, params: SceneParams,
                 orig, dirn, target, num_steps: int, seed: int = 0,
                 checkpoint_path: Optional[str] = None, checkpoint_every: int = 10,
                 on_step: Optional[Callable] = None):
    """Drive ``step_fn`` for ``num_steps`` steps, checkpointing every
    ``checkpoint_every`` steps and resuming from ``checkpoint_path`` when
    it exists. Per-step keys are ``fold_in(prng_key(seed), step)``.
    Returns (params, the losses of the steps run here)."""
    start = 0
    if checkpoint_path:
        got = load_train_state(checkpoint_path, params, optimizer)
        if got is not None:
            start, seed = got
    base = prng_key(seed)
    losses = []
    for s in range(start, num_steps):
        loss = float(step_fn(params, orig, dirn, target, fold_in(base, s)))
        losses.append(loss)
        if checkpoint_path and (s + 1) % checkpoint_every == 0:
            save_train_state(checkpoint_path, params, optimizer, s + 1, seed)
        if on_step is not None:
            on_step(s, loss)
    if checkpoint_path and num_steps > start:
        save_train_state(checkpoint_path, params, optimizer, num_steps, seed)
    return params, losses
