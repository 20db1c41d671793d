"""The inverse-rendering job: a closed loop of optimizer steps of one
trainer (``atray_tpu_torch.dist.train.make_train_step``) over every ray
of its views, a new key each step, the loss read back after each step as
the job's loop does. Fits of ``episode_steps`` steps follow each other,
each from the same corrupted start with a fresh Adam state, so that every
window meets the same mix of steps: the refit widens the boxes by the
vertices' largest move, so a step costs more the longer a fit runs.
Set-up renders the target views from the true scene, corrupts the albedo
and the vertices (noise from the seed), builds the step with its Adam
state, and drives it through its first ``checked_steps`` steps; the
window continues the same object. A unit is a step.

The check follows the first fit that starts inside the measured window
(its restart of the parameters and of Adam's state included) through its
first ``checked_steps`` steps: the window keeps each step's loss, each
leaf's first gradient as the optimizer got it (its first moment after
the fit's first step over 1 - beta1) and each leaf's change after those
steps; where the window closes before they are done, the loop runs on,
untimed, until they are. The reference (its own camera rays, target
views, BVH refit to the moving vertices, loss, gradients by autograd and
Adam) replays those steps, under the same step keys, from the same
inputs; the last two numbers are compared by the gap of the norms over
the larger of the reference leaf's norm and the median leaf's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench import inputs, port
from portbench.common import Window

WIDE_EXACT_TABLES = ("cboxes", "clinks", "tris")
LEAVES = ("albedo", "vertices")
BETAS = (0.9, 0.999)
EPS = 1.0e-8
# rays a block of the reference's forward and backward
REF_BLOCK = 1 << 23


class TrainSteps:
    def __init__(self, cell):
        import torch

        from atray_tpu_torch.core.camera import camera_rays, look_at_camera
        from atray_tpu_torch.dist.train import make_train_step
        from atray_tpu_torch.render.wavefront import trace_radiance

        cfg, tr = cell.config, cell.traffic
        self.cell = cell
        dev = self.dev = torch.device(cell.device)
        inp = self.inp = inputs.make(cfg)
        host = port.scene(inp)
        acc, cell.accel_build_s = port.accel(host, cfg["accel"])
        scene, accel = host.to(dev), acc.to(dev)
        self.res = tr["view_res"]
        orig, dirn = [], []
        for eye in self._eyes():
            cam = look_at_camera(eye, cfg["views"]["target"], h_fov=cfg["views"]["h_fov"],
                                 aspect=1.0)
            o, d = camera_rays(cam, self.res, self.res, 1, device=dev)
            orig.append(o)
            dirn.append(d)
        self.orig, self.dirn = torch.cat(orig), torch.cat(dirn)
        n = self.orig.shape[0]
        self.bounces = cfg["bounce_limit"]
        with torch.no_grad():
            self.target = trace_radiance(scene, self.orig, self.dirn, self.bounces,
                                         self._target_key(), accel=accel)
        self.start = self._start()
        self.start_dev = {k: torch.tensor(self.start[k], device=dev) for k in LEAVES}
        self.params = dataclasses.replace(
            scene.params(), **{k: self.start_dev[k].clone().requires_grad_() for k in LEAVES})
        lr = cfg["optimizer"]["lr"]
        self.opt = torch.optim.Adam(
            [{"params": [getattr(self.params, k)], "lr": lr[k]} for k in LEAVES],
            betas=BETAS, eps=EPS)
        self.step = make_train_step(host, self.bounces, self.opt, accel=accel,
                                    refit=cfg["accel"].get("refit", False), device=dev)
        for s in range(tr["checked_steps"]):
            self._run_step(s)
        self.next = tr["checked_steps"]
        self.fit0, self.losses, self.first_grad, self.after = None, [], None, None
        cell.shapes = {"rays_per_unit": n,
                       "wide_exact": {"rays": n,
                                      "tables": port.table_bytes(acc, WIDE_EXACT_TABLES)}}

    def _first_moment(self, leaf):
        """Adam's first moment of ``leaf`` (zeros where it holds none: the
        optimizer took no step)."""
        import torch

        return self.opt.state.get(leaf, {}).get("exp_avg", torch.zeros_like(leaf)).detach()

    def _eyes(self):
        vw = self.cell.config["views"]
        t = vw["target"]
        for v in range(vw["count"]):
            a = 2.0 * math.pi * v / vw["count"]
            yield (t[0] + vw["radius"] * math.sin(a), vw["eye_height"],
                   t[2] + vw["radius"] * math.cos(a))

    def _keys(self):
        from portbench.reference import rng

        return rng.split(rng.prng_key(self.cell.seed))

    def _target_key(self):
        return self._keys()[0]

    def _step_key(self, s: int):
        from portbench.reference import rng

        return rng.fold_in(self._keys()[1], s)

    def _start(self) -> dict:
        """The corrupted start: the albedo scaled and shifted, the vertices
        with Gaussian noise from the seed, as float32 host arrays."""
        c = self.cell.config["corrupt"]
        v = self.inp["vertices"]
        noise = np.random.default_rng(self.cell.seed).normal(0.0, c["vertex_noise"], v.shape)
        f32 = np.float32
        return {"albedo": self.inp["albedo"] * f32(c["albedo_scale"]) + f32(c["albedo_shift"]),
                "vertices": v + noise.astype(f32)}

    def _run_step(self, s: int):
        """Step ``s`` of the loop; every ``episode_steps`` steps the fit
        starts again from the corrupted start with a fresh Adam state."""
        import torch

        if s and s % self.cell.traffic["episode_steps"] == 0:
            with torch.no_grad():
                for k in LEAVES:
                    getattr(self.params, k).copy_(self.start_dev[k])
            self.opt.state.clear()
        return self.step(self.params, self.orig, self.dirn, self.target, self._step_key(s))

    def _next_step(self) -> float:
        """Run the loop's next step, keep what the check reads of the
        checked fit, and return the step's loss."""
        s = self.next
        loss = float(self._run_step(s))
        self.next += 1
        k = s - self.fit0 if self.fit0 is not None else -1
        if 0 <= k < self.cell.traffic["checked_steps"]:
            self.losses.append(loss)
            if k == 0:
                self.first_grad = [self._first_moment(getattr(self.params, x)).double().cpu()
                                   / (1.0 - BETAS[0]) for x in LEAVES]
            if k == self.cell.traffic["checked_steps"] - 1:
                self.after = [getattr(self.params, x).detach().double().cpu() for x in LEAVES]
        return loss

    def warm(self) -> None:
        """The steps of set-up ran every shape of the window."""

    def window(self, seconds=None, units=None, tag: int = 0) -> Window:
        import time

        from portbench import trace

        ep = self.cell.traffic["episode_steps"]
        if tag == 0 and self.fit0 is None:
            self.fit0 = -(-self.next // ep) * ep
        ends, failed = [], 0
        t0 = time.perf_counter()
        deadline = t0 + seconds if seconds is not None else math.inf
        limit = units if units is not None else math.inf
        while True:
            failed += not math.isfinite(self._next_step())
            t = time.perf_counter()
            ends.append(t)
            trace.mark_unit()
            if t >= deadline or len(ends) >= limit:
                break
        while tag == 0 and self.after is None:
            self._next_step()
        return Window(t0, ends, self.cell.shapes["rays_per_unit"], failed=failed)

    def free(self) -> None:
        del self.step, self.opt, self.params, self.target, self.orig, self.dirn, self.start_dev

    # ---- the check -----------------------------------------------------

    def reference(self, dtype=None, fault=None):
        """The reference's (losses, first gradients, changes) of the checked
        fit's first steps, in ``dtype`` (float32 by default). ``fault`` plants a fault
        in it: "half" (the rays of the second half of the views left out,
        the loss their mean over the rest), "grad" (the albedo's gradient
        off by 1%)."""
        import torch

        from portbench.reference import bvh, camera, tracer

        dt = dtype or torch.float32
        dev = self.dev
        i = self.inp
        vw = self.cell.config["views"]

        def t(x, d=None):
            return torch.as_tensor(x, device=dev, dtype=d)

        sc = tracer.Scene(vertices=t(i["vertices"]), faces=t(i["faces"], torch.int64),
                          normals=t(i["normals"]), tri_mat=t(i["tri_mat"], torch.int64),
                          emission=t(i["emission"]), albedo=t(i["albedo"]),
                          scatter=t(i["scatter"]), plane_n=t(i["plane_n"]),
                          plane_off=t(i["plane_off"]),
                          plane_mat=t(i["plane_mat"], torch.int64)).cast(dt)
        res = self.res
        pix = torch.arange(res * res, device=dev)
        o, d = [], []
        for eye in self._eyes():
            cam = camera.basis(eye, vw["target"], vw["h_fov"], 1.0)
            oo, dd = camera.pixel_rays(cam, res, res, pix % res, pix // res, dt)
            o.append(oo)
            d.append(dd)
        o, d = torch.cat(o), torch.cat(d)
        n = o.shape[0]
        ids = torch.arange(n, device=dev)
        blocks = [slice(s, min(s + REF_BLOCK, n)) for s in range(0, n, REF_BLOCK)]
        if fault == "half":
            blocks = [slice(s, min(s + REF_BLOCK, n // 2)) for s in range(0, n // 2, REF_BLOCK)]
        kept = sum(b.stop - b.start for b in blocks)
        tree = bvh.build(sc.triangles())
        with torch.no_grad():
            target = torch.cat([tracer.trace(sc, tree, o[b], d[b], ids[b], self._target_key(),
                                             self.bounces) for b in
                                [slice(s, min(s + REF_BLOCK, n)) for s in range(0, n, REF_BLOCK)]])
        leaves = [t(self.start["albedo"], dt).clone().requires_grad_(),
                  t(self.start["vertices"], dt).clone().requires_grad_()]
        lr = [self.cell.config["optimizer"]["lr"][k] for k in LEAVES]
        m = [torch.zeros_like(x) for x in leaves]
        v = [torch.zeros_like(x) for x in leaves]
        losses, first = [], None
        for s in range(self.cell.traffic["checked_steps"]):
            cur = dataclasses.replace(sc, albedo=leaves[0], vertices=leaves[1])
            tree = bvh.refit(tree, cur.triangles())
            loss = 0.0
            grads = [torch.zeros_like(x) for x in leaves]
            for b in blocks:
                col = tracer.trace(cur, tree, o[b], d[b], ids[b], self._step_key(self.fit0 + s),
                                   self.bounces)
                part = torch.sum((col - target[b].to(dt)) ** 2) / (3.0 * kept)
                for g, x in zip(grads, torch.autograd.grad(part, leaves, allow_unused=True)):
                    if x is not None:
                        g += x
                loss += float(part.detach())
            if fault == "grad":
                grads[0] = grads[0] * 1.01
            losses.append(loss)
            if s == 0:
                first = [g.double().cpu() for g in grads]
            with torch.no_grad():
                k = s + 1
                for j, x in enumerate(leaves):
                    m[j] = BETAS[0] * m[j] + (1 - BETAS[0]) * grads[j]
                    v[j] = BETAS[1] * v[j] + (1 - BETAS[1]) * grads[j] * grads[j]
                    mh = m[j] / (1 - BETAS[0] ** k)
                    vh = v[j] / (1 - BETAS[1] ** k)
                    x -= lr[j] * mh / (torch.sqrt(vh) + EPS)
        change = [x.detach().double().cpu() - t(self.start[k]).double().cpu()
                  for x, k in zip(leaves, LEAVES)]
        return losses, first, change

    def readings(self, ref) -> dict:
        """The three numbers of the program against ``ref`` (a
        ``reference()`` result)."""
        import torch

        r_loss, r_grad, r_change = ref
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.losses, r_loss))
        start = [torch.as_tensor(self.start[k]).double() for k in LEAVES]
        p_change = [a - s for a, s in zip(self.after, start)]
        gn = [float(g.norm()) for g in r_grad]
        med = float(np.median(gn))
        moved = [x >= 1.0e-3 * med for x in gn]
        return {"loss_gap": loss_gap,
                "grad_gap": _worst(self.first_grad, r_grad, [True] * len(gn)),
                "change_gap": _worst(p_change, r_change, moved),
                "grad_norms": gn}

    def check(self, win: Window) -> dict:
        r = self.readings(self.reference())
        return {k: r[k] for k in ("loss_gap", "grad_gap", "change_gap")}


def _worst(got, want, use) -> float:
    """The largest gap between the norms of ``got`` and ``want`` leaf by
    leaf, over the larger of the reference leaf's norm and the median
    leaf's, over the leaves ``use`` keeps."""
    wn = [float(w.norm()) for w in want]
    med = float(np.median(wn))
    gaps = [abs(float(g.norm()) - x) / max(x, med, 1e-30)
            for g, x, u in zip(got, wn, use) if u]
    return max(gaps) if gaps else 0.0


def setup(cell):
    return TrainSteps(cell)
