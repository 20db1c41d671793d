"""The interactive viewer: one client in a closed loop of progressive
passes (``atray_tpu_torch.render.progressive.render_progressive``). Each
view gathers ``spp_per_view`` samples in passes of ``spp_per_pass``; then
the camera moves ``step_deg`` on an orbit around the target and the film
restarts. The seed sets the orbit's starting angle, the views' keys and
the pixels the check reads. A unit is a pass; it ends when its film
reaches the viewer's ``on_batch`` on the host.

The check: at ``check_pixels`` pixels drawn from the seed, the film sum
after every pass of the window is kept; after the window, for
``check_passes`` passes drawn from the seed, the reference traces the
pass's samples of those pixels, and the film sum the program reached is
compared with the one before it plus the reference's film, channel by
channel. ``film_off_share`` is the share of those values off by more than
``OFF`` (a path that meets an edge or a silhouette otherwise, by
rounding, may take another way, so a few differ by the nature of the
work).
"""

from __future__ import annotations

import math

import numpy as np

from portbench import inputs, port, trace
from portbench.common import M32, StopWindow, Window

OFF = 1.0e-4
WIDE_SHADE_TABLES = ("cboxes", "clinks", "caxis", "tris")


class Progressive:
    def __init__(self, cell):
        import torch

        from atray_tpu_torch.config import RenderSettings

        cfg, tr = cell.config, cell.traffic
        self.cell = cell
        self.dev = torch.device(cell.device)
        self.inp = inputs.make(cfg)
        host = port.scene(self.inp)
        acc, cell.accel_build_s = port.accel(host, cfg["accel"])
        self.scene, self.accel = host.to(self.dev), acc.to(self.dev)
        r = cfg["render"]
        self.w, self.h = r["resolution"]
        self.spp = tr["spp_per_pass"]
        self.total_spp = tr["spp_per_view"]
        self.settings = RenderSettings(
            resolution=(self.w, self.h), samples_per_pixel=self.spp,
            bounce_limit=r["bounce_limit"], ray_chunk=r["ray_chunk"],
            sort_bounces=r["sort_bounces"], lane_pack=r["lane_pack"], nee=False,
            anti_aliasing=False)
        rng = np.random.default_rng(cell.seed)
        self.a0 = rng.uniform(0.0, 2.0 * math.pi)
        k = tr["check_pixels"]
        self.px = rng.integers(0, self.w, k)
        self.py = rng.integers(0, self.h, k)
        rays = self.w * self.h * self.spp
        chunk = min(r["ray_chunk"] or rays, rays)
        cell.shapes = {"paths_per_unit": rays,
                       "wide_shade": {"rays": chunk,
                                      "tables": port.table_bytes(acc, WIDE_SHADE_TABLES)}}

    def _eye(self, v: int):
        orb = self.cell.traffic["orbit"]
        tgt = self.cell.config["camera"]["target"]
        a = self.a0 + math.radians(orb["step_deg"]) * v
        return (tgt[0] + orb["radius"] * math.sin(a), tgt[1] + orb["height"],
                tgt[2] + orb["radius"] * math.cos(a))

    def _view_seed(self, tag: int, v: int) -> int:
        return (self.cell.seed * 0x9E3779B1 + tag * 0x10000 + v) & M32

    def warm(self) -> None:
        import torch

        self.window(units=2, tag=1)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds=None, units=None, tag: int = 0) -> Window:
        """Passes until ``seconds`` have gone by or ``units`` are done."""
        import time

        from atray_tpu_torch.core.camera import look_at_camera
        from atray_tpu_torch.render.progressive import render_progressive

        cam_cfg = self.cell.config["camera"]
        ends, recs = [], []
        px, py = self.px, self.py
        t0 = time.perf_counter()
        deadline = t0 + seconds if seconds is not None else math.inf
        limit = units if units is not None else math.inf
        v = 0
        try:
            while True:
                cam = look_at_camera(self._eye(v), cam_cfg["target"], h_fov=cam_cfg["h_fov"],
                                     aspect=self.w / self.h)

                def on_batch(state, v=v):
                    t = time.perf_counter()
                    ends.append(t)
                    recs.append((v, state.batches_done - 1, state.film_sum[py, px]))
                    trace.mark_unit()
                    if t >= deadline or len(ends) >= limit:
                        raise StopWindow

                render_progressive(self.scene, cam, self.settings, self.total_spp,
                                   accel=self.accel, seed=self._view_seed(tag, v),
                                   on_batch=on_batch, device=self.dev)
                v += 1
        except StopWindow:
            pass
        return Window(t0, ends, self.cell.shapes["paths_per_unit"], records=(tag, recs))

    def free(self) -> None:
        del self.scene, self.accel

    # ---- the check -----------------------------------------------------

    def _films(self, chosen, dtype):
        """The reference's films (P, K, 3) float32 of the chosen passes."""
        import torch

        from portbench.reference import bvh, camera, film, rng, tracer

        dev = self.dev
        tag = chosen[0][0]
        sc = self._ref_scene(dev).cast(dtype)
        tri = sc.triangles()
        tree = bvh.build(tri)
        px = torch.as_tensor(self.px, device=dev)
        py = torch.as_tensor(self.py, device=dev)
        cam_cfg = self.cell.config["camera"]
        os_, ds, ids, keys = [], [], [], []
        for _, v, b in chosen:
            cam = camera.basis(self._eye(v), cam_cfg["target"], cam_cfg["h_fov"], self.w / self.h)
            o, d = camera.pixel_rays(cam, self.w, self.h, px, py, dtype)
            key = rng.split(rng.fold_in(rng.prng_key(self._view_seed(tag, v)), b))[1]
            kt = torch.as_tensor(key.astype(np.int64), device=dev)
            for s in range(self.spp):
                os_.append(o)
                ds.append(d)
                ids.append(film.ray_id(px, py, s, self.w, self.h, self.spp))
                keys.append(kt.expand(px.shape[0], 2))
        with torch.no_grad():
            col = tracer.trace(sc, tree, torch.cat(os_), torch.cat(ds), torch.cat(ids),
                               torch.cat(keys), self.cell.config["render"]["bounce_limit"], tri)
        col = col.float().reshape(len(chosen), self.spp, px.shape[0], 3).mean(dim=1)
        col = torch.minimum(torch.maximum(col, torch.zeros_like(col)), torch.ones_like(col))
        return col.cpu().numpy()

    def _ref_scene(self, dev):
        import torch

        from portbench.reference.tracer import Scene

        i = self.inp

        def t(x, dt=None):
            return torch.as_tensor(x, device=dev, dtype=dt)

        return Scene(vertices=t(i["vertices"]), faces=t(i["faces"], torch.int64),
                     normals=t(i["normals"]), tri_mat=t(i["tri_mat"], torch.int64),
                     emission=t(i["emission"]), albedo=t(i["albedo"]),
                     scatter=t(i["scatter"]), plane_n=t(i["plane_n"]),
                     plane_off=t(i["plane_off"]), plane_mat=t(i["plane_mat"], torch.int64))

    def _chosen(self, win: Window):
        tag, recs = win.records
        n = min(self.cell.traffic["check_passes"], len(recs))
        pick = np.random.default_rng(self.cell.seed + 1).choice(len(recs), n, replace=False)
        return [(tag, recs[i][0], recs[i][1]) for i in sorted(pick)]

    def readings(self, win: Window, dtype=None):
        """(program's reading, ...) as a dict: ``film_off_share`` and
        ``film_gap_max``; with ``dtype`` the control's in its place (the
        reference in that precision judged against the float32 one)."""
        import torch

        tag, recs = win.records
        sums = {(v, b): s for v, b, s in recs}
        chosen = self._chosen(win)
        want = self._films(chosen, torch.float32)
        got = np.stack([sums[(v, b)] for _, v, b in chosen])
        prev = np.stack([sums.get((v, b - 1), np.zeros_like(sums[(v, b)]))
                         for _, v, b in chosen])
        expect = prev + want
        if dtype is not None:
            got = prev + self._films(chosen, dtype)
        gap = np.abs(got.astype(np.float64) - expect.astype(np.float64))
        gap = np.where(np.isfinite(gap), gap, np.inf)
        return {"film_off_share": float(np.mean(gap > OFF)), "film_gap_max": float(gap.max()),
                "values": int(gap.size)}

    def check(self, win: Window) -> dict:
        r = self.readings(win)
        return {"film_off_share": r["film_off_share"]}


def setup(cell):
    return Progressive(cell)
