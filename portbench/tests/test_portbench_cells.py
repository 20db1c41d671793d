"""Each cell's run at a tiny size on the CPU: the program's outputs come
out correct against the reference; the control (the reference in
bfloat16 in the program's place) and each fault the cell can have,
planted under the timed path, come out not correct; a run loads neither
JAX nor the JAX package; and, on a card, the command runs a cell."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import run
from portbench.common import ROOT, Cell, cell_files, load_module, read_json

BENCH = read_json(os.path.join(ROOT, "BENCHMARK.json"))
RENDER = "dragon139k-1080p.progressive64"
TRAIN = "dragon139k-inverse16.step512"


def tiny(workload: str, seed: int = 2**31 + 17) -> Cell:
    """The cell at a size the CPU holds: 2,000 triangles, a 96 x 54 film
    or 24 x 24 views and fits of 8 steps; every other setting as the cell
    runs."""
    f = cell_files(BENCH, workload)
    cfg, tr = read_json(f["config_file"]), read_json(f["traffic_file"])
    cfg["meshes"][0]["target_tris"] = 2000
    if "render" in cfg:
        cfg["render"].update(resolution=[96, 54], ray_chunk=0)
        tr.update(spp_per_view=8, check_pixels=128, check_passes=6)
    else:
        tr.update(view_res=24, episode_steps=8)
    return Cell(workload, cfg, tr, read_json(f["limits_file"]), seed, "cpu")


def go(cell: Cell, seconds: float = 1.5):
    out, checks = run.run_cell(cell, BENCH, seconds, False, time.perf_counter())
    return out, {k: v for k, v, _ in checks}


@pytest.mark.parametrize("workload", [RENDER, TRAIN])
def test_cell_is_correct(workload):
    out, checks = go(tiny(workload))
    assert out["correct"], checks
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {m["name"] for m in BENCH["end_to_end"]
             if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == names


def _film_unchanged(mp):
    import atray_tpu_torch.render.progressive as prog

    mp.setattr(prog, "to_numpy", lambda film: np.zeros(tuple(film.shape), np.float32))


def _half_samples(mp):
    import atray_tpu_torch.render.wavefront as wf

    orig = wf.from_tile_order

    def half(x, w, h, spp):
        x = orig(x, w, h, spp).clone()
        x[x.shape[0] // 2:] = x[:x.shape[0] // 2]          # sample 0 in place of 1
        return x

    mp.setattr(wf, "from_tile_order", half)


def _paths_altered(every):
    def fault(mp):
        import atray_tpu_torch.render.wavefront as wf

        orig = wf.from_tile_order

        def altered(x, w, h, spp):
            x = orig(x, w, h, spp).clone()
            x[::every] = x[::every] * 1.5 + 0.01
            return x

        mp.setattr(wf, "from_tile_order", altered)

    fault.__name__ = f"_path_altered_every_{every}"
    return fault


# every 16th path (6%), and every 256th (0.4%: a few rows misrouted)
@pytest.mark.parametrize("fault", [_film_unchanged, _half_samples, _paths_altered(16),
                                   _paths_altered(256)], ids=lambda f: f.__name__)
def test_render_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out, checks = go(tiny(RENDER))
    assert not out["correct"], checks


def _state_unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _wrap_loss_and_grad(mp, wrap):
    import atray_tpu_torch.dist.train as tr

    orig = tr.make_loss_and_grad
    mp.setattr(tr, "make_loss_and_grad", lambda *a, **k: wrap(orig(*a, **k)))


def _half_batch(mp):
    def wrap(f):
        def g(params, orig, dirn, target, key):
            n = orig.shape[0] // 2
            return f(params, orig[:n], dirn[:n], target[:n], key)
        return g

    _wrap_loss_and_grad(mp, wrap)


def _grad_altered(mp):
    import dataclasses

    def wrap(f):
        def g(*a):
            loss, grads = f(*a)
            return loss, dataclasses.replace(grads, albedo=grads.albedo * 1.01)
        return g

    _wrap_loss_and_grad(mp, wrap)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _grad_altered])
def test_train_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out, checks = go(tiny(TRAIN))
    assert not out["correct"], checks


@pytest.mark.parametrize("workload", [RENDER, TRAIN])
def test_control_is_not_correct(workload):
    """The reference in bfloat16, judged as the program's outputs are,
    fails the cell's limits."""
    cell = tiny(workload)
    driver = load_module(os.path.join(ROOT, "portbench", "drivers",
                                      cell.traffic["driver"] + ".py"), "t_driver")
    d = driver.setup(cell)
    d.warm()
    win = d.window(units=6)
    d.free()
    if cell.traffic["driver"] == "progressive":
        got = d.readings(win, torch.bfloat16)
    else:
        got = d.readings(d.reference(torch.bfloat16))
    assert any(got[k] > lim for k, lim in cell.limits.items()), got


def test_a_run_loads_no_jax():
    """A tiny run in a fresh process: no top-level module named jax,
    jaxlib, flax or atray_tpu (compared whole) is loaded."""
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "torch.set_num_threads(1)\n"
            "from portbench.tests.test_portbench_cells import tiny, go, RENDER\n"
            "from portbench import run\n"
            "go(tiny(RENDER), 0.5)\n"
            "print(run.banned_modules())\n"
            "print('atray_tpu_torch' in sys.modules)\n") % ROOT
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split("\n")[-3:-1] == ["[]", "True"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [RENDER, TRAIN])
def test_command_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().split("\n")[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
