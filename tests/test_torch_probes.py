"""PyTorch port, the lane-routing probes (``atray_tpu_torch/probes``): each
probe's plain version against the TPU probe kernel of ``scripts/probe_r18.py``
to ``probe_r22.py`` (P1-P11) in Pallas interpret mode on the same inputs, the
wrappers' counters, and on a card each kernel against its plain version.

The scripts run their TPU benchmarks when imported, so the test compiles only
their imports, function definitions and upper-case constants (``ast``), and
hands their functions a ``pl`` whose ``pallas_call`` passes
``interpret=True``."""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.kernels.lane_pack import pack_indices as jax_pack_indices  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.kernels.lane_pack import pack_indices, unpack_indices  # noqa: E402
from atray_tpu_torch.probes import (  # noqa: E402
    probe_r18, probe_r19, probe_r20, probe_r21, probe_r22)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
C, LANE = probe_r20.C, probe_r20.LANE
F32 = jax.ShapeDtypeStruct


class _InterpretPallas:
    """``pl`` with ``pallas_call(..., interpret=True)``."""

    def __getattr__(self, name):
        if name == "pallas_call":
            return functools.partial(pl.pallas_call, interpret=True)
        return getattr(pl, name)


@functools.lru_cache(maxsize=None)
def _script(name):
    """The definitions of ``scripts/<name>.py`` without its module-level runs."""
    path = os.path.join(SCRIPTS, f"{name}.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    keep = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(node, ast.Assign)
                and all(isinstance(t, ast.Name) and t.id.isupper() for t in node.targets))]
    ns = {"__name__": f"probe_script_{name}"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    ns["pl"] = _InterpretPallas()
    return ns


def _call(kern, out_shape, *args, in_specs=None, scratch_shapes=()):
    kw = {} if in_specs is None else {"in_specs": in_specs}
    return np.asarray(pl.pallas_call(kern, out_shape=out_shape, interpret=True,
                                     scratch_shapes=list(scratch_shapes), **kw)(*args))


def _t(x):
    return torch.from_numpy(np.array(x))


SMEM_VMEM = [pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM),
             pl.BlockSpec(memory_space=pltpu.VMEM)]


def _route_inputs(rng, rel_hi=2048):
    win = rng.normal(size=(C, 16, LANE)).astype(np.float32)
    rel = rng.integers(0, rel_hi, size=(1, LANE)).astype(np.int32)
    return win, rel


def _dot_case(name, kern, a, b, reps, port_fn, **kw):
    ref = _call(functools.partial(_script(name)[kern], reps=reps, **kw),
                F32((a.shape[0], 128), jnp.float32), jnp.asarray(a), jnp.asarray(b))
    return ref, port_fn(_t(a), _t(b), reps).numpy()


def case_p1(rng):
    a = rng.normal(size=(14, 128)).astype(np.float32)
    b = rng.normal(size=(128, 128)).astype(np.float32)
    ref, got = _dot_case("probe_r18", "_kern_t", a, b, 3, probe_r18.dot_t)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * 3)


def case_p2(rng):
    a = rng.normal(size=(14, 128)).astype(np.float32)
    b = rng.normal(size=(128, 128)).astype(np.float32)
    ref, got = _dot_case("probe_r18", "_kern_n", a, b, 3, probe_r18.dot_n)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * 3)


def case_p3(rng):
    for m in probe_r18.BF16_ROWS:
        a = jnp.asarray(rng.normal(size=(m, 128)).astype(np.float32)).astype(jnp.bfloat16)
        b = jnp.asarray((rng.random((128, 128)) < 0.01).astype(np.float32)).astype(jnp.bfloat16)
        ref = _call(functools.partial(_script("probe_r18")["_kern_bf16"], reps=3),
                    F32((m, 128), jnp.float32), a, b)
        to_port = lambda x: _t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
        got = probe_r18.dot_bf16(to_port(a), to_port(b), 3).numpy()
        np.testing.assert_array_equal(got, ref)            # 0/1 operands: exact
        assert np.abs(ref).max() > 0


def case_p4(rng):
    for m, k in ((14, 128), (16, 512), (14, 4096)):
        a = rng.normal(size=(m, k)).astype(np.float32)
        b = (rng.random((k, 128)) < 1.0 / k).astype(np.float32)
        ref, got = _dot_case("probe_r19", "_kern_k", a, b, 2, probe_r19.dot_k)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * 2)
        assert np.abs(ref).max() > 0


def case_p5(rng):
    a = rng.normal(size=(14, 512)).astype(np.float32)
    b = (rng.random((512, 128)) < 0.02).astype(np.float32)
    ref, got = _dot_case("probe_r19", "_kern_indep", a, b, 3, probe_r19.dot_indep)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * 3)
    assert np.abs(ref).max() > 0


def case_p6(rng):
    win, rel = _route_inputs(rng, rel_hi=300)
    for variant, unroll in probe_r20.LOOP_CASES[:5]:
        n = np.asarray([240 // unroll], np.int32)
        ref = _call(_script("probe_r20")["make_kern"](variant, unroll), F32((C, LANE), jnp.float32),
                    jnp.asarray(n), jnp.asarray(win), jnp.asarray(rel), in_specs=SMEM_VMEM)
        got = probe_r20.route_loop(_t(n), _t(win), _t(rel[0]), variant, unroll).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"{variant} x{unroll}")


def case_p7(rng):
    win, rel = _route_inputs(rng, rel_hi=300)
    n = np.asarray([300], np.int32)
    ref = _call(_script("probe_r20")["_kern_dyn"], F32((C, LANE), jnp.float32), jnp.asarray(n),
                jnp.asarray(win), jnp.asarray(rel), in_specs=SMEM_VMEM)
    got = probe_r20.route_dyn(_t(n), _t(win), _t(rel[0])).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.count_nonzero(ref) > 1000


def case_route_edge(rng, kernel, steps, past=False):
    # P6 build+dot x1 or P7 at a step count near the window's 128 columns;
    # ``past`` puts every lane at or past the step count, lane 0 at it
    win, rel = _route_inputs(rng, rel_hi=300)
    if past:
        rel = steps + rel % 136
        rel[0, 0] = steps
    n = np.asarray([steps], np.int32)
    script = _script("probe_r20")
    kern = script["make_kern"]("build+dot", 1) if kernel == "P6" else script["_kern_dyn"]
    ref = _call(kern, F32((C, LANE), jnp.float32), jnp.asarray(n), jnp.asarray(win),
                jnp.asarray(rel), in_specs=SMEM_VMEM)
    fn = (lambda *a: probe_r20.route_loop(*a, "build+dot", 1)) if kernel == "P6" else \
        probe_r20.route_dyn
    np.testing.assert_array_equal(fn(_t(n), _t(win), _t(rel[0])).numpy(), ref)
    assert np.count_nonzero(ref) > 0


def case_p8(rng, cases=((40, False), (43, True)), inner=7):
    # rel within a few lanes of 0 so that the rows' short loops gather
    win, rel = _route_inputs(rng, rel_hi=136)
    for rows, carry6 in cases:
        n = np.asarray([rows], np.int32)
        kern = functools.partial(_script("probe_r20")["_kern_nested"], inner=inner,
                                 when_store=True, carry6=carry6)
        ref = _call(kern, F32((C, LANE), jnp.float32), jnp.asarray(n), jnp.asarray(win),
                    jnp.asarray(rel), in_specs=SMEM_VMEM)
        got, carry = probe_r20.route_nested(_t(n), _t(win), _t(rel[0]), inner, True, carry6)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert np.count_nonzero(ref) > 100
        if carry6:
            assert carry.tolist() == probe_r20.nested_carries(rows)


def case_p9(rng):
    win, _ = _route_inputs(rng)
    idx = rng.integers(0, LANE, size=(probe_r20.IDX_ROWS, LANE)).astype(np.int32)
    n = np.asarray([60], np.int32)
    for store_dyn in (False, True):
        def kern(n_ref, idx_ref, win_ref, o_ref, *rest, store_dyn=store_dyn):
            _script("probe_r20")["_kern_bigread"](n_ref, idx_ref, win_ref, o_ref,
                                                  store_dyn=store_dyn,
                                                  oslab_ref=rest[0] if rest else None)
        scratch = [pltpu.VMEM((2, C, 450, LANE), jnp.float32)] if store_dyn else []
        ref = _call(kern, F32((C, LANE), jnp.float32), jnp.asarray(n), jnp.asarray(idx),
                    jnp.asarray(win), in_specs=SMEM_VMEM, scratch_shapes=scratch)
        got, slab = probe_r20.route_bigread(_t(n), _t(idx), _t(win), store_dyn)
        np.testing.assert_array_equal(got.numpy(), ref)
        # the last row written to each slab row holds the sum after that row
        if store_dyn:
            jj = 59
            np.testing.assert_array_equal(slab[jj % 2, :, (13 * jj) % 450].numpy(), ref)


def _take_maps(rng, rows=256):
    maps = []
    for occ, wcap in ((0.15, 16), (0.035, 64)):
        alive = rng.random(rows * LANE) < occ
        idx = np.asarray(jax_pack_indices(jnp.asarray(alive)))
        np.testing.assert_array_equal(pack_indices(_t(alive)).numpy(), idx)
        maps.append((idx, wcap))
    return maps


def case_p10(rng):
    cols = rng.normal(size=(256, 2, LANE)).astype(np.float32)
    for idx, wcap in _take_maps(rng):
        ref = np.asarray(_script("probe_r21")["lane_take_rm"](jnp.asarray(cols), jnp.asarray(idx),
                                                              wcap=wcap))
        got = probe_r21.take_rm(_t(cols), _t(idx)).numpy()
        np.testing.assert_array_equal(got, ref)
        assert np.count_nonzero(ref) > 0


def case_p11(rng):
    cols = rng.normal(size=(2, 256, LANE)).astype(np.float32)
    for idx, wcap in _take_maps(rng):
        ref = np.asarray(_script("probe_r22")["take"](jnp.asarray(cols), jnp.asarray(idx),
                                                      wcap=wcap, mode="full"))
        got = probe_r22.stream_take(_t(cols), _t(idx)).numpy()
        np.testing.assert_array_equal(got, ref)
        assert np.count_nonzero(ref) > 0


CASES = {f"P{i}": fn for i, fn in enumerate(
    (case_p1, case_p2, case_p3, case_p4, case_p5, case_p6, case_p7, case_p8, case_p9, case_p10,
     case_p11), start=1)}
# P6 build+dot and P7 at 1, 127 and 129 steps and with every lane at or
# past the step count; P8 at one and two rows (an even and an odd last row)
# and at inner 3
CASES.update({f"{k} steps={steps}": functools.partial(case_route_edge, kernel=k, steps=steps)
              for k in ("P6", "P7") for steps in (1, 127, 129)})
CASES.update({f"{k} rel>=steps": functools.partial(case_route_edge, kernel=k, steps=129, past=True)
              for k in ("P6", "P7")})
CASES.update({
    "P8 rows=1": functools.partial(case_p8, cases=((1, False), (1, True))),
    "P8 rows=2": functools.partial(case_p8, cases=((2, False), (2, True))),
    "P8 inner=3": functools.partial(case_p8, inner=3),
})


@pytest.mark.parametrize("row", list(CASES))
def test_plain_version_matches_tpu_probe_kernel(row):
    CASES[row](np.random.default_rng(int(row[1:].split()[0])))


def _warp0_rel(warp0):
    """rel (128,) with warp 0's first lanes at ``warp0`` and every other lane
    at 10,000, where no step below 9,873 gathers."""
    rel = np.full(LANE, 10_000, np.int32)
    rel[:len(warp0)] = warp0
    return _t(rel)


def _loop_hand_count():
    # lane 0 gathers at steps 0..5, lane 1 at 173..300: the warp needs 14
    # adds for each of lane 1's 128 terms, not for each of the 134 steps
    # on which one of its lanes gathers
    rel = _warp0_rel([5, 300])
    for variant, per_warp in (("build+dot", [128 * 14, 0, 0, 0]), ("iota", [400] * 4),
                              ("dot", [400 * 14] * 4), ("empty", [0] * 4)):
        assert probe_r20.issue_instr("probe_route_loop", 100, rel, variant=variant,
                                     unroll=4) == per_warp, variant
    assert probe_r20.issue_instr("probe_route_dyn", 400, rel) == [128 * 14, 0, 0, 0]


def _routed_hand_count(rel, steps, per_warp):
    assert probe_r20.issue_instr("probe_route_dyn", steps, _t(rel)) == per_warp
    assert probe_r20.issue_instr("probe_route_loop", steps // 4, _t(rel), unroll=4) == per_warp


def _overlap_hand_count():
    # 400 steps; warp 0: lane 0 gathers at steps 0..100 (101 terms), lane 1
    # at 23..150 (128); warp 1: lanes at 60 and 90, steps 0..60 and 0..90
    rel = np.full(LANE, 10_000, np.int32)
    rel[[0, 1, 32, 33]] = [100, 150, 60, 90]
    _routed_hand_count(rel, 400, [128 * 14, 91 * 14, 0, 0])


def _short_hand_count():
    # 48 steps, fewer than the window's 128 columns: a lane at 100 gathers
    # at steps 0..47, one at 30 at 0..30, one at 20 (warp 2) at 0..20
    rel = np.full(LANE, 10_000, np.int32)
    rel[[0, 1, 64]] = [100, 30, 20]
    _routed_hand_count(rel, 48, [48 * 14, 0, 21 * 14, 0])


def _no_term_hand_count():
    # 100 steps: a lane at 300 gathers at none (its steps 173..300 are past
    # the last), one at -5 at none, one at 5 at steps 0..5
    rel = np.full(LANE, 10_000, np.int32)
    rel[[0, 1, 2, 96]] = [300, -5, 5, 300]
    _routed_hand_count(rel, 100, [6 * 14, 0, 0, 0])


def _nested_hand_count():
    # lane 0 gathers at steps 0..2, so a row of q steps gathers on min(q, 3);
    # inner 7: q = 1..7 by jj % 7
    rel = _warp0_rel([2])
    for rows, gathered, odd in ((8, 19, 4), (9, 21, 4)):         # last row odd, even
        for ws in (False, True):
            for c6 in (False, True):
                want = 14 * gathered + ws * (14 * rows + 14 * odd) + c6 * 6 * rows
                got = probe_r20.issue_instr("probe_route_nested", rows, rel, inner=7,
                                            when_store=ws, carry6=c6)
                assert got == [want] + [ws * (14 * rows + 14 * odd) + c6 * 6 * rows] * 3
    # inner 3: q = 1, 2, 3, 3, 3, 3, 3, 1, 2 on nine rows
    assert probe_r20.issue_instr("probe_route_nested", 9, rel, inner=3)[0] == 14 * 21
    assert probe_r20.issue_instr("probe_route_nested", 0, rel, when_store=True) == [0] * 4


def _bigread_hand_count():
    # rows (7 jj) % 3 = 0, 1, 2, 0, 1: row 0 gathers nowhere, row 1 in warp 1
    # (lane 40), row 2 in every warp
    idx = np.full((3, LANE), 200, np.int32)
    idx[1, 40] = 7
    idx[2] = 5
    for sd in (False, True):
        got = probe_r20.issue_instr("probe_route_bigread", 5, idx=_t(idx), store_dyn=sd)
        assert got == [14 + 70 * sd, 42 + 70 * sd, 14 + 70 * sd, 14 + 70 * sd]


def _bound_hand_count():
    # the busiest warp's count over one scheduler's rate, 33.5e12 / (132 x 4 x 32)
    instr = [100, 2_000_000, 5, 0]
    assert probe_r20.issue_bound_ms(instr) == pytest.approx(
        2_000_000 / (33.5e12 / 16_896) * 1e3, rel=1e-12)
    assert probe_r20.issue_bound_ms([0] * 4) == 0.0
    win, rel = probe_r20.inputs("cpu")
    # the script's nested rows with the store and the carries: 83 a row
    assert max(probe_r20.issue_instr("probe_route_nested", probe_r20.OUTER_ROWS, rel,
                                     when_store=True, carry6=True)) == 83 * probe_r20.OUTER_ROWS


@pytest.mark.parametrize("count", [_loop_hand_count, _overlap_hand_count, _short_hand_count,
                                   _no_term_hand_count, _nested_hand_count, _bigread_hand_count,
                                   _bound_hand_count],
                         ids=["loop", "overlap", "short", "no term", "nested", "bigread", "bound"])
def test_issue_instr_matches_a_hand_count(count):
    count()


@pytest.mark.parametrize("steps", [0, 1, 129, probe_r20.STEPS])
def test_route_library_products_match_plain_versions_within_their_tolerance(steps):
    # the library yardstick of P6 build+dot and P7: one product with a 0/1
    # mask each (library_calls raises beyond its tolerance); exact where
    # no lane has a term
    win, rel = probe_r20.inputs("cpu")
    calls = probe_r20.library_calls(win, rel % 300, steps)
    got = calls["probe_route_dyn"]()
    assert got.shape == (C, LANE) and (torch.count_nonzero(got) > 0) == (steps > 0)


def test_a_time_under_its_issue_rate_bound_raises():
    from atray_tpu_torch.probes import _timing
    with pytest.raises(AssertionError, match="under its bound"):
        _timing.at_least_bound(0.099, 0.1, "P8")
    assert _timing.at_least_bound(0.3, 0.1, "P8") == pytest.approx(3.0)
    assert _timing.at_least_bound(0.01, 0.0, "P6 empty") == float("inf")
    t = _timing.Timed("probe_route_nested", "x", 0.3, 1e-5, "bytes", True, issue_bound_ms=0.1)
    assert "issue rate, 3.000x" in t.bound_text() and "one SM" not in t.bound_text()


@pytest.mark.parametrize("reps", [0, 1])
@pytest.mark.parametrize("row", ["P4", "P5", "P1", "P2", "P3"])
def test_stream_products_match_tpu_kernels_at_reps_0_and_1(row, reps):
    # no rep gives zeros and one rep one product: where a split-K share or a
    # ring stage that is dropped, repeated or read early shows plainly (P1,
    # P2: also a swizzled row of b's stage; P3: b a permutation, so that out's
    # column n is a's column of b's row for n, and a k or n mapping fault shows)
    rng = np.random.default_rng(40 + reps)
    if row == "P3":
        b = probe_r18.permutation_b("cpu", rng)
        for m in probe_r18.BF16_ROWS:
            a = jnp.asarray(rng.normal(size=(m, 128)).astype(np.float32)).astype(jnp.bfloat16)
            ref = _call(functools.partial(_script("probe_r18")["_kern_bf16"], reps=reps),
                        F32((m, 128), jnp.float32), a, jnp.asarray(b.float().numpy()).astype(
                            jnp.bfloat16))
            got = probe_r18.dot_bf16(_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16), b,
                                     reps).numpy()
            np.testing.assert_array_equal(got, ref)
            assert (np.abs(ref).max() > 0) == (reps > 0)
        return
    if row in ("P1", "P2"):
        kern, fn = ("_kern_t", probe_r18.dot_t) if row == "P1" else ("_kern_n", probe_r18.dot_n)
        for m in probe_r18.F32_ROWS:
            a = rng.normal(size=(m, 128)).astype(np.float32)
            b = rng.normal(size=(128, 128)).astype(np.float32)
            ref, got = _dot_case("probe_r18", kern, a, b, reps, fn)
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(reps, 1))
            assert (np.abs(ref).max() > 0) == (reps > 0)
        return
    shapes = ((14, 128), (16, 512), (14, 4096)) if row == "P4" else ((14, 512), (16, 512))
    for m, k in shapes:
        a = rng.normal(size=(m, k)).astype(np.float32)
        b = (rng.random((k, 128)) < (1.0 / k if row == "P4" else 0.02)).astype(np.float32)
        if row == "P4":
            ref, got = _dot_case("probe_r19", "_kern_k", a, b, reps, probe_r19.dot_k)
        else:
            ref, got = _dot_case("probe_r19", "_kern_indep", a, b, reps, probe_r19.dot_indep)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(reps, 1))
        assert (np.abs(ref).max() > 0) == (reps > 0)


def test_dot_k_dense_b_matches_tpu_kernel_within_the_stated_tolerance():
    # b normal: every term counts, and the plain version and the TPU kernel
    # sum in other orders; probe_r19.dense_tolerance bounds the difference
    rng = np.random.default_rng(45)
    a = rng.normal(size=(16, 1024)).astype(np.float32)
    b = rng.normal(size=(1024, 128)).astype(np.float32)
    for reps in (1, 3):
        ref, got = _dot_case("probe_r19", "_kern_k", a, b, reps, probe_r19.dot_k)
        tol = probe_r19.dense_tolerance(_t(a), _t(b), reps).numpy()
        assert (np.abs(got - ref) <= tol).all(), reps
        assert np.abs(got - ref).max() > 0          # the orders do differ


def test_dense_tolerance_catches_one_dropped_share():
    # the card check's dense cases must fail a kernel that loses one warp's
    # 16-deep share of one slice (P4 at K = 4096, the widest) or of every slice
    rng = np.random.default_rng(46)
    a, b = probe_r19.dense_inputs("cpu", 16, 4096, rng)
    want = probe_r19.dot_k_ref(a, b, 8)
    tol = probe_r19.dense_tolerance(a, b, 8)
    one = b.clone()
    one[3 * 128 + 48:3 * 128 + 64] = 0.0            # warp 3's share of slice 3
    every = b.clone().view(32, 128, 128)
    every[:, 48:64] = 0.0                           # its share of every slice
    for cut in (one, every.view(4096, 128)):
        got = probe_r19.dot_k_ref(a, cut, 8)
        assert bool(((got - want).abs() > tol).any())
        with pytest.raises(AssertionError):
            probe_r19.dense_err(got, want, a, b, 8, "dropped share")
    assert probe_r19.dense_err(want, want, a, b, 8, "same")[0] == 0.0


def _resident_order(a, b, reps, transpose):
    """P1's or P2's sum in the card kernel's order, on the CPU: warp w's
    rows [16 w, 16 w + 16) of the contraction as a chain of fused
    multiply-adds (exact float64 products, sums rounded to float32), runs of
    16 reps' partials added to the warp's carry, the carries summed warp 0
    first."""
    bk = (b.t() if transpose else b).double()          # (k, n)
    carries = []
    for w in range(8):
        p = torch.zeros(a.shape[0], 128)
        for k in range(16 * w, 16 * w + 16):
            p = (a[:, k:k + 1].double() * bk[k] + p.double()).float()
        carry = torch.zeros_like(p)
        for r0 in range(0, reps, 16):
            run = torch.zeros_like(p)
            for _ in range(r0, min(r0 + 16, reps)):
                run = run + p
            carry = carry + run
        carries.append(carry)
    out = carries[0]
    for carry in carries[1:]:
        out = out + carry
    return out


@pytest.mark.parametrize("row", ["P1", "P2"])
def test_p1_p2_check_catches_one_dropped_share(row):
    # the card check (probe_r18.sum_err on the script's normal inputs, reps
    # 64, M = 16) passes the kernel's summation order and fails a result
    # that lost warp 3's 16-deep share: b's rows [48, 64) for P2, its
    # columns [48, 64) for P1 (b is (n, k) there)
    transpose = row == "P1"
    a, b = probe_r18.inputs("cpu", m=16)
    want = probe_r18.dot_ref(a, b, 64, transpose=transpose)
    cut = b.clone()
    if transpose:
        cut[:, 48:64] = 0.0
    else:
        cut[48:64] = 0.0
    probe_r18.sum_err(_resident_order(a, b, 64, transpose), want, 64, row)
    for got in (_resident_order(a, cut, 64, transpose),
                probe_r18.dot_ref(a, cut, 64, transpose=transpose)):
        with pytest.raises(AssertionError):
            probe_r18.sum_err(got, want, 64, f"{row} without warp 3's share")


def _span_rows(idx, rows):
    """Source rows of each output row's live lanes."""
    return [sorted({int(s) // LANE for s in idx[j * LANE:(j + 1) * LANE] if 0 <= s < rows * LANE})
            for j in range(rows)]


def test_row_spans_give_the_spans_they_claim():
    # the kernel stages each output row's span of source rows where it fits
    # a stage, gathers a wider row directly and only zeroes a dead one:
    # row_spans and staged_bytes must give exactly those spans
    rng = np.random.default_rng(47)
    rows = 256
    mask = (rng.random(rows * LANE) < 0.3) & np.repeat(rng.random(rows) < 0.5, LANE)
    packed = pack_indices(_t(rng.random(rows * LANE) < 0.15)).view(rows, LANE)
    maps = [probe_r22.edge_map(rows), unpack_indices(_t(mask)),
            packed[_t(rng.permutation(rows))].reshape(-1).contiguous()]
    cap = probe_r22.STAGE_ROWS
    for idx in maps:
        lo, span = (t.tolist() for t in probe_r22.row_spans(idx))
        used = _span_rows(idx.tolist(), rows)
        for j in range(rows):
            assert (lo[j], span[j]) == ((used[j][0], used[j][-1] - used[j][0] + 1)
                                        if used[j] else (0, 0))
        assert probe_r22.staged_bytes(idx, 3) == sum(u for u in span if u <= cap) * 3 * 512
    lo, span = probe_r22.row_spans(maps[0])
    assert [(int(lo[j]), int(span[j])) for j in (99, 100, 101, 102)] == [
        (99, 1), (100, cap), (101 - cap, cap + 1), (0, 0)]


def test_stream_take_plain_version_matches_tpu_kernel_on_interleaved_dead_rows():
    # half the output rows dead and interleaved with live ones (an unpacked
    # map, not a prefix), one plane
    rng = np.random.default_rng(48)
    rows = 256
    mask = (rng.random(rows * LANE) < 0.3) & np.repeat(rng.random(rows) < 0.5, LANE)
    idx = unpack_indices(_t(mask)).numpy()
    cols = rng.normal(size=(1, rows, LANE)).astype(np.float32)
    ref = np.asarray(_script("probe_r22")["take"](jnp.asarray(cols), jnp.asarray(idx), wcap=16,
                                                  mode="full"))
    got = probe_r22.stream_take(_t(cols), _t(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.count_nonzero(ref) > 0 and (ref.reshape(rows, LANE) == 0).all(1).sum() > rows // 4


def _np_take_rm(cols, idx):
    """numpy's ray-major take: out[j, c, l] = cols[s // 128, c, s % 128] for
    s = idx[128 j + l] in [0, N), else 0."""
    rows, c, _ = cols.shape
    ok = (idx >= 0) & (idx < rows * LANE)
    s = np.where(ok, idx, 0).astype(np.int64)
    got = cols[s // LANE, :, s % LANE]                      # (N, c)
    got[~ok] = 0
    return got.reshape(rows, LANE, c).transpose(0, 2, 1)


# (sources at some output lanes, distinct 32-byte sectors of one plane)
SECTOR_CASES = {"one sector": ([8, 9, 15, 15], 1),
                "two sectors of a row": ([7, 8, 3], 2),
                "across rows": ([127, 128, 3 * LANE + 5, 3 * LANE + 6], 3)}


@pytest.mark.parametrize("case", list(SECTOR_CASES))
def test_sector_work_matches_a_hand_count(case):
    rows, c = 4, 3
    n = rows * LANE
    sources, sectors = SECTOR_CASES[case]
    idx = np.full(n, -1, np.int32)
    idx[[5, 70, 300, 511][:len(sources)]] = sources
    idx[[6, 7]] = [n, -5]                                   # dead: at N, below 0
    assert probe_r21.sector_work(_t(idx), c) == 4 * n + 32 * c * sectors + 4 * c * n
    live = len(sources)
    assert probe_r21.take_work(_t(idx), c) == 4 * n + 4 * c * live + 4 * c * n


@pytest.mark.parametrize("c", [1, 3, 17])
def test_take_rm_plain_version_matches_numpy_on_the_edge_maps(c):
    rng = np.random.default_rng(c)
    rows = 6
    cols = rng.normal(size=(rows, c, LANE)).astype(np.float32)
    words = probe_r21.nan_words("cpu", rng, rows, c).numpy()
    packed = pack_indices(_t(rng.random(rows * LANE) < 0.15))
    for label, idx in probe_r21.edge_maps("cpu", rng, rows) + [("packed", packed)]:
        for x in (cols, words):
            got = probe_r21.take_rm_ref(_t(x), idx).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          _np_take_rm(x, idx.numpy()).view(np.uint32),
                                          err_msg=label)


def test_take_rm_launch_refuses_a_misaligned_idx_before_loading_the_library():
    rng = np.random.default_rng(4)
    rows = 3
    cols = _t(rng.normal(size=(rows, 2, LANE)).astype(np.float32))
    buf = torch.from_numpy(rng.integers(-1, rows * LANE, size=rows * LANE + 4).astype(np.int32))
    idx = buf[1:rows * LANE + 1]                            # contiguous, 4 bytes off
    assert buf.data_ptr() % 16 == 0 and idx.is_contiguous() and idx.data_ptr() % 16 == 4
    loaded = _build._loaded.lib
    with pytest.raises(ValueError, match="16-byte"):
        probe_r21.launch_take_rm(cols, idx, torch.empty_like(cols))
    assert _build._loaded.lib is loaded
    np.testing.assert_array_equal(probe_r21.take_rm(cols, idx).numpy(),
                                  _np_take_rm(cols.numpy(), idx.numpy()))


def test_cpu_wrappers_count_plain_calls_only():
    rng = np.random.default_rng(3)
    a = _t(rng.normal(size=(14, 512)).astype(np.float32))
    b = _t(rng.normal(size=(512, 128)).astype(np.float32))
    win, rel = (_t(x) for x in _route_inputs(rng))
    a128, b128 = a[:, :128].contiguous(), b[:128]
    n = torch.tensor([20], dtype=torch.int32)
    cols = _t(rng.normal(size=(2, 8, LANE)).astype(np.float32))
    idx = pack_indices(_t(rng.random(8 * LANE) < 0.3))
    calls = {
        "probe_dot_t": lambda: probe_r18.dot_t(a128, b128, 2),
        "probe_dot_n": lambda: probe_r18.dot_n(a128, b128, 2),
        "probe_dot_bf16": lambda: probe_r18.dot_bf16(a128.bfloat16(), b128.bfloat16(), 2),
        "probe_dot_k": lambda: probe_r19.dot_k(a, b, 2),
        "probe_dot_indep": lambda: probe_r19.dot_indep(a, b, 2),
        "probe_route_loop": lambda: probe_r20.route_loop(n, win, rel[0]),
        "probe_route_dyn": lambda: probe_r20.route_dyn(n, win, rel[0]),
        "probe_route_nested": lambda: probe_r20.route_nested(n, win, rel[0]),
        "probe_route_bigread": lambda: probe_r20.route_bigread(
            n, probe_r20.bigread_idx("cpu", rows=50), win),
        "probe_take_rm": lambda: probe_r21.take_rm(cols.permute(1, 0, 2).contiguous(), idx),
        "probe_stream_take": lambda: probe_r22.stream_take(cols, idx),
    }
    assert set(calls) == {k for k in _build.COUNTERS if k.startswith("probe_")}
    for name, call in calls.items():
        before = {k: (c.launches, c.plain_calls) for k, c in _build.COUNTERS.items()}
        call()
        after = {k: (c.launches, c.plain_calls) for k, c in _build.COUNTERS.items()}
        assert after[name] == (before[name][0], before[name][1] + 1), name
        assert all(after[k] == before[k] for k in after if k != name), name
    with pytest.raises(ValueError):
        probe_r22.stream_take(cols, idx, "nocopy")       # timing modes run only on a card
    with pytest.raises(ValueError):
        probe_r19.dot_indep(a[:, :256].contiguous(), b[:256], 1)


@pytest.mark.cuda
def test_cuda_probe_kernels_match_plain_versions():
    # each module's check(): the kernels against their plain versions at the
    # scripts' shapes (reps cut for the products), the takes at 2,073,600
    # lanes x 14 planes on packed and scattered maps
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    errs = {}
    for mod in (probe_r18, probe_r19, probe_r20, probe_r21, probe_r22):
        errs.update(mod.check(dev, out=lambda line: None))
    assert set(errs) == {k for k in _build.COUNTERS if k.startswith("probe_")}
