"""PyTorch port: the lane take and scatter (``kernels/lane_pack.py``)
against the JAX Pallas kernels (interpret mode) and numpy, their autograd
pair against ``jax.vjp``, and the state pack's exactness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.kernels.lane_pack import lane_scatter as jax_lane_scatter  # noqa: E402
from atray_tpu.kernels.lane_pack import lane_scatter_p as jax_lane_scatter_p  # noqa: E402
from atray_tpu.kernels.lane_pack import lane_take as jax_lane_take  # noqa: E402
from atray_tpu.kernels.lane_pack import lane_take_p as jax_lane_take_p  # noqa: E402
from atray_tpu.kernels.lane_pack import pack_indices as jax_pack_indices  # noqa: E402
from atray_tpu.kernels.lane_pack import unpack_indices as jax_unpack_indices  # noqa: E402

from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.kernels.lane_pack import (  # noqa: E402
    GROUP_BYTES,
    L2_BYTES,
    lane_scatter,
    lane_scatter_p,
    lane_scatter_ref,
    lane_take,
    lane_take_p,
    lane_take_ref,
    pack_indices,
    plane_group,
    unpack_indices,
)
from atray_tpu_torch.kernels.treelet_pairs import bin_pairs, pair_cap, pair_slots  # noqa: E402
from atray_tpu_torch.render.wavefront import WaveState, _lane_pack_state  # noqa: E402

LANE = 128


def _numpy_take(flat, idx):
    out = np.zeros_like(flat)
    ok = idx >= 0
    out[:, ok] = flat[:, idx[ok]]
    return out


@pytest.mark.parametrize("occupancy", [0.4, 0.9])
def test_matches_jax_lane_take_on_banded_maps(rng, occupancy):
    rows, c = 24, 5
    n = rows * LANE
    cols = rng.normal(size=(c, rows, LANE)).astype(np.float32)
    alive = rng.random(n) < occupancy
    pidx = np.array(jax_pack_indices(jnp.asarray(alive)))
    uidx = np.array(jax_unpack_indices(jnp.asarray(alive)))
    for idx in (pidx, uidx):
        ref = np.asarray(jax_lane_take(jnp.asarray(cols), jnp.asarray(idx), wcap=8,
                                       interpret=True)).reshape(c, n)
        got = lane_take(torch.from_numpy(cols.reshape(c, n)), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_pack_and_unpack_indices_match_jax(rng):
    alive = rng.random(64 * LANE) < 0.3
    alive[:500] = False
    np.testing.assert_array_equal(pack_indices(torch.from_numpy(alive)).numpy(),
                                  np.asarray(jax_pack_indices(jnp.asarray(alive))))
    np.testing.assert_array_equal(unpack_indices(torch.from_numpy(alive)).numpy(),
                                  np.asarray(jax_unpack_indices(jnp.asarray(alive))))
    assert pack_indices(torch.from_numpy(alive)).dtype == torch.int32


def test_scattered_map_and_word_exactness(rng):
    # no band limit: any permutation works; words move bit-exactly, NaN
    # payloads and denormals included
    c, n = 4, 10_000
    words = rng.integers(-2 ** 31, 2 ** 31, size=(c, n), dtype=np.int64).astype(np.int32)
    words[0, :8] = [0x7FC00001, 0x7F800001, 0x00000001, -1, 0x00000009, 0xFFC00000 - 2 ** 32,
                    0x80000001 - 2 ** 32, 0x7F7FFFFF]
    idx = rng.permutation(n).astype(np.int32)
    idx[rng.random(n) < 0.05] = -1
    idx[:8] = np.arange(8)
    want = _numpy_take(words, idx)
    got = lane_take(torch.from_numpy(words), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    got_f = lane_take(torch.from_numpy(words.view(np.float32)), torch.from_numpy(idx))
    np.testing.assert_array_equal(got_f.numpy().view(np.int32), want)
    # indices at or past N give 0 in both versions
    idx[9] = n
    assert int(lane_take_ref(torch.from_numpy(words), torch.from_numpy(idx))[0, 9]) == 0


def test_wrapper_checks_inputs(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    cols = torch.zeros((3, 256))
    with pytest.raises(TypeError):
        lane_take(cols, torch.zeros(256, dtype=torch.int64))
    with pytest.raises(TypeError):
        lane_take(cols.double(), torch.zeros(256, dtype=torch.int32))
    with pytest.raises(TypeError):
        lane_take(cols, torch.zeros(255, dtype=torch.int32))
    with pytest.raises(ValueError):
        lane_take(torch.zeros((256, 3)).t(), torch.zeros(256, dtype=torch.int32))
    before = _build.COUNTERS["lane_take"].plain_calls
    lane_take(cols, torch.zeros(256, dtype=torch.int32))
    assert _build.COUNTERS["lane_take"].plain_calls == before + 1


def test_lane_pack_gid_exact_beyond_f32_int_range():
    # the twin of the reference's test of the same name: global ray ids
    # past 2**24 ride the pack as one int32 plane and stay exact
    n = 64 * 128 * 2
    rng = np.random.default_rng(0)
    alive = torch.from_numpy(rng.random(n) < 0.4)
    base = 2 ** 25 + 3
    gid = torch.arange(base, base + n, dtype=torch.int32)
    f = torch.zeros(n)
    st = WaveState(f, f, f, f, f, torch.ones(n), f, f, f, f, f, f, alive, gid,
                   torch.zeros((), dtype=torch.int64))
    packed, restore = _lane_pack_state(st)
    got = packed.gid[packed.alive].numpy()
    want = gid[alive].numpy()
    np.testing.assert_array_equal(got, want)          # stable: same order
    assert len(np.unique(got)) == len(got)
    assert packed.gid.dtype == torch.int32
    # the restore routes packed colours back; rays dead at pack time keep theirs
    col = torch.arange(n, dtype=torch.float32)
    back = restore(col[: n], col[: n], col[: n])[0]
    live_pos = torch.cumsum(alive.to(torch.int64), 0) - 1
    np.testing.assert_array_equal(back[alive].numpy(), live_pos[alive].numpy().astype(np.float32))
    assert torch.all(back[~alive] == 0)


def _scatter_maps(rng, n):
    alive = rng.random(n) < 0.45
    alive[:300] = False
    pidx = np.array(jax_pack_indices(jnp.asarray(alive)))
    uidx = np.array(jax_unpack_indices(jnp.asarray(alive)))
    dup = (np.arange(n) // 2).astype(np.int32)     # every target hit twice
    dup[rng.random(n) < 0.05] = -1
    return {"pack": pidx, "unpack": uidx, "duplicates": dup}


@pytest.mark.parametrize("c", [3, 12])
def test_lane_scatter_matches_jax_lane_scatter(rng, c):
    rows = 64
    n = rows * LANE
    cols = rng.normal(size=(c, rows, LANE)).astype(np.float32)
    for name, dst in _scatter_maps(rng, n).items():
        ref = np.asarray(jax_lane_scatter(jnp.asarray(cols), jnp.asarray(dst), wcap=64,
                                          interpret=True)).reshape(c, n)
        got = lane_scatter(torch.from_numpy(cols.reshape(c, n)), torch.from_numpy(dst)).numpy()
        if name == "duplicates":
            # two addends in another order may round differently
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref)
        want = np.zeros((c, n), np.float32)
        ok = dst >= 0
        np.add.at(want.T, dst[ok], cols.reshape(c, n).T[ok])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_lane_scatter_any_map_and_edges(rng):
    # no band and no monotonicity: a random many-to-one map sums in input
    # order; out-of-range targets drop, untargeted lanes stay 0
    c, n = 2, 5000
    cols = rng.normal(size=(c, n)).astype(np.float32)
    dst = rng.integers(-1, n // 3, n).astype(np.int32)
    dst[:4] = [n, n + 7, -5, 0]
    want = np.zeros((c, n), np.float32)
    ok = (dst >= 0) & (dst < n)
    for i in np.nonzero(ok)[0]:
        want[:, dst[i]] += cols[:, i]
    got = lane_scatter_ref(torch.from_numpy(cols), torch.from_numpy(dst)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[:, n // 3:] == 0)
    empty = lane_scatter_ref(torch.from_numpy(cols), torch.full((n,), -1, dtype=torch.int32))
    assert not empty.any()


@pytest.mark.parametrize("direction", ["take", "scatter"])
def test_lane_autograd_pair_matches_jax_vjp(rng, direction):
    # each direction's backward is the other kernel with the same index
    rows, c = 64, 3
    n = rows * LANE
    cols = rng.normal(size=(c, rows, LANE)).astype(np.float32)
    ct = rng.normal(size=(c, rows, LANE)).astype(np.float32)
    maps = _scatter_maps(rng, n)
    for name in ("pack", "unpack"):
        idx = maps[name]
        jfn = jax_lane_take_p if direction == "take" else jax_lane_scatter_p
        tfn = lane_take_p if direction == "take" else lane_scatter_p
        jy, vjp = jax.vjp(lambda x: jfn(x, jnp.asarray(idx), 64), jnp.asarray(cols))
        (jg,) = vjp(jnp.asarray(ct))
        x = torch.from_numpy(cols.reshape(c, n)).requires_grad_()
        y = tfn(x, torch.from_numpy(idx))
        (g,) = torch.autograd.grad(y, x, torch.from_numpy(ct.reshape(c, n)))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy).reshape(c, n))
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg).reshape(c, n))


def test_lane_scatter_wrapper_checks_inputs(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    cols = torch.zeros((3, 256))
    with pytest.raises(TypeError):
        lane_scatter(cols.to(torch.int32), torch.zeros(256, dtype=torch.int32))
    with pytest.raises(TypeError):
        lane_scatter(cols, torch.zeros(256, dtype=torch.int64))
    with pytest.raises(ValueError):
        lane_scatter(torch.zeros((256, 3)).t(), torch.zeros(256, dtype=torch.int32))
    before = _build.COUNTERS["lane_scatter"].plain_calls
    lane_scatter(cols, torch.zeros(256, dtype=torch.int32))
    assert _build.COUNTERS["lane_scatter"].plain_calls == before + 1


def _offset_planes(flat, c, n):
    """(c, n) planes of ``flat`` that start one word (4 bytes) past its
    base: a contiguous view whose planes sit off 16-byte boundaries."""
    return flat[1:1 + c * n].view(c, n)


@pytest.mark.cuda
def test_cuda_scatter_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    for n in (300_000, 300_001, 65_553):          # N % 4 = 0, 1 and 1 (ragged)
        cols = torch.from_numpy(rng.normal(size=(12, n)).astype(np.float32)).cuda()
        view = _offset_planes(torch.from_numpy(rng.normal(size=12 * n + 1).astype(np.float32))
                              .cuda(), 12, n)
        alive = torch.from_numpy(rng.random(n) < 0.6).cuda()
        for x in (cols, view):
            for idx in (pack_indices(alive), unpack_indices(alive)):
                assert torch.equal(lane_scatter(x, idx), lane_scatter_ref(x, idx))
            dup = torch.from_numpy((np.arange(n) // 3).astype(np.int32)).cuda()
            assert torch.allclose(lane_scatter(x, dup), lane_scatter_ref(x, dup), rtol=1e-6,
                                  atol=1e-6)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    for n in (300_000, 300_003, 65_553):          # N % 4 = 0, 3 and 1 (ragged)
        words = rng.integers(-2 ** 31, 2 ** 31, size=14 * n + 1, dtype=np.int64).astype(np.int32)
        cols = torch.from_numpy(words[:14 * n].reshape(14, n)).cuda()
        view = _offset_planes(torch.from_numpy(words).cuda(), 14, n)
        alive = torch.from_numpy(rng.random(n) < 0.6).cuda()
        scat = rng.permutation(n).astype(np.int32)
        scat[rng.random(n) < 0.05] = -1
        for x in (cols, view):
            for idx in (pack_indices(alive), unpack_indices(alive),
                        torch.from_numpy(scat).cuda()):
                assert torch.equal(lane_take(x, idx), lane_take_ref(x, idx))


def _numpy_scatter(flat, dst):
    out = np.zeros_like(flat)
    ok = (dst >= 0) & (dst < flat.shape[1])
    np.add.at(out.T, dst[ok], flat.T[ok])
    return out


@pytest.mark.parametrize("direction", ["take", "scatter"])
@pytest.mark.parametrize("rem", [1, 2, 3])
def test_plain_versions_at_ragged_n(rng, direction, rem):
    # N % 4 != 0 (the card's kernels own lanes in fours): the plain
    # versions, which the CPU path runs, against numpy on every map kind
    c, n = 3, 4 * 250 + rem
    flat = rng.normal(size=(c, n)).astype(np.float32)
    alive = torch.from_numpy(rng.random(n) < 0.6)
    scat = rng.permutation(n).astype(np.int32)
    scat[rng.random(n) < 0.1] = -1
    dup = (np.arange(n) // 2).astype(np.int32)
    for idx in (pack_indices(alive).numpy(), unpack_indices(alive).numpy(), scat, dup):
        if direction == "take":
            got = lane_take(torch.from_numpy(flat), torch.from_numpy(idx)).numpy()
            np.testing.assert_array_equal(got, _numpy_take(flat, idx))
        else:
            got = lane_scatter(torch.from_numpy(flat), torch.from_numpy(idx)).numpy()
            np.testing.assert_allclose(got, _numpy_scatter(flat, idx), rtol=1e-6, atol=1e-6)


def _pair_route(rng, r=3000, k=4, treelets=37):
    """The pair path's routing: random candidates (-1 = empty slot, each
    ray's candidates distinct), binned by the port's ``bin_pairs`` and
    capped; returns (slot map, cap, keys)."""
    tids = np.full((k, r), -1, np.int32)
    for ray in range(r):
        m = rng.integers(0, k + 1)
        tids[:m, ray] = rng.choice(treelets, size=m, replace=False)
    tids = torch.from_numpy(tids)
    cap = pair_cap(r, k, 0.5)
    keys, perm, _ = bin_pairs(tids, treelets, cap)
    return pair_slots(keys, perm, cap), cap, keys


def test_pair_routing_map_take_matches_numpy(rng):
    slot, cap, keys = _pair_route(rng)
    n = slot.shape[0]
    # the slot map is the capped inverse of a stable sort of the slot keys
    order = np.argsort(keys.numpy(), kind="stable")
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    np.testing.assert_array_equal(slot.numpy(), np.where(inv < cap, inv, -1))
    assert 0 < int((slot >= 0).sum()) <= cap
    # the route: result words of the first cap sorted slots, zero-padded to K*R
    words = np.zeros((6, n), np.int32)
    words[:, :cap] = rng.integers(-2 ** 31, 2 ** 31, size=(6, cap), dtype=np.int64)
    got = lane_take(torch.from_numpy(words), slot).numpy()
    np.testing.assert_array_equal(got, _numpy_take(words, slot.numpy()))


def _transpose_maps(rng, n):
    alive = torch.from_numpy(rng.random(n) < 0.55)
    dup = (np.arange(n) // 2).astype(np.int32)
    dup[rng.random(n) < 0.05] = -1
    return {"pack": pack_indices(alive), "unpack": unpack_indices(alive),
            "pair": _pair_route(rng, r=n // 4)[0], "duplicates": torch.from_numpy(dup)}


@pytest.mark.parametrize("name", ["pack", "unpack", "pair", "duplicates"])
def test_take_and_scatter_are_transposes(rng, name):
    # <take(x, idx), y> == <x, scatter(y, idx)>; small integers keep every
    # float32 sum exact, so the two sides must agree exactly
    idx = _transpose_maps(rng, 4 * 1031)[name]
    c, n = 3, idx.shape[0]
    x = rng.integers(-8, 9, size=(c, n)).astype(np.float32)
    y = rng.integers(-8, 9, size=(c, n)).astype(np.float32)
    tx = lane_take(torch.from_numpy(x), idx).numpy().astype(np.float64)
    sy = lane_scatter(torch.from_numpy(y), idx).numpy().astype(np.float64)
    assert np.sum(tx * y) == np.sum(x * sy)
    assert np.any(tx != 0) and np.any(sy != 0)


def test_injective_scatter_of_negative_zero_gives_positive_zero(rng):
    # the add onto +0.0 (as the kernel's atomics do): -0.0 + +0.0 = +0.0
    n = 1031
    cols = torch.full((2, n), -0.0)
    for dst in (torch.from_numpy(rng.permutation(n).astype(np.int32)),
                pack_indices(torch.from_numpy(rng.random(n) < 0.5))):
        out = lane_scatter(cols, dst).numpy()
        assert not np.signbit(out).any()
        assert not np.any(out)


def test_plane_group_fits_the_budget():
    chunk = 1920 * 1080 * 2
    # two planes of a slice chunk, four of the gradient chunk, all planes
    # where one plane and the index overflow L2 (the pair routing maps of
    # the slice chunk and of the gradient chunk), and all planes of a small
    # launch
    assert plane_group(chunk, 14) == 2
    assert plane_group(chunk // 2, 12) == 4
    assert plane_group(4 * chunk, 6) == 6
    assert plane_group(2 * chunk, 6) == 6
    assert plane_group(65_553, 3) == 3
    assert plane_group(65_553, 15) == 15
    assert plane_group(chunk, 1) == 1
    assert plane_group(0, 3) == 3


def test_plane_group_bounds():
    for n in (1, 3, 1000, 1024, 65_553, 2_073_600, 4_147_200, 6_553_600, 6_553_601,
              8_294_400, 8_388_608, 8_388_609, 16_588_800):
        for c in (1, 2, 3, 6, 12, 14, 15):
            g = plane_group(n, c)
            assert 1 <= g <= c
            if 8 * n > L2_BYTES:
                assert g == c                  # one group: the index read once
            else:
                assert g * 4 * n <= GROUP_BYTES
                assert (g + 1) * 4 * n <= L2_BYTES or g == c
                assert g == c or (g + 1) * 4 * n > GROUP_BYTES
