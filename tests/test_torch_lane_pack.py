"""PyTorch port: the lane take (``kernels/lane_pack.py``) against the JAX
Pallas take (interpret mode) and numpy, and the state pack's exactness."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.kernels.lane_pack import lane_take as jax_lane_take  # noqa: E402
from atray_tpu.kernels.lane_pack import pack_indices as jax_pack_indices  # noqa: E402
from atray_tpu.kernels.lane_pack import unpack_indices as jax_unpack_indices  # noqa: E402

from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.kernels.lane_pack import (  # noqa: E402
    lane_take,
    lane_take_ref,
    pack_indices,
    unpack_indices,
)
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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    n = 300_000
    cols = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(14, n),
                                         dtype=np.int64).astype(np.int32)).cuda()
    alive = torch.from_numpy(rng.random(n) < 0.6).cuda()
    scat = rng.permutation(n).astype(np.int32)
    scat[rng.random(n) < 0.05] = -1
    for idx in (pack_indices(alive), unpack_indices(alive), torch.from_numpy(scat).cuda()):
        assert torch.equal(lane_take(cols, idx), lane_take_ref(cols, idx))
