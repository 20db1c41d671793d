"""PyTorch port: explicit uniforms, the anti-aliasing jitter and the host
assets. ``ray_uniforms``, ``draw_bounce_uniforms`` and the jitter's
threefry bits bit-equal to the JAX package's; explicit uniforms give the
keyed film; ``camera_rays`` with AA against JAX's (and a twin of
``tests/test_camera.py``'s jitter test); ``load_obj``, ``save_obj`` and
``quad`` array-equal to the JAX package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.core.camera import camera_rays as jax_camera_rays  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.render import wavefront as jw  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.objio import load_obj as jax_load_obj  # noqa: E402

from test_torch_render import _pack_scene, _tree  # noqa: E402

from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig, RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera, make_camera  # noqa: E402
from atray_tpu_torch.interop import scene_from_numpy  # noqa: E402
from atray_tpu_torch.render import wavefront as tw  # noqa: E402
from atray_tpu_torch.render import rng  # noqa: E402
from atray_tpu_torch.scene import load_obj, procedural, save_obj  # noqa: E402

ASSETS = ("Cube", "Deer", "Monkey")
ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets")
MESH_FIELDS = ("vertices", "faces", "normals", "face_normal_idx", "tex_coords",
               "face_tex_idx", "material_id")


def test_uniform_tables_bit_equal():
    # the JAX side jitted: one compile a call, not one an op
    key = jax.random.split(jax.random.PRNGKey(11))[1]
    ids = np.concatenate([np.arange(777), 2 ** 26 + np.arange(5)]).astype(np.int32)
    for channels in (3, 6):
        want = np.asarray(jax.jit(jw.ray_uniforms, static_argnums=(2, 3))(
            key, jnp.asarray(ids), 2, channels))
        got = rng.ray_uniforms(np.asarray(key), torch.from_numpy(ids), 2, channels).numpy()
        assert got.shape == (ids.size, channels)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        want = np.asarray(jax.jit(jw.draw_bounce_uniforms, static_argnums=(1, 2, 3))(
            key, 3, 501, channels))
        got = rng.draw_bounce_uniforms(np.asarray(key), 3, 501, channels, device="cpu").numpy()
        assert got.shape == (3, 501, channels)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("variant", ["compaction", "ragged chunks"])
def test_explicit_uniforms_give_the_keyed_film(variant):
    # uniforms drawn from the bounce key are the keyed draw: the film is the
    # same bit for bit, through compaction (sort + pack: the uniforms' rows
    # follow the permuted global ids) and through ragged chunks (the last
    # chunk's uniforms padded with zeros)
    scene = scene_from_numpy(_tree(_pack_scene())).to("cpu")
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=8)).to("cpu")
    cam = look_at_camera((0, 0.6, 0.7), (0, 0, -4), h_fov=0.9, aspect=2.0)
    chunk = 3000 if variant == "ragged chunks" else 0
    s = RenderSettings(resolution=(128, 64), samples_per_pixel=1, bounce_limit=4,
                       ray_chunk=chunk)
    key = rng.prng_key(6)
    keyed = tw.render(scene, cam, s, key, accel=accel, device="cpu")
    _, bounce_key = rng.split(key)
    uni = rng.draw_bounce_uniforms(bounce_key, 4, 128 * 64, device="cpu")
    explicit = tw.render(scene, cam, s, rng.prng_key(123), accel=accel, uniforms=uni,
                         device="cpu")
    assert torch.equal(keyed, explicit)
    assert float(keyed.std()) > 0.01


def test_jitter_bits_bit_equal_to_jax_uniform():
    for seed, shape in ((0, (1, 1, 1, 2)), (3, (3, 5, 7, 2)), (2 ** 40 + 5, (2, 33, 17, 2))):
        key = jax.random.PRNGKey(seed)
        want, bits = jax.jit(lambda k, shape=shape: (
            jax.random.uniform(k, shape, jnp.float32, -1.0, 1.0), jax.random.bits(k, shape)))(key)
        want, bits = np.asarray(want), np.asarray(bits).reshape(-1)
        got = rng.uniform(np.asarray(key), shape, -1.0, 1.0, device="cpu").numpy()
        assert got.shape == shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        n = int(np.prod(shape))
        np.testing.assert_array_equal(rng.random_bits(np.asarray(key), n, "cpu").numpy(),
                                      bits.astype(np.int64))
        np.testing.assert_array_equal(rng.random_bits_np(np.asarray(key), n), bits)


def test_aa_camera_rays_match_jax():
    key = jax.random.PRNGKey(21)
    jcam = jax_look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.6)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.6)
    jo, jd = jax.jit(lambda k: jax_camera_rays(jcam, 40, 25, 3, key=k, anti_aliasing=True))(key)
    o, d = camera_rays(cam, 40, 25, 3, device="cpu", anti_aliasing=True, key=np.asarray(key))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    with pytest.raises(ValueError, match="key"):
        camera_rays(cam, 4, 4, 1, device="cpu", anti_aliasing=True)
    # render() jitters with the key's first split half: AA changes the film
    scene = scene_from_numpy(_tree(_pack_scene())).to("cpu")
    s = RenderSettings(resolution=(32, 16), samples_per_pixel=1, bounce_limit=2)
    plain = tw.render(scene, cam, s, rng.prng_key(1), device="cpu")
    aa = tw.render(scene, cam, RenderSettings(resolution=(32, 16), samples_per_pixel=1,
                                              bounce_limit=2, anti_aliasing=True),
                   rng.prng_key(1), device="cpu")
    assert torch.isfinite(aa).all() and not torch.equal(plain, aa)


def test_aa_jitter_stays_in_pixel():
    w, h = 8, 8
    cam = make_camera((0, 0, 0), (0, 0, -1), h_fov=1.0, aspect=1.0)
    _, d0 = camera_rays(cam, w, h, 1, device="cpu")
    _, dj = camera_rays(cam, w, h, 1, device="cpu", anti_aliasing=True, key=rng.prng_key(3))
    d0, dj = d0.numpy(), dj.numpy()
    assert not np.allclose(d0, dj)
    # one pixel spans about 2/w film units; a generous angular bound
    assert np.all(np.sum(d0 * dj, axis=1) > np.cos(4.0 / w))


def test_load_obj_matches_jax_python_parser():
    # the JAX side's Python backend: its native parser is built in place
    # and may be mid-write under parallel test workers
    for name in ASSETS:
        path = os.path.join(ASSET_DIR, f"{name}.obj")
        want = jax_load_obj(path, backend="python")
        # "auto" takes the port's native parser, as the JAX package's does
        for backend in ("auto", "native", "python"):
            got = load_obj(path, backend=backend)
            for f in MESH_FIELDS:
                a, b = np.asarray(getattr(want, f)), getattr(got, f)
                assert a.dtype == b.dtype, (name, backend, f)
                np.testing.assert_array_equal(b, a, err_msg=f"{name} {backend} {f}")


def test_save_obj_round_trip(tmp_path):
    for mesh in (load_obj(os.path.join(ASSET_DIR, "Monkey.obj")),
                 procedural.uv_sphere(6, 8, smooth=True),
                 procedural.quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), material=3)):
        path = str(tmp_path / "m.obj")
        save_obj(path, mesh)
        back = load_obj(path, default_material=int(mesh.material_id[0]))
        for f in ("faces", "face_normal_idx", "face_tex_idx", "material_id"):
            np.testing.assert_array_equal(getattr(back, f), getattr(mesh, f), err_msg=f)
        np.testing.assert_allclose(back.vertices, mesh.vertices, rtol=1e-6, atol=1e-7)


def test_quad_matches_jax():
    corners = ((-1.2, 2.3, -5.0), (1.2, 2.3, -5.0), (1.2, 2.3, -3.0), (-1.2, 2.3, -3.0))
    want = jax_procedural.quad(*corners, material=3)
    got = procedural.quad(*corners, material=3)
    for f in MESH_FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
