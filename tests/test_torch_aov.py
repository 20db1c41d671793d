"""PyTorch port, AOV passes: twins of ``tests/test_aov.py`` against the JAX
package's ``render_aovs`` (brute force and a binary BVH on both sides), and
the AOVs through the port's ``ShadedWideBVH`` (``wide_shade`` via
``nearest_hit_ids``) against brute force. No JAX interpret-mode call."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from atray_tpu.accel.bvh import build_bvh as jax_build_bvh  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.render import aov as jaov  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.data import Planes as JaxPlanes  # noqa: E402
from atray_tpu.scene.data import Spheres as JaxSpheres  # noqa: E402
from atray_tpu.scene.data import make_materials as jax_make_materials  # noqa: E402
from atray_tpu.scene.transforms import translate as jax_translate  # noqa: E402
from test_render_oracle import _textured_scene  # noqa: E402
from test_torch_texture import port_scene, textured_mix  # noqa: E402

from atray_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.render.aov import aov_preview_films, render_aovs  # noqa: E402
from atray_tpu_torch.render.wavefront import nearest_hit_ids  # noqa: E402

W, H = 48, 36
EYE, TARGET = (0.0, 0.5, 1.0), (0.0, 0.0, -4.0)
MATS = jax_make_materials([
    ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
    ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),
    ((0.0, 0.0, 0.0), (0.8, 0.2, 0.2), 0.7),
    ((4.0, 3.5, 3.0), (0.0, 0.0, 0.0), 0.0),
])


def _jscene():
    """``tests/test_aov.py``'s scene: a cube, a light sphere, a floor."""
    cube = jax_translate(jax_procedural.cube(size=1.5, material=2), (0.0, -0.5, -4.0))
    spheres = JaxSpheres(centers=np.asarray([[1.6, 0.2, -5.0]], np.float32),
                         radii=np.asarray([0.8], np.float32),
                         material_id=np.asarray([3], np.int32))
    planes = JaxPlanes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                       offsets=np.asarray([-1.5], np.float32),
                       material_id=np.asarray([1], np.int32))
    return jax_build_scene([cube], spheres=spheres, planes=planes, materials=MATS)


def _both(jscene, eye=EYE, target=TARGET, jax_accel=None, accel=None):
    """(port AOVs as numpy, JAX AOVs as numpy)."""
    cam = look_at_camera(eye, target, h_fov=0.9, aspect=W / H)
    jcam = jax_look_at_camera(eye, target, h_fov=0.9, aspect=W / H)
    got = render_aovs(port_scene(jscene), cam, W, H, accel=accel, device="cpu")
    want = jax.jit(lambda s: jaov.render_aovs(s, jcam, W, H, accel=jax_accel))(jscene)
    return ({k: v.detach().numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def _hold(got, want):
    for k in want:
        if k in ("material_id", "hit"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            # test_aov.py's depth rule: a floor's depth reaches the hundreds
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_aov_depth_matches_nearest_hit_and_jax():
    jscene = _jscene()
    got, want = _both(jscene)
    _hold(got, want)
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=W / H)
    o, d = camera_rays(cam, W, H, 1, device="cpu")
    ids = nearest_hit_ids(port_scene(jscene), o, d)
    t = ids.t.numpy().reshape(H, W)
    hit = ids.prim_id.numpy().reshape(H, W) >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(got["depth"][hit], t[hit], rtol=1e-4, atol=1e-4)
    assert (got["depth"][~hit] == 0.0).all()
    np.testing.assert_array_equal(got["hit"] > 0.5, hit)


def test_aov_normals_unit_and_materials_consistent():
    jscene = _jscene()
    got, _ = _both(jscene)
    hit = got["hit"] > 0.5
    np.testing.assert_allclose(np.linalg.norm(got["normal"][hit], axis=-1), 1.0, atol=1e-4)
    assert (np.linalg.norm(got["normal"][~hit], axis=-1) == 0.0).all()
    mid = got["material_id"]
    assert (mid[~hit] == -1).all()
    np.testing.assert_allclose(got["albedo"][hit], np.asarray(MATS.albedo)[mid[hit]], atol=1e-6)
    assert got["emission"][mid == 3].max() > 3.0


def test_aov_bvh_matches_brute_force_and_jax():
    jscene = _jscene()
    scene = port_scene(jscene)
    accel = build_bvh(scene.mesh.vertices.numpy(), scene.mesh.faces.numpy()).to("cpu")
    jaccel = jax_build_bvh(jscene.mesh.vertices, jscene.mesh.faces)
    got, want = _both(jscene, jax_accel=jaccel, accel=accel)
    _hold(got, want)
    brute, _ = _both(jscene)
    for k in brute:
        np.testing.assert_allclose(got[k], brute[k], atol=1e-5, err_msg=k)


def test_aov_albedo_textured_matches_jax():
    # the oracle suite's textured quad: the albedo AOV carries the checker
    got, want = _both(_textured_scene(), eye=(0.0, 2.5, 0.5), target=(0.0, 0.0, -3.0))
    _hold(got, want)
    hit = got["hit"] > 0.5
    assert hit.sum() > 20
    assert np.unique(got["albedo"][hit].round(4), axis=0).shape[0] >= 2


def test_aov_shaded_accel_matches_brute_force():
    # the textured mix through wide_shade (nearest_hit_ids) against the
    # brute-force walk, one launch of the plain version
    scene = port_scene(textured_mix())
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=4)).to("cpu")
    cam = look_at_camera(EYE, (0.0, -0.4, -4.0), h_fov=0.9, aspect=W / H)
    brute = render_aovs(scene, cam, W, H, device="cpu")
    before = _build.COUNTERS["wide_shade"].plain_calls
    fast = render_aovs(scene, cam, W, H, accel=accel, device="cpu")
    assert _build.COUNTERS["wide_shade"].plain_calls - before == 1
    for k in brute:
        if k in ("material_id", "hit"):
            assert torch.equal(fast[k], brute[k]), k
        else:
            np.testing.assert_allclose(fast[k].numpy(), brute[k].numpy(), atol=1e-6, err_msg=k)
    assert len(torch.unique(brute["material_id"])) >= 2


def test_aov_preview_films_match_jax():
    jscene = _jscene()
    got, want = _both(jscene)
    films = aov_preview_films({k: torch.from_numpy(v) for k, v in got.items()})
    ref = jaov.aov_preview_films({k: jnp.asarray(v) for k, v in got.items()})
    for k in ("depth", "normal", "albedo", "emission"):
        f = films[k].numpy()
        assert f.shape == (H, W, 3)
        assert np.isfinite(f).all() and f.min() >= 0.0 and f.max() <= 1.0
        np.testing.assert_allclose(f, np.asarray(ref[k]), atol=1e-6, err_msg=k)
    # the depth scale is twice the mean hit depth
    hit = got["hit"] > 0.5
    dmax = 2.0 * got["depth"][hit].mean()
    np.testing.assert_allclose(films["depth"][..., 0].numpy(),
                               np.clip(got["depth"] / dmax, 0.0, 1.0), atol=1e-6)


def test_aov_depth_gradient_matches_jax():
    jscene = _jscene()
    jcam = jax_look_at_camera(EYE, TARGET, h_fov=0.9, aspect=W / H)

    def loss(verts):
        s = dataclasses.replace(jscene, mesh=dataclasses.replace(jscene.mesh, vertices=verts))
        return jnp.sum(jaov.render_aovs(s, jcam, W, H)["depth"])

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(jscene.mesh.vertices)))
    scene = port_scene(jscene)
    verts = scene.mesh.vertices.clone().requires_grad_()
    sc = dataclasses.replace(scene, mesh=dataclasses.replace(scene.mesh, vertices=verts))
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=W / H)
    got, = torch.autograd.grad(render_aovs(sc, cam, W, H, device="cpu")["depth"].sum(), [verts])
    assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())
