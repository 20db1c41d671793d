"""PyTorch port: the geometry-sharded treelet render (``dist/treelet.py``'s
forward backends and one rank of its differentiable one, ``trace_radiance``'s
overrides, ``wide_shade_first_hit``,
the command line's ``--treelet``): twins of ``tests/test_treelet.py``.

As in ``tests/test_torch_dist.py`` (whose ``spawn_ranks`` it uses), one
spawn of 3 gloo ranks runs every case's rank side, and the cases assert in
the parent. The ranks import this file, so it imports nothing of JAX at
module level; the JAX side renders only by brute force (``TreeletGeom``),
with no Pallas kernel and no interpret mode. The port's ``TreeletAccels``
hops run the plain ``wide_shade`` here."""

import dataclasses
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_dist import _cli, spawn_ranks  # noqa: E402

from atray_tpu_torch import cli  # noqa: E402
from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig, RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.core.intersect import (  # noqa: E402
    first_triangle_hit,
    moller_trumbore,
    normalize,
)
from atray_tpu_torch.dist.mesh import make_device_mesh  # noqa: E402
from atray_tpu_torch.dist.treelet import (  # noqa: E402
    build_treelet_accels,
    build_treelet_parts,
    build_treelets,
    partition_faces,
    render_treelet,
    ring_first_fid,
    ring_first_hit,
    ring_first_hit_accel,
)
from atray_tpu_torch.interop import scene_from_numpy  # noqa: E402
from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.kernels.wide_shade import wide_shade_first_hit, wide_shade_planes  # noqa: E402
from atray_tpu_torch.render.film import save_png  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402
from atray_tpu_torch.render.wavefront import (  # noqa: E402
    build_face_table,
    render,
    resolve_material_rows,
    trace_radiance,
)
from atray_tpu_torch.scene.data import SceneParams, empty_mesh  # noqa: E402

WORLD = 3
EYE, TARGET = (0.0, 0.4, 0.6), (0.0, 0.0, -4.0)
FILM = RenderSettings(resolution=(16, 16), samples_per_pixel=2, bounce_limit=3)
NEE = RenderSettings(resolution=(12, 12), samples_per_pixel=1, bounce_limit=2, nee=True)
LEAF8 = KDTreeConfig(leaf_size=8)

# a uv sphere (12 x 12, 264 faces: kernel accels at leaf 4) or a cube (12
# faces: brute force at leaf 8) under a light sphere, 20x12 x 2 spp x 2
TOML = """
[render]
resolution = [20, 12]
samples_per_pixel = 2
bounce_limit = 2

[accel]
leaf_size = {leaf}

[camera]
eye = [0.0, 0.5, 1.0]
look_at = [0.0, 0.0, -4.0]
h_fov = 0.9

[[materials]]
name = "sky"
emission = [0.1, 0.12, 0.2]

[[materials]]
name = "body"
albedo = [0.8, 0.5, 0.3]
scatter = 0.2

[[materials]]
name = "light"
emission = [5.0, 4.5, 4.0]

[[meshes]]
procedural = "{kind}"
rows = 12
cols = 12
material = "body"
translate_to = [0.0, 0.0, -4.0]

[[spheres]]
center = [1.2, 1.5, -3.5]
radius = 0.5
material = "light"
"""
CLI_CASES = {"accels": ("uv_sphere", 4, []), "brute_nee": ("cube", 8, ["--nee"])}


def _treelet_rank(rank, job, out):
    """The rank side of every case."""
    mesh = make_device_mesh(WORLD, device="cpu")
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    res = {}
    # the rings on this rank's 8 of the 24 rays
    scene = scene_from_numpy(job["scenes"]["geom"])
    o, d = (torch.from_numpy(x[8 * rank:8 * (rank + 1)]) for x in job["rays"])
    t, n, mat, hit, fid = ring_first_hit(build_treelets(scene, WORLD).local(rank, "cpu"),
                                         o, d, mesh)
    res.update(ring_t=t.numpy(), ring_n=n.numpy(), ring_fid=fid.numpy(), ring_hit=hit.numpy())
    t, fid = ring_first_fid(build_treelets(scene, WORLD).local(rank, "cpu"), o, d, mesh)
    res.update(fid_t=t.numpy(), fid_fid=fid.numpy())
    acc = build_treelet_accels(scene, WORLD, LEAF8).local(rank, "cpu")
    t, n, mat, fid = ring_first_hit_accel(acc, o, d, torch.ones(8, dtype=torch.bool), mesh)
    res.update(accel_t=t.numpy(), accel_n=n.numpy(), accel_fid=fid.numpy())
    # the films
    res["geom_film"] = render_treelet(scene, cam, FILM, prng_key(0), mesh).numpy()
    for name, s, key in (("accels", FILM, 0), ("nee", NEE, 2)):
        scene = scene_from_numpy(job["scenes"][name])
        ta = build_treelet_accels(scene, WORLD, LEAF8)
        before = _build.COUNTERS["wide_shade"].plain_calls
        hops = []
        film, st = render_treelet(scene, cam, s, prng_key(key), mesh, treelets=ta,
                                  return_stats=True, hop_log=hops)
        res[f"{name}_film"] = film.numpy()
        res[f"{name}_calls"] = _build.COUNTERS["wide_shade"].plain_calls - before
        res[f"{name}_hops"] = np.asarray([[h["hop"], h["rays"], h["bytes"]] for h in hops])
        res[f"{name}_per_shard"] = st["rays_cast_per_shard"].numpy()
    # the command line, and the direct render it stands for
    for name, (kind, leaf, extra) in CLI_CASES.items():
        toml = os.path.join(out, f"{name}.toml")
        png = os.path.join(out, f"cli_{name}_rank{rank}.png")
        rc, err = _cli(["render", toml, "-o", png, "--treelet", "--device", "cpu",
                        "--dist-backend", "gloo"] + extra)
        assert rc == 0
        scene, cam_t, s, accel_cfg, _ = cli.load_scene_file(toml)
        s = dataclasses.replace(s, nee=bool(extra))
        ta = (build_treelet_accels(scene, WORLD, accel_cfg)
              if scene.mesh.num_faces >= WORLD * accel_cfg.leaf_size else None)
        film = render_treelet(scene, cam_t, s, prng_key(0), mesh, treelets=ta)
        res[f"cli_{name}_accels"] = ta is not None
        if rank == 0:
            save_png(os.path.join(out, f"direct_{name}.png"), film)
            with open(os.path.join(out, f"cli_{name}.err"), "w") as fh:
                fh.write(err)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def _jax_scene(rows=12, cols=12, light=False):
    """``tests/test_treelet.py``'s scenes: a smooth uv sphere, with a light
    sphere for the NEE case."""
    from atray_tpu.scene import build_scene, procedural
    from atray_tpu.scene.data import Spheres, make_materials
    from atray_tpu.scene.transforms import translate

    rows_ = [((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0), ((0.0, 0.0, 0.0), (0.8, 0.5, 0.3), 0.2)]
    if light:
        rows_ = [((0.2, 0.25, 0.35), (0.0, 0.0, 0.0), 0.0), rows_[1],
                 ((5.0, 4.5, 4.0), (0.0, 0.0, 0.0), 0.0)]
    mesh = translate(procedural.uv_sphere(rows=rows, cols=cols, material=1, smooth=True),
                     (0, 0, -4))
    spheres = None
    if light:
        spheres = Spheres(centers=np.asarray([[1.5, 2.0, -3.0]], np.float32),
                          radii=np.asarray([0.6], np.float32),
                          material_id=np.asarray([2], np.int32))
    return build_scene([mesh], spheres=spheres, materials=make_materials(rows_))


@pytest.fixture(scope="module")
def jax_scenes():
    return {"geom": _jax_scene(), "accels": _jax_scene(14, 14),
            "nee": _jax_scene(10, 10, light=True)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_scenes):
    """(job, {rank: results}, out dir) of the one spawn of 3 ranks."""
    from test_torch_render import _tree

    out = str(tmp_path_factory.mktemp("treelet_ranks"))
    for name, (kind, leaf, _) in CLI_CASES.items():
        with open(os.path.join(out, f"{name}.toml"), "w") as fh:
            fh.write(TOML.format(kind=kind, leaf=leaf))
    rng = np.random.default_rng(1234)
    r = 8 * WORLD
    orig = (rng.normal(0, 0.3, (r, 3)) + [0.0, 0.0, 0.5]).astype(np.float32)
    dirn = rng.normal(size=(r, 3))
    dirn[:r // 2] = [0.0, 0.0, -4.0] - orig[:r // 2]     # half aimed at the mesh
    dirn = (dirn / np.linalg.norm(dirn, axis=1, keepdims=True)).astype(np.float32)
    job = {"scenes": {k: _tree(v) for k, v in jax_scenes.items()}, "rays": (orig, dirn)}
    spawn_ranks(_treelet_rank, job, out)
    res = {k: dict(np.load(os.path.join(out, f"rank{k}.npz"))) for k in range(WORLD)}
    return job, res, out


def _replicated(job, name, s, key):
    scene = scene_from_numpy(job["scenes"][name])
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    return render(scene, cam, s, prng_key(key), accel=build_shaded_accel(scene, LEAF8),
                  device="cpu").numpy()


def test_partition_faces_matches_reference(jax_scenes):
    from atray_tpu.dist.treelet import partition_faces as jax_partition_faces

    v = np.asarray(jax_scenes["geom"].mesh.vertices)
    f = np.asarray(jax_scenes["geom"].mesh.faces)
    for n in (1, 2, 3, 8):
        got, want = partition_faces(v, f, n), jax_partition_faces(v, f, n)
        assert len(got) == n and max(map(len, got)) - min(map(len, got)) <= 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_treelet_tables_equal_jax_build(jax_scenes):
    # the brute-force records (ids exact, geometry within 1e-6), and each
    # part of the kernel accels equal to the JAX build's slice bit for bit,
    # remapped global face ids and padding included, built by one builder
    from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig
    from atray_tpu.dist.treelet import build_treelet_accels as jax_build_treelet_accels
    from atray_tpu.dist.treelet import build_treelets as jax_build_treelets

    from test_torch_render import _tree, jax_builder

    jscene = jax_scenes["accels"]
    scene = scene_from_numpy(_tree(jscene))
    got = build_treelets(scene, WORLD).recs
    want = np.asarray(jax_build_treelets(jscene, WORLD).recs)
    np.testing.assert_array_equal(got[..., 18:], want[..., 18:])
    np.testing.assert_allclose(got, want, atol=1e-6)
    ta = build_treelet_accels(scene, WORLD, LEAF8, backend=jax_builder())
    ja = jax_build_treelet_accels(jscene, WORLD, JaxKDTreeConfig(leaf_size=8))
    assert (ta.leaf_size, ta.num_nodes, ta.max_depth) == (ja.leaf_size, ja.num_nodes,
                                                          ja.max_depth)
    for r in range(WORLD):
        part = ta.local(r, "cpu")
        for k in ("cboxes", "clinks", "caxis", "tris"):
            a, b = getattr(part, k).numpy(), np.asarray(getattr(ja, k))[r]
            assert a.dtype == b.dtype and np.array_equal(a.view(np.int32), b.view(np.int32)), k
        ids = part.tris.view(torch.int32).reshape(-1, 32)[:, 9]
        real = ids[ids >= 0].numpy()
        own = partition_faces(np.asarray(jscene.mesh.vertices), np.asarray(jscene.mesh.faces),
                              WORLD)[r]
        # leaf slots may repeat a face (the builder pads leaves so)
        assert sorted(set(real.tolist())) == sorted(own.tolist())


def test_ring_first_hit_matches_brute_force(ranks):
    # three hops of the brute-force rings (the hit's, and the fid-only one
    # of the reference's differentiable path) and of the kernel-accel ring
    # (the plain wide_shade here) against brute force over the whole mesh
    job, res, _ = ranks
    scene = scene_from_numpy(job["scenes"]["geom"])
    o, d = (torch.from_numpy(x) for x in job["rays"])
    t_ref, _, _, tid_ref = first_triangle_hit(o, d, *scene.to("cpu").triangle_soa())
    for pre in ("ring", "fid", "accel"):
        t = np.concatenate([res[r][f"{pre}_t"] for r in range(WORLD)])
        fid = np.concatenate([res[r][f"{pre}_fid"] for r in range(WORLD)])
        np.testing.assert_allclose(t, t_ref.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(fid, tid_ref.numpy())
    assert int((tid_ref >= 0).sum()) > o.shape[0] // 4
    hit = np.concatenate([res[r]["ring_hit"] for r in range(WORLD)])
    np.testing.assert_array_equal(hit, tid_ref.numpy() >= 0)
    np.testing.assert_allclose(np.concatenate([res[r]["accel_n"] for r in range(WORLD)]),
                               np.concatenate([res[r]["ring_n"] for r in range(WORLD)]),
                               atol=1e-6)


def test_treelet_geom_film_matches_jax_render_treelet(ranks, jax_scenes, devices):
    # the brute-force backend against the JAX render_treelet on a mesh of
    # 3 devices (brute force, jitted without LLVM's optimizations, as
    # tests/test_torch_dist.py's reference), and against the replicated film
    import jax

    from atray_tpu.config import RenderSettings as JaxRenderSettings
    from atray_tpu.core.camera import look_at_camera as jax_look_at_camera
    from atray_tpu.dist.mesh import make_device_mesh as jax_make_device_mesh
    from atray_tpu.dist.treelet import build_treelets as jax_build_treelets
    from atray_tpu.dist.treelet import render_treelet as jax_render_treelet

    job, res, _ = ranks
    js = JaxRenderSettings(resolution=FILM.resolution, samples_per_pixel=FILM.samples_per_pixel,
                           bounce_limit=FILM.bounce_limit)
    jcam = jax_look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    mesh = jax_make_device_mesh(WORLD)
    geom = jax_build_treelets(jax_scenes["geom"], WORLD)     # from the concrete scene
    ref = np.asarray(jax.jit(
        lambda k: jax_render_treelet(jax_scenes["geom"], jcam, js, k, mesh, treelets=geom),
        compiler_options={"xla_backend_optimization_level": 0})(jax.random.PRNGKey(0)))
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["geom_film"], ref, atol=2e-5)
    np.testing.assert_allclose(res[0]["geom_film"], _replicated(job, "geom", FILM, 0),
                               atol=1e-5)
    assert ref.std() > 0.01


@pytest.mark.parametrize("name", ["accels", "nee"])
def test_treelet_accels_film_matches_replicated(ranks, name):
    # the kernel-accel backend (plain wide_shade a hop) against the
    # replicated render through the whole mesh's shaded accel; with NEE the
    # light is a sphere (the treelet NEE samples only sphere lights, as the
    # reference's); every rank runs every hop of every bounce: 3 hops x 3
    # bounces, or with NEE 3 x 2 for hits and 3 x 2 for shadow rays
    job, res, _ = ranks
    s, key = (FILM, 0) if name == "accels" else (NEE, 2)
    want = _replicated(job, name, s, key)
    for r in range(WORLD):
        np.testing.assert_allclose(res[r][f"{name}_film"], want, atol=1e-5)
        hops = WORLD * s.bounce_limit * (2 if s.nee else 1)
        assert int(res[r][f"{name}_calls"]) == hops
        log = res[r][f"{name}_hops"]
        words = 13 if not s.nee else np.where(np.arange(hops) % (2 * WORLD) < WORLD, 13, 8)
        assert log.shape == (hops, 3) and (log[:, 2] == 4 * words * log[:, 1]).all()
        assert list(log[:WORLD, 0]) == list(range(WORLD))
    assert want.max() > 0.05 and want.std() > 0.01


def test_cli_treelet_renders(ranks):
    # `render --treelet` under 3 ranks: the kernel accels where the faces
    # number at least ranks x leaf size, else brute force (the cube, with
    # NEE's shadow ring and the light sphere); rank 0's PNG is save_png of
    # the direct render_treelet film
    _, res, out = ranks
    assert bool(res[0]["cli_accels_accels"]) and not bool(res[0]["cli_brute_nee_accels"])
    for name in CLI_CASES:
        with open(os.path.join(out, f"cli_{name}_rank0.png"), "rb") as a, \
                open(os.path.join(out, f"direct_{name}.png"), "rb") as b:
            assert a.read() == b.read()
        assert not os.path.exists(os.path.join(out, f"cli_{name}_rank1.png"))
        err = open(os.path.join(out, f"cli_{name}.err")).read()
        assert "treelet sharding over 3 rank(s)" in err
        assert ("bvh_build" in err) == (name == "accels")


def test_treelet_parts_one_rank_equals_render(jax_scenes):
    # the differentiable backend on one rank (both rings of one hop, sort
    # and lane pack on) against the replicated brute-force render: the film
    # and the gradients of all five leaves; the backward runs pickup hops
    # only, in reverse
    scene = scene_from_numpy(_tree_of(jax_scenes["nee"])).to("cpu")
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    s = RenderSettings(resolution=(12, 12), samples_per_pixel=1, bounce_limit=3)
    mesh = make_device_mesh(device="cpu")
    parts = build_treelet_parts(scene, 1)
    hops = []

    def film_and_grads(fn):
        p = SceneParams(*(x.clone().requires_grad_() for x in scene.params().leaves()))
        film = fn(scene.with_params(p))
        g = torch.autograd.grad(film.sum(), p.leaves(), allow_unused=True)
        return film.detach(), [torch.zeros_like(x) if y is None else y
                               for x, y in zip(p.leaves(), g)]

    want, g_want = film_and_grads(lambda sc: render(sc, cam, s, prng_key(3), device="cpu"))
    n_fwd = []

    def treelet(sc):
        film = render_treelet(sc, cam, s, prng_key(3), mesh, treelets=parts, hop_log=hops)
        n_fwd.append(len(hops))
        return film

    got, g_got = film_and_grads(treelet)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert want.std() > 0.01
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-3)
    assert float(g_want[0].abs().max()) > 1e-3
    fwd, bwd = hops[:n_fwd[0]], hops[n_fwd[0]:]
    assert [h["ring"] for h in fwd] == ["first_fid", "pickup"] * s.bounce_limit
    assert bwd and all(h["ring"] == "pickup" and h["reverse"] for h in bwd)
    assert not any(h["reverse"] for h in fwd)
    assert {h["bytes"] for h in bwd} == {20 * 4 * 144}


def _tree_of(jscene):
    from test_torch_render import _tree

    return _tree(jscene)


def test_overrides_and_first_hit_adapter(jax_scenes):
    # wide_shade_first_hit is wide_shade_planes on rows; trace_radiance with
    # a hit override in either form (a one-rank ring) gives the replicated
    # trace; NEE with a light and no occlusion override raises
    scene = scene_from_numpy(_tree_of(jax_scenes["nee"])).to("cpu")
    acc = build_shaded_accel(scene, LEAF8).to("cpu")
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    o, d = camera_rays(cam, 12, 12, 1, device="cpu")
    alive = torch.arange(o.shape[0]) % 5 != 0
    fo = wide_shade_first_hit(acc, o, d, alive.to(torch.float32))
    want = wide_shade_planes(acc, *(o[:, k].contiguous() for k in range(3)),
                             *(d[:, k].contiguous() for k in range(3)), alive)
    for k in ("t", "id", "mat"):
        assert torch.equal(fo[k], want[k])
    assert torch.equal(fo["normal"], torch.stack([want["nx"], want["ny"], want["nz"]], 1))

    mesh = make_device_mesh(device="cpu")
    geom = build_treelets(scene, 1).local(0, "cpu")

    def ids_form(o_, d_, alive_):
        return ring_first_hit(geom, o_, d_, mesh)[:4]

    def consts_form(o_, d_, alive_):
        t, n, mat, fid = ring_first_hit_accel(acc, o_, d_, alive_, mesh)
        return (t, n, *resolve_material_rows(scene, mat, fid >= 0), fid >= 0)

    base = trace_radiance(scene, o, d, 3, prng_key(4), sort_rays=True)
    lean = dataclasses.replace(scene, mesh=empty_mesh()).to("cpu")
    for form in (ids_form, consts_form):
        got = trace_radiance(lean, o, d, 3, prng_key(4), sort_rays=True, hit_override=form)
        np.testing.assert_allclose(got.numpy(), base.numpy(), atol=1e-5)
    with pytest.raises(NotImplementedError, match="occl_override"):
        trace_radiance(lean, o, d, 2, prng_key(4), nee=True, hit_override=ids_form)


def test_override_replay_passes_ray_gradient(jax_scenes):
    # an override that replays each ray's hit from its face id (found by
    # brute force, detached) on the rays it is handed, as the differentiable
    # treelet backends do: from the second bounce on the ray origins depend
    # on the vertices, and the vertex gradient through trace_radiance equals
    # the reference's jax.grad through the same override (with the rays
    # detached before the override, as they were, it misses that term)
    import jax
    import jax.numpy as jnp

    from atray_tpu.core import intersect as jx
    from atray_tpu.render import wavefront as jw
    from atray_tpu.scene.data import empty_mesh as jax_empty_mesh

    from atray_tpu.scene import build_scene, procedural

    # the uv sphere over a floor of two triangles: rays bounce between them
    floor = procedural.quad((-3, -1, -1), (3, -1, -1), (3, -1, -7), (-3, -1, -7))
    g = jax_scenes["geom"]
    jscene = build_scene([g.mesh, floor], materials=g.materials)
    scene = scene_from_numpy(_tree_of(jscene)).to("cpu")
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    o, d = camera_rays(cam, 10, 10, 1, device="cpu")

    def replay(xp, mt, norm, o_, d_, row, j, mat):
        # t and the normal from the row on the rays handed in (both sides)
        tt, u, v, _ = mt(o_, d_, row[:, 0:3], row[:, 3:6], row[:, 6:9])
        w0 = (1.0 - u - v)[:, None]
        n = norm(w0 * row[:, 9:12] + u[:, None] * row[:, 12:15] + v[:, None] * row[:, 15:18])
        hit = (j >= 0) & (tt < 1.0e30)
        return xp.where(hit, tt, 1.0e30), xp.where(hit[:, None], n, 0.0), xp.where(hit, mat, 0), hit

    v = scene.mesh.vertices.clone().requires_grad_()
    sc = scene.with_params(dataclasses.replace(scene.params(), vertices=v))
    ft = build_face_table(sc)
    soa = [x.detach() for x in sc.triangle_soa()]

    def port_override(o_, d_, alive):
        j = first_triangle_hit(o_.detach(), d_.detach(), *soa)[3]
        row = torch.index_select(ft, 0, torch.clamp(j, min=0).long())
        return replay(torch, moller_trumbore, normalize, o_, d_, row, j,
                      row[:, 18].detach().to(torch.int32))

    lean = dataclasses.replace(sc, mesh=empty_mesh()).to("cpu")
    color = trace_radiance(lean, o, d, 3, prng_key(6), hit_override=port_override)
    got = torch.autograd.grad(color.sum(), v)[0].numpy()

    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    jlean = dataclasses.replace(jscene, mesh=jax_empty_mesh())

    def loss(verts):
        js = dataclasses.replace(jscene, mesh=dataclasses.replace(jscene.mesh, vertices=verts))
        jft = jw.build_face_table(js)
        p0, e1, e2 = (jax.lax.stop_gradient(jft[:, k:k + 3]) for k in (0, 3, 6))

        def override(o_, d_, alive):
            j = jx.first_triangle_hit(jax.lax.stop_gradient(o_), jax.lax.stop_gradient(d_),
                                      p0, e1, e2)[3]
            row = jft[jnp.maximum(j, 0)]
            return replay(jnp, jx.moller_trumbore, jx.normalize, o_, d_, row, j,
                          jax.lax.stop_gradient(row[:, 18]).astype(jnp.int32))

        return jnp.sum(jw.trace_radiance(jlean, jo, jd, 3, key=jax.random.PRNGKey(6),
                                         hit_override=override))

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(jscene.mesh.vertices)))
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
