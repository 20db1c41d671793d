"""PyTorch port, the output modules: progressive render with checkpoint and
resume (twins of ``tests/test_aux.py``'s ``TestProgressive``, the film sum
against the JAX package's, a checkpoint read by the other package),
telemetry (``TestTelemetry``'s first case), ``progress_cb`` ticks against
the JAX ticks, BMP bytes against the JAX encoder, and the phase registry
(``TestProfiling``). The JAX side renders by brute force only."""

import json
import os
import struct

import jax
import numpy as np
import torch

torch.set_num_threads(2)

from atray_tpu.config import RenderSettings as JaxRenderSettings  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.render import film as jax_film  # noqa: E402
from atray_tpu.render import progressive as jprog  # noqa: E402
from atray_tpu.render import telemetry as jtel  # noqa: E402
from atray_tpu.render import wavefront as jw  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.data import make_materials as jax_make_materials  # noqa: E402
from atray_tpu.scene.transforms import translate as jax_translate  # noqa: E402
from test_torch_texture import port_scene  # noqa: E402

from atray_tpu_torch.config import RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import look_at_camera  # noqa: E402
from atray_tpu_torch.render import film, progressive  # noqa: E402
from atray_tpu_torch.render import wavefront as tw  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402
from atray_tpu_torch.render.telemetry import render_telemetry, tail_report  # noqa: E402
from atray_tpu_torch.utils.profiling import (  # noqa: E402
    Phase,
    metrics_json,
    phase_report,
    reset_phases,
    trace_to,
)


def _jscene(shape="cube", size=2.0, albedo=(0.8, 0.6, 0.4), scatter=0.2):
    mats = jax_make_materials([
        ((0.4, 0.5, 0.7), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), albedo, scatter),
    ])
    mesh = (jax_procedural.cube(size=size, material=1) if shape == "cube"
            else jax_procedural.uv_sphere(rows=8, cols=8, material=1))
    return jax_build_scene([jax_translate(mesh, (0, 0, -4))], materials=mats)


def _progressive_case():
    """``TestProgressive``'s scene, camera and settings (12x12, 2 spp a
    batch, 2 bounces), both packages'."""
    jscene = _jscene()
    eye, target = (0, 0.4, 0.5), (0, 0, -4)
    return (jscene, port_scene(jscene),
            jax_look_at_camera(eye, target, h_fov=0.8, aspect=1.0),
            look_at_camera(eye, target, h_fov=0.8, aspect=1.0),
            JaxRenderSettings(resolution=(12, 12), samples_per_pixel=2, bounce_limit=2),
            RenderSettings(resolution=(12, 12), samples_per_pixel=2, bounce_limit=2))


class TestProgressive:
    def test_checkpoint_roundtrip(self, tmp_path):
        p = str(tmp_path / "ck.npz")
        st = progressive.FilmState(film_sum=np.ones((4, 4, 3), np.float32) * 2.0,
                                   batches_done=3, spp_per_batch=2, seed=7)
        progressive.save_checkpoint(p, st)
        st2 = progressive.load_checkpoint(p)
        assert (st2.batches_done, st2.spp_per_batch, st2.seed, st2.spp_total) == (3, 2, 7, 6)
        np.testing.assert_array_equal(st2.film_sum, st.film_sum)
        np.testing.assert_allclose(st2.film(), np.clip(st.film_sum / 3, 0, 1))
        assert progressive.load_checkpoint(str(tmp_path / "none.npz")) is None

    def test_resume_bit_identical(self, tmp_path):
        _, scene, _, cam, _, s = _progressive_case()
        full = progressive.render_progressive(scene, cam, s, total_spp=6, seed=5, device="cpu")
        p = str(tmp_path / "ck.npz")

        def stop_after_one(state):
            if state.batches_done == 1:
                raise KeyboardInterrupt

        try:
            progressive.render_progressive(scene, cam, s, total_spp=6, seed=5, checkpoint_path=p,
                                           on_batch=stop_after_one, device="cpu")
        except KeyboardInterrupt:
            pass
        assert progressive.load_checkpoint(p).batches_done == 1
        resumed = progressive.render_progressive(scene, cam, s, total_spp=6, seed=5,
                                                 checkpoint_path=p, device="cpu")
        assert resumed.batches_done == 3 and full.batches_done == 3
        np.testing.assert_array_equal(resumed.film_sum, full.film_sum)


def test_progressive_film_sum_matches_jax_and_checkpoints_cross(tmp_path):
    jscene, scene, jcam, cam, js, s = _progressive_case()
    want = jprog.render_progressive(jscene, jcam, js, total_spp=6, seed=5)
    got = progressive.render_progressive(scene, cam, s, total_spp=6, seed=5, device="cpu")
    assert got.batches_done == want.batches_done == 3
    np.testing.assert_allclose(got.film_sum, want.film_sum, atol=1e-4)
    assert got.film_sum.std() > 0.01
    # a checkpoint of either package loads in the other, field for field
    for save, load in ((progressive.save_checkpoint, jprog.load_checkpoint),
                       (jprog.save_checkpoint, progressive.load_checkpoint)):
        p = str(tmp_path / f"{save.__module__}.npz")
        save(p, got)
        back = load(p)
        np.testing.assert_array_equal(back.film_sum, got.film_sum)
        assert (back.batches_done, back.spp_per_batch, back.seed) == (3, 2, 5)


def test_telemetry_matches_render_and_reports():
    # the film of the per-chunk timed path equals render()'s at that chunk
    # size and without chunks; the table covers every chunk, in the
    # reference's format
    scene = port_scene(_jscene("sphere", albedo=(0.8, 0.45, 0.25)))
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(resolution=(16, 16), samples_per_pixel=2, bounce_limit=3)
    film_t, report = render_telemetry(scene, cam, s, prng_key(0), n_chunks=4, device="cpu")
    assert report["n_chunks"] == 4 and report["chunk_rays"] == 128
    assert len(report["chunk_s"]) == 4 and sum(report["chunk_live_rays"]) > 0
    film_ref, stats = tw.render(scene, cam, s, prng_key(0), device="cpu", return_stats=True)
    assert torch.equal(film_t, film_ref)
    assert sum(report["chunk_live_rays"]) == int(stats["rays_cast"])
    chunked = tw.render(scene, cam, RenderSettings(
        resolution=(16, 16), samples_per_pixel=2, bounce_limit=3, ray_chunk=128),
        prng_key(0), device="cpu")
    assert torch.equal(film_t, chunked)
    # one chunk: render calls no callback, the whole call is the chunk
    film_1, report_1 = render_telemetry(scene, cam, s, prng_key(0), n_chunks=1, device="cpu")
    assert torch.equal(film_1, film_ref)
    assert report_1["n_chunks"] == 1 and report_1["chunk_rays"] == 512
    assert len(report_1["chunk_s"]) == 1
    assert report_1["chunk_live_rays"] == [int(stats["rays_cast"])]
    text = tail_report(report)
    assert "imbal" in text and "chunk wall" in text
    assert text == jtel.tail_report(report)


def test_progress_callback_ticks_per_chunk():
    # one tick per ray chunk with the chunk's rays cast, the JAX ticks'
    # values; no tick when the frame is one chunk
    jscene = _jscene(size=1.5, albedo=(0.7, 0.7, 0.7), scatter=0.0)
    eye, target = (0, 0.5, 1), (0, 0, -4)
    js = JaxRenderSettings(resolution=(64, 48), samples_per_pixel=2, bounce_limit=2,
                           ray_chunk=2048, sort_bounces=False)
    jticks = []
    jcam = jax_look_at_camera(eye, target, h_fov=0.9, aspect=4 / 3)
    film_j = jax.jit(lambda k: jw.render(jscene, jcam, js, k,
                                         progress_cb=lambda live: jticks.append(float(live))))(
        jax.random.PRNGKey(0))
    jax.block_until_ready(film_j)
    jax.effects_barrier()
    s = RenderSettings(resolution=(64, 48), samples_per_pixel=2, bounce_limit=2,
                       ray_chunk=2048, sort_bounces=False)
    scene = port_scene(jscene)
    cam = look_at_camera(eye, target, h_fov=0.9, aspect=4 / 3)
    ticks = []
    _, stats = tw.render(scene, cam, s, prng_key(0), device="cpu", return_stats=True,
                         progress_cb=ticks.append)
    assert len(ticks) == 3 and all(isinstance(t, int) and t > 0 for t in ticks)
    assert ticks == jticks
    assert sum(ticks) == int(stats["rays_cast"])
    one = []
    tw.render(scene, cam, RenderSettings(resolution=(64, 48), samples_per_pixel=2,
                                         bounce_limit=2, sort_bounces=False),
              prng_key(0), device="cpu", progress_cb=one.append)
    assert one == []


def test_bmp_bytes_match_jax_and_header_reads_back(tmp_path):
    # an odd width pads every row
    img = np.random.default_rng(0).uniform(0, 1, (7, 5, 3)).astype(np.float32)
    u8 = film.to_uint8(img)
    assert film.encode_bmp(u8) == jax_film.encode_bmp(u8)
    p = film.save_bmp(str(tmp_path / "img.bmp"), img)
    data = open(p, "rb").read()
    assert data[:2] == b"BM" and len(data) == 54 + 7 * 16
    assert struct.unpack("<ii", data[18:26]) == (5, 7)
    assert film.save_bmp(str(tmp_path / "img.bmp"), img) == str(tmp_path / "img_1.bmp")
    srgb = open(film.save_bmp(str(tmp_path / "s.bmp"), img, srgb=True), "rb").read()
    assert srgb == open(jax_film.save_bmp(str(tmp_path / "j.bmp"), img, srgb=True), "rb").read()


class TestProfiling:
    def test_phase_registry_and_report(self, tmp_path):
        reset_phases()
        with Phase("load"):
            pass
        # trace_to writes a torch.profiler trace in which each phase is a range
        with trace_to(str(tmp_path)) as prof:
            with Phase("render", block=True):
                torch.ones(8).sum()
        with Phase("render"):
            pass
        assert "render" in {e.key for e in prof.key_averages()}
        assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path))
        rep = phase_report(rays=1000)
        assert "load" in rep and "render" in rep and "rays/s" in rep
        m = json.loads(metrics_json(extra={"x": 1}))
        assert m["phases"]["render"]["runs"] == 2 and m["phases"]["load"]["runs"] == 1
        assert m["x"] == 1
