"""PyTorch port: the command line (``atray_tpu_torch.cli``) and the demo.

Twins of ``tests/test_aux.py::TestCLI``,
``test_cli_parses_quad_area_light_scene`` and
``test_cli_parses_checker_texture``: ``load_scene_file`` gives the JAX
package's scene arrays, camera and configs exactly; the ``--no-accel`` PNG
is within 1/255 of the JAX command line's; the default path writes
``save_png`` of the port's own ``render()``; progressive resume,
``--aov``, ``--telemetry``, ``info``, the options that raise, and the
demo."""

import dataclasses
import os
import zlib

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.cli import load_scene_file as jax_load_scene_file  # noqa: E402
from atray_tpu.cli import main as jax_main  # noqa: E402

from test_torch_render import _tree  # noqa: E402

from atray_tpu_torch import cli  # noqa: E402
from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.examples import render_demo  # noqa: E402
from atray_tpu_torch.interop import scene_from_numpy  # noqa: E402
from atray_tpu_torch.render.film import save_png  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402
from atray_tpu_torch.render.wavefront import render  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")

# tests/test_aux.py::TestCLI's scene, with its [mesh] table
AUX_TOML = """
[render]
resolution = [32, 24]
samples_per_pixel = 2
bounce_limit = 3

[camera]
eye = [0.0, 0.5, 1.0]
look_at = [0.0, 0.0, -4.0]
h_fov = 0.8

[[materials]]
name = "sky"
emission = [0.3, 0.4, 0.6]

[[materials]]
name = "red"
albedo = [0.8, 0.2, 0.2]
scatter = 0.5

[[meshes]]
procedural = "cube"
material = "red"
translate_to = [0.0, 0.0, -4.0]

[[spheres]]
center = [1.0, 0.0, -4.0]
radius = 0.5
material = "red"

[[planes]]
normal = [0.0, 2.0, 0.0]
offset = -1.5
material = "red"

[mesh]
num_devices = 8
"""

# tests/test_aux.py::test_cli_parses_checker_texture's scene, plus a uv sphere
CHECKER_TOML = """
[render]
resolution = [32, 24]
[accel]
leaf_size = 8
[texture]
checker = [4, 6]
color_a = [1.0, 0.0, 0.0]
[[materials]]
name = "sky"
emission = [0.2, 0.2, 0.2]
[[materials]]
name = "m"
albedo = [0.8, 0.8, 0.8]
[[meshes]]
procedural = "cube"
material = "m"
size = 1.5
[[meshes]]
procedural = "uv_sphere"
rows = 6
cols = 8
scale_to = 1.2
translate_to = [0.5, 0.0, -3.0]
"""

# tests/test_aux.py::TestCLI's render scene, 24x16 x 1 spp x 2 bounces
RENDER_TOML = """
[render]
resolution = [24, 16]
samples_per_pixel = 1
bounce_limit = 2

[[materials]]
name = "sky"
emission = [0.3, 0.4, 0.6]

[[materials]]
name = "grey"
albedo = [0.7, 0.7, 0.7]

[[meshes]]
procedural = "cube"
material = "grey"
translate_to = [0.0, 0.0, -4.0]
"""


def _toml(tmp_path, text, name="scene.toml"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _png_rgb(path) -> np.ndarray:
    """The (H, W, 3) uint8 pixels of an 8-bit RGB PNG with one IDAT chunk
    and filter 0 rows (``film.encode_png``, either package's)."""
    data = open(path, "rb").read()
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    i = data.index(b"IDAT")
    n = int.from_bytes(data[i - 4:i], "big")
    raw = np.frombuffer(zlib.decompress(data[i + 4:i + 4 + n]), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


def _same_scene_file(path):
    want = jax_load_scene_file(path)
    got = cli.load_scene_file(path)
    jscene, wscene = want[0], got[0]
    ref = scene_from_numpy(_tree(jscene))
    for part in ("mesh", "spheres", "planes", "materials"):
        for f in dataclasses.fields(getattr(ref, part)):
            a, b = getattr(getattr(ref, part), f.name), getattr(getattr(wscene, part), f.name)
            assert a.dtype == b.dtype, (part, f.name)
            np.testing.assert_array_equal(b, a, err_msg=f"{part}.{f.name}")
    if jscene.texture is None:
        assert wscene.texture is None
    else:
        np.testing.assert_array_equal(wscene.texture, np.asarray(jscene.texture))
    for f in dataclasses.fields(want[1]):
        np.testing.assert_array_equal(np.asarray(getattr(got[1], f.name)),
                                      np.asarray(getattr(want[1], f.name)), err_msg=f.name)
    for a, b in zip(want[2:], got[2:]):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    return got


def test_load_scene_file_matches_jax(tmp_path):
    scene, _, settings, accel_cfg, mesh_cfg = _same_scene_file(_toml(tmp_path, AUX_TOML))
    assert settings.resolution == (32, 24) and settings.samples_per_pixel == 2
    assert mesh_cfg.num_devices == 8 and scene.mesh.num_faces == 12
    assert scene.spheres.count == 1 and scene.planes.count == 1
    np.testing.assert_allclose(np.linalg.norm(scene.planes.normals[0]), 1.0, rtol=1e-6)
    scene, _, _, accel_cfg, _ = _same_scene_file(_toml(tmp_path, CHECKER_TOML, "tex.toml"))
    assert scene.texture.shape == (4, 6, 3) and accel_cfg.leaf_size == 8
    with pytest.raises(ValueError, match=r"unknown \[render\] keys \['spp'\]"):
        cli.load_scene_file(_toml(tmp_path, "[render]\nspp = 4\n", "bad.toml"))
    with pytest.raises(ValueError, match=r"unknown \[mesh\] keys"):
        cli.load_scene_file(_toml(tmp_path, "[mesh]\ndevices = 4\n", "bad2.toml"))
    with pytest.raises(ValueError, match="unknown procedural mesh"):
        cli.load_scene_file(_toml(tmp_path, '[[meshes]]\nprocedural = "torus"\n', "bad3.toml"))


def test_example_scene_files_match_jax():
    scene, _, settings, accel_cfg, _ = _same_scene_file(os.path.join(EXAMPLES, "arealight.toml"))
    assert settings.nee and accel_cfg.leaf_size == 16
    em = scene.materials.emission.max(axis=1)[scene.mesh.material_id]
    assert scene.mesh.num_faces > 138_000 and int((em > 0).sum()) == 4
    scene, _, settings, _, _ = _same_scene_file(os.path.join(EXAMPLES, "cornell.toml"))
    assert settings.anti_aliasing and scene.spheres.count == 2


def test_command_line_key_is_jax_prng_key():
    # JAX with 64-bit types off (the JAX package's setting) keeps the low 32
    # bits of a negative seed or one of 2**32 and more
    for seed in (0, 1, 7, 2**31 - 1, 2**31 + 5, -1, -5, 2**32 + 5, 2**40 + 3):
        np.testing.assert_array_equal(prng_key(seed), np.asarray(jax.random.PRNGKey(seed)))


def test_no_accel_png_matches_jax_command_line(tmp_path):
    toml = _toml(tmp_path, RENDER_TOML)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert cli.main(["render", toml, "-o", ours, "--no-accel", "--device", "cpu"]) == 0
    assert jax_main(["render", toml, "-o", theirs, "--no-accel"]) == 0
    a, b = _png_rgb(ours).astype(int), _png_rgb(theirs).astype(int)
    assert a.shape == (16, 24, 3)
    assert np.abs(a - b).max() <= 1
    assert a.std() > 5


def test_default_path_png_is_save_png_of_render(tmp_path, capsys):
    toml = _toml(tmp_path, RENDER_TOML)
    out = str(tmp_path / "cli.png")
    assert cli.main(["render", toml, "-o", out, "--device", "cpu", "--srgb", "--seed", "3",
                     "--chunk", "128"]) == 0
    captured = capsys.readouterr()
    assert captured.out.strip().splitlines()[-1] == out
    assert "chunk 3/3" in captured.err and "rays/s (best render)" in captured.err
    for name in ("load", "accel_build", "build", "render", "save"):
        assert f"\n{name} " in captured.err, name
    scene, cam, settings, accel_cfg, _ = cli.load_scene_file(toml)
    accel = build_shaded_accel(scene, accel_cfg)
    film = render(scene, cam, dataclasses.replace(settings, ray_chunk=128), prng_key(3),
                  accel=accel, device="cpu")
    direct = save_png(str(tmp_path / "direct.png"), film, srgb=True)
    assert open(out, "rb").read() == open(direct, "rb").read()


def test_progressive_resume_is_bit_identical(tmp_path):
    toml = _toml(tmp_path, RENDER_TOML)
    base = ["render", toml, "--device", "cpu", "--seed", "2"]
    ck, whole_ck = str(tmp_path / "ck.npz"), str(tmp_path / "whole.npz")
    assert cli.main(base + ["-o", str(tmp_path / "half.png"), "--progressive", "2",
                            "--checkpoint", ck]) == 0
    assert cli.main(base + ["-o", str(tmp_path / "resumed.png"), "--progressive", "4",
                            "--checkpoint", ck]) == 0
    assert cli.main(base + ["-o", str(tmp_path / "whole.png"), "--progressive", "4",
                            "--checkpoint", whole_ck]) == 0
    a, b = np.load(ck), np.load(whole_ck)
    assert int(a["batches_done"]) == int(b["batches_done"]) == 4
    np.testing.assert_array_equal(a["film_sum"], b["film_sum"])
    assert (tmp_path / "resumed.png").read_bytes() == (tmp_path / "whole.png").read_bytes()
    assert os.path.exists(str(tmp_path / "whole.png") + ".preview.png")


def test_aov_telemetry_and_info_exit_0(tmp_path, capsys):
    toml = _toml(tmp_path, RENDER_TOML)
    prefix = str(tmp_path / "aov")
    assert cli.main(["render", toml, "-o", str(tmp_path / "a.png"), "--device", "cpu",
                     "--aov", prefix]) == 0
    for name in ("depth", "normal", "albedo", "emission"):
        assert _png_rgb(f"{prefix}_{name}.png").shape == (16, 24, 3)
    assert "\naov " in capsys.readouterr().err
    assert cli.main(["render", toml, "-o", str(tmp_path / "t.png"), "--device", "cpu",
                     "--telemetry", "2"]) == 0
    err = capsys.readouterr().err
    assert "chunk wall (s)" in err and "chunk live rays" in err
    assert cli.main(["info"]) == 0
    assert capsys.readouterr().out.startswith(f"torch {torch.__version__}")


def test_unported_options_and_missing_card_raise(tmp_path):
    toml = _toml(tmp_path, RENDER_TOML)
    meshed = _toml(tmp_path, RENDER_TOML + "\n[mesh]\nnum_devices = 8\n", "meshed.toml")
    out = str(tmp_path / "x.png")
    # a process started alone is a world of one rank: a mesh of 2 or 8
    # names both counts (sharded renders: tests/test_torch_dist.py)
    for argv in (["render", toml, "--mesh", "2"], ["render", meshed]):
        with pytest.raises(ValueError, match="ranks asked for, but the process group has 1"):
            cli.main(argv + ["-o", out, "--device", "cpu"])
    assert not os.path.exists(out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["render", toml, "-o", out])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            render_demo.main(["--out", str(tmp_path / "demo")])


def test_demo_runs_at_a_tiny_size(tmp_path, capsys):
    out = str(tmp_path / "demo")
    assert render_demo.main(["--res", "16x9", "--spp", "1", "--bounces", "2", "--tris", "600",
                             "--out", out, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[1:]
    want = [f"{out}.png"] + [f"{out}_{n}.png" for n in ("depth", "normal", "albedo", "emission")]
    assert printed == want
    for path in want:
        assert _png_rgb(path).shape == (9, 16, 3)
