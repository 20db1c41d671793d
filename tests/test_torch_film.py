"""PyTorch port: PNG output (``render/film.py``) names files as the JAX
package does: an existing file is kept and the film goes to the first free
``name_N.png``, unless the caller asks to overwrite."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.render import film as jax_film  # noqa: E402

from atray_tpu_torch.render import film  # noqa: E402


def _films():
    rng = np.random.default_rng(3)
    return [rng.uniform(size=(6, 5, 3)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("srgb", [False, True])
def test_save_png_picks_free_names_as_the_reference(tmp_path, srgb):
    got, want = [], []
    for img in _films():
        got.append(film.save_png(str(tmp_path / "port" / "name.png"), torch.from_numpy(img),
                                 srgb=srgb))
        want.append(jax_film.save_png(str(tmp_path / "jax" / "name.png"), img, srgb=srgb))
    assert [os.path.basename(p) for p in got] == ["name.png", "name_1.png", "name_2.png"]
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()


def test_save_png_overwrites_when_asked(tmp_path):
    path = str(tmp_path / "out.png")
    imgs = _films()
    assert film.save_png(path, imgs[0]) == path
    assert film.save_png(path, imgs[1], avoid_collision=False) == path
    assert sorted(os.listdir(tmp_path)) == ["out.png"]
    with open(path, "rb") as fh:
        assert fh.read() == film.encode_png(film.to_uint8(imgs[1]))
    assert film.unique_path(path) == str(tmp_path / "out_1.png")
