"""The port's synthetic scenes against the JAX package's, at 96x72x4.

The JAX package renders through ``cv2.remap``, which quantises sample
positions to 1/32 px, and writes JPEG; the port samples bilinearly at the
exact positions and keeps the uint8 image in memory. Its images are compared
with the JAX package's before the JPEG write (``cv2.imwrite`` patched). The
port's ``make_plane_scene`` meets: uint8 images within 1 grey level, on at
most 0.01% of the pixels off by that one level (at 96x72 they are equal; at
640x480 one level on 0.0013% of the pixels, the rich scene 0.0007%), and the
rich scene is held to the same. Cameras, depth lines and ``pair.txt``
(``write_scene_folder``) are byte-equal; ground-truth depths and normals
within 1e-5 (the same float32 numpy expressions).
"""
from pathlib import Path

import numpy as np
import pytest

from dpe_mvs_tpu_torch.utils import synthetic as tsyn

import cv2
from dpe_mvs_tpu.utils import synthetic as jsyn

W, H, VIEWS, SEED = 96, 72, 4, 3


def _jax_scene(kind, folder, monkeypatch, **kw):
    written = {}

    def imwrite(path, img, *a):
        written[Path(path).name] = np.array(img)
        return True
    monkeypatch.setattr(cv2, "imwrite", imwrite)
    make = jsyn.make_rich_scene if kind == "rich" else jsyn.make_plane_scene
    sc = make(folder, width=W, height=H, num_views=VIEWS, seed=SEED, **kw)
    return sc, [written[f"{v:08d}.jpg"] for v in range(VIEWS)]


@pytest.mark.parametrize("kind", ["plane", "step", "rich"])
def test_scene_equals_jax(kind, tmp_path, monkeypatch):
    kw = {"step": True, "weak_patch": True} if kind == "step" else {}
    jsc, jimgs = _jax_scene(kind, tmp_path / "jax", monkeypatch, **kw)
    make = tsyn.make_rich_scene if kind == "rich" else tsyn.make_plane_scene
    sc = make(width=W, height=H, num_views=VIEWS, seed=SEED, **kw)
    folder = tsyn.write_scene_folder(sc, tmp_path / "port")
    for v in range(VIEWS):
        name = f"cams/{v:08d}_cam.txt"
        assert (folder / name).read_bytes() == \
            (jsc.folder / name).read_bytes(), name
        np.testing.assert_allclose(sc.gt_depths[v], jsc.gt_depths[v],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(sc.gt_normals[v], jsc.gt_normals[v],
                                   rtol=0, atol=1e-5)
        diff = np.abs(sc.images[v] - jimgs[v].astype(np.float32))
        assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-4, v
    assert (folder / "pair.txt").read_bytes() == \
        (jsc.folder / "pair.txt").read_bytes()
    if kind == "rich":
        # The surfaces and the blank texture are all there: depths spread
        # over the planes, the sphere and the occluder; flat image regions.
        d = sc.gt_depths[0]
        assert d.min() < 0.6 * 4.0 * 1.05 and d.max() > 4.0
        n = sc.gt_normals[0].reshape(-1, 3)
        assert len(np.unique(n.round(3), axis=0)) > 50
        flat = np.abs(np.diff(sc.images[0], axis=1)) == 0
        assert flat.mean() > 0.05
