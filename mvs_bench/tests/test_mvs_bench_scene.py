"""The frozen scene generator and writers against the program's own
(``dpe_mvs_tpu_torch.utils.synthetic``): bit-equal at a tiny size, two
seeds, with and without the texture-less patch."""
import numpy as np
import pytest

from dpe_mvs_tpu_torch.io import formats, imread
from dpe_mvs_tpu_torch.utils import synthetic
from mvs_bench import scene


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
@pytest.mark.parametrize("weak_patch", [False, True])
def test_plane_scene_bit_equal(seed, weak_patch):
    kw = dict(width=40, height=30, num_views=4, weak_patch=weak_patch,
              seed=seed)
    ours, theirs = scene.make_plane_scene(**kw), synthetic.make_plane_scene(**kw)
    for a, b in zip(ours.images, theirs.images):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(ours.gt_depths, theirs.gt_depths):
        assert np.array_equal(a, b)
    for a, b in zip(ours.gt_normals, theirs.gt_normals):
        assert np.array_equal(a, b)
    for a, b in zip(ours.cameras, theirs.cameras):
        for f in ("K", "R", "t"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
        assert (a.depth_min, a.depth_max, a.width, a.height) == \
            (b.depth_min, b.depth_max, b.width, b.height)
    if weak_patch:
        y0, y1, x0, x1 = ours.weak_box
        band = np.zeros((30, 40), bool)
        band[y0:y1, x0:x1] = True
        assert np.array_equal(band, theirs.weak_region)


def test_folder_and_priors_bit_equal(tmp_path):
    kw = dict(width=40, height=30, num_views=3, seed=11)
    ours, theirs = scene.make_plane_scene(**kw), synthetic.make_plane_scene(**kw)
    a = scene.write_scene_folder(ours, tmp_path / "a")
    b = synthetic.write_scene_folder(theirs, tmp_path / "b")
    for rel in ["pair.txt"] + [f"images/{v:08d}.jpg" for v in range(3)] + \
            [f"cams/{v:08d}_cam.txt" for v in range(3)]:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    assert np.array_equal(imread.read_gray(a / "images/00000001.jpg"),
                          ours.images[1])
    ra = scene.write_coarse_priors(ours, 1, tmp_path / "pa", step=2)
    rb = synthetic.write_coarse_priors(theirs, 1, tmp_path / "pb", step=2)
    for name in ("depths.dmb", "normals.dmb", "selected_views.bin",
                 "weak.bin"):
        assert (ra / name).read_bytes() == (rb / name).read_bytes(), name
        assert np.array_equal(scene.read_dmb(ra / name),
                              formats.read_dmb(rb / name))
