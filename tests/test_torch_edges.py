"""The PyTorch port's dual-level edge extraction without OpenCV.

  * the cases of ``tests/test_edges.py`` on the port's ``edges/dual_level``;
  * ``edges/imgproc`` against cv2 on seeded images, exactly:
    ``resize_linear_u8`` (downscales, halvings, upscales of binary maps),
    ``canny`` (thresholds drawn from the seed), ``hough_lines_p`` (the same
    segments in the same order, on region boundaries of the kind
    ``_hough_complete`` feeds it and on scattered points and lines) and
    ``draw_line`` (endpoints inside and outside the image);
  * ``fine_edges`` equal to the JAX package's, exactly, for both
    ``high_res_img`` values on textured, step and scene images at several
    sizes, and ``coarse_labels`` at scales 0-2 with the same 0 set, the same
    -1 set and the same partition of the positive regions up to relabelling
    (the JAX package may number regions through its native module).
"""
import numpy as np
import pytest
from scipy import ndimage

import torch_parity  # noqa: F401  (one torch thread per worker)
from dpe_mvs_tpu_torch.edges import dual_level
from dpe_mvs_tpu_torch.edges import imgproc

SIZES = [(36, 48), (61, 83), (150, 200)]


def _region_border(rng, H, W, sigma):
    """The 4-neighbour boundary of a smooth random blob set, as
    ``_hough_complete`` draws it (uint8 {0, 255})."""
    reg = ndimage.gaussian_filter(rng.random((H, W)), sigma) > 0.5
    dil = ndimage.binary_dilation(reg, structure=dual_level._FOUR_CONN)
    return ((dil & ~reg) * 255).astype(np.uint8)


def _images(H, W, seed):
    """Textured (the plane scene's texture), step and half-flat images."""
    from dpe_mvs_tpu.utils.synthetic import procedural_texture
    rng = np.random.default_rng(seed)
    tex = procedural_texture(rng, 256)
    tex = np.tile(tex, (H // 256 + 1, W // 256 + 1))[:H, :W].astype(np.uint8)
    step = (rng.random((H, W)) * 20).astype(np.uint8)
    step[:, W // 2:] += 150
    half = rng.integers(0, 256, (H, W)).astype(np.uint8)
    half[:, :W // 2] = 120
    return {"textured": tex, "step": step, "half-flat": half}


def _same_partition(a, b):
    """Equal 0 and -1 sets and a one-to-one map between positive ids."""
    np.testing.assert_array_equal(a == 0, b == 0)
    np.testing.assert_array_equal(a == -1, b == -1)
    pos = a > 0
    pairs = np.unique(np.stack([a[pos], b[pos]]), axis=1)
    assert len(np.unique(pairs[0])) == pairs.shape[1] == \
        len(np.unique(pairs[1]))


# --- tests/test_edges.py on the port ---------------------------------------

def test_roberts_flat_is_dark():
    r = dual_level.roberts(np.full((20, 20), 100, np.uint8))
    assert (r[1:-1, 1:-1] == 0).all()
    assert (r[0, :] == 70).all()


def test_roberts_detects_step():
    img = np.zeros((20, 20), np.uint8)
    img[:, 10:] = 100
    r = dual_level.roberts(img)
    assert r[5, 9] > 100
    assert r[5, 3] == 0


def test_roberts_truncation_wraps_like_reference():
    img = np.zeros((8, 8), np.uint8)
    img[:, 4:] = 200
    assert dual_level.roberts(img)[3, 3] == int(np.sqrt(2) * 200) % 256


def test_connect_labels_regions():
    binary = np.zeros((10, 10), np.uint8)
    binary[:, 5] = 255
    labels, counts = dual_level.connect(binary)
    assert labels[0, 5] == 0
    left, right = labels[3, 2], labels[3, 8]
    assert left != 0 and right != 0 and left != right
    assert counts[left] == 50 and counts[right] == 40


def test_fine_edges_on_step(rng):
    img = (rng.random((64, 64)) * 20).astype(np.uint8)
    img[:, 32:] += 150
    edges = dual_level.fine_edges(img, high_res_img=True)
    assert set(np.unique(edges)) <= {0, 255}
    assert edges[:, 30:35].max() == 255


def test_coarse_labels_weak_region(rng):
    img = (rng.random((128, 128)) * 255).astype(np.uint8)
    img[:, :64] = 120
    labels = dual_level.coarse_labels(img, scale=0, high_res_img=False)
    assert labels.shape == (128, 128)
    left = labels[10:110, 5:55]
    assert left[left > 0].size > left.size * 0.5
    assert (labels[10:110, 70:120] <= 0).mean() > 0.5


def test_roberts_and_connect_equal_jax(rng):
    from dpe_mvs_tpu.edges import dual_level as jdl
    img = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    img[5:20, 5:30] = 9
    np.testing.assert_array_equal(dual_level.roberts(img), jdl.roberts(img))
    binary = np.where(dual_level.roberts(img) > 60, 255, 0).astype(np.uint8)
    ours, counts = dual_level.connect(binary)
    ref, ref_counts = jdl.connect(binary)
    _same_partition(np.where(ours == 0, 0, ours), ref)
    assert sorted(counts[1:]) == sorted(ref_counts[1:])


# --- the OpenCV routines against cv2 ---------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_resize_linear_u8_equals_cv2(seed):
    import cv2
    rng = np.random.default_rng(seed)
    for _ in range(40):
        H, W = (int(v) for v in rng.integers(1, 90, 2))
        kind = int(rng.integers(0, 3))
        if kind == 0:                                   # halvings
            rows, cols = max(H // 2, 1), max(W // 2, 1)
        else:
            rows, cols = (int(v) for v in rng.integers(1, 200, 2))
        img = rng.integers(0, 256, (H, W)).astype(np.uint8)
        if kind == 2:                                   # binary maps
            img = ((rng.random((H, W)) < 0.3) * 255).astype(np.uint8)
        np.testing.assert_array_equal(
            imgproc.resize_linear_u8(img, cols, rows),
            cv2.resize(img, (cols, rows), interpolation=cv2.INTER_LINEAR),
            err_msg=f"{(H, W)} -> {(rows, cols)}")


@pytest.mark.parametrize("seed", range(4))
def test_canny_equals_cv2(seed):
    import cv2
    rng = np.random.default_rng(10 + seed)
    for _ in range(25):
        H, W = (int(v) for v in rng.integers(3, 120, 2))
        img = ndimage.gaussian_filter(
            rng.integers(0, 256, (H, W)).astype(np.float64),
            float(rng.uniform(0, 3))).astype(np.uint8)
        lo, hi = (int(v) for v in rng.integers(0, 300, 2))
        np.testing.assert_array_equal(
            imgproc.canny(img, lo, hi),
            cv2.Canny(img, lo, hi, apertureSize=3, L2gradient=True),
            err_msg=f"{(H, W)}, thresholds {lo}, {hi}")


@pytest.mark.parametrize("seed", range(4))
def test_hough_lines_p_equals_cv2(seed):
    import cv2
    rng = np.random.default_rng(20 + seed)
    n_lines = 0
    for case in range(12):
        H, W = (int(v) for v in rng.integers(8, 160, 2))
        if case % 2:
            img = _region_border(rng, H, W, float(rng.uniform(2, 6)))
        else:
            img = ((rng.random((H, W)) < 0.03) * 255).astype(np.uint8)
            for _ in range(4):
                p = rng.integers(0, [W, H], (2, 2))
                imgproc.draw_line(img, p[0], p[1], 255)
        reach = int(min(W, H) / 30.0)
        args = (max(reach, 1), reach, reach)
        if case % 3 == 0:
            args = tuple(int(v) for v in (rng.integers(1, 12),
                                          rng.integers(0, 10),
                                          rng.integers(0, 6)))
        ref = cv2.HoughLinesP(img, 1, np.pi / 180, args[0],
                              minLineLength=args[1], maxLineGap=args[2])
        ref = np.zeros((0, 4), np.int32) if ref is None else ref.reshape(-1,
                                                                         4)
        ours = imgproc.hough_lines_p(img, 1, np.pi / 180, *args)
        assert ours.dtype == np.int32
        np.testing.assert_array_equal(ours, ref, err_msg=f"{(H, W)} {args}")
        n_lines += len(ref)
    assert n_lines > 20


def test_draw_line_equals_cv2():
    import cv2
    rng = np.random.default_rng(5)
    for case in range(1500):
        H, W = (int(v) for v in rng.integers(1, 40, 2))
        pad = 20 if case % 2 else 0
        p = rng.integers(-pad, [W + pad, H + pad], (2, 2))
        ref = np.zeros((H, W), np.uint8)
        cv2.line(ref, tuple(int(v) for v in p[0]),
                 tuple(int(v) for v in p[1]), 255, 1)
        ours = imgproc.draw_line(np.zeros((H, W), np.uint8), p[0], p[1], 255)
        np.testing.assert_array_equal(ours, ref, err_msg=f"{(H, W)} {p}")


# --- the maps against the JAX package --------------------------------------

@pytest.mark.parametrize("shape", SIZES)
def test_fine_edges_equal_jax(shape):
    from dpe_mvs_tpu.edges import dual_level as jdl
    for name, img in _images(*shape, seed=shape[0]).items():
        for high_res in (True, False):
            ours = dual_level.fine_edges(img, high_res)
            np.testing.assert_array_equal(ours, jdl.fine_edges(img, high_res),
                                          err_msg=f"{name} {high_res}")
            assert ours.any() or name == "half-flat"


@pytest.mark.parametrize("shape", SIZES)
def test_coarse_labels_same_partition_as_jax(shape):
    from dpe_mvs_tpu.edges import dual_level as jdl
    for name, img in _images(*shape, seed=shape[0] + 1).items():
        for high_res in (True, False):
            for scale in (0, 1, 2):
                ours = dual_level.coarse_labels(img, scale, high_res)
                ref = jdl.coarse_labels(img, scale, high_res)
                assert ours.dtype == np.int32 and ours.shape == ref.shape
                _same_partition(ours, ref)


def test_scene_image_maps_equal_jax(tmp_path):
    """fine_edges and coarse_labels on the plane scene's images, as
    get_problem_edges computes them, at 64x48 and 160x120."""
    from dpe_mvs_tpu.edges import dual_level as jdl
    from dpe_mvs_tpu_torch.utils.synthetic import make_plane_scene
    for W, H in ((64, 48), (160, 120)):
        sc = make_plane_scene(width=W, height=H, num_views=2, seed=4,
                              weak_patch=True)
        img = sc.images[0].astype(np.uint8)
        for high_res in (True, False):
            np.testing.assert_array_equal(dual_level.fine_edges(img, high_res),
                                          jdl.fine_edges(img, high_res))
            for scale in (0, 1):
                ours = dual_level.coarse_labels(img, scale, high_res)
                _same_partition(ours, jdl.coarse_labels(img, scale, high_res))
