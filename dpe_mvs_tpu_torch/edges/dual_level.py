"""Dual-level edge extraction (reference component C9), without OpenCV.

Port of :mod:`dpe_mvs_tpu.edges.dual_level` (``Roberts`` / ``Connect`` /
``EdgeSegment``, DPE.cpp:9-291), with the OpenCV routines it calls replaced
by their numpy counterparts in :mod:`.imgproc`, which give the same maps:

  - *fine* edges: auto-threshold Canny, thresholds from the image median
    with sigma 0.67 (DPE.cpp:192-221);
  - *coarse* labels: downsample, Roberts gradient + threshold, connected
    components of the non-edge area, Hough-line completion of large
    weak-texture regions' boundaries, then relabel at the processing scale
    with small regions marked -1 (DPE.cpp:140-190, 224-288).

This stage is under 1% of a run and cached per scale on disk, so it stays on
the host; the maps it produces feed the sweeps on the device. Region ids are
``scipy.ndimage.label``'s (the JAX package may number them through its
native module): the same partition, not necessarily the same numbers.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

from . import imgproc

_FOUR_CONN = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def roberts(src: np.ndarray) -> np.ndarray:
    """Roberts cross gradient magnitude; borders forced to (50, 50)
    (DPE.cpp:9-25). src: uint8 (H, W). Returns uint8, the magnitude
    truncated and wrapped as C's ``(uchar)sqrt(...)`` does."""
    s = src.astype(np.int32)
    t1 = np.full(s.shape, 50, np.int32)
    t2 = np.full(s.shape, 50, np.int32)
    t1[1:-1, 1:-1] = s[1:-1, 1:-1] - s[2:, 2:]
    t2[1:-1, 1:-1] = s[2:, 1:-1] - s[1:-1, 2:]
    mag = np.sqrt(t1.astype(np.float64) ** 2 + t2.astype(np.float64) ** 2)
    return (mag.astype(np.int64) & 0xFF).astype(np.uint8)


def connect(binary: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4-connected components of the *zero* pixels (``Connect``,
    DPE.cpp:28-134). Returns (labels int32 with 0 on nonzero pixels,
    pixel count per label including label 0)."""
    labels, n = ndimage.label(binary == 0, structure=_FOUR_CONN)
    counts = np.bincount(labels.ravel(), minlength=n + 1)
    return labels.astype(np.int32), counts


def _auto_canny(src_u8: np.ndarray) -> np.ndarray:
    """Median-based auto-threshold Canny (DPE.cpp:192-221)."""
    hist = np.bincount(src_u8.ravel(), minlength=256)
    half = src_u8.size // 2
    above = np.nonzero(np.cumsum(hist[:255]) > half)[0]
    median_val = int(above[0]) if above.size else -1
    sigma = 0.67
    return imgproc.canny(src_u8, int((1 - sigma) * median_val), median_val)


def _smear_borders(dst: np.ndarray) -> np.ndarray:
    """Copy inner-ring zero-ness onto the border (DPE.cpp:239-250): a border
    pixel becomes non-edge if its inward neighbour is non-edge."""
    out = dst.copy()
    out[:, 0][out[:, 1] == 0] = 0
    out[:, -1][out[:, -2] == 0] = 0
    out[0, :][out[1, :] == 0] = 0
    out[-1, :][out[-2, :] == 0] = 0
    return out


def fine_edges(src_img_u8: np.ndarray, high_res_img: bool) -> np.ndarray:
    """Fine edge map at the input resolution: ``EdgeSegment(scale, img, 0,
    use_canny=True, high_res)`` (DPE.cpp:136-253). Returns uint8 {0, 255}."""
    robthr = 4 if high_res_img else 6
    edge = _auto_canny(src_img_u8)
    edge = np.where(edge > robthr, 255, 0).astype(np.uint8)
    return _smear_borders(edge)


def _hough_complete(dst: np.ndarray, weak_tex_num: int) -> np.ndarray:
    """Hough-line completion of large weak regions' boundaries
    (DPE.cpp:150-190). dst: binary uint8 {0, 255} at the downsampled
    scale."""
    h, w = dst.shape
    reach = int(min(w, h) / 30.0)   # threshold, min length and gap alike
    labels, counts = connect(dst)
    out = dst.copy()
    for k in range(1, counts.size):
        if counts[k] < weak_tex_num:
            continue
        region = labels == k
        # Boundary = non-region pixels 4-adjacent to the region.
        dil = ndimage.binary_dilation(region, structure=_FOUR_CONN)
        border = (dil & ~region).astype(np.uint8) * 255
        for x0, y0, x1, y1 in imgproc.hough_lines_p(
                border, 1, np.pi / 180, max(reach, 1), reach, reach):
            imgproc.draw_line(out, (x0, y0), (x1, y1), 255)
    return out


def coarse_labels(full_img_u8: np.ndarray, scale: int,
                  high_res_img: bool) -> np.ndarray:
    """Coarse label map at resolution ``full / 2**scale``:
    ``EdgeSegment(scale, full_img, 1, use_canny=False, high_res)``
    (DPE.cpp:136-288). Returns int32: 0 = edge, -1 = small region,
    >0 = weak-texture region id."""
    robthr = 4 if high_res_img else 6
    h, w = full_img_u8.shape
    weak_tex_num = int(1.0 * h * w / (1024 << (2 * scale)))

    src_down = full_img_u8
    if high_res_img:
        src_down = imgproc.resize_linear_u8(src_down, w // 2, h // 2)
    src_down = imgproc.resize_linear_u8(src_down, src_down.shape[1] // 2,
                                        src_down.shape[0] // 2)

    dst = roberts(src_down)
    dst = np.where(dst > robthr, 255, 0).astype(np.uint8)
    dst = _hough_complete(dst, weak_tex_num)

    factor = 1.0 / float(1 << scale)
    dst = imgproc.resize_linear_u8(dst, int(round(w * factor)),
                                   int(round(h * factor)))
    dst = np.where(dst > robthr, 255, 0).astype(np.uint8)
    dst = _smear_borders(dst)

    labels, counts = connect(dst)
    small = counts[labels] <= weak_tex_num
    labels = np.where(small & (labels != 0), -1, labels)
    return labels.astype(np.int32)
