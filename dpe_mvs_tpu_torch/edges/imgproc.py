"""The four OpenCV routines that dual-level edge extraction uses, in numpy.

Each gives OpenCV's output bit for bit for the arguments ``edges/dual_level``
passes (``tests/test_torch_edges.py`` holds them against ``cv2``):

  - :func:`resize_linear_u8`: ``cv2.resize(img_u8, (cols, rows),
    INTER_LINEAR)``;
  - :func:`canny`: ``cv2.Canny(img_u8, low, high, apertureSize=3,
    L2gradient=True)``;
  - :func:`hough_lines_p`: ``cv2.HoughLinesP`` (probabilistic Hough, with
    OpenCV's own random generator, so the same segments in the same order);
  - :func:`draw_line`: ``cv2.line(img, p0, p1, value, 1)`` (8-connected).

They run on the host: edge extraction is under 1% of a run and is cached per
scale on disk.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy import ndimage

_COEF_SCALE = 2048          # INTER_RESIZE_COEF_SCALE: 11-bit coefficients


def linear_taps(n_out: int, n_in: int, clamp: bool, dtype=np.float32):
    """Source taps (i0, i1) and weights (w0, w1) of OpenCV's linear resize
    along one axis: half-pixel centres, ``f = (d + 0.5) * n_in / n_out -
    0.5``, weights in ``dtype``. Along x a tap left of the first or right
    of the last source pixel is clamped with weight 0 on the far one; along
    y OpenCV keeps the weight and clips the row index instead
    (``clamp=False``)."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(dtype)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(dtype)
    if clamp:
        lo, hi = s < 0, s >= n_in - 1
        f[lo | hi] = 0.0
        s[lo], s[hi] = 0, n_in - 1
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1),
            dtype(1.0) - f, f)


def resize_linear_u8(img: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """``cv2.resize(img, (cols, rows), interpolation=INTER_LINEAR)`` of a
    uint8 image. OpenCV's fixed-point path: weights rounded to 11 bits, the
    horizontal pass exact in int32, the vertical pass as its vector code
    computes it, ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16)`` rounded
    by ``(x + 2) >> 2``. (Exact halvings, which OpenCV hands to its area
    filter, give the same numbers.)"""
    H, W = img.shape
    x0, x1, a0, a1 = linear_taps(cols, W, clamp=True)
    y0, y1, b0, b1 = linear_taps(rows, H, clamp=False)

    def fixed(w):
        return np.rint(w * np.float32(_COEF_SCALE)).astype(np.int64)
    a0, a1, b0, b1 = fixed(a0), fixed(a1), fixed(b0), fixed(b1)
    src = img.astype(np.int64)
    hor = src[:, x0] * a0 + src[:, x1] * a1
    s0, s1 = hor[y0] >> 4, hor[y1] >> 4
    out = ((s0 * b0[:, None] >> 16) + (s1 * b1[:, None] >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


_CANNY_TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)


def canny(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(img, low, high, apertureSize=3, L2gradient=True)`` of a
    uint8 image; returns uint8 {0, 255}.

    3x3 Sobel with replicated borders; magnitude ``dx*dx + dy*dy`` (int),
    against thresholds clamped to 32767, squared and floored;
    non-maximum suppression along the gradient's sector (OpenCV's
    ``tan(22.5)`` in 15-bit fixed point, ``>`` against one neighbour and
    ``>=`` against the other, both ``>`` on diagonals) with the magnitude
    padded by zeros; hysteresis: the 8-connected components of surviving
    pixels above ``low`` that hold one above ``high``, which is the set
    OpenCV's stack walk reaches."""
    if low > high:
        low, high = high, low
    low, high = min(32767.0, float(low)), min(32767.0, float(high))
    low = math.floor(low * low if low > 0 else low)
    high = math.floor(high * high if high > 0 else high)

    p = np.pad(np.asarray(img, np.uint8).astype(np.int64), 1, mode="edge")
    dx = (p[:-2, 2:] - p[:-2, :-2]) + 2 * (p[1:-1, 2:] - p[1:-1, :-2]) \
        + (p[2:, 2:] - p[2:, :-2])
    dy = (p[2:, :-2] - p[:-2, :-2]) + 2 * (p[2:, 1:-1] - p[:-2, 1:-1]) \
        + (p[2:, 2:] - p[:-2, 2:])
    m = np.pad(dx * dx + dy * dy, 1)
    mag = m[1:-1, 1:-1]

    ax = np.abs(dx)
    ay = np.abs(dy) << 15
    tg22x = ax * _CANNY_TG22
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg22x + (ax << 16))
    # Diagonal: the neighbours at (row - 1, col - s) and (row + 1, col + s),
    # s = -1 where dx and dy differ in sign.
    anti = (dx ^ dy) < 0
    prev_d = np.where(anti, m[:-2, 2:], m[:-2, :-2])
    next_d = np.where(anti, m[2:, :-2], m[2:, 2:])
    peak = np.where(
        horizontal, (mag > m[1:-1, :-2]) & (mag >= m[1:-1, 2:]),
        np.where(vertical, (mag > m[:-2, 1:-1]) & (mag >= m[2:, 1:-1]),
                 (mag > prev_d) & (mag > next_d)))
    cand = peak & (mag > low)
    lab, n = ndimage.label(cand, structure=np.ones((3, 3), bool))
    keep = np.zeros(n + 1, bool)
    keep[lab[cand & (mag > high)]] = True
    keep[0] = False
    return np.where(keep[lab], 255, 0).astype(np.uint8)


class _CvRng:
    """OpenCV's ``cv::RNG``: multiply-with-carry on a 64-bit state."""

    def __init__(self, state: int = 0xFFFFFFFFFFFFFFFF):
        self.state = state

    def uniform(self, lo: int, hi: int) -> int:
        """``RNG::uniform(int, int)``: ``next() % (hi - lo) + lo``."""
        if lo == hi:
            return lo
        s = self.state
        s = ((s & 0xFFFFFFFF) * 4164903690 + (s >> 32)) & 0xFFFFFFFFFFFFFFFF
        self.state = s
        return (s & 0xFFFFFFFF) % (hi - lo) + lo


def hough_lines_p(img: np.ndarray, rho: float, theta: float, threshold: int,
                  min_len: int, max_gap: int) -> np.ndarray:
    """``cv2.HoughLinesP(img, rho, theta, threshold, minLineLength=min_len,
    maxLineGap=max_gap)``: (N, 4) int32 segments (x0, y0, x1, y1), possibly
    N = 0 (cv2 returns None there).

    OpenCV's ``HoughLinesProbabilistic``: the nonzero points in row-major
    order, drawn one at a time by ``cv::RNG((uint64)-1).uniform(0, count)``
    and removed by moving the last point into the drawn slot; each
    still-unclaimed point votes over the angles (float32 ``cos``/``sin``
    tables times ``1 / rho``, ``rint``); a vote reaching ``threshold`` walks
    the line both ways in 16-bit fixed point until ``max_gap`` misses or the
    border, claims the walked points and, if the segment spans ``min_len``
    in x or y, takes their votes back and keeps it."""
    img = np.asarray(img)
    H, W = img.shape
    rho, theta = float(np.float32(rho)), float(np.float32(theta))
    irho = float(np.float32(1.0) / np.float32(rho))
    numangle = math.floor(math.pi / theta) + 1
    if numangle > 1 and abs(math.pi - (numangle - 1) * theta) < theta / 2:
        numangle -= 1
    numrho = round(((W + H) * 2 + 1) / rho)
    n = np.arange(numangle)
    cos_t = (np.cos(n * theta) * irho).astype(np.float32)
    sin_t = (np.sin(n * theta) * irho).astype(np.float32)
    accum = np.zeros((numangle, numrho), np.int32)
    off = (numrho - 1) // 2

    def bins(x, y):
        return np.rint(np.float32(x) * cos_t + np.float32(y) * sin_t
                       ).astype(np.int64) + off

    mask = img != 0
    ys, xs = np.nonzero(mask)
    points = list(zip(ys.tolist(), xs.tolist()))
    mask = mask.tolist()
    rng = _CvRng()
    lines = []
    shift = 16
    for count in range(len(points), 0, -1):
        idx = rng.uniform(0, count)
        i, j = points[idx]
        points[idx] = points[count - 1]
        if not mask[i][j]:
            continue
        r = bins(j, i)
        accum[n, r] += 1
        votes = accum[n, r]
        best = int(np.argmax(votes))
        if votes[best] < threshold:
            continue
        a, b = -float(sin_t[best]), float(cos_t[best])
        x0, y0 = j, i
        xflag = abs(a) > abs(b)
        if xflag:
            dx0 = 1 if a > 0 else -1
            dy0 = int(np.rint(np.float32(b * (1 << shift))
                              / np.float32(abs(a))))
            y0 = (y0 << shift) + (1 << (shift - 1))
        else:
            dy0 = 1 if b > 0 else -1
            dx0 = int(np.rint(np.float32(a * (1 << shift))
                              / np.float32(abs(b))))
            x0 = (x0 << shift) + (1 << (shift - 1))

        def walk(sign):
            x, y, dx, dy = x0, y0, sign * dx0, sign * dy0
            while True:
                jj, ii = (x, y >> shift) if xflag else (x >> shift, y)
                yield jj, ii
                x += dx
                y += dy

        ends = []
        for sign in (1, -1):
            gap, end = 0, None
            for jj, ii in walk(sign):
                if not (0 <= jj < W and 0 <= ii < H):
                    break
                if mask[ii][jj]:
                    gap, end = 0, (jj, ii)
                else:
                    gap += 1
                    if gap > max_gap:
                        break
            ends.append(end)
        good = (abs(ends[1][0] - ends[0][0]) >= min_len
                or abs(ends[1][1] - ends[0][1]) >= min_len)
        for sign, end in zip((1, -1), ends):
            for jj, ii in walk(sign):
                if mask[ii][jj]:
                    if good:
                        accum[n, bins(jj, ii)] -= 1
                    mask[ii][jj] = False
                if (jj, ii) == end:
                    break
        if good:
            lines.append((*ends[0], *ends[1]))
    return np.array(lines, np.int32).reshape(-1, 4)


def _clip_line(W: int, H: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to [0, W-1] x [0, H-1]: (visible, x1, y1, x2,
    y2)."""
    right, bottom = W - 1, H - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def draw_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
              value) -> np.ndarray:
    """``cv2.line(img, p0, p1, value, thickness=1, lineType=LINE_8)`` in
    place: OpenCV's clipping, then its Bresenham walk from the left end
    (the major axis steps every pixel, the minor one where the error turns
    negative). Points are (x, y). Returns ``img``."""
    H, W = img.shape[:2]
    (x1, y1), (x2, y2) = (int(v) for v in p0), (int(v) for v in p1)
    visible, x1, y1, x2, y2 = _clip_line(W, H, x1, y1, x2, y2)
    if not visible:
        return img
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, abs(y2 - y1), 1 if y2 >= y1 else -1
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    err = major - 2 * minor
    x, y = x1, y1
    for _ in range(major + 1):
        img[y, x] = value
        turn = err < 0
        err += 2 * major * turn - 2 * minor
        if steep:
            y, x = y + sy, x + turn
        else:
            x, y = x + 1, y + sy * turn
    return img
