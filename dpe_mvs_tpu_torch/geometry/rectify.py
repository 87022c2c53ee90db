"""Pairwise epipolar rectification: the geometry that makes NCC row-local.

The port's own copy of :mod:`dpe_mvs_tpu.geometry.rectify` (the same
float64 arithmetic, so the rect frames and warp fields are bit-identical to
the JAX package's). The frames are solved in numpy; the per-pixel warp
fields and depth factors are evaluated element by element with torch, on
the CPU or on the sweep's device (in numpy they dominated a large frame's
host time), each operation the numpy expression's, so every element rounds
as numpy's does. For each (reference, source) pair both cameras are rotated
about their centers onto a shared orientation whose x-axis is the baseline,
with shared intrinsics K. In the rectified frames:

  * corresponding pixels lie on the same row for every 3-D point;
  * a plane hypothesis ``(n, d)`` (normal in the ref-cam frame, d = -n.X)
    induces the correspondence

        x_src = u + (b/d) * (nr_x (u-cx) + nr_y (v-cy) + f nr_z)

    with ``nr = R2r n`` the normal in the rectified frame and ``b`` the
    baseline: affine in the rectified pixel (u, v);
  * the depth of the hypothesis at (u, v) is z = -d / (nr . p~) with
    p~ = ((u-cx)/f, (v-cy)/f, 1).

Computed once per (problem, scale): rotation/intrinsics, the original <->
rectified homographies, and the separable two-pass warp index fields that
:mod:`..ops.warp` consumes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

LANES = 128


class RectPair(NamedTuple):
    """Rectification of one (reference, source) camera pair (float64)."""

    R2r: np.ndarray      # (3, 3) ref-cam -> rect-cam rotation (shared frame)
    R2s: np.ndarray      # (3, 3) src-cam -> rect-cam rotation
    K: np.ndarray        # (3, 3) rectified intrinsics, fx == fy == f
    b: float             # baseline length (src sits at +x of ref), > 0
    width: int           # rectified frame width  (multiple of 128)
    height: int          # rectified frame height (multiple of 8)
    H_ref: np.ndarray    # (3, 3) original ref pixel -> rect pixel
    H_src: np.ndarray    # (3, 3) original src pixel -> rect pixel
    quality: float       # sin(angle between baseline and ref optical axis)

    @property
    def f(self) -> float:
        return float(self.K[0, 0])

    @property
    def cx(self) -> float:
        return float(self.K[0, 2])

    @property
    def cy(self) -> float:
        return float(self.K[1, 2])


def _camera_center(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return -R.T @ t


def _apply_h(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """pts (N, 2) -> (N, 2) through 3x3 homography."""
    q = (H @ np.concatenate([pts, np.ones((len(pts), 1))], axis=1).T).T
    return q[:, :2] / q[:, 2:3]


def _round_up(v: int, m: int) -> int:
    return -(-int(v) // m) * m


def build_rect_pair(
    ref_K: np.ndarray, ref_R: np.ndarray, ref_t: np.ndarray,
    src_K: np.ndarray, src_R: np.ndarray, src_t: np.ndarray,
    width: int, height: int,
    max_scale: float = 1.8,
    force_size: Optional[Tuple[int, int]] = None,
) -> RectPair:
    """Rectify one camera pair (both images ``width`` x ``height``).

    The rectified frame is sized from the warped bounding box of the
    reference image, clamped to ``max_scale`` times the original dimensions
    and padded to multiples of 8 rows and 128 columns (the JAX package's
    frame, kept so that both packages share their rect frames)."""
    ref_K = np.asarray(ref_K, np.float64)
    src_K = np.asarray(src_K, np.float64)
    ref_R = np.asarray(ref_R, np.float64)
    src_R = np.asarray(src_R, np.float64)
    c_r = _camera_center(ref_R, np.asarray(ref_t, np.float64))
    c_s = _camera_center(src_R, np.asarray(src_t, np.float64))

    base = c_s - c_r
    b = float(np.linalg.norm(base))
    if b < 1e-12:
        raise ValueError("coincident camera centers: cannot rectify")
    x_axis = base / b

    # New y: perpendicular to both the baseline and the ref optical axis
    # (Fusiello, Trucco, Verri 2000).
    z_old = ref_R[2]
    y_dir = np.cross(z_old, x_axis)
    quality = float(np.linalg.norm(y_dir))
    if quality < 1e-6:
        # Forward motion: any perpendicular works; pick one from ref y.
        y_dir = np.cross(ref_R[0], x_axis)
        if np.linalg.norm(y_dir) < 1e-6:
            y_dir = np.cross(ref_R[1], x_axis)
    y_axis = y_dir / np.linalg.norm(y_dir)
    z_axis = np.cross(x_axis, y_axis)
    R_rect = np.stack([x_axis, y_axis, z_axis])  # world -> rect (rows)

    f = float(0.5 * (ref_K[0, 0] + ref_K[1, 1]))
    K0 = np.array([[f, 0.0, 0.0], [0.0, f, 0.0], [0.0, 0.0, 1.0]])
    R2r = R_rect @ ref_R.T
    R2s = R_rect @ src_R.T

    H_ref0 = K0 @ R2r @ np.linalg.inv(ref_K)
    corners = np.array(
        [[0.0, 0.0], [width - 1.0, 0.0], [0.0, height - 1.0],
         [width - 1.0, height - 1.0]])
    warped = _apply_h(H_ref0, corners)
    lo = warped.min(axis=0)
    hi = warped.max(axis=0)
    if force_size is not None:
        out_w, out_h = force_size
    else:
        out_w = min(int(np.ceil(hi[0] - lo[0])) + 1, int(max_scale * width))
        out_h = min(int(np.ceil(hi[1] - lo[1])) + 1, int(max_scale * height))
        out_w = _round_up(max(out_w, LANES), LANES)
        out_h = _round_up(max(out_h, 8), 8)
    # Center the warped ref box in the (possibly clamped) output frame.
    cx = -0.5 * (lo[0] + hi[0]) + 0.5 * (out_w - 1)
    cy = -0.5 * (lo[1] + hi[1]) + 0.5 * (out_h - 1)

    K = np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]])
    H_ref = K @ R2r @ np.linalg.inv(ref_K)
    H_src = K @ R2s @ np.linalg.inv(src_K)
    return RectPair(R2r=R2r, R2s=R2s, K=K, b=b, width=out_w, height=out_h,
                    H_ref=H_ref, H_src=H_src, quality=quality)


# ---------------------------------------------------------------------------
# Separable (Catmull-Smith) two-pass warp index fields
# ---------------------------------------------------------------------------

def _grid(n: int, device, row: bool):
    """0..n-1 as float64, shaped (1, n) (``row``) or (n, 1)."""
    a = torch.arange(n, dtype=torch.float64, device=device)
    return a[None, :] if row else a[:, None]


def _inverse_map(H: np.ndarray, out_w: int, out_h: int, device):
    """Backward map of the projective warp ``out[q] = in[H^{-1} q]``:
    per rect pixel (u, v) the original coords (x, y). Returns (x, y) fields
    of shape (out_h, out_w) plus the positive-denominator mask (float64
    tensors on ``device``)."""
    m = np.linalg.inv(H).tolist()
    u, v = _grid(out_w, device, True), _grid(out_h, device, False)
    w = m[2][0] * u + m[2][1] * v + m[2][2]
    sign_ok = w * float(np.sign(m[2][2] if m[2][2] != 0 else 1.0)) > 1e-9
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    x = (m[0][0] * u + m[0][1] * v + m[0][2]) / w
    y = (m[1][0] * u + m[1][1] * v + m[1][2]) / w
    return x, y, sign_ok


class WarpFields(NamedTuple):
    """Index fields for a two-pass row-local projective warp (ops/warp.py).

    Pass 1 (vertical): tmp[v, xc] = in[vpass_y[v, xc], xc]   (column gather)
    Pass 2 (horizontal): out[v, u] = tmp[v, hpass_x[v, u]]   (row gather)

    With backward map (x, y) = g(u, v), the horizontal pass reads tmp at
    column x(u, v); the vertical pass therefore needs, for every (rect row
    v, original column xc), the original row that the composite warp
    samples there: solve u from x(u, v) = xc and evaluate y at it."""

    vpass_y: np.ndarray   # (out_h, in_w)  float32
    hpass_x: np.ndarray   # (out_h, out_w) float32
    valid: np.ndarray     # (out_h, out_w) bool: maps inside the input image
    transposed_input: bool  # input must be transposed before pass 1


def _needs_transpose(H: np.ndarray) -> bool:
    """True when the warp rotates by more than ~45 deg, in which case the
    separable decomposition bottlenecks; the caller then feeds the transposed
    input with a swap-adjusted homography."""
    Minv = np.linalg.inv(H)
    return abs(Minv[0, 0]) < abs(Minv[0, 1])


_SWAP = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def build_warp_fields(H: np.ndarray, in_w: int, in_h: int,
                      out_w: int, out_h: int, device=None) -> WarpFields:
    """Precompute the two-pass index fields for ``out[q] = in[H^{-1} q]``,
    evaluated on ``device`` (the CPU by default) and returned as numpy
    arrays."""
    H = np.asarray(H, np.float64)
    transposed = _needs_transpose(H)
    if transposed:
        H = H @ _SWAP  # input will be given transposed: in'[y, x] = in[x, y]
        in_w, in_h = in_h, in_w
    device = torch.device("cpu" if device is None else device)

    x, y, sign_ok = _inverse_map(H, out_w, out_h, device)
    valid = sign_ok & (x >= 0) & (x <= in_w - 1) & (y >= 0) & (y <= in_h - 1)
    del y, sign_ok

    # Vertical-pass rows: solve u from x(u, v) = xc, then y(u, v).
    m = np.linalg.inv(H).tolist()
    v = _grid(out_h, device, False)
    xc = _grid(in_w, device, True)
    # x = (m00 u + m01 v + m02) / (m20 u + m21 v + m22)
    #  => u = ((m21 v + m22) xc - (m01 v + m02)) / (m00 - m20 xc)
    denom = m[0][0] - m[2][0] * xc
    denom = torch.where(denom.abs() < 1e-9, torch.sign(denom + 1e-30) * 1e-9,
                        denom)
    u_of = ((m[2][1] * v + m[2][2]) * xc - (m[0][1] * v + m[0][2])) / denom
    w2 = m[2][0] * u_of + m[2][1] * v + m[2][2]
    w2 = torch.where(w2.abs() < 1e-12, 1e-12, w2)
    vpass_y = (m[1][0] * u_of + m[1][1] * v + m[1][2]) / w2

    return WarpFields(
        vpass_y=vpass_y.clamp(0.0, in_h - 1).to(torch.float32).cpu().numpy(),
        hpass_x=x.clamp(0.0, in_w - 1).to(torch.float32).cpu().numpy(),
        valid=valid.cpu().numpy(),
        transposed_input=transposed,
    )


def src_depth_factor(pair: RectPair, src_K: np.ndarray, width: int,
                     height: int, device=None) -> torch.Tensor:
    """(H, W) float32 factor taking a source depth map (z along the source
    camera's axis, on the source pixel grid) to z along the rect axis:
    z_rect = (R2s row 3) . X_src = depth * (r3 . p~_src), evaluated on
    ``device`` (the CPU by default)."""
    device = torch.device("cpu" if device is None else device)
    Ks = np.asarray(src_K, np.float64).tolist()
    r3 = np.asarray(pair.R2s[2], np.float64).tolist()
    px = (_grid(width, device, True) - Ks[0][2]) / Ks[0][0]
    py = (_grid(height, device, False) - Ks[1][2]) / Ks[1][1]
    return (r3[0] * px + r3[1] * py + r3[2] * 1.0).to(torch.float32)


def disparity_coeffs(nr, d, f, b):
    """Affine disparity of a rect-frame plane: x_src(u, v) =
    u + gx*(u-cx) + gy*(v-cy) + g0. Arrays broadcast (numpy or torch)."""
    inv_d = 1.0 / d
    gx = b * nr[..., 0] * inv_d
    gy = b * nr[..., 1] * inv_d
    g0 = b * f * nr[..., 2] * inv_d
    return gx, gy, g0
