"""Bilateral-weighted NCC matching costs and the geometric-consistency cost.

Port of :mod:`dpe_mvs_tpu.ops.ncc` (``ComputeBilateralNCCOld``
DPE.cu:692-778, ``ComputeBilateralNCCNew`` :557-690,
``ComputeGeomConsistencyCost`` :915-953):

  - the whole image evaluates a chunk of window *sample offsets* at a time
    as elementwise ops over the window centres, with one bilinear gather
    (``gather2d_hwc`` on a corner map) per chunk;
  - the plane-induced homography is evaluated once per window centre and
    applied to sample offsets incrementally
    (H @ (p + o) = H @ p + ox * H[:,0] + oy * H[:,1]);
  - the adaptive weak-pixel radius is the static 36-sample stencil with a
    per-pixel scale factor.

The chunks are the JAX package's (:func:`_chunking`, sized from the window
centres' shape), so the float sums follow the same order: within a chunk a
sum over its samples, across chunks a running total. A homography field may
carry leading dims in front of the centres' shape (candidates, views): the
port evaluates every view (and, where memory allows, several candidates) in
one pass, each element computed as the JAX package computes it for its own
view. Costs are in [0, 2] with 2.0 == COST_MAX meaning invalid
(DPE.cu:573).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import COST_MAX, GEOM_COST_MAX
from ..geometry import cameras as geo
from . import sampling

K_MIN_VAR = 1e-5


def window_offsets(radius: int, increment: int) -> np.ndarray:
    """Static window offsets (S, 2) as the reference's
    ``for i in -r..r step inc`` double loop."""
    r = np.arange(-radius, radius + 1, increment, dtype=np.float32)
    ox, oy = np.meshgrid(r, r, indexing="ij")  # i == x offset, j == y offset
    return np.stack([ox.ravel(), oy.ravel()], axis=-1)


class HomographyField(NamedTuple):
    """Per-pixel plane homography, decomposed for incremental application."""

    q0: torch.Tensor  # (..., 3)  H @ [cx, cy, 1]
    hx: torch.Tensor  # (..., 3)  H[:, 0]
    hy: torch.Tensor  # (..., 3)  H[:, 1]

    def at_offset(self, ox, oy):
        """ox/oy: scalars or tensors broadcastable to the pixel grid."""
        q = [self.q0[..., k] + self.hx[..., k] * ox + self.hy[..., k] * oy
             for k in range(3)]
        return q[0] / q[2], q[1] / q[2]


def homography_field(ref_cam: geo.Camera, src_K, R_rel, t_rel, plane, cx, cy
                     ) -> HomographyField:
    """The per-pixel homography of a plane field, pre-applied at the window
    centres (cx, cy). Operands broadcast as in the JAX package; leading view
    dims come in through ``src_K``, ``R_rel`` and ``t_rel``."""
    eye = torch.eye(3, dtype=src_K.dtype, device=src_K.device)
    src_cam = geo.Camera(K=src_K, R=eye, t=torch.zeros(3, device=eye.device))
    Hm = geo.homography_from_plane(ref_cam, src_cam, plane, R_rel=R_rel,
                                   t_rel=t_rel)
    hx = Hm[..., :, 0]
    hy = Hm[..., :, 1]
    hz = Hm[..., :, 2]
    q0 = hx * cx[..., None] + hy * cy[..., None] + hz
    return HomographyField(q0=q0, hx=hx, hy=hy)


def _chunking(S: int, batch_shape) -> Tuple[int, int]:
    """(chunk, n_chunks): bound transient gather buffers to ~4M elements."""
    batch_elems = math.prod(batch_shape)
    chunk = max(1, min(S, int(4_000_000 // max(batch_elems, 1)) or 1))
    return chunk, (S + chunk - 1) // chunk


def _chunked_offsets(offsets: np.ndarray, chunk: int, n_chunks: int):
    pad = n_chunks * chunk - offsets.shape[0]
    offs = np.concatenate([offsets.astype(np.float32),
                           np.zeros((pad, 2), np.float32)])
    smask = np.concatenate([np.ones(offsets.shape[0], np.float32),
                            np.zeros(pad, np.float32)])
    return offs.reshape(n_chunks, chunk, 2), smask.reshape(n_chunks, chunk)


class RefWindowCache(NamedTuple):
    """The reference-image side of an NCC window set: the ref samples and
    bilateral weights depend only on the reference image and the window
    geometry, not on the candidate plane, the source view or the disparity
    step, so one cache serves every cost evaluation of a sweep stage."""

    ref_pix: torch.Tensor   # (n_chunks, chunk, *B)
    w: torch.Tensor         # (n_chunks, chunk, *B) masked bilateral weights
    sum_w: torch.Tensor     # (*B)
    sum_ref: torch.Tensor
    sum_ref_ref: torch.Tensor


def _chunk_offsets(off_c: np.ndarray, nb: int, scale, device):
    """A chunk's offsets as (chunk, 1...) tensors (times ``scale``)."""
    oshape = (off_c.shape[0],) + (1,) * nb
    ox = torch.as_tensor(off_c[:, 0], device=device).reshape(oshape)
    oy = torch.as_tensor(off_c[:, 1], device=device).reshape(oshape)
    if scale is not None:
        ox = ox * scale[None]
        oy = oy * scale[None]
    return ox, oy


def _ref_side(ref_img, corners, cx, cy, ox, oy, m_c, sigma_spatial,
              sigma_color, ref_center_pix):
    """A chunk's ref samples and masked bilateral weights (chunk, *B)."""
    ref_pix = sampling.bilinear(ref_img, cx[None] + ox, cy[None] + oy,
                                corners)
    # ComputeBilateralWeight (DPE.cu:550-555): NON-squared spatial distance
    # over 2*sigma^2 (a reference quirk; kept).
    spatial = torch.sqrt(ox * ox + oy * oy)
    w = torch.exp(
        -spatial / (2.0 * sigma_spatial * sigma_spatial)
        - torch.abs(ref_pix - ref_center_pix[None])
        / (2.0 * sigma_color * sigma_color)
    ) * torch.as_tensor(m_c, device=cx.device).reshape(ox.shape[:1] + (1,) *
                                                       cx.dim())
    return ref_pix, w


def make_ref_cache(ref_img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                   offsets: np.ndarray, sigma_spatial: float,
                   sigma_color: float, ref_center_pix: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   max_bytes: int = 2_000_000_000, *,
                   corners: torch.Tensor) -> Optional[RefWindowCache]:
    """Build the ref-side cache, or None if it would exceed ``max_bytes``.
    ``corners``: the reference's :func:`sampling.corner_map`."""
    S = offsets.shape[0]
    if 2 * 4 * S * math.prod(cx.shape) > max_bytes:
        return None
    chunk, n_chunks = _chunking(S, cx.shape)
    offs, smask = _chunked_offsets(offsets, chunk, n_chunks)
    pix, ws = [], []
    for c in range(n_chunks):
        ox, oy = _chunk_offsets(offs[c], cx.dim(), scale, cx.device)
        p, w = _ref_side(ref_img, corners, cx, cy, ox, oy, smask[c],
                         sigma_spatial, sigma_color, ref_center_pix)
        pix.append(p)
        ws.append(w)
    ref_pix, w = torch.stack(pix), torch.stack(ws)
    wr = w * ref_pix
    return RefWindowCache(ref_pix=ref_pix, w=w, sum_w=w.sum((0, 1)),
                          sum_ref=wr.sum((0, 1)),
                          sum_ref_ref=(wr * ref_pix).sum((0, 1)))


def bilateral_ncc(
    ref_img: torch.Tensor,          # (H, W)
    src_img: torch.Tensor,          # (H, W), or (V, H, W) (see below)
    hom: HomographyField,           # (*L, *B, 3), pre-applied at (cx, cy)
    cx: torch.Tensor,               # (*B) window centre x (float)
    cy: torch.Tensor,               # (*B) window centre y
    offsets: np.ndarray,            # (S, 2) static
    sigma_spatial: float,
    sigma_color: float,
    ref_center_pix: torch.Tensor,   # (*B) color anchor of the bilateral weight
    scale: Optional[torch.Tensor] = None,   # (*B) offset scale (adaptive r)
    ref_cache: Optional[RefWindowCache] = None,
    *,
    ref_corners: torch.Tensor,
    src_corners: torch.Tensor,
) -> torch.Tensor:
    """Bilateral-weighted NCC cost of one window per centre. Returns
    (*L, *B) costs in [0, COST_MAX].

    ``hom`` may carry leading dims L in front of the centres' shape B. With
    a (V, H, W) ``src_img`` the last of them is the view axis, each view
    sampled from its own image. ``ref_corners`` / ``src_corners`` are the
    images' :func:`sampling.corner_map`. With ``ref_cache`` the
    reference-image half of the work is skipped."""
    height, width = src_img.shape[-2:]
    nb = cx.dim()
    lead = hom.q0.dim() - 1 - nb
    view = None
    if src_img.dim() == 3:
        view = torch.arange(src_img.shape[0], device=cx.device).reshape(
            (-1,) + (1,) * (1 + nb))

    S = offsets.shape[0]
    chunk, n_chunks = _chunking(S, cx.shape)
    offs, smask = _chunked_offsets(offsets, chunk, n_chunks)
    h = HomographyField(*(t.unsqueeze(lead) for t in hom))
    sums = [None] * 6
    if ref_cache is not None:
        sums[:3] = ref_cache.sum_w, ref_cache.sum_ref, ref_cache.sum_ref_ref

    def add(i, s):
        sums[i] = s if sums[i] is None else sums[i] + s

    for c in range(n_chunks):
        ox, oy = _chunk_offsets(offs[c], nb, scale, cx.device)
        if ref_cache is None:
            ref_pix, w = _ref_side(ref_img, ref_corners, cx, cy, ox, oy,
                                   smask[c], sigma_spatial, sigma_color,
                                   ref_center_pix)
            wr = w * ref_pix
            add(0, w.sum(0))
            add(1, wr.sum(0))
            add(2, (wr * ref_pix).sum(0))
        else:
            ref_pix, w = ref_cache.ref_pix[c], ref_cache.w[c]
            wr = w * ref_pix
        sx, sy = h.at_offset(ox, oy)
        src_pix = sampling.bilinear(src_img, sx, sy, src_corners, view)
        ws = w * src_pix
        add(3, ws.sum(lead))
        add(4, (ws * src_pix).sum(lead))
        add(5, (wr * src_pix).sum(lead))
    sum_w, sum_ref, sum_ref_ref, sum_src, sum_src_src, sum_ref_src = sums

    inv_w = 1.0 / sum_w
    m_ref = sum_ref * inv_w
    m_src = sum_src * inv_w
    var_ref = sum_ref_ref * inv_w - m_ref * m_ref
    var_src = sum_src_src * inv_w - m_src * m_src
    covar = sum_ref_src * inv_w - m_ref * m_src
    denom = torch.sqrt((var_ref * var_src).clamp(min=K_MIN_VAR * K_MIN_VAR))
    ncc = (1.0 - covar / denom).clamp(0.0, COST_MAX)
    invalid = (var_ref < K_MIN_VAR) | (var_src < K_MIN_VAR)

    # Window-center out-of-source-image -> COST_MAX (DPE.cu:577-580).
    ctr_x, ctr_y = hom.at_offset(torch.zeros_like(cx), torch.zeros_like(cy))
    oob = (ctr_x < 0.0) | (ctr_x >= width) | (ctr_y < 0.0) | \
        (ctr_y >= height)
    return torch.where(invalid | oob, COST_MAX, ncc)


def geom_consistency_cost(ref_cam: geo.Camera, src_cam: geo.Camera,
                          src_depth: torch.Tensor, plane: torch.Tensor,
                          px: torch.Tensor, py: torch.Tensor,
                          view=None) -> torch.Tensor:
    """Forward-backward reprojection error capped at 3.0
    (``ComputeGeomConsistencyCost``, DPE.cu:915-953).

    ``src_depth`` (H, W), or (V, H, W) with ``src_cam`` carrying the views
    as leading dims and ``view`` the integer index tensor of
    :func:`sampling.nearest`."""
    depth = geo.depth_from_plane(ref_cam, plane, px, py)
    Xw = geo.backproject_to_world(ref_cam, px, py, depth)
    sx, sy, _sd = geo.project_to_camera(src_cam, Xw)
    d_src = sampling.nearest(src_depth, sx, sy, view)
    Xs = geo.backproject_to_world(src_cam, sx, sy, d_src)
    bx, by, _rd = geo.project_to_camera(ref_cam, Xs)
    err = torch.sqrt((px - bx) ** 2 + (py - by) ** 2)
    err = err.clamp(max=GEOM_COST_MAX)
    return torch.where(d_src == 0.0, GEOM_COST_MAX, err)
