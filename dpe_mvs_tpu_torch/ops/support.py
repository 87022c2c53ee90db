"""Per-sweep support maps: edge distances, nearest-strong, line-of-sight.

Port of :mod:`dpe_mvs_tpu.ops.support`. The reference's per-pixel walking
kernels become O(log N) pointer-doubling passes over whole maps:

  - ``GenEdgeInform`` (DPE.cu:2483-2591): the walk to the nearest edge pixel
    per direction -> :func:`ray_first_hit_multi`; the edge-density
    "complexity" map -> an integral-image box filter; the label-region
    boundary walk -> :func:`label_run_length` (contiguous runs);
  - ``FindNearestStrongPoint`` (DPE.cu:2855-2889) -> jump flooding
    (:func:`jfa_nearest`, exact Euclidean nearest);
  - ``BresenhamLine`` (DPE.cu:158-250) -> precomputed free-path distances
    along 16 quantized directions; a line-of-sight query is two lookups
    (:class:`LineOfSight`).

Every doubling level shifts each direction plane by one static offset
(``torch.roll`` + an out-of-bounds mask), as the JAX package does.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import gather2d as g2d
from . import sampling
from .sampling import _shift_axis

INF = float(1e9)

# 8 walk directions in the reference's order (DPE.cu:2498) as (dx, dy).
DIR8 = np.array(
    [[0, -1], [0, 1], [-1, 0], [1, 0], [-1, -1], [1, 1], [-1, 1], [1, -1]],
    np.int32,
)

# 16 quantized directions for line-of-sight tests (integer lattice steps).
DIR16 = np.array(
    [
        [1, 0], [2, 1], [1, 1], [1, 2],
        [0, 1], [-1, 2], [-1, 1], [-2, 1],
        [-1, 0], [-2, -1], [-1, -1], [-1, -2],
        [0, -1], [1, -2], [1, -1], [2, -1],
    ],
    np.int32,
)
DIR16_LEN = np.linalg.norm(DIR16, axis=1).astype(np.float32)
DIR16_ANGLE = np.arctan2(DIR16[:, 1].astype(np.float64),
                         DIR16[:, 0].astype(np.float64))


def shift_fill(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """result[y, x] = arr[y+dy, x+dx], out-of-bounds -> fill. Static
    offsets."""
    out = _shift_axis(arr, int(dy), arr.dim() - 2, fill=fill)
    return _shift_axis(out, int(dx), arr.dim() - 1, fill=fill)


def _shift_planes(field: torch.Tensor, offs: Sequence[Tuple[int, int]],
                  oob_fill) -> torch.Tensor:
    """field (D, H, W); result[d, y, x] = field[d, y + oy_d, x + ox_d] for
    the per-plane offsets ``offs[d] = (oy, ox)``, out of bounds -> oob_fill
    (a roll + edge mask per plane, as the JAX package's
    ``_gather_planes``)."""
    D, H, W = field.shape
    dev = field.device
    yg = torch.arange(H, device=dev)[:, None]
    xg = torch.arange(W, device=dev)[None, :]
    fill = torch.full((), oob_fill, dtype=field.dtype, device=dev)
    out = []
    for d, (oy, ox) in enumerate(offs):
        rolled = torch.roll(field[d], (-int(oy), -int(ox)), dims=(0, 1))
        ok = (yg + oy >= 0) & (yg + oy < H) & (xg + ox >= 0) & (xg + ox < W)
        out.append(torch.where(ok, rolled, fill))
    return torch.stack(out)


def _levels(max_steps: int) -> int:
    return max(1, int(np.ceil(np.log2(max(2, max_steps)))))


def ray_first_hit_multi(mask: torch.Tensor, vecs: np.ndarray,
                        max_steps: int) -> torch.Tensor:
    """(D, H, W) distance in steps of vecs[d] to the first True of ``mask``
    strictly along each ray; INF if none within ``max_steps`` (rounded up to
    a power of two). Pointer doubling, one level per power of two."""
    H, W = mask.shape
    D = vecs.shape[0]
    vx = [int(v) for v in vecs[:, 0]]
    vy = [int(v) for v in vecs[:, 1]]
    m = mask.to(torch.float32)[None].expand(D, H, W)
    hit1 = _shift_planes(m, list(zip(vy, vx)), 0.0)
    d = torch.where(hit1 > 0, torch.ones((), device=mask.device),
                    torch.full((), INF, device=mask.device))
    for i in range(_levels(max_steps)):
        k = 1 << i
        d_shift = _shift_planes(d, [(y * k, x * k) for y, x in zip(vy, vx)],
                                INF)
        d = torch.where(d <= float(k), d, float(k) + d_shift)
    return torch.where(d > max_steps, torch.full_like(d, INF), d)


def edge_steps(edge: torch.Tensor, max_steps: int) -> torch.Tensor:
    """(8, H, W) distances in steps along DIR8 to the nearest edge pixel
    (``GenEdgeInform`` edge_neigh, DPE.cu:2499-2520). INF when no hit."""
    return ray_first_hit_multi(edge, DIR8, max_steps)


def label_run_length(label: torch.Tensor, max_steps: int) -> torch.Tensor:
    """(8, H, W) contiguous same-label run length along DIR8
    (label-region boundary, ``GenEdgeInform``, DPE.cu:2557-2590)."""
    H, W = label.shape
    D = DIR8.shape[0]
    vx = [int(v) for v in DIR8[:, 0]]
    vy = [int(v) for v in DIR8[:, 1]]
    lab = label.to(torch.float32)[None].expand(D, H, W)
    nb = _shift_planes(lab, list(zip(vy, vx)), -2.0)
    r = (nb == lab).to(torch.float32)
    for i in range(_levels(max_steps)):
        k = 1 << i
        r_shift = _shift_planes(r, [(y * k, x * k) for y, x in zip(vy, vx)],
                                0.0)
        r = torch.where(r < float(k), r, float(k) + r_shift)
    return r


def box_density(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Fraction of True pixels in the clipped (2r+1)^2 box around each pixel
    (edge-density term of ``GenEdgeInform``, DPE.cu:2523-2536)."""
    H, W = mask.shape
    dev = mask.device
    m = mask.to(torch.float32)
    ii = torch.nn.functional.pad(torch.cumsum(torch.cumsum(m, 0), 1),
                                 (1, 0, 1, 0))
    y = torch.arange(H, device=dev)[:, None]
    x = torch.arange(W, device=dev)[None, :]
    y0 = (y - radius).clamp(0, H)
    y1 = (y + radius + 1).clamp(0, H)
    x0 = (x - radius).clamp(0, W)
    x1 = (x + radius + 1).clamp(0, W)
    total = ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]
    count = ((y1 - y0) * (x1 - x0)).to(torch.float32)
    return total / count


def complexity_map(edge: torch.Tensor, label: torch.Tensor, radius: int,
                   use_label: bool) -> torch.Tensor:
    """Texture-complexity probability sigmoid(25 * (density - 0.35))
    (DPE.cu:2522-2555)."""
    density = box_density(edge, radius)
    if use_label:
        density = torch.maximum(density, box_density(label == 0, radius))
    return torch.sigmoid(25.0 * (density - 0.35))


_JFA_OFFS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
             if not (dy == 0 and dx == 0)]


def jfa_nearest(mask: torch.Tensor, max_dist: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jump-flooding nearest-True-pixel.

    Returns (coords (H, W, 2) int32 as (x, y), valid (H, W) bool). Replaces
    the reference's O(r^2) ring search (``FindNearestStrongPoint``,
    DPE.cu:2855-2889) with an O(log N) pass; distances are Euclidean and
    capped at ``max_dist``."""
    H, W = mask.shape
    dev = mask.device
    xg = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    yg = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(H, W)
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    best_x = torch.where(mask, xg, neg)
    best_y = torch.where(mask, yg, neg)
    levels = max(1, int(np.ceil(np.log2(max(H, W)))))

    def dist2(bx, by):
        dx = (bx - xg).to(torch.float32)
        dy = (by - yg).to(torch.float32)
        return torch.where(bx < 0, torch.full_like(dx, INF), dx * dx + dy * dy)

    def body(i, bx, by):
        k = 1 << (levels - 1 - i)
        offs = [(oy * k, ox * k) for oy, ox in _JFA_OFFS]
        cx = _shift_planes(bx.to(torch.float32)[None].expand(8, H, W), offs,
                           -1.0).to(torch.int32)
        cy = _shift_planes(by.to(torch.float32)[None].expand(8, H, W), offs,
                           -1.0).to(torch.int32)
        cand_d = dist2(cx, cy)                               # (8, H, W)
        cand_best_d, best_o = torch.min(cand_d, dim=0)
        cbx = torch.gather(cx, 0, best_o[None])[0]
        cby = torch.gather(cy, 0, best_o[None])[0]
        better = cand_best_d < dist2(bx, by)
        return torch.where(better, cbx, bx), torch.where(better, cby, by)

    for i in range(levels):
        best_x, best_y = body(i, best_x, best_y)
    # One refinement round at step 1 tightens JFA's rare misses.
    best_x, best_y = body(levels - 1, best_x, best_y)

    d = torch.sqrt(dist2(best_x, best_y))
    valid = (best_x >= 0) & (d <= max_dist)
    coords = torch.stack([torch.where(valid, best_x, neg),
                          torch.where(valid, best_y, neg)], dim=-1)
    return coords, valid


class LineOfSight(NamedTuple):
    """Precomputed low-res free-path field for Bresenham-style edge tests."""

    free_dist: torch.Tensor  # (16, Hl, Wl) free path length in pixels
    scale_x: float           # low-res / full-res
    scale_y: float
    max_len: float           # cap in low-res pixels (reference max_step)

    def crossing(self, ax, ay, bx, by, edge_full: torch.Tensor
                 ) -> torch.Tensor:
        """True if the segment A->B crosses an edge on the low-res map
        (``BresenhamLine``, DPE.cu:158-250). a*/b* are full-res float
        coords. An edge within min(len, cap) along the quantized direction
        from either endpoint blocks; endpoints on a full-res edge pass
        (DPE.cu:162-163)."""
        dev = self.free_dist.device
        lx_a = ax * self.scale_x
        ly_a = ay * self.scale_y
        lx_b = bx * self.scale_x
        ly_b = by * self.scale_y
        dx = lx_b - lx_a
        dy = ly_b - ly_a
        seg = torch.sqrt(dx * dx + dy * dy)
        limit = torch.clamp(seg, max=float(self.max_len))

        angles = torch.as_tensor(DIR16_ANGLE, dtype=torch.float32,
                                 device=dev)
        ang = torch.atan2(dy, dx)
        diff = torch.abs(torch.remainder(ang[..., None] - angles + math.pi,
                                         2 * math.pi) - math.pi)
        bin_ab = torch.argmin(diff, dim=-1)
        bin_ba = (bin_ab + 8) % 16

        def free_at(b, x, y):
            # The segment's bin picks one direction plane per query; the
            # gather clamps the endpoint to the map.
            ic, iy, ix = torch.broadcast_tensors(
                b, torch.round(y).to(torch.int32),
                torch.round(x).to(torch.int32))
            return g2d.gather2d_pick(self.free_dist, ic.contiguous(),
                                     iy.contiguous(), ix.contiguous())

        fa = free_at(bin_ab, lx_a, ly_a)
        fb = free_at(bin_ba, lx_b, ly_b)
        hit = (fa < limit) | (fb < limit)

        def edge_at(x, y):
            return sampling.gather_map(edge_full,
                                       torch.round(y).to(torch.int32),
                                       torch.round(x).to(torch.int32))

        on_edge = edge_at(ax, ay) | edge_at(bx, by)
        return hit & ~on_edge


def build_line_of_sight(edge_low: torch.Tensor, full_w: int, full_h: int,
                        high_res_img: bool) -> LineOfSight:
    """Free-path distances along DIR16 on the low-res edge map."""
    Hl, Wl = edge_low.shape
    max_dim = max(Hl, Wl)
    steps = ray_first_hit_multi(edge_low, DIR16, max_dim)     # (16, Hl, Wl)
    lens = torch.as_tensor(DIR16_LEN, device=edge_low.device)[:, None, None]
    # Reference cap: high-res walks max(h,w)/60 Bresenham cells; otherwise
    # unbounded (DPE.cu:171).
    cap = round(max_dim / 60.0) if high_res_img else float(max_dim * 2)
    return LineOfSight(free_dist=steps * lens, scale_x=Wl / float(full_w),
                       scale_y=Hl / float(full_h), max_len=float(cap))
