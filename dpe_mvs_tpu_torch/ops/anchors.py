"""Deformable strong-anchor search for weak pixels (``GenNeighbours``,
DPE.cu:2103-2463).

Port of :mod:`dpe_mvs_tpu.ops.anchors`. Per angular sector the first strong
pixel along a lattice ray is found by pointer doubling on a slightly dilated
strong mask and snapped to an exact strong pixel through the jump-flood
nearest-strong field; the reference's cone-angle test and Bresenham edge
limit (through :class:`.support.LineOfSight`) are applied to the snapped
anchor; label-region points extend the pool; a fixed 64-trial plane RANSAC
over the pool keeps the 8 most coplanar anchors (inlier >= 6 rule, adaptive
threshold shrink to the 10th residual, in-triangle / normal-consistency
gating). Draws follow the JAX function's key schedule.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import PatchMatchParams, PixelState
from ..geometry import cameras as geo
from ..utils.profiling import BRANCHES
from . import sampling, support

WEAK = int(PixelState.WEAK)
STRONG = int(PixelState.STRONG)
UNKNOWN = int(PixelState.UNKNOWN)

MAX_SEARCH_RADIUS = 4096
MIN_MARGIN = 6
NEIGHBOUR_NUM = 9
BIG = float(1e30)
# The anchor search runs in row bands whose largest transient, the line-of-
# sight test's (D, h, W, 16) float32 angle table over the D sector rays,
# stays within BAND_BYTES: at full-resolution frames its (D, H, W) and
# (H, W, pool) fields would not fit the card. Exact: a pixel's anchors read
# only full-frame inputs and its own entries of the full-frame draws. One
# band up to 1600x1200; module-level so that tests can force many.
BAND_BYTES = 2e9


def sector_rays(rotate_time: int) -> np.ndarray:
    """Integer lattice step vectors for 8*rotate_time evenly spaced sectors."""
    n = 8 * rotate_time
    vecs = []
    for i in range(n):
        theta = 2.0 * math.pi * i / n
        R = 5.0
        v = np.array([round(R * math.cos(theta)), round(R * math.sin(theta))],
                     np.int32)
        g = math.gcd(int(abs(v[0])), int(abs(v[1]))) or 1
        vecs.append(v // g)
    return np.stack(vecs)


def _dilate(mask: torch.Tensor, r: int) -> torch.Tensor:
    out = mask
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out = out | support.shift_fill(mask, dy, dx, False)
    return out


def tri_contains(ax, ay, bx, by, cx_, cy_, px, py):
    """PointinTriangle (DPE.cu:135-156): the pixel (px, py) lies in the
    non-degenerate triangle (a, b, c) (every side longer than 2 px)."""
    def edge_len(x0, y0, x1, y1):
        return torch.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2)
    ab = edge_len(ax, ay, bx, by)
    bc = edge_len(bx, by, cx_, cy_)
    ca = edge_len(cx_, cy_, ax, ay)
    degenerate = (ab <= 2) | (bc <= 2) | (ca <= 2) | \
        ~((ab + bc > ca) & (bc + ca > ab) & (ab + ca > bc))
    pax, pay = ax - px, ay - py
    pbx, pby = bx - px, by - py
    pcx, pcy = cx_ - px, cy_ - py
    t1 = pax * pby - pay * pbx
    t2 = pbx * pcy - pby * pcx
    t3 = pcx * pay - pcy * pax
    inside = (t1 * t2 >= 0) & (t1 * t3 >= 0)
    return inside & ~degenerate


def normals_agree(na, nb, nc):
    """The three anchors' normals pairwise within 30 degrees (cos >=
    0.8660254), the normal-consistency gate of geom passes."""
    return ((na * nb).sum(-1) >= 0.8660254) & \
        ((na * nc).sum(-1) >= 0.8660254) & ((nb * nc).sum(-1) >= 0.8660254)


def _fit_depth_at(nrm, d, fxx, fyy):
    return -d / (nrm[..., 0] * fxx + nrm[..., 1] * fyy + nrm[..., 2])


def gen_neighbours(key, data, state, params: PatchMatchParams, *,
                   edge_steps, complexity, label_runs,
                   los, nearest_strong) -> Tuple[torch.Tensor, ...]:
    """Returns (neighbours (8, H, W, 2) int32 (x, y) or -1, reliable (H, W)
    bool, new weak map with unreliable weak -> UNKNOWN (``NeigbourUpdate``,
    DPE.cu:2465-2481), new complexity map).

    ``state.plane`` must still hold the (world normal, depth) prior layout:
    the reference runs this before RandomInitialization (DPE.cu:3168)."""
    H, W = data.ref_image.shape
    dev = data.device
    k_lim, k_ransac = key.split(2)

    depth_diff = data.depth_max - data.depth_min
    ransac_threshold = params.ransac_threshold * depth_diff
    rt = params.rotate_time
    half_angle = (45.0 / rt) / 2.0
    cos_thresh = math.cos(math.radians(half_angle))

    strong = state.weak == STRONG
    strong_d = _dilate(strong, 1)

    # Per-pixel edge_limit (DPE.cu:2155-2164). Pixels that keep the limit
    # bump their complexity to >= 0.99 (DPE.cu:2162), which effectively
    # disables the limit for them in the later fit-plane RANSAC redraw.
    new_complexity = complexity
    if params.use_limit and params.use_edge:
        u = k_lim.uniform((H, W)).to(dev)
        edge_limit = u >= complexity
        is_weak_px = state.weak == WEAK
        new_complexity = torch.where(is_weak_px & edge_limit,
                                     complexity.clamp(min=0.99), complexity)
    else:
        edge_limit = torch.full((H, W), bool(params.use_limit), device=dev)

    rays = sector_rays(rt)                                    # (D, 2)
    max_steps_pow2 = 1 << int(math.ceil(math.log2(
        min(MAX_SEARCH_RADIUS, max(H, W)))))
    t_hit = support.ray_first_hit_multi(strong_d, rays, max_steps_pow2)
    must_tri = ~((data.label > 0) & edge_limit) if params.use_label \
        else torch.ones((H, W), dtype=torch.bool, device=dev)

    neighbours = torch.empty((8, H, W, 2), dtype=torch.int32, device=dev)
    reliable = torch.empty((H, W), dtype=torch.bool, device=dev)
    bands = sampling.spans(H, 64.0 * len(rays) * W, BAND_BYTES)
    if len(bands) > 1:
        BRANCHES["anchor-search bands"] += len(bands)
    for r0, r1 in bands:
        neighbours[:, r0:r1], reliable[r0:r1] = _anchor_band(
            r0, r1, k_ransac, data, state, params, rays, t_hit[:, r0:r1],
            edge_limit, must_tri, cos_thresh, ransac_threshold, label_runs,
            los, nearest_strong)

    is_weak = state.weak == WEAK
    new_weak = torch.where(is_weak & ~reliable,
                           torch.full((), UNKNOWN, dtype=torch.uint8,
                                      device=dev), state.weak)
    return neighbours, reliable, new_weak, new_complexity


def _anchor_band(r0: int, r1: int, k_ransac, data, state,
                 params: PatchMatchParams, rays: np.ndarray,
                 t_hit: torch.Tensor, edge_limit: torch.Tensor,
                 must_tri: torch.Tensor, cos_thresh: float,
                 ransac_threshold, label_runs, los, nearest_strong):
    """:func:`gen_neighbours` for the pixels of rows [r0, r1): ((8, h, W, 2)
    anchors or -1 (weak pixels only), (h, W) reliable). ``t_hit``: the band's
    (D, h, W) sector-ray hits; ``edge_limit`` and ``must_tri`` full-frame;
    each RANSAC trial draws its full-frame indices and keeps the band's."""
    H, W = data.ref_image.shape
    h = r1 - r0
    dev = data.device
    px, py = geo.pixel_grid(H, W, dev)
    px, py = px[r0:r1], py[r0:r1]
    xg = px.to(torch.int32)
    yg = py.to(torch.int32)
    edge_limit = edge_limit[r0:r1]
    rt = params.rotate_time

    # --- Sector rays, all directions at once ------------------------------
    vlen = torch.as_tensor(np.hypot(rays[:, 0], rays[:, 1]).astype(
        np.float32), device=dev)[:, None, None]
    hit = t_hit < support.INF                                 # (D, h, W)
    vxj = torch.as_tensor(rays[:, 0], dtype=torch.int32,
                          device=dev)[:, None, None]
    vyj = torch.as_tensor(rays[:, 1], dtype=torch.int32,
                          device=dev)[:, None, None]
    t = torch.where(hit, t_hit, torch.ones_like(t_hit)).to(torch.int32)
    hx = xg[None] + t * vxj
    hy = yg[None] + t * vyj
    anc = sampling.gather_map(nearest_strong, hy, hx)         # (D, h, W, 2)
    ax = anc[..., 0]
    ay = anc[..., 1]
    ok = hit & (ax >= 0)
    # Margin (DPE.cu:2187).
    ok = ok & (ax >= MIN_MARGIN) & (ay >= MIN_MARGIN) & \
        (ax < W - MIN_MARGIN) & (ay < H - MIN_MARGIN)
    # Cone-angle acceptance (DPE.cu:2198-2201).
    dxf = (ax - xg[None]).to(torch.float32)
    dyf = (ay - yg[None]).to(torch.float32)
    norm = torch.sqrt(dxf * dxf + dyf * dyf)
    cosang = (dxf * vxj + dyf * vyj) / (norm.clamp(min=1e-6) * vlen)
    ok = ok & (cosang > cos_thresh)
    # Edge limit: line of sight must not cross an edge (DPE.cu:2201).
    if los is not None:
        cross = los.crossing(px[None], py[None], ax.to(torch.float32),
                             ay.to(torch.float32), data.edge)
        ok = ok & ~(edge_limit[None] & cross)
    pool_x = [ax]
    pool_y = [ay]
    pool_valid = [ok]

    # --- Label-region extension, all points at once (DPE.cu:2224-2272) ----
    if params.use_label:
        # Effective reference behaviour of the MIN/MAX'd step split
        # (DPE.cu:2239-2245): even dirs get 2*rt-1 points, odd get 1.
        pt_dir, pt_s = [], []
        for d in range(8):
            n_pts = (2 * rt - 1) if d % 2 == 0 else 1
            for s in range(1, n_pts + 1):
                pt_dir.append(d)
                pt_s.append(s)
        pt_dir = np.array(pt_dir, np.int64)                   # (P2,)
        n_pts_per_dir = np.array([(2 * rt - 1) if d % 2 == 0 else 1
                                  for d in range(8)], np.int32)

        dist = label_runs[:, r0:r1]                           # (8, h, W)
        gap = torch.as_tensor(n_pts_per_dir + 1, dtype=torch.float32,
                              device=dev)[:, None, None]
        step_len = (dist / gap).to(torch.int32).clamp(min=1)
        pd = torch.as_tensor(pt_dir, device=dev)
        sl = step_len[pd]                                     # (P2, h, W)
        ddx = torch.as_tensor(support.DIR8[pt_dir, 0], dtype=torch.int32,
                              device=dev)[:, None, None]
        ddy = torch.as_tensor(support.DIR8[pt_dir, 1], dtype=torch.int32,
                              device=dev)[:, None, None]
        sj = torch.as_tensor(pt_s, dtype=torch.int32,
                             device=dev)[:, None, None]
        tx = xg[None] + sj * sl * ddx
        ty = yg[None] + sj * sl * ddy
        anc2 = sampling.gather_map(nearest_strong, ty, tx)    # (P2, h, W, 2)
        ax2 = anc2[..., 0]
        ay2 = anc2[..., 1]
        label_here = data.label[r0:r1]
        ok2 = (label_here > 0)[None] & (dist[pd] > 0) & (ax2 >= 0)
        ok2 = ok2 & (ax2 >= MIN_MARGIN) & (ay2 >= MIN_MARGIN) & \
            (ax2 < W - MIN_MARGIN) & (ay2 < H - MIN_MARGIN)
        lab_at = sampling.gather_map(data.label, ay2, ax2)
        ok2 = ok2 & ((lab_at == 0) | (lab_at == label_here[None]))
        pool_x.append(ax2)
        pool_y.append(ay2)
        pool_valid.append(ok2)

    pool_x = torch.cat(pool_x, 0).permute(1, 2, 0)            # (h, W, P)
    pool_y = torch.cat(pool_y, 0).permute(1, 2, 0)
    pool_valid = torch.cat(pool_valid, 0).permute(1, 2, 0)
    # Invalid pool entries gather from the pixel's own position (pool_valid
    # masks every downstream use), which keeps the gathers local.
    pool_x = torch.where(pool_valid, pool_x, xg[..., None])
    pool_y = torch.where(pool_valid, pool_y, yg[..., None])
    P = pool_x.shape[-1]
    pool_size = pool_valid.sum(-1)

    # 3D data of each anchor under the prior planes (DPE.cu:2286-2300).
    cam = data.ref_cam
    pool_z = sampling.gather_map(state.plane[..., 3], pool_y, pool_x)
    fx_ = (pool_x.to(torch.float32) - cam.cx) / cam.fx
    fy_ = (pool_y.to(torch.float32) - cam.cy) / cam.fy

    need_normals = params.geom_consistency
    if need_normals:
        n_world = sampling.gather_map(state.plane[..., :3], pool_y, pool_x)
        pool_n = geo.normal_world_to_cam(cam, n_world)       # (h, W, P, 3)
    center_z = state.plane[r0:r1, :, 3]

    # ---------------- RANSAC over the pool (DPE.cu:2302-2435) -------------
    T = 64
    limit = 0.05 if params.high_res_img else 0.005
    must_tri = must_tri[r0:r1]
    pick = sampling.pick_last
    pool_xf = pool_x.to(torch.float32)
    pool_yf = pool_y.to(torch.float32)
    cxs = (px - cam.cx) / cam.fx
    cys = (py - cam.cy) / cam.fy

    best_plane = torch.zeros((h, W, 4), device=dev)
    best_count = torch.full((h, W), 3, dtype=torch.int64, device=dev)
    best_dist = torch.full((h, W), BIG, device=dev)
    thr = torch.full((h, W), 1.0, device=dev) * ransac_threshold
    has_norm = torch.zeros((h, W), dtype=torch.bool, device=dev)
    has_valid = torch.zeros((h, W), dtype=torch.bool, device=dev)

    for k in k_ransac.split(T):
        ka, kb, kc = k.split(3)
        ia = ka.randint((H, W), 0, P)[r0:r1].to(dev).long()
        ib = kb.randint((H, W), 0, P)[r0:r1].to(dev).long()
        ic = kc.randint((H, W), 0, P)[r0:r1].to(dev).long()
        distinct = (ia != ib) & (ib != ic) & (ia != ic)

        ax_, ay_ = pick(pool_xf, ia), pick(pool_yf, ia)
        bx_, by_ = pick(pool_xf, ib), pick(pool_yf, ib)
        cx_, cy_ = pick(pool_xf, ic), pick(pool_yf, ic)
        va = pick(pool_valid, ia) & pick(pool_valid, ib) & \
            pick(pool_valid, ic)

        in_tri = tri_contains(ax_, ay_, bx_, by_, cx_, cy_, px, py)
        ok = distinct & va & (in_tri | ~must_tri)

        if need_normals:
            def pick3(idx):
                return torch.stack([pick(pool_n[..., j], idx)
                                    for j in range(3)], -1)
            consist = normals_agree(pick3(ia), pick3(ib), pick3(ic)) & \
                edge_limit
            ok = ok & ~(has_norm & ~consist)

        # Edge tests on triangle sides (DPE.cu:2323-2339).
        if los is not None:
            cr_ab = los.crossing(ax_, ay_, bx_, by_, data.edge)
            cr_bc = los.crossing(bx_, by_, cx_, cy_, data.edge)
            cr_ca = los.crossing(cx_, cy_, ax_, ay_, data.edge)
            ok = ok & ~(edge_limit & (cr_ab | cr_bc | cr_ca))

        # Plane through the three cam-frame 3D points.
        za, zb, zc = pick(pool_z, ia), pick(pool_z, ib), pick(pool_z, ic)
        A = torch.stack([pick(fx_, ia) * za, pick(fy_, ia) * za, za], -1)
        B = torch.stack([pick(fx_, ib) * zb, pick(fy_, ib) * zb, zb], -1)
        C = torch.stack([pick(fx_, ic) * zc, pick(fy_, ic) * zc, zc], -1)
        cr = torch.linalg.cross(A - C, B - C)
        nrm2 = (cr * cr).sum(-1)
        ok = ok & (nrm2 > 0) & torch.isfinite(nrm2)
        nrm = cr / torch.sqrt(nrm2.clamp(min=1e-30))[..., None]
        dpl = -(nrm * A).sum(-1)

        fit_all = _fit_depth_at(nrm[..., None, :], dpl[..., None], fx_, fy_)
        resid = torch.abs(fit_all - pool_z)
        resid = torch.where(pool_valid, resid, torch.full_like(resid, BIG))
        count = (resid < thr[..., None]).sum(-1)
        ok = ok & (count >= 6)

        fit_c = _fit_depth_at(nrm, dpl, cxs, cys)
        center_dist = torch.abs(fit_c - center_z)

        improved = ok & (count > best_count)
        tied = ok & (count == best_count) & (center_dist < best_dist)
        take = improved | tied

        plane4 = torch.cat([nrm, dpl[..., None]], -1)
        best_plane = torch.where(take[..., None], plane4, best_plane)
        best_dist = torch.where(take, center_dist, best_dist)
        has_valid = has_valid | ok
        must_tri = must_tri | (take & in_tri)
        if need_normals:
            has_norm = has_norm | (take & consist)

        # Adaptive threshold shrink (DPE.cu:2403-2416): the 10th smallest
        # residual.
        want_shrink = improved & (thr > limit)
        r9 = torch.topk(resid, NEIGHBOUR_NUM + 1, dim=-1,
                        largest=False).values[..., NEIGHBOUR_NUM]
        shrink = want_shrink & (thr >= r9)
        new_thr = torch.where(shrink, (r9 - 1e-6).clamp(min=limit), thr)
        new_count = (resid < new_thr[..., None]).sum(-1)
        best_count = torch.where(improved, torch.where(shrink, new_count,
                                                       count), best_count)
        thr = new_thr

    # Final anchor ranking by residual vs the best plane (DPE.cu:2437-2462):
    # the 8 smallest, ties in pool order (a stable sort, as XLA's top_k).
    fit_all = _fit_depth_at(best_plane[..., None, :3], best_plane[..., None, 3],
                            fx_, fy_)
    resid = torch.abs(fit_all - pool_z)
    w = torch.where(pool_valid & (resid < ransac_threshold), resid,
                    torch.full_like(resid, BIG))
    w_sorted, order = torch.sort(w, dim=-1, stable=True)
    top_idx = order[..., :8]
    sel_valid = w_sorted[..., :8] < BIG
    neg = torch.full((), -1, dtype=pool_x.dtype, device=dev)
    nb_x = torch.where(sel_valid, sampling.take_last(pool_x, top_idx), neg)
    nb_y = torch.where(sel_valid, sampling.take_last(pool_y, top_idx), neg)

    reliable = has_valid & (pool_size > 3)
    keep = ((state.weak[r0:r1] == WEAK) & reliable)[..., None]
    nb_x = torch.where(keep, nb_x, neg)
    nb_y = torch.where(keep, nb_y, neg)
    return torch.stack([nb_x.permute(2, 0, 1), nb_y.permute(2, 0, 1)],
                       dim=-1).to(torch.int32), reliable    # (8, h, W, 2)
