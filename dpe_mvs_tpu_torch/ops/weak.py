"""Weak-texture machinery: deformable NCC, per-iteration plane fit, weak
propagation (reference C8: DPE.cu:557-690, 1668-1862, 2891-3124).

Port of :mod:`dpe_mvs_tpu.ops.weak`. :func:`fit_plane_ransac` serves both
engines; :func:`deformable_cost_vector` and :func:`propagate_weak` are the
exact engine's (the rect engine's weak propagation is
:mod:`..engine.weak_rect`). Propagation evaluates one checkerboard color at
a time on its compacted (H, ceil(W/2)) half grid (see :mod:`.checker`); the
sweep scatters the results back and masks them to the weak population.
``sup.neighbours`` holds the 8 deformable strong anchors per pixel from
:mod:`.anchors`. Candidate planes are evaluated in groups, every source view
in one pass, as in :mod:`..engine.patchmatch`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import COST_MAX, GEOM_COST_MAX, PatchMatchParams, \
    PixelState, RunState
from ..geometry import cameras as geo
from . import anchors as anchor_ops
from . import checker, ncc, sampling, support

WEAK = int(PixelState.WEAK)
STRONG = int(PixelState.STRONG)
BIG = float(1e30)


def weak_offsets(params: PatchMatchParams) -> np.ndarray:
    return ncc.window_offsets(params.weak_radius, params.weak_increment)


def fit_plane_ransac(key, data, sup, state, params: PatchMatchParams
                     ) -> dict:
    """Per-weak-pixel plane fit over the 8 anchors + adaptive NCC radius.
    Returns dict(fit_plane, radius) for ``Support._replace``.
    ``state.plane`` is in (n_cam, dist) layout (mid-sweep)."""
    H, W = data.ref_image.shape
    dev = data.device
    px, py = geo.pixel_grid(H, W, dev)
    k_lim, k_iter = key.split(2)
    cam = data.ref_cam

    anchors = sup.neighbours                      # (8, H, W, 2)
    ax = anchors[..., 0].permute(1, 2, 0)         # (H, W, 8)
    ay = anchors[..., 1].permute(1, 2, 0)
    valid = ax >= 0
    strong_count = valid.sum(-1)
    # Invalid anchors gather from the pixel's own position (validity masks
    # every consumer below).
    ax = torch.where(valid, ax, px.to(torch.int32)[..., None])
    ay = torch.where(valid, ay, py.to(torch.int32)[..., None])
    axf = ax.to(torch.float32)
    ayf = ay.to(torch.float32)

    # Anchor cam-frame 3D data from their current planes (DPE.cu:2928-2945).
    a_plane = sampling.gather_map(state.plane, ay, ax)        # (H, W, 8, 4)
    a_depth = geo.depth_from_plane(cam, a_plane, axf, ayf)
    fx_ = (axf - cam.cx) / cam.fx
    fy_ = (ayf - cam.cy) / cam.fy
    a_n = a_plane[..., :3]

    # Per-pixel edge limit; after GenNeighbours bumped complexity to >= 0.99
    # for limited pixels, the redraw here almost always disables the limit
    # (DPE.cu:2912-2920 + 2162).
    if params.use_limit and params.use_edge:
        u = k_lim.uniform((H, W)).to(dev)
        edge_limit = u >= sup.complexity
    else:
        edge_limit = torch.full((H, W), bool(params.use_limit), device=dev)

    must_tri = ~((data.label > 0) & edge_limit) if params.use_label \
        else torch.ones((H, W), dtype=torch.bool, device=dev)
    pick = sampling.pick_last
    slots = torch.arange(8, device=dev)

    best_plane = torch.zeros((H, W, 4), device=dev)
    min_cost = torch.full((H, W), BIG, device=dev)
    has_best = torch.zeros((H, W), dtype=torch.bool, device=dev)
    has_strong = torch.zeros((H, W), dtype=torch.bool, device=dev)
    tri = torch.zeros((H, W, 6), device=dev)
    cnt = strong_count.clamp(min=1)

    for k in k_iter.split(50):
        ka, kb, kc = k.split(3)
        # The reference indexes modulo the valid count; anchors are packed
        # first by construction.
        ia = ka.randint((H, W), 0, 8).to(dev).long() % cnt
        ib = kb.randint((H, W), 0, 8).to(dev).long() % cnt
        ic = kc.randint((H, W), 0, 8).to(dev).long() % cnt
        ok = (ia != ib) & (ib != ic) & (ia != ic) & (strong_count >= 3)

        pax, pay = pick(axf, ia), pick(ayf, ia)
        pbx, pby = pick(axf, ib), pick(ayf, ib)
        pcx, pcy = pick(axf, ic), pick(ayf, ic)

        if params.geom_consistency:
            def pick3(idx):
                return torch.stack([pick(a_n[..., j], idx)
                                    for j in range(3)], -1)
            consist = anchor_ops.normals_agree(
                pick3(ia), pick3(ib), pick3(ic)) & edge_limit
            ok = ok & ~(has_strong & ~consist)
        else:
            consist = torch.zeros((H, W), dtype=torch.bool, device=dev)

        # In-triangle constraint (DPE.cu:2982-2984).
        in_tri = anchor_ops.tri_contains(pax, pay, pbx, pby, pcx, pcy, px, py)
        ok = ok & (in_tri | ~must_tri)

        if sup.los is not None:
            cr = sup.los.crossing(pax, pay, pbx, pby, data.edge) | \
                sup.los.crossing(pbx, pby, pcx, pcy, data.edge) | \
                sup.los.crossing(pcx, pcy, pax, pay, data.edge)
            ok = ok & ~(edge_limit & cr)

        za, zb, zc = pick(a_depth, ia), pick(a_depth, ib), pick(a_depth, ic)
        A = torch.stack([pick(fx_, ia) * za, pick(fy_, ia) * za, za], -1)
        B = torch.stack([pick(fx_, ib) * zb, pick(fy_, ib) * zb, zb], -1)
        C = torch.stack([pick(fx_, ic) * zc, pick(fy_, ic) * zc, zc], -1)
        cr3 = torch.linalg.cross(A - C, B - C)
        nrm2 = (cr3 * cr3).sum(-1)
        ok = ok & (nrm2 > 0) & torch.isfinite(nrm2)
        nrm = cr3 / torch.sqrt(nrm2.clamp(min=1e-30))[..., None]
        dpl = -(nrm * A).sum(-1)

        fit_all = -dpl[..., None] / (nrm[..., None, 0] * fx_
                                     + nrm[..., None, 1] * fy_
                                     + nrm[..., None, 2])
        resid = torch.abs(fit_all - a_depth)
        not_in_triple = (slots != ia[..., None]) & (slots != ib[..., None]) \
            & (slots != ic[..., None])
        cost = torch.where(valid & not_in_triple, resid,
                           torch.zeros_like(resid)).sum(-1)

        take = ok & (cost < min_cost)
        plane4 = torch.cat([nrm, dpl[..., None]], -1)
        best_plane = torch.where(take[..., None], plane4, best_plane)
        min_cost = torch.where(take, cost, min_cost)
        has_best = has_best | take
        has_strong = has_strong | (ok & consist)
        must_tri = must_tri | (take & in_tri)
        tri = torch.where(take[..., None],
                          torch.stack([pax, pay, pbx, pby, pcx, pcy], -1), tri)

    # Orient toward the viewer (DPE.cu:3048-3057).
    view = geo.view_direction(cam, px, py)
    flip = (best_plane[..., :3] * view).sum(-1) > 0
    best_plane = torch.where(flip[..., None], -best_plane, best_plane)

    is_weak = state.weak == WEAK
    fit_plane = torch.where(
        (is_weak & has_best)[..., None], best_plane,
        torch.where(is_weak[..., None], torch.zeros_like(best_plane),
                    state.plane))

    radius = torch.full((H, W), float(params.strong_radius), device=dev)
    if params.use_radius:
        pax, pay, pbx, pby, pcx, pcy = [tri[..., i] for i in range(6)]
        a = torch.sqrt((pax - pbx) ** 2 + (pay - pby) ** 2)
        b = torch.sqrt((pbx - pcx) ** 2 + (pby - pcy) ** 2)
        c = torch.sqrt((pcx - pax) ** 2 + (pcy - pay) ** 2)
        s = (a + b + c) / 2.0
        area = torch.sqrt((s * (s - a) * (s - b) * (s - c)).clamp(min=0.0))
        r = torch.floor(torch.sqrt(area) / 2.0)
        d_a = torch.sqrt((pax - px) ** 2 + (pay - py) ** 2)
        d_b = torch.sqrt((pbx - px) ** 2 + (pby - py) ** 2)
        d_c = torch.sqrt((pcx - px) ** 2 + (pcy - py) ** 2)
        min_d = torch.minimum(torch.minimum(d_a, d_b), d_c)
        r = torch.where(2.5 * min_d < r, torch.floor(min_d), r)
        lens = np.linalg.norm(support.DIR8, axis=1)
        if sup.edge_steps is not None and params.use_edge:
            e_d = torch.stack([sup.edge_steps[d] * float(lens[d])
                               for d in range(8)]).min(0).values
            r = torch.where(edge_limit & (e_d < r), torch.floor(e_d), r)
        if sup.label_runs is not None and params.use_label:
            runs = torch.stack(
                [torch.where(sup.label_runs[d] > 0,
                             sup.label_runs[d] * float(lens[d]),
                             torch.full_like(sup.label_runs[d], BIG))
                 for d in range(8)])
            b_d = runs.min(0).values
            r = torch.where(edge_limit & (data.label > 0) & (b_d < r),
                            torch.floor(b_d), r)
        # Round down to a multiple of 5 (DPE.cu:3104).
        r = 5.0 * torch.floor(r / 5.0)
        sr = float(params.strong_radius)
        r_lim = torch.where(edge_limit, r.clamp(min=sr),
                            torch.where(r > params.strong_radius,
                                        torch.zeros_like(r),
                                        torch.full_like(r, sr)))
        radius = torch.where(is_weak & has_best & must_tri, r_lim, radius)

    return {"fit_plane": fit_plane, "radius": radius}


class DeformableSites:
    """Site-local inputs of the deformable NCC for one checkerboard color:
    window centres, the ref image value there (the bilateral color anchor,
    DPE.cu:585), the 8 deformable anchors and their selected-view masks, the
    adaptive radius scale, and the two ref-side window caches."""

    def __init__(self, data, sup, state, params: PatchMatchParams,
                 color: int):
        from ..engine import patchmatch as pm
        H, W = data.ref_image.shape
        self.cx, self.cy = checker.sites(H, W, color, device=data.device)
        self.ref_center = checker.compact(data.ref_image, color)
        anchors = checker.compact_stack(sup.neighbours, color)  # (8,H,W2,2)
        self.anchor_valid = anchors[..., 0] >= 0               # (8, H, W2)
        self.anchor_x = anchors[..., 0].to(torch.float32)
        self.anchor_y = anchors[..., 1].to(torch.float32)
        self.anchor_sel = sampling.gather_map(
            state.selected, anchors[..., 1], anchors[..., 0])  # (8, H, W2)
        self.scale = None
        if params.use_radius and sup.radius is not None:
            self.scale = checker.compact(sup.radius, color) / \
                float(params.strong_radius)
        corners = pm.corner_maps(data)[0]
        self.cache_center = ncc.make_ref_cache(
            data.ref_image, self.cx, self.cy,
            ncc.window_offsets(params.strong_radius, params.strong_increment),
            5.0, 3.0, self.ref_center, scale=self.scale, corners=corners)
        self.cache_anchor = ncc.make_ref_cache(
            data.ref_image, self.anchor_x, self.anchor_y,
            weak_offsets(params), 5.0, 3.0, self.ref_center, corners=corners)


def deformable_cost_vector(data, sites: DeformableSites, plane: torch.Tensor,
                           params: PatchMatchParams) -> torch.Tensor:
    """(*C, V, H, W2) deformable NCC (``ComputeBilateralNCCNew``,
    DPE.cu:557-690) of candidate plane fields (*C, H, W2, 4) at the
    compacted sites: 0.25 * centre window (adaptive radius) + 0.75 * mean
    over up-to-8 strong anchor windows, all warped by the *candidate's*
    plane homography."""
    from ..engine import patchmatch as pm
    H, W = data.ref_image.shape
    px, py = sites.cx, sites.cy
    offs_strong = ncc.window_offsets(params.strong_radius,
                                     params.strong_increment)
    offs_weak = weak_offsets(params)
    V = data.num_src
    ref_c, src_c = pm.corner_maps(data)
    cams, R2, t2, _ = pm.view_fields(data, 2)
    _, R3, t3, _ = pm.view_fields(data, 3)
    K3 = cams.K[..., None, :, :]
    valid = data.view_valid[:, None, None]
    # Each view's bit of every anchor's selection (8, H, W2) -> (V, 8, ...).
    sel_here = pm.selected_bits(sites.anchor_sel.reshape(8, -1), V).reshape(
        V, *sites.anchor_sel.shape)
    C = plane.shape[:-3]
    flat = plane.reshape(-1, *plane.shape[-3:])
    per = V * max(
        ncc._chunking(offs_strong.shape[0], px.shape)[0] * px.numel(),
        ncc._chunking(offs_weak.shape[0], sites.anchor_x.shape)[0]
        * sites.anchor_x.numel())
    outs = []
    for a, b in pm.groups(flat.shape[0], per):
        pl = flat[a:b, None]                                   # (g,1,H,W2,4)
        # Centre window (k == 0) with the adaptive radius; a centre warped
        # out of the source image gives COST_MAX (DPE.cu:577-580).
        hom_c = ncc.homography_field(data.ref_cam, cams.K, R2, t2, pl, px, py)
        c0 = ncc.bilateral_ncc(
            data.ref_image, data.src_images, hom_c, px, py, offs_strong, 5.0,
            3.0, sites.ref_center, scale=sites.scale,
            ref_cache=sites.cache_center, ref_corners=ref_c,
            src_corners=src_c)                                 # (g,V,H,W2)
        # All 8 anchor windows at once: the centres carry a leading (8,).
        hom_k = ncc.homography_field(data.ref_cam, K3, R3, t3, pl[:, :, None],
                                     sites.anchor_x, sites.anchor_y)
        ck = ncc.bilateral_ncc(
            data.ref_image, data.src_images, hom_k, sites.anchor_x,
            sites.anchor_y, offs_weak, 5.0, 3.0, sites.ref_center,
            ref_cache=sites.cache_anchor, ref_corners=ref_c,
            src_corners=src_c)                                 # (g,V,8,H,W2)
        zero = torch.zeros((), device=data.device)
        wx, wy = hom_k.at_offset(zero, zero)
        oob = (wx < 0) | (wy < 0) | (wx >= W) | (wy >= H)
        # In-bounds anchor -> its window cost; an OOB anchor counts COST_MAX
        # only if it had selected this view (DPE.cu:595-607).
        contrib = torch.where(oob, torch.where(sel_here, COST_MAX, 0.0), ck)
        counts = torch.where(oob, torch.where(sel_here, 1.0, 0.0), 1.0)
        strong_sum = torch.where(sites.anchor_valid, contrib, 0.0).sum(-3)
        strong_cnt = torch.where(sites.anchor_valid, counts, 0.0).sum(-3)
        strong_cost = (strong_sum / strong_cnt.clamp(min=1.0)).clamp(
            max=COST_MAX)
        cost = torch.where(strong_cnt > 0, 0.25 * c0 + 0.75 * strong_cost,
                           c0)
        outs.append(torch.where(valid, cost, COST_MAX))
    return torch.cat(outs).reshape(*C, V, *px.shape)


def propagate_weak(key, data, sup, state, params: PatchMatchParams, it: int,
                   color: int):
    """Weak-pixel checkerboard propagation (``CheckerboardPropagationWeak``,
    DPE.cu:1668-1862) for one color, evaluated on its compacted (H, W2)
    half grid: the 8 anchors' planes as candidates, the fitted plane and the
    5 refinements, REFINE_INIT hysteresis, and the stored cost re-expressed
    with the standard strong NCC. Returns compacted (plane, cost, selected,
    view_weight); the caller scatters and masks."""
    from ..engine import patchmatch as pm
    nview = data.num_src
    k_sel, k_ref = key.split(2)
    geom = params.geom_consistency

    sites = DeformableSites(data, sup, state, params, color)
    px, py = sites.cx, sites.cy                              # (H, W2)
    plane_now = checker.compact(state.plane, color)
    selected_now = checker.compact(state.selected, color)

    a_x = sampling.to_int32(sites.anchor_x)                  # (8, H, W2)
    a_y = sampling.to_int32(sites.anchor_y)
    a_valid = sites.anchor_valid
    a_weak = sampling.gather_map(state.weak, a_y, a_x)
    flags = a_valid & (a_weak == STRONG)                     # (8, H, W2)
    cand_planes = sampling.gather_map(state.plane, a_y, a_x)  # (8,H,W2,4)
    cost_array = deformable_cost_vector(data, sites, cand_planes, params)
    cost_array = torch.where(flags[:, None], cost_array, 0.0)

    # Priors from all non-(-1) anchors (DPE.cu:1717-1730).
    bits = pm.selected_bits(sites.anchor_sel.reshape(8, -1), nview).reshape(
        nview, *sites.anchor_sel.shape).transpose(0, 1)      # (8, V, H, W2)
    prior = torch.where(a_valid[:, None], torch.where(bits, 0.9, 0.1),
                        0.0).sum(0)

    view_weight, temp_selected, weight_norm = pm.view_selection(
        k_sel, cost_array, prior, data.view_valid, it)
    wsum = weight_norm.clamp(min=1e-30)

    if geom:
        geom_rows = pm.geom_cost_vector(data, cand_planes, px, py)
        geom_rows = torch.where(flags[:, None], geom_rows, GEOM_COST_MAX)
        cost_array = cost_array + params.geom_factor * geom_rows

    final_costs = (view_weight[None] * cost_array).sum(1) / wsum[None]
    min_cost, min_idx = torch.min(final_costs, dim=0)
    min_flag = torch.gather(flags, 0, min_idx[None])[0]
    min_plane = torch.gather(
        cand_planes, 0, min_idx[None, ..., None].expand(1, *plane_now.shape)
    )[0]

    def weighted(cand):
        """Weighted deformable (+ geom) cost of plane fields (*C, H, W2,
        4)."""
        c = deformable_cost_vector(data, sites, cand, params)
        if geom:
            c = c + params.geom_factor * pm.geom_cost_vector(data, cand, px,
                                                             py)
        return (view_weight * c).sum(-3) / wsum

    cost_now = torch.where(weight_norm > 0, weighted(plane_now), COST_MAX)
    stored_cost = cost_now

    depth_now = geo.depth_from_plane(data.ref_cam, plane_now, px, py)
    depth_before = geo.depth_from_plane(data.ref_cam, min_plane, px, py)
    accept = min_flag & (depth_before >= data.depth_min) & \
        (depth_before <= data.depth_max) & (min_cost < cost_now)

    plane = torch.where(accept[..., None], min_plane, plane_now)
    depth = torch.where(accept, depth_before, depth_now)
    cost = torch.where(accept, min_cost, cost_now)
    selected = torch.where(accept, temp_selected, selected_now)

    # Refinement (PlaneHypothesisRefinementWeak, DPE.cu:1120-1212): the
    # fitted plane, then the 5 combos, each taken where it lowers the cost.
    fit = checker.compact(sup.fit_plane, color)
    fit_nonzero = (fit[..., :3] != 0.0).any(-1)
    c_fit = weighted(fit)
    d_fit = geo.depth_from_plane(data.ref_cam, fit, px, py)
    ok = fit_nonzero & (d_fit >= data.depth_min) & \
        (d_fit <= data.depth_max) & (c_fit < cost) & (weight_norm > 0)
    plane = torch.where(ok[..., None], fit, plane)
    depth = torch.where(ok, d_fit, depth)
    cost = torch.where(ok, c_fit, cost)

    depths_c, normals_c = pm.refine_combos(k_ref, data, plane, depth, px, py)
    cands = geo.plane_from_depth_normal(data.ref_cam, px, py, depths_c,
                                        normals_c)           # (5, H, W2, 4)
    cs = weighted(cands)
    d_chk = geo.depth_from_plane(data.ref_cam, cands, px, py)
    for i in range(cands.shape[0]):
        ok = (d_chk[i] >= data.depth_min) & (d_chk[i] <= data.depth_max) & \
            (cs[i] < cost) & (weight_norm > 0)
        plane = torch.where(ok[..., None], cands[i], plane)
        depth = torch.where(ok, d_chk[i], depth)
        cost = torch.where(ok, cs[i], cost)

    if params.state == RunState.REFINE_INIT:
        accept_final = cost < stored_cost - 0.1
        plane = torch.where(accept_final[..., None], plane, plane_now)

    # Re-express the stored cost with the standard strong NCC so weak and
    # strong costs are comparable during propagation (DPE.cu:1845-1861).
    final_vec = pm.ncc_cost_vector(
        data, plane, pm.strong_offsets(params), cx=px, cy=py,
        ref_center=sites.ref_center,
        ref_cache=pm.strong_ref_cache(data, params, px, py, sites.ref_center))
    final_cost = (view_weight * final_vec).sum(0) / wsum
    final_cost = torch.where(weight_norm > 0, final_cost, COST_MAX)
    return plane, final_cost, selected, view_weight
