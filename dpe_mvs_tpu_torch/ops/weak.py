"""Per-iteration plane fit of the weak-texture machinery
(``RANSACToGetFitPlane``, DPE.cu:2891-3124).

Port of :func:`dpe_mvs_tpu.ops.weak.fit_plane_ransac` and
:func:`weak_offsets`. The deformable NCC and the weak propagation of the
exact engine (``deformable_cost_vector``, ``propagate_weak``) arrive with
that engine; the rect engine's weak propagation is
:mod:`..engine.weak_rect`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import PatchMatchParams, PixelState
from ..geometry import cameras as geo
from . import anchors as anchor_ops
from . import ncc, sampling, support

WEAK = int(PixelState.WEAK)
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
