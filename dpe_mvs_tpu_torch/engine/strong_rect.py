"""Strong-pixel PatchMatch propagation on the rectified cost engine.

Port of :mod:`dpe_mvs_tpu.engine.strong_rect`. Every NCC evaluation goes
through :mod:`.rectcost` as a full-resolution cost field (with the
geometric term in geom passes); one color's update evaluates all pixels and
the caller masks to the color's checkerboard sites. Candidate planes are
carried through the probe argmin as shifted plane fields: static shifts in
the classic ACMM mode (DPE.cu:1345-1545), and in the edge-bounded mode
(``use_edge``, DPE.cu:1242-1343) one roll per entry of the offset table
that the iteration's step magnitude selects.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import COST_MAX, PatchMatchParams, PixelState, RunState
from ..geometry import cameras as geo
from ..ops import sampling, support
from ..utils.profiling import BRANCHES
from . import patchmatch as pm
from . import rectcost, sweep
from .state import PMState, SweepData

WEAK = int(PixelState.WEAK)
BIG = float(1e30)


def _select_k(stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stack (K, H, W, ...) picked at idx (H, W)."""
    idx = idx.to(torch.int64)
    if stack.dim() > 3:
        g = idx[None, ..., None].expand(1, *stack.shape[1:])
    else:
        g = idx[None]
    return torch.gather(stack, 0, g)[0]


def classic_candidate_planes(cost_map: torch.Tensor, plane: torch.Tensor):
    """Classic ACMM near/far candidate selection with the winning plane
    carried through the argmin as static shifts.

    Returns (flags (8, H, W) bool, cand_planes (8, H, W, 4))."""
    H, W = cost_map.shape
    xg, yg = pm.int_grids(H, W, cost_map.device)
    plane_c = plane.permute(2, 0, 1)                        # (4, H, W)
    big = torch.full((), BIG, device=cost_map.device)
    flags, cands = [], []
    for probes in pm._CLASSIC_PROBES:
        best_c = torch.full((H, W), BIG, device=cost_map.device)
        best_p = plane_c
        base_guard = probes[0][2](xg, yg, W, H)
        for dx, dy, guard in probes:
            ok = base_guard & guard(xg, yg, W, H)
            c = torch.where(ok, sampling.shift(cost_map, dy, dx), big)
            better = c < best_c
            best_c = torch.where(better, c, best_c)
            best_p = torch.where(better[None], sampling.shift(plane_c, dy, dx),
                                 best_p)
        flags.append(base_guard)
        cands.append(best_p.permute(1, 2, 0))
    return torch.stack(flags), torch.stack(cands)


# Static step lengths the edge mode quantizes to (the reference computes
# step_len = dist/step_num with min 2; the realized values at working
# resolutions are small integers).
_EDGE_STEP_SET = (2, 4, 6)


def _scan_offsets(stack5: torch.Tensor, plane: torch.Tensor, table, xg, yg):
    """Carry the min-cost entry of ``stack5`` (5, H, W) = [cost, plane x4]
    over the offset table ``[(dx, dy, extra_ok), ...]`` (``extra_ok`` an
    (H, W) bool mask or None), as the JAX package's scan over rolled
    stacks. Returns (best cost, best plane (H, W, 4))."""
    H, W = stack5.shape[1:]
    best_c = torch.full((H, W), BIG, device=stack5.device)
    best_p = plane
    big = torch.full((), BIG, device=stack5.device)
    for pdx, pdy, extra in table:
        rolled = torch.roll(stack5, (-pdy, -pdx), dims=(1, 2))
        ok = (xg + pdx >= 0) & (xg + pdx < W) & (yg + pdy >= 0) & \
            (yg + pdy < H)
        if extra is not None:
            ok = ok & extra
        c = torch.where(ok, rolled[0], big)
        better = c < best_c
        best_c = torch.where(better, c, best_c)
        best_p = torch.where(better[..., None], rolled[1:].permute(1, 2, 0),
                             best_p)
    return best_c, best_p


def edge_candidate_planes(cost_map: torch.Tensor, plane: torch.Tensor,
                          edge: torch.Tensor, edge_steps: torch.Tensor, it):
    """Edge-bounded directional sampling (DPE.cu:1242-1292) with the
    per-pixel step length quantized to ``_EDGE_STEP_SET``. The JAX package
    scans a table of (bucket, step magnitude, step) offsets; only the rows
    of this iteration's step magnitude can win, so only they are visited.
    Carries winning planes like the classic mode.

    Returns (flags (8, H, W) bool, cand_planes (8, H, W, 4))."""
    H, W = cost_map.shape
    max_edge_dist = max(H, W) / 30.0
    min_step = 2
    s_mag = pm._s_mag(it)
    xg, yg = pm.int_grids(H, W, cost_map.device)
    stack5 = torch.cat([cost_map[None], plane.permute(2, 0, 1)])

    flags, cands = [], []
    for d in range(8):
        dx_u, dy_u = pm._EDGE_DIRS[d]
        steps_t = edge_steps[d]
        invalid = steps_t >= support.INF
        cap = max_edge_dist / (np.sqrt(2.0) if d >= 4 else 1.0)
        dist = torch.where(invalid | (steps_t > max_edge_dist),
                           torch.full_like(steps_t, cap), steps_t)
        dist = torch.where(edge, torch.full_like(dist, 11.0 * min_step), dist)
        step_num = (dist / min_step).to(torch.int32).clamp(11, 22)
        step_len_f = dist / step_num.to(torch.float32)
        fx, fy = pm._diag_fix(d, dx_u, dy_u)
        slq = torch.round(step_len_f).clamp(min_step, _EDGE_STEP_SET[-1]) \
            .to(torch.int32)
        table = []
        for sl in _EDGE_STEP_SET:
            in_bucket = (slq >= sl - 1) & (slq <= sl)
            for t in range(22):
                table.append((s_mag * dx_u + t * sl * dx_u + fx,
                              s_mag * dy_u + t * sl * dy_u + fy,
                              in_bucket & (t < step_num)))
        best_c, best_p = _scan_offsets(stack5, plane, table, xg, yg)
        flags.append(best_c < BIG)
        cands.append(best_p)
    return torch.stack(flags), torch.stack(cands)


def second_pass_candidate_planes(cost_map: torch.Tensor, plane: torch.Tensor,
                                 it):
    """Short-range non-local pass (DPE.cu:1293-1343): 11 probes at step 2
    per direction, at this iteration's step magnitude."""
    H, W = cost_map.shape
    s_mag = pm._s_mag(it)
    xg, yg = pm.int_grids(H, W, cost_map.device)
    stack5 = torch.cat([cost_map[None], plane.permute(2, 0, 1)])

    flags, cands = [], []
    for d in range(8):
        dx_u, dy_u = pm._EDGE_DIRS[d]
        fx, fy = pm._diag_fix(d, dx_u, dy_u)
        table = [(s_mag * dx_u + t * 2 * dx_u + fx,
                  s_mag * dy_u + t * 2 * dy_u + fy, None) for t in range(11)]
        best_c, best_p = _scan_offsets(stack5, plane, table, xg, yg)
        flags.append(best_c < BIG)
        cands.append(best_p)
    return torch.stack(flags), torch.stack(cands)


def screen_stride(params: PatchMatchParams, rstat) -> int:
    """Stride of the candidate-SCREENING cost evaluations (strong
    propagation): candidates are scored on the rect frame's stride-subgrid
    and the winner re-scored exactly. Auto: 2 once the rect frame reaches
    384x512; ``params.propagate_stride`` overrides."""
    if params.propagate_stride is not None and rstat is not None:
        return params.propagate_stride
    return 2 if (rstat is not None
                 and rstat.hp * rstat.wp >= 384 * 512) else 1


def make_cost_fn(data: SweepData, params: PatchMatchParams, rstat,
                 stride: int = 1, stack=None):
    """plane field (H, W, 4) -> (V, H, W) costs through the rectified engine.
    Builds the view-stacked operands once (or takes ``stack``, to share them
    between evaluators), and for strided screening the candidate-independent
    EvalCache, so every evaluation only pays the source-side gathers and
    accumulation. Costs include the geometric term in geom passes."""
    offs = pm.strong_offsets(params)
    geom = params.geom_consistency
    if stack is None:
        stack = rectcost.build_rect_stack(data.rect, rstat)
    cache = (rectcost.build_eval_cache(stack, params, offs, stride=stride,
                                       geom=geom)
             if stride > 1 else None)

    def cost_fn(plane):
        return rectcost.rect_cost_vector_stacked(
            stack, plane, data.view_valid, params, offs, geom=geom,
            stride=stride, cache=cache)

    return cost_fn


def initialize_rect(data: SweepData, state: PMState,
                    params: PatchMatchParams, rstat) -> PMState:
    """``RandomInitialization`` (DPE.cu:1035-1063) on the rect engine
    (:func:`.patchmatch.init_from_costs` over its cost function)."""
    return pm.init_from_costs(data, state, params,
                              make_cost_fn(data, params, rstat))


def refine_strong_rect(key, data: SweepData, params: PatchMatchParams,
                       cost_fn, plane, depth, cost, view_weight,
                       weight_norm, cost_fn_s=None):
    """``PlaneHypothesisRefinementStrong`` (DPE.cu:1065-1118), full-res.

    With ``cost_fn_s`` (strided screening), the 5 perturbation combos are
    scored on the stride-subgrid and only the per-pixel winner is re-scored
    exactly for the acceptance test."""
    px, py = geo.pixel_grid(*data.ref_image.shape, data.device)
    depths, normals = pm.refine_combos(key, data, plane, depth, px, py)
    wsum = weight_norm.clamp(min=1e-30)
    vw = view_weight.to(torch.float32)

    if cost_fn_s is not None:
        s_c = torch.full(cost.shape, BIG, device=data.device)
        s_d, s_n = depth, plane[..., :3]
        for d_i, n_i in zip(depths, normals):
            cand = geo.plane_from_depth_normal(data.ref_cam, px, py, d_i, n_i)
            c = torch.sum(vw * cost_fn_s(cand), dim=0) / wsum
            d_chk = geo.depth_from_plane(data.ref_cam, cand, px, py)
            ok = (d_chk >= data.depth_min) & (d_chk <= data.depth_max) & \
                (c < s_c)
            s_c = torch.where(ok, c, s_c)
            s_d = torch.where(ok, d_i, s_d)
            s_n = torch.where(ok[..., None], n_i, s_n)
        cand = geo.plane_from_depth_normal(data.ref_cam, px, py, s_d, s_n)
        c = torch.sum(vw * cost_fn(cand), dim=0) / wsum
        d_chk = geo.depth_from_plane(data.ref_cam, cand, px, py)
        ok = (s_c < BIG) & (d_chk >= data.depth_min) & \
            (d_chk <= data.depth_max) & (c < cost) & (weight_norm > 0)
        plane = torch.where(ok[..., None], cand, plane)
        depth = torch.where(ok, d_chk, depth)
        cost = torch.where(ok, c, cost)
        return plane, depth, cost

    for d_i, n_i in zip(depths, normals):
        cand = geo.plane_from_depth_normal(data.ref_cam, px, py, d_i, n_i)
        c = torch.sum(vw * cost_fn(cand), dim=0) / wsum
        d_chk = geo.depth_from_plane(data.ref_cam, cand, px, py)
        ok = (d_chk >= data.depth_min) & (d_chk <= data.depth_max) & \
            (c < cost) & (weight_norm > 0)
        plane = torch.where(ok[..., None], cand, plane)
        depth = torch.where(ok, d_chk, depth)
        cost = torch.where(ok, c, cost)
    return plane, depth, cost


def propagate_strong_rect(key, data: SweepData, sup, state: PMState,
                          params: PatchMatchParams, it, color, rstat,
                          cost_now_vec=None, cost_fn=None, cost_fn_s=None):
    """One color's strong-pixel proposal, full resolution. Returns
    (plane, cost, selected, view_weight (V,H,W)) full-res fields; the caller
    masks to the color's sites and non-weak pixels. ``cost_now_vec`` shares
    the current-plane evaluation across both colors; ``cost_fn`` /
    ``cost_fn_s`` share the exact and screening evaluators (and their
    caches) across both colors. ``sup`` carries the edge steps of the
    edge-bounded mode."""
    H, W = data.ref_image.shape
    nview = data.num_src
    dev = data.device
    k_sel, k_ref = key.split(2)
    if cost_fn is None:
        cost_fn = make_cost_fn(data, params, rstat)
    stride = screen_stride(params, rstat)
    if cost_fn_s is None:
        cost_fn_s = (make_cost_fn(data, params, rstat, stride=stride)
                     if stride > 1 else cost_fn)

    plane_now = state.plane
    selected_now = state.selected
    if params.use_edge:
        flags, cand_planes = edge_candidate_planes(
            state.cost, state.plane, data.edge, sup.edge_steps, it)
    else:
        flags, cand_planes = classic_candidate_planes(state.cost, state.plane)

    # Above pm.FULLRES_PX the screening volumes are stored bf16 (they only
    # feed the candidate argmin and view-selection counts; the winner is
    # re-scored exactly below).
    cdt = torch.float32
    if H * W > pm.FULLRES_PX:
        cdt = torch.bfloat16
        BRANCHES["bf16 screening"] += 1
    cost_array = torch.stack([cost_fn_s(p).to(cdt) for p in cand_planes])
    cost_array = torch.where(flags[:, None], cost_array,
                             torch.zeros((), dtype=cdt, device=dev))

    if params.use_edge:
        # The short-range second pass replaces a direction's candidate away
        # from edges when it scores more good / fewer bad views.
        good_thr = pm._threshold(it).to(dev)
        f2, p2 = second_pass_candidate_planes(state.cost, state.plane, it)
        c2 = torch.stack([cost_fn_s(p).to(cdt) for p in p2])
        # Counts over the views in uint8: a bool sum to int64 would first
        # copy the whole (8, V, H, W) mask as int64.
        u8 = torch.uint8
        good1 = (cost_array < good_thr).sum(1, dtype=u8)
        bad1 = (cost_array > 1.2).sum(1, dtype=u8)
        c2m = torch.where(f2[:, None], c2,
                          torch.full((), COST_MAX, dtype=cdt, device=dev))
        good2 = (c2m < good_thr).sum(1, dtype=u8)
        bad2 = (c2m > 1.2).sum(1, dtype=u8)
        del c2m
        off_edge = (~data.edge)[None]
        replace = f2 & off_edge & (
            (~flags) | (good2 > good1) | ((good2 == good1) & (bad2 < bad1)))
        del good1, bad1, good2, bad2
        cost_array = torch.where(replace[:, None], c2, cost_array)
        cand_planes = torch.where(replace[..., None], p2, cand_planes)
        flags = flags | (f2 & off_edge)
        # Free the second pass's (8, ...) fields before view selection: at
        # full-resolution frames they are gigabytes each.
        del f2, p2, c2, replace

    prior = pm.neighbour_prior(state.selected, flags, nview)
    view_weight, temp_selected, weight_norm = pm.view_selection(
        k_sel, cost_array, prior, data.view_valid, it)
    wsum = weight_norm.clamp(min=1e-30)
    vw = view_weight.to(torch.float32)

    final_costs = torch.sum(vw[None] * cost_array, dim=1) / wsum[None]
    min_idx = torch.argmin(final_costs, dim=0)
    min_flag = _select_k(flags, min_idx)
    min_cost = _select_k(final_costs, min_idx)
    min_plane = _select_k(cand_planes, min_idx)
    del cand_planes, cost_array, final_costs
    if stride > 1:
        # Re-score the winning candidate exactly.
        min_cost = torch.sum(vw * cost_fn(min_plane), dim=0) / wsum

    if cost_now_vec is None:
        cost_now_vec = cost_fn(plane_now)
    cost_now = torch.sum(vw * cost_now_vec, dim=0) / wsum
    cost_now = torch.where(weight_norm > 0, cost_now,
                           torch.full_like(cost_now, COST_MAX))
    stored_cost = cost_now

    px, py = geo.pixel_grid(H, W, dev)
    depth_now = geo.depth_from_plane(data.ref_cam, plane_now, px, py)
    depth_before = geo.depth_from_plane(data.ref_cam, min_plane, px, py)
    accept = min_flag & (depth_before >= data.depth_min) & \
        (depth_before <= data.depth_max) & (min_cost < cost_now)

    plane = torch.where(accept[..., None], min_plane, plane_now)
    depth = torch.where(accept, depth_before, depth_now)
    cost = torch.where(accept, min_cost, cost_now)
    selected = torch.where(accept, temp_selected, selected_now)

    plane, depth, cost = refine_strong_rect(
        k_ref, data, params, cost_fn, plane, depth, cost, view_weight,
        weight_norm, cost_fn_s=cost_fn_s if stride > 1 else None)

    if params.state == RunState.REFINE_INIT:
        accept_final = cost < stored_cost - 0.1
        plane = torch.where(accept_final[..., None], plane, plane_now)
        cost = torch.where(accept_final, cost, stored_cost)
    return plane, cost, selected, view_weight


def apply_strong_full(state: PMState, mask, color, plane, cost, selected,
                      view_weight) -> PMState:
    """Write one color's full-res proposal back into state (masked to the
    color's checkerboard sites and ``mask``)."""
    H, W = state.cost.shape
    m = sweep.checkerboard_mask(H, W, color, state.cost.device) & mask
    return state.replace(
        plane=torch.where(m[..., None], plane, state.plane),
        cost=torch.where(m, cost, state.cost),
        selected=torch.where(m, selected, state.selected),
        view_weight=torch.where(m[..., None], view_weight.permute(1, 2, 0),
                                state.view_weight),
    )
