"""PatchMatch building blocks of both cost engines.

Port of :mod:`dpe_mvs_tpu.engine.patchmatch`: the per-sweep :class:`Support`
maps, the exact engine's cost vectors (bilateral NCC against every source
view, the geometric term), initialisation, the candidate searches (classic
ACMM probes, edge-bounded rays and their second pass), multi-hypothesis view
selection and its prior, strong propagation and refinement, depth extraction
and filtering, and the disparity sweeps of DepthToWeak and LocalRefine
(exact, or on the rect engine with ``rstat``).

The exact engine evaluates every source view of a cost vector in one pass
(the JAX package scans them), and a stack of candidate planes in groups of
at most :data:`BATCH_ELEMS` elements per temporary; each element is the JAX
package's own expression. Every 2-D gather goes through
``sampling.gather_map`` (the ``gather2d_hwc`` kernel on the card).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import COST_MAX, GEOM_COST_MAX, PatchMatchParams, \
    PixelState, RunState
from ..geometry import cameras as geo
from ..ops import checker, ncc, sampling, support
from ..ops import planes as planegen
from ..utils.profiling import BRANCHES
from .state import PMState, SweepData

WEAK = int(PixelState.WEAK)
STRONG = int(PixelState.STRONG)
UNKNOWN = int(PixelState.UNKNOWN)
BIG = float(1e30)
# Elements of one temporary of a batched cost evaluation (candidates x views
# x window samples x centres): candidate groups stay under it.
BATCH_ELEMS = 1 << 25
# Frames of more pixels are full-resolution frames: view selection draws its
# 15 Monte-Carlo samples one at a time and the strong iteration stores its
# screening volumes as bf16 (``strong_rect.propagate_strong_rect``). The JAX
# package's literal 4_000_000; module-level so that tests can force both.
FULLRES_PX = 4_000_000
# The disparity sweeps' memory bound at full-resolution frames: the rect
# sweep (DepthToWeak's 61 probes, LocalRefine's 11) evaluates its probes in
# chunks whose float32 volume, on the larger of the original grid and the
# rect subgrid, stays within SWEEP_CHUNK_BYTES, DepthToWeak's per-pixel
# analysis runs in row bands of as many bytes (``sampling.spans``), and the
# weak bundle warps its 16-probe volumes back in chunks of as many bytes.
# Exact: no probe or pixel depends on the chunks, and no draw is made. One
# chunk and one band up to 1600x1200; module-level so that tests can force
# many.
SWEEP_CHUNK_BYTES = 1e9


class Support(NamedTuple):
    """Per-sweep precomputed support maps (GenEdgeInform + friends)."""

    edge_steps: Optional[torch.Tensor]      # (8, H, W) f32 steps to edge
    complexity: Optional[torch.Tensor]      # (H, W) f32
    label_runs: Optional[torch.Tensor]      # (8, H, W) f32 same-label runs
    los: Optional[support.LineOfSight]
    nearest_strong: Optional[torch.Tensor]  # (H, W, 2) i32 (x, y) or -1
    neighbours: Optional[torch.Tensor]      # (8, H, W, 2) i32 anchors / -1
    radius: Optional[torch.Tensor]          # (H, W) f32 adaptive NCC radius
    fit_plane: Optional[torch.Tensor]       # (H, W, 4)


EMPTY_SUPPORT = Support(*([None] * len(Support._fields)))

# Reference direction vectors of edge-bounded sampling (DPE.cu:1243), the
# same table as ops.support.DIR8.
_EDGE_DIRS = [(0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (1, 1), (-1, 1),
              (1, -1)]


def strong_offsets(params: PatchMatchParams) -> np.ndarray:
    return ncc.window_offsets(params.strong_radius, params.strong_increment)


# ---------------------------------------------------------------------------
# Cost vectors of the exact engine
# ---------------------------------------------------------------------------

def with_corners(data: SweepData) -> SweepData:
    """``data`` with the bilinear corner maps of its images (built once per
    sweep; every NCC sample reads its four texels from them)."""
    if data.ref_corners is not None:
        return data
    return data.replace(ref_corners=sampling.corner_map(data.ref_image),
                        src_corners=sampling.corner_map(data.src_images))


def corner_maps(data: SweepData):
    """(ref, src) bilinear corner maps of ``data``: cached, or built."""
    data = with_corners(data)
    return data.ref_corners, data.src_corners


def groups(n: int, per_item: int):
    """[a, b) ranges over n items of ``per_item`` elements each, every range
    within :data:`BATCH_ELEMS` (at least one item)."""
    g = max(1, BATCH_ELEMS // max(per_item, 1))
    return [(a, min(a + g, n)) for a in range(0, n, g)]


def view_fields(data: SweepData, nb: int):
    """The view-stacked (V, ...) cameras and relative poses shaped to
    broadcast against (V, *B) with ``nb`` = len(B): (src_cams, R_rel, t_rel,
    view index)."""
    V = data.num_src

    def r(t):
        return t.reshape(V, *([1] * nb), *t.shape[1:])
    cams = geo.Camera(K=r(data.src_cams.K), R=r(data.src_cams.R),
                      t=r(data.src_cams.t))
    view = torch.arange(V, device=data.device).reshape(V, *([1] * nb))
    return cams, r(data.R_rel), r(data.t_rel), view


def ncc_cost_vector(data: SweepData, plane: torch.Tensor,
                    offsets: np.ndarray, *, cx=None, cy=None, scale=None,
                    ref_cache=None, ref_center=None) -> torch.Tensor:
    """(*C, V, *B) bilateral NCC of plane fields (*C, *B, 4) against every
    source view (``ComputeMultiViewCostVectorOld``, DPE.cu:870-879); *C are
    optional candidate dims. Invalid (padding) views get COST_MAX. Window
    centres default to the full pixel grid; pass ``cx``/``cy`` (+ matching
    ``ref_center`` image values) to evaluate at other sites (e.g. one
    checkerboard color's compacted half grid)."""
    H, W = data.ref_image.shape
    if cx is None:
        cx, cy = geo.pixel_grid(H, W, data.device)
    if ref_center is None:
        ref_center = data.ref_image
    nb = cx.dim()
    cams, R_rel, t_rel, _view = view_fields(data, nb)
    valid = data.view_valid.reshape(-1, *([1] * nb))
    ref_c, src_c = corner_maps(data)
    C = plane.shape[:plane.dim() - 1 - nb]
    flat = plane.reshape(-1, *cx.shape, 4)
    chunk = ncc._chunking(offsets.shape[0], cx.shape)[0]
    outs = []
    for a, b in groups(flat.shape[0], data.num_src * chunk * cx.numel()):
        hom = ncc.homography_field(data.ref_cam, cams.K, R_rel, t_rel,
                                   flat[a:b, None], cx, cy)
        c = ncc.bilateral_ncc(
            data.ref_image, data.src_images, hom, cx, cy, offsets, 5.0, 3.0,
            ref_center, scale=scale, ref_cache=ref_cache, ref_corners=ref_c,
            src_corners=src_c)
        outs.append(torch.where(valid, c, COST_MAX))
    return torch.cat(outs).reshape(*C, data.num_src, *cx.shape)


def strong_ref_cache(data: SweepData, params: PatchMatchParams,
                     cx=None, cy=None, ref_center=None):
    """Ref-side window cache for the standard strong NCC geometry, shared by
    every strong cost evaluation at the given window centres (defaults to
    the full pixel grid)."""
    H, W = data.ref_image.shape
    if cx is None:
        cx, cy = geo.pixel_grid(H, W, data.device)
    if ref_center is None:
        ref_center = data.ref_image
    return ncc.make_ref_cache(
        data.ref_image, cx, cy, strong_offsets(params), 5.0, 3.0, ref_center,
        corners=corner_maps(data)[0])


def geom_cost_vector(data: SweepData, plane: torch.Tensor, px=None,
                     py=None) -> torch.Tensor:
    """(*C, V, *B) forward-backward geometric cost of plane fields
    (*C, *B, 4) (DPE.cu:915-953); invalid views get GEOM_COST_MAX."""
    H, W = data.ref_image.shape
    if px is None:
        px, py = geo.pixel_grid(H, W, data.device)
    nb = px.dim()
    cams, _R, _t, view = view_fields(data, nb)
    C = plane.dim() - 1 - nb
    c = ncc.geom_consistency_cost(data.ref_cam, cams, data.src_depths,
                                  plane.unsqueeze(C), px, py, view)
    return torch.where(data.view_valid.reshape(-1, *([1] * nb)), c,
                       GEOM_COST_MAX)


# ---------------------------------------------------------------------------
# Initialization (RandomInitialization, DPE.cu:1035-1063)
# ---------------------------------------------------------------------------

def init_from_costs(data: SweepData, state: PMState,
                    params: PatchMatchParams, cost_fn) -> PMState:
    """``RandomInitialization`` over a cost function (plane (H, W, 4) ->
    (V, H, W) costs) of either engine: random planes in the first round
    (mean of the top-k view costs, those views selected); later passes
    re-frame the prior (world normal, depth) into camera planes and keep the
    selected views whose cost is valid."""
    H, W = data.ref_image.shape
    px, py = geo.pixel_grid(H, W, data.device)
    key, sub = state.key.split(2)
    zero = torch.zeros((), device=data.device)

    if params.state != RunState.FIRST_INIT:
        n_cam = geo.normal_world_to_cam(data.ref_cam, state.plane[..., :3])
        plane = geo.plane_from_depth_normal(data.ref_cam, px, py,
                                            state.plane[..., 3], n_cam)
        costs = cost_fn(plane)
        bit = selected_bits(state.selected, costs.shape[0])
        use = bit & (costs < COST_MAX)
        cnt = use.sum(0)
        cost = torch.where(cnt > 0, torch.where(use, costs, zero).sum(0)
                           / cnt.clamp(min=1),
                           torch.full((H, W), COST_MAX, device=data.device))
        # Deselect views whose cost saturated (the intended single-bit
        # semantics of ``unSetBit``, DPE.cu:77-80).
        keep = ~(bit & (costs >= COST_MAX))
        return state.replace(plane=plane, cost=cost,
                             selected=pack_bits(bit & keep), key=key)

    plane = planegen.random_plane(sub, data.ref_cam, px, py,
                                  data.depth_min, data.depth_max)
    costs = cost_fn(plane)
    v = costs.shape[0]
    num_valid = (costs < COST_MAX).sum(0)
    top_k = num_valid.clamp(max=params.top_k)
    sorted_c = torch.sort(costs, dim=0).values
    ks = (top_k - 1).clamp(0, v - 1)
    kth = torch.gather(sorted_c, 0, ks[None])[0]
    mask_steps = torch.arange(v, device=data.device)[:, None, None] < \
        top_k[None]
    mean_cost = torch.where(mask_steps, sorted_c, zero).sum(0) / \
        top_k.clamp(min=1)
    cost = torch.where(top_k > 0, mean_cost,
                       torch.full_like(mean_cost, COST_MAX))
    sel_bits = (costs <= kth[None]) & (top_k[None] > 0)
    return state.replace(plane=plane, cost=cost, selected=pack_bits(sel_bits),
                         key=key)


def initialize(data: SweepData, state: PMState, params: PatchMatchParams
               ) -> PMState:
    """:func:`init_from_costs` on the exact engine's strong NCC."""
    offs = strong_offsets(params)
    cache = strong_ref_cache(data, params)
    return init_from_costs(
        data, state, params,
        lambda plane: ncc_cost_vector(data, plane, offs, ref_cache=cache))


def selected_bits(selected: torch.Tensor, nview: int) -> torch.Tensor:
    """(H, W) int32 bitmask -> (V, H, W) bool."""
    sh = torch.arange(nview, dtype=torch.int32, device=selected.device)
    return ((selected[None] >> sh[:, None, None]) & 1) == 1


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(V, H, W) bool -> (H, W) int32 bitmask (V <= 31)."""
    sh = torch.arange(bits.shape[0], dtype=torch.int32, device=bits.device)
    return torch.sum(bits.to(torch.int32) << sh[:, None, None], dim=0,
                     dtype=torch.int32)


def classic_probe_sets():
    """Probe offset tables of the ACMM near/far checkerboard sampling
    (DPE.cu:1345-1545), in reference direction order 0..7 = up_near, up_far,
    down_near, down_far, left_near, left_far, right_near, right_far.

    Each probe: (dx, dy, guard) where guard(x, y, W, H) is the reference's
    bound condition."""
    dirs = []
    probes = [(0, -1, lambda x, y, W, H: y > 0)]
    for i in range(3):
        probes.append((-(1 + i), -(2 + i),
                       lambda x, y, W, H, i=i: (y > 1 + i) & (x > i)))
        probes.append((1 + i, -(2 + i),
                       lambda x, y, W, H, i=i: (y > 1 + i) & (x < W - 1 - i)))
    dirs.append(probes)
    probes = [(0, -3, lambda x, y, W, H: y > 2)]
    for i in range(1, 11):
        probes.append((0, -3 - 2 * i, lambda x, y, W, H, i=i: y > 2 + 2 * i))
    dirs.append(probes)
    probes = [(0, 1, lambda x, y, W, H: y < H - 1)]
    for i in range(3):
        probes.append((-(1 + i), 2 + i,
                       lambda x, y, W, H, i=i: (y < H - 2 - i) & (x > i)))
        probes.append((1 + i, 2 + i,
                       lambda x, y, W, H, i=i: (y < H - 2 - i) & (x < W - 1 - i)))
    dirs.append(probes)
    probes = [(0, 3, lambda x, y, W, H: y < H - 3)]
    for i in range(1, 11):
        probes.append((0, 3 + 2 * i, lambda x, y, W, H, i=i: y < H - 3 - 2 * i))
    dirs.append(probes)
    probes = [(-1, 0, lambda x, y, W, H: x > 0)]
    for i in range(3):
        probes.append((-(2 + i), -(1 + i),
                       lambda x, y, W, H, i=i: (x > 1 + i) & (y > i)))
        probes.append((-(2 + i), 1 + i,
                       lambda x, y, W, H, i=i: (x > 1 + i) & (y < H - 1 - i)))
    dirs.append(probes)
    probes = [(-3, 0, lambda x, y, W, H: x > 2)]
    for i in range(1, 11):
        probes.append((-3 - 2 * i, 0, lambda x, y, W, H, i=i: x > 2 + 2 * i))
    dirs.append(probes)
    probes = [(1, 0, lambda x, y, W, H: x < W - 1)]
    for i in range(3):
        probes.append((2 + i, -(1 + i),
                       lambda x, y, W, H, i=i: (x < W - 2 - i) & (y > i)))
        probes.append((2 + i, 1 + i,
                       lambda x, y, W, H, i=i: (x < W - 2 - i) & (y < H - 1 - i)))
    dirs.append(probes)
    probes = [(3, 0, lambda x, y, W, H: x < W - 3)]
    for i in range(1, 11):
        probes.append((3 + 2 * i, 0, lambda x, y, W, H, i=i: x < W - 3 - 2 * i))
    dirs.append(probes)
    return dirs


_CLASSIC_PROBES = classic_probe_sets()


def classic_candidates(cost_map: torch.Tensor):
    """For each of the 8 reference directions: (flag, best_dx, best_dy) of
    the min-cost probe (classic ACMM mode, DPE.cu:1345-1545)."""
    H, W = cost_map.shape
    dev = cost_map.device
    xg, yg = int_grids(H, W, dev)
    flags, dxs, dys = [], [], []
    for probes in _CLASSIC_PROBES:
        best_c = torch.full((H, W), BIG, device=dev)
        best_dx = torch.zeros((H, W), dtype=torch.int32, device=dev)
        best_dy = torch.zeros((H, W), dtype=torch.int32, device=dev)
        base_guard = probes[0][2](xg, yg, W, H)
        for dx, dy, guard in probes:
            ok = base_guard & guard(xg, yg, W, H)
            c = torch.where(ok, sampling.shift(cost_map, dy, dx), BIG)
            better = c < best_c
            best_c = torch.where(better, c, best_c)
            best_dx = torch.where(better, dx, best_dx)
            best_dy = torch.where(better, dy, best_dy)
        flags.append(base_guard)
        dxs.append(best_dx)
        dys.append(best_dy)
    return flags, dxs, dys


def _s_mag(it) -> int:
    """First probe distance of the edge-bounded rays: 5 - 2 * it, >= 1."""
    return max(1, 5 - 2 * int(it))


def _diag_fix(d: int, dx_u: int, dy_u: int):
    """The reference's extra unit step of the last diagonal directions."""
    if d > 4:
        return (dx_u, 0) if d % 2 == 1 else (0, dy_u)
    return 0, 0


def _best_probe(cost_map: torch.Tensor, pdx, pdy, ok):
    """Min-cost probe of a (T, H, W) ray: (flag, dx, dy); invalid probes read
    BIG (the flag decides, not the index)."""
    H, W = cost_map.shape
    xg, yg = int_grids(H, W, cost_map.device)
    tx = xg[None] + pdx
    ty = yg[None] + pdy
    ok = ok & (tx >= 0) & (ty >= 0) & (tx < W) & (ty < H)
    c = torch.where(ok, sampling.gather_map(cost_map, ty, tx), BIG)
    best_c, best_t = torch.min(c, dim=0)
    pdx, pdy = torch.broadcast_tensors(pdx, pdy, c)[:2]
    return (best_c < BIG, torch.gather(pdx, 0, best_t[None])[0],
            torch.gather(pdy, 0, best_t[None])[0])


def edge_candidates(cost_map: torch.Tensor, edge: torch.Tensor,
                    edge_steps: torch.Tensor, it):
    """Edge-bounded directional sampling, first pass (DPE.cu:1242-1292): per
    direction, probe along the ray with a reach bounded by the distance to
    the nearest edge. Returns (flags, dxs, dys)."""
    H, W = cost_map.shape
    dev = cost_map.device
    max_edge_dist = max(H, W) / 30.0
    min_step = 2
    s_mag = _s_mag(it)
    t = torch.arange(22, dtype=torch.int32, device=dev)[:, None, None]
    flags, dxs, dys = [], [], []
    for d in range(8):
        dx_u, dy_u = _EDGE_DIRS[d]
        dist = edge_steps[d]                         # f32 steps, INF if none
        invalid = dist >= support.INF
        cap = max_edge_dist / (np.sqrt(2.0) if d >= 4 else 1.0)
        dist = torch.where(invalid | (dist > max_edge_dist), float(cap), dist)
        dist = torch.where(edge, 11.0 * min_step, dist)
        step_num = sampling.to_int32(dist / min_step).clamp(11, 22)
        step_len = sampling.to_int32(
            dist / step_num.to(torch.float32)).clamp(min=min_step)
        if d < 4:
            step_len = torch.where(step_len % 2 == 1, step_len - 1, step_len)
        fx, fy = _diag_fix(d, dx_u, dy_u)
        pdx = s_mag * dx_u + t * step_len[None] * dx_u + fx   # (22, H, W)
        pdy = s_mag * dy_u + t * step_len[None] * dy_u + fy
        f, bx, by = _best_probe(cost_map, pdx, pdy, t < step_num[None])
        flags.append(f)
        dxs.append(bx)
        dys.append(by)
    return flags, dxs, dys


def edge_second_pass_candidates(cost_map: torch.Tensor, it):
    """Short-range non-local pass for non-edge pixels (DPE.cu:1293-1343):
    11 probes at fixed step 2."""
    H, W = cost_map.shape
    dev = cost_map.device
    s_mag = _s_mag(it)
    t = torch.arange(11, dtype=torch.int32, device=dev)[:, None, None]
    flags, dxs, dys = [], [], []
    for d in range(8):
        dx_u, dy_u = _EDGE_DIRS[d]
        fx, fy = _diag_fix(d, dx_u, dy_u)
        pdx = (s_mag * dx_u + t * 2 * dx_u + fx).expand(11, H, W)
        pdy = (s_mag * dy_u + t * 2 * dy_u + fy).expand(11, H, W)
        f, bx, by = _best_probe(cost_map, pdx, pdy, True)
        flags.append(f)
        dxs.append(bx)
        dys.append(by)
    return flags, dxs, dys


def _threshold(it) -> torch.Tensor:
    """Good-cost threshold 0.8 * exp(-it^2 / 90), in float32."""
    itf = torch.tensor(float(it), dtype=torch.float32)
    return 0.8 * torch.exp(itf * itf / -90.0)


def view_selection(key, cost_array: torch.Tensor, prior: torch.Tensor,
                   valid_view: torch.Tensor, it):
    """cost_array: (8, V, H, W); prior: (V, H, W). Returns (view_weight
    (V, H, W) i32, selected bitmask (H, W) i32, weight_norm (H, W) f32)."""
    nview = cost_array.shape[1]
    dev = cost_array.device
    thr = _threshold(it).to(dev)
    good = cost_array < thr                                  # (8, V, H, W)
    bad = cost_array > 1.2
    # Counts over the 8 candidates in uint8 (a bool sum to int64 would first
    # copy the whole mask as int64).
    count = good.sum(0, dtype=torch.uint8).to(torch.float32)  # (V, H, W)
    count_false = bad.sum(0, dtype=torch.uint8)
    zero = torch.zeros((), device=dev)
    tmpw = torch.where(good, torch.exp(cost_array * cost_array / -0.18),
                       zero.to(cost_array.dtype)).sum(0)
    probs = torch.where(
        (count > 2) & (count_false < 3), tmpw / count.clamp(min=1.0),
        torch.where(count_false < 3, torch.exp(thr * thr / -0.32), zero))
    probs = probs * prior * valid_view[:, None, None]

    psum = probs.sum(0, keepdim=True)
    cdf = torch.cumsum(probs, 0) / psum.clamp(min=1e-30)
    cdf = torch.where(psum > 0, cdf, zero)

    H, W = cost_array.shape[2:]
    views = torch.arange(nview, device=dev)
    if H * W > FULLRES_PX:
        # Full-resolution frames: accumulate the 15 Monte-Carlo draws one at
        # a time instead of materializing (15, V, H, W) hit masks; draw i
        # from the i-th key of ``key.split(15)``, as the JAX package's scan.
        BRANCHES["scanned draws"] += 1
        view_weight = torch.zeros((nview, H, W), dtype=torch.int32,
                                  device=dev)
        for key_i in key.split(15):
            ui = key_i.uniform((H, W)).to(dev)
            hits = cdf > ui[None]                            # (V, H, W)
            first = hits.to(torch.uint8).argmax(0)
            any_hit = hits.any(0)
            view_weight += ((first[None] == views[:, None, None])
                            & any_hit[None]).to(torch.int32)
    else:
        u = key.uniform((15, H, W)).to(dev)
        hits = cdf[None, :] > u[:, None]                     # (15, V, H, W)
        first = hits.to(torch.uint8).argmax(1)               # (15, H, W)
        any_hit = hits.any(1)
        one_hot = ((first[:, None] == views[None, :, None, None])
                   & any_hit[:, None])
        view_weight = one_hot.sum(0, dtype=torch.int32)

    selected = pack_bits(view_weight > 0)
    weight_norm = view_weight.sum(0).to(torch.float32)
    return view_weight, selected, weight_norm


def neighbour_prior(selected: torch.Tensor, flags: torch.Tensor,
                    nview: int, icx=None, icy=None) -> torch.Tensor:
    """View-selection prior from the 4 fixed neighbours (DPE.cu:1552-1566):
    +0.9 if the neighbour selected the view, else +0.1, for each neighbour
    whose direction flag (index 0, 2, 4, 6) holds. ``selected`` is
    full-res; with ``icx``/``icy`` the prior is evaluated at those sites
    (flags share the site shape). Borders are safe either way: the direction
    flags are False exactly where the neighbour would fall outside."""
    shifts = [(0, -1), (0, 1), (-1, 0), (1, 0)]  # up, down, left, right (dx,dy)
    dev = selected.device
    prior = torch.zeros((nview, *flags.shape[1:]), dtype=torch.float32,
                        device=dev)
    zero = torch.zeros((), device=dev)
    for i, (dx, dy) in enumerate(shifts):
        if icx is None:
            nb = support.shift_fill(selected, dy, dx, 0)
        else:
            nb = sampling.gather_map(selected, icy + dy, icx + dx)
        bits = selected_bits(nb, nview)
        contrib = torch.where(bits, torch.full((), 0.9, device=dev),
                              torch.full((), 0.1, device=dev))
        prior = prior + torch.where(flags[2 * i][None], contrib, zero)
    return prior


def refine_combos(key, data: SweepData, plane, depth, px, py):
    """The 5 {depth, normal} refinement combinations (DPE.cu:1093-1095).
    Returns (depths (5, *B), normals (5, *B, 3))."""
    k1, k2, k3, k4 = key.split(4)
    dev = px.device
    depth_rand = k1.uniform(px.shape, data.depth_min, data.depth_max).to(dev)
    n_rand = planegen.random_normal_facing(k2, data.ref_cam, px, py, depth)
    depth_pert = k3.uniform(px.shape, 0.98 * depth, 1.02 * depth).to(dev)
    n_pert = planegen.perturbed_normal(k4, data.ref_cam, px, py,
                                       plane[..., :3], 0.02 * math.pi)
    n_cur = plane[..., :3]
    depths = torch.stack([depth_rand, depth, depth_rand, depth, depth_pert])
    normals = torch.stack([n_cur, n_rand, n_rand, n_pert, n_cur])
    return depths, normals


def refine_strong(key, data: SweepData, params: PatchMatchParams,
                  plane, depth, cost, view_weight, weight_norm,
                  ref_cache=None, px=None, py=None, ref_center=None):
    """``PlaneHypothesisRefinementStrong`` (DPE.cu:1065-1118): the 5
    refinement candidates, each taken where it lowers the weighted cost and
    its depth is in range (in order, as the JAX package's scan)."""
    if px is None:
        px, py = geo.pixel_grid(*data.ref_image.shape, data.device)
    depths, normals = refine_combos(key, data, plane, depth, px, py)
    wsum = weight_norm.clamp(min=1e-30)
    cands = geo.plane_from_depth_normal(data.ref_cam, px, py, depths,
                                        normals)             # (5, *B, 4)
    costs = ncc_cost_vector(data, cands, strong_offsets(params),
                            ref_cache=ref_cache, cx=px, cy=py,
                            ref_center=ref_center)           # (5, V, *B)
    cs = (view_weight[None] * costs).sum(1) / wsum
    d_chk = geo.depth_from_plane(data.ref_cam, cands, px, py)
    for i in range(cands.shape[0]):
        ok = (d_chk[i] >= data.depth_min) & (d_chk[i] <= data.depth_max) & \
            (cs[i] < cost) & (weight_norm > 0)
        plane = torch.where(ok[..., None], cands[i], plane)
        depth = torch.where(ok, d_chk[i], depth)
        cost = torch.where(ok, cs[i], cost)
    return plane, depth, cost


def _compact_dirs(cands, color: int):
    """Stack and compact the 8 directions' (flags, dxs, dys)."""
    return [checker.compact_stack(torch.stack(c), color) for c in cands]


def propagate_strong(key, data: SweepData, sup: Support, state: PMState,
                     params: PatchMatchParams, it: int, color: int):
    """Strong-pixel proposal for one checkerboard color
    (``CheckerboardPropagationStrong``, DPE.cu:1214-1666), evaluated on the
    color's compacted (H, W2) half grid. Candidate *search* runs full-res
    over the cost map; every NCC evaluation runs at the compacted sites.
    Returns compacted (plane, cost, selected, view_weight); the caller
    scatters back and applies the weak mask."""
    H, W = data.ref_image.shape
    dev = data.device
    offs = strong_offsets(params)
    nview = data.num_src
    k_sel, k_ref = key.split(2)

    # Compacted site coordinates + site-local inputs.
    ccx, ccy = checker.sites(H, W, color, device=dev)      # (H, W2) f32
    icx = sampling.to_int32(ccx)
    icy = sampling.to_int32(ccy)
    ref_center_c = checker.compact(data.ref_image, color)
    plane_now = checker.compact(state.plane, color)         # (H, W2, 4)
    selected_now = checker.compact(state.selected, color)
    cache = strong_ref_cache(data, params, ccx, ccy, ref_center_c)

    if params.use_edge:
        cands = edge_candidates(state.cost, data.edge, sup.edge_steps, it)
    else:
        cands = classic_candidates(state.cost)
    flags, dxs, dys = _compact_dirs(cands, color)            # (8, H, W2)
    cand_planes = sampling.gather_map(state.plane, icy[None] + dys,
                                      icx[None] + dxs)       # (8, H, W2, 4)

    def cost_vec(pl):
        return ncc_cost_vector(data, pl, offs, ref_cache=cache, cx=ccx,
                               cy=ccy, ref_center=ref_center_c)

    cost_array = cost_vec(cand_planes)                       # (8, V, H, W2)
    # Uncomputed directions keep zeroed rows, as the reference's
    # uninitialized cost_array does (DPE.cu:1236; border-only effect).
    cost_array = torch.where(flags[:, None], cost_array, 0.0)

    if params.use_edge:
        # Second non-local pass for non-edge pixels (DPE.cu:1293-1343).
        good_thr = _threshold(it).to(dev)
        f2, dx2, dy2 = _compact_dirs(
            edge_second_pass_candidates(state.cost, it), color)
        p2 = sampling.gather_map(state.plane, icy[None] + dy2,
                                 icx[None] + dx2)
        c2 = cost_vec(p2)
        edge_c = checker.compact(data.edge, color)
        good1 = (cost_array < good_thr).sum(1)               # (8, H, W2)
        bad1 = (cost_array > 1.2).sum(1)
        c2m = torch.where(f2[:, None], c2, COST_MAX)
        good2 = (c2m < good_thr).sum(1)
        bad2 = (c2m > 1.2).sum(1)
        replace = f2 & (~edge_c)[None] & (
            (~flags) | (good2 > good1) | ((good2 == good1) & (bad2 < bad1)))
        cost_array = torch.where(replace[:, None], c2, cost_array)
        cand_planes = torch.where(replace[..., None], p2, cand_planes)
        flags = flags | (f2 & (~edge_c)[None])

    prior = neighbour_prior(state.selected, flags, nview, icx=icx, icy=icy)
    view_weight, temp_selected, weight_norm = view_selection(
        k_sel, cost_array, prior, data.view_valid, it)
    wsum = weight_norm.clamp(min=1e-30)

    final_costs = (view_weight[None] * cost_array).sum(1) / wsum[None]
    min_cost, min_idx = torch.min(final_costs, dim=0)       # (H, W2)
    min_flag = torch.gather(flags, 0, min_idx[None])[0]
    min_plane = torch.gather(
        cand_planes, 0, min_idx[None, ..., None].expand(1, *plane_now.shape)
    )[0]

    cost_now = (view_weight * cost_vec(plane_now)).sum(0) / wsum
    cost_now = torch.where(weight_norm > 0, cost_now, COST_MAX)
    stored_cost = cost_now

    depth_now = geo.depth_from_plane(data.ref_cam, plane_now, ccx, ccy)
    depth_before = geo.depth_from_plane(data.ref_cam, min_plane, ccx, ccy)
    accept = min_flag & (depth_before >= data.depth_min) & \
        (depth_before <= data.depth_max) & (min_cost < cost_now)

    plane = torch.where(accept[..., None], min_plane, plane_now)
    depth = torch.where(accept, depth_before, depth_now)
    cost = torch.where(accept, min_cost, cost_now)
    selected = torch.where(accept, temp_selected, selected_now)

    plane, depth, cost = refine_strong(
        k_ref, data, params, plane, depth, cost, view_weight, weight_norm,
        ref_cache=cache, px=ccx, py=ccy, ref_center=ref_center_c)

    if params.state == RunState.REFINE_INIT:
        # Hysteresis: protect the upsampled prior (DPE.cu:1656-1665).
        accept_final = cost < stored_cost - 0.1
        plane = torch.where(accept_final[..., None], plane, plane_now)
        cost = torch.where(accept_final, cost, stored_cost)

    return plane, cost, selected, view_weight


def to_world_depth(data: SweepData, plane: torch.Tensor) -> torch.Tensor:
    """(n_cam, dist) -> (n_world, depth) (``GetDepthandNormal``)."""
    H, W = data.ref_image.shape
    px, py = geo.pixel_grid(H, W, data.device)
    depth = geo.depth_from_plane(data.ref_cam, plane, px, py)
    n_world = geo.normal_cam_to_world(data.ref_cam, plane[..., :3])
    return torch.cat([n_world, depth[..., None]], dim=-1)


_FILTER_OFFSETS = [
    # (dx, dy, guard) from CheckerboardFilterStrong (DPE.cu:1995-2057).
    (0, -1, lambda x, y, W, H: y > 0),
    (0, -3, lambda x, y, W, H: y > 2),
    (0, -5, lambda x, y, W, H: y > 4),
    (0, 1, lambda x, y, W, H: y < H - 1),
    (0, 3, lambda x, y, W, H: y < H - 3),
    (0, 5, lambda x, y, W, H: y < H - 5),
    (-1, 0, lambda x, y, W, H: x > 0),
    (-3, 0, lambda x, y, W, H: x > 2),
    (-5, 0, lambda x, y, W, H: x > 4),
    (1, 0, lambda x, y, W, H: x < W - 1),
    (3, 0, lambda x, y, W, H: x < W - 3),
    (5, 0, lambda x, y, W, H: x < W - 5),
    (2, -1, lambda x, y, W, H: (y > 0) & (x < W - 2)),
    (2, 1, lambda x, y, W, H: (y < H - 1) & (x < W - 2)),
    (-2, -1, lambda x, y, W, H: (y > 0) & (x > 1)),
    (-2, 1, lambda x, y, W, H: (y < H - 1) & (x > 1)),
    (-1, -2, lambda x, y, W, H: (x > 0) & (y > 2)),
    (1, -2, lambda x, y, W, H: (x < W - 1) & (y > 2)),
    (-1, 2, lambda x, y, W, H: (x > 0) & (y < H - 2)),
    (1, 2, lambda x, y, W, H: (x < W - 1) & (y < H - 2)),
]


def int_grids(H: int, W: int, device):
    xg = torch.arange(W, dtype=torch.int32, device=device)[None, :].expand(H, W)
    yg = torch.arange(H, dtype=torch.int32, device=device)[:, None].expand(H, W)
    return xg, yg


def median_filter_depth(data: SweepData, plane: torch.Tensor,
                        cost: torch.Tensor, weak: torch.Tensor
                        ) -> torch.Tensor:
    """Median of the center depth + up-to-20 STRONG neighbour depths
    (``CheckerboardFilterStrong``, DPE.cu:1957-2067). Returns the new depth
    channel; the caller applies the red/black + non-weak mask."""
    H, W = data.ref_image.shape
    xg, yg = int_grids(H, W, data.device)
    depth = plane[..., 3]
    vals = [depth]
    valids = [torch.ones((H, W), dtype=torch.bool, device=data.device)]
    for dx, dy, guard in _FILTER_OFFSETS:
        ok = guard(xg, yg, W, H) & \
            (support.shift_fill(weak, dy, dx, UNKNOWN) == STRONG)
        vals.append(sampling.shift(depth, dy, dx))
        valids.append(ok)
    stack = torch.stack(vals)                                # (21, H, W)
    valid = torch.stack(valids)
    n = valid.sum(0)                                         # (H, W) >= 1
    sorted_vals = torch.sort(torch.where(valid, stack,
                                         torch.full_like(stack, BIG)),
                             dim=0).values
    mid = n // 2

    def take(idx):
        return torch.gather(sorted_vals, 0, idx[None])[0]

    med_odd = take(mid)
    med_even = 0.5 * (take((mid - 1).clamp(min=0)) + take(mid))
    med = torch.where(n % 2 == 0, med_even, med_odd)
    return torch.where(cost < 0.001, depth, med)


def _disparity_setup(data: SweepData, state: PMState):
    """Per-pixel mean baseline over selected views + cam-frame plane/depth."""
    nview = data.num_src
    n_world = state.plane[..., :3]
    origin_depth = state.plane[..., 3]
    n_cam = geo.normal_world_to_cam(data.ref_cam, n_world)
    bits = selected_bits(state.selected, nview) & \
        data.view_valid[:, None, None]
    cnt = bits.sum(0)
    bl = torch.where(bits, data.baseline[:, None, None],
                     torch.zeros((), device=data.device)).sum(0) / \
        cnt.clamp(min=1)
    return n_cam, origin_depth, bl, cnt


def _selected_weighted_cost(data: SweepData, state: PMState,
                            params: PatchMatchParams, plane: torch.Tensor,
                            offs: np.ndarray, ref_cache=None):
    """Weighted NCC (+ geom) over each pixel's selected views of plane
    fields (*C, H, W, 4): ((*C, H, W) cost, (H, W) weight sum)."""
    costs = ncc_cost_vector(data, plane, offs, ref_cache=ref_cache)
    if params.geom_consistency:
        costs = costs + params.geom_factor * geom_cost_vector(data, plane)
    bits = selected_bits(state.selected, data.num_src)
    w = torch.where(bits, state.view_weight.permute(2, 0, 1),
                    torch.zeros((), dtype=torch.int32, device=data.device))
    wsum = w.sum(0).to(torch.float32)
    total = (w * costs).sum(-3) / wsum.clamp(min=1e-30)
    return total, wsum


def disparity_sweep(data: SweepData, state: PMState,
                    params: PatchMatchParams, disps: np.ndarray,
                    rstat=None, stride: int = 1) -> torch.Tensor:
    """(S, H, W) weighted costs over disparity offsets around the current
    depth, shared by DepthToWeak and LocalRefine. With ``rstat`` the sweep
    runs on the rect engine (``weak_rect.rect_disparity_sweep``, ``stride``
    subsampling its probe centres); without, every probe is the exact
    engine's cost at full resolution (``stride`` ignored)."""
    if rstat is not None:
        from . import weak_rect
        return weak_rect.rect_disparity_sweep(data, state, params, rstat,
                                              disps, stride=stride)
    H, W = data.ref_image.shape
    px, py = geo.pixel_grid(H, W, data.device)
    offs = strong_offsets(params)
    cache = strong_ref_cache(data, params)
    n_cam, origin_depth, bl, _cnt = _disparity_setup(data, state)
    f = data.ref_cam.fx
    disp0 = f * bl / torch.where(origin_depth > 0, origin_depth,
                                 torch.full_like(origin_depth, 1e30))
    p_disps = torch.as_tensor(np.asarray(disps, np.float32),
                              device=data.device)[:, None, None]
    chunk = ncc._chunking(offs.shape[0], (H, W))[0]
    out = []
    for a, b in groups(len(disps), data.num_src * chunk * H * W):
        p_depth = f * bl / (disp0 + p_disps[a:b])            # (g, H, W)
        cand = geo.plane_from_depth_normal(data.ref_cam, px, py, p_depth,
                                           n_cam)
        c, _ = _selected_weighted_cost(data, state, params, cand, offs,
                                       ref_cache=cache)
        in_range = (p_depth >= data.depth_min) & \
            (p_depth <= data.depth_max)
        out.append(torch.where(in_range, c.clamp(max=COST_MAX), COST_MAX))
    return torch.cat(out)


def _classify_profile(costs: torch.Tensor, radius: int,
                      weak_peak_radius: int) -> torch.Tensor:
    """WEAK / STRONG per pixel of a (S, h, W) disparity cost profile
    (``DepthToWeak``'s analysis, DPE.cu:2593-2747): the local minima
    ("peaks") of the interior probes, the lowest of them, and the spread of
    the others around it."""
    dev = costs.device
    S = costs.shape[0]
    interior = torch.zeros((S,), dtype=torch.bool, device=dev)
    interior[2:S - 2] = True
    is_peak = interior[:, None, None] & \
        (torch.roll(costs, 1, 0) > costs) & (torch.roll(costs, -1, 0) > costs)
    peak_count = is_peak.sum(0)
    peak_costs = torch.where(is_peak, costs, torch.full_like(costs, BIG))
    min_cost, min_peak = torch.min(peak_costs, dim=0)
    has_min = min_cost < COST_MAX
    min_peak = torch.where(has_min, min_peak, torch.zeros_like(min_peak))
    min_cost_eff = torch.where(has_min, min_cost, torch.full_like(min_cost,
                                                                  2.0))
    cost_at_minpeak = torch.where(has_min, min_cost, costs[0])

    # Variance of other peaks around the minimum (DPE.cu:2730-2739).
    others = is_peak & (torch.arange(S, device=dev)[:, None, None]
                        != min_peak[None])
    var = torch.sqrt(torch.where(others, (costs - min_cost_eff) ** 2,
                                 torch.zeros((), device=dev)).sum(0))
    var = var / (peak_count - 1).clamp(min=1)

    off_center = (min_peak - radius).abs() > weak_peak_radius
    weak_t = torch.full((), WEAK, dtype=torch.uint8, device=dev)
    strong_t = torch.full((), STRONG, dtype=torch.uint8, device=dev)
    return torch.where(
        off_center | (cost_at_minpeak > 0.5),
        weak_t,
        torch.where(peak_count == 1,
                    torch.where(cost_at_minpeak <= 0.15, strong_t, weak_t),
                    torch.where(var > 0.2, strong_t, weak_t)))


def depth_to_weak(data: SweepData, state: PMState, params: PatchMatchParams,
                  rstat=None) -> torch.Tensor:
    """Reclassify pixels from the 61-sample disparity cost profile
    (``DepthToWeak``, DPE.cu:2593-2747). Returns the new weak map."""
    H, W = data.ref_image.shape
    dev = data.device
    radius = 30
    disps = np.arange(-radius, radius + 1, dtype=np.float32)
    # The rect engine takes stride-2 probe centres at working resolutions
    # (labels only); params.classify_stride overrides the auto gate. The
    # exact engine probes every pixel.
    stride = 1
    if rstat is not None:
        stride = params.classify_stride if params.classify_stride is not None \
            else 2 if rstat.hp * rstat.wp >= 384 * 512 else 1
    costs = disparity_sweep(data, state, params, disps, rstat=rstat,
                            stride=stride)                    # (61, H, W)
    # The per-pixel analysis in row bands (each pixel reads only its own
    # probes).
    weak_out = torch.empty((H, W), dtype=torch.uint8, device=dev)
    bands = sampling.spans(H, 4.0 * costs.shape[0] * W, SWEEP_CHUNK_BYTES)
    if len(bands) > 1:
        BRANCHES["classify bands"] += len(bands)
    for r0, r1 in bands:
        weak_out[r0:r1] = _classify_profile(costs[:, r0:r1], radius,
                                            params.weak_peak_radius)
    del costs

    # Invalid pixels -> UNKNOWN (DPE.cu:2604-2652).
    _n_cam, origin_depth, _bl, cnt = _disparity_setup(data, state)
    xg, yg = int_grids(H, W, dev)
    margin = 6
    border = (xg < margin) | (yg < margin) | (xg >= W - margin) | \
        (yg >= H - margin)
    unknown = border | (origin_depth == 0) | (cnt == 0)
    return torch.where(unknown,
                       torch.full((), UNKNOWN, dtype=torch.uint8, device=dev),
                       weak_out)


def local_refine(data: SweepData, state: PMState, params: PatchMatchParams,
                 rstat=None) -> torch.Tensor:
    """+-5-disparity depth polish; accept on >= 0.1 improvement
    (``LocalRefine``, DPE.cu:2749-2835), exact or on the rect engine.
    Returns the new depth channel."""
    disps = np.arange(-5, 6, dtype=np.float32)
    costs = disparity_sweep(data, state, params, disps,
                            rstat=rstat)                      # (11, H, W)
    n_cam, origin_depth, bl, cnt = _disparity_setup(data, state)
    f = data.ref_cam.fx
    disp0 = f * bl / torch.where(origin_depth > 0, origin_depth,
                                 torch.full_like(origin_depth, 1e30))

    min_cost, best_idx = torch.min(costs, dim=0)
    best_depth = f * bl / (disp0 + (best_idx.to(torch.float32) - 5.0))
    in_range = (best_depth >= data.depth_min) & \
        (best_depth <= data.depth_max)
    best_depth = torch.where(in_range & (min_cost < 2.0), best_depth,
                             origin_depth)

    cost_now = costs[5]  # disparity 0 == current depth
    nview = data.num_src
    bits = selected_bits(state.selected, nview)
    wsum = torch.where(bits, state.view_weight.permute(2, 0, 1),
                       torch.zeros((), dtype=torch.int32, device=data.device)
                       ).sum(0).to(torch.float32)
    ok = (cost_now - min_cost > 0.1) & (origin_depth != 0) & (wsum > 0) & \
        (cnt > 0)
    return torch.where(ok, best_depth, origin_depth)
