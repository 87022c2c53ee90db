"""PatchMatch building blocks used by the rectified engine.

Port of the rect-path pieces of :mod:`dpe_mvs_tpu.engine.patchmatch`: the
per-sweep :class:`Support` maps, the probe tables, multi-hypothesis view
selection, the view-selection prior, the refinement combos, depth extraction
and filtering, and the disparity sweeps of DepthToWeak and LocalRefine
(their rect branch). The exact (XLA-gather) engine is a later slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import COST_MAX, PatchMatchParams, PixelState
from ..geometry import cameras as geo
from ..ops import ncc, sampling, support
from ..ops import planes as planegen
from .state import PMState, SweepData

WEAK = int(PixelState.WEAK)
STRONG = int(PixelState.STRONG)
UNKNOWN = int(PixelState.UNKNOWN)
BIG = float(1e30)


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


def selected_bits(selected: torch.Tensor, nview: int) -> torch.Tensor:
    """(H, W) int32 bitmask -> (V, H, W) bool."""
    sh = torch.arange(nview, dtype=torch.int32, device=selected.device)
    return ((selected[None] >> sh[:, None, None]) & 1) == 1


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(V, H, W) bool -> (H, W) int32 bitmask (V <= 31)."""
    sh = torch.arange(bits.shape[0], dtype=torch.int32, device=bits.device)
    return torch.sum(bits.to(torch.int32) << sh[:, None, None], dim=0,
                     dtype=torch.int32)


def checkerboard_mask(H: int, W: int, color: int, device) -> torch.Tensor:
    """color 0 == 'black' ((x + y) even), 1 == 'red'."""
    yg = torch.arange(H, device=device)[:, None]
    xg = torch.arange(W, device=device)[None, :]
    return ((xg + yg) % 2) == color


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
    count = good.sum(0).to(torch.float32)                    # (V, H, W)
    count_false = bad.sum(0)
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
    if H * W > 4_000_000:
        # Full-resolution frames: accumulate the 15 Monte-Carlo draws one at
        # a time instead of materializing (15, V, H, W) hit masks.
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
                    nview: int) -> torch.Tensor:
    """View-selection prior from the 4 fixed neighbours (DPE.cu:1552-1566):
    +0.9 if the neighbour selected the view, else +0.1, for each neighbour
    whose direction flag (index 0, 2, 4, 6) holds."""
    shifts = [(0, -1), (0, 1), (-1, 0), (1, 0)]  # up, down, left, right (dx,dy)
    prior = torch.zeros((nview, *flags.shape[1:]), dtype=torch.float32,
                        device=selected.device)
    zero = torch.zeros((), device=selected.device)
    for i, (dx, dy) in enumerate(shifts):
        nb = support.shift_fill(selected, dy, dx, 0)
        bits = selected_bits(nb, nview)
        contrib = torch.where(bits, torch.full((), 0.9, device=bits.device),
                              torch.full((), 0.1, device=bits.device))
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


def depth_to_weak(data: SweepData, state: PMState, params: PatchMatchParams,
                  rstat) -> torch.Tensor:
    """Reclassify pixels from the 61-sample disparity cost profile
    (``DepthToWeak``, DPE.cu:2593-2747) on the rect engine. Returns the new
    weak map."""
    from . import weak_rect
    H, W = data.ref_image.shape
    dev = data.device
    radius = 30
    disps = np.arange(-radius, radius + 1, dtype=np.float32)
    # Stride-2 probe centers at working resolutions (labels only);
    # params.classify_stride overrides the auto gate.
    if params.classify_stride is not None:
        stride = params.classify_stride
    else:
        stride = 2 if rstat.hp * rstat.wp >= 384 * 512 else 1
    costs = weak_rect.rect_disparity_sweep(data, state, params, rstat, disps,
                                           stride=stride)     # (61, H, W)

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

    off_center = (min_peak - radius).abs() > params.weak_peak_radius
    weak_t = torch.full((), WEAK, dtype=torch.uint8, device=dev)
    strong_t = torch.full((), STRONG, dtype=torch.uint8, device=dev)
    weak_out = torch.where(
        off_center | (cost_at_minpeak > 0.5),
        weak_t,
        torch.where(peak_count == 1,
                    torch.where(cost_at_minpeak <= 0.15, strong_t, weak_t),
                    torch.where(var > 0.2, strong_t, weak_t)))

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
                 rstat) -> torch.Tensor:
    """+-5-disparity depth polish; accept on >= 0.1 improvement
    (``LocalRefine``, DPE.cu:2749-2835) on the rect engine. Returns the new
    depth channel."""
    from . import weak_rect
    disps = np.arange(-5, 6, dtype=np.float32)
    costs = weak_rect.rect_disparity_sweep(data, state, params, rstat,
                                           disps)             # (11, H, W)
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
