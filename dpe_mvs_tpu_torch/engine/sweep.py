"""Sweep composition: support maps, the checkerboard, compacted write-back
and ``RunPatchMatch`` on the exact engine.

Port of :mod:`dpe_mvs_tpu.engine.sweep`: :func:`build_support`
(GenEdgeInform / FindNearestStrongPoint / GenNeighbours equivalents,
DPE.cu:3153-3171), :func:`checkerboard_mask`, :func:`apply_compacted` and
:func:`run_sweep`, which is :func:`.stages.run_sweep_staged` without a rect
engine (the JAX package holds its one-jit sweep and its staged executor to
the same computation). The JAX module's separately-jitted support pieces
were a TPU compile workaround and have no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import PatchMatchParams, PixelState
from ..ops import anchors, checker
from ..ops import support as sup_ops
from . import patchmatch as pm
from .state import PMState, SweepData

STRONG = int(PixelState.STRONG)


def checkerboard_mask(H: int, W: int, color: int, device) -> torch.Tensor:
    """color 0 == 'black' ((x + y) even), 1 == 'red' (DPE.cu:1864-1938)."""
    yg = torch.arange(H, device=device)[:, None]
    xg = torch.arange(W, device=device)[None, :]
    return ((xg + yg) % 2) == color


def build_support(data: SweepData, state: PMState, params: PatchMatchParams,
                  key):
    """Per-sweep support maps, built only for their consumers (the reference
    gates GenEdgeInform/GenNeighbours on use_edge/use_APD): edge_steps feeds
    the edge candidates and the anchor search; label_runs and the line of
    sight feed only the anchor search. Returns (Support, state with the
    unreliable weak pixels made UNKNOWN)."""
    H, W = data.ref_image.shape
    max_steps = 1 << int(np.ceil(np.log2(max(H, W))))

    edge_steps = complexity = label_runs = los = None
    if params.use_edge or (params.use_APD and params.use_limit):
        edge_steps = sup_ops.edge_steps(data.edge, max_steps)
    if params.use_edge:
        complexity = sup_ops.complexity_map(data.edge, data.label,
                                            params.strong_radius,
                                            params.use_label)
    if params.use_APD and params.use_label:
        label_runs = sup_ops.label_run_length(data.label, max_steps)
    if params.use_APD and params.use_limit:
        los = sup_ops.build_line_of_sight(data.edge_low, W, H,
                                          params.high_res_img)

    nearest_strong = neighbours = None
    if params.use_APD:
        nearest_strong, _valid = sup_ops.jfa_nearest(state.weak == STRONG,
                                                     100.0)
        neighbours, _reliable, weak2, complexity = anchors.gen_neighbours(
            key, data, state, params, edge_steps=edge_steps,
            complexity=complexity, label_runs=label_runs, los=los,
            nearest_strong=nearest_strong)
        state = state.replace(weak=weak2)
    return pm.Support(
        edge_steps=edge_steps, complexity=complexity, label_runs=label_runs,
        los=los, nearest_strong=nearest_strong, neighbours=neighbours,
        radius=None, fit_plane=None,
    ), state


def apply_compacted(state: PMState, mask: torch.Tensor, color: int, plane_c,
                    cost_c, selected_c, view_weight_c) -> PMState:
    """Scatter one color's compacted proposal back into full-res state;
    ``mask`` (full-res) further restricts to the strong/weak population
    (non-site pixels are untouched by construction of scatter)."""
    plane_n = checker.scatter(state.plane, plane_c, color)
    cost_n = checker.scatter(state.cost, cost_c, color)
    sel_n = checker.scatter(state.selected, selected_c, color)
    vw_n = checker.scatter(state.view_weight, view_weight_c.permute(1, 2, 0),
                           color)
    return state.replace(
        plane=torch.where(mask[..., None], plane_n, state.plane),
        cost=torch.where(mask, cost_n, state.cost),
        selected=torch.where(mask, sel_n, state.selected),
        view_weight=torch.where(mask[..., None], vw_n, state.view_weight),
    )


def run_sweep(data: SweepData, state: PMState, params: PatchMatchParams
              ) -> PMState:
    """One full PatchMatch sweep (state -> state) on the exact engine."""
    from .stages import run_sweep_staged
    return run_sweep_staged(data, state, params, rstat=None)
