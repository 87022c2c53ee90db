"""Staged sweep executor of both cost engines.

Port of :mod:`dpe_mvs_tpu.engine.stages`. One sweep runs

    [support] -> init -> [weakprep] -> (strong [-> weak]) x max_iterations
    -> finish -> classify -> refine

on the rectified engine when given its statics (``rstat``), else on the
exact engine (per-pixel homography NCC, :mod:`.patchmatch` and
:mod:`..ops.weak`), with support when the weak-texture machinery is on
(``use_APD``; support also for ``use_edge``), weakprep on the rect engine
with ``use_APD``, and the JAX package's key
schedule call for call: ``keys = state.key.split(32)``; ``keys[0]`` goes to
support (the anchor search); ``keys[1]`` is the iteration base,
``fold_in(it)`` per iteration, then ``fold_in(color)`` per strong color,
``fold_in(2)`` for the fit-plane RANSAC and ``fold_in(3 + color)`` per weak
color; ``keys[-1]`` becomes the next sweep's key. The stages run eagerly on
the tensors' device.
"""
from __future__ import annotations

import torch

from ..config import PatchMatchParams, PixelState
from ..ops import weak as weak_ops
from ..utils import profiling
from . import patchmatch as pm
from . import rectcost, strong_rect, sweep, weak_rect
from .state import PMState, SweepData

WEAK = int(PixelState.WEAK)


def _support_stage(data: SweepData, state: PMState, key,
                   params: PatchMatchParams):
    return sweep.build_support(data, state, params, key)


def _init_stage(data: SweepData, state: PMState, params: PatchMatchParams,
                rstat) -> PMState:
    if rstat is None:
        return pm.initialize(data, state, params)
    return strong_rect.initialize_rect(data, state, params, rstat)


def _weakprep_stage(data: SweepData, sup, state: PMState,
                    params: PatchMatchParams, rstat):
    """Per-sweep probe volumes + anchor profiles; runs once after init."""
    return weak_rect.build_weak_bundle(data, sup, state, params, rstat)


def _strong_iter(data: SweepData, state: PMState, it, key_it,
                 params: PatchMatchParams, rstat, sup=pm.EMPTY_SUPPORT
                 ) -> PMState:
    """One propagation iteration over strong pixels, both checkerboard
    colors. On the rect engine the current plane's cost vector is shared by
    both colors (the cost at a pixel depends only on that pixel's plane, and
    color 0 writes only color-0 sites), and so are the evaluators and their
    caches."""
    if rstat is None:
        for color in (0, 1):
            out = pm.propagate_strong(key_it.fold_in(color), data, sup,
                                      state, params, it, color)
            state = sweep.apply_compacted(state, state.weak != WEAK, color,
                                          *out)
        return state
    stack = rectcost.build_rect_stack(data.rect, rstat)
    cost_fn = strong_rect.make_cost_fn(data, params, rstat, stack=stack)
    stride = strong_rect.screen_stride(params, rstat)
    cost_fn_s = (strong_rect.make_cost_fn(data, params, rstat, stride=stride,
                                          stack=stack)
                 if stride > 1 else cost_fn)
    cnv = cost_fn(state.plane)
    for color in (0, 1):
        out = strong_rect.propagate_strong_rect(
            key_it.fold_in(color), data, sup, state, params, it, color,
            rstat, cost_now_vec=cnv, cost_fn=cost_fn, cost_fn_s=cost_fn_s)
        state = strong_rect.apply_strong_full(state, state.weak != WEAK,
                                              color, *out)
    return state


def _weak_iter(data: SweepData, sup, state: PMState, it, key_it,
               params: PatchMatchParams, rstat, bundle) -> PMState:
    """Fit-plane RANSAC + weak propagation for both colors."""
    with profiling.span("weak.ransac"):
        sup_it = sup._replace(**weak_ops.fit_plane_ransac(
            key_it.fold_in(2), data, sup, state, params))
    for color in (0, 1):
        k = key_it.fold_in(3 + color)
        if rstat is None:
            out = weak_ops.propagate_weak(k, data, sup_it, state, params, it,
                                          color)
        else:
            out = weak_rect.propagate_weak_rect(k, data, sup_it, state,
                                                params, it, color, rstat,
                                                bundle)
        with profiling.span("weak.apply"):
            state = sweep.apply_compacted(state, state.weak == WEAK, color,
                                          *out)
    return state


def _finish_stage(data: SweepData, state: PMState,
                  params: PatchMatchParams) -> PMState:
    """Plane -> world frame + red/black strong median filter
    (DPE.cu:3214-3220)."""
    H, W = data.ref_image.shape
    state = state.replace(plane=pm.to_world_depth(data, state.plane))
    for color in (0, 1):
        new_depth = pm.median_filter_depth(data, state.plane, state.cost,
                                           state.weak)
        mask = sweep.checkerboard_mask(H, W, color, data.device) & \
            (state.weak != WEAK)
        plane = state.plane.clone()
        plane[..., 3] = torch.where(mask, new_depth, state.plane[..., 3])
        state = state.replace(plane=plane)
    return state


def _classify_stage(data: SweepData, state: PMState,
                    params: PatchMatchParams, rstat) -> PMState:
    """DepthToWeak reclassification (DPE.cu:3222)."""
    return state.replace(weak=pm.depth_to_weak(data, state, params, rstat))


def _refine_stage(data: SweepData, state: PMState, params: PatchMatchParams,
                  rstat) -> PMState:
    """LocalRefine depth polish (DPE.cu:3225)."""
    new_depth = pm.local_refine(data, state, params, rstat)
    plane = state.plane.clone()
    plane[..., 3] = new_depth
    return state.replace(plane=plane)


def run_sweep_staged(data: SweepData, state: PMState,
                     params: PatchMatchParams, *, rstat=None,
                     timer=None) -> PMState:
    """One full PatchMatch sweep: on the rectified engine with its statics
    ``rstat`` (``data.rect`` holding the rect views), else on the exact
    engine (whose bilinear corner maps are built here once).

    ``timer``: optional callable ``timer(name)`` returning a context manager
    (it is responsible for any device synchronisation), attached for the
    sweep (:func:`..utils.profiling.attach`): it times each stage and the
    weak stage's steps."""
    with profiling.attach(timer):
        if rstat is None:
            data = pm.with_corners(data)
        keys = state.key.split(32)

        def run(name, fn, *args):
            with profiling.span(name):
                return fn(*args)

        sup = pm.EMPTY_SUPPORT
        if params.use_APD or params.use_edge:
            sup, state = run("support", _support_stage, data, state,
                             keys[0], params)
        state = run("init", _init_stage, data, state, params, rstat)
        bundle = None
        if params.use_APD and rstat is not None:
            bundle = run("weakprep", _weakprep_stage, data, sup, state,
                         params, rstat)
        base_key = keys[1]
        for it in range(params.max_iterations):
            key_it = base_key.fold_in(it)
            state = run("strong", _strong_iter, data, state, it, key_it,
                        params, rstat, sup)
            if params.use_APD:
                state = run("weak", _weak_iter, data, sup, state, it,
                            key_it, params, rstat, bundle)
        # The support maps and the weak bundle serve only the iterations:
        # free them for classify's and refine's sweeps.
        del sup, bundle
        state = run("finish", _finish_stage, data, state, params)
        state = run("classify", _classify_stage, data, state, params, rstat)
        state = run("refine", _refine_stage, data, state, params, rstat)
        return state.replace(key=keys[-1])
