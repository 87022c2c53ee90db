"""One sweep over one problem, with writeback.

Port of :func:`dpe_mvs_tpu.pipeline.schedule.process_problem` on the
rectified engine, for every pass of the schedule: round-0 pass A, pass A of
later rounds (REFINE_INIT, weak machinery and edges) and pass B (REFINE_ITER
with geometric consistency). As in the reference, the sweep's results go to
``<result_folder>/`` as ``depths.dmb``, ``normals.dmb``, ``weak.bin`` and
``selected_views.bin`` (readable by the JAX package's ``export_npy``), and a
later pass reads its priors and its source views' depths back from there
(:func:`add_pass_inputs`).

The problem argument is duck-typed: it needs ``result_folder``,
``ref_image_id`` and ``iteration``. Inputs and support maps are supplied in
memory: loading a dense folder (images through OpenCV, the edge and label
maps of ``edges/dual_level``) belongs to the pipeline slice.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..config import EngineConfig, PatchMatchParams, PixelState, RunState
from ..engine import rectcost
from ..engine import state as state_mod
from ..engine.stages import check_engine, run_sweep_staged
from ..io import formats
from ..utils.rng import TorchKey


@dataclasses.dataclass
class Problem:
    """The fields of the JAX package's ``io.scene.Problem`` a sweep needs."""

    result_folder: Path
    ref_image_id: int
    iteration: int = 0


def resolve_device(device) -> torch.device:
    """The device a sweep runs on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    return device


def rescale_nearest(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nearest-neighbour rescale of priors between rounds
    (``RescaleMatToTargetSize``, DPE.cpp:1146-1168), as the JAX package's
    ``io.scene.rescale_nearest``."""
    if src.shape[1] == width and src.shape[0] == height:
        return src
    r_idx = np.minimum(
        (np.arange(height) * (src.shape[0] / height)).astype(np.int64),
        src.shape[0] - 1)
    c_idx = np.minimum(
        (np.arange(width) * (src.shape[1] / width)).astype(np.int64),
        src.shape[1] - 1)
    return src[np.ix_(r_idx, c_idx)]


def add_pass_inputs(inputs, result_folder, view_folders: Sequence, *,
                    need_prior: bool, need_weak: bool,
                    need_src_depths: bool):
    """The inputs of a later pass, as the JAX package's
    ``load_problem_inputs`` assembles them (``io/scene.py:201-222``): the
    prior depth, normal and selected views and the weak map from the
    problem's own ``result_folder``, and the depth map of every view of the
    problem (``view_folders``: the result folders of [ref, src...]; zeros
    where a view has none yet), each rescaled to the inputs' size."""
    W, H = inputs.width, inputs.height
    out = dataclasses.replace(inputs)
    rf = Path(result_folder)
    if need_prior:
        out.prior_depth = rescale_nearest(
            formats.read_dmb(rf / "depths.dmb").astype(np.float32), W, H)
        out.prior_normal = rescale_nearest(
            formats.read_dmb(rf / "normals.dmb").astype(np.float32), W, H)
        out.prior_selected_views = rescale_nearest(
            formats.read_dmb(rf / "selected_views.bin").astype(np.int32),
            W, H)
    if need_weak:
        out.weak_info = rescale_nearest(
            formats.read_dmb(rf / "weak.bin").astype(np.uint8), W, H)
    if need_src_depths:
        depths = []
        for folder in view_folders:
            p = Path(folder) / "depths.dmb"
            d = (formats.read_dmb(p).astype(np.float32) if p.exists()
                 else np.zeros((H, W), np.float32))
            depths.append(rescale_nearest(d, W, H))
        out.src_depths = np.stack(depths, axis=0)
    return out


def process_problem(problem, params: PatchMatchParams, scale_size: int,
                    max_scale: int, v_pad: int, cfg: EngineConfig, *,
                    device="cuda", verbose: bool = False, inputs=None,
                    support_maps=None, rect_frame=None, timer=None):
    """One sweep over one problem (``ProcessProblem``, main.cpp:411-472).
    Returns the final PMState.

    ``device``: where every tensor of the sweep lives (the card by default,
    "cpu" on request). ``inputs``: the problem's host inputs
    (``state.ProblemInputs``; for later passes with priors, weak map and
    source depths, see :func:`add_pass_inputs`). ``support_maps``: the
    (edge, edge_low, label) maps of passes with the weak machinery or edges;
    pass A of round 0 reads none. ``scale_size`` / ``max_scale`` select the
    round's maps when loading a folder. ``rect_frame``: optional common
    (wp, hp) rect frame. ``timer``: optional callable ``timer(name)``
    returning a context manager, wrapped around the load, rectify,
    src-depth rectify, writeback and every sweep stage."""
    if inputs is None:
        raise NotImplementedError(
            "loading a problem from its dense folder (images, cameras and "
            "the edge and label maps) is not ported yet: it arrives with "
            "slice 3 (the pipeline); pass the inputs in memory")
    needs_maps = params.use_APD or params.use_edge
    if needs_maps and support_maps is None:
        raise ValueError("this pass reads the edge and label maps: pass "
                         "support_maps=(edge, edge_low, label)")
    check_engine("rect")
    device = resolve_device(device)
    span = timer if timer is not None else (lambda name: nullcontext())
    t0 = time.time()
    with span("load"):
        edge, edge_low, label = support_maps if needs_maps else (None,) * 3
        data = state_mod.build_sweep_data(inputs, v_pad, edge, edge_low,
                                          label, device=device)
        key = TorchKey(cfg.seed + problem.ref_image_id * 1000
                       + problem.iteration, device)
        st = state_mod.init_pm_state(inputs, v_pad, key, params.use_APD,
                                     device)

    with span("rectify"):
        rh = rectcost.build_rect_host(inputs.cameras, inputs.width,
                                      inputs.height, v_pad,
                                      force_size=rect_frame)
        views = rectcost.build_rect_views(rh, inputs.images, device)
    if params.geom_consistency and inputs.src_depths is not None:
        with span("src-depth rectify"):
            views = rectcost.rectify_src_depths(
                views, rh, inputs.src_depths[1:], inputs.cameras)
    data = data.replace(rect=views)
    st = run_sweep_staged(data, st, params, rstat=rh.statics, timer=timer)

    with span("writeback"):
        plane = st.plane.cpu().numpy()
        depth = plane[..., 3].copy()
        normal = plane[..., :3].copy()
        weak = st.weak.cpu().numpy().copy()
        out_of_range = (depth < inputs.depth_min) | \
            (depth > inputs.depth_max) | ~np.isfinite(depth)
        depth[out_of_range] = 0.0
        weak[out_of_range] = int(PixelState.UNKNOWN)

        rf = Path(problem.result_folder)
        rf.mkdir(parents=True, exist_ok=True)
        formats.write_dmb(rf / "depths.dmb", depth.astype(np.float32))
        formats.write_dmb(rf / "normals.dmb", normal.astype(np.float32))
        formats.write_dmb(rf / "weak.bin", weak.astype(np.uint8))
        formats.write_dmb(rf / "selected_views.bin",
                          st.selected.cpu().numpy().astype(np.int32))
    if verbose:
        print(f"  image {problem.ref_image_id:08d} iter {problem.iteration} "
              f"({inputs.width}x{inputs.height}) done in "
              f"{time.time() - t0:.2f}s")
    return st


def pass_needs(params: PatchMatchParams) -> dict:
    """Which stored inputs a pass reads (the JAX scheduler's flags):
    priors after round 0's pass A, the weak map with the weak machinery,
    source depths in geom passes."""
    return dict(need_prior=params.state != RunState.FIRST_INIT,
                need_weak=params.use_APD,
                need_src_depths=params.geom_consistency)
