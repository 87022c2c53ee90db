"""The coarse-to-fine pipeline (``RunDPEPipeline``, main.cpp:474-600).

Port of :mod:`dpe_mvs_tpu.pipeline.schedule`, on either cost engine
(:func:`use_rect_engine`).
Schedule per resolution round i (scale = 2^(rounds-1-i)):
  pass A - photometric: FIRST_INIT (round 0) or REFINE_INIT;
  pass B - 3x geometric-consistency REFINE_ITER sweeps.

As in the reference, all state between sweeps lives on disk under
``<dense>/DPE/<%08d>/`` (``depths.dmb``, ``normals.dmb``, ``weak.bin``,
``selected_views.bin`` and the per-scale ``edges_<s>.dmb`` /
``labels_<s>.dmb``), in the JAX package's formats, so every sweep is
resumable. The sweeps run on ``device`` (the card unless the caller asks
for "cpu"); loading, edge extraction and the rect engine's rectification
stay on the host.
"""
from __future__ import annotations

import concurrent.futures as cf
import functools
import json
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import config
from ..config import EngineConfig, PatchMatchParams, PixelState, RunState
from ..edges import dual_level
from ..engine import rectcost
from ..engine import state as state_mod
from ..engine.stages import run_sweep_staged
from ..geometry import rectify
from ..io import formats, imread, scene
from ..utils import viz as viz_mod
from ..utils import profiling
from ..utils.profiling import GLOBAL_TIMER
from . import fusion as fusion_mod
from ..utils.rng import TorchKey

# Host-side rectification data keyed by (scene, view, size, v_pad, frame):
# the epipolar frames depend only on cameras and image size, so one build
# serves every pass of a round. Cleared at each round boundary.
_RECT_HOSTS: Dict = {}


def resolve_device(device) -> torch.device:
    """The device a sweep runs on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available")
    return device


def use_rect_engine(cfg: EngineConfig) -> bool:
    """The rectified engine unless ``cfg.use_rect`` is False (the exact
    engine); see ``config.EngineConfig.use_rect``."""
    return cfg.use_rect is not False


def pass_needs(params: PatchMatchParams) -> dict:
    """Which stored inputs a pass reads (the JAX scheduler's flags):
    priors after round 0's pass A, the weak map with the weak machinery,
    source depths in geom passes."""
    return dict(need_prior=params.state != RunState.FIRST_INIT,
                need_weak=params.use_APD,
                need_src_depths=params.geom_consistency)


def scale_index(scale_size: int) -> int:
    """s with 2**s the first power of two >= scale_size: the index of a
    round's edge and label maps."""
    s = 0
    while (1 << s) < scale_size:
        s += 1
    return s


def _rect_host(problem, inputs, v_pad: int, rect_frame=None, device=None):
    """The problem's rect host of this round (built once; its warp fields
    evaluated on ``device``)."""
    key = (str(problem.dense_folder), problem.ref_image_id, inputs.width,
           inputs.height, v_pad, rect_frame)
    rh = _RECT_HOSTS.get(key)
    if rh is None:
        rh = _RECT_HOSTS[key] = rectcost.build_rect_host(
            inputs.cameras, inputs.width, inputs.height, v_pad,
            force_size=rect_frame, device=device)
    return rh


def round_rect_frame(problems: List[scene.Problem], scale_size: int,
                     v_pad: int):
    """Common (wp, hp) rect frame for every problem of a round, from camera
    algebra alone: the largest frame any (ref, src) pair of any problem
    needs. It fixes the shapes of every sweep of the round (and so the
    numbers: a frame is where the costs are evaluated).

    Precondition: every image in the scene shares problems[0]'s size
    (:func:`scene.check_images`, run first by :func:`run_pipeline`)."""
    img0 = scene.load_image_gray(problems[0].dense_folder,
                                 problems[0].ref_image_id)
    H0, W0 = img0.shape
    cols, rows = scene.scaled_size(W0, H0, scale_size)
    sx, sy = cols / W0, rows / H0
    wp = hp = 0
    for p in problems:
        ids = [p.ref_image_id] + list(p.src_image_ids)[:v_pad]
        cams = [scene.load_camera(p.dense_folder, i).scaled(sx, sy, cols,
                                                            rows)
                for i in ids]
        ref = cams[0]
        for src in cams[1:]:
            pair = rectify.build_rect_pair(ref.K, ref.R, ref.t, src.K, src.R,
                                           src.t, cols, rows, max_scale=1.6)
            wp, hp = max(wp, pair.width), max(hp, pair.height)
    return wp, hp


def compute_round_num(problems: List[scene.Problem],
                      cfg: EngineConfig) -> int:
    img = scene.load_image_gray(problems[0].dense_folder,
                                problems[0].ref_image_id)
    return config.compute_round_num(img.shape[1], img.shape[0], cfg)


def get_problem_edges(problem: scene.Problem, scale_size: int,
                      params: PatchMatchParams) -> None:
    """Compute and cache the scale's edge and label maps
    (``GetProblemEdges``, main.cpp:331-388): ``edges_<s>.dmb`` (uint8 {0,
    255}, fine edges of the image resized to the scale) and
    ``labels_<s>.dmb`` (int32 coarse labels). With the problem's
    ``show_medium_result``, also their images ``rawedge_<s>.jpg`` and
    ``connect_<s>.jpg`` (PNG bytes)."""
    scale = scale_index(scale_size)
    rf = problem.result_folder
    img = scene.load_image_gray(problem.dense_folder, problem.ref_image_id)
    edge_path = rf / f"edges_{scale}.dmb"
    if not edge_path.exists():
        cols, rows = scene.scaled_size(img.shape[1], img.shape[0],
                                       scale_size)
        scaled = scene.resize_linear(img, cols, rows).astype(np.uint8)
        edge = dual_level.fine_edges(scaled, params.high_res_img)
        formats.write_dmb(edge_path, edge)
        if problem.show_medium_result:
            imread.write_png_gray(rf / f"rawedge_{scale}.jpg", edge)
    label_path = rf / f"labels_{scale}.dmb"
    if not label_path.exists():
        label = dual_level.coarse_labels(img.astype(np.uint8), scale,
                                         params.high_res_img)
        formats.write_dmb(label_path, label)
        if problem.show_medium_result:
            viz_mod.save_label_map(rf / f"connect_{scale}.jpg", label)


def load_support_maps(problem, scale_size: int, max_scale: int,
                      params: PatchMatchParams, width: int, height: int):
    """The round's (edge, edge_low, label) maps from the cache
    (``SupportInitialization``, DPE.cpp:1025-1052): edges and labels of the
    round's scale, nearest-rescaled to (height, width) where they differ,
    and the coarse edge map (the coarsest scale's with ``high_res_img``,
    else the round's own)."""
    scale = scale_index(scale_size)
    rf = problem.result_folder
    edge = formats.read_dmb(rf / f"edges_{scale}.dmb") > 0
    low_scale = max_scale if params.high_res_img else scale
    edge_low = formats.read_dmb(rf / f"edges_{low_scale}.dmb") > 0
    label = formats.read_dmb(rf / f"labels_{scale}.dmb").astype(np.int32)
    if edge.shape != (height, width):
        edge = scene.rescale_nearest(edge, width, height)
    if label.shape != (height, width):
        label = scene.rescale_nearest(label, width, height)
    return edge, edge_low, label


def process_problem(problem, params: PatchMatchParams, scale_size: int,
                    max_scale: int, v_pad: int, cfg: EngineConfig, *,
                    device="cuda", verbose: bool = False, inputs=None,
                    support_maps=None, rect_frame=None, timer=None):
    """One sweep over one problem (``ProcessProblem``, main.cpp:411-472).
    Returns the final PMState; the results go to ``problem.result_folder``.

    ``problem``: a ``scene.Problem`` (anything with ``dense_folder``,
    ``result_folder``, ``ref_image_id``, ``iteration`` and
    ``show_medium_result`` when inputs and maps are given; ``src_image_ids``
    too when they are loaded).
    ``scale_size`` / ``max_scale``: the round's scale and the coarsest
    round's scale index; they select the images' size and the edge and
    label maps. ``device``: where every tensor of the sweep lives (the card
    by default, "cpu" on request). ``inputs``: the problem's host inputs
    (``scene.ProblemInputs``), loaded from the dense folder when None.
    ``support_maps``: (edge, edge_low, label) for passes with the weak
    machinery or edges, read from the problem's cache
    (:func:`load_support_maps`) when None. ``cfg.use_rect`` picks the cost
    engine (:func:`use_rect_engine`); the exact engine builds no rect host.
    ``rect_frame``: optional common (wp, hp) rect frame of the rect engine.
    ``timer``: optional callable ``timer(name)`` returning a context
    manager, attached for the sweep (:func:`..utils.profiling.attach`): it
    is wrapped around the load, rectify, src-depth rectify (rect engine),
    writeback, every sweep stage and the weak stage's steps. With the problem's
    ``show_medium_result``, the written maps also go to ``depth_<it>.jpg``,
    ``normal_<it>.jpg`` and ``weak_<it>.jpg`` (PNG bytes)."""
    device = resolve_device(device)
    with profiling.attach(timer):
        t0 = time.time()
        with profiling.span("load"):
            if inputs is None:
                inputs = scene.load_problem_inputs(problem, scale_size,
                                                   **pass_needs(params))
            if not (params.use_APD or params.use_edge):
                support_maps = (None,) * 3
            elif support_maps is None:
                support_maps = load_support_maps(problem, scale_size,
                                                 max_scale, params,
                                                 inputs.width, inputs.height)
            data = state_mod.build_sweep_data(inputs, v_pad, *support_maps,
                                              device=device)
            key = TorchKey(cfg.seed + problem.ref_image_id * 1000
                           + problem.iteration, device)
            st = state_mod.init_pm_state(inputs, v_pad, key, params.use_APD,
                                         device)

        rstat = None
        if use_rect_engine(cfg):
            with profiling.span("rectify"):
                rh = _rect_host(problem, inputs, v_pad, rect_frame, device)
                views = rectcost.build_rect_views(rh, inputs.images, device)
            if params.geom_consistency and inputs.src_depths is not None:
                with profiling.span("src-depth rectify"):
                    views = rectcost.rectify_src_depths(
                        views, rh, inputs.src_depths[1:], inputs.cameras)
            data = data.replace(rect=views)
            rstat = rh.statics
        st = run_sweep_staged(data, st, params, rstat=rstat)

        with profiling.span("writeback"):
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
    if problem.show_medium_result:
        it = problem.iteration
        viz_mod.save_depth_map(rf / f"depth_{it}.jpg", depth,
                               inputs.depth_min, inputs.depth_max)
        viz_mod.save_normal_map(rf / f"normal_{it}.jpg", normal)
        viz_mod.save_weak_map(rf / f"weak_{it}.jpg", weak)
    if verbose:
        print(f"  image {problem.ref_image_id:08d} iter {problem.iteration} "
              f"({inputs.width}x{inputs.height}) done in "
              f"{time.time() - t0:.2f}s")
    return st


def export_npy(problem: scene.Problem, *, depth: bool, normal: bool,
               weak: bool, edge: bool) -> None:
    """Final .npy exports (main.cpp:99-260): ``depth.npy`` (float32, 0
    where UNKNOWN), ``normal.npy`` (float32 (H, W, 3)), ``weak.npy`` (int8:
    0 unknown, 1 weak, 2 strong), ``edge.npy`` (int8, the finest scale's
    edges)."""
    rf = problem.result_folder
    if depth:
        d = formats.read_dmb(rf / "depths.dmb").astype(np.float32)
        w = formats.read_dmb(rf / "weak.bin")
        d[w == int(PixelState.UNKNOWN)] = 0.0
        np.save(rf / "depth.npy", d)
    if normal:
        n = formats.read_dmb(rf / "normals.dmb").astype(np.float32)
        np.save(rf / "normal.npy", n)
    if weak:
        w = formats.read_dmb(rf / "weak.bin")
        enc = np.zeros(w.shape, np.int8)
        enc[w == int(PixelState.WEAK)] = 1
        enc[w == int(PixelState.STRONG)] = 2
        np.save(rf / "weak.npy", enc)
    if edge:
        for idx in range(8):
            p = rf / f"edges_{idx}.dmb"
            if p.exists():
                np.save(rf / "edge.npy",
                        (formats.read_dmb(p) > 0).astype(np.int8))
                break


def cleanup_intermediates(problems: List[scene.Problem],
                          round_num: int) -> None:
    """Delete the state files between sweeps (main.cpp:581-595) and the
    progress record."""
    if problems:
        _progress_path(problems[0].dense_folder).unlink(missing_ok=True)
    for p in problems:
        rf = p.result_folder
        for name in ("weak.bin", "depths.dmb", "normals.dmb",
                     "selected_views.bin"):
            (rf / name).unlink(missing_ok=True)
        for j in range(round_num):
            (rf / f"edges_{j}.dmb").unlink(missing_ok=True)
            (rf / f"labels_{j}.dmb").unlink(missing_ok=True)


def _progress_path(dense_folder: Path) -> Path:
    return Path(dense_folder) / "DPE" / "progress.json"


def _load_progress(dense_folder: Path) -> int:
    """Last fully completed iteration index, or -1."""
    p = _progress_path(dense_folder)
    if not p.exists():
        return -1
    try:
        return int(json.loads(p.read_text()).get("iteration", -1))
    except (ValueError, TypeError, AttributeError):
        return -1


def _save_progress(dense_folder: Path, iteration: int) -> None:
    _progress_path(dense_folder).write_text(
        json.dumps({"iteration": iteration}))


def run_pipeline(dense_folder, *, verbose: bool = True, fusion: bool = False,
                 viz: bool = False, depth: bool = True, normal: bool = False,
                 weak: bool = False, edge: bool = False,
                 cfg: Optional[EngineConfig] = None,
                 keep_intermediates: bool = False, resume: bool = False,
                 device="cuda") -> int:
    """Full pipeline (``RunDPEPipeline``, main.cpp:474-600). Returns 0 on
    success, 1 if the images are missing or differ in size. With
    ``resume=True``, iterations recorded as complete in
    ``DPE/progress.json`` are skipped (their state is in the per-view .dmb
    files). ``fusion=True`` fuses the final depth maps into
    ``DPE/DPE.ply`` (:func:`.fusion.run_fusion`, on ``device``);
    ``viz=True`` writes the debug images of every sweep and scale
    (:mod:`..utils.viz`). With ``verbose``, stage times go to
    ``utils.profiling.GLOBAL_TIMER`` (fusion as the span ``fusion``), spans
    on a card timed by CUDA events (the host is never blocked for them),
    and its summary is printed at the end; without it nothing is timed."""
    device = resolve_device(device)
    cfg = cfg or EngineConfig()
    dense_folder = Path(dense_folder)
    (dense_folder / "DPE").mkdir(parents=True, exist_ok=True)
    timer = (functools.partial(GLOBAL_TIMER.span, device=device) if verbose
             else None)
    span = timer or (lambda name: nullcontext())

    problems = scene.generate_sample_list(dense_folder, viz)
    if not scene.check_images(problems):
        print("Images may error, check it!")
        return 1
    if verbose:
        print(f"There are {len(problems)} images to be processed!")

    round_num = compute_round_num(problems, cfg)
    base = cfg.profile.apply(PatchMatchParams())
    v_pad = max(max(min(len(p.src_image_ids), cfg.max_images - 1)
                    for p in problems), 1)

    # Edges and labels for every scale first (main.cpp:494-501).
    scale_sizes = [2 ** (round_num - 1 - i) for i in range(round_num)]
    for scale_size in scale_sizes:
        with span(f"edges, scale {scale_index(scale_size)}"):
            for p in problems:
                get_problem_edges(p, scale_size, base)
    max_scale = scale_index(max(scale_sizes))

    if verbose:
        print(f"There are {round_num} resolution stages, "
              f"{round_num * 4} iterations")

    done_iter = _load_progress(dense_folder) if resume else -1
    iteration = 0
    for i, scale_size in enumerate(scale_sizes):
        # One rect frame per round, shared by every problem's sweeps.
        rect_frame = (round_rect_frame(problems, scale_size, v_pad)
                      if use_rect_engine(cfg) and len(problems) > 1
                      else None)
        for j in [None, 0, 1, 2]:
            params = config.schedule_params(base, i, j)
            if iteration > done_iter:
                t_it = time.time()
                needs = pass_needs(params)

                def load(p):
                    # All but the sources' depth maps, which the sweep
                    # running meanwhile may be writing.
                    return scene.load_problem_inputs(
                        p, scale_size, **{**needs, "need_src_depths": False})

                # The host loads the next problem's inputs (decode, resize,
                # priors) while the device sweeps the current one. A
                # geometric pass reads its sources' depth maps just before
                # its sweep, so that, as in the sequential reference, it
                # sees this iteration's map of every source swept before it.
                with cf.ThreadPoolExecutor(max_workers=1) as pool:
                    fut = pool.submit(load, problems[0])
                    for idx, p in enumerate(problems):
                        inputs = fut.result()
                        if idx + 1 < len(problems):
                            fut = pool.submit(load, problems[idx + 1])
                        if needs["need_src_depths"]:
                            with span("load"):
                                inputs = scene.add_pass_inputs(
                                    inputs, p.result_folder,
                                    scene.view_folders(p), need_prior=False,
                                    need_weak=False, need_src_depths=True)
                        p.iteration = iteration
                        process_problem(p, params, scale_size, max_scale,
                                        v_pad, cfg, device=device,
                                        verbose=verbose, inputs=inputs,
                                        rect_frame=rect_frame, timer=timer)
                _save_progress(dense_folder, iteration)
                if verbose:
                    print(f"Iteration {iteration + 1} / {round_num * 4} done "
                          f"in {time.time() - t_it:.2f}s")
            elif verbose:
                print(f"Iteration {iteration + 1} / {round_num * 4} "
                      "resumed from checkpoint")
            iteration += 1
        # Round boundary: this scale's rect hosts (warp fields of every view
        # of every problem) are never used again.
        _RECT_HOSTS.clear()

    for p in problems:
        export_npy(p, depth=depth, normal=normal, weak=weak, edge=edge)
    if fusion:
        with span("fusion"):
            fusion_mod.run_fusion(dense_folder, problems, verbose=verbose,
                                  device=device)
    if not keep_intermediates:
        cleanup_intermediates(problems, round_num)
    if verbose:
        if GLOBAL_TIMER.totals:
            print("Per-stage wall clock:\n" + GLOBAL_TIMER.summary())
        print("All done")
    return 0
