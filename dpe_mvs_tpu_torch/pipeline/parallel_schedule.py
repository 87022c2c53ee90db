"""The view-parallel pipeline: device-resident rounds sharded over ranks.

Port of :mod:`dpe_mvs_tpu.pipeline.parallel_schedule`. The reference sweeps
its problems one after another (main.cpp:508-567); here every rank of a
:class:`..parallel.mesh.ViewGroup` owns a contiguous block of problems and
keeps their inputs and state on its device for the **four passes of a
resolution round**. The geometric-consistency passes read their source
views' depth maps through :func:`..parallel.mesh.exchange_depths`, the
in-memory replacement for the reference's ``depths.dmb`` round-trip
(DPE.cpp:826-844). State returns to the host only at round edges (for the
cross-round rescale, which the reference also does on the host), where each
rank writes its own problems' ``.dmb`` files.

Cross-view semantics, as in the JAX package's parallel runner: the
reference is accidentally Gauss-Seidel (each problem reads whatever mix of
old and new depth maps is on disk, and the sequential port reads the same);
this runner is Jacobi: every sweep of pass k reads the depths of pass k-1.
Its random draws follow the JAX parallel runner's keys: pass A from
``seed + ref_id * 1000``, pass B ``j`` of round ``r`` from
``fold_in(seed, ref_id * 1000 + 4 * r + j + 1)``. Padding slots of the
problem list are zero blocks in the exchange and are never swept (the JAX
package sweeps them as copies of problem 0 because its SPMD batch must
divide the mesh), so no real problem's numbers depend on the rank count.
"""
from __future__ import annotations

import contextlib
import functools
import struct
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import config
from ..config import EngineConfig, PatchMatchParams, PixelState, RunState
from ..engine import rectcost
from ..engine import state as st_mod
from ..engine.state import PMState
from ..io import formats, scene
from ..parallel import mesh as mesh_mod
from ..utils.profiling import GLOBAL_TIMER
from ..utils.rng import TorchKey
from . import fusion as fusion_mod
from . import schedule as seq

UNKNOWN = int(PixelState.UNKNOWN)
STRONG = int(PixelState.STRONG)


def _bad_depth(depth: torch.Tensor, depth_min, depth_max) -> torch.Tensor:
    return (depth < depth_min) | (depth > depth_max) | ~torch.isfinite(depth)


def reinit_state(state: PMState, depth_min, depth_max, key,
                 use_weak: bool) -> PMState:
    """The between-pass state reset (the JAX package's ``_reinit_exec``):
    depths out of [depth_min, depth_max] or not finite become 0 and their
    pixels UNKNOWN, as ``process_problem`` sanitises before writing
    (main.cpp:423-437); without ``use_weak`` every pixel is STRONG; the
    transient fields are rebuilt as ``init_pm_state`` builds them (cost
    2.0, view weights 0, the selection kept) and the key is ``key``."""
    depth = state.plane[..., 3]
    bad = _bad_depth(depth, depth_min, depth_max)
    plane = state.plane.clone()
    plane[..., 3] = torch.where(bad, 0.0, depth)
    weak = torch.where(bad, torch.full_like(state.weak, UNKNOWN), state.weak)
    if not use_weak:
        weak = torch.full_like(weak, STRONG)
    return PMState(plane=plane, cost=torch.full_like(state.cost, 2.0),
                   selected=state.selected,
                   view_weight=torch.zeros_like(state.view_weight),
                   weak=weak, key=key)


class ParallelRunner:
    """One rank's part of the view-parallel rounds: loads, sweeps and
    writes back only its own block of ``problems``, keeping the host state
    of those problems between rounds (the cross-round checkpoint)."""

    def __init__(self, group: mesh_mod.ViewGroup,
                 problems: List[scene.Problem], v_pad: int,
                 cfg: EngineConfig, timer=None):
        self.group = group
        self.problems = problems
        self.v_pad = v_pad
        self.cfg = cfg
        self.span = timer or (lambda name: contextlib.nullcontext())
        n = len(problems)
        self.b_loc = mesh_mod.block_size(n, group)
        self.local = list(mesh_mod.local_block(n, group))
        self.src_index = np.full((self.b_loc * group.world, v_pad), -1,
                                 np.int32)
        self.src_index[:n] = mesh_mod.build_src_index(
            [p.ref_image_id for p in problems],
            [list(p.src_image_ids) for p in problems], v_pad)
        self.depth: Dict[int, np.ndarray] = {}
        self.normal: Dict[int, np.ndarray] = {}
        self.weak: Dict[int, np.ndarray] = {}
        self.selected: Dict[int, np.ndarray] = {}

    @property
    def own(self) -> List[scene.Problem]:
        return [self.problems[b] for b in self.local]

    # ------------------------------------------------------------------
    # Host <-> device boundary (round edges)
    # ------------------------------------------------------------------

    def _load_round(self, params_a: PatchMatchParams, scale_size: int,
                    max_scale: int):
        """Load this rank's problems' inputs at the round's scale onto its
        device, priors and weak maps resampled from the previous round's
        host state; once per round (the reference re-reads every pass).
        Returns (datas, states, rects), ``rects`` None on the exact
        engine."""
        dev = self.group.device
        rect = seq.use_rect_engine(self.cfg)
        frame = (seq.round_rect_frame(self.problems, scale_size, self.v_pad)
                 if rect else None)
        datas, states, rects = [], [], []
        for p in self.own:
            inputs = scene.load_problem_inputs(
                p, scale_size, need_prior=False, need_weak=False,
                need_src_depths=False)
            W, H = inputs.width, inputs.height
            rid = p.ref_image_id
            if params_a.state != RunState.FIRST_INIT and rid in self.depth:
                inputs.prior_depth = scene.rescale_nearest(
                    self.depth[rid], W, H)
                inputs.prior_normal = scene.rescale_nearest(
                    self.normal[rid], W, H)
                inputs.prior_selected_views = scene.rescale_nearest(
                    self.selected[rid], W, H)
            if params_a.use_APD and rid in self.weak:
                inputs.weak_info = scene.rescale_nearest(self.weak[rid], W, H)
            maps = seq.load_support_maps(p, scale_size, max_scale, params_a,
                                         W, H)
            data = st_mod.build_sweep_data(inputs, self.v_pad, *maps,
                                           device=dev)
            if rect:
                rh = seq._rect_host(p, inputs, self.v_pad, frame, dev)
                data = data.replace(rect=rectcost.build_rect_views(
                    rh, inputs.images, dev))
                rects.append((rh, inputs.cameras))
            datas.append(data)
            states.append(st_mod.init_pm_state(
                inputs, self.v_pad,
                TorchKey(self.cfg.seed + rid * 1000, dev),
                params_a.use_APD, dev))
        return datas, states, (rects if rect else None)

    def _writeback(self, datas, states) -> None:
        """The round's final state to the host dicts, sanitised as
        ``process_problem`` sanitises before writing its ``.dmb`` files."""
        for p, d, st in zip(self.own, datas, states):
            depth = st.plane[..., 3]
            bad = _bad_depth(depth, d.depth_min, d.depth_max)
            weak = torch.where(bad, torch.full_like(st.weak, UNKNOWN),
                               st.weak)
            rid = p.ref_image_id
            self.depth[rid] = torch.where(bad, 0.0, depth).cpu().numpy()
            self.normal[rid] = st.plane[..., :3].cpu().numpy().copy()
            self.weak[rid] = weak.cpu().numpy()
            self.selected[rid] = st.selected.cpu().numpy()

    # ------------------------------------------------------------------
    # One resolution round, device-resident
    # ------------------------------------------------------------------

    def run_round(self, round_idx: int, scale_size: int, max_scale: int,
                  base: PatchMatchParams, verbose: bool = False) -> None:
        span = self.span
        params_a = config.schedule_params(base, round_idx, None)
        with span("load"):
            datas, states, rects = self._load_round(params_a, scale_size,
                                                    max_scale)
        dev = self.group.device
        # Every image shares problem 0's size (scene.check_images).
        img0 = scene.load_image_gray(self.problems[0].dense_folder,
                                     self.problems[0].ref_image_id)
        W, H = scene.scaled_size(img0.shape[1], img0.shape[0], scale_size)
        for j in [None, 0, 1, 2]:
            params = config.schedule_params(base, round_idx, j)
            t0 = time.time()
            if j is not None:
                # Between-pass reset, then the exchange of the sanitised
                # depths (the reference reads the sanitised .dmb files).
                with span("reinit"):
                    states = [reinit_state(
                        st, d.depth_min, d.depth_max,
                        TorchKey(self.cfg.seed, dev).fold_in(
                            p.ref_image_id * 1000 + 4 * round_idx + j + 1),
                        params.use_APD)
                        for p, d, st in zip(self.own, datas, states)]
                with span("exchange"):
                    local = torch.zeros((self.b_loc, H, W),
                                        dtype=torch.float32, device=dev)
                    for k, st in enumerate(states):
                        local[k] = st.plane[..., 3]
                    src = mesh_mod.exchange_depths(self.group, local,
                                                   self.src_index)
                datas = [d.replace(src_depths=src[k])
                         for k, d in enumerate(datas)]
            with span("sweep"):
                states = mesh_mod.sharded_sweep(self.group, datas, states,
                                                params, rects)
            if verbose:
                dt = time.time() - t0
                print(f"  round {round_idx} pass "
                      f"{'A' if j is None else f'B{j}'}: {len(states)} "
                      f"problems on rank {self.group.rank} in {dt:.2f} s")
        with span("writeback"):
            self._writeback(datas, states)
        seq._RECT_HOSTS.clear()

    def flush_to_disk(self) -> None:
        """Write this rank's problems' checkpoint files (the reference's
        per-view state files)."""
        for p in self.own:
            rf = p.result_folder
            rid = p.ref_image_id
            formats.write_dmb(rf / "depths.dmb", self.depth[rid])
            formats.write_dmb(rf / "normals.dmb", self.normal[rid])
            formats.write_dmb(rf / "weak.bin", self.weak[rid])
            formats.write_dmb(rf / "selected_views.bin", self.selected[rid])

    def load_from_disk(self) -> bool:
        """Reload this rank's host round state from the checkpoint files
        (resume). Returns False if a file is missing or unreadable."""
        for p in self.own:
            rf = p.result_folder
            rid = p.ref_image_id
            try:
                self.depth[rid] = formats.read_dmb(
                    rf / "depths.dmb").astype(np.float32)
                self.normal[rid] = formats.read_dmb(
                    rf / "normals.dmb").astype(np.float32)
                self.weak[rid] = formats.read_dmb(
                    rf / "weak.bin").astype(np.uint8)
                self.selected[rid] = formats.read_dmb(
                    rf / "selected_views.bin").astype(np.int32)
            except (OSError, ValueError, KeyError, struct.error):
                return False
        return True


def run_pipeline_parallel(
    dense_folder,
    *,
    group: Optional[mesh_mod.ViewGroup] = None,
    verbose: bool = True,
    fusion: bool = False,
    viz: bool = False,
    depth: bool = True,
    normal: bool = False,
    weak: bool = False,
    edge: bool = False,
    cfg: Optional[EngineConfig] = None,
    keep_intermediates: bool = False,
    resume: bool = False,
    device="cuda",
) -> int:
    """The view-parallel ``run_pipeline``, one call on every rank of
    ``group`` (default: :func:`..parallel.mesh.make_group` of ``device``,
    every rank of the default process group). Returns 0 on success, 1 if
    the images are missing or differ in size.

    Every rank builds its own problems' edge and label maps, runs the
    rounds on its block, and exports its problems' maps. ``fusion=True``:
    rank 0 runs the single-device ``fusion.run_fusion`` on its device while
    the others wait (as the JAX package does, ROADMAP queue 3).
    ``resume=True`` resumes at *round* granularity: each completed round is
    checkpointed to the ``.dmb`` files plus ``DPE/progress.json``
    (iteration ``4 * (round + 1) - 1``), written by rank 0 after a barrier,
    and completed rounds are skipped by reloading that state on every rank.
    With ``verbose``, stage spans (``load``, ``reinit``, ``exchange``,
    ``sweep``, ``writeback``, ``fusion``) go to
    ``utils.profiling.GLOBAL_TIMER``, whose summary rank 0 prints at the
    end; without it nothing is timed."""
    cfg = cfg or EngineConfig()
    if group is None:
        group = mesh_mod.make_group(device)
    dense_folder = Path(dense_folder)
    (dense_folder / "DPE").mkdir(parents=True, exist_ok=True)
    timer = (functools.partial(GLOBAL_TIMER.span, device=group.device)
             if verbose else None)
    span = timer or (lambda name: contextlib.nullcontext())
    problems = scene.generate_sample_list(dense_folder, viz)
    if not scene.check_images(problems):
        print("Images may error, check it!")
        return 1
    round_num = seq.compute_round_num(problems, cfg)
    base = cfg.profile.apply(PatchMatchParams())
    v_pad = max(max(min(len(p.src_image_ids), cfg.max_images - 1)
                    for p in problems), 1)

    runner = ParallelRunner(group, problems, v_pad, cfg, timer)
    scale_sizes = [2 ** (round_num - 1 - i) for i in range(round_num)]
    for scale_size in scale_sizes:
        with span(f"edges, scale {seq.scale_index(scale_size)}"):
            for p in runner.own:
                seq.get_problem_edges(p, scale_size, base)
    max_scale = seq.scale_index(max(scale_sizes))
    if verbose and group.rank == 0:
        print(f"{len(problems)} problems over {group.world} ranks "
              f"({runner.b_loc} per rank), {round_num} rounds")

    done_iter = seq._load_progress(dense_folder) if resume else -1
    done_rounds = (done_iter + 1) // 4
    if done_rounds > 0 and not runner.load_from_disk():
        done_rounds = 0
    # Every rank resumes alike (and has read progress.json before rank 0
    # writes it again).
    done_rounds = mesh_mod.agree_min(group, done_rounds)

    for i, scale_size in enumerate(scale_sizes):
        if i < done_rounds:
            if verbose and group.rank == 0:
                print(f"Round {i + 1} / {round_num} resumed from checkpoint")
            continue
        runner.run_round(i, scale_size, max_scale, base, verbose)
        runner.flush_to_disk()
        mesh_mod.barrier(group)
        if group.rank == 0:
            seq._save_progress(dense_folder, 4 * (i + 1) - 1)
            if verbose:
                print(f"Round {i + 1} / {round_num} done")
    for p in runner.own:
        seq.export_npy(p, depth=depth, normal=normal, weak=weak, edge=edge)
    mesh_mod.barrier(group)
    if fusion and group.rank == 0:
        with span("fusion"):
            fusion_mod.run_fusion(dense_folder, problems, verbose=verbose,
                                  device=group.device)
    mesh_mod.barrier(group)
    if not keep_intermediates:
        seq.cleanup_intermediates(runner.own, round_num)
    if verbose and group.rank == 0:
        print("Per-stage wall clock:\n" + GLOBAL_TIMER.summary())
        print("All done")
    return 0
