"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

An 800x600 scene with 6 views (5 source views per problem), rendered in
memory from a seed, first through single sweeps of
``dpe_mvs_tpu_torch.pipeline.schedule.process_problem``: round-0 pass A for
all 6 problems, then the modal pass B (``schedule_params(base, 1, 0)``:
REFINE_ITER, weak machinery, edges and geometric consistency) for all 6,
reading each problem's priors and its sources' depths back from the pass-A
writeback; then written to a dense folder and run through the whole
pipeline by the CLI, as a user runs it; then frames of 1600x1200 and
6048x4032 (phase 12), the ETH3D final round through ``dpe_mvs`` on two
of the 6048x4032 views (phase 14) and the weak stage's cost kernel at the
benchmark cell's frame (phase 15); last, the weak-path envelope of
``tools/torch_weak_compare.py`` (phase 13). Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build the kernels from ``dpe_mvs_tpu_torch/csrc`` (one nvcc per source,
     all at once: the row kernels, the gathers and the weak stage's cost
     kernel ``weakcost``);
  3. each kernel against its plain PyTorch version on the card, bit-exact,
     at ragged shapes and in every branch of the row kernels' launch plan
     (rows W in {1, 2, 3, 800, 1024, 70001}, L ragged and aligned, H = 70001,
     inputs at a 4-byte offset, staged and unstaged, the widest staged rows
     (W = 6140, 48 KB of shared memory) and the first too wide (W = 6144), a
     tall staged launch (H = 12672), uint32 words with NaN payloads, +-inf
     columns) and of the three gather2d entries: gather2d in both of the
     JAX package's size regimes, C in {1, 3, 6, 9, 17}, clustered and
     scattered queries, inputs at a 4-byte offset; gather2d_hwc at C in
     {1, 2, 3, 4, 6, 16} over bool, uint8 and 32-bit words, at a 4-byte
     offset and on strided views; gather2d_pick with channels out of
     range. gather2d timed at the > 6 MB-per-channel case (row 4);
  4. render the scene;
  5. pass A, all problems, with the launch counters set to 0 just before and
     read just after; row_gather and bilinear_x must have launched, and
     none of the gather2d entries (pass A has no weak machinery);
  6. problem 0 after pass A, read back through the port's ``io.formats``:
     median relative depth error < 2% and valid share > 50%;
  7. pass B, all problems (edge and label maps from the in-memory stand-in
     ``utils.synthetic.support_maps``), counters set to 0 just before and
     read just after; every kernel must have launched; the weak share
     before pass B must be > 0; the weak stage's entry ``weak_cost`` is
     checked bit for bit against its plain version at the first launch of
     each shape (:class:`FirstLaunchCheck`); problem 0 must meet the same bar and be no
     worse than its pass-A error + 0.003. (Each sweep of phases 5-8 builds
     its rect host anew, as it did before the pipeline cached them per
     round);
  8. each kernel against its plain version again, bit-exact, on the inputs
     captured from the pass-A and pass-B runs. At each run's dominant shape
     the kernel (row_gather and bilinear_x: both variants, unstaged and
     staged), its plain version and one PyTorch library call are timed in
     turns (ABBA), each launch by its own event pair, median of REPS
     launches, L2-cold (a 256 MB scratch buffer written and read before every
     launch) and warm, beside the bound (the larger of the bytes over
     3.35 TB/s and the float32 operations over 67 TFLOP/s), the same bound
     with touched image words counted in whole 32-byte sectors, and the
     launch floor (the same kernel on one row of 4 outputs). Per sweep: the
     sum over every captured shape of problem 0's launches x the kernel's
     cold time, beside the same sum of bounds; for the row kernels both
     variants at every shape, in turns with a second copy of the unstaged
     one (their difference is the timing noise), and the sweep's time for
     each choice of the plan's staging threshold; gather2d_hwc and
     gather2d_pick in turns with
     the routes gather_map and the line-of-sight test took before them
     (old_gather_map, old_free_at). Then launches per sweep, and the warm
     time of one more pass-B sweep with a synchronised per-stage breakdown
     and the peak device memory;
  9. the pipeline: the first PIPELINE_VIEWS (3) views of the scene (a cut
     of depth that pays for phase 12c) written to a dense folder
     (``utils.synthetic.write_scene_folder``, PNG bytes) and run in-process
     by ``dpe_mvs_tpu_torch.cli.main([folder, "0", "1", "0", "1", "1", "1",
     "1", "1"])`` (card 0, verbose, no viz, fusion, all four exports): the
     schedule's 2 rounds (400x300, then 800x600), 8 iterations of 3 sweeps,
     with the dual-level edge and label maps of ``edges/dual_level``, then
     fusion of the 3 depth maps into ``DPE/DPE.ply`` on the card. Counters
     set to 0 just before and read just after; all five kernel entries must
     have launched; fusion must have launched ``gather2d_hwc`` 3 times per
     (reference, source) pair and nothing else; problem 0's ``depth.npy``
     must meet the bar of phase 6; every problem's four exports must exist
     with the JAX package's dtypes and shapes; ``DPE.ply`` must read back
     through ``io.formats.read_ply`` with more than 100 000 points and a
     precision above 0.9 against the analytic plane at tau = 0.005 x the
     median ground-truth depth (``tools/torch_eval.fscore``), and differ
     in at most 0.01% of its points from the cloud the same fusion gives on
     the CPU from a copy of the state; the intermediate files must be gone; neither cv2 nor jax may be loaded;
     each kernel must be bit-exact against its plain version at every shape
     the run gave it, fusion's among them (the first inputs of each shape
     captured as in phases 5 and 7). Fusion's gather2d_hwc shapes are timed
     (kernel, plain version and library call in turns, L2-cold) and summed
     over its launches. Prints seconds per iteration, the sweep loop's and
     fusion's seconds apart, the per-stage summary
     (``utils.profiling.GLOBAL_TIMER``, spans timed by CUDA events),
     edge-extraction seconds per scale, problem 0's edge and label shares
     per scale, launches per kernel entry per round and in fusion, the peak
     device memory (captured inputs included, their bytes beside it), every
     problem's depth error and the cloud's point count, precision, recall
     and F-score;
 10. the exact engine (``EngineConfig(use_rect=False)``: per-pixel
     homography NCC, every 2-D gather through ``gather2d_hwc``) on the same
     scene, in memory through ``process_problem``:
     a. round-0 pass A for all problems, counters set to 0 just before and
        read just after: gather2d_hwc must have launched and row_gather and
        bilinear_x must not have (the exact engine does not rectify; a call
        fails the phase with its call site); problem 0 meets the bar of
        phase 6;
     b. the modal pass B on that writeback (the stand-in support maps of
        phase 7), for problem 0, then for the rest if the script is
        projected to end within EXACT_BUDGET_S (it prints which ran):
        gather2d_hwc and gather2d_pick must have launched; problem 0 no
        worse than its 10a error + 0.003, valid > 50%;
     c. every kernel entry bit-exact against its plain version at every
        shape 10a and 10b gave it (captured as in phases 5 and 7); for
        gather2d_hwc (A and B) and gather2d_pick (B) the three shapes that
        move the most elements per sweep timed in turns with the library
        call and the plain version (L2-cold), and every shape's cold time x
        problem 0's launches summed per sweep beside the bounds;
     d. problem 0's warm pass-A and pass-B sweeps on each engine in turns,
        SIDE_PAIRS pairs per pass (the rect engine rebuilding its rect host
        as in phases 5-8): median seconds, synchronised per-stage spans,
        launches per kernel entry, peak device memory (no capture; beside
        it what was allocated before the sweep) and the median relative
        depth error, printed as one JSON line
        (``engines_side_by_side``);
 11. the view-parallel path (``pipeline.parallel_schedule``,
     ``parallel.mesh``, ``parallel.tiles``) over a one-rank NCCL group the
     phase makes on a local rendezvous and destroys at its end (one card:
     NCCL refuses two ranks on one device, so every collective has one
     rank):
     a. ``run_pipeline_parallel`` with fusion on a dense folder of the first
        PARALLEL_VIEWS (3) views of the scene, phase 9's (2 rounds of 4
        passes over 3 problems, the state on the card for a round, the
        exchange between passes; a cut of depth that pays for phase 12),
        counters set to
        0 just before and read just after, inside :class:`Capture`: all five
        kernel entries must have launched; seconds per pass and in all, the
        runner's spans (load, reinit, exchange, sweep, writeback, fusion),
        launches per round, peak memory, problem 0's depth error and valid
        share (phase 9's bar) and the cloud's points, precision and recall
        (phase 9's bars), each beside phase 9's number (the runners draw
        other keys and read depths otherwise, so never bit for bit);
     b. ``fusion.run_fusion_mesh`` on 11a's maps: its point count within 1%
        of ``run_fusion``'s (11a's cloud), its seconds and vote passes, and
        the JAX package's two-pass schedule (``max_passes=2``) beside it;
     c. ``parallel.tiles.tile_sharded_sweep`` with one tile (one card) on
        problem 0's pass A, beside the unsharded sweep, held to
        ``tests/test_tiles.py``'s bars (median < 0.01; tile median <
        max(2 x unsharded, 0.01)).
     Every kernel entry bit-exact against its plain version at every shape
     11a-c gave it; their numbers beside phase 9's as one JSON line
     (``parallel_vs_sequential``);
 12. full-resolution frames (run after phase 9, before phase 10, so that
     its time counts in 10b's projection), through ``process_problem``:
     a. ``make_plane_scene(width=1600, height=1200, num_views=6, seed=7)``
        (the final round of a 2-round schedule): round-0 pass A for all six
        problems, then the modal pass B of problem 0 on that writeback with
        the stand-in support maps of phase 7;
     c. the final round of an ETH3D frame, 6048x4032 (``compute_round_num``
        gives 4 rounds; round 3 sweeps the full frame; the six views
        rendered in threads): problem 0's round-3 modal pass B
        (``schedule_params(base, 3, 0)``: REFINE_ITER with the weak
        machinery, edges and geometric consistency) on its ground truth at
        the full frame written as its previous writeback
        (``utils.synthetic.write_coarse_priors``: every pixel STRONG), the
        sources' depth maps their ground truth written as their
        ``depths.dmb``, with the stand-in support maps (the weak machinery's
        worst case for memory), on the default CUDA allocator
        (``PYTORCH_CUDA_ALLOC_CONF`` must be unset).
     (12b, 3200x2400, was dropped for time: 12c takes every branch it took.
     12c's pass A was dropped for time too: ``tools/torch_final_round.py``
     sweeps round 3's pass A through the round loop, and
     ``tools/torch_probe.py 6048 4032 6 apd geom --round 3`` keeps both
     passes of problem 0.)
     Per sweep: seconds, synchronised stage spans, launches per kernel
     entry, the full-resolution branches taken
     (``utils.profiling.BRANCHES``), the memory allocated and free before it,
     its peak (``max_memory_allocated``, reset before each sweep) and each
     stage's peak (reset as each stage starts) with the stage that sets the
     sweep's. Counters set to 0 before each pass and read after it. Bars:
     problem 0 meets phase 6's bar after pass A and phase 7's after pass B;
     pass A launches both row kernels, pass B all five entries; 12a's pass
     B streams its anchor profiles (``AP_STORE_MAX_PX``), regathers ``a_d0``
     (``A_D0_STORE_MAX_PX``) and bands the weak body (``_weak_band_count``
     > 1); at 6048x4032 pass B takes these and also stores bf16 screening
     volumes, scans its view-selection draws (``patchmatch.FULLRES_PX``),
     bands the rect cost field (``rectcost.band_rows``), the anchor search
     (``anchors.BAND_BYTES``) and classify's analysis, and chunks the
     disparity sweeps (``patchmatch.SWEEP_CHUNK_BYTES``); ``gather2d``
     reads a channel over 6 MiB (TPU kernel row 4's regime). Every kernel
     entry, ``weak_cost`` among them, is compared bit for bit with its plain
     version at the first launch of each shape (:class:`FirstLaunchCheck`:
     no copies kept, unlike :class:`Capture`; the comparisons kept out of
     the peaks); 12c times ``weak_cost``'s first launch of each mode (the
     final round's band of 42 x 6048 sites) as phase 15 does; and row 4's
     real shape is timed (kernel, library call, plain version in turns,
     L2-cold) beside its bound, its inputs copied to host memory at their
     launch so that pass B's peak is the sweep's own. Every sweep sweeps in
     the rect frame the round loop gives every problem of the round
     (``schedule.round_rect_frame`` on the scene written as a dense folder:
     7296x6456 at 6048x4032, where problem 0's own is 6528x6456), and every
     sweep's peak must be under PEAK_LIMIT_MIB (57220). One JSON line
     (``fullres``) before the kernels line;
 14. the ETH3D final round through the round loop (run right after phase
     12, on 12c's scene): ``tools/torch_final_round.run`` in-process on the
     first FINAL_VIEWS (2) views of 12c's 6048x4032 scene (two problems,
     each the other's source), resumed after FINAL_RESUME (14): the dense
     folder written, every problem's ground truth at the full frame written
     as iteration 14's state with ``DPE/progress.json``, then
     ``api.dpe_mvs(folder, resume=True, fusion=True, depth, normal, weak,
     edge)`` on the card: the edge and label maps of all four scales,
     round 3's last pass B (problem 1 reads problem 0's map of this
     iteration), the exports, fusion to ``DPE/DPE.ply`` and the cleanup,
     inside :class:`FirstLaunchCheck` (every entry bit-exact at the first
     launch of each shape, fusion's ``gather2d_hwc`` at 6048x4032 among
     them, and ``weak_cost``). Counters set to 0 just before the run and read
     just after: all six entries must have launched, fusion ``gather2d_hwc``
     3 times per
     (reference, source) pair. Bars: every problem's median relative depth
     error < 0.02 and valid share > 0.5, more than 100 000 points with
     precision > 0.9 (``tools/torch_eval.fscore``, tau = 0.005 x the median
     depth), every sweep's peak under PEAK_LIMIT_MIB (57220). Fusion's
     ``gather2d_hwc`` shapes timed (kernel, library call, plain version in
     turns, L2-cold) beside their bounds. One JSON line (``final_round``:
     the tool's record and those timings);
 15. the weak stage's cost kernel at the benchmark cell's frame
     (CELL_FRAME: eth3d-r1.passB's 1512x1008, 6 views, round 1):
     ``tools/torch_probe.py``'s sweeps in-process (round 1's REFINE_INIT
     pass A from the ground truth at half size, then its modal pass B with
     the geometric term; 7 weak bands of 144 rows, streamed anchor
     profiles) inside :class:`FirstLaunchCheck` on ``weak_cost``: every
     shape's first launch bit-exact against the plain version, and each
     mode's first launch (cost, term, cost + factor x term) timed: the
     kernel (into a spare output) and the plain version in turns, each call
     by its own event pair, median of REPS, warm and L2-cold, beside the
     bound (``ops/weakcost.site_bytes`` a site over 3.35 TB/s). Bar: 15
     launches a band body in pass A and 23 in pass B (42 band bodies a
     sweep);
 13. the weak-path envelope (cell ``weak-envelope-800x600x6``):
     ``tools/torch_weak_compare.py`` on problem 0 of its own 800x600x6 scene
     (``make_plane_scene(seed=17, weak_patch=True)``, its images as the
     JAX tool's JPEG q98 files decode, its real dual-level edge and label
     maps), a FIRST_INIT sweep then an APD + edge
     REFINE_INIT sweep on the rect engine, then the same on the exact
     engine, in one process, inside :class:`FirstLaunchCheck` (every entry
     bit-exact at the first launch of each shape); counters set to 0 before
     each run and read after it: the rect run must launch all six entries,
     the exact run ``gather2d_hwc`` and ``gather2d_pick`` and no row
     kernel. Then the tool's ``compare`` of the two ``.npz`` files. Bars:
     both engines median relative depth error < 0.02 and valid share > 0.5
     (the ratio of their weak fractions is a finding, not a bar). One JSON
     line (``weak_envelope``): per engine median error, inliers at 1%,
     valid share, weak fraction and seconds, the interior weak-label
     agreement and the ratio of the weak fractions (rect / exact).

Exits non-zero, without the result lines, when there is no CUDA device or
any phase fails. The line before the last holds the kernel records as JSON
(``launches``: the pipeline's, fusion's included; ``launches_by_path``:
every path's, the exact engine's passes as "exact pass A" / "exact pass B",
phase 11's as "parallel pipeline" (and per round), "mesh fusion" and "tile
sweep", phase 12's as "fullres <frame> pass A" / "... pass B", phase
14's as "final round" and "final round fusion", phase 13's as "weak
compare rect" / "weak compare exact"; ``gather2d`` adds
``row4_real_paths``, row 4's real shapes timed in phase 12;
``gather2d_hwc`` adds ``final_round_fusion``, phase 14's fusion shapes;
``exact``: phase 10c's timings; ``weakcost``: the cost mode's times at the
cell's band, and ``bands``, every mode's at the cell's band (phase 15) and
the final round's (12c)); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

W, H, VIEWS = 800, 600, 6
SEED = 7
REPS = 60                          # launches per timed function (median)
SWEEP_REPS = 50                    # launches per captured shape (per sweep)
EXACT_BUDGET_S = 800               # phase 10b runs every problem if the
                                   # script is projected to stay under
                                   # this in all (phase 11 included)
SIDE_PAIRS = 3                     # phase 10d: (rect, exact) pairs per pass
PIPELINE_VIEWS = 3                 # phase 9: views of the scene (time)
PARALLEL_VIEWS = 3                 # phase 11a-b: views of the scene
ENVELOPE_S = 90                    # phase 13's budget (s)
# Staging thresholds whose per-sweep time phase 8 reports: the plan stages
# where L >= r * W (inf: never).
REUSE_CHOICES = (0.25, 0.5, 1, 2, 4, 8, 16, float("inf"))
GATHERS = ("gather2d", "gather2d_hwc", "gather2d_pick")
FLUSH_BYTES = 256 * 2**20          # > 5x the 50 MB L2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
# Phase 12: (sub-phase, width, height, round). 12a sweeps round 0 (and the
# modal pass B of round 1) at the size of a 2-round schedule's final round;
# 12c the modal pass B of round 3 of an ETH3D frame, its final round. 12b
# (3200x2400) was dropped for time: 12c takes every branch it took
# (FULLRES_BRANCHES).
FULLRES = (("a", 1600, 1200, 0), ("c", 6048, 4032, 3))
FULLRES_BRANCHES = ("bf16 screening", "scanned draws",
                    "banded cost evaluations", "streamed anchor profiles",
                    "regathered a_d0", "weak bands", "anchor-search bands",
                    "disparity-sweep chunks", "classify bands")
PEAK_LIMIT_MIB = 57220             # a sweep's device peak at large frames
# Phase 14: the final round through the round loop on the first FINAL_VIEWS
# views of 12c's scene, resumed after FINAL_RESUME (before round 3's last
# pass B).
FINAL_VIEWS = 2
FINAL_RESUME = 14
ROW4_CHANNEL_BYTES = 6 * 2**20     # the JAX package's gather2d switches to
                                   # its HBM kernel (TPU row 4) above this
F32_OPS_PER_S = 67e12              # float32 outside the tensor cores (same)
# Phase 15: the benchmark cell eth3d-r1.passB's frame (width, height, views,
# round).
CELL_FRAME = (1512, 1008, 6, 1)
SOURCES = {"row_gather": "dpe_mvs_tpu_torch/csrc/rowgather.cu",
           "bilinear_x": "dpe_mvs_tpu_torch/csrc/rowgather.cu",
           **{n: "dpe_mvs_tpu_torch/csrc/gather2d.cu" for n in GATHERS},
           "weakcost": "dpe_mvs_tpu_torch/csrc/weakcost.cu"}
_G2D_TPU = ("dpe_mvs_tpu/ops/gather2d.py:86 (_gather2d_vmem_kernel) and "
            "dpe_mvs_tpu/ops/gather2d.py:127 (_gather2d_kernel)")
REPLACES = {"row_gather": "dpe_mvs_tpu/ops/rowgather.py:59",
            "bilinear_x": "dpe_mvs_tpu/ops/rowgather.py:122",
            "gather2d": _G2D_TPU,
            "gather2d_hwc": _G2D_TPU + " as reached by "
                            "dpe_mvs_tpu/ops/sampling.py:82 gather_map",
            "gather2d_pick": _G2D_TPU + " as reached by "
                             "dpe_mvs_tpu/ops/support.py:308 "
                             "LineOfSight.crossing free_at",
            "weakcost": "none: the elementwise chain XLA fuses for "
                        "dpe_mvs_tpu/engine/weak_rect.py deformable_cost_rect"
                        " and geom_term_rect"}
LIBRARY = {"row_gather": "torch.gather, int64 index pre-clamped",
           "bilinear_x": "torch.nn.functional.grid_sample (bilinear, "
                         "border, align_corners) on a precomputed grid",
           "gather2d": "advanced indexing imgs[:, iy, ix], int64 indices "
                       "pre-clamped",
           "gather2d_hwc": "advanced indexing arr[iy, ix] on (H, W, C), "
                           "int64 indices pre-clamped",
           "gather2d_pick": "advanced indexing imgs[ic, iy, ix], int64 "
                            "indices pre-clamped"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


class Capture:
    """Wraps the kernel modules' entry points during a run: counts calls per
    shape signature and keeps a copy of the first inputs of each signature
    (the launch counters are the wrappers' own)."""

    def __init__(self, entries):
        self.entries = entries                 # {name: module}
        self.orig = {n: getattr(m, n) for n, m in entries.items()}
        self.seen = {n: {} for n in entries}

    def _wrap(self, name):
        import torch
        fn = self.orig[name]
        seen = self.seen[name]

        def wrapped(*args):
            sig = tuple((tuple(a.shape), str(a.dtype), tuple(a.stride()))
                        for a in args)
            rec = seen.get(sig)
            if rec is None:                    # a copy with the same strides
                seen[sig] = rec = [0, [torch.empty_strided(
                    a.shape, a.stride(), dtype=a.dtype, device=a.device
                ).copy_(a) for a in args]]
            rec[0] += 1
            return fn(*args)
        return wrapped

    def counts(self):
        """{name: {signature: calls so far}}."""
        return {n: {sig: rec[0] for sig, rec in seen.items()}
                for n, seen in self.seen.items()}

    def __enter__(self):
        for n, m in self.entries.items():
            setattr(m, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, m in self.entries.items():
            setattr(m, n, self.orig[n])


def time_turns(fns, reps: int = REPS, flush=None):
    """Median ms per call of each function in ``fns`` ({name: callable}),
    each call timed by its own pair of CUDA events, the functions in turns
    (the order, then the order reversed: ABBA). ``flush`` runs before every
    timed call (outside its events). The card first sleeps so that the host
    queues the calls ahead of it and no host time lands between the events."""
    import torch
    names = list(fns)
    for n in names:
        fns[n]()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    pairs = {n: [] for n in names}
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            if flush is not None:
                flush()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[n]()
            b.record()
            pairs[n].append((a, b))
    torch.cuda.synchronize()
    return {n: statistics.median(a.elapsed_time(b) for a, b in p)
            for n, p in pairs.items()}


def bound(name, args, granule: int = 1):
    """(ms, "bytes" or "operations"): the least time the card could take for
    the call, the larger of the bytes it must move over the memory rate and
    its float32 operations over the float32 peak outside the tensor cores.
    Bytes count each index and output word once and each image word that
    these indices touch once (4-byte words throughout). ``granule = 8``
    counts touched image words in whole 32-byte sectors instead, the least
    that device memory can deliver."""
    import torch
    if name == "gather2d_hwc":
        # Bytes: a pixel's row of C elements is contiguous.
        img, iy, ix = args
        Hh, Ww, C = img.shape
        es = img.element_size()
        row = C * es
        pix = (iy.clamp(0, Hh - 1).long() * img.stride(0)
               + ix.clamp(0, Ww - 1).long() * img.stride(1)).reshape(-1)
        if granule == 1:
            touched = torch.unique(pix).numel() * row
        else:
            b = pix * es
            sectors = torch.cat([(b + min(k, row - 1)) // 32
                                 for k in range(0, row + 31, 32)])
            touched = torch.unique(sectors).numel() * 32
        n_bytes = touched + 8 * iy.numel() + iy.numel() * row
        return n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"
    if name in ("gather2d", "gather2d_pick"):
        imgs, *idx = args
        C = imgs.shape[0] if imgs.dim() == 3 else 1
        Hh, Ww = imgs.shape[-2:]
        iy, ix = idx[-2:]
        words = iy.clamp(0, Hh - 1).long() * Ww + ix.clamp(0, Ww - 1).long()
        if name == "gather2d_pick":
            words = words + idx[0].clamp(0, C - 1).long() * (Hh * Ww)
            C = 1
        touched = C * torch.unique(words // granule).numel() * granule
        n_out, ops = C * iy.numel(), 0
    elif name == "row_gather":
        img, ix = args
        Ww = img.shape[1]
        rows = torch.arange(img.shape[0], device=img.device)[:, None]
        words = rows * Ww + ix.clamp(0, Ww - 1).long()
        touched = torch.unique(words // granule).numel() * granule
        n_out, ops = ix.numel(), 0
    else:                                              # bilinear_x
        img, x = args
        Ww = img.shape[1]
        rows = torch.arange(img.shape[0], device=img.device)[:, None]
        x0 = x.clamp(0, Ww - 1).floor().clamp(0, max(Ww - 2, 0)).long()
        words = torch.cat([rows * Ww + x0,
                           rows * Ww + (x0 + 1).clamp(max=Ww - 1)])
        touched = torch.unique(words // granule).numel() * granule
        # Per output: two clamps of x, floor, two clamps of x0, 1 - f,
        # x - x0, two products and a sum.
        n_out, ops = x.numel(), 10 * x.numel()
    n_idx = args[1].numel() * (len(args) - 1)
    t_bytes = 4 * (touched + n_idx + n_out) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(name, args):
    """One PyTorch call computing the kernel's function on the same data
    (its index preparation done beforehand, outside the timing)."""
    import torch
    if name == "row_gather":
        img, ix = args
        idx = ix.clamp(0, img.shape[1] - 1).long()
        return lambda: torch.gather(img, 1, idx)
    if name == "bilinear_x":
        img, x = args
        Hh, Ww = img.shape
        rows = torch.arange(Hh, device=img.device, dtype=torch.float32)
        gy = (2.0 * rows / max(Hh - 1, 1) - 1.0)[:, None].expand_as(x)
        gx = 2.0 * x / max(Ww - 1, 1) - 1.0
        grid = torch.stack([gx, gy], dim=-1)[None]
        inp = img[None, None]
        return lambda: torch.nn.functional.grid_sample(
            inp, grid, mode="bilinear", padding_mode="border",
            align_corners=True)
    if name == "gather2d_hwc":
        img, iy, ix = args
        Hh, Ww = img.shape[:2]
        iy64, ix64 = iy.clamp(0, Hh - 1).long(), ix.clamp(0, Ww - 1).long()
        return lambda: img[iy64, ix64]
    if name == "gather2d_pick":
        imgs, ic, iy, ix = args
        Cc, Hh, Ww = imgs.shape
        ic64, iy64, ix64 = (ic.clamp(0, Cc - 1).long(),
                            iy.clamp(0, Hh - 1).long(),
                            ix.clamp(0, Ww - 1).long())
        words = imgs.view(torch.int32) if imgs.dtype == torch.uint32 else imgs
        return lambda: words[ic64, iy64, ix64]
    imgs, iy, ix = args
    Hh, Ww = imgs.shape[-2:]
    iy64, ix64 = iy.clamp(0, Hh - 1).long(), ix.clamp(0, Ww - 1).long()
    words = imgs.view(torch.int32) if imgs.dtype == torch.uint32 else imgs
    if words.dim() == 2:
        return lambda: words[iy64, ix64]
    return lambda: words[:, iy64, ix64]


def old_gather_map(img, iy, ix):
    """The route ``sampling.gather_map`` took before the channel-last entry,
    on the (H, W, C) array and int32 indices it hands ``gather2d_hwc``:
    channels moved first (a copy), narrow types widened to int32, the
    channel-first ``gather2d``, channels moved last and narrowed back."""
    import torch
    from dpe_mvs_tpu_torch.ops import gather2d as g2d
    S = tuple(iy.shape)
    n = iy.numel()
    q2 = (n // S[-1] if S[-1] else 0, S[-1]) if len(S) >= 2 else (1, n)
    flat = img.permute(2, 0, 1)
    if img.dtype in (torch.bool, torch.uint8, torch.int8):
        flat = flat.to(torch.int32)
    out = g2d.gather2d(flat.contiguous(), iy.reshape(q2).contiguous(),
                       ix.reshape(q2).contiguous())
    return out.permute(1, 2, 0).to(img.dtype).reshape(*S, img.shape[2])


def old_free_at(free_dist, bins, iy, ix):
    """The route ``LineOfSight.crossing`` took to the free path of each
    segment's bin before the pick entry, on the indices it hands
    ``gather2d_pick`` (``bins`` int64, as ``argmin`` gives them): the
    endpoint clamped, all 16 direction planes gathered channel-last through
    :func:`old_gather_map`, then one picked (``sampling.pick_last``)."""
    from dpe_mvs_tpu_torch.ops import sampling
    Hl, Wl = free_dist.shape[1:]
    f16 = old_gather_map(free_dist.permute(1, 2, 0), iy.clamp(0, Hl - 1),
                         ix.clamp(0, Wl - 1))
    return sampling.pick_last(f16, bins)


def first_views(sc, views: int):
    """A copy of the synthetic scene ``sc`` with its first ``views``
    views."""
    return dataclasses.replace(sc, images=sc.images[:views],
                               cameras=sc.cameras[:views],
                               gt_depths=sc.gt_depths[:views],
                               gt_normals=sc.gt_normals[:views])


def pipeline_phase(sc, folder: Path, launches, reset, modules) -> dict:
    """Phase 9: the scene ``sc`` written to the dense folder ``folder`` and
    run through the CLI in-process, with every check and print of the
    module docstring but the kernels' (the caller's, on what this returns).
    ``launches`` / ``reset`` read and zero the kernel counters; ``modules``
    maps each kernel entry to its module, for :class:`Capture`. Returns
    {"all": launches of the run, "rounds": [launches per round], "fusion":
    launches in fusion, "fusion_sigs": fusion's gather2d_hwc calls per
    captured signature, "fusion_s": fusion's seconds, "seen": the captured
    inputs per entry, "summary": the numbers phase 11 prints beside its
    own}."""
    import numpy as np
    import torch
    from dpe_mvs_tpu_torch import cli
    from dpe_mvs_tpu_torch.io import formats, scene
    from dpe_mvs_tpu_torch.pipeline import fusion as fus
    from dpe_mvs_tpu_torch.pipeline import schedule as sch
    from dpe_mvs_tpu_torch.utils.profiling import GLOBAL_TIMER
    from dpe_mvs_tpu_torch.utils.synthetic import write_scene_folder
    from tools.torch_eval import backproject_gt, depth_scale, fscore

    phase("9. the pipeline through the CLI")
    t0 = time.time()
    write_scene_folder(sc, folder)
    print(f"dense folder written in {time.time() - t0:.1f} s")

    # Wrappers around the schedule's own calls: per-sweep time and launches,
    # and problem 0's maps as each scale's are written.
    per_iter, per_scale, shares, fused = {}, {}, {}, {}
    sweep_fn, edges_fn = sch.process_problem, sch.get_problem_edges
    fusion_fn = fus.run_fusion

    def sweep(problem, params, scale_size, *args, **kw):
        before, ts = launches(), time.time()
        out = sweep_fn(problem, params, scale_size, *args, **kw)
        torch.cuda.synchronize()
        per_iter[problem.iteration] = per_iter.get(problem.iteration, 0.0) \
            + time.time() - ts
        n = per_scale.setdefault(scale_size, dict.fromkeys(before, 0))
        for k, v in launches().items():
            n[k] += v - before[k]
        return out

    def edges(problem, scale_size, params):
        edges_fn(problem, scale_size, params)
        if problem.ref_image_id == 0:
            s = sch.scale_index(scale_size)
            e = formats.read_dmb(problem.result_folder / f"edges_{s}.dmb")
            lab = formats.read_dmb(problem.result_folder / f"labels_{s}.dmb")
            shares[s] = (e.shape, float((e > 0).mean()),
                         float((lab > 0).mean()), float((lab < 0).mean()),
                         int(lab.max()))

    def fusion(dense_folder, problems, **kw):
        # The state fusion reads, kept for the plain run on the CPU after
        # the pipeline (whose cleanup deletes it).
        shutil.copytree(dense_folder, cpu_copy)
        torch.cuda.synchronize()
        before, sigs, ts = launches(), cap.counts()["gather2d_hwc"], \
            time.time()
        out = fusion_fn(dense_folder, problems, **kw)
        torch.cuda.synchronize()
        fused["s"] = time.time() - ts
        fused["launches"] = {k: v - before[k] for k, v in launches().items()}
        fused["sigs"] = {sig: n - sigs.get(sig, 0) for sig, n in
                         cap.counts()["gather2d_hwc"].items()
                         if n > sigs.get(sig, 0)}
        fused["pairs"] = sum(len(p.src_image_ids) for p in problems)
        return out

    cpu_copy = folder.parent / "fusion_on_cpu"
    argv = [str(folder), "0", "1", "0", "1", "1", "1", "1", "1"]
    sch.process_problem, sch.get_problem_edges = sweep, edges
    fus.run_fusion = fusion
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with Capture(modules) as cap:
            reset()
            t0 = time.time()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            run_s = time.time() - t0
            counts = launches()
    finally:
        sch.process_problem, sch.get_problem_edges = sweep_fn, edges_fn
        fus.run_fusion = fusion_fn
    peak = torch.cuda.max_memory_allocated()
    held = sum(a.untyped_storage().nbytes() for seen in cap.seen.values()
               for _, args in seen.values() for a in args)
    if rc != 0:
        fail(f"cli.main returned {rc}")
    print(f"pipeline: {run_s:.2f} s in all; peak device memory "
          f"{peak / 2**20:.1f} MiB, of which the captured kernel inputs "
          f"hold {held / 2**20:.1f} MiB; launches {counts}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the pipeline")
    print("seconds per iteration (sweeps, synchronised): " + ", ".join(
        f"{it} {t:.2f}" for it, t in sorted(per_iter.items())))
    if sorted(per_iter) != list(range(8)):
        fail(f"expected iterations 0-7, ran {sorted(per_iter)}")
    if "s" not in fused:
        fail("the pipeline did not run fusion")
    print(f"sweeps {sum(per_iter.values()):.2f} s, fusion {fused['s']:.2f} s "
          f"(span 'fusion' {GLOBAL_TIMER.totals.get('fusion', 0.0):.2f} s); "
          f"launches in fusion {fused['launches']}")
    want = {k: 3 * fused["pairs"] if k == "gather2d_hwc" else 0
            for k in fused["launches"]}
    if fused["launches"] != want:
        fail(f"fusion launched {fused['launches']}, expected {want} (three "
             f"gather2d_hwc per reference-source pair)")
    print("per-stage time (GLOBAL_TIMER, CUDA events):\n"
          + GLOBAL_TIMER.summary())
    print("edge extraction, all problems: " + ", ".join(
        f"scale {s} {GLOBAL_TIMER.totals[f'edges, scale {s}']:.3f} s"
        for s in sorted(shares)))
    for s, (shape, e, pos, small, n_reg) in sorted(shares.items()):
        print(f"problem 0, scale {s} ({shape[1]}x{shape[0]}): edge share "
              f"{e:.4f}, labelled (> 0) {pos:.4f}, small regions (-1) "
              f"{small:.4f}, {n_reg} regions")
    rounds = [per_scale[k] for k in sorted(per_scale, reverse=True)]
    for i, n in enumerate(rounds):
        print(f"launches, round {i}: {n}")

    res = [folder / "DPE" / f"{v:08d}" for v in range(len(sc.images))]
    want = {"depth.npy": (np.float32, (H, W)),
            "normal.npy": (np.float32, (H, W, 3)),
            "weak.npy": (np.int8, (H, W)), "edge.npy": (np.int8, (H, W))}
    for v, rf in enumerate(res):
        for name, (dt, shape) in want.items():
            if not (rf / name).is_file():
                fail(f"problem {v}: {name} missing")
            a = np.load(rf / name)
            if a.dtype != dt or a.shape != shape:
                fail(f"problem {v}: {name} is {a.dtype} {a.shape}")
        d = np.load(rf / "depth.npy")
        gt = sc.gt_depths[v]
        ok = d > 0
        med = float(np.median(np.abs(d[ok] - gt[ok]) / gt[ok])) \
            if ok.any() else float("inf")
        print(f"problem {v}: median rel depth error {med:.5f}, valid "
              f"{float(ok.mean()):.4f}")
        if v == 0:
            med0, valid0 = med, float(ok.mean())
        if v == 0 and not (med < 0.02 and ok.mean() > 0.5):
            fail("problem 0 misses the bar after the pipeline (median < "
                 "2%, valid > 50%)")
        left = sorted(p.name for p in rf.iterdir()
                      if p.suffix in (".dmb", ".bin"))
        if left:
            fail(f"problem {v}: intermediates left: {left}")
    if (folder / "DPE" / "progress.json").exists():
        fail("progress.json left")
    ply = folder / "DPE" / "DPE.ply"
    if not ply.is_file():
        fail("DPE/DPE.ply missing")
    cloud, colors = formats.read_ply(ply)
    tau = 0.005 * depth_scale(sc)
    t0 = time.time()
    rep = fscore(cloud, backproject_gt(sc), tau)
    print(f"fused cloud: {cloud.shape[0]} points, precision "
          f"{rep['precision']}, recall {rep['recall']}, F {rep['fscore']} "
          f"at tau {tau:.5f} (0.005 x median depth; scored in "
          f"{time.time() - t0:.1f} s)")
    if cloud.shape[0] <= 100_000 or colors.shape != cloud.shape or \
            not np.isfinite(cloud).all():
        fail(f"fused cloud of {cloud.shape[0]} points (need > 100000, "
             f"finite, one colour each)")
    if not rep["precision"] > 0.9:
        fail(f"fused cloud precision {rep['precision']} <= 0.9")

    # The same fusion on the CPU (the gathers' plain versions) from the same
    # state. The card's expf / acosf may round an ulp away from the CPU's,
    # so a pixel exactly at a vote threshold could flip: the clouds may
    # differ in at most 0.01% of their points (point and colour bytes).
    t0 = time.time()
    fusion_fn(cpu_copy, scene.generate_sample_list(cpu_copy), device="cpu")
    cpu_s = time.time() - t0
    ref_cloud, ref_colors = formats.read_ply(cpu_copy / "DPE" / "DPE.ply")

    def records(pts, cols):
        raw = np.concatenate([pts.view(np.uint8).reshape(len(pts), 12),
                              cols], axis=1)
        return np.ascontiguousarray(raw).view("V15")[:, 0]
    differ = np.setxor1d(records(cloud, colors),
                         records(ref_cloud, ref_colors)).size
    print(f"fusion on the CPU: {cpu_s:.2f} s, {ref_cloud.shape[0]} points; "
          f"points in one cloud only: {differ}")
    if differ > 1e-4 * cloud.shape[0]:
        fail("the card's fused cloud and the CPU's differ in more than 0.01%"
             " of the points")
    shutil.rmtree(cpu_copy, ignore_errors=True)
    if any(m.split(".")[0] in ("jax", "cv2") for m in sys.modules):
        fail("the pipeline loaded jax or cv2")
    summary = {"seconds": run_s, "sweeps_s": sum(per_iter.values()),
               "per_iteration_s": [per_iter[i] for i in range(8)],
               "peak_mib": peak / 2**20, "held_mib": held / 2**20,
               "median": med0, "valid": valid0, "points": cloud.shape[0],
               "precision": rep["precision"], "recall": rep["recall"],
               "fusion_s": fused["s"]}
    return {"all": counts, "rounds": rounds, "fusion": fused["launches"],
            "fusion_sigs": fused["sigs"], "fusion_s": fused["s"],
            "seen": cap.seen, "summary": summary}


def parallel_phase(sc, folder: Path, launches, reset, modules, seq: dict,
                   device, views: int = PARALLEL_VIEWS) -> dict:
    """Phase 11: the view-parallel path over a one-rank group on ``device``
    (NCCL on a card) that this phase makes (``tcp://127.0.0.1:<free
    port>``) and destroys, with every check and print of the module
    docstring but the kernels' (the caller's, on the captured inputs this
    returns). 11a and 11b run on the first ``views`` views of ``sc`` (a
    copy of phase 9's scene with fewer views: the same bars, half the
    sweeps at 3 of 6), 11c on ``sc``. ``seq``: phase 9's summary, printed
    beside 11a's numbers.
    Returns {"parallel pipeline",
    "mesh fusion", "tile sweep": launches of each path, "rounds": the
    parallel pipeline's launches per round, "seen": {path: captured inputs
    per entry}, "summary": 11a-c's numbers}."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from dpe_mvs_tpu_torch.config import PatchMatchParams, schedule_params
    from dpe_mvs_tpu_torch.engine import rectcost
    from dpe_mvs_tpu_torch.engine import state as st_mod
    from dpe_mvs_tpu_torch.engine.stages import run_sweep_staged
    from dpe_mvs_tpu_torch.io import formats, scene
    from dpe_mvs_tpu_torch.parallel import mesh, tiles
    from dpe_mvs_tpu_torch.pipeline import fusion as fus
    from dpe_mvs_tpu_torch.pipeline import parallel_schedule as ps
    from dpe_mvs_tpu_torch.utils.profiling import GLOBAL_TIMER
    from dpe_mvs_tpu_torch.utils.rng import TorchKey
    from dpe_mvs_tpu_torch.utils.synthetic import write_scene_folder
    from tools.torch_eval import backproject_gt, depth_scale, fscore

    sc_all = sc
    sc = first_views(sc, views)
    phase(f"11a. the view-parallel pipeline (one NCCL rank), views 0-"
          f"{views - 1} of the scene's {len(sc_all.images)}")
    write_scene_folder(sc, folder)
    mesh.initialize_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0,
                                device=device)
    out = {"seen": {}, "summary": {}}
    try:
        group = mesh.make_group(device)
        print(f"group: rank {group.rank} of {group.world}, backend "
              f"{group.backend}, {group.device} (one card: NCCL refuses two "
              f"ranks on one device, so every collective has one rank)")
        want = "nccl" if device.type == "cuda" else "gloo"
        if group.backend != want:
            fail(f"the phase's group runs {group.backend}, not {want}")

        # Each sweep pass of the runner, synchronised, and each round's
        # launches (its loading, rectification included).
        passes, rounds = [], []
        sweep_fn, round_fn = mesh.sharded_sweep, ps.ParallelRunner.run_round

        def sweep(*args, **kw):
            torch.cuda.synchronize()
            ts = time.time()
            res = sweep_fn(*args, **kw)
            torch.cuda.synchronize()
            passes.append(time.time() - ts)
            return res

        def run_round(self, *args, **kw):
            before = launches()
            round_fn(self, *args, **kw)
            rounds.append({k: v - before[k] for k, v in launches().items()})

        spans0 = dict(GLOBAL_TIMER.totals)
        mesh.sharded_sweep, ps.ParallelRunner.run_round = sweep, run_round
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with Capture(modules) as cap:
                reset()
                t0 = time.time()
                rc = ps.run_pipeline_parallel(
                    folder, group=group, verbose=True, fusion=True,
                    depth=True, normal=True, weak=True, edge=True,
                    keep_intermediates=True)
                torch.cuda.synchronize()
                run_s = time.time() - t0
                counts = launches()
        finally:
            mesh.sharded_sweep, ps.ParallelRunner.run_round = sweep_fn, \
                round_fn
        peak = torch.cuda.max_memory_allocated()
        held = sum(a.untyped_storage().nbytes() for seen in cap.seen.values()
                   for _, args in seen.values() for a in args)
        if rc != 0:
            fail(f"run_pipeline_parallel returned {rc}")
        if len(passes) != 8:
            fail(f"expected 2 rounds of 4 passes, ran {len(passes)} passes")
        spans = {k: v - spans0.get(k, 0.0)
                 for k, v in GLOBAL_TIMER.totals.items()
                 if v - spans0.get(k, 0.0) > 0}
        names = ("A", "B0", "B1", "B2")
        print(f"seconds per pass ({len(sc.images)} problems, "
              "synchronised): " + ", ".join(
            f"round {i // 4} {names[i % 4]} {t:.2f}"
            for i, t in enumerate(passes)))
        print(f"parallel pipeline {run_s:.2f} s, sweeps "
              f"{sum(passes):.2f} s (phase 9, sequential: "
              f"{seq['seconds']:.2f} s, sweeps {seq['sweeps_s']:.2f} s)")
        print("spans (GLOBAL_TIMER, CUDA events, s): " + ", ".join(
            f"{k} {spans.get(k, 0.0):.3f}" for k in (
                "load", "reinit", "exchange", "sweep", "writeback",
                "fusion")))
        for r, n in enumerate(rounds):
            print(f"launches, round {r}: {n}")
        print(f"launches: {counts}")
        for name, n in counts.items():
            if n <= 0:
                fail(f"kernel {name} was not launched by the parallel "
                     f"pipeline")
        print(f"peak device memory {peak / 2**20:.1f} MiB, of which the "
              f"captured kernel inputs hold {held / 2**20:.1f} MiB (phase "
              f"9, sequential: {seq['peak_mib']:.1f} MiB, captured "
              f"{seq['held_mib']:.1f} MiB)")
        meds = []
        for v in range(len(sc.images)):
            d = np.load(folder / "DPE" / f"{v:08d}" / "depth.npy")
            gt = sc.gt_depths[v]
            ok = d > 0
            med = float(np.median(np.abs(d[ok] - gt[ok]) / gt[ok])) \
                if ok.any() else float("inf")
            meds.append((med, float(ok.mean())))
            print(f"problem {v}: median rel depth error {med:.5f}, valid "
                  f"{float(ok.mean()):.4f}")
        med0, valid0 = meds[0]
        print(f"problem 0: median {med0:.5f}, valid {valid0:.4f} (phase 9: "
              f"{seq['median']:.5f}, {seq['valid']:.4f}; other keys and "
              f"Jacobi reads, so no bit comparison)")
        if not (med0 < 0.02 and valid0 > 0.5):
            fail("problem 0 misses the bar after the parallel pipeline "
                 "(median < 2%, valid > 50%)")
        ply = folder / "DPE" / "DPE.ply"
        cloud, colors = formats.read_ply(ply)
        rep = fscore(cloud, backproject_gt(sc), 0.005 * depth_scale(sc))
        print(f"fused cloud: {cloud.shape[0]} points, precision "
              f"{rep['precision']}, recall {rep['recall']} (phase 9: "
              f"{seq['points']} points, precision {seq['precision']}, "
              f"recall {seq['recall']})")
        if cloud.shape[0] <= 100_000 or colors.shape != cloud.shape or \
                not np.isfinite(cloud).all():
            fail(f"fused cloud of {cloud.shape[0]} points (need > 100000, "
                 f"finite, one colour each)")
        if not rep["precision"] > 0.9:
            fail(f"fused cloud precision {rep['precision']} <= 0.9")
        out["parallel pipeline"], out["rounds"] = counts, rounds
        out["seen"]["parallel pipeline"] = cap.seen
        out["summary"]["11a"] = {
            "seconds": run_s, "pass_s": passes,
            "spans_s": spans, "peak_mib": peak / 2**20,
            "held_mib": held / 2**20, "median": med0, "valid": valid0,
            "points": cloud.shape[0], "precision": rep["precision"],
            "recall": rep["recall"]}

        phase("11b. run_fusion_mesh on 11a's maps (one NCCL rank)")
        problems = scene.generate_sample_list(folder)
        seq_ply = ply.read_bytes()
        reset()
        torch.cuda.synchronize()
        t0 = time.time()
        with Capture(modules) as cap:
            fus.run_fusion_mesh(folder, problems, group, verbose=True)
            torch.cuda.synchronize()
        mesh_s = time.time() - t0
        n_mesh = launches()
        pts, _ = formats.read_ply(ply)
        same = ply.read_bytes() == seq_ply
        rel = abs(pts.shape[0] - cloud.shape[0]) / cloud.shape[0]
        passes = n_mesh["gather2d_hwc"] / max(
            3 * sum(len(p.src_image_ids) for p in problems), 1)
        print(f"mesh fusion: {mesh_s:.2f} s ({passes:g} vote passes), "
              f"{pts.shape[0]} points against run_fusion's {cloud.shape[0]} "
              f"on the same maps (relative difference {rel:.5f}; the same "
              f"file: {same}); launches {n_mesh}")
        if rel > 0.01:
            fail("mesh fusion's point count is not within 1% of run_fusion's")
        if n_mesh["gather2d_hwc"] <= 0:
            fail("mesh fusion did not launch gather2d_hwc")
        torch.cuda.synchronize()
        t0 = time.time()
        fus.run_fusion_mesh(folder, problems, group, max_passes=2)
        torch.cuda.synchronize()
        two_s = time.time() - t0
        n_two = formats.read_ply(ply)[0].shape[0]
        print(f"the JAX package's two passes (max_passes=2): {two_s:.2f} s, "
              f"{n_two} points ({n_two / cloud.shape[0] - 1:+.4f} against "
              f"run_fusion's)")
        out["mesh fusion"] = n_mesh
        out["seen"]["mesh fusion"] = cap.seen
        out["summary"]["11b"] = {
            "seconds": mesh_s, "passes": passes, "points": pts.shape[0],
            "run_fusion_points": cloud.shape[0], "same_file": same,
            "two_pass_s": two_s, "two_pass_points": n_two}

        phase("11c. tile_sharded_sweep, one tile (one card), problem 0 "
              "pass A")
        inputs = sc_all.problem_inputs(0)
        v_pad = len(sc_all.images) - 1
        params = schedule_params(PatchMatchParams(), 0, None)
        gt = sc_all.gt_depths[0]
        torch.cuda.synchronize()
        t0 = time.time()
        rh = rectcost.build_rect_host(inputs.cameras, inputs.width,
                                      inputs.height, v_pad)
        data = st_mod.build_sweep_data(inputs, v_pad, device=device).replace(
            rect=rectcost.build_rect_views(rh, inputs.images, device))
        st = run_sweep_staged(data, st_mod.init_pm_state(
            inputs, v_pad, TorchKey(0, device), False, device), params,
            rstat=rh.statics)
        rel_ref = np.abs(st.plane[..., 3].cpu().numpy() - gt) / gt
        torch.cuda.synchronize()
        ref_s = time.time() - t0
        del data, st
        reset()
        t0 = time.time()
        with Capture(modules) as cap:
            data, rstat, hb = tiles.build_tile_data(inputs, 1, 0, v_pad,
                                                    device=device)
            tile = tiles.build_tile_inputs(inputs, 1)[0][0]
            st = tiles.tile_sharded_sweep(group, data, st_mod.init_pm_state(
                tile, v_pad, TorchKey(10, device), False, device), params,
                rstat, hb)
            st = tiles.stitch_tiles(group, st, inputs.height)
            torch.cuda.synchronize()
        tile_s = time.time() - t0
        n_tile = launches()
        rel_tile = np.abs(st.plane[..., 3].cpu().numpy() - gt) / gt
        med_ref, med_tile = float(np.median(rel_ref)), float(
            np.median(rel_tile))
        print(f"one tile of {tile.height} rows (halo {tiles.HALO}, never "
              f"exchanged with one tile): {tile_s:.2f} s, median rel depth "
              f"error {med_tile:.5f}; unsharded sweep {ref_s:.2f} s, "
              f"{med_ref:.5f}; launches {n_tile}")
        if not (med_ref < 0.01 and med_tile < max(2.0 * med_ref, 0.01)):
            fail("the tile sweep misses tests/test_tiles.py's bars (median "
                 "< 0.01; tile median < max(2 x unsharded, 0.01))")
        for name in ("row_gather", "bilinear_x"):
            if n_tile[name] <= 0:
                fail(f"the tile sweep did not launch {name}")
        out["tile sweep"] = n_tile
        out["seen"]["tile sweep"] = cap.seen
        out["summary"]["11c"] = {"seconds": tile_s, "median": med_tile,
                                 "unsharded_s": ref_s,
                                 "unsharded_median": med_ref}
    finally:
        dist.destroy_process_group()
    return out


def weak_cost_call(args, kwargs) -> dict:
    """``engine.weak_rect.weak_cost``'s arguments by name, defaults
    filled."""
    def named(data, sites, plane, photo=True, geom=False, geom_factor=0.0,
              out=None):
        return dict(data=data, sites=sites, plane=plane, photo=photo,
                    geom=geom, geom_factor=geom_factor, out=out)
    return named(*args, **kwargs)


def launch_signature(name, args, kwargs) -> tuple:
    """A launch's shape signature: each tensor argument's shape, dtype and
    strides; for ``weak_cost``, what it computes and the shapes, dtypes and
    strides of the plane and of every site field the kernel reads."""
    if name == "weak_cost":
        from dpe_mvs_tpu_torch.engine import weak_rect
        a = weak_cost_call(args, kwargs)
        ts = [a["plane"], *weak_rect._kernel_operands(
            a["sites"], a["photo"], a["geom"]).values()]
        head = (("photo" if a["photo"] else "") + ("geom" if a["geom"]
                                                    else ""),)
    else:
        ts, head = args, ()
    return head + tuple((tuple(t.shape), str(t.dtype), tuple(t.stride()))
                        for t in ts)


def weak_cost_plain(data, sites, plane, photo=True, geom=False,
                    geom_factor=0.0, out=None):
    """``weak_cost``'s plain version with its signature (``out`` unused)."""
    from dpe_mvs_tpu_torch.engine import weak_rect
    return weak_rect.weak_cost_ref(data, sites, plane, photo, geom,
                                   geom_factor)


def weak_cost_timer(records: list, label: str):
    """A :class:`FirstLaunchCheck` ``timed`` hook for ``weak_cost``: at the
    first launch of each (mode, band shape) the kernel (into a spare output)
    and the plain version in turns, each call by its own event pair, median
    of REPS, warm and L2-cold (FLUSH_BYTES written and read before each
    call), beside the bound: ``ops/weakcost.site_bytes`` a site over the
    memory rate. Appends a record to ``records``; the launches it makes are
    taken off ``weakcost.LAUNCHES`` again."""
    import torch
    from dpe_mvs_tpu_torch.ops import weakcost as wc
    done = set()

    def hook(fn, args, kwargs):
        a = weak_cost_call(args, kwargs)
        data, sites, plane = a["data"], a["sites"], a["plane"]
        photo, geom, gf = a["photo"], a["geom"], a["geom_factor"]
        (h, w), V = plane.shape[:2], sites.xr.shape[0]
        mode = {(True, False): "cost", (False, True): "term",
                (True, True): "cost+term"}[photo, geom]
        if (mode, h, w) in done:
            return
        done.add((mode, h, w))
        spare = torch.empty((V, h, w), dtype=torch.float32,
                            device=plane.device)
        scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                              device=plane.device)

        def flush():
            scratch.fill_(1.0)
            scratch.sum()
        n0 = wc.LAUNCHES["weakcost"]
        fns = {"kernel": lambda: fn(data, sites, plane, photo, geom, gf,
                                    out=spare),
               "plain": lambda: weak_cost_plain(data, sites, plane, photo,
                                                geom, gf)}
        warm = time_turns(fns)
        cold = time_turns(fns, flush=flush)
        wc.LAUNCHES["weakcost"] = n0
        rec = {"frame": label, "mode": mode, "sites": [h, w], "views": V,
               "ms": warm["kernel"], "cold_ms": cold["kernel"],
               "plain_ms": warm["plain"], "plain_cold_ms": cold["plain"],
               "bound_ms": h * w * wc.site_bytes(V, photo, geom)
               / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        records.append(rec)
        print(f"weak_cost, {label}, {mode} at {V} x {h} x {w} sites: kernel "
              f"{rec['cold_ms']:.4f} / {rec['ms']:.4f} ms (cold / warm), "
              f"plain {rec['plain_cold_ms']:.3f} / {rec['plain_ms']:.3f} ms; "
              f"bound {rec['bound_ms']:.4f} ms (bytes), "
              f"{rec['bound_ms'] / rec['cold_ms']:.0%} of it cold",
              flush=True)
        del spare, scratch
    return hook


class FirstLaunchCheck:
    """Wraps the kernel entries during a run without keeping copies (unlike
    :class:`Capture`, which would hold gigabytes at 6048x4032): on the first
    launch of each shape signature the kernel's output is compared, bit for
    bit, with its plain version on the same inputs, and the plain output is
    freed at once. The launch itself is the run's own, so it counts. Also
    notes the largest channel ``gather2d`` read (``max_channel_bytes``).
    ``keep`` maps an entry to a predicate of its arguments: the inputs of
    the first launch of each shape signature that it accepts are copied to
    host memory (``kept[name][sig]``; on the card they would count in the
    run's peak), for timing, and its accepted launches are counted per
    signature (``kept_launches``). With ``own_peak`` the comparisons and
    copies stay out of the card's peak counter: the peak the run reached
    before each is noted and the counter reset after it, and
    :meth:`max_allocated` / :meth:`reset_peak` stand for
    ``torch.cuda.max_memory_allocated`` / ``reset_peak_memory_stats``.
    ``timed`` maps an entry to a function called after the check of each
    signature's first launch with the entry's own function, the arguments
    and the keyword arguments (to time the launch; inside ``own_peak``'s
    exclusion too)."""

    def __init__(self, entries, plain, exact, keep=None, own_peak=False,
                 timed=None):
        self.entries, self.plain, self.exact = entries, plain, exact
        self.timed = dict(timed or {})
        self.orig = {n: getattr(m, n) for n, m in entries.items()}
        self.checked = {n: set() for n in entries}
        self.max_channel_bytes = 0
        self.keep = dict(keep or {})
        self.kept = {n: {} for n in entries}
        self.kept_launches = {n: {} for n in entries}
        self.own_peak, self.noted_peak = own_peak, 0

    def max_allocated(self) -> int:
        import torch
        return max(torch.cuda.max_memory_allocated(), self.noted_peak)

    def reset_peak(self) -> None:
        import torch
        torch.cuda.reset_peak_memory_stats()
        self.noted_peak = 0

    def _wrap(self, name):
        import torch
        fn, ref = self.orig[name], self.plain[name]
        checked, kept = self.checked[name], self.kept[name]

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            sig = launch_signature(name, args, kwargs)
            if name == "gather2d":
                img = args[0]
                self.max_channel_bytes = max(
                    self.max_channel_bytes,
                    img.shape[-1] * img.shape[-2] * img.element_size())
            keep = name in self.keep and self.keep[name](args)
            if sig in checked and (not keep or sig in kept):
                if keep:
                    kept_n = self.kept_launches[name]
                    kept_n[sig] += 1
                return out
            if self.own_peak:
                self.noted_peak = max(self.noted_peak,
                                      torch.cuda.max_memory_allocated())
            if sig not in checked:
                checked.add(sig)
                want = ref(*args, **kwargs)
                self.exact(name, out, want, f"{sig} (first launch)")
                del want
                if name in self.timed:
                    self.timed[name](fn, args, kwargs)
            if keep:
                # A copy: the inputs may be views of the run's tensors,
                # which a reference would keep alive.
                kept[sig] = tuple(a.to("cpu", copy=True) for a in args)
                self.kept_launches[name][sig] = 1
            if self.own_peak:
                torch.cuda.reset_peak_memory_stats()
            return out
        return wrapped

    def __enter__(self):
        for n, m in self.entries.items():
            setattr(m, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, m in self.entries.items():
            setattr(m, n, self.orig[n])


def fullres_phase(out_dir: Path, cfg, launches, reset, modules, plain,
                  exact, weak_times: list) -> dict:
    """Phase 12: full-resolution frames (FULLRES), 12a at 1600x1200 and 12c
    at 6048x4032, 6 views each, through ``process_problem`` inside
    :class:`FirstLaunchCheck`. ``exact(name, a, b, where)`` fails the script
    unless a equals b bit for bit. The final round's (rnd > 0) weak_cost
    launches are timed into ``weak_times`` (:func:`weak_cost_timer`).
    Returns {"launches": {path: launches},
    "row4": [timing records], "summary": what the ``fullres`` line
    prints, "scene": 12c's scene, for phase 14}."""
    import numpy as np
    import torch
    from dpe_mvs_tpu_torch.config import PatchMatchParams, schedule_params
    from dpe_mvs_tpu_torch.engine import patchmatch as tpm
    from dpe_mvs_tpu_torch.engine import rectcost, weak_rect
    from dpe_mvs_tpu_torch.io import formats, scene
    from dpe_mvs_tpu_torch.ops import anchors
    from dpe_mvs_tpu_torch.pipeline import schedule as sch
    from dpe_mvs_tpu_torch.utils.profiling import BRANCHES, outermost
    from dpe_mvs_tpu_torch.utils.synthetic import make_plane_scene, \
        support_maps, write_coarse_priors, write_scene_folder

    base = PatchMatchParams()
    device = torch.device("cuda")
    out = {"launches": {}, "row4": [], "summary": {}}

    def sweep(p, params, chk, **kw):
        """One synchronised sweep in the round's rect frame: seconds, stage
        spans, launches, branches taken, memory free before it, its peak,
        and the peak of each stage (the peak counter reset as each span
        starts; ``chk``'s comparisons kept out of it)."""
        spans, stage_mib = {}, {}
        peak = [0]

        @contextlib.contextmanager
        def timer(name):
            torch.cuda.synchronize()
            peak[0] = max(peak[0], chk.max_allocated())
            chk.reset_peak()
            ts = time.time()
            yield
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.time() - ts
            top = chk.max_allocated()
            peak[0] = max(peak[0], top)
            stage_mib[name] = max(stage_mib.get(name, 0.0), top / 2**20)

        torch.cuda.synchronize()
        free = torch.cuda.mem_get_info()[0]
        held = torch.cuda.memory_allocated()
        chk.reset_peak()
        before = launches()
        BRANCHES.clear()
        ts = time.time()
        sch.process_problem(p, params, 1, 1, v_pad, cfg, device=device,
                            timer=outermost(timer), rect_frame=frame,
                            **kw)
        torch.cuda.synchronize()
        peak_mib = max(peak[0], chk.max_allocated()) / 2**20
        rec = {"problem": p.ref_image_id, "seconds": time.time() - ts,
               "spans_s": spans,
               "launches": {k: v - before[k] for k, v in launches().items()},
               "branches": dict(BRANCHES), "free_before_mib": free / 2**20,
               "allocated_before_mib": held / 2**20, "peak_mib": peak_mib,
               "stage_peak_mib": stage_mib,
               "peak_stage": max(stage_mib, key=stage_mib.get)}
        print(f"problem {p.ref_image_id}: {rec['seconds']:.2f} s, peak "
              f"{peak_mib:.1f} MiB in {rec['peak_stage']} (before it: "
              f"{held / 2**20:.1f} MiB allocated, {free / 2**20:.1f} MiB free "
              f"on the card); launches {rec['launches']}; branches "
              f"{rec['branches']}\n  spans (s, synchronised): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in spans.items()) +
              "\n  stage peaks (MiB): " + ", ".join(
                  f"{k} {v:.1f}" for k, v in stage_mib.items()), flush=True)
        return rec

    def depth_stats(sc, p):
        depth = formats.read_dmb(p.result_folder / "depths.dmb")
        gt = sc.gt_depths[p.ref_image_id]
        if depth.shape != gt.shape or not np.isfinite(depth).all():
            fail(f"problem {p.ref_image_id}: bad depth map")
        ok = depth > 0
        med = float(np.median(np.abs(depth[ok] - gt[ok]) / gt[ok])) \
            if ok.any() else float("inf")
        return med, float(ok.mean())

    def need(label, rec, names):
        for name in names:
            if rec["branches"].get(name, 0) <= 0:
                fail(f"{label} did not take the {name} branch: "
                     f"{rec['branches']}")

    def pass_b(sc, problems, rnd, recs, chk):
        """Problem 0's modal pass B on its pass-A writeback (12a) or its
        ground truth (12c), inside ``chk``: (launches, median relative depth
        error, valid share)."""
        if rnd:
            # The sources' depth maps: their ground truth, written as their
            # .dmb (what five more full-frame pass-A sweeps would write).
            for p in problems[1:]:
                p.result_folder.mkdir(parents=True, exist_ok=True)
                formats.write_dmb(p.result_folder / "depths.dmb",
                                  sc.gt_depths[p.ref_image_id])
            print("pass B reads the sources' ground-truth depth maps, "
                  "written as their depths.dmb, in place of their pass-A "
                  "writeback", flush=True)
        params_b = schedule_params(base, max(rnd, 1), 0)
        p0 = problems[0]
        inp = scene.add_pass_inputs(
            sc.problem_inputs(0), p0.result_folder,
            [problems[i].result_folder for i in [0] + sc.src_ids(0)],
            **sch.pass_needs(params_b))
        maps = support_maps(inp.images[0])
        p0.iteration = 1
        reset()
        recs["B"].append(sweep(p0, params_b, chk, inputs=inp,
                               support_maps=maps))
        n_b = launches()
        del inp, maps
        return (n_b, *depth_stats(sc, p0))

    v_pad = VIEWS - 1
    for tag, w, h, rnd in FULLRES:
        label = f"{w}x{h}"
        phase(f"12{tag}. full-resolution frames: {label}x{VIEWS}, round {rnd}")
        if rnd and os.environ.get("PYTORCH_CUDA_ALLOC_CONF"):
            fail("PYTORCH_CUDA_ALLOC_CONF is set: the final round must fit "
                 "the default allocator")
        t0 = time.time()
        # One round's rect hosts, built by the first sweep of a problem,
        # reused by its next (the pipeline's per-round cache).
        sch._RECT_HOSTS.clear()
        sc = make_plane_scene(width=w, height=h, num_views=VIEWS, seed=SEED)
        render_s = time.time() - t0
        folder = write_scene_folder(sc, out_dir / label)
        problems = [scene.Problem(index=i, ref_image_id=i,
                                  src_image_ids=sc.src_ids(i),
                                  dense_folder=folder)
                    for i in range(VIEWS)]
        # The rect frame the round loop sweeps every problem of the round
        # in: the largest any pair of any problem needs.
        frame = sch.round_rect_frame(problems, 1, v_pad)
        params_a = schedule_params(base, rnd, None)
        print(f"scene rendered in {render_s:.1f} s (views in threads), "
              f"written in {time.time() - t0 - render_s:.1f} s; the round's "
              f"rect frame {frame[0]}x{frame[1]}; gates: rect bands over "
              f"{rectcost.BAND_FULL_BYTES:g} B, anchor profiles streamed over "
              f"{weak_rect.AP_STORE_MAX_PX} px, a_d0 regathered over "
              f"{weak_rect.A_D0_STORE_MAX_PX} px, weak bands "
              f"{weak_rect._weak_band_count(h, w)}, bf16 screening and "
              f"scanned draws over {tpm.FULLRES_PX} px; disparity-sweep "
              f"chunks and classify bands of {tpm.SWEEP_CHUNK_BYTES:g} B, "
              f"anchor-search bands of {anchors.BAND_BYTES:g} B; allocator "
              f"configuration "
              f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '(default)')}",
              flush=True)
        # 12a: every problem's round-0 pass A. 12c sweeps no pass A (a cut
        # for time; tools/torch_final_round.py runs round 3's through the
        # round loop): problem 0's pass B starts from its full-frame ground
        # truth, written as its previous sweep's writeback, as phase 14
        # writes it. The inputs of the first gather2d launch of each shape
        # in TPU kernel row 4's regime are kept on the host, for timing.
        recs = {"A": [], "B": []}
        n_a, med_a, valid_a = None, None, None
        row4_regime = {"gather2d": lambda args: (
            args[0].shape[-1] * args[0].shape[-2] * args[0].element_size()
            > ROW4_CHANNEL_BYTES)}
        timed = ({"weak_cost": weak_cost_timer(weak_times,
                                                f"{label} pass B")}
                 if rnd else None)
        with FirstLaunchCheck(modules, plain, exact, keep=row4_regime,
                              own_peak=True, timed=timed) as chk:
            if rnd == 0:
                reset()
                for i in range(VIEWS):
                    recs["A"].append(sweep(problems[i], params_a, chk,
                                           inputs=sc.problem_inputs(i)))
                n_a = launches()
                med_a, valid_a = depth_stats(sc, problems[0])
                print(f"pass A launches {n_a}; problem 0: median rel depth "
                      f"error {med_a:.5f}, valid {valid_a:.4f}", flush=True)
                if not (med_a < 0.02 and valid_a > 0.5):
                    fail(f"{label}: problem 0 misses phase 6's bar after "
                         "pass A")
                for name in ("row_gather", "bilinear_x"):
                    if n_a[name] <= 0:
                        fail(f"{label} pass A did not launch {name}")
            else:
                write_coarse_priors(sc, 0, problems[0].result_folder, 1)
                print("no pass A: problem 0's pass B starts from its "
                      "ground truth at the full frame (every pixel STRONG)",
                      flush=True)
            n_b, med_b, valid_b = pass_b(sc, problems, rnd, recs, chk)
        print(f"pass B launches {n_b}; problem 0: median rel depth error "
              f"{med_b:.5f}, valid {valid_b:.4f} (pass A {med_a})",
              flush=True)
        if not (med_b < 0.02 and valid_b > 0.5
                and (med_a is None or med_b <= med_a + 0.003)):
            fail(f"{label}: problem 0 misses phase 7's bar after pass B")
        for name, n in n_b.items():
            if n <= 0:
                fail(f"{label} pass B did not launch {name}")
        need(f"{label} pass B", recs["B"][0], FULLRES_BRANCHES if rnd else
             ("streamed anchor profiles", "regathered a_d0", "weak bands"))
        for rec in recs["A"] + recs["B"]:
            if rec["peak_mib"] >= PEAK_LIMIT_MIB:
                fail(f"{label}: problem {rec['problem']}'s sweep peaked at "
                     f"{rec['peak_mib']:.1f} MiB in {rec['peak_stage']}, "
                     f"not under {PEAK_LIMIT_MIB} MiB")
        if not chk.kept["gather2d"]:
            fail(f"{label}: gather2d read no channel over "
                 f"{ROW4_CHANNEL_BYTES} bytes (largest "
                 f"{chk.max_channel_bytes})")
        checked = {n: len(s) for n, s in chk.checked.items()}
        print(f"bit-exact against the plain versions at the first launch "
              f"of every shape: {checked}", flush=True)

        # TPU kernel row 4 at its real shape: kernel, library call and
        # plain version in turns, L2-cold, beside the bound (its inputs
        # back on the card from the host copy).
        args = tuple(a.to(device) for a in next(iter(
            chk.kept["gather2d"].values())))
        scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                              device=device)

        def flush():
            scratch.fill_(1.0)
            scratch.sum()
        fns = {"kernel": lambda: modules["gather2d"].gather2d(*args),
               "library": library_call("gather2d", args),
               "plain": lambda: plain["gather2d"](*args)}
        t = time_turns(fns, flush=flush)
        b_ms, b_by = bound("gather2d", args)
        shape = (f"{tuple(args[0].shape)} int32 words "
                 f"({args[0][0].numel() * 4 / 2**20:.1f} MiB a channel), "
                 f"queries {tuple(args[1].shape)}")
        print(f"gather2d, row 4's real shape ({label} pass A or B, the "
              f"streamed anchor profiles): {shape}; cold ms kernel "
              f"{t['kernel']:.4f}, library {t['library']:.4f}, plain "
              f"{t['plain']:.4f}; bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / t['kernel']:.0%} of it", flush=True)
        row4 = {"frame": label, "shape": shape, "cold_ms": t["kernel"],
                "library_cold_ms": t["library"], "plain_cold_ms": t["plain"],
                "bound_ms": b_ms, "bound_by": b_by,
                "launches_pass_a": None if n_a is None else n_a["gather2d"],
                "launches_pass_b": n_b["gather2d"]}
        out["row4"].append(row4)
        del args, fns, chk, scratch
        if n_a is not None:
            out["launches"][f"{label} pass A"] = n_a
        out["launches"][f"{label} pass B"] = n_b
        out["summary"][label] = {
            "round": rnd, "views": VIEWS, "rect_frame": list(frame),
            "pass_a": recs["A"],
            "pass_b": recs["B"], "median_a": med_a, "valid_a": valid_a,
            "median_b": med_b, "valid_b": valid_b,
            "checked_shapes": checked, "row4": row4, "render_s": render_s,
            "seconds": time.time() - t0}
        out["scene"] = sc
        del sc, problems
        sch._RECT_HOSTS.clear()
        shutil.rmtree(folder, ignore_errors=True)
    return out


def final_round_phase(sc, out_dir: Path, launches, reset, modules, plain,
                      exact, device) -> dict:
    """Phase 14: the ETH3D final round through the round loop,
    ``tools/torch_final_round.run`` in-process on the first FINAL_VIEWS
    views of ``sc`` (12c's scene), resumed after FINAL_RESUME (round 3's
    last pass B, then the exports and fusion), inside
    :class:`FirstLaunchCheck`, fusion's ``gather2d_hwc`` inputs kept and
    timed (kernel, library call, plain version in turns, L2-cold) beside
    their bounds, on ``device`` (the card). ``exact(name, a, b, where)``
    fails the script unless a equals b bit for bit. Returns {"launches": the
    run's, "fusion": fusion's, "fusion_hwc": the timing records, "summary":
    the tool's record}."""
    import torch
    from tools import torch_final_round as tfr

    sc = first_views(sc, FINAL_VIEWS)
    with FirstLaunchCheck(modules, plain, exact) as chk:
        @contextlib.contextmanager
        def keep_fusion_inputs():
            chk.keep = {"gather2d_hwc": lambda args: True}
            try:
                yield
            finally:
                chk.keep = {}
        reset()
        res = tfr.run(resume_iteration=FINAL_RESUME, out=out_dir,
                      device=device, scene=sc,
                      around_fusion=keep_fusion_inputs)
        n = launches()
    checked = {name: len(sigs) for name, sigs in chk.checked.items()}
    print(f"bit-exact against the plain versions at the first launch of "
          f"every shape: {checked}", flush=True)
    for v, rep in res["problems"].items():
        if not (rep["median_rel_err"] < 0.02 and rep["valid"] > 0.5):
            fail(f"final round: problem {v} misses the bar: {rep}")
    cloud = res["cloud"]
    if not (cloud["points"] > 100_000 and cloud["precision"] > 0.9):
        fail(f"final round: the cloud misses the bar: {cloud}")
    for rec in res["sweeps"]:
        if not rec["peak_allocated_mib"] or \
                rec["peak_allocated_mib"] >= PEAK_LIMIT_MIB:
            fail(f"final round: a sweep's peak is not under "
                 f"{PEAK_LIMIT_MIB} MiB: {rec}")
    for name, c in n.items():
        if c <= 0:
            fail(f"final round did not launch {name}")
    if res["launches_fusion"]["gather2d_hwc"] != \
            3 * FINAL_VIEWS * (FINAL_VIEWS - 1):
        fail(f"fusion launched {res['launches_fusion']}")

    # Fusion's gather2d_hwc at the full frame: each shape's kernel, library
    # call and plain version in turns, L2-cold, beside the bound.
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                          device=device)

    def flush():
        scratch.fill_(1.0)
        scratch.sum()
    recs = []
    for sig, host in chk.kept["gather2d_hwc"].items():
        args = tuple(a.to(device) for a in host)
        t = time_turns({"kernel": lambda: modules["gather2d_hwc"]
                        .gather2d_hwc(*args),
                        "library": library_call("gather2d_hwc", args),
                        "plain": lambda: plain["gather2d_hwc"](*args)},
                       flush=flush)
        b_ms, b_by = bound("gather2d_hwc", args)
        recs.append({"shape": str(sig), "launches":
                     chk.kept_launches["gather2d_hwc"][sig],
                     "cold_ms": t["kernel"], "library_cold_ms": t["library"],
                     "plain_cold_ms": t["plain"], "bound_ms": b_ms,
                     "bound_by": b_by})
        print(f"gather2d_hwc in fusion at {sc.width}x{sc.height}: {sig} "
              f"x{recs[-1]['launches']}: cold ms kernel {t['kernel']:.4f}, "
              f"library {t['library']:.4f}, plain {t['plain']:.4f}; bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        del args
    del scratch, chk
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"launches": n, "fusion": res["launches_fusion"],
            "fusion_hwc": recs, "summary": res}


@contextlib.contextmanager
def call_sites(module, names):
    """Record where each of ``module``'s functions ``names`` is first called
    from while the context is open (for a failure message)."""
    orig = {n: getattr(module, n) for n in names}
    sites = {}

    def wrap(n):
        def wrapped(*args, **kw):
            sites.setdefault(n, "".join(traceback.format_stack(limit=10)[:-1]))
            return orig[n](*args, **kw)
        return wrapped
    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield sites
    finally:
        for n in names:
            setattr(module, n, orig[n])


def sweep_timer(spans):
    """A ``process_problem`` timer summing synchronised seconds per stage
    into ``spans``."""
    import torch
    from dpe_mvs_tpu_torch.utils.profiling import outermost

    @contextlib.contextmanager
    def timer(name):
        torch.cuda.synchronize()
        ts = time.time()
        yield
        torch.cuda.synchronize()
        spans[name] = spans.get(name, 0.0) + time.time() - ts
    return outermost(timer)


def exact_phase(sc, out_dir: Path, cfg, v_pad: int, launches, reset,
                modules, t_start: float, side_s) -> dict:
    """Phases 10a and 10b: the exact engine (``EngineConfig(use_rect=
    False)``) through ``process_problem``, round-0 pass A for every problem
    of ``sc``, then the modal pass B on that writeback for every problem if
    the script (which started at ``t_start``) can still end within
    EXACT_BUDGET_S with ``side_s(exact pass-A s, exact pass-B s)`` seconds
    left for phases 10c and 10d, else for problem 0. Every kernel entry is
    wrapped by :class:`Capture`.
    Returns {"problems", "cfg", "a"/"b": launches of the pass, "per_sweep_a"
    / "per_sweep_b": problem 0's, "counts_a" / "counts_b": problem 0's calls
    per captured signature, "cap_a" / "cap_b": the captures, "med_a",
    "sweep_s": seconds per sweep (pass A and B, problem 0 excluded)}."""
    import numpy as np
    import torch
    from dpe_mvs_tpu_torch.config import PatchMatchParams, schedule_params
    from dpe_mvs_tpu_torch.io import formats, scene
    from dpe_mvs_tpu_torch.ops import rowgather as rg
    from dpe_mvs_tpu_torch.pipeline import schedule as sch
    from dpe_mvs_tpu_torch.utils.synthetic import support_maps

    base = PatchMatchParams()
    params_a = schedule_params(base, 0, None)
    params_b = schedule_params(base, 1, 0)
    ecfg = dataclasses.replace(cfg, use_rect=False)
    device = torch.device("cuda")
    problems = [scene.Problem(index=i, ref_image_id=i,
                              src_image_ids=sc.src_ids(i),
                              dense_folder=out_dir)
                for i in range(len(sc.images))]

    def depth_stats(p):
        depth = formats.read_dmb(p.result_folder / "depths.dmb")
        gt = sc.gt_depths[p.ref_image_id]
        if depth.shape != gt.shape or not np.isfinite(depth).all():
            fail(f"exact engine, problem {p.ref_image_id}: bad depth map")
        ok = depth > 0
        med = float(np.median(np.abs(depth[ok] - gt[ok]) / gt[ok])) \
            if ok.any() else float("inf")
        return med, float(ok.mean())

    times = {"A": [], "B": []}

    def sweep(p, params, name, **kw):
        before = launches()
        tp = time.time()
        sch.process_problem(p, params, 1, 1, v_pad, ecfg, device=device,
                            **kw)
        torch.cuda.synchronize()
        dt = time.time() - tp
        if p.ref_image_id:
            times[name].append(dt)
        n = {k: v - before[k] for k, v in launches().items()}
        med, valid = depth_stats(p)
        print(f"problem {p.ref_image_id}: {dt:.2f} s, launches {n}; median "
              f"rel depth error {med:.5f}, valid {valid:.4f}", flush=True)
        return n

    def run_pass(name, params, inputs_of, ids):
        reset()
        per_sweep = counts = None
        with Capture(modules) as cap, \
                call_sites(rg, ("row_gather", "bilinear_x")) as sites:
            for i in ids:
                p = problems[i]
                p.iteration = 0 if name == "A" else 1
                n = sweep(p, params, name, **inputs_of(p))
                if per_sweep is None:
                    per_sweep, counts = n, cap.counts()
        n_all = launches()
        print(f"launches: {n_all}")
        for k in ("row_gather", "bilinear_x"):
            if n_all[k]:
                fail(f"exact pass {name} launched {k} {n_all[k]} times (the "
                     f"exact engine does not rectify); first called from:\n"
                     f"{sites.get(k, '(no call seen)')}")
        return n_all, per_sweep, counts, cap

    phase("10a. exact engine: pass A, all problems")
    t0 = time.time()
    a, per_a, counts_a, cap_a = run_pass(
        "A", params_a, lambda p: {"inputs": sc.problem_inputs(p.ref_image_id)},
        range(len(problems)))
    print(f"all problems: {time.time() - t0:.2f} s (first includes warm-up)")
    if a["gather2d_hwc"] <= 0:
        fail("exact pass A did not launch gather2d_hwc")
    med_a, valid_a = depth_stats(problems[0])
    if not (med_a < 0.02 and valid_a > 0.5):
        fail("problem 0 misses the ground-truth bar after exact pass A "
             "(median < 2%, valid > 50%)")

    phase("10b. exact engine: pass B")

    def pass_b_inputs(p):
        ids = [p.ref_image_id] + sc.src_ids(p.ref_image_id)
        inp = scene.add_pass_inputs(sc.problem_inputs(p.ref_image_id),
                                    p.result_folder,
                                    [problems[i].result_folder for i in ids],
                                    **sch.pass_needs(params_b))
        return {"inputs": inp, "support_maps": support_maps(inp.images[0])}

    # Problem 0 first; the rest only if the script can still end in time
    # (projected from the sweeps so far).
    t0 = time.time()
    b, per_b, counts_b, cap_b = run_pass("B", params_b, pass_b_inputs, (0,))
    per_problem = time.time() - t0
    rest = list(range(1, len(problems)))
    projected = time.time() - t_start + per_problem * len(rest) + \
        side_s(statistics.median(times["A"]), per_problem)
    ran = [0]
    if rest and projected <= EXACT_BUDGET_S:
        more = run_pass("B", params_b, pass_b_inputs, rest)
        b = {k: b[k] + more[0][k] for k in b}
        for name, seen in more[3].seen.items():
            for sig, rec in seen.items():
                cap_b.seen[name].setdefault(sig, [0, rec[1]])[0] += rec[0]
        ran += rest
    print(f"exact pass B ran problems {ran} (projected script time with "
          f"all: {projected:.0f} s, budget {EXACT_BUDGET_S} s); launches "
          f"{b}")
    for k in ("gather2d_hwc", "gather2d_pick"):
        if b[k] <= 0:
            fail(f"exact pass B did not launch {k}")
    med_b, valid_b = depth_stats(problems[0])
    print(f"problem 0 after exact pass B: median rel depth error "
          f"{med_b:.5f}, valid {valid_b:.4f} (exact pass A {med_a:.5f})")
    if not (med_b <= med_a + 0.003 and valid_b > 0.5):
        fail("problem 0 after exact pass B is worse than its pass A + 0.003 "
             "(or valid <= 50%)")
    return {"problems": problems, "cfg": ecfg, "a": a, "b": b,
            "per_sweep_a": per_a, "per_sweep_b": per_b,
            "counts_a": counts_a, "counts_b": counts_b, "cap_a": cap_a,
            "cap_b": cap_b, "med_a": med_a, "ran_b": ran,
            "sweep_s": {k: statistics.median(v) if v else None
                        for k, v in times.items()}}


def side_by_side(sc, engines, v_pad: int, launches, reset) -> dict:
    """Phase 10d: problem 0's warm pass-A and pass-B sweeps on each engine
    (``engines``: {name: (EngineConfig, problems whose result folders the
    engine reads and writes)}), in turns, SIDE_PAIRS pairs per pass (the
    order reversed every other pair), each with synchronised per-stage spans
    (``sweep_timer``); the rect engine builds its rect host anew each time,
    as in phases 5-8. Returns {pass: {engine: summary}}."""
    import numpy as np
    import torch
    from dpe_mvs_tpu_torch.config import PatchMatchParams, schedule_params
    from dpe_mvs_tpu_torch.io import formats, scene
    from dpe_mvs_tpu_torch.pipeline import schedule as sch
    from dpe_mvs_tpu_torch.utils.synthetic import support_maps

    base = PatchMatchParams()
    passes = {"A": schedule_params(base, 0, None),
              "B": schedule_params(base, 1, 0)}
    device = torch.device("cuda")
    names = list(engines)
    out = {}
    for pname, params in passes.items():
        runs = {e: [] for e in names}
        for pair in range(SIDE_PAIRS):
            for e in (names if pair % 2 == 0 else names[::-1]):
                ecfg, problems = engines[e]
                p = problems[0]
                p.iteration = 2
                kw = {"inputs": sc.problem_inputs(0)}
                if pname == "B":
                    ids = [0] + sc.src_ids(0)
                    kw["inputs"] = scene.add_pass_inputs(
                        kw["inputs"], p.result_folder,
                        [problems[i].result_folder for i in ids],
                        **sch.pass_needs(params))
                    kw["support_maps"] = support_maps(
                        kw["inputs"].images[0])
                spans = {}
                sch._RECT_HOSTS.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                reset()
                t0 = time.time()
                sch.process_problem(p, params, 1, 1, v_pad, ecfg,
                                    device=device, timer=sweep_timer(spans),
                                    **kw)
                torch.cuda.synchronize()
                dt = time.time() - t0
                depth = formats.read_dmb(p.result_folder / "depths.dmb")
                gt = sc.gt_depths[0]
                ok = depth > 0
                runs[e].append({
                    "s": dt, "spans": spans, "launches": launches(),
                    "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                    "held_mib": held / 2**20,
                    "median_err": float(np.median(np.abs(depth[ok] - gt[ok])
                                                  / gt[ok])),
                    "valid": float(ok.mean())})
        out[pname] = {}
        for e in names:
            r = runs[e]
            out[pname][e] = {
                "median_s": statistics.median(x["s"] for x in r),
                "s": [x["s"] for x in r],
                "spans": {k: statistics.median(x["spans"].get(k, 0.0)
                                               for x in r)
                          for k in r[0]["spans"]},
                "launches": r[-1]["launches"],
                "peak_mib": max(x["peak_mib"] for x in r),
                "held_before_mib": max(x["held_mib"] for x in r),
                "median_err": [x["median_err"] for x in r],
                "valid": r[-1]["valid"]}
            o = out[pname][e]
            print(f"pass {pname}, {e} engine: median {o['median_s']:.3f} s "
                  f"of {', '.join(f'{x:.3f}' for x in o['s'])}; spans "
                  f"(median s) {', '.join(f'{k} {v:.3f}' for k, v in o['spans'].items())}; "
                  f"launches {o['launches']}; peak {o['peak_mib']:.1f} MiB "
                  f"({o['held_before_mib']:.1f} MiB held before the sweep); "
                  f"median rel depth error "
                  f"{', '.join(f'{x:.5f}' for x in o['median_err'])}",
                  flush=True)
    return out


def weak_envelope_phase(out_dir: Path, launches, reset, modules, plain,
                        exact) -> dict:
    """Phase 13, the weak-path envelope (cell ``weak-envelope-800x600x6``):
    ``tools/torch_weak_compare.py`` on problem 0 of its W x H x VIEWS scene,
    the rect engine, then the exact engine, inside :class:`FirstLaunchCheck`
    (``exact(name, a, b, where)`` fails the script unless a equals b bit for
    bit), the counters set to 0 before each run and read after it; then the
    tool's ``compare`` of the two runs' files. Fails unless the rect run
    launched all five entries, the exact run ``gather2d_hwc`` and
    ``gather2d_pick`` and no row kernel, and both meet the JAX tool's bars
    (median relative depth error < 0.02, valid share > 0.5). Returns
    {"launches": {path: launches}, "summary": what the ``weak_envelope``
    line prints}."""
    from tools import torch_weak_compare as twc

    out_dir.mkdir(parents=True, exist_ok=True)
    recs, n, paths = {}, {}, {}
    with FirstLaunchCheck(modules, plain, exact) as chk:
        for engine in twc.ENGINES:
            reset()
            recs[engine] = twc.run(engine, W, H, VIEWS)
            n[engine] = launches()
            paths[engine] = out_dir / f"wc_{engine}.npz"
            twc.save(recs[engine], paths[engine])
            print(f"weak compare, {engine} engine: {recs[engine]['wall']:.2f}"
                  f" s for the two sweeps; launches {n[engine]}", flush=True)
    checked = {name: len(sigs) for name, sigs in chk.checked.items()}
    print(f"bit-exact against the plain versions at the first launch of "
          f"every shape: {checked}", flush=True)
    for name, k in n["rect"].items():
        if k <= 0:
            fail(f"weak compare rect did not launch {name}")
    for name in ("gather2d_hwc", "gather2d_pick"):
        if n["exact"][name] <= 0:
            fail(f"weak compare exact did not launch {name}")
    for name in ("row_gather", "bilinear_x"):
        if n["exact"][name]:
            fail(f"weak compare exact launched {name}")
    env = twc.compare(paths["rect"], paths["exact"])
    frac = env["weak_frac_raw"]
    summary = {e: {**env[e], "weak_frac": frac[e], "seconds": r["wall"]}
               for e, r in recs.items()}
    summary.update(
        frame=f"{W}x{H}x{VIEWS}",
        weak_label_agreement=env["weak_label_agreement"],
        weak_frac_ratio=(frac["rect"] / frac["exact"] if frac["exact"]
                         else float("inf")),
        checked_shapes=checked)
    for e in twc.ENGINES:
        if not (env[e]["median_rel"] < 0.02 and env[e]["valid"] > 0.5):
            fail(f"weak compare {e}: misses the bars (median < 0.02, valid "
                 f"> 0.5): {env[e]}")
    return {"launches": {f"weak compare {e}": n[e] for e in twc.ENGINES},
            "summary": summary}


def weak_cell_phase(launches, reset, plain, exact, weak_times: list) -> dict:
    """Phase 15: ``tools/torch_probe.py``'s round sweeps at CELL_FRAME
    in-process, inside :class:`FirstLaunchCheck` on ``weak_cost`` (every
    shape's first launch bit-exact, each mode's first launch timed into
    ``weak_times``). Fails unless the weak bodies launched 15 kernels each
    in pass A and 23 in pass B. Returns {"launches": the sweeps',
    "checked_shapes": signatures checked}."""
    from dpe_mvs_tpu_torch.engine import weak_rect
    from tools import torch_probe

    w, h, views, rnd = CELL_FRAME
    label = f"{w}x{h}"
    bodies = 2 * 3 * weak_rect._weak_band_count(h, w)  # colours, iterations
    reset()
    with FirstLaunchCheck({"weak_cost": weak_rect}, plain, exact,
                          timed={"weak_cost": weak_cost_timer(
                              weak_times, f"{label} round {rnd}")}) as chk:
        rc = torch_probe.main([str(w), str(h), str(views), "apd", "geom",
                               "--round", str(rnd)])
    n = launches()
    if rc != 0:
        fail(f"tools/torch_probe.py at {label} returned {rc}")
    checked = len(chk.checked["weak_cost"])
    print(f"weak_cost at {label}: {checked} shapes bit-exact at their first "
          f"launch; launches {n}", flush=True)
    if n["weakcost"] != bodies * (15 + 23):
        fail(f"weak_cost at {label}: {n['weakcost']} launches, not 15 a "
             f"band body in pass A and 23 in pass B over {bodies} each")
    return {"launches": n, "checked_shapes": checked}


def exact_kernel_times(ex, modules, plain, flush) -> dict:
    """Phase 10c's timings: for gather2d_hwc (exact pass A and B) and
    gather2d_pick (exact pass B), the three shapes that move the most
    elements per sweep (problem 0's launches x queries) timed in turns with
    the library call and the plain version, L2-cold (``flush`` before every
    launch), and every shape's cold time x problem 0's launches summed per
    sweep beside the same sum of bounds. ``ex``: what :func:`exact_phase`
    returned. Returns {entry: {pass: record}}."""
    exact_recs = {}
    for name, lab, cap, counts0 in (
            ("gather2d_hwc", "exact pass A", ex["cap_a"], ex["counts_a"]),
            ("gather2d_hwc", "exact pass B", ex["cap_b"], ex["counts_b"]),
            ("gather2d_pick", "exact pass B", ex["cap_b"], ex["counts_b"])):
        seen, fn = cap.seen[name], getattr(modules[name], name)
        # Problem 0's launches at each shape; the shapes that move the most
        # elements timed in turns with the library call and the plain
        # version (L2-cold), then every shape's cold time x its launches.
        sigs = sorted((sig for sig in seen if counts0[name].get(sig)),
                      key=lambda sig: -counts0[name][sig]
                      * seen[sig][1][1].numel())
        shapes, sums = [], {"kernel_ms": 0.0, "bound_ms": 0.0}
        for k, sig in enumerate(sigs):
            args, c = seen[sig][1], counts0[name][sig]
            b_ms, b_by = bound(name, args)
            fns = {"kernel": lambda: fn(*args)}
            if k < 3:
                fns["library"] = library_call(name, args)
                fns["plain"] = lambda: plain[name](*args)
            t = time_turns(fns, reps=REPS if k < 3 else SWEEP_REPS,
                           flush=flush)
            sums["kernel_ms"] += c * t["kernel"]
            sums["bound_ms"] += c * b_ms
            if k < 3:
                shapes.append({"shape": str(sig), "launches_per_sweep": c,
                               "cold_ms": t["kernel"],
                               "library_cold_ms": t["library"],
                               "plain_cold_ms": t["plain"],
                               "bound_ms": b_ms, "bound_by": b_by})
                print(f"{name}, {lab}: {sig} x{c}: cold ms kernel "
                      f"{t['kernel']:.4f}, library {t['library']:.4f} "
                      f"({LIBRARY[name]}), plain {t['plain']:.4f}; bound "
                      f"{b_ms:.4f} ({b_by}), {b_ms / t['kernel']:.0%}")
        print(f"{name}, {lab}: per sweep (problem 0, "
              f"{sum(counts0[name].values())} launches over {len(sigs)} "
              f"shapes) {sums['kernel_ms']:.3f} ms cold, bound "
              f"{sums['bound_ms']:.3f} ms")
        exact_recs.setdefault(name, {})[lab] = {
            "dominant": shapes, "sweep_ms": sums["kernel_ms"],
            "sweep_bound_ms": sums["bound_ms"],
            "launches_per_sweep": ex["per_sweep_a" if lab.endswith("A")
                                     else "per_sweep_b"][name]}
    return exact_recs


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    device = torch.device("cuda")
    t_start = time.time()

    phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from dpe_mvs_tpu_torch.config import EngineConfig, PatchMatchParams, \
        schedule_params
    from dpe_mvs_tpu_torch.engine import rectcost
    from dpe_mvs_tpu_torch.io import formats, scene
    from dpe_mvs_tpu_torch.ops import cudalib
    from dpe_mvs_tpu_torch.ops import gather2d as g2d
    from dpe_mvs_tpu_torch.ops import rowgather as rg
    from dpe_mvs_tpu_torch.ops import weakcost as wc
    from dpe_mvs_tpu_torch.engine import weak_rect as twr
    from dpe_mvs_tpu_torch.pipeline import schedule as sch
    from dpe_mvs_tpu_torch.utils.profiling import outermost
    from dpe_mvs_tpu_torch.utils.synthetic import make_plane_scene, \
        support_maps
    # The gathers' entries (copied per shape by Capture, checked and timed
    # at every captured shape); weak_cost joins them where the inputs are
    # not copied (FirstLaunchCheck).
    modules = {"row_gather": rg, "bilinear_x": rg,
               **{n: g2d for n in GATHERS}}
    plain = {"row_gather": rg.row_gather_ref, "bilinear_x": rg.bilinear_x_ref,
             "gather2d": g2d.gather2d_ref,
             "gather2d_hwc": g2d.gather2d_hwc_ref,
             "gather2d_pick": g2d.gather2d_pick_ref,
             "weak_cost": weak_cost_plain}
    checked = {**modules, "weak_cost": twr}
    weak_only = {"weak_cost": twr}
    weak_times = []

    def reset():
        rg.reset_launches()
        g2d.reset_launches()
        wc.reset_launches()

    def launches():
        return {**rg.LAUNCHES, **g2d.LAUNCHES, **wc.LAUNCHES}

    phase("2. build kernels")
    t0 = time.time()
    sos = cudalib.build_many([rg.SOURCE, g2d.SOURCE, wc.SOURCE],
                             verbose=True)
    print(f"built {', '.join(p.name for p in sos)} in "
          f"{time.time() - t0:.1f} s")

    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                          device=device)

    def flush():
        """Write, then read, FLUSH_BYTES: L2 ends up holding clean lines of
        the scratch buffer and none of the kernel's data."""
        scratch.fill_(1.0)
        scratch.sum()

    def bits(t):
        """The tensor's bits: 32-bit words as int32, anything else as
        bytes."""
        if t.element_size() == 4:
            return t.view(torch.int32)
        return t.contiguous().view(torch.uint8)

    def exact(name, a, b, where):
        torch.cuda.synchronize()
        if a.shape != b.shape or not torch.equal(bits(a), bits(b)):
            fail(f"{name} differs from its plain version at {where}")

    def variant(name, staged, *args):
        """A row kernel in the plan's variant (staged None, the public
        wrapper) or the one staged asks for."""
        if staged is None:
            return getattr(rg, name)(*args)
        return rg._launch(name, *args, staged=staged)

    def off4(t):
        """A contiguous copy of t that starts 4 bytes (8 for 8-byte
        elements) past a 16-byte boundary."""
        n = t.numel() * t.element_size()
        o = max(4, t.element_size())
        flat = torch.empty(n + 16, dtype=torch.uint8, device=t.device)
        return flat[o:o + n].view(t.dtype).view(t.shape).copy_(t)

    phase("3. kernels vs plain versions, ragged shapes")
    g = torch.Generator(device=device).manual_seed(SEED)
    # Ragged shapes, then the launch plan's shape classes: word I/O (L = 37)
    # and vector I/O (L = 64); rows staged by bulk copy (W % 4 == 0) or read
    # through __ldg (unstaged, W % 4 != 0, W = 70001 past the stage budget);
    # tall arrays (H = 70001) with word and vector I/O; the widest staged
    # rows (48 KB of shared memory with the barriers), the first rows too
    # wide to stage, a tall staged launch.
    shapes = [(1, 1, 1), (3, 1, 5), (7, 5, 33), (257, 130, 1000),
              (70001, 9, 3), (70001, 8, 8), (3, 6140, 12280),
              (3, 6144, 12288), (12672, 1024, 2048)] + \
        [(5 if w == 70001 else 33, w, l)
         for w in (1, 2, 3, 800, 1024, 70001) for l in (37, 64)]
    n_rg = 0
    for (h, w, l) in shapes + [(40, 1024, 2048)]:
        img = torch.rand(h, w, device=device, generator=g) * 255
        x = torch.rand(h, l, device=device, generator=g) * (w + 20) - 10
        ix = torch.floor(x).to(torch.int32)
        x.view(-1)[::5] = float("inf")
        x.view(-1)[1::7] = float("-inf")
        words = torch.randint(-2**31, 2**31 - 1, (h, w), device=device,
                              generator=g, dtype=torch.int32)
        words[:, ::3] = 0x7FC00001                       # quiet-NaN payload
        sets = [(img, x, ix, words)]
        if (h, w, l) == (40, 1024, 2048):                # 4-byte offsets
            sets = [tuple(off4(t) for t in sets[0])]
        for (im, xx, ii, wd) in sets:
            for staged in (None, False, True):
                where = f"({h}, {w}, {l}), staged={staged}, " \
                        f"offset {im.data_ptr() % 16}"
                exact("bilinear_x", variant("bilinear_x", staged, im, xx),
                      rg.bilinear_x_ref(im, xx), where)
                exact("row_gather f32", variant("row_gather", staged, im, ii),
                      rg.row_gather_ref(im, ii), where)
                exact("row_gather u32",
                      variant("row_gather", staged, wd.view(torch.uint32), ii),
                      rg.row_gather_ref(wd, ii), where)
                n_rg += 3
    # gather2d (channel-first): a channel <= 6 MB and > 6 MB (the JAX
    # package's two TPU kernels), ragged, C in {1, 3, 6, 9, 17}, words with
    # NaN payloads as float32 and int32, clustered and scattered queries; an
    # image and indices 4 bytes off 16 (word index I/O).
    def g2d_queries(h, w, qh, qw, clustered):
        if clustered:
            yy = torch.arange(qh, device=device)[:, None] * h // qh
            xx = torch.arange(qw, device=device)[None, :] * w // qw
            iy = (yy + torch.randint(-6, 6, (qh, qw), device=device,
                                     generator=g)).to(torch.int32)
            ix = (xx + torch.randint(-9, 9, (qh, qw), device=device,
                                     generator=g)).to(torch.int32)
            return iy, ix
        return (torch.randint(-3, h + 3, (qh, qw), device=device,
                              generator=g, dtype=torch.int32),
                torch.randint(-3, w + 3, (qh, qw), device=device,
                              generator=g, dtype=torch.int32))

    def nan_words(*shape):
        words = torch.randint(-2**31, 2**31 - 1, shape, device=device,
                              generator=g, dtype=torch.int32)
        words.view(-1)[::3] = 0x7FC00001                 # quiet-NaN payload
        return words

    n_g = 0
    big = None
    for (c, h, w, qh, qw) in [(1, 1, 1, 1, 1), (1, 200, 256, 64, 256),
                              (3, 17, 29, 5, 33), (6, 600, 800, 1201, 803),
                              (9, 960, 1024, 4800, 800),
                              (9, 1920, 2048, 9600, 1600),
                              (17, 70, 33, 129, 257)]:
        words = nan_words(c, h, w)
        for clustered in (True, False):
            iy, ix = g2d_queries(h, w, qh, qw, clustered)
            cases = [(words.view(torch.float32), iy, ix), (words, iy, ix)]
            if c == 17:
                cases.append(tuple(off4(t) for t in (words, iy, ix)))
            for args in cases:
                exact("gather2d", g2d.gather2d(*args),
                      g2d.gather2d_ref(*args),
                      f"({c}, {h}, {w}) x ({qh}, {qw}), clustered "
                      f"{clustered}, offset {args[0].data_ptr() % 16}")
                n_g += 1
            if (c, h) == (9, 1920) and clustered:
                big = (words, iy, ix)
    # gather2d_hwc (channel-last): C in {1, 2, 3, 4, 6, 16}, bool, uint8 and
    # NaN-payload words, contiguous and 4 bytes off 16, and the strided views
    # gather_map reads in place (plane[..., :3], plane[..., 3]).
    n_h = 0
    for cc in (1, 2, 3, 4, 6, 16):
        for dt in (torch.bool, torch.uint8, torch.int32):
            h, w = 131, 77
            if dt == torch.int32:
                arr = nan_words(h, w, cc)
            else:
                arr = torch.randint(0, 256, (h, w, cc), device=device,
                                    generator=g, dtype=torch.int32).to(dt)
            iy, ix = g2d_queries(h, w, 37, 203, cc % 2 == 0)
            for args in ((arr, iy, ix), tuple(off4(t) for t in (arr, iy, ix))):
                exact("gather2d_hwc", g2d.gather2d_hwc(*args),
                      g2d.gather2d_hwc_ref(*args),
                      f"({h}, {w}, {cc}) {dt}, offset "
                      f"{args[0].data_ptr() % 16}")
                n_h += 1
    plane = nan_words(600, 800, 4).view(torch.float32)
    iy, ix = g2d_queries(600, 800, 600, 800, True)
    for view in (plane[..., :3], plane[..., 3:], plane):
        exact("gather2d_hwc", g2d.gather2d_hwc(view, iy, ix),
              g2d.gather2d_hwc_ref(view, iy, ix), f"view {view.stride()}")
        n_h += 1
    # gather2d_pick: 16 direction planes, channels (beyond 32 bits) and
    # positions out of range, word and vector index I/O.
    n_p = 0
    free = nan_words(16, 300, 400).view(torch.float32)
    for S in ((600, 800), (1001,), (7, 5, 3)):
        ic, iy, ix = (torch.randint(-2, hi, S, device=device, generator=g,
                                    dtype=torch.int32)
                      for hi in (18, 303, 403))
        ic = ic.long()
        ic.view(-1)[::7] = 2**40
        ic.view(-1)[3::7] = -2**40
        for args in ((ic, iy, ix), tuple(off4(t) for t in (ic, iy, ix))):
            exact("gather2d_pick", g2d.gather2d_pick(free, *args),
                  g2d.gather2d_pick_ref(free, *args), f"{S}")
            n_p += 1
    print(f"row_gather, bilinear_x bit-exact in {n_rg} cases ("
          f"{len(shapes) + 1} shapes x 3 plan variants); gather2d bit-exact "
          f"in {n_g} cases, gather2d_hwc in {n_h}, gather2d_pick in {n_p}")
    # Row 4 of the TPU kernel table: gather2d with a channel > 6 MB (the
    # JAX package's _gather2d_kernel regime), clustered queries.
    fns4 = {"kernel": lambda: g2d.gather2d(*big),
            "library": library_call("gather2d", big),
            "plain": lambda: g2d.gather2d_ref(*big)}
    t4 = {v: time_turns(fns4, flush=fl)
          for v, fl in (("cold", flush), ("warm", None))}
    b4, b4_by = bound("gather2d", big)
    s4 = bound("gather2d", big, granule=8)[0]
    print(f"gather2d > 6 MB per channel (9 x 1920x2048 int32 words, 9600x1600 "
          f"clustered queries): bound {b4:.4f} ms ({b4_by}), {s4:.4f} ms in "
          f"whole 32-byte sectors; cold / warm ms, share of bound (cold):")
    for k in fns4:
        lib = f" ({LIBRARY['gather2d']})" if k == "library" else ""
        print(f"  {k}{lib}: {t4['cold'][k]:.4f} / {t4['warm'][k]:.4f}, "
              f"{b4 / t4['cold'][k]:.0%}")
    row4 = {"shape": "9 x 1920x2048 words, 9600x1600 clustered queries",
            **{f"{k}_cold_ms": t4["cold"][k] for k in fns4},
            **{f"{k}_ms": t4["warm"][k] for k in fns4},
            "bound_ms": b4, "sector_bound_ms": s4}
    # The timed closures hold row 4's arrays: free them before the runs
    # whose peak memory is reported.
    del big, fns4, cases, args, plane, free, words, arr, iy, ix, ic

    phase("4. render scene")
    t0 = time.time()
    sc = make_plane_scene(width=W, height=H, num_views=VIEWS, seed=SEED)
    print(f"{W}x{H}x{VIEWS} in {time.time() - t0:.1f} s")

    base = PatchMatchParams()
    params_a = schedule_params(base, 0, None)
    params_b = schedule_params(base, 1, 0)
    cfg = EngineConfig(seed=SEED)
    v_pad = VIEWS - 1
    out_dir = Path(tempfile.mkdtemp(prefix="dpe_smoke_"))
    problems = [scene.Problem(index=i, ref_image_id=i,
                              src_image_ids=sc.src_ids(i),
                              dense_folder=out_dir) for i in range(VIEWS)]

    def folders(p):
        ids = [p.ref_image_id] + sc.src_ids(p.ref_image_id)
        return [problems[i].result_folder for i in ids]

    def depth_stats(p):
        depth = formats.read_dmb(p.result_folder / "depths.dmb")
        gt = sc.gt_depths[p.ref_image_id]
        if depth.shape != gt.shape or not np.isfinite(depth).all():
            fail(f"problem {p.ref_image_id}: bad depth map")
        ok = depth > 0
        med = float(np.median(np.abs(depth[ok] - gt[ok]) / gt[ok])) \
            if ok.any() else float("inf")
        return med, float(ok.mean())

    phase("5. pass A, all problems")
    for p in problems:
        st = rectcost.build_rect_host(sc.problem_inputs(p.ref_image_id)
                                      .cameras, W, H, v_pad).statics
        print(f"problem {p.ref_image_id}: rect frame {st.wp}x{st.hp}")

    sweep_s = {"A": [], "B": []}           # seconds per sweep, problems 1-5

    def sweep(p, params, **kw):
        """One sweep of problem p; prints its time and its kernel launches
        and returns the launches."""
        before = launches()
        tp = time.time()
        sch._RECT_HOSTS.clear()
        sch.process_problem(p, params, 1, 1, v_pad, cfg, device=device, **kw)
        torch.cuda.synchronize()
        n = {k: v - before[k] for k, v in launches().items()}
        dt = time.time() - tp
        if p.ref_image_id:
            sweep_s["A" if params is params_a else "B"].append(dt)
        print(f"problem {p.ref_image_id}: {dt:.2f} s, launches {n}")
        return n

    reset()
    t0 = time.time()
    per_sweep_a = None
    with Capture(modules) as cap_a:
        for p in problems:
            n = sweep(p, params_a, inputs=sc.problem_inputs(p.ref_image_id))
            if per_sweep_a is None:        # problem 0: launches per shape
                per_sweep_a, counts_a = n, cap_a.counts()
    launches_a = launches()
    print(f"all problems: {time.time() - t0:.2f} s (first includes warm-up)")
    print(f"launches: {launches_a}")
    for name in ("row_gather", "bilinear_x"):
        if launches_a[name] <= 0:
            fail(f"kernel {name} was not launched by pass A")
    if any(launches_a[name] for name in GATHERS):
        fail("pass A launched a gather2d entry (it has no weak machinery)")

    phase("6. result of problem 0 after pass A")
    med_a, valid_a = depth_stats(problems[0])
    print(f"median rel depth error {med_a:.5f}, valid {valid_a:.4f}")
    if not (med_a < 0.02 and valid_a > 0.5):
        fail("problem 0 misses the ground-truth bar after pass A "
             "(median < 2%, valid > 50%)")
    for p in problems[1:]:
        depth_stats(p)

    phase("7. pass B, all problems")

    def pass_b_inputs(p):
        inp = scene.add_pass_inputs(sc.problem_inputs(p.ref_image_id),
                                    p.result_folder, folders(p),
                                    **sch.pass_needs(params_b))
        return inp, support_maps(inp.images[0])

    reset()
    t0 = time.time()
    per_sweep_b = None
    with Capture(modules) as cap_b, \
            FirstLaunchCheck(weak_only, plain, exact) as chk_b:
        for p in problems:
            inp, maps = pass_b_inputs(p)
            weak_share = float((inp.weak_info == 0).mean())
            print(f"problem {p.ref_image_id}: weak share before pass B "
                  f"{weak_share:.4f}, edge share {float(maps[0].mean()):.4f}, "
                  f"labelled {float((maps[2] > 0).mean()):.4f}")
            if p.ref_image_id == 0 and weak_share <= 0.0:
                fail("problem 0 has no weak pixels before pass B")
            p.iteration = 1
            n = sweep(p, params_b, inputs=inp, support_maps=maps)
            if per_sweep_b is None:
                per_sweep_b, counts_b = n, cap_b.counts()
    launches_b = launches()
    print(f"all problems: {time.time() - t0:.2f} s (first includes warm-up); "
          f"weak_cost bit-exact at the first launch of "
          f"{len(chk_b.checked['weak_cost'])} shapes")
    print(f"launches: {launches_b}")
    for name, n in launches_b.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by pass B")
    print(f"gather2d entries per pass-B sweep of problem 0: "
          f"{sum(per_sweep_b[n] for n in GATHERS)} "
          f"({', '.join(f'{n} {per_sweep_b[n]}' for n in GATHERS)})")
    med_b, valid_b = depth_stats(problems[0])
    print(f"problem 0 after pass B: median rel depth error {med_b:.5f}, "
          f"valid {valid_b:.4f} (pass A {med_a:.5f})")
    if not (med_b < 0.02 and valid_b > 0.5 and med_b <= med_a + 0.003):
        fail("problem 0 misses the bar after pass B (median < 2%, valid > "
             "50%, no worse than pass A + 0.003)")
    for p in problems[1:]:
        depth_stats(p)

    phase("8. kernels at the main paths' shapes; warm sweep")

    n_sm = torch.cuda.get_device_properties(device).multi_processor_count

    def check(name, seen, sweep_name):
        """Bit-exact against the plain version at every captured shape."""
        fn = getattr(modules[name], name)
        for sig, (n, args) in seen.items():
            exact(name, fn(*args), plain[name](*args), f"{sig} ({sweep_name})")

    def time_dominant(name, seen, sweep_name):
        """Kernel variants, library call and plain version in turns at the
        dominant shape (the most elements over the run), L2-cold and warm."""
        sig, (n, args) = max(seen.items(),
                             key=lambda kv: kv[1][0] * kv[1][1][1].numel())
        fn = getattr(modules[name], name)
        if name in GATHERS:
            fns, chosen = {"kernel": lambda: fn(*args)}, "kernel"
        else:
            fns = {"unstaged": lambda: rg._launch(name, *args, staged=False),
                   "staged": lambda: rg._launch(name, *args, staged=True)}
            img, idx = args
            chosen = "staged" if rg.launch_plan(
                *img.shape, idx.shape[1], img.data_ptr(), idx.data_ptr(), 0,
                n_sm).staged else "unstaged"
        kinds = list(fns)
        fns["library"] = library_call(name, args)
        fns["plain"] = lambda: plain[name](*args)
        # The launch floor: the same kernel on one row of 4 outputs (the
        # gathers: 4 queries of the same image).
        if name in GATHERS:
            tiny = [args[0]] + [a.reshape(-1)[:4].reshape(1, 4).contiguous()
                                for a in args[1:]]
        else:
            tiny = [a[..., :1, :4].contiguous() for a in args]
        fns["floor"] = lambda: fn(*tiny)
        cold = time_turns(fns, flush=flush)
        warm = time_turns(fns)
        b_ms, b_by = bound(name, args)
        s_ms = bound(name, args, granule=8)[0]
        print(f"{name}, {sweep_name}: dominant {sig} x{n}; bound {b_ms:.4f} "
              f"ms ({b_by}), {s_ms:.4f} ms in whole 32-byte sectors; launch "
              f"floor (1 x 4 outputs) {cold['floor']:.4f} / "
              f"{warm['floor']:.4f} ms; cold / warm ms, share of bound "
              f"(cold):")
        for k in [*kinds, "library", "plain"]:
            mark = " (chosen)" if k == chosen and len(kinds) > 1 else ""
            lib = f" ({LIBRARY[name]})" if k == "library" else ""
            print(f"  {k}{mark}{lib}: {cold[k]:.4f} / {warm[k]:.4f}, "
                  f"{b_ms / cold[k]:.0%}")
        rec = {"ms": warm[chosen], "cold_ms": cold[chosen],
               "plain_ms": warm["plain"], "plain_cold_ms": cold["plain"],
               "library_ms": warm["library"],
               "library_cold_ms": cold["library"],
               "bound_ms": b_ms, "bound_by": b_by, "sector_bound_ms": s_ms,
               "floor_ms": cold["floor"]}
        if len(kinds) > 1:
            rec["variant"] = chosen
            rec["variants"] = {k: {"ms": warm[k], "cold_ms": cold[k]}
                               for k in kinds}
        return rec

    def per_sweep(name, seen, counts0, sweep_name):
        """Problem 0's sweep: over every captured shape, its launches x the
        kernel's cold time (median of SWEEP_REPS) and the same sum of
        bounds. The row kernels time both variants at every shape, in turns
        with a second copy of the unstaged one, and sum the sweep for each
        staging threshold in REUSE_CHOICES; gather2d_hwc and gather2d_pick
        time the route that gather_map and the line-of-sight test took
        before them (old_gather_map, old_free_at) in turns with the new one.
        Returns the record's fields."""
        fn = getattr(modules[name], name)
        row = name not in GATHERS
        sums = {"plan": 0.0, "bound": 0.0}
        if row:
            sums.update({"unstaged": 0.0, "staged": 0.0, "unstaged_again": 0.0,
                         **{r: 0.0 for r in REUSE_CHOICES}})
        elif name != "gather2d":
            sums["old_route"] = 0.0
        for sig, (n, args) in seen.items():
            c = counts0[name].get(sig, 0)
            if not c:
                continue
            sums["bound"] += c * bound(name, args)[0]
            if not row:
                fns = {"new": lambda: fn(*args)}
                if name == "gather2d_pick":
                    fns["old"] = lambda: old_free_at(*args)
                elif name == "gather2d_hwc":
                    fns["old"] = lambda: old_gather_map(*args)
                t = time_turns(fns, reps=SWEEP_REPS, flush=flush)
                sums["plan"] += c * t["new"]
                if "old" in t:
                    sums["old_route"] += c * t["old"]
                continue
            t = time_turns(
                {"unstaged": lambda: rg._launch(name, *args, staged=False),
                 "staged": lambda: rg._launch(name, *args, staged=True),
                 "unstaged_again":
                     lambda: rg._launch(name, *args, staged=False)},
                reps=SWEEP_REPS, flush=flush)
            img, idx = args
            (Hh, Ww), L = img.shape, idx.shape[1]

            def plan_staged(r):
                return rg.launch_plan(Hh, Ww, L, img.data_ptr(),
                                      idx.data_ptr(), 0, n_sm, L >= r * Ww
                                      ).staged
            for k in ("unstaged", "staged", "unstaged_again"):
                sums[k] += c * t[k]
            for r in REUSE_CHOICES:
                sums[r] += c * t["staged" if plan_staged(r) else "unstaged"]
            sums["plan"] += c * t["staged" if plan_staged(rg.STAGE_MIN_REUSE)
                                  else "unstaged"]
        t, b = sums["plan"], sums["bound"]
        print(f"{name}, {sweep_name}: per sweep (problem 0, "
              f"{sum(counts0[name].values())} launches over "
              f"{len(counts0[name])} shapes) {t:.3f} ms cold, bound "
              f"{b:.3f} ms ({b / t:.0%})")
        rec = {"sweep_ms": t, "sweep_bound_ms": b}
        if row:
            print(f"  per sweep, every shape in one variant: unstaged "
                  f"{sums['unstaged']:.3f} ms, staged {sums['staged']:.3f} "
                  f"ms, unstaged again {sums['unstaged_again']:.3f} ms "
                  f"(noise {abs(sums['unstaged'] - sums['unstaged_again']):.3f}"
                  f" ms)")
            print("  per sweep, staged where L >= r W: " + ", ".join(
                f"r={r:g} {sums[r]:.3f}" for r in REUSE_CHOICES) +
                f" ms (plan: r={rg.STAGE_MIN_REUSE:g})")
            rec["sweep_variants"] = {
                **{k: sums[k] for k in ("unstaged", "staged",
                                        "unstaged_again")},
                "by_reuse": {f"{r:g}": sums[r] for r in REUSE_CHOICES}}
        elif name != "gather2d":
            rec["old_route_sweep_ms"] = sums["old_route"]
            rec["new_route_sweep_ms"] = t
            print(f"  route per sweep, in turns at every shape: old "
                  f"{sums['old_route']:.3f} ms, new {t:.3f} ms")
        return rec

    def measure(name, seen, counts0, sweep_name):
        check(name, seen, sweep_name)
        print(f"{name}, {sweep_name}: {len(seen)} shapes bit-exact")
        rec = time_dominant(name, seen, sweep_name)
        rec.update(per_sweep(name, seen, counts0, sweep_name))
        return rec

    recs = {(name, "pass A"): measure(name, cap_a.seen[name], counts_a,
                                      "pass A")
            for name in ("row_gather", "bilinear_x")}
    recs.update({(name, "pass B"): measure(name, cap_b.seen[name], counts_b,
                                           "pass B")
                 for name in ("row_gather", "bilinear_x", *GATHERS)})
    recs["gather2d", "pass B"]["row4"] = row4
    kernels = []
    for name in ("row_gather", "bilinear_x", *GATHERS):
        print(f"{name}: launches per sweep (problem 0) pass A "
              f"{per_sweep_a[name]}, pass B {per_sweep_b[name]}; all "
              f"problems pass A {launches_a[name]}, pass B {launches_b[name]}")
        rec = recs[name, "pass B"]
        if (name, "pass A") in recs:
            ra = recs[name, "pass A"]
            rec["pass_a"] = {k: ra[k] for k in
                             ("ms", "cold_ms", "bound_ms", "library_ms",
                              "library_cold_ms", "plain_ms", "sweep_ms",
                              "sweep_bound_ms", "sweep_variants")}
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches_b[name], "max_abs_err": 0.0,
                        **rec})
    print(f"gather_map and line-of-sight routes per pass-B sweep (problem 0, "
          f"cold, in turns): old "
          f"{sum(recs[n, 'pass B']['old_route_sweep_ms'] for n in GATHERS[1:]):.3f}"
          f" ms, new "
          f"{sum(recs[n, 'pass B']['new_route_sweep_ms'] for n in GATHERS[1:]):.3f}"
          f" ms; the three gather2d entries "
          f"{sum(recs[n, 'pass B']['sweep_ms'] for n in GATHERS):.3f} ms per "
          f"sweep, bound "
          f"{sum(recs[n, 'pass B']['sweep_bound_ms'] for n in GATHERS):.3f} ms")
    del cap_a, cap_b, scratch

    p0 = problems[0]
    p0.iteration = 2
    inp0, maps0 = pass_b_inputs(p0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sch._RECT_HOSTS.clear()
    sch.process_problem(p0, params_b, 1, 1, v_pad, cfg, device=device,
                        inputs=inp0, support_maps=maps0)
    torch.cuda.synchronize()
    warm = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"warm pass-B sweep (incl. rectification and writeback): "
          f"{warm:.3f} s; peak memory {peak / 2**20:.1f} MiB")

    spans = {}

    @contextlib.contextmanager
    def timer(name):
        torch.cuda.synchronize()
        ts = time.time()
        yield
        torch.cuda.synchronize()
        spans[name] = spans.get(name, 0.0) + time.time() - ts

    inp0, maps0 = pass_b_inputs(p0)
    sch._RECT_HOSTS.clear()
    sch.process_problem(p0, params_b, 1, 1, v_pad, cfg, device=device,
                        inputs=inp0, support_maps=maps0,
                        timer=outermost(timer))
    print("pass-B stages (s, synchronised): " +
          ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))

    launches_p = pipeline_phase(first_views(sc, PIPELINE_VIEWS),
                                out_dir / "scene", launches, reset, modules)
    for name in modules:
        check(name, launches_p["seen"][name], "pipeline")
        print(f"{name}, pipeline: {len(launches_p['seen'][name])} shapes "
              f"bit-exact")
    # Fusion's gathers: each shape's kernel, plain version and library call
    # in turns (L2-cold: the flush buffer again), times its launches in
    # fusion, beside the bounds.
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                          device=device)
    hwc_seen = launches_p["seen"]["gather2d_hwc"]
    fus = dict.fromkeys(("kernel", "plain", "library", "bound"), 0.0)
    for sig, c in launches_p["fusion_sigs"].items():
        args = hwc_seen[sig][1]
        t = time_turns({"kernel": lambda: g2d.gather2d_hwc(*args),
                        "plain": lambda: plain["gather2d_hwc"](*args),
                        "library": library_call("gather2d_hwc", args)},
                       flush=flush)
        b_ms = bound("gather2d_hwc", args)[0]
        print(f"gather2d_hwc in fusion: {sig} x{c}: cold ms kernel "
              f"{t['kernel']:.4f}, library {t['library']:.4f}, plain "
              f"{t['plain']:.4f}; bound {b_ms:.4f}")
        for k in ("kernel", "plain", "library"):
            fus[k] += c * t[k]
        fus["bound"] += c * b_ms
    del scratch, hwc_seen, args
    n_fus = sum(launches_p["fusion_sigs"].values())
    print(f"gather2d_hwc, fusion's {n_fus} launches: kernel "
          f"{fus['kernel']:.3f} ms, library {fus['library']:.3f} ms, plain "
          f"{fus['plain']:.3f} ms, bound {fus['bound']:.3f} ms; fusion "
          f"{launches_p['fusion_s']:.2f} s")
    for rec in kernels:
        if rec["name"] == "gather2d_hwc":
            rec["fusion"] = {"launches": n_fus,
                             "shapes": len(launches_p["fusion_sigs"]),
                             "kernel_ms": fus["kernel"],
                             "plain_ms": fus["plain"],
                             "library_ms": fus["library"],
                             "bound_ms": fus["bound"],
                             "fusion_s": launches_p["fusion_s"]}
    del launches_p["seen"]

    # Phase 12 before phase 10: its time counts in 10b's projection.
    full = fullres_phase(out_dir / "fullres", cfg, launches, reset, checked,
                         plain, exact, weak_times)
    print(f"phase 12: {sum(v['seconds'] for v in full['summary'].values()):.1f}"
          f" s; script time so far {time.time() - t_start:.1f} s")
    # Phase 14 on 12c's scene, which goes with it.
    t0 = time.time()
    phase(f"14. the final round through dpe_mvs: "
          f"tools/torch_final_round.py at {full['scene'].width}x"
          f"{full['scene'].height}x{FINAL_VIEWS}, resumed after iteration "
          f"{FINAL_RESUME}")
    final = final_round_phase(full.pop("scene"), out_dir / "final_round",
                              launches, reset, checked, plain, exact, device)
    print(json.dumps({"final_round": {**final["summary"],
                                      "fusion_hwc": final["fusion_hwc"]}}))
    print(f"phase 14: {time.time() - t0:.1f} s; script time so far "
          f"{time.time() - t_start:.1f} s")

    t0 = time.time()
    phase(f"15. the weak stage's cost kernel at the benchmark cell's frame: "
          f"{CELL_FRAME[0]}x{CELL_FRAME[1]}x{CELL_FRAME[2]}, round "
          f"{CELL_FRAME[3]}")
    cell = weak_cell_phase(launches, reset, plain, exact, weak_times)
    print(f"phase 15: {time.time() - t0:.1f} s")
    cell_label = f"{CELL_FRAME[0]}x{CELL_FRAME[1]} round {CELL_FRAME[3]}"
    top = next((r for r in weak_times if r["frame"] == cell_label
                and r["mode"] == "cost"), None)
    if top is None:
        fail(f"weak_cost was not timed at {cell_label}: {weak_times}")
    kernels.append({"name": "weakcost", "route": "cuda",
                    "source": SOURCES["weakcost"],
                    "replaces": REPLACES["weakcost"], "max_abs_err": 0.0,
                    "shape": f"{top['views']} x {top['sites'][0]} x "
                             f"{top['sites'][1]} sites ({cell_label})",
                    **{k: top[k] for k in ("ms", "cold_ms", "plain_ms",
                                           "plain_cold_ms", "bound_ms",
                                           "bound_by")},
                    "bands": weak_times,
                    "cell_launches": cell["launches"]["weakcost"],
                    "cell_checked_shapes": cell["checked_shapes"]})

    # Phase 10: the exact engine on the same scene, in memory.
    rect_s = {k: statistics.median(v) for k, v in sweep_s.items()}
    # Left after 10b: 10c, 10d, phase 11 (about phase 9's pipeline: 11a
    # runs the same views) and phase 13.
    ex = exact_phase(sc, out_dir / "exact", cfg, v_pad, launches, reset,
                     modules, t_start, lambda ea, eb: SIDE_PAIRS * (
                         rect_s["A"] + rect_s["B"] + ea + eb) + 60.0
                     + PARALLEL_VIEWS / PIPELINE_VIEWS
                     * launches_p["summary"]["seconds"] + 60.0
                     + ENVELOPE_S)

    phase("10c. kernels at the exact engine's shapes")
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                          device=device)
    for lab, cap in (("exact pass A", ex["cap_a"]), ("exact pass B",
                                                     ex["cap_b"])):
        for name in GATHERS:
            check(name, cap.seen[name], lab)
        print(f"{lab}: bit-exact at every shape (" + ", ".join(
            f"{n} {len(cap.seen[n])}" for n in modules) + ")")
    exact_recs = exact_kernel_times(ex, modules, plain, flush)
    del scratch, ex["cap_a"], ex["cap_b"]

    phase("10d. the two engines side by side (problem 0)")
    cmp = side_by_side(sc, {"rect": (cfg, problems),
                            "exact": (ex["cfg"], ex["problems"])},
                       v_pad, launches, reset)
    print(json.dumps({"engines_side_by_side": cmp}))

    par = parallel_phase(sc, out_dir / "parallel", launches, reset, modules,
                         launches_p["summary"], torch.device("cuda", 0))
    for path, seen in par.pop("seen").items():
        for name in modules:
            check(name, seen[name], path)
        print(f"{path}: bit-exact at every shape (" + ", ".join(
            f"{n} {len(seen[n])}" for n in modules) + ")")
    print(json.dumps({"parallel_vs_sequential": {
        "sequential": launches_p["summary"], **par["summary"]}}))

    phase(f"13. the weak-path envelope: tools/torch_weak_compare.py at "
          f"{W}x{H}x{VIEWS}")
    env = weak_envelope_phase(out_dir / "weak_compare", launches, reset,
                              checked, plain, exact)
    print(json.dumps({"weak_envelope": env["summary"]}))

    for rec in kernels:
        name = rec["name"]
        rec["launches"] = launches_p["all"][name]
        rec["launches_by_path"] = {
            "pass A": launches_a[name], "pass B": launches_b[name],
            "pipeline": launches_p["all"][name],
            **{f"pipeline round {i}": n[name]
               for i, n in enumerate(launches_p["rounds"])},
            "pipeline fusion": launches_p["fusion"][name],
            "exact pass A": ex["a"][name], "exact pass B": ex["b"][name],
            "parallel pipeline": par["parallel pipeline"][name],
            **{f"parallel pipeline round {i}": n[name]
               for i, n in enumerate(par["rounds"])},
            "mesh fusion": par["mesh fusion"][name],
            "tile sweep": par["tile sweep"][name],
            **{f"fullres {path}": n[name]
               for path, n in full["launches"].items()},
            "final round": final["launches"][name],
            "cell frame": cell["launches"][name],
            # The tool counts the gathers' launches only.
            "final round fusion": final["fusion"].get(name, 0),
            **{path: n[name] for path, n in env["launches"].items()}}
        if name in exact_recs:
            rec["exact"] = exact_recs[name]
        if name == "gather2d":
            rec["row4_real_paths"] = full["row4"]
        if name == "gather2d_hwc":
            rec["final_round_fusion"] = final["fusion_hwc"]
    print(f"script time {time.time() - t_start:.1f} s")

    shutil.rmtree(out_dir, ignore_errors=True)
    if any(m.split(".")[0] in ("jax", "cv2", "dpe_mvs_tpu")
           for m in sys.modules):
        fail("the port imported jax, cv2 or the JAX package")
    print(json.dumps({"fullres": full["summary"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
