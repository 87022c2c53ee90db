"""The ETH3D final round as a user runs it, through ``dpe_mvs``, measured.

    python tools/torch_final_round.py [--width 6048] [--height 4032]
        [--views 6] [--resume-iteration K] [--last-iteration N] [--out DIR]
        [--cpu]

An ETH3D frame (6048x4032) takes 4 rounds (``config.compute_round_num``);
the last one sweeps the full frame: pass A and three passes B over every
view, 24 sweeps at 6 views, then the exports and fusion. The tool

  1. renders ``utils.synthetic.make_plane_scene(width, height, views,
     seed=7)`` (the views in threads) and writes it as a dense folder
     (lossless images);
  2. writes the state that iteration K leaves, as the round loop would:
     each problem's ``depths.dmb``, ``normals.dmb``, ``weak.bin`` and
     ``selected_views.bin`` are its ground truth at the size of K's round
     (``utils.synthetic.write_coarse_priors``: every source selected, every
     pixel STRONG), and ``DPE/progress.json`` records K
     (``schedule._save_progress``). K defaults to the last iteration before
     the final round (11 at 6048x4032: round 2's maps at 3024x2016); K = 14
     is the state before round 3's last pass B. Nothing else is written, so
     the round loop computes every scale's edge and label maps itself;
  3. runs the user's call, ``api.dpe_mvs(folder, resume=True, fusion=True,
     depth=True, normal=True, weak=True, edge=True)`` with the default
     ``EngineConfig`` (the rect engine), on the card (``--cpu``: on the
     CPU; without a card and without ``--cpu`` it raises).

With ``--out DIR`` the dense folder is DIR and is kept; a DIR that already
holds ``DPE/progress.json`` is resumed from it as it stands (K is read from
it) unless ``--resume-iteration`` is given. ``--last-iteration N`` stops the
round loop once iteration N is recorded, before the exports and fusion, so
that a run can be made in pieces: say ``--last-iteration 13``, then again on
the same DIR. Without ``--out`` the folder is a temporary one, removed at
the end.

It prints a line per sweep, a short summary and, last, one JSON line: the
seconds of each iteration and of each sweep; per sweep the device's peak
(``max_memory_allocated``), what was allocated as it started (what an
earlier sweep left) and ``max_memory_reserved``, each stage's peak
and the stage that sets the sweep's (on the card the tool synchronises as
each stage starts and ends, and resets the peak counters there), and the
host's resident memory after the sweep; the host
spans of ``utils.profiling.GLOBAL_TIMER`` (``edges, scale s``, ``load``,
``rectify``, ``src-depth rectify``, ``writeback``, ``fusion`` and the sweep
stages) and the seconds of ``export_npy`` and ``cleanup_intermediates``;
each prefetched load (the next problem's inputs, read on the host while a
sweep runs) against the sweep it overlaps; the host memory the round's rect
hosts hold; the host's peak resident memory (``resource.getrusage``); the
launches of each kernel entry per iteration and in fusion (0 on the CPU,
where the plain versions run); per problem the median relative depth error
and valid share against the ground truth (``tools/torch_eval``); and the
fused cloud's points, precision, recall and F at tau = 0.005 x the median
depth (``tools/torch_eval.fscore``; the ground truth sampled every
``gt_stride(width)``-th pixel).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import resource
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SCENE_SEED = 7


class _Stopped(Exception):
    """Raised from the round loop once the requested last iteration is
    recorded."""


def final_round_start(round_num: int) -> int:
    """The last iteration before the final round of a ``round_num``-round
    schedule (4 iterations a round)."""
    return 4 * (round_num - 1) - 1


def gt_stride(width: int) -> int:
    """Every how many pixels the ground-truth surface is sampled for the
    F-score: 2 at 800 wide, as ``chip_smoke.py`` phase 9 samples it, and the
    same share of the frame at larger widths (15 at 6048: ~0.011 world
    units apart, under the 0.02 of tau)."""
    return max(2, width // 400)


def write_state(sc, folder, iteration: int, round_num: int) -> None:
    """The state that ``iteration`` leaves in the dense folder ``folder``:
    every view's ground truth at the size of the iteration's round, and
    ``DPE/progress.json``."""
    from dpe_mvs_tpu_torch.io import formats
    from dpe_mvs_tpu_torch.pipeline import schedule
    from dpe_mvs_tpu_torch.utils.synthetic import write_coarse_priors
    if not 0 <= iteration < 4 * round_num:
        raise ValueError(f"iteration {iteration} is not one of the "
                         f"{4 * round_num} of a {round_num}-round schedule")
    step = 2 ** (round_num - 1 - iteration // 4)
    for v in range(len(sc.images)):
        write_coarse_priors(sc, v, formats.result_folder(folder, v), step)
    schedule._save_progress(folder, iteration)


def _host_bytes(obj) -> int:
    """Bytes of the numpy arrays in a rect host (tuples of warp fields)."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, tuple):
        return sum(_host_bytes(x) for x in obj)
    return 0


def _rss_mib() -> float:
    """The host's resident memory now (Linux), else its peak so far."""
    try:
        pages = int(Path("/proc/self/statm").read_text().split()[1])
        return pages * resource.getpagesize() / 2**20
    except (OSError, ValueError, IndexError):
        return _peak_rss_mib()


def _peak_rss_mib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _overlap(a, b) -> float:
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def run(width: int = 6048, height: int = 4032, views: int = 6,
        resume_iteration=None, last_iteration=None, out=None,
        device="cuda", scene=None, verbose: bool = True,
        around_fusion=contextlib.nullcontext) -> dict:
    """Write the dense folder and iteration K's state, run ``dpe_mvs``
    resumed with fusion, and return what the JSON line prints (module
    docstring). ``scene``: a ``utils.synthetic.PlaneScene`` to use in place
    of rendering one (its size and views then set the run's). ``device``:
    "cuda" (the card, ``dpe_mvs``'s default) or "cpu". ``around_fusion``: a
    context manager factory entered around fusion, inside its timing."""
    import torch
    from dpe_mvs_tpu_torch import api
    from dpe_mvs_tpu_torch.config import EngineConfig, compute_round_num
    from dpe_mvs_tpu_torch.io import formats
    from dpe_mvs_tpu_torch.io import scene as scene_mod
    from dpe_mvs_tpu_torch.ops import gather2d, rowgather
    from dpe_mvs_tpu_torch.pipeline import fusion, schedule
    from dpe_mvs_tpu_torch.utils.profiling import GLOBAL_TIMER, outermost
    from dpe_mvs_tpu_torch.utils.synthetic import make_plane_scene, \
        write_scene_folder
    from tools.torch_eval import depth_report, depth_scale, evaluate_scene

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("the final round runs on the card, and "
                           "torch.cuda is not available (--cpu runs it on "
                           "the CPU)")
    t_start = time.time()
    if scene is None:
        scene = make_plane_scene(width=width, height=height,
                                 num_views=views, seed=SCENE_SEED)
    sc = scene
    width, height, views = sc.width, sc.height, len(sc.images)
    round_num = compute_round_num(width, height, EngineConfig())
    keep = out is not None
    folder = Path(out) if keep else Path(tempfile.mkdtemp(
        prefix="dpe_final_round_"))
    resumed = (resume_iteration is None
               and (folder / "DPE" / "progress.json").exists())
    if resumed:
        k = schedule._load_progress(folder)
    else:
        k = (final_round_start(round_num) if resume_iteration is None
             else int(resume_iteration))
        write_scene_folder(sc, folder)
        write_state(sc, folder, k, round_num)
    setup_s = time.time() - t_start
    if verbose:
        print(f"{width}x{height}x{views}: {round_num} rounds; resuming after "
              f"iteration {k}{' (progress.json)' if resumed else ''}; "
              f"folder {folder} ready in {setup_s:.1f} s", flush=True)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def launches():
        return {**rowgather.LAUNCHES, **gather2d.LAUNCHES}

    t0 = time.time()
    sweeps, loads, iters, fused = [], [], {}, {}
    rect_mib = [0.0]
    host = {"export_npy": 0.0, "cleanup_intermediates": 0.0}
    lock = threading.Lock()
    # An iteration runs from its first load (the round loop submits it once
    # the previous iteration is recorded) to its progress record.
    state = {"iter_start": None, "launches": launches()}
    spans_before = dict(GLOBAL_TIMER.totals)
    orig = {"process_problem": schedule.process_problem,
            "_save_progress": schedule._save_progress,
            "export_npy": schedule.export_npy,
            "cleanup_intermediates": schedule.cleanup_intermediates,
            "load_problem_inputs": scene_mod.load_problem_inputs,
            "run_fusion": fusion.run_fusion}

    def process_problem(p, params, *args, **kw):
        # On the card, each stage's peak: the counters are reset as each
        # span starts (after a synchronisation) and the sweep's peak is the
        # largest of what they read.
        peaks = {"allocated": 0, "reserved": 0}
        stage_mib = {}
        span = kw.get("timer") or (lambda name: contextlib.nullcontext())

        def note():
            peaks["allocated"] = max(peaks["allocated"],
                                     torch.cuda.max_memory_allocated(device))
            peaks["reserved"] = max(peaks["reserved"],
                                    torch.cuda.max_memory_reserved(device))

        @contextlib.contextmanager
        def timer(name):
            sync()
            note()
            torch.cuda.reset_peak_memory_stats(device)
            with span(name):
                yield
            sync()
            stage_mib[name] = max(stage_mib.get(name, 0.0),
                                  torch.cuda.max_memory_allocated(device)
                                  / 2**20)
            note()

        sync()
        held = torch.cuda.memory_allocated(device) if on_card else None
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
            kw["timer"] = outermost(timer)
        ts = time.time()
        orig["process_problem"](p, params, *args, **kw)
        sync()
        te = time.time()
        if on_card:
            note()
        rect_mib[0] = max(rect_mib[0], sum(
            _host_bytes(rh[:4]) for rh in schedule._RECT_HOSTS.values())
            / 2**20)
        rec = {"iteration": p.iteration, "problem": p.ref_image_id,
               "seconds": te - ts, "span": (ts - t0, te - t0),
               "allocated_before_mib": (held / 2**20 if on_card else None),
               "peak_allocated_mib": (peaks["allocated"] / 2**20
                                      if on_card else None),
               "max_reserved_mib": (peaks["reserved"] / 2**20
                                    if on_card else None),
               "peak_stage": (max(stage_mib, key=stage_mib.get)
                              if stage_mib else None),
               "stage_peak_mib": stage_mib, "host_rss_mib": _rss_mib()}
        sweeps.append(rec)
        if verbose:
            peak = ("" if not on_card else
                    f", peak {rec['peak_allocated_mib']:.1f} MiB allocated "
                    f"(in {rec['peak_stage']}), "
                    f"{rec['max_reserved_mib']:.1f} MiB reserved")
            print(f"iteration {p.iteration} problem {p.ref_image_id}: "
                  f"{rec['seconds']:.2f} s{peak}, host resident "
                  f"{rec['host_rss_mib']:.0f} MiB", flush=True)

    def load_problem_inputs(p, *args, **kw):
        ts = time.time()
        with lock:
            if state["iter_start"] is None:
                state["iter_start"] = ts
        out_ = orig["load_problem_inputs"](p, *args, **kw)
        with lock:
            loads.append({"problem": p.ref_image_id,
                          "span": (ts - t0, time.time() - t0)})
        return out_

    def save_progress(dense_folder, iteration):
        orig["_save_progress"](dense_folder, iteration)
        now, n = time.time(), launches()
        iters[iteration] = {
            "seconds": now - state["iter_start"],
            "launches": {e: c - state["launches"][e] for e, c in n.items()}}
        state["iter_start"], state["launches"] = None, n
        if verbose:
            print(f"iteration {iteration} recorded: "
                  f"{iters[iteration]['seconds']:.2f} s, launches "
                  f"{iters[iteration]['launches']}", flush=True)
        if last_iteration is not None and iteration >= last_iteration:
            raise _Stopped

    def timed(name):
        def wrapped(*args, **kw):
            ts = time.time()
            try:
                return orig[name](*args, **kw)
            finally:
                host[name] += time.time() - ts
        return wrapped

    def run_fusion(*args, **kw):
        before = launches()
        sync()
        ts = time.time()
        with around_fusion():
            path = orig["run_fusion"](*args, **kw)
        sync()
        fused["seconds"] = time.time() - ts
        fused["launches"] = {e: c - before[e] for e, c in launches().items()}
        return path

    schedule.process_problem = process_problem
    schedule._save_progress = save_progress
    schedule.export_npy = timed("export_npy")
    schedule.cleanup_intermediates = timed("cleanup_intermediates")
    scene_mod.load_problem_inputs = load_problem_inputs
    fusion.run_fusion = run_fusion
    stopped = False
    try:
        api.dpe_mvs(str(folder), 0, verbose, True, False, True, True, True,
                    True, resume=True,
                    device=None if on_card else device)
    except RuntimeError as e:
        if not isinstance(e.__cause__, _Stopped):
            raise
        stopped = True
    finally:
        schedule.process_problem = orig["process_problem"]
        schedule._save_progress = orig["_save_progress"]
        schedule.export_npy = orig["export_npy"]
        schedule.cleanup_intermediates = orig["cleanup_intermediates"]
        scene_mod.load_problem_inputs = orig["load_problem_inputs"]
        fusion.run_fusion = orig["run_fusion"]
    run_s = time.time() - t0

    spans = {n: s - spans_before.get(n, 0.0)
             for n, s in GLOBAL_TIMER.totals.items()
             if s - spans_before.get(n, 0.0) > 0}
    # Each prefetched load against the sweep it overlaps most (the first
    # load of an iteration overlaps none).
    for ld in loads:
        it = max(sweeps, key=lambda s: _overlap(ld["span"], s["span"]),
                 default=None)
        ld["seconds"] = ld["span"][1] - ld["span"][0]
        ld["overlap_s"] = 0.0 if it is None else _overlap(ld["span"],
                                                          it["span"])
        ld["overlaps_sweep"] = (None if not ld["overlap_s"] else
                                [it["iteration"], it["problem"]])
        del ld["span"]
    problems = {}
    for v in range(views):
        rf = formats.result_folder(folder, v)
        if stopped:
            d = formats.read_dmb(rf / "depths.dmb")
            d = np.where(np.isfinite(d), d, 0.0)
        else:
            d = np.load(rf / "depth.npy")
        rep = depth_report(d, sc.gt_depths[v])
        problems[v] = {"median_rel_err": rep["median_rel_err"],
                       "valid": rep["completeness"]}
    cloud = None
    if not stopped:
        t_eval = time.time()
        tau = 0.005 * depth_scale(sc)
        rep = evaluate_scene(sc, folder, tau=tau, gt_stride=gt_stride(width))
        cloud = {"points": rep["cloud"]["cloud_points"],
                 "precision": rep["cloud"]["precision"],
                 "recall": rep["cloud"]["recall"],
                 "fscore": rep["cloud"]["fscore"], "tau": tau,
                 "gt_stride": gt_stride(width),
                 "eval_s": time.time() - t_eval}
    if not keep:
        shutil.rmtree(folder, ignore_errors=True)
    res = {
        "frame": [width, height], "views": views, "round_num": round_num,
        "resumed_after": k, "stopped_after": (max(iters) if stopped
                                              else None),
        "device": (torch.cuda.get_device_name(device) if on_card
                   else "cpu"),
        "setup_s": setup_s, "run_s": run_s,
        "iteration_s": {i: r["seconds"] for i, r in iters.items()},
        "sweeps": [{k_: v_ for k_, v_ in s.items() if k_ != "span"}
                   for s in sweeps],
        "max_sweep_peak_mib": (max(s["peak_allocated_mib"] for s in sweeps)
                               if on_card and sweeps else None),
        "max_reserved_mib": (max(s["max_reserved_mib"] for s in sweeps)
                             if on_card and sweeps else None),
        "host_spans_s": {**spans, **host},
        "prefetch_loads": loads, "rect_hosts_mib": rect_mib[0],
        "host_peak_rss_mib": _peak_rss_mib(),
        "launches_per_iteration": {i: r["launches"]
                                   for i, r in iters.items()},
        "launches_fusion": fused.get("launches"),
        "fusion_s": fused.get("seconds"),
        "problems": problems, "cloud": cloud,
        "folder": str(folder) if keep else None}
    if verbose:
        print(summary(res), flush=True)
    return res


def summary(res: dict) -> str:
    """A few lines for a reader: seconds per iteration, the largest peak,
    host memory and spans, depth errors and the cloud."""
    spans = res["host_spans_s"]
    edges = {n: round(s, 2) for n, s in spans.items()
             if n.startswith("edges")}
    lines = [
        f"final round {res['frame'][0]}x{res['frame'][1]}x{res['views']} on "
        f"{res['device']}: resumed after iteration {res['resumed_after']}, "
        f"{len(res['sweeps'])} sweeps in {res['run_s']:.1f} s (setup "
        f"{res['setup_s']:.1f} s)",
        "seconds per iteration: " + ", ".join(
            f"{i}: {s:.1f}" for i, s in res["iteration_s"].items()),
        f"largest sweep peak {res['max_sweep_peak_mib']} MiB allocated, "
        f"{res['max_reserved_mib']} MiB reserved; host peak resident "
        f"{res['host_peak_rss_mib']:.0f} MiB, rect hosts "
        f"{res['rect_hosts_mib']:.0f} MiB",
        f"edges {edges}; fusion {res['fusion_s']} s; exports "
        f"{spans.get('export_npy', 0.0):.2f} s; cleanup "
        f"{spans.get('cleanup_intermediates', 0.0):.2f} s",
        "problems (median, valid): " + ", ".join(
            f"{v}: {p['median_rel_err']}, {p['valid']}"
            for v, p in res["problems"].items())]
    if res["cloud"] is not None:
        c = res["cloud"]
        lines.append(f"cloud: {c['points']} points, precision "
                     f"{c['precision']}, recall {c['recall']}, F "
                     f"{c['fscore']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=6048)
    ap.add_argument("--height", type=int, default=4032)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--resume-iteration", type=int, default=None,
                    help="write the state this iteration leaves (default: "
                         "the folder's progress.json, else the last "
                         "iteration before the final round)")
    ap.add_argument("--last-iteration", type=int, default=None,
                    help="stop once this iteration is recorded")
    ap.add_argument("--out", default=None,
                    help="the dense folder (kept); default: a temporary one")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    res = run(args.width, args.height, args.views, args.resume_iteration,
              args.last_iteration, args.out, "cpu" if args.cpu else "cuda")
    print(json.dumps({"final_round": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
