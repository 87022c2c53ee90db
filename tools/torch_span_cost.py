"""What the pipeline's stage spans cost, on one NVIDIA GPU.

    python3 tools/torch_span_cost.py [--width 800] [--height 600] [--views 6]
                                     [--pairs 1]

Writes the synthetic plane scene (``make_plane_scene``, seed 7) to a dense
folder and runs the PyTorch port's pipeline on it
(``dpe_mvs_tpu_torch.pipeline.schedule.run_pipeline``, the path of
``dpe_mvs`` and the CLI) once per run, each run on a fresh copy of the
folder, in one of three modes:

  none    ``verbose=False``: nothing is timed, as in a user's quiet run;
  events  ``verbose=True`` with ``schedule.GLOBAL_TIMER`` a fresh
          ``utils.profiling.StageTimer``: spans timed by CUDA events and
          host synchronisations counted (what ``verbose`` does);
  sync    ``verbose=True`` with spans that synchronise the card when they
          start and before the clock stops.

The timed modes' printed output is captured and dropped.

The modes run in turns, in order then reversed (none, events, sync, sync,
events, none) for each of ``--pairs``, after one warm-up run at a quarter
of the size. Prints the card's name and power limit, each run's wall time,
each mode's median and its difference to ``none``, and the two timers'
stage totals of their first run; the last line is JSON. Exits non-zero
without a card. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MODES = ("none", "events", "sync")


class SyncTimer:
    """Host-clock spans that synchronise ``device`` before the block starts
    and before the clock stops."""

    def __init__(self) -> None:
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def span(self, name, device=None):
        import torch
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize(device)
            self.totals[name] = self.totals.get(name, 0.0) \
                + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return "\n".join(f"{k} {v:.2f}s x{self.counts[k]}"
                         for k, v in self.totals.items())


def run(folder: Path, mode: str, work: Path) -> tuple:
    """One pipeline run on a fresh copy of ``folder`` in ``mode``:
    (seconds, stage totals)."""
    import torch
    from dpe_mvs_tpu_torch.pipeline import schedule
    from dpe_mvs_tpu_torch.utils.profiling import StageTimer
    make = {"none": None, "events": StageTimer, "sync": SyncTimer}[mode]
    timer = make() if make is not None else None
    copy = work / f"run_{mode}"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(folder, copy)
    if timer is not None:
        schedule.GLOBAL_TIMER = timer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = schedule.run_pipeline(copy, verbose=timer is not None,
                                   depth=True, normal=True, weak=True,
                                   edge=True, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if rc != 0:
        sys.exit(f"run_pipeline returned {rc}")
    totals = dict(timer.totals) if timer is not None else {}
    shutil.rmtree(copy)
    return dt, totals


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a "
                 "GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed")
    from dpe_mvs_tpu_torch.ops import cudalib, gather2d, rowgather
    from dpe_mvs_tpu_torch.utils.synthetic import make_plane_scene, \
        write_scene_folder
    cudalib.build_many([rowgather.SOURCE, gather2d.SOURCE])

    work = Path(tempfile.mkdtemp(prefix="dpe_span_cost_"))
    try:
        sc = make_plane_scene(width=args.width // 4, height=args.height // 4,
                              num_views=args.views, seed=7)
        warm = write_scene_folder(sc, work / "warm")
        print(f"warm-up ({args.width // 4}x{args.height // 4}): "
              f"{run(warm, 'events', work)[0]:.2f} s")
        sc = make_plane_scene(width=args.width, height=args.height,
                              num_views=args.views, seed=7)
        folder = write_scene_folder(sc, work / "scene")
        order = [*MODES, *MODES[::-1]] * args.pairs
        times = {m: [] for m in MODES}
        stages = {}
        for mode in order:
            dt, totals = run(folder, mode, work)
            times[mode].append(dt)
            stages.setdefault(mode, totals)
            print(f"{mode}: {dt:.2f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    med = {m: statistics.median(t) for m, t in times.items()}
    for m in MODES:
        print(f"{m}: median {med[m]:.2f} s over {len(times[m])} runs "
              f"({', '.join(f'{t:.2f}' for t in times[m])}); "
              f"{med[m] - med['none']:+.2f} s "
              f"({(med[m] / med['none'] - 1) * 100:+.2f}%) against none")
    for m in ("events", "sync"):
        print(f"stage totals, {m}, first run (s): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(stages[m].items(),
                                                key=lambda kv: -kv[1])))
    print(json.dumps({"size": [args.width, args.height, args.views],
                      "order": order, "seconds": times, "median": med,
                      "stages": {m: stages[m] for m in ("events", "sync")}}))


if __name__ == "__main__":
    main()
