"""Run one cell of the benchmark once and print its result line.

    python mvs_bench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1> [--control 0|1]

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``dpe_mvs_tpu_torch``). It needs as many CUDA cards as the cell
asks for, and exits with code 2 (printing no result) without them. Set-up
(``setup_s``) runs from the start of this script to the window's start; the
window sweeps for ``--seconds`` (a sweep begun before then is finished);
then the plain reference checks what the window's sweeps and kernels
produced (:mod:`mvs_bench.reference`).

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` passes the
benchmark's CUDA-event timer to the program, profiles the window and prints
the per-layer metrics (``mvs_bench/metrics/*.py``), the device's busy time
and a breakdown. ``--control 1`` puts the plain gathers, computed in
bfloat16, in place of the hand-written kernels: the check must then come out
false. The last line of standard output is one JSON object; the numbers the
check compared, each with its limit, are the last lines of standard error
and the result's last key, ``checks``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CACHE = ROOT / ".mvs_bench_cache"
COST_SAMPLES = 2048            # pixels per sweep whose matching cost is
                               # worked out again


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)


def metric_context(run, win, timer, summary, probe, peak):
    """What the per-layer readers read (see ``mvs_bench/metrics``)."""
    bound = (float(probe.bound_s.item()) if probe.bound_s is not None
             else None)
    return {"sweeps": win.sweeps, "window_s": win.seconds,
            "spans": timer.totals if timer is not None else {},
            "trace": summary, "kernel_bound_s": bound,
            "peak_bytes": peak}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             control: bool, device: str, manifest=None, spec=None,
             limits=None, workdir=None, fault=None):
    """One run of a cell; returns the result dictionary (``checks`` last).
    ``manifest``, ``spec`` and ``limits`` default to the files found by the
    cell's name; ``fault`` (tests) is called with the run after set-up, before
    the probes wrap the kernels."""
    import numpy as np
    import torch

    from mvs_bench import cell as cell_mod
    from mvs_bench import manifest as man
    from mvs_bench import probes, reference, tracer
    from mvs_bench.window import mpix_per_s

    manifest = manifest or man.load_manifest()
    entry = man.cell(manifest, workload)
    if spec is None:
        spec = cell_mod.CellSpec(
            name=workload, config=man.load_config(manifest, entry["config"]),
            traffic=man.load_traffic(entry["traffic"]))
    limits = limits if limits is not None else man.load_limits(workload)
    cuda = torch.device(device).type == "cuda"

    from dpe_mvs_tpu_torch.ops import gather2d, rowgather
    with tempfile.TemporaryDirectory(dir=workdir) as work:
        run = cell_mod.CellRun(spec, seed, device, Path(work), log=log)
        run.setup()
        if fault is not None:
            fault(run)
        probe = probes.KernelProbe(
            {"rowgather": rowgather, "gather2d": gather2d},
            rng=np.random.default_rng([seed, 1]), account=trace,
            replace=cell_mod.control_replace if control else None)
        timer = prof = summary = None
        clock = None
        try:
            if trace:
                timer = tracer.StageTimer(device)
                clock = tracer.WindowClock()
                if cuda:
                    prof = tracer.profiler()
                    prof.__enter__()
            win = run.measure(seconds, probe, timer,
                              clock() if clock is not None else None)
            setup_s = win.starts[0] - T0
            if cuda:
                torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() if cuda else 0)
            if prof is not None:
                prof = None
                t = time.perf_counter()
                events = tracer.stop(log)
                summary = tracer.reduce_trace(events, clock.bounds,
                                              timer.intervals)
                log(f"trace: {time.perf_counter() - t:.3f} s to read "
                    f"{summary.events} device events on streams "
                    f"{summary.streams}; probes' stream "
                    f"{summary.other_s:.3f} s")
        finally:
            if prof is not None:
                tracer.stop()
            probe.remove()
        log(f"window: {win.sweeps} sweeps in {win.seconds:.3f} s, per sweep "
            + ", ".join(f"{s:.3f}" for s in run.sweep_s) + " s")
        if cuda:
            torch.cuda.empty_cache()

        # The check, after the window, on the host.
        t = time.perf_counter()
        numbers, failed = cell_mod.check_numbers(run, probe, COST_SAMPLES,
                                                 limits)
        verdict = reference.judge(numbers, limits)
        log(f"check: {time.perf_counter() - t:.3f} s, "
            f"{len(probe.captures)} kernel launches copied")

        mpix = mpix_per_s(win, run.pixels)
        device_info = {"platform": "gpu" if cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(0) if cuda
                                else "cpu"),
                       "count": 1,
                       "memory_peak_bytes": int(max(peak, run.setup_peak))}
        metrics = {}
        result = {"correct": all(v["ok"] for v in verdict.values()),
                  "attempted": win.sweeps,
                  "failed": int(failed),
                  "metrics": metrics, "device": device_info}
        if trace:
            ctx = metric_context(run, win, timer, summary, probe, peak)
            for m in man.metrics_for(manifest, "per_layer", workload):
                value = man.load_metric(m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info["busy_s"] = summary.busy_s if summary else 0.0
            device_info["window_s"] = (summary.window_s if summary
                                       else win.seconds)
            if summary is not None:
                result["breakdown"] = {
                    "device_ops": [[n, s] for n, s in summary.device_ops],
                    "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
        else:
            e2e = {"setup_s": setup_s, "mpix_per_s": mpix,
                   "peak_mib": peak / 2 ** 20}
            for m in man.metrics_for(manifest, "end_to_end", workload):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                            for k, v in verdict.items()}
        result["_info"] = {"set-up": run.info, "sweep_s": run.sweep_s,
                           "numbers": numbers,
                           "host_peak_mib": resource.getrusage(
                               resource.RUSAGE_SELF).ru_maxrss / 1024,
                           "mpix_per_s": mpix, "peak_mib": peak / 2 ** 20,
                           "launches": probe.per_sweep}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    from mvs_bench import manifest as man
    manifest = man.load_manifest()
    chips = man.cell(manifest, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bool(args.control), "cuda",
                      manifest=manifest)
    bad = man.forbidden_modules(list(sys.modules))
    if bad:
        log("forbidden modules loaded: " + ", ".join(bad))
        return 3
    info = result.pop("_info")
    log("info: " + json.dumps(info))
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
