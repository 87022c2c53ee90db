"""The readings that a cell's limits are set from, in one process on the
card: the cell's set-up once, then, each from the same state after set-up,
the sound timed path, the program faults (:mod:`.faults`) and the control,
and every number of the check for each, per sweep and per seed.

    python3 mvs_bench/readings.py --workload eth3d-r1.passB \\
        --seeds 3000000601,3000000602,3000000603 --out readings.json

``--sweeps`` sweeps (cycling over the traffic's problems as the window
does) are read for the sound path and ``--fault-sweeps`` for each fault;
the map faults are read from the sound sweeps' maps, altered as they would
have been written. ``--views`` adds one sound sweep of each view named, for
the record. The seed draws what a run's seed draws: the check's samples and
the probes' copied launches. Beside the numbers it records the host's state
(CPU steal time, a launch-rate probe, the card's clocks) before and after.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def host_state(device: str) -> dict:
    """CPU time stolen by the host so far, a launch rate and the card's
    clocks: what tells a slow host from a slow card."""
    import torch
    out = {"t": time.perf_counter() - T0, "loadavg": os.getloadavg()}
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()[1:]
        out["proc_stat_cpu"] = [int(x) for x in cpu]
    except OSError:
        pass
    t = time.perf_counter()
    n = 0
    while time.perf_counter() - t < 0.5:
        sum(range(1000))
        n += 1
    out["py_loops_per_s"] = n / (time.perf_counter() - t)
    if torch.device(device).type == "cuda":
        x = torch.zeros(1, device=device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(20000):
            x.add_(1.0)
        torch.cuda.synchronize()
        out["launches_per_s"] = 20000 / (time.perf_counter() - t)
        try:
            out["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
                 "clocks.sm,clocks.max.sm,temperature.gpu",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            pass
    return out


class NoProbe:
    """A probe that copies nothing (the timing of a sweep without one)."""
    per_sweep: list = []
    captures: list = []

    def start_sweep(self):
        pass

    def finish(self):
        pass

    def remove(self):
        pass

    def missing(self):
        return []


def read_all(workload: str, seeds, sweeps: int, fault_sweeps: int,
             faults, views, device: str, spec=None, manifest=None,
             workdir=None) -> dict:
    """The readings (see the module's docstring) as one dictionary."""
    import numpy as np
    import torch

    from mvs_bench import cell as cell_mod
    from mvs_bench import faults as fault_mod
    from mvs_bench import manifest as man
    from mvs_bench import probes, reference
    from mvs_bench import run as bench
    from mvs_bench import window

    manifest = manifest or man.load_manifest()
    entry = man.cell(manifest, workload)
    if spec is None:
        spec = cell_mod.CellSpec(
            name=workload, config=man.load_config(manifest, entry["config"]),
            traffic=man.load_traffic(entry["traffic"]))
    from dpe_mvs_tpu_torch.ops import gather2d, rowgather
    modules = {"rowgather": rowgather, "gather2d": gather2d}
    out = {"workload": workload, "seeds": list(seeds),
           "host": [host_state(device)]}

    with tempfile.TemporaryDirectory(dir=workdir) as work:
        run = cell_mod.CellRun(spec, seeds[0], device, Path(work), log=log)
        run.setup()
        out["setup"] = dict(run.info)
        for v in views:
            run.last.setdefault(v, run.read_prior(v))
        state_dir = Path(run.problems[0].result_folder).parent
        saved = Path(work) / "saved_state"
        shutil.copytree(state_dir, saved)
        last0 = dict(run.last)
        order0 = list(run.order)
        box = (fault_mod.patch_box(run.scene, run.scale_size)
               if run.scene.weak_box is not None else None)
        all_views = sorted({v for v in order0 + list(views)}
                           | {s for v in order0 + list(views)
                              for s in run.scene.src_ids(v)})
        images = reference.images_at_round(run.scene, all_views,
                                           run.scale_size)

        def sweep_path(order, n, fault=None, control=False, probe_on=True):
            """``n`` sweeps cycling over ``order`` from the state after
            set-up; the probe's launches drawn with the first seed."""
            shutil.rmtree(state_dir)
            shutil.copytree(saved, state_dir)
            run.last = dict(last0)
            run.order = list(order)
            run.maps, run.pending, run.pixels, run.sweep_s = [], [], [], []

            def n_sweeps(sweep, seconds):
                done = []
                return window.run_window(
                    lambda k: (sweep(k), done.append(k)), float(n),
                    clock=lambda: float(len(done)))
            probe = (probes.KernelProbe(
                modules, rng=np.random.default_rng([seeds[0], 1]),
                replace=cell_mod.control_replace if control else None)
                if probe_on else NoProbe())
            with fault_mod.patched(cell_mod, "run_window", n_sweeps):
                try:
                    with (fault() if fault is not None
                          else contextlib.nullcontext()):
                        run.measure(float(n), probe)
                finally:
                    probe.remove()
            return probe

        def numbers(maps_list, probe=None):
            per_seed = []
            for s in seeds:
                rng = np.random.default_rng([s, 2])
                per = [reference.sweep_numbers(m, run.scene, run.scale_size,
                                               run.params.top_k, rng,
                                               bench.COST_SAMPLES, images)
                       for m in maps_list]
                per_seed.append(per)
            res = {"per_seed_per_sweep": per_seed,
                   "worst_per_seed": [reference.worst(p) for p in per_seed],
                   "sweep_s": list(run.sweep_s),
                   "views": [m.view for m in maps_list]}
            if probe is not None:
                res["kernels"] = cell_mod.kernel_numbers(probe)
            return res

        t = time.perf_counter()
        probe = sweep_path(order0, sweeps)
        sound_maps = list(run.maps)
        out["sound"] = numbers(sound_maps, probe)
        log(f"sound: {time.perf_counter() - t:.1f} s, sweeps "
            f"{run.sweep_s}")
        for name in fault_mod.MAP_FAULTS:
            if name.startswith("patch_") and box is None:
                continue
            out[name] = numbers([fault_mod.on_maps(name, m, box)
                                 for m in sound_maps])
        for name in faults:
            t = time.perf_counter()
            if name == "control":
                probe = sweep_path(order0, fault_sweeps, control=True)
            elif name == "no_probe":
                probe = sweep_path(order0, fault_sweeps, probe_on=False)
            else:
                probe = sweep_path(order0, fault_sweeps,
                                   fault=fault_mod.PROGRAM_FAULTS[name])
            out[name] = numbers(list(run.maps),
                                probe if name != "no_probe" else None)
            log(f"{name}: {time.perf_counter() - t:.1f} s, sweeps "
                f"{run.sweep_s}")
        if views:
            t = time.perf_counter()
            probe = sweep_path(list(views), len(views))
            out["views"] = numbers(list(run.maps), probe)
            log(f"views {list(views)}: {time.perf_counter() - t:.1f} s")
    out["host"].append(host_state(device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--fault-sweeps", type=int, default=2)
    ap.add_argument("--faults", default="weak_skipped,cost_bf16,control,"
                    "no_probe")
    ap.add_argument("--views", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from mvs_bench import run as bench
    bench.cache_env()
    import torch
    if not torch.cuda.is_available():
        log("the readings need a CUDA card")
        return 2
    res = read_all(args.workload, [int(s) for s in args.seeds.split(",")],
                   args.sweeps, args.fault_sweeps,
                   [f for f in args.faults.split(",") if f],
                   [int(v) for v in args.views.split(",") if v], "cuda")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    for name, r in res.items():
        if isinstance(r, dict) and "worst_per_seed" in r:
            log(f"{name}: " + json.dumps(r["worst_per_seed"][0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
