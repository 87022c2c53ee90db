"""Per-stage probe of the PyTorch port at a given frame size.

    python tools/torch_probe.py WIDTH HEIGHT VIEWS [apd|noapd] [geom]
        [--cpu] [--band-full-bytes B] [--band-field-bytes B] [--snapshot]

The port's counterpart of ``tools/tpu_probe.py`` (which imports jax). It
renders ``utils.synthetic.make_plane_scene(width, height, views, seed=3)`` in
memory and runs problem 0 through ``pipeline.schedule.process_problem``: a
FIRST_INIT sweep (round-0 pass A), then with ``apd`` the modal sweep
(``schedule_params(base, 1, 0 if geom else None)``) from that sweep's
writeback, with the stand-in support maps of ``utils.synthetic.support_maps``
and, with ``geom``, every source view's depth map a constant mid-range depth
(as ``tools/tpu_probe.py`` does). Per sweep it prints the seconds, the stage
spans (each span synchronised with the device), the device memory free
before the sweep and its peak (``max_memory_allocated``, reset before it),
the launches of each kernel entry and the full-resolution branches taken
(``utils.profiling.BRANCHES``), then one JSON line of the same. Each sweep
builds its rect host anew, so its spans hold all of its host work.

``--band-full-bytes`` / ``--band-field-bytes`` set
``engine.rectcost.BAND_FULL_BYTES`` / ``BAND_FIELD_BYTES`` (``inf`` turns
the row banding off). On an out-of-memory error the probe prints the failed
allocation and the largest live blocks (with ``--snapshot``, which records
allocation history at a host cost, the Python frames that allocated them),
then exits 2. It runs on the card unless given ``--cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _holders(top: int = 12):
    """The largest live blocks of the device memory snapshot, with the
    frames recorded for them (``--snapshot``)."""
    import torch
    blocks = []
    for seg in torch.cuda.memory_snapshot():
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = blk.get("frames") or []
            where = [f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                     for f in frames if "dpe_mvs" in f["filename"]
                     or "torch_probe" in f["filename"]]
            blocks.append((blk["size"], where[:4]))
    blocks.sort(key=lambda b: -b[0])
    total = sum(b[0] for b in blocks)
    return total, blocks[:top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("width", type=int)
    ap.add_argument("height", type=int)
    ap.add_argument("views", type=int)
    ap.add_argument("mode", nargs="?", default="noapd",
                    choices=["apd", "noapd"])
    ap.add_argument("geom", nargs="?", default="", choices=["", "geom"])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--band-full-bytes", type=float, default=None)
    ap.add_argument("--band-field-bytes", type=float, default=None)
    ap.add_argument("--snapshot", action="store_true",
                    help="record allocation history for the OOM report")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from dpe_mvs_tpu_torch.config import EngineConfig, PatchMatchParams, \
        schedule_params
    from dpe_mvs_tpu_torch.engine import rectcost
    from dpe_mvs_tpu_torch.io import scene
    from dpe_mvs_tpu_torch.ops import gather2d as g2d
    from dpe_mvs_tpu_torch.ops import rowgather as rg
    from dpe_mvs_tpu_torch.pipeline import schedule as sch
    from dpe_mvs_tpu_torch.utils.profiling import BRANCHES
    from dpe_mvs_tpu_torch.utils.synthetic import make_plane_scene, \
        support_maps

    device = torch.device("cpu" if args.cpu else "cuda")
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("no CUDA device (pass --cpu to run on the CPU)", flush=True)
        return 1
    if args.band_full_bytes is not None:
        rectcost.BAND_FULL_BYTES = args.band_full_bytes
    if args.band_field_bytes is not None:
        rectcost.BAND_FIELD_BYTES = args.band_field_bytes
    if cuda and args.snapshot:
        torch.cuda.memory._record_memory_history(max_entries=200_000)
    apd, geom = args.mode == "apd", args.geom == "geom"
    W, H, V = args.width, args.height, args.views
    print(f"device {torch.cuda.get_device_name(device) if cuda else 'cpu'}; "
          f"torch {torch.__version__}; rect bands over "
          f"{rectcost.BAND_FULL_BYTES:g} B, {rectcost.BAND_FIELD_BYTES:g} B "
          f"per band field", flush=True)

    t0 = time.time()
    sc = make_plane_scene(width=W, height=H, num_views=V, seed=3)
    print(f"scene {W}x{H}x{V} rendered in {time.time() - t0:.1f} s",
          flush=True)
    out = Path(tempfile.mkdtemp(prefix="dpe_probe_"))
    p0 = scene.Problem(index=0, ref_image_id=0, src_image_ids=sc.src_ids(0),
                       dense_folder=out)
    base = PatchMatchParams()
    cfg = EngineConfig(seed=3)
    v_pad = V - 1

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def launches():
        return {**rg.LAUNCHES, **g2d.LAUNCHES}

    def sweep(label, params, inputs, maps=None):
        spans = {}

        @contextlib.contextmanager
        def timer(name):
            sync()
            ts = time.time()
            yield
            sync()
            spans[name] = spans.get(name, 0.0) + time.time() - ts

        sync()
        free = torch.cuda.mem_get_info(device)[0] if cuda else None
        held = torch.cuda.memory_allocated(device) if cuda else None
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        before = launches()
        BRANCHES.clear()
        sch._RECT_HOSTS.clear()
        ts = time.time()
        try:
            sch.process_problem(p0, params, 1, 1, v_pad, cfg, device=device,
                                inputs=inputs, support_maps=maps, timer=timer)
        except torch.OutOfMemoryError as e:
            print(f"{label}: out of memory: {e}".splitlines()[0], flush=True)
            rec = {"sweep": label, "oom": str(e).splitlines()[0],
                   "spans": spans, "free_before_mib": free / 2**20,
                   "peak_mib": torch.cuda.max_memory_allocated(device)
                   / 2**20}
            total, top = _holders()
            rec["live_mib"] = total / 2**20
            rec["holders"] = [{"mib": b / 2**20, "at": w} for b, w in top]
            print(f"live blocks {total / 2**20:.1f} MiB; largest (with "
                  f"--snapshot, where they were allocated):")
            for b, w in top:
                print(f"  {b / 2**20:9.1f} MiB  {' <- '.join(w)}")
            print(json.dumps({"probe": rec}), flush=True)
            raise
        sync()
        rec = {"sweep": label, "seconds": time.time() - ts,
               "spans": spans,
               "launches": {k: v - before[k] for k, v in launches().items()},
               "branches": dict(BRANCHES)}
        if cuda:
            rec["free_before_mib"] = free / 2**20
            rec["allocated_before_mib"] = held / 2**20
            rec["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
        print(f"{label}: {rec['seconds']:.2f} s, peak "
              f"{rec.get('peak_mib', float('nan')):.1f} MiB (before it "
              f"{(held or 0) / 2**20:.1f} MiB allocated, "
              f"{(free or 0) / 2**20:.1f} MiB free)\n  spans " + ", ".join(
                  f"{k} {v:.3f}" for k, v in spans.items()) +
              f"\n  launches {rec['launches']}\n  branches {rec['branches']}",
              flush=True)
        return rec

    recs = []
    try:
        recs.append(sweep("FIRST_INIT", schedule_params(base, 0, None),
                          sc.problem_inputs(0)))
        if apd:
            params = schedule_params(base, 1, 0 if geom else None)
            inputs = scene.add_pass_inputs(
                sc.problem_inputs(0), p0.result_folder, [],
                **{**sch.pass_needs(params), "need_src_depths": False})
            if geom:
                mid = 0.5 * (inputs.depth_min + inputs.depth_max)
                inputs.src_depths = np.full((V, H, W), mid, np.float32)
            p0.iteration = 1
            recs.append(sweep("modal REFINE_ITER", params, inputs,
                              support_maps(inputs.images[0])))
    except torch.OutOfMemoryError:
        return 2
    from dpe_mvs_tpu_torch.io import formats
    dm = formats.read_dmb(p0.result_folder / "depths.dmb")
    gt = sc.gt_depths[0]
    ok = dm > 0
    med = float(np.median(np.abs(dm[ok] - gt[ok]) / gt[ok])) if ok.any() \
        else float("inf")
    print(f"problem 0: median rel depth error {med:.5f}, valid "
          f"{float(ok.mean()):.4f}", flush=True)
    print(json.dumps({"probe": {"width": W, "height": H, "views": V,
                                "apd": apd, "geom": geom,
                                "band_full_bytes": rectcost.BAND_FULL_BYTES,
                                "band_field_bytes": rectcost.BAND_FIELD_BYTES,
                                "sweeps": recs, "median_rel_err": med,
                                "valid": float(ok.mean())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
