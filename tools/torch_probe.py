"""Per-stage probe of the PyTorch port at a given frame size.

    python tools/torch_probe.py WIDTH HEIGHT VIEWS [apd|noapd] [geom]
        [--round R] [--cpu] [--band-full-bytes B] [--band-field-bytes B]
        [--sweep-chunk-bytes B] [--anchor-band-bytes B] [--snapshot]

The port's counterpart of ``tools/tpu_probe.py`` (which imports jax). It
renders ``utils.synthetic.make_plane_scene(width, height, views, seed=3)``,
writes it as a dense folder and runs problem 0 through
``pipeline.schedule.process_problem`` in the rect frame the round loop
sweeps every problem of the scene in (``schedule.round_rect_frame``, the
largest frame any of its pairs needs: 7296x6456 for six views at
6048x4032, where problem 0's own is 6528x6456).
With ``--round 0`` (the default): a FIRST_INIT sweep (round-0 pass A), then
with ``apd`` the modal sweep (``schedule_params(base, 1, 0 if geom else
None)``) from that sweep's writeback, with the stand-in support maps of
``utils.synthetic.support_maps`` and, with ``geom``, every source view's
depth map a constant mid-range depth (as ``tools/tpu_probe.py`` does).
With ``--round R`` (R > 0), round R's sweeps: pass A
(``schedule_params(base, R, None)``, REFINE_INIT with the weak machinery and
edges) whose priors are the ground truth at half the frame
(``utils.synthetic.write_coarse_priors``, read through the round loop's own
``rescale_nearest``), then with ``apd`` the modal sweep
(``schedule_params(base, R, 0 if geom else None)``) from its writeback, with
``geom`` the sources' ground-truth depth maps; both with the stand-in
support maps.

Per sweep it prints the seconds, the stage spans (each span synchronised
with the device), the device memory free before the sweep and its peak
(``max_memory_allocated``, reset before it), the peak of every stage (the
peak counter is reset as each span starts) and the stage that sets the
sweep's peak, the launches of each kernel entry and the full-resolution
branches taken (``utils.profiling.BRANCHES``), then one JSON line of the
same. Each sweep builds its rect host anew, so its spans hold all of its
host work.

``--band-full-bytes`` / ``--band-field-bytes`` set
``engine.rectcost.BAND_FULL_BYTES`` / ``BAND_FIELD_BYTES`` (``inf`` turns
the row banding off); ``--sweep-chunk-bytes`` sets
``engine.patchmatch.SWEEP_CHUNK_BYTES`` (``inf``: the disparity sweeps in
one probe chunk and the classify analysis in one row band) and
``--anchor-band-bytes`` ``ops.anchors.BAND_BYTES`` (``inf``: the anchor
search in one piece). With
``--snapshot`` (the card only) the allocator records its history, at a host
cost: every stage prints the largest blocks live at its peak, found by
replaying the stage's allocations and frees, with the Python frames that
allocated them. On an out-of-memory error the probe prints the failed
allocation and the largest live blocks (their frames with ``--snapshot``),
then exits 2. It runs on the card unless given ``--cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _where(frames):
    """The port's and the probe's frames of an allocation, innermost first."""
    return [f"{Path(f['filename']).name}:{f['line']} {f['name']}"
            for f in frames or [] if "dpe_mvs" in f["filename"]
            or "torch_probe" in f["filename"]][:4]


def _live_blocks(snap) -> dict:
    """{address: (bytes, frames)} of the snapshot's allocated blocks."""
    live = {}
    for seg in snap["segments"]:
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                live[blk.get("address", addr)] = (blk["size"],
                                                  blk.get("frames"))
            addr += blk["size"]
    return live


def _top(live, top: int = 12):
    blocks = sorted(((b, _where(f)) for b, f in live.values()),
                    key=lambda b: -b[0])
    return sum(b for b, _ in blocks), blocks[:top]


def _holders(top: int = 12):
    """The largest live blocks of the device memory snapshot, with the
    frames recorded for them (``--snapshot``)."""
    import torch
    return _top(_live_blocks(torch.cuda.memory._snapshot()), top)


def _peak_blocks(live0: dict, trace) -> tuple:
    """Replay a stage's allocator trace from the blocks live at its start:
    (bytes live at the stage's peak, the blocks live there)."""
    def step(live, ev):
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames"))
            return ev["size"]
        if ev["action"] == "free_requested" and ev["addr"] in live:
            return -live.pop(ev["addr"])[0]
        return 0

    live = dict(live0)
    cur = best = sum(b for b, _ in live.values())
    at = -1
    for i, ev in enumerate(trace):
        cur += step(live, ev)
        if cur > best:
            best, at = cur, i
    live = dict(live0)
    for ev in trace[:at + 1]:
        step(live, ev)
    return best, live


HISTORY_ENTRIES = 2_000_000     # allocator events kept per stage (--snapshot)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("width", type=int)
    ap.add_argument("height", type=int)
    ap.add_argument("views", type=int)
    ap.add_argument("mode", nargs="?", default="noapd",
                    choices=["apd", "noapd"])
    ap.add_argument("geom", nargs="?", default="", choices=["", "geom"])
    ap.add_argument("--round", type=int, default=0, dest="round_idx",
                    help="the round whose sweeps run (0: FIRST_INIT)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--band-full-bytes", type=float, default=None)
    ap.add_argument("--band-field-bytes", type=float, default=None)
    ap.add_argument("--sweep-chunk-bytes", type=float, default=None)
    ap.add_argument("--anchor-band-bytes", type=float, default=None)
    ap.add_argument("--snapshot", action="store_true",
                    help="record allocation history: the blocks live at "
                         "each stage's peak")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from dpe_mvs_tpu_torch.config import EngineConfig, PatchMatchParams, \
        schedule_params
    from dpe_mvs_tpu_torch.engine import patchmatch, rectcost
    from dpe_mvs_tpu_torch.io import scene
    from dpe_mvs_tpu_torch.ops import anchors
    from dpe_mvs_tpu_torch.ops import gather2d as g2d
    from dpe_mvs_tpu_torch.ops import rowgather as rg
    from dpe_mvs_tpu_torch.ops import weakcost as wc
    from dpe_mvs_tpu_torch.pipeline import schedule as sch
    from dpe_mvs_tpu_torch.utils.profiling import BRANCHES, outermost
    from dpe_mvs_tpu_torch.utils.synthetic import make_plane_scene, \
        support_maps, write_coarse_priors, write_scene_folder

    device = torch.device("cpu" if args.cpu else "cuda")
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("no CUDA device (pass --cpu to run on the CPU)", flush=True)
        return 1
    if args.band_full_bytes is not None:
        rectcost.BAND_FULL_BYTES = args.band_full_bytes
    if args.band_field_bytes is not None:
        rectcost.BAND_FIELD_BYTES = args.band_field_bytes
    if args.sweep_chunk_bytes is not None:
        patchmatch.SWEEP_CHUNK_BYTES = args.sweep_chunk_bytes
    if args.anchor_band_bytes is not None:
        anchors.BAND_BYTES = args.anchor_band_bytes
    snapshot = cuda and args.snapshot

    def restart_history():
        """Clear the allocator's event ring (blocks keep their frames)."""
        torch.cuda.memory._record_memory_history(None)
        torch.cuda.memory._record_memory_history(
            stacks="python", max_entries=HISTORY_ENTRIES)

    if snapshot:
        restart_history()
    apd, geom = args.mode == "apd", args.geom == "geom"
    W, H, V, R = args.width, args.height, args.views, args.round_idx
    print(f"device {torch.cuda.get_device_name(device) if cuda else 'cpu'}; "
          f"torch {torch.__version__}; allocator configuration "
          f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '(default)')}; rect "
          f"bands over {rectcost.BAND_FULL_BYTES:g} B, "
          f"{rectcost.BAND_FIELD_BYTES:g} B per band field; disparity-sweep "
          f"chunks of {patchmatch.SWEEP_CHUNK_BYTES:g} B; anchor-search bands "
          f"of {anchors.BAND_BYTES:g} B", flush=True)

    t0 = time.time()
    sc = make_plane_scene(width=W, height=H, num_views=V, seed=3)
    print(f"scene {W}x{H}x{V} rendered in {time.time() - t0:.1f} s",
          flush=True)
    out = write_scene_folder(sc, tempfile.mkdtemp(prefix="dpe_probe_"))
    problems = [scene.Problem(index=i, ref_image_id=i,
                              src_image_ids=sc.src_ids(i), dense_folder=out)
                for i in range(V)]
    p0 = problems[0]
    base = PatchMatchParams()
    cfg = EngineConfig(seed=3)
    v_pad = V - 1
    # The frame the round loop sweeps each problem of the scene in.
    rect_frame = (sch.round_rect_frame(problems, 1, v_pad)
                  if sch.use_rect_engine(cfg) and V > 1 else None)
    print(f"rect frame {rect_frame}", flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def launches():
        return {**rg.LAUNCHES, **g2d.LAUNCHES, **wc.LAUNCHES}

    def sweep(label, params, inputs, maps=None):
        spans, stages = {}, {}
        run_peak = [0]

        @contextlib.contextmanager
        def timer(name):
            sync()
            if cuda:
                run_peak[0] = max(run_peak[0],
                                  torch.cuda.max_memory_allocated(device))
                torch.cuda.reset_peak_memory_stats(device)
            if snapshot:
                restart_history()
                snap = torch.cuda.memory._snapshot()
                live0, n0 = _live_blocks(snap), len(
                    snap["device_traces"][device.index or 0])
                del snap
            ts = time.time()
            yield
            sync()
            spans[name] = spans.get(name, 0.0) + time.time() - ts
            if not cuda:
                return
            peak = torch.cuda.max_memory_allocated(device)
            run_peak[0] = max(run_peak[0], peak)
            st = stages.setdefault(name, {"peak_mib": 0.0})
            if peak / 2**20 <= st["peak_mib"]:
                return
            st["peak_mib"] = peak / 2**20
            if not snapshot:
                return
            trace = torch.cuda.memory._snapshot()["device_traces"][
                device.index or 0]
            if len(trace) >= HISTORY_ENTRIES:
                st["holders"] = "not read: the allocator's event ring wrapped"
                return
            _best, live = _peak_blocks(live0, trace[n0:])
            total, top = _top(live)
            st["live_at_peak_mib"] = total / 2**20
            st["holders"] = [{"mib": b / 2**20, "at": w} for b, w in top]

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
                                inputs=inputs, support_maps=maps,
                                timer=outermost(timer),
                                rect_frame=rect_frame)
        except torch.OutOfMemoryError as e:
            print(f"{label}: out of memory: {e}".splitlines()[0], flush=True)
            rec = {"sweep": label, "oom": str(e).splitlines()[0],
                   "spans": spans, "stages": stages,
                   "free_before_mib": free / 2**20,
                   "peak_mib": max(run_peak[0], torch.cuda.
                                   max_memory_allocated(device)) / 2**20}
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
            rec["peak_mib"] = max(
                run_peak[0], torch.cuda.max_memory_allocated(device)) / 2**20
            rec["stages"] = stages
            rec["peak_stage"] = max(stages, key=lambda k:
                                    stages[k]["peak_mib"])
        print(f"{label}: {rec['seconds']:.2f} s, peak "
              f"{rec.get('peak_mib', float('nan')):.1f} MiB in "
              f"{rec.get('peak_stage')} (before it "
              f"{(held or 0) / 2**20:.1f} MiB allocated, "
              f"{(free or 0) / 2**20:.1f} MiB free)\n  spans " + ", ".join(
                  f"{k} {v:.3f}" for k, v in spans.items()) +
              ("\n  stage peaks (MiB) " + ", ".join(
                  f"{k} {v['peak_mib']:.1f}" for k, v in stages.items())
               if stages else "") +
              f"\n  launches {rec['launches']}\n  branches {rec['branches']}",
              flush=True)
        for name, st in stages.items():
            if isinstance(st.get("holders"), list):
                print(f"  {name}: {st['live_at_peak_mib']:.1f} MiB live at "
                      f"its peak; largest blocks:")
                for h in st["holders"]:
                    print(f"    {h['mib']:9.1f} MiB  {' <- '.join(h['at'])}")
            elif "holders" in st:
                print(f"  {name}: {st['holders']}")
        return rec

    recs = []
    try:
        if R == 0:
            recs.append(sweep("FIRST_INIT", schedule_params(base, 0, None),
                              sc.problem_inputs(0)))
        else:
            params = schedule_params(base, R, None)
            write_coarse_priors(sc, 0, p0.result_folder)
            inputs = scene.add_pass_inputs(
                sc.problem_inputs(0), p0.result_folder, [],
                **{**sch.pass_needs(params), "need_src_depths": False})
            recs.append(sweep(f"round {R} REFINE_INIT", params, inputs,
                              support_maps(inputs.images[0])))
        if apd:
            params = schedule_params(base, max(R, 1), 0 if geom else None)
            inputs = scene.add_pass_inputs(
                sc.problem_inputs(0), p0.result_folder, [],
                **{**sch.pass_needs(params), "need_src_depths": False})
            if geom and R == 0:
                mid = 0.5 * (inputs.depth_min + inputs.depth_max)
                inputs.src_depths = np.full((V, H, W), mid, np.float32)
            elif geom:
                inputs.src_depths = np.stack(
                    [sc.gt_depths[i] for i in [0] + sc.src_ids(0)])
            p0.iteration = 1
            recs.append(sweep("modal REFINE_ITER" if R == 0 else
                              f"round {R} modal REFINE_ITER", params, inputs,
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
                                "round": R, "apd": apd, "geom": geom,
                                "rect_frame": rect_frame,
                                "alloc_conf": os.environ.get(
                                    "PYTORCH_CUDA_ALLOC_CONF"),
                                "sweep_chunk_bytes":
                                    patchmatch.SWEEP_CHUNK_BYTES,
                                "anchor_band_bytes": anchors.BAND_BYTES,
                                "band_full_bytes": rectcost.BAND_FULL_BYTES,
                                "band_field_bytes": rectcost.BAND_FIELD_BYTES,
                                "sweeps": recs, "median_rel_err": med,
                                "valid": float(ok.mean())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
