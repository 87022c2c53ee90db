"""The rect engine's weak path against the exact engine's, on one problem.

    python tools/torch_weak_compare.py --engine rect --out wc_rect.npz
    python tools/torch_weak_compare.py --engine exact --out wc_exact.npz
    python tools/torch_weak_compare.py --compare wc_rect.npz wc_exact.npz
        [--width 400] [--height 304] [--views 4] [--cpu] [--jpeg-quality Q]

The port's counterpart of ``tools/weak_compare.py`` (which imports jax). The
rect engine's weak path approximates the reference (probe lattice, the
initial plane's slope across a window, each anchor window's own centre as
its bilateral colour anchor, no adaptive centre radius:
``dpe_mvs_tpu_torch/engine/weak_rect.py``); the exact engine
(``EngineConfig(use_rect=False)``) keeps the reference's semantics. A run
renders ``utils.synthetic.make_plane_scene(width, height, views, seed=17,
weak_patch=True)`` (the JAX tool's scene), writes it as a dense folder with
the pixels of the JAX tool's JPEG files (quality 98, decoded as libjpeg
does: ``imread.jpeg_roundtrip_gray``; ``--jpeg-quality 0`` writes them
lossless), computes problem 0's dual-level edge and label maps, and runs a
FIRST_INIT sweep (``schedule_params(base, 0, None)``, key seed 42) and
then an APD + edge REFINE_INIT sweep
(``schedule_params(base, 1, None)``, key seed 43) on the chosen engine: the
rect engine through its rect host, the exact engine with ``rstat=None``. It
runs on the card unless given ``--cpu``, and raises without one. ``wall`` is
the seconds of the two sweeps, the card synchronised before and after.

A run saves ``depth``, ``weak``, ``gt``, ``dmin``, ``dmax``, ``wall`` and
``engine`` as the JAX tool does, so either tool's ``--compare`` reads the
other's files, and prints one JSON line: engine, seconds, the launches of
each kernel entry (0 on the CPU, where the plain versions run) and the file.
``--compare`` prints, as the JAX tool does, per engine the median relative
depth error, inliers at 1% and valid share, then the interior weak-label
agreement and each engine's weak fraction.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SCENE_SEED = 17
SCENE_JPEG_QUALITY = 98        # make_plane_scene's JPEG files
SWEEP_SEEDS = (42, 43)         # keys of the FIRST_INIT and REFINE_INIT sweeps
ENGINES = ("rect", "exact")


def make_scene(width: int, height: int, views: int):
    """The JAX tool's scene: a tilted plane with a texture-less patch."""
    from dpe_mvs_tpu_torch.utils.synthetic import make_plane_scene
    return make_plane_scene(width=width, height=height, num_views=views,
                            seed=SCENE_SEED, weak_patch=True)


def run(engine: str, width: int, height: int, views: int,
        device="cuda", jpeg_quality=SCENE_JPEG_QUALITY) -> dict:
    """Problem 0's FIRST_INIT sweep, then its APD + edge REFINE_INIT sweep,
    on ``engine`` ("rect" or "exact"), the scene's images as a JPEG at
    ``jpeg_quality`` decodes them (None: lossless). Returns the ``.npz``
    fields and ``launches`` (per kernel entry, from the rectification to
    the end of the sweeps)."""
    import torch
    from dpe_mvs_tpu_torch.config import PatchMatchParams, schedule_params
    from dpe_mvs_tpu_torch.engine import rectcost
    from dpe_mvs_tpu_torch.engine import state as st_mod
    from dpe_mvs_tpu_torch.engine.stages import run_sweep_staged
    from dpe_mvs_tpu_torch.io import scene as scene_mod
    from dpe_mvs_tpu_torch.ops import gather2d, rowgather
    from dpe_mvs_tpu_torch.pipeline import schedule as sched
    from dpe_mvs_tpu_torch.utils.rng import TorchKey
    from dpe_mvs_tpu_torch.utils.synthetic import write_scene_folder

    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} is not one of {ENGINES}")
    device = sched.resolve_device(device)
    sc = make_scene(width, height, views)
    base = PatchMatchParams()
    v_pad = views - 1
    with tempfile.TemporaryDirectory(prefix="dpe_wc_") as tmp:
        problems = scene_mod.generate_sample_list(
            write_scene_folder(sc, tmp, jpeg_quality))
        sched.get_problem_edges(problems[0], 1, base)
        inputs = scene_mod.load_problem_inputs(
            problems[0], 1, need_prior=False, need_weak=False,
            need_src_depths=False)
        edge, edge_low, label = sched.load_support_maps(
            problems[0], 1, 0, base, inputs.width, inputs.height)
    before = {**rowgather.LAUNCHES, **gather2d.LAUNCHES}
    data = st_mod.build_sweep_data(inputs, v_pad, edge, edge_low, label,
                                   device=device)
    rstat = None
    if engine == "rect":
        rh = rectcost.build_rect_host(inputs.cameras, inputs.width,
                                      inputs.height, v_pad, device=device)
        data = data.replace(rect=rectcost.build_rect_views(
            rh, inputs.images, device))
        rstat = rh.statics

    st = st_mod.init_pm_state(inputs, v_pad, TorchKey(SWEEP_SEEDS[0], device),
                              False, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    st = run_sweep_staged(data, st, schedule_params(base, 0, None),
                          rstat=rstat)
    st = st.replace(key=TorchKey(SWEEP_SEEDS[1], device))
    st = run_sweep_staged(data, st, schedule_params(base, 1, None),
                          rstat=rstat)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    launches = {k: v - before[k] for k, v in
                {**rowgather.LAUNCHES, **gather2d.LAUNCHES}.items()}
    return dict(depth=st.plane[..., 3].cpu().numpy(),
                weak=st.weak.cpu().numpy(), gt=sc.gt_depths[0],
                dmin=float(inputs.depth_min), dmax=float(inputs.depth_max),
                wall=wall, engine=engine, launches=launches)


def save(rec: dict, path) -> None:
    """The run's maps under the JAX tool's keys and dtypes."""
    np.savez(path, depth=rec["depth"], weak=rec["weak"], gt=rec["gt"],
             dmin=rec["dmin"], dmax=rec["dmax"], wall=rec["wall"],
             engine=rec["engine"])


def report(d, gt, dmin, dmax):
    valid = (d >= dmin) & (d <= dmax)
    rel = np.abs(d[valid] - gt[valid]) / gt[valid]
    return dict(valid=round(float(valid.mean()), 4),
                median_rel=round(float(np.median(rel)), 6),
                inlier_1pct=round(float((rel < 0.01).mean()), 4))


def compare(a_path, b_path) -> dict:
    """Print the JAX tool's comparison of two runs' files; return it with
    the weak fractions also unrounded, under ``weak_frac_raw``."""
    a = np.load(a_path, allow_pickle=True)
    b = np.load(b_path, allow_pickle=True)
    out = {
        str(a["engine"]): report(a["depth"], a["gt"], float(a["dmin"]),
                                 float(a["dmax"])),
        str(b["engine"]): report(b["depth"], b["gt"], float(b["dmin"]),
                                 float(b["dmax"])),
    }
    # Weak-map agreement (interior; DepthToWeak blanks a 6 px border).
    wa, wb = a["weak"], b["weak"]
    inner = np.zeros(wa.shape, bool)
    inner[6:-6, 6:-6] = True
    out["weak_label_agreement"] = round(
        float((wa == wb)[inner].mean()), 4)
    raw = {str(a["engine"]): float((wa == 0)[inner].mean()),
           str(b["engine"]): float((wb == 0)[inner].mean())}
    out["weak_frac"] = {e: round(f, 4) for e, f in raw.items()}
    print(json.dumps(out, indent=2))
    return {**out, "weak_frac_raw": raw}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=ENGINES, default="rect")
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=304)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--jpeg-quality", type=int, default=SCENE_JPEG_QUALITY,
                    help="the images as a JPEG at this quality decodes them "
                         "(0: lossless)")
    ap.add_argument("--out", default=str(Path(tempfile.gettempdir())
                                         / "wc.npz"))
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return 0
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    rec = run(args.engine, args.width, args.height, args.views,
              "cpu" if args.cpu else "cuda", args.jpeg_quality or None)
    save(rec, args.out)
    print(json.dumps({"engine": args.engine, "wall_s": round(rec["wall"], 1),
                      "launches": rec["launches"], "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
