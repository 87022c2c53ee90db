"""Accuracy harness of the PyTorch port: depth-map statistics and the fused
cloud's F-score against analytic ground truth.

The port's counterpart of ``tools/eval.py`` (which reads through the JAX
package): it imports nothing of ``dpe_mvs_tpu`` and reads the port's
``utils.synthetic.PlaneScene``. The metric family is the one the method is
scored on (ETH3D / Tanks-and-Temples):

  - per-view depth report: completeness (valid fraction), median / mean
    absolute relative error, inlier rates at 0.5% / 1% / 2%;
  - fused-cloud precision (cloud -> ground-truth surface distance <= tau),
    recall (ground-truth sample -> cloud distance <= tau) and
    F = 2PR / (P + R), tau by default 0.005 x the median ground-truth depth.

``chip_smoke.py`` and ``tests/test_torch_pipeline.py`` score the pipeline's
cloud with it. As a script it renders a scene
(``utils.synthetic.make_rich_scene``, or the plane scene, with a depth step
and a blank patch for ``step``), writes it as a dense folder, runs
``dpe_mvs`` with fusion on it and prints the report (``--json``: one line):

    python tools/torch_eval.py [--scene rich|plane|step] [--width 640]
        [--height 480] [--views 10] [--seed 11] [--tau T] [--parallel]
        [--engine rect|exact] [--folder DIR] [--cpu] [--json]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def depth_report(d: np.ndarray, gt: np.ndarray) -> dict:
    valid = d > 0
    rel = np.abs(d[valid] - gt[valid]) / np.maximum(gt[valid], 1e-9)
    return {
        "completeness": round(float(valid.mean()), 4),
        "median_rel_err": round(float(np.median(rel)) if rel.size else 1.0, 6),
        "mean_rel_err": round(float(rel.mean()) if rel.size else 1.0, 6),
        "inlier_0.5pct": round(float((rel < 0.005).mean()) if rel.size else 0.0, 4),
        "inlier_1pct": round(float((rel < 0.01).mean()) if rel.size else 0.0, 4),
        "inlier_2pct": round(float((rel < 0.02).mean()) if rel.size else 0.0, 4),
    }


def backproject_gt(sc, stride: int = 2) -> np.ndarray:
    """Ground-truth surface samples: every view's analytic depth map
    (strided) back-projected to world points through ``sc.cameras``."""
    pts = []
    for cam, d in zip(sc.cameras, sc.gt_depths):
        K, R, t = cam.K, cam.R, cam.t
        H, W = d.shape
        ys, xs = np.mgrid[0:H:stride, 0:W:stride].astype(np.float32)
        dd = d[::stride, ::stride]
        pc = np.stack([(xs - K[0, 2]) / K[0, 0] * dd,
                       (ys - K[1, 2]) / K[1, 1] * dd, dd], axis=-1)
        pts.append(((pc - t) @ R).reshape(-1, 3))
    return np.concatenate(pts)


def fscore(cloud: np.ndarray, gt_pts: np.ndarray, tau: float) -> dict:
    """Distance-threshold precision / recall / F-score (the ETH3D metric
    family) via KD-trees."""
    from scipy.spatial import cKDTree

    if cloud.shape[0] == 0:
        return {"precision": 0.0, "recall": 0.0, "fscore": 0.0,
                "tau": tau, "cloud_points": 0}
    gt_tree = cKDTree(gt_pts)
    d_prec, _ = gt_tree.query(cloud, k=1, distance_upper_bound=tau * 8,
                              workers=-1)
    precision = float((d_prec <= tau).mean())
    cl_tree = cKDTree(cloud)
    d_rec, _ = cl_tree.query(gt_pts, k=1, distance_upper_bound=tau * 8,
                             workers=-1)
    recall = float((d_rec <= tau).mean())
    f = 2 * precision * recall / max(precision + recall, 1e-9)
    return {"precision": round(precision, 4), "recall": round(recall, 4),
            "fscore": round(f, 4), "tau": tau,
            "cloud_points": int(cloud.shape[0])}


def depth_scale(sc) -> float:
    """The median over views of the mean ground-truth depth."""
    return float(np.median([d[d > 0].mean() for d in sc.gt_depths]))


def evaluate_scene(sc, folder, *, tau: float | None = None,
                   gt_stride: int = 2) -> dict:
    """Depth and cloud metrics of a pipeline's output tree in the dense
    folder ``folder`` written from the scene ``sc``."""
    from dpe_mvs_tpu_torch.io import formats

    folder = Path(folder)
    report: dict = {"views": {}}
    for v, gt in enumerate(sc.gt_depths):
        p = folder / "DPE" / f"{v:08d}" / "depth.npy"
        if p.exists():
            report["views"][v] = depth_report(np.load(p), gt)
    meds = [r["median_rel_err"] for r in report["views"].values()]
    comps = [r["completeness"] for r in report["views"].values()]
    report["depth_median_rel_err"] = round(float(np.median(meds)), 6) if meds else None
    report["depth_completeness"] = round(float(np.mean(comps)), 4) if comps else None

    ply = folder / "DPE" / "DPE.ply"
    if ply.exists():
        cloud, _ = formats.read_ply(ply)
        tau = tau if tau is not None else 0.005 * depth_scale(sc)
        report["cloud"] = fscore(cloud, backproject_gt(sc, gt_stride), tau)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="rich",
                    choices=["rich", "plane", "step"])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--tau", type=float, default=None)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--parallel", action="store_true")
    ap.add_argument("--engine", default="rect", choices=["rect", "exact"])
    ap.add_argument("--json", action="store_true",
                    help="print the report as one JSON line")
    ap.add_argument("--folder", default=None,
                    help="write (and keep) the dense folder here")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from dpe_mvs_tpu_torch.api import dpe_mvs
    from dpe_mvs_tpu_torch.config import EngineConfig
    from dpe_mvs_tpu_torch.utils import synthetic

    if args.scene == "rich":
        sc = synthetic.make_rich_scene(width=args.width, height=args.height,
                                       num_views=args.views, seed=args.seed)
    else:
        step = args.scene == "step"
        sc = synthetic.make_plane_scene(
            width=args.width, height=args.height, num_views=args.views,
            step=step, weak_patch=step, seed=args.seed)
    folder = synthetic.write_scene_folder(
        sc, args.folder or tempfile.mkdtemp(prefix="dpe_eval_"))
    cfg = EngineConfig(use_rect=args.engine == "rect")
    t0 = time.time()
    dpe_mvs(str(folder), verbose=not args.json, fusion=True, depth=True,
            normal=True, weak=True, cfg=cfg, parallel=args.parallel,
            device="cpu" if args.cpu else None)
    report = evaluate_scene(sc, folder, tau=args.tau)
    report["pipeline_seconds"] = round(time.time() - t0, 2)
    report["scene"] = {"kind": args.scene, "width": args.width,
                       "height": args.height, "views": args.views,
                       "engine": args.engine}
    print(json.dumps(report) if args.json else json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
