"""One rank of the PyTorch port's multi-process tests: a
``torch.distributed`` group over gloo on the CPU.

    python tests/torch_dist_driver.py <out_dir> <case>=<json> [...]

with ``DPE_MVS_COORDINATOR`` (host:port), ``DPE_MVS_NUM_PROCS`` and
``DPE_MVS_PROC_ID`` set: the rank joins the group through
``parallel.mesh.initialize_distributed`` (the port's counterpart of
``tests/multihost_driver.py``), runs the cases in order, writes its results
under ``out_dir`` and prints ``MULTIHOST OK p<rank>``. The tests start the
ranks with :func:`start_group` and wait with :func:`wait_group`; they also
import the case inputs from here. Nothing here imports jax.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from dpe_mvs_tpu_torch.parallel import mesh  # noqa: E402

# Pair graphs of the exchange cases: problem b's sources among n problems.
GRAPHS = {
    "next": lambda b, n: [(b + 1) % n],
    "ring": lambda b, n: [(b + 1) % n, (b + 2) % n, (b - 1) % n],
    "far": lambda b, n: [(b + 2) % n, (b + 4) % n, (b + 6) % n],
}
# (graph, problems) of the exchange cases, each run in every group.
EXCHANGES = (("next", 4), ("next", 7), ("ring", 8), ("far", 8))


def exchange_inputs(graph: str, n: int, world: int, V: int = 3, H: int = 6,
                    W: int = 5):
    """The depth maps (n_pad, H, W) and pair graph (n_pad, V) of an
    exchange case: n problems padded to a multiple of ``world`` (padding
    rows zeros, padding slots -1)."""
    n_pad = mesh.pad_problem_count(n, world)
    depth = np.zeros((n_pad, H, W), np.float32)
    depth[:n] = 1.0 + np.arange(n * H * W, dtype=np.float32).reshape(n, H,
                                                                      W)
    idx = np.full((n_pad, V), -1, np.int32)
    idx[:n] = mesh.build_src_index(
        list(range(n)), [GRAPHS[graph](b, n) for b in range(n)], V)
    return depth, idx


HALO = dict(hb=5, halo=3, W=4, V=2)


def halo_inputs(n_tiles: int, hb: int, halo: int, W: int, V: int):
    """Random per-tile state fields (n_tiles, hb + 2 * halo, W, ...), NaNs
    and signed zeros among the planes."""
    rng = np.random.default_rng(n_tiles)
    rows = hb + 2 * halo
    plane = rng.standard_normal((n_tiles, rows, W, 4)).astype(np.float32)
    plane[rng.random(plane.shape) < 0.05] = np.nan
    plane[rng.random(plane.shape) < 0.05] = -0.0
    return dict(
        plane=plane,
        cost=rng.random((n_tiles, rows, W)).astype(np.float32),
        selected=rng.integers(0, 2**32, (n_tiles, rows, W), np.uint64)
        .astype(np.uint32),
        view_weight=rng.integers(-5, 5, (n_tiles, rows, W, V), np.int32),
        weak=rng.integers(0, 3, (n_tiles, rows, W), np.uint8))


def _exchange(group, out: Path, _):
    res = {}
    for graph, n in EXCHANGES:
        depth, idx = exchange_inputs(graph, n, group.world)
        b = depth.shape[0] // group.world
        local = torch.from_numpy(depth[group.rank * b:(group.rank + 1) * b])
        res[f"{graph}_{n}"] = mesh.exchange_depths(group, local, idx).numpy()
    np.savez(out, **res)


def _halo(group, out: Path, _):
    from dpe_mvs_tpu_torch.engine.state import PMState
    from dpe_mvs_tpu_torch.parallel import tiles
    f = {k: v[group.rank] for k, v in halo_inputs(group.world,
                                                  **HALO).items()}
    f["selected"] = f["selected"].view(np.int32)
    st = PMState(key=None, **{k: torch.from_numpy(v) for k, v in f.items()})
    st = tiles._halo_refresh(group, st, HALO["halo"], HALO["hb"])
    np.savez(out, **{k: getattr(st, k).numpy() for k in f})


def _tiles(group, out: Path, arg):
    """The tile-sharded FIRST_INIT sweep of ``tests/test_tiles.py``: one
    band per rank, stitched."""
    from dpe_mvs_tpu_torch.config import PatchMatchParams, schedule_params
    from dpe_mvs_tpu_torch.engine import state as st_mod
    from dpe_mvs_tpu_torch.parallel import tiles
    from dpe_mvs_tpu_torch.utils.rng import TorchKey
    from dpe_mvs_tpu_torch.utils.synthetic import make_plane_scene
    sc = make_plane_scene(width=arg["w"], height=arg["h"],
                          num_views=arg["views"], seed=arg["seed"])
    inputs = sc.problem_inputs(0)
    v_pad, halo, t = arg["views"] - 1, arg["halo"], group.rank
    params = schedule_params(PatchMatchParams(), 0, None).replace(
        max_iterations=arg["iters"], use_APD=False)
    data, rstat, hb = tiles.build_tile_data(inputs, group.world, t, v_pad,
                                            halo=halo, device="cpu")
    tile = tiles.build_tile_inputs(inputs, group.world, halo)[0][t]
    st = st_mod.init_pm_state(tile, v_pad, TorchKey(10 + t), False, "cpu")
    st = tiles.tile_sharded_sweep(group, data, st, params, rstat, hb,
                                  halo=halo)
    st = tiles.stitch_tiles(group, st, arg["h"])
    np.savez(out, depth=st.plane[..., 3].numpy(), hb=hb)


def _fusion(group, out: Path, arg):
    """``run_fusion_mesh`` on each [folder, max_passes] of ``arg``."""
    from dpe_mvs_tpu_torch.io import scene
    from dpe_mvs_tpu_torch.pipeline import fusion
    for folder, max_passes in arg:
        fusion.run_fusion_mesh(folder, scene.generate_sample_list(folder),
                               group, max_passes=max_passes)


def _pipeline(group, out: Path, arg):
    from dpe_mvs_tpu_torch.config import EngineConfig
    from dpe_mvs_tpu_torch.pipeline.parallel_schedule import \
        run_pipeline_parallel
    ret = run_pipeline_parallel(
        arg["folder"], group=group, verbose=False, normal=True,
        cfg=EngineConfig(**arg["cfg"]), keep_intermediates=arg["keep"],
        device="cpu")
    assert ret == 0, ret


def _api(group, out: Path, arg):
    """``dpe_mvs(parallel=True)`` in a group of more than one rank (the
    API's case (a))."""
    from dpe_mvs_tpu_torch import api
    from dpe_mvs_tpu_torch.config import EngineConfig
    assert api.dpe_mvs(arg["folder"], 0, False, cfg=EngineConfig(
        **arg["cfg"]), parallel=True, device="cpu") == 0


CASES = {"exchange": _exchange, "halo": _halo, "tiles": _tiles,
         "fusion": _fusion, "pipeline": _pipeline, "api": _api}


def start_group(world: int, out_dir, cases: dict) -> list:
    """Start ``world`` driver ranks over a fresh local rendezvous, running
    ``cases`` ({name: json-able argument}) in order."""
    port = mesh.free_port()
    args = [f"{k}={json.dumps(v)}" for k, v in cases.items()]
    procs = []
    for rank in range(world):
        env = dict(os.environ, DPE_MVS_COORDINATOR=f"127.0.0.1:{port}",
                   DPE_MVS_NUM_PROCS=str(world), DPE_MVS_PROC_ID=str(rank),
                   PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(out_dir), *args], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def wait_group(procs, timeout: float) -> list:
    """Every rank's output; kills every rank if one fails or the group
    outlives ``timeout`` seconds, then fails with every rank's output."""
    outs = [None] * len(procs)
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(timeout=timeout)[0]
            if p.returncode != 0:
                break
    finally:
        for r, p in enumerate(procs):
            if outs[r] is None:
                if p.poll() is None:
                    p.kill()
                outs[r] = p.communicate()[0]
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"--- rank {r} ({procs[r].returncode}):\n"
                               f"{outs[r]}" for r in range(len(outs)))
    for rank, out in enumerate(outs):
        assert f"MULTIHOST OK p{rank}" in out, out
    return outs


def main() -> int:
    torch.set_num_threads(1)
    out_dir = Path(sys.argv[1])
    assert mesh.initialize_distributed(device="cpu"), "no bootstrap"
    assert mesh.initialize_distributed(device="cpu")     # a no-op now
    group = mesh.make_group("cpu")
    assert group.world == int(os.environ["DPE_MVS_NUM_PROCS"])
    assert group.rank == int(os.environ["DPE_MVS_PROC_ID"])
    assert group.backend == "gloo", group.backend
    for spec in sys.argv[2:]:
        name, arg = spec.split("=", 1)
        CASES[name](group, out_dir / f"{name}_w{group.world}_r{group.rank}"
                    ".npz", json.loads(arg))
    mesh.barrier(group)
    torch.distributed.destroy_process_group()
    print(f"MULTIHOST OK p{group.rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
