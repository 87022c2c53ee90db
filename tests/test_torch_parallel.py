"""The PyTorch port's view-parallel pipeline (``run_pipeline_parallel``) and
``dpe_mvs(parallel=True)`` on the CPU, ranks in gloo groups started by
``tests/torch_dist_driver.py``:

  * partition invariance: at 32x24x3, one round, a 2-rank run writes every
    ``depth.npy``, ``normal.npy`` and state file bit-equal to a 1-rank run
    (padding slots are never swept and the exchange copies, so no rank
    count changes a number);
  * accuracy, at ``tests/test_parallel.py``'s bars: a 2-rank
    ``dpe_mvs(parallel=True)`` at 48x36x4 (valid > 0.4, median < 0.03 per
    view, ``test_parallel_pipeline_e2e``), and the rect engine over 2
    rounds at 32x24x3 (the interior bars of
    ``test_parallel_pipeline_rect_2rounds``);
  * resume: with every round checkpointed, ``resume=True`` runs no sweep
    (counted by a stub) and writes the outputs byte for byte again;
  * keys: each sweep's key follows the JAX parallel runner's schedule call
    for call (pass A ``seed + ref_id * 1000``, pass B ``j`` of round ``r``
    ``fold_in(seed, ref_id * 1000 + 4 * r + j + 1)``), the JAX runner's own
    keys recorded the same way;
  * the round's rect frame equals JAX ``ParallelRunner._attach_rect``'s;
  * the API's three cases, with the process group, ``device_count`` and
    ``spawn`` stubbed.

The runs differ from the sequential pipeline's on purpose (other keys,
Jacobi reads), so they are held to ground truth, not to it.

GPU (marked ``gpu``): the pipeline over a one-rank NCCL group on the card.
"""
import shutil

import numpy as np
import pytest
import torch

import torch_dist_driver as drv
import torch_parity  # noqa: F401  (one torch thread per worker)
from dpe_mvs_tpu_torch import api as tapi
from dpe_mvs_tpu_torch.config import EngineConfig as TEngineConfig
from dpe_mvs_tpu_torch.io import scene as tscene
from dpe_mvs_tpu_torch.parallel import mesh
from dpe_mvs_tpu_torch.pipeline import parallel_schedule as ps
from dpe_mvs_tpu_torch.pipeline import schedule as tschedule
from dpe_mvs_tpu_torch.utils import synthetic as tsynth
from dpe_mvs_tpu_torch.utils.rng import TorchKey

ONE_ROUND = {"min_rounds": 1}
TWO_ROUNDS = {"min_rounds": 2, "coarse_target": 16}


def _scene(path, width, height, views, seed):
    sc = tsynth.make_plane_scene(width=width, height=height,
                                 num_views=views, seed=seed)
    return sc, tsynth.write_scene_folder(sc, path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four groups started together: the 32x24x3 one-round scene on 1 and
    on 2 ranks (state kept), ``dpe_mvs(parallel=True)`` at 48x36x4 on 2
    ranks, and the 2-round rect run at 32x24x3 on 2 ranks."""
    root = tmp_path_factory.mktemp("torch_parallel")
    small, f1 = _scene(root / "w1", 32, 24, 3, 9)
    _, f2 = _scene(root / "w2", 32, 24, 3, 9)
    acc, fa = _scene(root / "acc", 48, 36, 4, 6)
    two, fr = _scene(root / "two", 32, 24, 3, 9)
    groups = [
        drv.start_group(1, root, {"pipeline": dict(
            folder=str(f1), cfg=ONE_ROUND, keep=True)}),
        drv.start_group(2, root, {"pipeline": dict(
            folder=str(f2), cfg=ONE_ROUND, keep=True)}),
        drv.start_group(2, root, {"api": dict(folder=str(fa),
                                              cfg=ONE_ROUND)}),
        drv.start_group(2, root, {"pipeline": dict(
            folder=str(fr), cfg=TWO_ROUNDS, keep=False)}),
    ]
    for procs in groups:
        drv.wait_group(procs, 900)
    return dict(small=small, w1=f1, w2=f2, acc=acc, fa=fa, two=two, fr=fr)


def _depth(folder, v):
    return np.load(folder / "DPE" / f"{v:08d}" / "depth.npy")


def test_two_ranks_write_the_bits_of_one(runs):
    for v in range(3):
        rf1 = runs["w1"] / "DPE" / f"{v:08d}"
        rf2 = runs["w2"] / "DPE" / f"{v:08d}"
        for name in ("depth.npy", "normal.npy", "depths.dmb", "normals.dmb",
                     "weak.bin", "selected_views.bin"):
            assert (rf1 / name).read_bytes() == (rf2 / name).read_bytes(), \
                (v, name)
    assert (_depth(runs["w1"], 0) > 0).any()


def test_two_ranks_meet_the_jax_e2e_bars(runs):
    sc = runs["acc"]
    for v in range(4):
        d = _depth(runs["fa"], v)
        gt = sc.gt_depths[v]
        valid = d > 0
        assert valid.mean() > 0.4, (v, valid.mean())
        err = np.abs(d[valid] - gt[valid]) / gt[valid]
        assert np.median(err) < 0.03, (v, np.median(err))
    # The API's run cleaned up after itself.
    assert not (runs["fa"] / "DPE" / "progress.json").exists()
    assert not (runs["fa"] / "DPE" / "00000001" / "depths.dmb").exists()


def test_rect_engine_two_rounds_meets_the_jax_bars(runs):
    sc = runs["two"]
    for v in range(3):
        d = _depth(runs["fr"], v)
        gt = sc.gt_depths[v]
        # DepthToWeak blanks a 6-px border (DPE.cu:2603-2607).
        interior = np.zeros(d.shape, bool)
        interior[6:-6, 6:-6] = True
        valid = (d > 0) & interior
        assert valid.sum() > 0.5 * interior.sum(), (v, valid.sum())
        err = np.abs(d[valid] - gt[valid]) / gt[valid]
        assert np.median(err) < 0.05, (v, np.median(err))


def test_resume_runs_no_sweep_and_rewrites_the_outputs(runs, tmp_path,
                                                       monkeypatch):
    folder = shutil.copytree(runs["w2"], tmp_path / "s")
    assert (folder / "DPE" / "progress.json").exists()
    for v in range(3):
        for name in ("depth.npy", "normal.npy"):
            (folder / "DPE" / f"{v:08d}" / name).unlink()
    calls = []
    monkeypatch.setattr(mesh, "sharded_sweep",
                        lambda *a, **k: calls.append(a) or a[2])
    assert ps.run_pipeline_parallel(folder, verbose=False, normal=True,
                                    cfg=TEngineConfig(**ONE_ROUND),
                                    resume=True, device="cpu") == 0
    assert calls == []
    for v in range(3):
        for name in ("depth.npy", "normal.npy"):
            assert (folder / "DPE" / f"{v:08d}" / name).read_bytes() == \
                (runs["w2"] / "DPE" / f"{v:08d}" / name).read_bytes()
    assert not (folder / "DPE" / "progress.json").exists()


def _schedule(problems, rounds):
    """(ref_id, round, pass) of every sweep, in the runner's order."""
    return [(p.ref_image_id, r, j) for r in range(rounds)
            for j in (None, 0, 1, 2) for p in problems]


def test_keys_follow_the_jax_parallel_schedule(tmp_path, monkeypatch):
    import jax
    from dpe_mvs_tpu.config import EngineConfig as JEngineConfig
    from dpe_mvs_tpu.parallel import mesh as jmesh
    from dpe_mvs_tpu.pipeline import parallel_schedule as jps
    _, folder = _scene(tmp_path / "s", 32, 24, 3, 2)
    seed = 1234

    # The port: the key of every run_sweep_staged call (sweeps stubbed).
    seen = []

    def stub(data, st, params, *, rstat=None, timer=None):
        seen.append(st.key.seed)
        return st
    monkeypatch.setattr(mesh.stages, "run_sweep_staged", stub)
    assert ps.run_pipeline_parallel(
        folder, verbose=False, device="cpu",
        cfg=TEngineConfig(seed=seed, **TWO_ROUNDS)) == 0
    problems = tscene.generate_sample_list(folder)
    calls = _schedule(problems, 2)
    want = [TorchKey(seed + i * 1000).seed if j is None else
            TorchKey(seed).fold_in(i * 1000 + 4 * r + j + 1).seed
            for i, r, j in calls]
    assert seen == want

    # The JAX parallel runner, recorded the same way (its sweeps stubbed),
    # draws from the same (seed, fold) table.
    jseen = []

    def jstub(mesh_, data, state, params, **kw):
        jseen.extend(np.asarray(jax.random.key_data(state.key)).tolist())
        return state
    monkeypatch.setattr(jmesh, "sharded_sweep_staged", jstub)
    monkeypatch.setattr(jmesh, "sharded_sweep", jstub)
    jfolder = shutil.copytree(folder, tmp_path / "j", ignore=lambda d, n: [
        x for x in n if x == "DPE"])
    assert jps.run_pipeline_parallel(
        jfolder, mesh=jmesh.make_mesh(jax.devices()[:1]), verbose=False,
        cfg=JEngineConfig(seed=seed, use_rect=True, **TWO_ROUNDS)) == 0
    root = jax.random.key(seed)
    jwant = [jax.random.key(seed + i * 1000) if j is None else
             jax.random.fold_in(root, i * 1000 + 4 * r + j + 1)
             for i, r, j in calls]
    assert jseen == [np.asarray(jax.random.key_data(k)).tolist()
                     for k in jwant]


def test_round_frame_equals_jax_attach_rect(tmp_path):
    import jax
    from dpe_mvs_tpu.config import EngineConfig as JEngineConfig
    from dpe_mvs_tpu.engine import state as jst
    from dpe_mvs_tpu.io import scene as jscene
    from dpe_mvs_tpu.parallel import mesh as jmesh
    from dpe_mvs_tpu.pipeline import parallel_schedule as jps
    _, folder = _scene(tmp_path / "s", 48, 36, 4, 6)
    jproblems = jscene.generate_sample_list(folder)
    problems = tscene.generate_sample_list(folder)
    v_pad = 3
    for scale_size in (1, 2):
        inputs = [jscene.load_problem_inputs(
            p, scale_size, need_prior=False, need_weak=False,
            need_src_depths=False) for p in jproblems]
        runner = jps.ParallelRunner(jmesh.make_mesh(jax.devices()[:1]),
                                    jproblems, v_pad,
                                    JEngineConfig(use_rect=True))
        runner._attach_rect([jst.build_sweep_data(i, v_pad) for i in inputs],
                            inputs)
        want = (runner.rstat.wp, runner.rstat.hp)
        assert tschedule.round_rect_frame(problems, scale_size, v_pad) == \
            want, scale_size


class _Called(Exception):
    pass


def _dispatch(monkeypatch, folder, *, group_world=None, cards=0,
              **kw):
    """Which of the API's three cases ``dpe_mvs(parallel=True, **kw)``
    takes: a process group of ``group_world`` ranks (None: no group) and
    ``cards`` visible cards, the runners and ``spawn`` stubbed."""
    import torch.distributed as dist
    got = {}

    def record(case):
        def stub(*a, **k):
            got.update(case=case, args=a, kw=k)
            return 0
        return stub
    monkeypatch.setattr(ps, "run_pipeline_parallel", record("a"))
    monkeypatch.setattr(torch.multiprocessing, "spawn", record("b"))
    monkeypatch.setattr(tschedule, "run_pipeline", record("c"))
    monkeypatch.setattr(mesh, "initialize_distributed",
                        lambda *a, **k: group_world is not None)
    monkeypatch.setattr(dist, "is_initialized",
                        lambda: group_world is not None)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: group_world)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tapi.dpe_mvs(str(folder), 0, False, parallel=True, **kw) == 0
    return got


def test_api_dispatch(tmp_path, monkeypatch):
    folder = tmp_path / "s"
    # (a) a group of several ranks: this process runs its rank.
    got = _dispatch(monkeypatch, folder, group_world=2, device="cpu")
    assert got["case"] == "a"
    g = got["kw"]["group"]
    assert (g.rank, g.world, g.device) == (1, 2, torch.device("cpu"))
    got = _dispatch(monkeypatch, folder, group_world=2, cards=4)
    assert got["kw"]["group"].device == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    got = _dispatch(monkeypatch, folder, group_world=2, cards=4)
    assert got["kw"]["group"].device == torch.device("cuda", 3)
    monkeypatch.delenv("LOCAL_RANK")
    # (b) no group, several cards: one worker per card.
    got = _dispatch(monkeypatch, folder, cards=2)
    assert got["case"] == "b" and got["kw"]["nprocs"] == 2
    assert got["args"][0] is tapi._rank_main
    # (c) otherwise: the sequential pipeline on one device.
    for kw in (dict(cards=2, device="cpu"), dict(cards=1),
               dict(group_world=1, cards=2)):
        got = _dispatch(monkeypatch, folder, **kw)
        assert got["case"] == "c", kw


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_gpu_parallel_pipeline_world1(tmp_path):
    """The view-parallel pipeline over a one-rank NCCL group on the card
    (one card: NCCL refuses two ranks on one device), at 64x48x3 with the
    default two rounds: its collectives are NCCL calls, every kernel entry
    of the rect engine launches, and the scene is recovered to the CPU
    pipeline test's bars."""
    import torch.distributed as dist
    from dpe_mvs_tpu_torch.ops import gather2d as tg2d
    from dpe_mvs_tpu_torch.ops import rowgather as trow
    sc, folder = _scene(tmp_path / "s", 64, 48, 3, 4)
    assert mesh.initialize_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0,
                                       device="cuda:0")
    try:
        group = mesh.make_group("cuda:0")
        assert group.backend == "nccl"
        tg2d.reset_launches()
        trow.reset_launches()
        assert ps.run_pipeline_parallel(folder, group=group, verbose=False,
                                        fusion=True) == 0
    finally:
        dist.destroy_process_group()
    launches = {**trow.LAUNCHES, **tg2d.LAUNCHES}
    assert all(n > 0 for n in launches.values()), launches
    d = _depth(folder, 0)
    gt = sc.gt_depths[0]
    valid = d > 0
    med = np.median(np.abs(d[valid] - gt[valid]) / gt[valid])
    print("world-1 NCCL pipeline on the card: valid", valid.mean(),
          "median", med, "launches", launches)
    assert valid.mean() > 0.4
    assert med < 0.03, med
    assert (folder / "DPE" / "DPE.ply").is_file()
