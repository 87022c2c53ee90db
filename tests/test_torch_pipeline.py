"""The PyTorch port's pipeline (round loop, API, CLI) against the JAX
package's.

  * The port's ``dpe_mvs`` with every output on (fusion, viz, the four
    exports) on a 64x48x3 ``write_scene_folder`` scene, 2 rounds (8
    iterations, 24 sweeps) on the CPU: ``depth.npy`` meets the rect-engine
    bar of ``tests/test_pipeline.py`` (median relative error < 0.03, valid >
    0.4); ``DPE/DPE.ply`` meets its F-score floor (> 150 points, P > 0.8,
    F > 0.4 at tau = 0.05 x depth, through ``tools/torch_eval``); the debug
    images of every sweep and scale exist; the edge and label maps it left
    equal JAX ``get_problem_edges`` on the same folder (labels as a
    partition); JAX ``export_npy`` on its state gives its ``.npy`` files
    byte for byte; its cleanup leaves the files the JAX rule leaves. (The
    state is copied just before the cleanup.)
  * Round-loop parity without sweeps: both packages' ``run_pipeline`` on
    the same folder, each with ``process_problem`` stubbed (the stub writes
    a constant plane's state files so later passes load), make the same
    ordered calls: view, iteration, scale, max scale, view padding, rect
    frame, every parameter field and which stored inputs were loaded.
  * Resume after a ``progress.json`` written by the JAX helper sweeps only
    the iterations after it.
  * A geometric pass reads, for every source swept before it, the depth map
    of the same iteration, as the sequential reference does, although the
    next problem's inputs load while the current one sweeps.
  * ``StageTimer`` sums host spans per stage (and, on a card, event spans
    without blocking the host).
  * ``dpe_mvs`` and the CLI: the JAX positional signature and defaults,
    usage error, RuntimeError for a missing folder, a corrupt camera file
    and a missing image; the CLI's viz and fusion flags reach
    ``run_pipeline``; parallel raises NotImplementedError, and without a
    card the default device raises.
"""
import dataclasses
import inspect
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from dpe_mvs_tpu_torch import api as tapi
from dpe_mvs_tpu_torch import cli as tcli
from dpe_mvs_tpu_torch.config import EngineConfig as TEngineConfig
from dpe_mvs_tpu_torch.io import formats as tformats
from dpe_mvs_tpu_torch.io import imread
from dpe_mvs_tpu_torch.io import scene as tscene
from dpe_mvs_tpu_torch.pipeline import schedule as tschedule
from dpe_mvs_tpu_torch.utils import synthetic as tsynth
from dpe_mvs_tpu_torch.utils.profiling import StageTimer

W, H, VIEWS, SEED = 64, 48, 3, 4


def _folder(path, width=W, height=H, views=VIEWS, seed=SEED):
    sc = tsynth.make_plane_scene(width=width, height=height,
                                 num_views=views, seed=seed)
    return sc, tsynth.write_scene_folder(sc, path)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """``dpe_mvs`` with fusion, viz and every export, on the CPU. Returns
    the scene, a copy of the folder made just before the cleanup (the state
    files), the return code and the folder as the run left it."""
    root = tmp_path_factory.mktemp("torch_pipeline")
    sc, folder = _folder(root / "s")
    kept = root / "kept"
    cleanup = tschedule.cleanup_intermediates

    def copy_then_cleanup(problems, round_num):
        shutil.copytree(folder, kept)
        cleanup(problems, round_num)
    mp = pytest.MonkeyPatch()
    mp.setattr(tschedule, "cleanup_intermediates", copy_then_cleanup)
    try:
        ret = tapi.dpe_mvs(str(folder), 0, False, True, True, True, True,
                           True, True, device="cpu")
    finally:
        mp.undo()
    return sc, kept, ret, folder


def test_pipeline_depth_meets_bar(port_run):
    sc, folder, ret, _ = port_run
    assert ret == 0
    for v in range(VIEWS):
        rf = folder / "DPE" / f"{v:08d}"
        d = np.load(rf / "depth.npy")
        assert d.dtype == np.float32 and d.shape == (H, W)
        n = np.load(rf / "normal.npy")
        assert n.dtype == np.float32 and n.shape == (H, W, 3)
        for name in ("weak.npy", "edge.npy"):
            a = np.load(rf / name)
            assert a.dtype == np.int8 and a.shape == (H, W)
    d = np.load(folder / "DPE" / "00000000" / "depth.npy")
    gt = sc.gt_depths[0]
    valid = d > 0
    assert valid.mean() > 0.4
    err = np.median(np.abs(d[valid] - gt[valid]) / gt[valid])
    assert err < 0.03, err
    assert set(np.unique(np.load(folder / "DPE" / "00000000" /
                                 "weak.npy"))) <= {0, 1, 2}


def test_fscore_floor(port_run):
    """The fused cloud against the scene's analytic surface (the floor of
    ``tests/test_pipeline.py::test_fscore_floor``; tau scaled to the
    64-px-wide scene)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from tools.torch_eval import depth_scale, evaluate_scene
    sc, _, _, folder = port_run
    rep = evaluate_scene(sc, folder, tau=0.05 * depth_scale(sc))
    assert rep["cloud"]["cloud_points"] > 150, rep["cloud"]
    assert rep["cloud"]["precision"] > 0.8, rep["cloud"]
    assert rep["cloud"]["fscore"] > 0.4, rep["cloud"]
    assert rep["depth_median_rel_err"] < 0.03, rep


def test_viz_files_written(port_run):
    """The debug images of every sweep (maps at the round's size) and of
    every scale's edge and label maps, readable as images."""
    _, _, _, folder = port_run
    for v in range(VIEWS):
        rf = folder / "DPE" / f"{v:08d}"
        for it in range(8):
            size = (H // 2, W // 2) if it < 4 else (H, W)
            for name in ("depth", "normal", "weak"):
                img = imread.read_color_u8(rf / f"{name}_{it}.jpg")
                assert img.shape == size + (3,), (v, it, name)
        for s, size in ((1, (H // 2, W // 2)), (0, (H, W))):
            assert imread.read_gray_u8(rf / f"rawedge_{s}.jpg").shape == \
                size
            assert imread.read_color_u8(rf / f"connect_{s}.jpg").shape == \
                size + (3,)


def test_edge_and_label_maps_equal_jax(port_run, tmp_path):
    from dpe_mvs_tpu.config import PatchMatchParams
    from dpe_mvs_tpu.io import formats as jformats
    from dpe_mvs_tpu.io import scene as jscene
    from dpe_mvs_tpu.pipeline import schedule as jschedule
    _, folder, _, _ = port_run
    copy = tmp_path / "jax"
    shutil.copytree(folder, copy, ignore=shutil.ignore_patterns("DPE"))
    for p in jscene.generate_sample_list(copy):
        for scale_size, s in ((2, 1), (1, 0)):
            jschedule.get_problem_edges(p, scale_size, PatchMatchParams())
            ours = folder / "DPE" / f"{p.ref_image_id:08d}"
            np.testing.assert_array_equal(
                tformats.read_dmb(ours / f"edges_{s}.dmb"),
                jformats.read_dmb(p.result_folder / f"edges_{s}.dmb"))
            a = tformats.read_dmb(ours / f"labels_{s}.dmb")
            b = jformats.read_dmb(p.result_folder / f"labels_{s}.dmb")
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a == 0, b == 0)
            np.testing.assert_array_equal(a == -1, b == -1)
            pairs = np.unique(np.stack([a[a > 0], b[a > 0]]), axis=1)
            assert len(np.unique(pairs[0])) == pairs.shape[1] == \
                len(np.unique(pairs[1]))


def test_jax_export_reads_port_state(port_run):
    from dpe_mvs_tpu.io import scene as jscene
    from dpe_mvs_tpu.pipeline import schedule as jschedule
    _, folder, _, _ = port_run
    names = ("depth.npy", "normal.npy", "weak.npy", "edge.npy")
    for p in jscene.generate_sample_list(folder):
        ours = {n: (p.result_folder / n).read_bytes() for n in names}
        jschedule.export_npy(p, depth=True, normal=True, weak=True,
                             edge=True)
        for n in names:
            assert (p.result_folder / n).read_bytes() == ours[n], n


def test_cleanup_leaves_what_jax_leaves(port_run, tmp_path):
    from dpe_mvs_tpu.io import scene as jscene
    from dpe_mvs_tpu.pipeline import schedule as jschedule
    _, folder, _, run_folder = port_run
    assert (folder / "DPE" / "progress.json").exists()
    a, b = tmp_path / "a", tmp_path / "b"
    shutil.copytree(folder, a)
    shutil.copytree(folder, b)
    tschedule.cleanup_intermediates(tscene.generate_sample_list(a), 2)
    jschedule.cleanup_intermediates(jscene.generate_sample_list(b), 2)

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file())
    assert files(a) == files(b) == files(run_folder)
    left = [f for f in files(a) if f.startswith("DPE")]
    debug = [f"{n}_{it}.jpg" for n in ("depth", "normal", "weak")
             for it in range(8)] + [f"{n}_{s}.jpg" for n in
                                    ("rawedge", "connect") for s in (0, 1)]
    assert sorted(left) == sorted(
        ["DPE/DPE.ply"] + [f"DPE/{v:08d}/{n}" for v in range(VIEWS)
                           for n in ["depth.npy", "normal.npy", "weak.npy",
                                     "edge.npy"] + debug])


def _plane_stub(calls):
    """A process_problem of either package that records its call and writes
    a constant plane's state at the inputs' size."""
    def stub(problem, params, scale_size, max_scale, v_pad, cfg, *args,
             inputs=None, rect_frame=None, **kw):
        p = {k: (int(v) if k == "state" else v)
             for k, v in dataclasses.asdict(params).items()}
        calls.append((problem.ref_image_id, problem.iteration, scale_size,
                      max_scale, v_pad,
                      None if rect_frame is None else tuple(rect_frame),
                      tuple(sorted(p.items())),
                      inputs.prior_depth is not None,
                      inputs.weak_info is not None,
                      inputs.src_depths is not None,
                      inputs.width, inputs.height))
        rf = problem.result_folder
        hw = (inputs.height, inputs.width)
        tformats.write_dmb(rf / "depths.dmb", np.full(
            hw, 0.5 * (inputs.depth_min + inputs.depth_max), np.float32))
        normal = np.zeros(hw + (3,), np.float32)
        normal[..., 2] = -1.0
        tformats.write_dmb(rf / "normals.dmb", normal)
        tformats.write_dmb(rf / "weak.bin", np.ones(hw, np.uint8))
        tformats.write_dmb(rf / "selected_views.bin", np.ones(hw, np.int32))
    return stub


def test_round_loop_parity_without_sweeps(tmp_path, monkeypatch):
    from dpe_mvs_tpu.config import EngineConfig
    from dpe_mvs_tpu.pipeline import schedule as jschedule
    _, folder = _folder(tmp_path / "port", views=4)
    pairs = tformats.read_pair_txt(folder / "pair.txt")
    pairs[2] = (2, [(0, 100.0), (1, 0.0), (3, 50.0)])   # a dropped source
    tformats.write_pair_txt(folder / "pair.txt", pairs)
    jfolder = tmp_path / "jax"
    shutil.copytree(folder, jfolder)
    ours, ref = [], []
    monkeypatch.setattr(tschedule, "process_problem", _plane_stub(ours))
    monkeypatch.setattr(jschedule, "process_problem", _plane_stub(ref))
    # coarse_target 16: three rounds (scales 4, 2, 1), 12 iterations.
    assert tschedule.run_pipeline(folder, verbose=False,
                                  cfg=TEngineConfig(coarse_target=16),
                                  device="cpu") == 0
    assert jschedule.run_pipeline(
        jfolder, verbose=False,
        cfg=EngineConfig(coarse_target=16, use_rect=True)) == 0
    assert len(ours) == 12 * 4
    assert [c[1] for c in ours[::4]] == list(range(12))
    assert {c[2] for c in ours} == {4, 2, 1}
    assert all(c[5] is not None for c in ours)
    assert ours == ref
    for name in ("depth.npy",):
        for v in range(4):
            assert (folder / "DPE" / f"{v:08d}" / name).read_bytes() == \
                (jfolder / "DPE" / f"{v:08d}" / name).read_bytes()


def test_resume_skips_done_iterations(tmp_path, monkeypatch):
    from dpe_mvs_tpu.pipeline import schedule as jschedule
    _, folder = _folder(tmp_path / "s")
    calls = []
    monkeypatch.setattr(tschedule, "process_problem", _plane_stub(calls))
    tschedule.run_pipeline(folder, verbose=False, keep_intermediates=True,
                           device="cpu")
    assert [c[1] for c in calls] == [i for i in range(8)
                                     for _ in range(VIEWS)]
    assert jschedule._load_progress(folder) == 7
    jschedule._save_progress(folder, 4)
    calls.clear()
    assert tschedule.run_pipeline(folder, verbose=False, resume=True,
                                  device="cpu") == 0
    assert [c[1] for c in calls] == [i for i in (5, 6, 7)
                                     for _ in range(VIEWS)]
    assert not (folder / "DPE" / "progress.json").exists()


def test_geometric_pass_reads_this_iterations_source_depths(tmp_path,
                                                             monkeypatch):
    _, folder = _folder(tmp_path / "s")
    seen = []
    plane = _plane_stub([])

    def stub(problem, params, *args, inputs=None, **kw):
        if inputs.src_depths is not None:
            ids = [problem.ref_image_id] + list(problem.src_image_ids)
            seen.append((problem.iteration, problem.ref_image_id,
                         {i: float(d[0, 0])
                          for i, d in zip(ids, inputs.src_depths)}))
        time.sleep(0.2)            # the next problem's inputs load meanwhile
        plane(problem, params, *args, inputs=inputs, **kw)
        tformats.write_dmb(problem.result_folder / "depths.dmb", np.full(
            (inputs.height, inputs.width),
            1000.0 * problem.iteration + problem.ref_image_id + 1,
            np.float32))
    monkeypatch.setattr(tschedule, "process_problem", stub)
    assert tschedule.run_pipeline(folder, verbose=False, device="cpu") == 0
    # Passes B of both rounds: iterations 1-3 and 5-7, every view.
    assert [(it, ref) for it, ref, _ in seen] == [
        (it, v) for it in (1, 2, 3, 5, 6, 7) for v in range(VIEWS)]
    for it, ref, depths in seen:
        for v, d in depths.items():
            done = it if v < ref else it - 1     # views sweep in id order
            assert d == 1000.0 * done + v + 1, (it, ref, v, d)


def test_stage_timer_host_spans():
    timer = StageTimer()
    for _ in range(3):
        with timer.span("a"):
            time.sleep(0.01)
    with timer.span("b", device="cpu"):
        pass
    assert timer.counts == {"a": 3, "b": 1}
    assert 0.03 <= timer.totals["a"] < 1.0 and timer.totals["b"] < 0.01
    assert [ln.split()[0] for ln in timer.summary().splitlines()] == \
        ["a", "b"]


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_gpu_stage_timer_event_spans():
    timer = StageTimer()
    with timer.span("sleep", device="cuda"):
        torch.cuda._sleep(100_000_000)       # ~50 ms of device time
    t_host = time.perf_counter()
    with timer.span("empty", device="cuda"):
        pass
    t_host = time.perf_counter() - t_host
    assert t_host < 0.01                     # the span did not wait
    assert timer.totals["sleep"] > 0.01
    assert timer.counts == {"sleep": 1, "empty": 1}


def test_api_signature_and_cli_usage():
    from dpe_mvs_tpu import api as japi
    sig, jsig = inspect.signature(tapi.dpe_mvs), \
        inspect.signature(japi.dpe_mvs)

    def positional(s):
        return [(n, p.default) for n, p in s.parameters.items()
                if p.kind is not inspect.Parameter.KEYWORD_ONLY]
    assert positional(sig) == positional(jsig)
    assert [n for n, _ in positional(sig)] == [
        "dense_folder", "gpu_index", "verbose", "fusion", "viz", "depth",
        "normal", "weak", "edge"]
    kw = {n for n, p in sig.parameters.items()
          if p.kind is inspect.Parameter.KEYWORD_ONLY}
    assert {"cfg", "resume", "device"} <= kw
    assert tcli.main([]) == 1


def test_api_errors_are_runtime_errors(tmp_path):
    with pytest.raises(RuntimeError):
        tapi.dpe_mvs(str(tmp_path / "nonexistent"), device="cpu")
    _, a = _folder(tmp_path / "a", width=48, height=36)
    (a / "cams" / "00000000_cam.txt").write_text("extrinsic\nnot a number\n")
    with pytest.raises(RuntimeError):
        tapi.dpe_mvs(str(a), device="cpu")
    _, b = _folder(tmp_path / "b", width=48, height=36)
    (b / "images" / "00000001.jpg").unlink()
    with pytest.raises(RuntimeError):
        tapi.dpe_mvs(str(b), device="cpu")


def test_cli_flags_reach_run_pipeline(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tschedule, "run_pipeline",
                        lambda folder, **kw: calls.append(kw) or 0)
    monkeypatch.setattr(tapi, "_device",
                        lambda gpu_index, device: torch.device("cpu"))
    assert tcli.main([str(tmp_path), "0", "0", "1", "1"]) == 0
    assert tcli.main([str(tmp_path), "0", "1", "0", "1", "0", "1", "0",
                      "1"]) == 0
    assert tcli.main([str(tmp_path)]) == 0
    want = [dict(verbose=False, fusion=True, viz=True, depth=True,
                 normal=False, weak=False, edge=False),
            dict(verbose=True, fusion=True, viz=False, depth=False,
                 normal=True, weak=False, edge=True),
            dict(verbose=True, fusion=False, viz=False, depth=True,
                 normal=False, weak=False, edge=False)]
    assert len(calls) == 3
    for kw, w in zip(calls, want):
        assert {k: kw[k] for k in w} == w
        assert kw["device"] == torch.device("cpu")


def test_pipeline_exact_engine(tmp_path, monkeypatch):
    """``EngineConfig(use_rect=False)`` through ``dpe_mvs`` runs the exact
    engine end to end (the port's counterpart of JAX
    ``tests/test_pipeline.py::test_pipeline_rect_engine``): the config
    reaches every ``process_problem``, no rect host or round frame is
    built, and the scene is recovered (median < 3%, valid > 0.4)."""
    sc, folder = _folder(tmp_path / "s", width=48, height=36, seed=5)
    seen, built = [], []
    sweep, rect_host = tschedule.process_problem, tschedule._rect_host

    def spy_sweep(*args, **kw):
        seen.append(args[5].use_rect)
        return sweep(*args, **kw)
    monkeypatch.setattr(tschedule, "process_problem", spy_sweep)
    monkeypatch.setattr(tschedule, "_rect_host",
                        lambda *a, **k: built.append(a) or rect_host(*a, **k))
    monkeypatch.setattr(tschedule, "round_rect_frame",
                        lambda *a: built.append(a))
    ret = tapi.dpe_mvs(str(folder), 0, False, False, False, True,
                       cfg=TEngineConfig(use_rect=False, min_rounds=1),
                       device="cpu")
    assert ret == 0
    assert seen == [False] * 4 * VIEWS          # 1 round, 4 passes, 3 views
    assert built == []
    d = np.load(folder / "DPE" / "00000000" / "depth.npy")
    gt = sc.gt_depths[0]
    valid = d > 0
    assert valid.mean() > 0.4
    err = np.abs(d[valid] - gt[valid]) / gt[valid]
    assert np.median(err) < 0.03, np.median(err)


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_gpu_pipeline_exact_engine_two_rounds(tmp_path):
    """The exact engine through ``dpe_mvs`` on the card with the default two
    rounds, so round 1's pass A runs REFINE_INIT with the weak machinery:
    ``gather2d_hwc`` and ``gather2d_pick`` launch, the row kernels do not,
    and the scene is recovered to the CPU test's bars."""
    from dpe_mvs_tpu_torch.ops import gather2d as tg2d
    from dpe_mvs_tpu_torch.ops import rowgather as trow
    sc, folder = _folder(tmp_path / "s", seed=5)
    tg2d.reset_launches()
    trow.reset_launches()
    assert tapi.dpe_mvs(str(folder), 0, False, False, False, True,
                        cfg=TEngineConfig(use_rect=False)) == 0
    assert tg2d.LAUNCHES["gather2d_hwc"] > 0
    assert tg2d.LAUNCHES["gather2d_pick"] > 0
    assert trow.LAUNCHES == {"row_gather": 0, "bilinear_x": 0}
    d = np.load(folder / "DPE" / "00000000" / "depth.npy")
    gt = sc.gt_depths[0]
    valid = d > 0
    med = np.median(np.abs(d[valid] - gt[valid]) / gt[valid])
    print("exact two rounds on the card: valid", valid.mean(), "median", med,
          "launches", dict(tg2d.LAUNCHES))
    assert valid.mean() > 0.4
    assert med < 0.03, med


@pytest.mark.parametrize("use_rect", [None, True, False])
def test_use_rect_picks_the_engine(use_rect, tmp_path, monkeypatch):
    """``process_problem`` rectifies (rect host and views, ``rstat`` to the
    sweep) for ``use_rect`` None and True, and hands the exact engine no
    rect data for False. The sweep is stubbed."""
    mem = tsynth.make_plane_scene(width=32, height=24, num_views=2, seed=1)
    prob = tscene.Problem(index=0, ref_image_id=0, src_image_ids=[1],
                          dense_folder=tmp_path)
    got = []

    def stub(data, st, params, *, rstat=None, timer=None):
        got.append((rstat, data.rect))
        raise StopIteration
    monkeypatch.setattr(tschedule, "run_sweep_staged", stub)
    tschedule._RECT_HOSTS.clear()
    params = tschedule.config.schedule_params(
        tschedule.config.PatchMatchParams(), 0, None)
    with pytest.raises(StopIteration):
        tschedule.process_problem(prob, params, 1, 1, 1,
                                  TEngineConfig(use_rect=use_rect),
                                  device="cpu", inputs=mem.problem_inputs(0))
    rstat, rect = got[0]
    assert (rstat is None) == (use_rect is False)
    assert (rect is None) == (use_rect is False)
    assert bool(tschedule._RECT_HOSTS) == (use_rect is not False)
    tschedule._RECT_HOSTS.clear()


def test_unported_options_raise(tmp_path, monkeypatch):
    """Every option of the JAX package's ``dpe_mvs`` is ported now:
    ``parallel=True`` no longer raises NotImplementedError; on the CPU
    without a process group it runs the sequential pipeline (the API's
    case (c), ``tests/test_torch_parallel.py`` has the others). Without a
    card, the default device still raises."""
    _, folder = _folder(tmp_path / "s", width=48, height=36)
    calls = []
    run = tschedule.run_pipeline
    monkeypatch.setattr(tschedule, "run_pipeline",
                        lambda f, **kw: calls.append(kw) or 0)
    assert tapi.dpe_mvs(str(folder), device="cpu", parallel=True) == 0
    assert [kw["device"] for kw in calls] == [torch.device("cpu")]
    monkeypatch.setattr(tschedule, "run_pipeline", run)
    if not torch.cuda.is_available():        # the card is the default
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.dpe_mvs(str(folder))
        with pytest.raises(RuntimeError, match="not available"):
            tschedule.run_pipeline(folder, verbose=False)
