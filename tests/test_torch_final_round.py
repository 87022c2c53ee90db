"""The ETH3D final round through the user's entry point
(``tools/torch_final_round.py``) against the JAX package, on small frames.

  * Resumed call list: on a 4-round folder (64x48x3, ``coarse_target`` 8:
    scales 8, 4, 2 and 1) holding the state the tool writes for iteration
    11, ``dpe_mvs(resume=True)`` of both packages, with ``process_problem``
    and ``get_problem_edges`` stubbed, makes the same calls: iterations
    12-15 only, every parameter field, the scale, the rect frame, and the
    priors, weak map and source depths loaded exactly where JAX loads them.
  * The state reads alike: the tool's state for iterations 11 and 14 read
    by the port's round-loop route (``load_problem_inputs`` in the prefetch
    thread, then ``add_pass_inputs`` for the source depths) and by the JAX
    package's ``load_problem_inputs`` gives equal arrays, bit for bit.
  * The resumed last iteration: the tool's ``main`` on a 64x48x2 folder
    (2 rounds) resumed after iteration 6 runs iteration 7 (two passes B),
    the exports and fusion on the CPU; the JAX package's ``run_pipeline``
    resumes a copy of the same folder, with fusion (the rect engine,
    compiled, as ``tests/test_pipeline.py`` runs it). The state is not the
    answer: every view's ground truth at half the frame (what round 0
    leaves), which pass B reads through ``rescale_nearest``, so the sweeps
    must refine a coarse prior. Every problem's median relative depth error
    is within 0.003 of JAX's, and both meet median < 0.02 and valid > 0.5;
    pixel by pixel, the valid masks agree and at least PIXEL_SHARE of the
    pixels valid in both lie within PIXEL_RTOL of JAX's depth; the fused
    cloud's points are within PLY_RTOL of JAX's. (Measured on this folder:
    0.891 and 0.615 of the pixels, 1267 points against JAX's 1357. A sweep
    whose propagation does nothing, ``max_iterations`` = 0, reads 0.786
    and 0.425, 2785 points.)
  * The tool end to end: its JSON line holds every key its docstring names,
    ``DPE/DPE.ply`` is written, ``--last-iteration`` stops the round loop
    and a second run on the same folder finishes it, and without a card and
    without ``--cpu`` it raises.
"""
import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from dpe_mvs_tpu_torch import api as tapi
from dpe_mvs_tpu_torch.config import EngineConfig as TEngineConfig
from dpe_mvs_tpu_torch.io import formats as tformats
from dpe_mvs_tpu_torch.io import scene as tscene
from dpe_mvs_tpu_torch.pipeline import schedule as tschedule
from dpe_mvs_tpu_torch.utils import synthetic as tsynth
from test_torch_pipeline import _plane_stub

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools import torch_final_round as tool  # noqa: E402

W, H, VIEWS = 64, 48, 3
RW, RH, RV = 64, 48, 2        # the runs: frame (2 rounds), views
PIXEL_RTOL = 1e-3             # |depth - JAX's| / JAX's, per pixel
PIXEL_SHARE = 0.55            # of the pixels valid in both packages
PLY_RTOL = 0.15               # fused points against JAX's
ENTRIES = ("row_gather", "bilinear_x", "gather2d", "gather2d_hwc",
           "gather2d_pick")


def _folder(path, iteration, round_num, width=W, height=H, views=VIEWS):
    """The tool's dense folder and the state ``iteration`` leaves."""
    sc = tsynth.make_plane_scene(width=width, height=height,
                                 num_views=views, seed=tool.SCENE_SEED)
    folder = tsynth.write_scene_folder(sc, path)
    tool.write_state(sc, folder, iteration, round_num)
    return sc, folder


def test_resumed_call_list_equals_jax(tmp_path, monkeypatch):
    from dpe_mvs_tpu import api as japi
    from dpe_mvs_tpu.config import EngineConfig
    from dpe_mvs_tpu.pipeline import schedule as jschedule
    assert tool.final_round_start(4) == 11
    _, folder = _folder(tmp_path / "port", 11, 4)
    assert tformats.read_dmb(folder / "DPE" / "00000001" / "depths.dmb"
                             ).shape == (H // 2, W // 2)
    jfolder = tmp_path / "jax"
    shutil.copytree(folder, jfolder)
    ours, ref, edges = [], [], []
    monkeypatch.setattr(tschedule, "process_problem", _plane_stub(ours))
    monkeypatch.setattr(jschedule, "process_problem", _plane_stub(ref))
    for mod in (tschedule, jschedule):
        monkeypatch.setattr(mod, "get_problem_edges",
                            lambda p, s, params, m=mod: edges.append(
                                (m.__name__, p.ref_image_id, s)))
    assert tapi.dpe_mvs(str(folder), 0, False, cfg=TEngineConfig(
        coarse_target=8), resume=True, device="cpu") == 0
    assert japi.dpe_mvs(str(jfolder), 0, False, cfg=EngineConfig(
        coarse_target=8, use_rect=True), resume=True) == 0
    assert ours == ref
    assert [(c[0], c[1]) for c in ours] == [
        (v, it) for it in (12, 13, 14, 15) for v in range(VIEWS)]
    assert {(c[2], c[3], c[10], c[11]) for c in ours} == {(1, 3, W, H)}
    # Priors and the weak map in every sweep of round 3, the sources'
    # depths in its passes B only.
    assert [c[7:10] for c in ours] == [(True, True, it > 12)
                                       for it in (12, 13, 14, 15)
                                       for _ in range(VIEWS)]
    # Edges and labels for every scale, by both packages alike.
    port = [e[1:] for e in edges if e[0] == tschedule.__name__]
    assert port == [e[1:] for e in edges if e[0] == jschedule.__name__]
    assert sorted({s for _, s in port}) == [1, 2, 4, 8]


@pytest.mark.parametrize("iteration", [11, 14])
def test_state_reads_alike(iteration, tmp_path):
    from dpe_mvs_tpu.config import PatchMatchParams, schedule_params
    from dpe_mvs_tpu.io import scene as jscene
    sc, folder = _folder(tmp_path / "s", iteration, 4)
    step = 2 if iteration == 11 else 1       # round 2's maps, or round 3's
    rows, cols = (np.arange(H) // step) * step, (np.arange(W) // step) * step
    base = PatchMatchParams()
    nxt = iteration + 1
    params = schedule_params(base, nxt // 4, None if nxt % 4 == 0
                             else nxt % 4 - 1)
    needs = tschedule.pass_needs(params)
    assert needs == dict(need_prior=True, need_weak=True,
                         need_src_depths=iteration == 14)
    for tp, jp in zip(tscene.generate_sample_list(folder),
                      jscene.generate_sample_list(folder)):
        ours = tscene.load_problem_inputs(
            tp, 1, **{**needs, "need_src_depths": False})
        if needs["need_src_depths"]:
            ours = tscene.add_pass_inputs(
                ours, tp.result_folder, tscene.view_folders(tp),
                need_prior=False, need_weak=False, need_src_depths=True)
        ref = jscene.load_problem_inputs(jp, 1, **needs)
        for name in ("images", "prior_depth", "prior_normal",
                     "prior_selected_views", "weak_info", "src_depths"):
            a, b = getattr(ours, name), getattr(ref, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == np.asarray(b).dtype, name
                np.testing.assert_array_equal(a, np.asarray(b), name)
        # The ground truth of the iteration's round, at the frame.
        np.testing.assert_array_equal(
            ours.prior_depth, sc.gt_depths[tp.ref_image_id][np.ix_(rows,
                                                                   cols)])
        assert (ours.depth_min, ours.depth_max, ours.width, ours.height) == \
            (ref.depth_min, ref.depth_max, ref.width, ref.height)
        for a, b in zip(ours.cameras, ref.cameras):
            for f in ("K", "R", "t"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tool's main on a 2-round 64x48x2 folder resumed after iteration
    6 from every view's ground truth at half the frame (its stdout kept),
    and the JAX package's pipeline resumed on a copy made before it."""
    from dpe_mvs_tpu.config import EngineConfig
    from dpe_mvs_tpu.pipeline import schedule as jschedule
    root = tmp_path_factory.mktemp("torch_final_round")
    sc = tsynth.make_plane_scene(width=RW, height=RH, num_views=RV,
                                 seed=tool.SCENE_SEED)
    folder = tsynth.write_scene_folder(sc, root / "port")
    for v in range(RV):
        tsynth.write_coarse_priors(sc, v, tformats.result_folder(folder, v))
    tschedule._save_progress(folder, 6)
    jfolder = root / "jax"
    shutil.copytree(folder, jfolder)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = tool.main(["--width", str(RW), "--height", str(RH), "--views",
                         str(RV), "--out", str(folder), "--cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        assert jschedule.run_pipeline(jfolder, verbose=False, depth=True,
                                      fusion=True,
                                      cfg=EngineConfig(use_rect=True),
                                      resume=True) == 0
    return sc, folder, jfolder, ret, out.getvalue()


def _depth(folder, v):
    return np.load(folder / "DPE" / f"{v:08d}" / "depth.npy")


def _median(d, gt):
    ok = d > 0
    return float(np.median(np.abs(d[ok] - gt[ok]) / gt[ok])), \
        float(ok.mean())


def _ply_points(path):
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"element vertex"):
                return int(line.split()[-1])
            if line.strip() == b"end_header":
                raise AssertionError(f"{path}: no vertex count")


def test_resumed_last_iteration_matches_jax(runs):
    sc, folder, jfolder, ret, _ = runs
    assert ret == 0
    for v in range(RV):
        d, dj, gt = _depth(folder, v), _depth(jfolder, v), sc.gt_depths[v]
        assert d.shape == dj.shape == gt.shape
        (med, valid), (jmed, jvalid) = _median(d, gt), _median(dj, gt)
        assert med < 0.02 and valid > 0.5, (v, med, valid)
        assert jmed < 0.02 and jvalid > 0.5, (v, jmed, jvalid)
        assert abs(med - jmed) <= 0.003, (v, med, jmed)
        ok, okj = d > 0, dj > 0
        assert (ok == okj).mean() >= 0.99, v
        both = ok & okj
        share = float((np.abs(d[both] - dj[both])
                       <= PIXEL_RTOL * dj[both]).mean())
        assert share >= PIXEL_SHARE, (v, share)
    n, nj = (_ply_points(f / "DPE" / "DPE.ply") for f in (folder, jfolder))
    assert abs(n - nj) <= PLY_RTOL * nj, (n, nj)


def test_tool_prints_every_key(runs):
    _, folder, _, _, stdout = runs
    res = json.loads(stdout.strip().splitlines()[-1])["final_round"]
    assert (folder / "DPE" / "DPE.ply").exists()
    assert not (folder / "DPE" / "progress.json").exists()  # cleaned up
    assert res["resumed_after"] == 6 and res["stopped_after"] is None
    assert list(res["iteration_s"]) == ["7"]
    assert [(s["iteration"], s["problem"]) for s in res["sweeps"]] == [
        (7, v) for v in range(RV)]
    for s in res["sweeps"]:
        assert set(s) == {"iteration", "problem", "seconds",
                          "allocated_before_mib", "peak_allocated_mib",
                          "max_reserved_mib",
                          "peak_stage", "stage_peak_mib", "host_rss_mib"}
        assert s["peak_allocated_mib"] is None      # no card
    spans = res["host_spans_s"]
    for name in ("edges, scale 0", "edges, scale 1", "load", "rectify",
                 "src-depth rectify", "writeback", "fusion", "export_npy",
                 "cleanup_intermediates"):
        assert spans[name] >= 0, name
    assert [ld["problem"] for ld in res["prefetch_loads"]] == \
        list(range(RV))
    assert res["host_peak_rss_mib"] > 0 and res["rect_hosts_mib"] > 0
    assert set(res["launches_per_iteration"]["7"]) == set(ENTRIES)
    assert set(res["launches_fusion"]) == set(ENTRIES)
    assert res["fusion_s"] > 0
    assert set(res["problems"]) == {str(v) for v in range(RV)}
    assert res["cloud"]["points"] > 0
    assert set(res["cloud"]) >= {"points", "precision", "recall", "fscore",
                                 "tau"}
    assert "seconds per iteration" in stdout


def test_tool_runs_in_pieces(tmp_path):
    """``--last-iteration`` stops the round loop once that iteration is
    recorded (no exports, no fusion); a second run on the folder resumes
    from its progress.json and finishes."""
    folder = tmp_path / "s"
    first = tool.run(16, 12, 2, resume_iteration=5, last_iteration=6,
                     out=folder, device="cpu", verbose=False)
    assert first["stopped_after"] == 6 and first["cloud"] is None
    assert [s["iteration"] for s in first["sweeps"]] == [6, 6]
    assert tschedule._load_progress(folder) == 6
    assert not (folder / "DPE" / "DPE.ply").exists()
    second = tool.run(16, 12, 2, out=folder, device="cpu", verbose=False)
    assert second["resumed_after"] == 6
    assert [s["iteration"] for s in second["sweeps"]] == [7, 7]
    assert (folder / "DPE" / "DPE.ply").exists()


def test_tool_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    with pytest.raises(RuntimeError, match="not available"):
        tool.run(32, 24, 2)
    with pytest.raises(RuntimeError, match="not available"):
        tool.main(["--width", "32", "--height", "24", "--views", "2"])
