"""The PyTorch port's pass-A sweep end to end against the JAX package.

The port's ``process_problem`` (inputs loaded through ``dpe_mvs_tpu.io``)
and JAX ``run_sweep_staged(rstat=...)`` on the same 96x72x3 plane scene,
each with its own random stream: both must recover the ground truth (median
relative depth error < 2%, valid > 50%, the bar of test_tpu.py), and their
depths must agree within 1% on >= 90% of the pixels valid in both. The
port's .dmb files go through JAX ``export_npy``; the cv2-free renderer gives
the folder renderer's cameras, depth range and ground truth.
"""
import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch.pipeline import schedule as tschedule
from dpe_mvs_tpu_torch.utils import synthetic as tsynth

import jax
from dpe_mvs_tpu.config import EngineConfig, PatchMatchParams, \
    PixelState, schedule_params
from dpe_mvs_tpu.engine import rectcost
from dpe_mvs_tpu.engine import state as st_mod
from dpe_mvs_tpu.engine.stages import run_sweep_staged
from dpe_mvs_tpu.io import formats
from dpe_mvs_tpu.io import scene as scene_mod
from dpe_mvs_tpu.pipeline.schedule import export_npy
from dpe_mvs_tpu.utils.synthetic import make_plane_scene

W, H, VIEWS, SEED = 96, 72, 3, 0


@pytest.fixture(scope="module")
def folder_scene(tmp_path_factory):
    folder = tmp_path_factory.mktemp("torch_sweep_scene")
    sc = make_plane_scene(folder, width=W, height=H, num_views=VIEWS,
                          seed=SEED)
    return sc, scene_mod.generate_sample_list(sc.folder)


def _gt_stats(depth, gt):
    ok = depth > 0
    med = float(np.median(np.abs(depth[ok] - gt[ok]) / gt[ok]))
    return ok, med


def test_pass_a_sweep_matches_jax(folder_scene):
    sc, problems = folder_scene
    problem = problems[0]
    params = schedule_params(PatchMatchParams(), 0, None)
    cfg = EngineConfig()
    v_pad = VIEWS - 1

    inputs = scene_mod.load_problem_inputs(
        problem, 1, need_prior=False, need_weak=False, need_src_depths=False)
    tschedule.process_problem(problem, torch_parity.port_params(params), 1,
                              1, v_pad, torch_parity.port_engine_config(cfg),
                              device="cpu", inputs=inputs)
    ours = formats.read_dmb(problem.result_folder / "depths.dmb")
    rh = rectcost.build_rect_host(inputs.cameras, W, H, v_pad)
    views = rectcost.build_rect_views(rh, inputs.images, None,
                                      cameras=inputs.cameras)
    data = st_mod.build_sweep_data(inputs, v_pad)._replace(rect=views)
    st = st_mod.init_pm_state(inputs, v_pad, jax.random.key(cfg.seed),
                              False)
    st = run_sweep_staged(data, st, params, rstat=rh.statics)
    ref = np.asarray(st.plane)[..., 3]
    ref = np.where((ref >= inputs.depth_min) & (ref <= inputs.depth_max),
                   ref, 0.0)

    gt = sc.gt_depths[0]
    for depth in (ours, ref):
        ok, med = _gt_stats(depth, gt)
        assert ok.mean() > 0.5
        assert med < 0.02, med
    both = (ours > 0) & (ref > 0)
    agree = np.abs(ours[both] - ref[both]) <= 0.01 * ref[both]
    assert agree.mean() >= 0.9, agree.mean()

    # The JAX package's exporter reads the port's files.
    export_npy(problem, depth=True, normal=True, weak=True, edge=False)
    rf = problem.result_folder
    d = np.load(rf / "depth.npy")
    weak = formats.read_dmb(rf / "weak.bin")
    np.testing.assert_array_equal(
        d, np.where(weak == int(PixelState.UNKNOWN), 0.0, ours))
    n = np.load(rf / "normal.npy")
    assert n.shape == (H, W, 3)
    np.testing.assert_allclose(np.linalg.norm(n[ours > 0], axis=-1), 1.0,
                               atol=1e-3)
    assert set(np.unique(np.load(rf / "weak.npy"))) <= {0, 1, 2}
    sel = formats.read_dmb(rf / "selected_views.bin")
    assert sel.dtype == np.int32 and sel.shape == (H, W)
    assert 0 <= sel.min() and sel.max() < 2 ** v_pad


def test_sweep_inputs_match(folder_scene):
    """build_sweep_data / init_pm_state: the same numpy preparation."""
    from dpe_mvs_tpu_torch.engine import state as tst
    sc, problems = folder_scene
    inputs = scene_mod.load_problem_inputs(
        problems[1], 1, need_prior=False, need_weak=False,
        need_src_depths=False)
    v_pad = VIEWS
    ref = torch_parity.to_numpy(st_mod.build_sweep_data(inputs, v_pad))
    ours = tst.build_sweep_data(inputs, v_pad, device="cpu")
    for name in ("ref_image", "src_images", "R_rel", "t_rel", "baseline",
                 "view_valid", "src_depths", "depth_min", "depth_max",
                 "edge", "edge_low", "label"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      getattr(ref, name), err_msg=name)
    for cam in ("ref_cam", "src_cams"):
        for f in ("K", "R", "t"):
            np.testing.assert_array_equal(
                getattr(getattr(ours, cam), f).numpy(),
                getattr(getattr(ref, cam), f))
    st_ref = torch_parity.to_numpy(st_mod.init_pm_state(
        inputs, v_pad, jax.random.key(0), False))
    st = tst.init_pm_state(inputs, v_pad, None, False, "cpu")
    for name in ("plane", "cost", "view_weight", "weak"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      getattr(st_ref, name))
    np.testing.assert_array_equal(st.selected.numpy().view(np.uint32),
                                  st_ref.selected)


def test_cv2_free_renderer_matches_folder_scene(folder_scene):
    sc, problems = folder_scene
    mem = tsynth.make_plane_scene(width=W, height=H, num_views=VIEWS,
                                  seed=SEED)
    for v in range(VIEWS):
        np.testing.assert_array_equal(mem.gt_depths[v], sc.gt_depths[v])
        np.testing.assert_array_equal(mem.gt_normals[v], sc.gt_normals[v])
    for p in problems:
        a = scene_mod.load_problem_inputs(p, 1, need_prior=False,
                                          need_weak=False,
                                          need_src_depths=False)
        b = mem.problem_inputs(p.ref_image_id)
        assert (a.width, a.height) == (b.width, b.height)
        assert (a.depth_min, a.depth_max) == (b.depth_min, b.depth_max)
        for ca, cb in zip(a.cameras, b.cameras):
            for f in ("K", "R", "t"):
                np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))
            assert (ca.depth_min, ca.depth_max) == (cb.depth_min,
                                                    cb.depth_max)
        assert b.images.shape == a.images.shape
        # Same kind of texture (not the same pixels: the folder version
        # also goes through OpenCV's resize and JPEG).
        assert abs(float(b.images.std()) - float(a.images.std())) < \
            0.25 * float(a.images.std())


def test_process_problem_rejects_later_passes(tmp_path):
    """Without inputs a sweep loads its problem from the dense folder, and a
    pass with the weak machinery or edges reads the round's edge and label
    maps from the problem's cache: missing files raise. The exact engine
    (``EngineConfig(use_rect=False)``) runs a 32x24 pass A without a rect
    host."""
    from dpe_mvs_tpu_torch import config as tcfg
    from dpe_mvs_tpu_torch.io import scene as tscene
    mem = tsynth.make_plane_scene(width=32, height=24, num_views=2, seed=1)
    prob = tscene.Problem(index=0, ref_image_id=0, src_image_ids=[1],
                          dense_folder=tmp_path)
    pass_a = tcfg.schedule_params(tcfg.PatchMatchParams(), 0, None)
    with pytest.raises(FileNotFoundError, match="00000000.jpg"):
        tschedule.process_problem(prob, pass_a, 1, 1, 1, tcfg.EngineConfig(),
                                  device="cpu")
    tschedule._RECT_HOSTS.clear()
    st = tschedule.process_problem(prob, pass_a, 1, 1, 1,
                                   tcfg.EngineConfig(use_rect=False),
                                   device="cpu", inputs=mem.problem_inputs(0))
    assert not tschedule._RECT_HOSTS
    assert st.plane.shape == (24, 32, 4)
    assert torch.isfinite(st.plane).all()
    assert (prob.result_folder / "depths.dmb").is_file()
    for params in (tcfg.schedule_params(tcfg.PatchMatchParams(), 1, None),
                   tcfg.schedule_params(tcfg.PatchMatchParams(), 1, 0)):
        with pytest.raises(FileNotFoundError, match="edges_0.dmb"):
            tschedule.process_problem(prob, params, 1, 1, 1,
                                      tcfg.EngineConfig(), device="cpu",
                                      inputs=mem.problem_inputs(0))


def test_cuda_device_is_never_replaced(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    from dpe_mvs_tpu_torch import config as tcfg
    from dpe_mvs_tpu_torch.io import scene as tscene
    mem = tsynth.make_plane_scene(width=32, height=24, num_views=2, seed=1)
    prob = tscene.Problem(index=0, ref_image_id=0, src_image_ids=[1],
                          dense_folder=tmp_path)
    pass_a = tcfg.schedule_params(tcfg.PatchMatchParams(), 0, None)
    for kw in ({"device": "cuda"}, {}):       # the card is the default
        with pytest.raises(RuntimeError, match="not available"):
            tschedule.process_problem(
                prob, pass_a, 1, 1, 1, tcfg.EngineConfig(),
                inputs=mem.problem_inputs(0), **kw)
