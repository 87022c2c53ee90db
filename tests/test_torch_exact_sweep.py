"""The PyTorch port's exact-engine sweep (``engine.sweep.run_sweep``, that is
``run_sweep_staged(rstat=None)``) end to end.

  * Against JAX ``run_sweep_jit`` in the geometric pass-B configuration of
    ``tests/test_stages.py`` (REFINE_ITER, the weak machinery, edges and
    the geometric term, two iterations, a mid-depth fronto-parallel prior,
    constant source depths) on a 48x36x3 plane scene, drawing the same
    random numbers (``torch_parity.JaxKey``): both recover the ground truth
    (median relative depth error < 2%) and the port's median is within
    0.003 of JAX's.
  * The other two configurations of that file, round-0 pass A and a pass A
    with the weak machinery and edges, on the port's side only with its own
    random stream (``TorchKey``): median < 2%, valid (in range) > 90%.
GPU (marked ``gpu``, skipped without a CUDA device): the same exact sweep at
64x48x3 on the card and on the CPU from the same draws (a key on the CPU):
depths within 1% on >= 98% of the pixels, labels equal on >= 98%, both
medians < 2%. The card's ``exp`` differs from the CPU's, so they are not
bit-equal, and after a whole sweep of refinements two planes that agree in
depth differ past 1e-4 in most pixels: the depths are what is compared.
``test_float_library_moves_planes_not_depths`` shows this on the CPU,
with XLA's float functions in place of libm's (measured: 30% of the planes
within 1e-4, 99.8% of the depths within 1%). JAX is imported only by the
CPU tests.
"""
import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch import config as tcfg
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.engine.sweep import run_sweep
from dpe_mvs_tpu_torch.utils import synthetic as tsynth
from dpe_mvs_tpu_torch.utils.rng import TorchKey

W, H, VIEWS = 48, 36, 3
CONFIGS = [(False, False, False),   # round-0 pass A
           (True, True, False),     # a pass A with the weak machinery
           (True, True, True)]      # geometric pass B


def _params(use_APD, use_edge, geom):
    return dict(state=2 if geom else 0, use_APD=use_APD, use_edge=use_edge,
                use_limit=use_APD, use_label=use_APD, geom_consistency=geom,
                max_iterations=2)


def _median(depth, gt):
    ok = depth > 0
    return float(np.median(np.abs(depth[ok] - gt[ok]) / gt[ok])), ok.mean()


def test_geometric_pass_matches_jax(tmp_path):
    import jax
    from dpe_mvs_tpu.config import PatchMatchParams, RunState
    from dpe_mvs_tpu.engine import state as st_mod
    from dpe_mvs_tpu.engine.sweep import run_sweep_jit
    from dpe_mvs_tpu.io import scene as scene_mod
    from dpe_mvs_tpu.utils.synthetic import make_plane_scene

    sc = make_plane_scene(str(tmp_path), width=W, height=H,
                          num_views=VIEWS, seed=0)
    inputs = scene_mod.load_problem_inputs(
        scene_mod.generate_sample_list(sc.folder)[0], 1, need_prior=False,
        need_weak=False, need_src_depths=False)
    v_pad = VIEWS - 1
    mid = 0.5 * (inputs.depth_min + inputs.depth_max)
    data = st_mod.build_sweep_data(inputs, v_pad)
    data = data._replace(src_depths=data.src_depths.at[:].set(mid))
    kw = _params(True, True, True)
    kw["state"] = RunState(kw["state"])
    params = PatchMatchParams(**kw)
    st0 = st_mod.init_pm_state(inputs, v_pad, jax.random.key(7), True)
    plane = np.zeros((H, W, 4), np.float32)
    plane[..., 2] = -1.0
    plane[..., 3] = mid
    st0 = st0._replace(plane=jax.numpy.asarray(plane))

    ref = run_sweep_jit(data, st0, params)
    ours = run_sweep(
        tst.sweep_data_from_numpy(torch_parity.to_numpy(data), "cpu"),
        tst.pm_state_from_numpy(torch_parity.to_numpy(st0),
                                torch_parity.JaxKey(st0.key), "cpu"),
        torch_parity.port_params(params))
    gt = sc.gt_depths[0]
    med_j = _median(np.asarray(ref.plane[..., 3]), gt)[0]
    med_t = _median(ours.plane[..., 3].numpy(), gt)[0]
    assert med_j < 0.02 and med_t < 0.02, (med_j, med_t)
    assert abs(med_t - med_j) <= 0.003, (med_t, med_j)
    assert (ours.weak.numpy() == np.asarray(ref.weak)).mean() >= 0.95
    # The key handed on is JAX's (keys[-1] of the sweep's split).
    np.testing.assert_array_equal(jax.random.key_data(ours.key.key),
                                  jax.random.key_data(ref.key))


@pytest.mark.parametrize("use_APD,use_edge,geom", CONFIGS[:2])
def test_pass_a_configurations(use_APD, use_edge, geom):
    sc = tsynth.make_plane_scene(width=W, height=H, num_views=VIEWS, seed=0)
    inputs = sc.problem_inputs(0)
    maps = tsynth.support_maps(inputs.images[0]) if use_edge else (None,) * 3
    data = tst.build_sweep_data(inputs, VIEWS - 1, *maps, device="cpu")
    params = tcfg.PatchMatchParams(
        **{**_params(use_APD, use_edge, geom),
           "state": tcfg.RunState.FIRST_INIT})
    st0 = tst.init_pm_state(inputs, VIEWS - 1, TorchKey(7), use_APD, "cpu")
    out = run_sweep(data, st0, params)
    depth = out.plane[..., 3].numpy()
    assert np.isfinite(depth).all()
    in_range = (depth >= inputs.depth_min) & (depth <= inputs.depth_max)
    assert in_range.mean() > 0.9
    med = _median(np.where(in_range, depth, 0.0), sc.gt_depths[0])[0]
    assert med < 0.02, med


def _card_scene():
    sc = tsynth.make_plane_scene(width=64, height=48, num_views=VIEWS,
                                 seed=2)
    return sc, sc.problem_inputs(0), tcfg.schedule_params(
        tcfg.PatchMatchParams(), 0, None)


def _agreement(plane, weak):
    """(planes to 1e-4, depths within 1%, labels equal) of run 1 against
    run 0."""
    d0, d1 = plane[0][..., 3], plane[1][..., 3]
    return (np.isclose(plane[1], plane[0], rtol=1e-4, atol=1e-4).all(-1)
            .mean(), (np.abs(d1 - d0) <= 0.01 * np.abs(d0)).mean(),
            (weak[1] == weak[0]).mean())


def test_float_library_moves_planes_not_depths(monkeypatch):
    """The GPU test's comparison on the CPU, with XLA:CPU's ``exp``,
    ``sqrt`` and summation order (``torch_parity.xla_cpu_float``) standing
    in for the card's float library: the depths and labels meet the GPU
    test's bars while most planes differ past 1e-4 (measured 30%)."""
    _, inputs, params = _card_scene()
    plane, weak = [], []
    for xla_float in (False, True):
        if xla_float:
            torch_parity.xla_cpu_float(monkeypatch)
        data = tst.build_sweep_data(inputs, VIEWS - 1, device="cpu")
        st0 = tst.init_pm_state(inputs, VIEWS - 1, TorchKey(3, "cpu"), False,
                                "cpu")
        out = run_sweep(data, st0, params)
        plane.append(out.plane.numpy())
        weak.append(out.weak.numpy())
    same_plane, near, same_label = _agreement(plane, weak)
    print("XLA's float functions vs libm's: planes to 1e-4", same_plane,
          "depths within 1%", near, "labels", same_label)
    assert near >= 0.98, near
    assert same_label >= 0.98, same_label


@pytest.mark.gpu
def test_gpu_exact_sweep_equals_cpu_statistically():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sc, inputs, params = _card_scene()
    plane, weak = [], []
    for dev in ("cpu", "cuda"):
        data = tst.build_sweep_data(inputs, VIEWS - 1, device=dev)
        st0 = tst.init_pm_state(inputs, VIEWS - 1, TorchKey(3, "cpu"), False,
                                dev)
        out = run_sweep(data, st0, params)
        plane.append(out.plane.cpu().numpy())
        weak.append(out.weak.cpu().numpy())
    same_plane, near, same_label = _agreement(plane, weak)
    print("card vs CPU: planes to 1e-4", same_plane, "depths within 1%",
          near, "labels", same_label)
    assert near >= 0.98, near
    assert same_label >= 0.98, same_label
    for d in (p[..., 3] for p in plane):
        assert np.median(np.abs(d - sc.gt_depths[0]) / sc.gt_depths[0]) < 0.02
