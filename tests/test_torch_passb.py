"""The PyTorch port's pass B (REFINE_ITER + weak machinery + edges +
geometric consistency, ``schedule_params(base, 1, 0)``) against the JAX
package, on the 48x36x3 plane scene after a shared round-0 pass A (the
port's, written to the scene's result folders; its parity is
test_torch_sweep.py's), with edge and label maps from ``edges/dual_level``.

  * the source-depth rectification: exact (the same nearest warps of the
    same scaled depths);
  * the geometric rect cost (``rect_cost_vector_stacked(geom=True)``) at
    stride 1, and at stride 2 with the EvalCache: ``assert_costs_close``
    (the geometric term of a valid center is exact; the NCC part agrees to
    ~1e-4);
  * one REFINE_ITER strong iteration with edge-bounded candidates from
    identical state and support maps: planes agree on >= 98% of the pixels,
    as slice 1's strong iteration;
  * a whole pass-B sweep of problem 0 through ``process_problem`` on the
    CPU, each package with its own random stream: the port's median
    relative depth error within 0.003 of the JAX package's and no worse than
    the shared pass A's + 0.003 (the bar of test_weak_rect.py); the weak
    stage changed some pixels;
  * the port's sweep timed by a host ``StageTimer``: the weak stage's six
    steps are spans nested in ``weak`` and take no more than it; untimed,
    the same sweep counts no host synchronisation and writes the same maps
    bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch.engine import rectcost as trc
from dpe_mvs_tpu_torch.engine import stages as tstages
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.io import scene as tscene
from dpe_mvs_tpu_torch.pipeline import schedule as tschedule
from dpe_mvs_tpu_torch.utils import profiling

import jax
import jax.numpy as jnp
from dpe_mvs_tpu.config import EngineConfig, PatchMatchParams, \
    schedule_params
from dpe_mvs_tpu.engine import patchmatch as pm
from dpe_mvs_tpu.engine import rectcost, stages
from dpe_mvs_tpu.engine import state as st_mod
from dpe_mvs_tpu.engine import sweep as jsweep
from dpe_mvs_tpu.geometry import cameras as geo
from dpe_mvs_tpu.io import formats
from dpe_mvs_tpu.io import scene as scene_mod
from dpe_mvs_tpu.pipeline import schedule as jschedule
from dpe_mvs_tpu.utils.synthetic import make_plane_scene

W, H, VIEWS, SEED = 48, 36, 3, 3
WEAK_STEPS = ("weak.ransac", "weak.sites", "weak.candidates", "weak.refine",
              "weak.final_cost", "weak.apply")
MAP_FILES = ("depths.dmb", "normals.dmb", "weak.bin", "selected_views.bin")


def _err(depth, gt):
    ok = depth > 0
    return float(np.median(np.abs(depth[ok] - gt[ok]) / gt[ok])), ok.mean()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    folder = tmp_path_factory.mktemp("torch_passb")
    sc = make_plane_scene(folder / "scene", width=W, height=H,
                          num_views=VIEWS, seed=SEED)
    problems = scene_mod.generate_sample_list(sc.folder)
    base = PatchMatchParams()
    cfg = EngineConfig(use_rect=True)
    v_pad = VIEWS - 1
    pass_a = torch_parity.port_params(schedule_params(base, 0, None))
    for p in problems:
        jschedule.get_problem_edges(p, 1, base)
        tschedule.process_problem(
            p, pass_a, 1, 0, v_pad, torch_parity.port_engine_config(cfg),
            device="cpu", inputs=scene_mod.load_problem_inputs(
                p, 1, need_prior=False, need_weak=False,
                need_src_depths=False))
    p0 = problems[0]
    err_a = _err(formats.read_dmb(p0.result_folder / "depths.dmb"),
                 sc.gt_depths[0])
    params = schedule_params(base, 1, 0)
    p0.iteration = 1
    inputs = scene_mod.load_problem_inputs(
        p0, 1, need_prior=True, need_weak=True, need_src_depths=True)
    maps = jschedule.load_support_maps(p0, 1, 0, params, W, H)
    rh = rectcost.build_rect_host(inputs.cameras, W, H, v_pad)
    views = rectcost.build_rect_views(rh, inputs.images,
                                      inputs.src_depths[1:],
                                      cameras=inputs.cameras)
    data = st_mod.build_sweep_data(inputs, v_pad, *maps)._replace(rect=views)
    return dict(sc=sc, problems=problems, cfg=cfg, v_pad=v_pad,
                params=params, inputs=inputs, maps=maps, rh=rh,
                views=views, data=data, err_a=err_a, folder=folder)


def test_src_depth_rectification_exact(scene):
    s = scene
    ours = trc.build_rect_views(
        trc.build_rect_host(s["inputs"].cameras, W, H, s["v_pad"]),
        s["inputs"].images, "cpu", src_depths=s["inputs"].src_depths[1:],
        cameras=s["inputs"].cameras)
    for rv, tv in zip(s["views"], ours):
        ref = np.asarray(rv.src_depth_rect)
        assert (ref > 0).mean() > 0.1
        np.testing.assert_array_equal(tv.src_depth_rect.numpy(), ref)


def _gt_plane(s, noise_seed=0):
    inputs = s["inputs"]
    cam = geo.Camera(K=jnp.asarray(inputs.cameras[0].K),
                     R=jnp.asarray(inputs.cameras[0].R),
                     t=jnp.asarray(inputs.cameras[0].t))
    n_cam = geo.normal_world_to_cam(cam, jnp.asarray(s["sc"].gt_normals[0]))
    px, py = geo.pixel_grid(H, W)
    rng = np.random.default_rng(noise_seed)
    depth = s["sc"].gt_depths[0] * rng.uniform(0.97, 1.03, (H, W))
    return np.asarray(geo.plane_from_depth_normal(
        cam, px, py, jnp.asarray(depth.astype(np.float32)), n_cam))


@pytest.mark.parametrize("stride", [1, 2])
def test_geometric_rect_cost(scene, stride):
    s = scene
    params = s["params"]
    offs = pm.strong_offsets(params)
    plane = _gt_plane(s)

    def jax_costs(vs, pl):
        stack = rectcost.build_rect_stack(vs, s["rh"].statics)
        cache = (rectcost.build_eval_cache(stack, params, offs, stride=stride,
                                           geom=True)
                 if stride > 1 else None)
        return rectcost.rect_cost_vector_stacked(
            stack, pl, s["data"].view_valid, params, offs, geom=True,
            stride=stride, cache=cache)

    ref = np.asarray(jax.jit(jax_costs)(s["views"], jnp.asarray(plane)))
    tdata = torch_parity.port_inputs(s["data"], s["views"])
    tparams = torch_parity.port_params(params)
    tstack = trc.build_rect_stack(tdata.rect,
                                  torch_parity.port_statics(s["rh"].statics))
    tcache = (trc.build_eval_cache(tstack, tparams, offs, stride=stride,
                                   geom=True) if stride > 1 else None)
    out = trc.rect_cost_vector_stacked(
        tstack, torch.tensor(plane), tdata.view_valid, tparams, offs,
        geom=True, stride=stride, cache=tcache).numpy()
    assert out.shape == ref.shape == (2, H, W)
    assert (ref < 0.5).mean() > 0.3 and (ref > 2.0).mean() > 0.001
    torch_parity.assert_costs_close(out, ref)


def test_pass_b_sweep(scene, monkeypatch, tmp_path):
    s = scene
    p0 = s["problems"][0]
    gt = s["sc"].gt_depths[0]
    weak_before = (s["inputs"].weak_info == 0).mean()
    assert weak_before > 0.0

    changed = []
    weak_iter = tstages._weak_iter

    def recording_weak_iter(data, sup, state, *args):
        out = weak_iter(data, sup, state, *args)
        changed.append(float((out.plane != state.plane).any(-1)
                             .float().mean()))
        return out
    monkeypatch.setattr(tstages, "_weak_iter", recording_weak_iter)

    prob = tscene.Problem(index=0, ref_image_id=0, src_image_ids=[1, 2],
                          dense_folder=tmp_path / "port", iteration=1)
    tschedule.process_problem(
        prob, torch_parity.port_params(s["params"]), 1, 0, s["v_pad"],
        torch_parity.port_engine_config(s["cfg"]), device="cpu",
        inputs=s["inputs"], support_maps=s["maps"])
    ours = _err(formats.read_dmb(prob.result_folder / "depths.dmb"), gt)

    # The JAX package's pass B of the same problem, from the same inputs.
    jschedule.process_problem(p0, s["params"], 1, 0, s["v_pad"], s["cfg"],
                              inputs=s["inputs"])
    ref = _err(formats.read_dmb(p0.result_folder / "depths.dmb"), gt)

    assert len(changed) == s["params"].max_iterations
    assert max(changed) > 0.0, changed          # the weak stage did work
    assert ours[1] > 0.5 and ref[1] > 0.5
    assert ours[0] <= ref[0] + 0.003, (ours, ref)
    assert ours[0] <= s["err_a"][0] + 0.003, (ours, s["err_a"])


def test_pass_b_sweep_spans(scene, tmp_path):
    s = scene
    # One iteration: every weak step runs, at a third of the sweep's cost.
    params = dataclasses.replace(torch_parity.port_params(s["params"]),
                                 max_iterations=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    timer = profiling.StageTimer()
    folders = {}
    try:
        for timed in (True, False):
            profiling.SYNCS.clear()
            prob = tscene.Problem(index=0, ref_image_id=0,
                                  src_image_ids=[1, 2],
                                  dense_folder=tmp_path / str(timed),
                                  iteration=1)
            tschedule.process_problem(
                prob, params, 1, 0,
                s["v_pad"], torch_parity.port_engine_config(s["cfg"]),
                device="cpu", inputs=s["inputs"], support_maps=s["maps"],
                timer=timer if timed else None)
            folders[timed] = prob.result_folder
    finally:
        torch.set_num_threads(threads)
    assert not profiling.SYNCS
    for f in MAP_FILES:
        assert (folders[True] / f).read_bytes() == \
            (folders[False] / f).read_bytes(), f

    totals = timer.totals
    assert timer.counts["weak"] == 1
    assert set(WEAK_STEPS) <= set(totals)
    for (name, t0, t1), parent in zip(timer.intervals, timer.parents):
        if name in WEAK_STEPS:
            assert parent == "weak", (name, parent)
            assert any(p == "weak" and p0 <= t0 <= t1 <= p1
                       for p, p0, p1 in timer.intervals), name
        elif name == "weak":
            assert parent is None
    assert timer.counts["weak.ransac"] == 1
    assert timer.counts["weak.apply"] == 2
    assert sum(totals[n] for n in WEAK_STEPS) <= totals["weak"]


def test_one_refine_iter_strong_iteration(scene):
    s = scene
    params = s["params"]
    st0 = st_mod.init_pm_state(s["inputs"], s["v_pad"], jax.random.key(4),
                               True)
    # The staged executor's own support and stage executables, which the
    # pass-B sweep above compiled already.
    sup, st = jsweep.build_support(s["data"], st0, params, jax.random.key(6),
                                   jit_pieces=True)
    st1 = stages._init_j(s["data"], st, params, s["rh"].statics)
    key_it = jax.random.fold_in(jax.random.key(9), 0)
    ref = torch_parity.to_numpy(stages._strong_j(
        s["data"], sup, st1, jnp.int32(0), key_it, params,
        s["rh"].statics))
    tdata = torch_parity.port_inputs(s["data"], s["views"])
    ts1 = tst.pm_state_from_numpy(torch_parity.to_numpy(st1), None, "cpu")
    out = tstages._strong_iter(
        tdata, ts1, 0, torch_parity.JaxKey(key_it),
        torch_parity.port_params(params),
        torch_parity.port_statics(s["rh"].statics),
        tst.support_from_numpy(torch_parity.to_numpy(sup), "cpu"))
    close = np.isclose(out.plane.numpy(), ref.plane, rtol=1e-4,
                       atol=1e-4).all(-1)
    assert close.mean() >= 0.98, close.mean()
    moved = ~np.isclose(ref.plane, torch_parity.to_numpy(st1).plane,
                        rtol=1e-4, atol=1e-4).all(-1)
    assert moved.mean() > 0.05
