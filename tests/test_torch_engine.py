"""The exact engine's stages of the PyTorch port against the JAX package,
from identical state and drawing the same random numbers
(``torch_parity.JaxKey``), on 48x36x3 plane scenes.

  * ``initialize``, FIRST_INIT and REFINE: planes to 1e-5, costs to the
    stated ~1e-4 (``assert_costs_close``), ``selected`` on >= 99.9% of the
    pixels, the key handed on equal;
  * ``classic_candidates``, ``edge_candidates`` and
    ``edge_second_pass_candidates``: equal on a cost map full of ties, at
    iterations 0-2 (ties resolve to the first probe in both);
  * one ``propagate_strong`` color without edges (round-0 pass A): past the
    candidate argmins parity is statistical (costs agree to ~1e-4, so
    near-ties can resolve to another candidate): planes agree to 1e-4 on
    >= 98% of the sites, and where they agree the costs agree to 1e-4 on
    >= 99% of them (pass B's colors, with edges and the weak ones, are in
    ``test_torch_exact_propagation.py``);
  * ``disparity_sweep`` with ``rstat=None``: the stated ~1e-4;
    ``depth_to_weak`` labels equal on >= 98% of the pixels and
    ``local_refine`` depths within 1e-4 relative on >= 98% (the bars of the
    rect counterparts in ``tests/test_torch_rectcost.py``);
  * the four checks of ``tests/test_engine.py`` on the port's own sweep:
    convergence, the border margin, determinism, REFINE_ITER holding or
    improving.
"""
import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch import config as tcfg
from dpe_mvs_tpu_torch.engine import patchmatch as tpm
from dpe_mvs_tpu_torch.engine import stages as tstages
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.engine.sweep import run_sweep
from dpe_mvs_tpu_torch.utils import synthetic as tsynth
from dpe_mvs_tpu_torch.utils.rng import TorchKey

import jax
import jax.numpy as jnp
from dpe_mvs_tpu.config import PatchMatchParams, PixelState, RunState, \
    schedule_params
from dpe_mvs_tpu.engine import patchmatch as jpm
from dpe_mvs_tpu.engine import stages
from dpe_mvs_tpu.engine import state as st_mod
from dpe_mvs_tpu.io import scene as scene_mod
from dpe_mvs_tpu.ops import checker as jchecker
from dpe_mvs_tpu.ops import support as jsupport
from dpe_mvs_tpu.utils.synthetic import make_plane_scene

W, H, VIEWS = 48, 36, 3
PW, PH = 64, 48          # the port-only sweep checks


def _tstate(st, key=None):
    return tst.pm_state_from_numpy(torch_parity.to_numpy(st), key, "cpu")


def _tsup(sup):
    return tst.support_from_numpy(torch_parity.to_numpy(sup), "cpu")


@pytest.fixture(scope="module")
def pass_a(tmp_path_factory):
    """Round-0 pass A inputs, the state before and after the exact init."""
    sc = make_plane_scene(str(tmp_path_factory.mktemp("torch_engine")),
                          width=W, height=H, num_views=VIEWS, seed=0)
    inputs = scene_mod.load_problem_inputs(
        scene_mod.generate_sample_list(sc.folder)[0], 1, need_prior=False,
        need_weak=False, need_src_depths=False)
    data = st_mod.build_sweep_data(inputs, VIEWS - 1)
    params = schedule_params(PatchMatchParams(), 0, None)
    st0 = st_mod.init_pm_state(inputs, VIEWS - 1, jax.random.key(3), False)
    st1 = jax.jit(jpm.initialize, static_argnames="params")(data, st0,
                                                            params=params)
    return dict(sc=sc, inputs=inputs, data=data, params=params, st0=st0,
                st1=st1, tparams=torch_parity.port_params(params),
                tdata=tst.sweep_data_from_numpy(torch_parity.to_numpy(data),
                                                "cpu"))


@pytest.mark.parametrize("state", ["first_init", "refine"])
def test_initialize(pass_a, state):
    c = pass_a
    params, st0 = c["params"], c["st0"]
    if state == "refine":
        params = schedule_params(PatchMatchParams(), 0, 0)
        rng = np.random.default_rng(4)
        gt = c["sc"].gt_depths[0] * rng.uniform(0.97, 1.03, (H, W))
        plane = np.concatenate([c["sc"].gt_normals[0], gt[..., None]], -1)
        st0 = st0._replace(
            plane=jnp.asarray(plane.astype(np.float32)),
            selected=jnp.asarray(rng.integers(0, 4, (H, W)).astype(
                np.uint32)))
    ref = torch_parity.to_numpy(jax.jit(
        jpm.initialize, static_argnames="params")(c["data"], st0,
                                                  params=params))
    ours = tpm.initialize(c["tdata"], _tstate(st0, torch_parity.JaxKey(
        st0.key)), torch_parity.port_params(params))
    np.testing.assert_allclose(ours.plane.numpy(), ref.plane, rtol=1e-5,
                               atol=1e-5)
    torch_parity.assert_costs_close(ours.cost.numpy(), ref.cost)
    assert (ours.cost.numpy() < 2.0).mean() > 0.5
    sel = ours.selected.numpy().view(np.uint32)
    assert (sel == ref.selected).mean() >= 0.999
    np.testing.assert_array_equal(jax.random.key_data(ours.key.key),
                                  jax.random.key_data(ref.key))


@pytest.mark.parametrize("it", [0, 1, 2])
def test_candidates_equal(it):
    """Every direction's flag and probe offsets equal JAX's, on a cost map
    of 11 levels (ties everywhere) and a random edge map."""
    rng = np.random.default_rng(it)
    cost = (rng.integers(0, 11, (H, W)) / 5.0).astype(np.float32)
    edge = rng.uniform(size=(H, W)) < 0.08
    steps = jsupport.edge_steps(jnp.asarray(edge), 64)
    tc, te, ts = (torch.from_numpy(cost), torch.from_numpy(edge),
                  torch.from_numpy(np.array(steps)))
    pairs = [
        (jax.jit(jpm.classic_candidates)(jnp.asarray(cost)),
         tpm.classic_candidates(tc)),
        (jax.jit(jpm.edge_candidates)(jnp.asarray(cost), jnp.asarray(edge),
                                      steps, it),
         tpm.edge_candidates(tc, te, ts, it)),
        (jax.jit(jpm.edge_second_pass_candidates)(jnp.asarray(cost), it),
         tpm.edge_second_pass_candidates(tc, it)),
    ]
    for ref, ours in pairs:
        for r_list, o_list in zip(ref, ours):
            assert len(r_list) == len(o_list) == 8
            for r, o in zip(r_list, o_list):
                np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def agree(ours, ref, sites=None):
    """(plane agreement, cost agreement where the planes agree)."""
    close = np.isclose(ours[0].numpy(), ref[0], rtol=1e-4,
                       atol=1e-4).all(-1)
    cost_ok = np.abs(ours[1].numpy() - ref[1]) <= 1e-4
    if sites is not None:
        close, cost_ok = close[sites], cost_ok[sites]
    return close.mean(), cost_ok[close].mean()


def test_one_strong_color(pass_a):
    """Round-0 pass A (no edges), color 1."""
    c = pass_a
    key = jax.random.key(21)
    ref = torch_parity.to_numpy(jax.jit(
        lambda k, d, s: jpm.propagate_strong(
            k, d, jpm.Support(*([None] * 8)), s, c["params"], 0, 1))(
        key, c["data"], c["st1"]))
    ours = tpm.propagate_strong(torch_parity.JaxKey(key), c["tdata"],
                                tpm.EMPTY_SUPPORT, _tstate(c["st1"]),
                                c["tparams"], 0, 1)
    planes, costs = agree(ours, ref)
    assert planes >= 0.98, planes
    assert costs >= 0.99, costs
    assert (ours[2].numpy().view(np.uint32) == ref[2]).mean() >= 0.95
    moved = ~np.isclose(ref[0], np.asarray(jchecker.compact(
        c["st1"].plane, 1)), rtol=1e-4, atol=1e-4).all(-1)
    assert moved.mean() > 0.2                     # the proposal did work


def world_state(c, rng):
    """A post-finish state: ground-truth planes (world normal, depth) with
    1% depth noise, random selections and weights."""
    sc = c["sc"] if "sc" in c else c["ws"].sc
    plane = np.concatenate([sc.gt_normals[0], (sc.gt_depths[0] * rng.uniform(
        0.99, 1.01, (H, W)))[..., None]], -1).astype(np.float32)
    return st_mod.PMState(
        plane=jnp.asarray(plane),
        cost=jnp.asarray(rng.uniform(0, 0.6, (H, W)).astype(np.float32)),
        selected=jnp.asarray(rng.integers(1, 4, (H, W)).astype(np.uint32)),
        view_weight=jnp.asarray(rng.integers(0, 5, (H, W, VIEWS - 1))
                                .astype(np.int32)),
        weak=jnp.ones((H, W), jnp.uint8), key=jax.random.key(0))


def test_disparity_sweep_classify_refine(pass_a):
    check_disparity_classify_refine(pass_a, pass_a["params"], geom=False)


def check_disparity_classify_refine(c, params, geom):
    """``disparity_sweep``, the classify and the refine stage with
    ``rstat=None`` from a post-finish state of the case ``c``."""
    rng = np.random.default_rng(7)
    st = world_state(c, rng)
    disps = np.arange(-5, 6, dtype=np.float32)
    ref = np.asarray(jax.jit(lambda d, s: jpm.disparity_sweep(
        d, s, params, disps))(c["data"], st))
    ours = tpm.disparity_sweep(c["tdata"], _tstate(st), c["tparams"],
                               disps).numpy()
    assert ours.shape == ref.shape == (11, H, W)
    assert (ref < 1.0).mean() > 0.2
    if geom:
        # The geometric term reads source depth at the truncated projection:
        # where compiled JAX's FMA moves a projection across a pixel edge it
        # reads another depth (a few entries, by up to 0.006 in the mean).
        torch_parity.assert_costs_close(ours, ref, frac=0.995, atol_max=1e-2)
    else:
        torch_parity.assert_costs_close(ours, ref)

    cls = stages._classify_j(c["data"], st, params, None)
    tcls = tstages._classify_stage(c["tdata"], _tstate(st), c["tparams"],
                                   None)
    weak_j = np.asarray(cls.weak)
    assert len(np.unique(weak_j)) == 3          # weak, strong and unknown
    assert (tcls.weak.numpy() == weak_j).mean() >= 0.98

    noisy = np.asarray(cls.plane).copy()
    noisy[..., 3] *= rng.uniform(0.85, 1.15, (H, W)).astype(np.float32)
    cls = cls._replace(plane=jnp.asarray(noisy))
    ref = np.asarray(stages._refine_j(c["data"], cls, params,
                                      None).plane)[..., 3]
    out = tstages._refine_stage(c["tdata"], _tstate(cls), c["tparams"],
                                None).plane[..., 3]
    moved = ref != noisy[..., 3]
    assert moved.mean() > 0.02
    assert np.isclose(out.numpy(), ref, rtol=1e-4, atol=0).mean() >= 0.98


# ---- the four checks of tests/test_engine.py, on the port's exact sweep ----

@pytest.fixture(scope="module")
def port_sweep():
    sc = tsynth.make_plane_scene(width=PW, height=PH, num_views=VIEWS,
                                 seed=1)
    inputs = sc.problem_inputs(0)
    data = tst.build_sweep_data(inputs, VIEWS - 1, device="cpu")
    params = tcfg.schedule_params(tcfg.PatchMatchParams(), 0, None)
    st = tst.init_pm_state(inputs, VIEWS - 1, TorchKey(0), False, "cpu")
    return sc, inputs, data, params, st, run_sweep(data, st, params)


def _rel_err(out, gt):
    return np.abs(out.plane[..., 3].numpy() - gt) / gt


def test_first_init_sweep_converges(port_sweep):
    sc, _, _, _, _, out = port_sweep
    err = _rel_err(out, sc.gt_depths[0])
    assert np.median(err) < 0.01, np.median(err)
    assert (err < 0.05).mean() > 0.9
    n = out.plane[..., :3].numpy()
    cos = np.clip(np.sum(n * sc.gt_normals[0], -1), -1, 1)
    assert np.degrees(np.arccos(np.median(cos))) < 15.0


def test_border_margin_unknown(port_sweep):
    weak = port_sweep[-1].weak.numpy()
    assert (weak[:6, :] == int(PixelState.UNKNOWN)).all()
    assert (weak[:, -6:] == int(PixelState.UNKNOWN)).all()
    interior = weak[6:-6, 6:-6]
    assert (interior == int(PixelState.STRONG)).mean() > 0.8


def test_sweep_deterministic(port_sweep):
    _, _, data, params, st, out = port_sweep
    again = run_sweep(data, st, params)
    assert torch.equal(again.plane, out.plane)
    assert torch.equal(again.weak, out.weak)


def test_refine_iter_improves_or_holds(port_sweep):
    """A geometric pass with every source's ground-truth depths (an ideal
    exchange) after the first sweep."""
    sc, inputs, _, _, _, out = port_sweep
    err0 = _rel_err(out, sc.gt_depths[0])
    inputs.src_depths = np.stack([sc.gt_depths[i] for i in range(VIEWS)])
    inputs.prior_depth = out.plane[..., 3].numpy()
    inputs.prior_normal = out.plane[..., :3].numpy()
    inputs.prior_selected_views = out.selected.numpy()
    params_b = tcfg.schedule_params(tcfg.PatchMatchParams(), 0, 0)
    assert params_b.state == RunState.REFINE_ITER
    data_b = tst.build_sweep_data(inputs, VIEWS - 1, device="cpu")
    st_b = tst.init_pm_state(inputs, VIEWS - 1, TorchKey(7), False, "cpu")
    out_b = run_sweep(data_b, st_b, params_b)
    err1 = _rel_err(out_b, sc.gt_depths[0])
    assert np.median(err1) <= np.median(err0) * 2.0
    assert np.median(err1) < 0.01
