"""Strong-pixel stages of the PyTorch port against the JAX package, drawing
the same random numbers (``torch_parity.JaxKey``) from identical state.

  * init (FIRST_INIT random planes + top-k costs and view selection):
    planes to 1e-5, costs to 1e-4 (see ``assert_costs_close``), ``selected``
    equal on >= 99.9% of pixels;
  * one strong iteration (both colors: candidates, view selection,
    refinement): parity is statistical past the candidate argmins. XLA and
    torch round the NCC window sums differently (costs differ by ~1e-5), and
    in a smooth region several neighbours' planes score within that of each
    other, so such near-ties can resolve to another candidate. Measured on
    this scene: planes agree to 1e-4 on 98.9% of pixels (99.3% with stride-2
    screening); at every pixel but 0.2% either the planes agree or the two
    winners' costs agree to 1e-4 (the disagreeing winners differ in cost by
    a median 9e-6). Held to >= 98% and >= 99.5%.
"""
import numpy as np
import pytest

import torch_parity
from dpe_mvs_tpu_torch.engine import stages as tstages
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.engine import strong_rect as tsr

import jax
import jax.numpy as jnp
from dpe_mvs_tpu.config import PatchMatchParams, schedule_params
from dpe_mvs_tpu.engine import patchmatch as pm
from dpe_mvs_tpu.engine import rectcost
from dpe_mvs_tpu.engine import stages
from dpe_mvs_tpu.engine import state as st_mod
from dpe_mvs_tpu.io import scene as scene_mod
from dpe_mvs_tpu.utils.synthetic import make_plane_scene


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    folder = tmp_path_factory.mktemp("torch_strong_scene")
    sc = make_plane_scene(folder, width=64, height=48, num_views=3, seed=0)
    inputs = scene_mod.load_problem_inputs(
        scene_mod.generate_sample_list(sc.folder)[0], 1, need_prior=False,
        need_weak=False, need_src_depths=False)
    v_pad = 2
    rh = rectcost.build_rect_host(inputs.cameras, inputs.width,
                                  inputs.height, v_pad)
    views = rectcost.build_rect_views(rh, inputs.images, None,
                                      cameras=inputs.cameras)
    data = st_mod.build_sweep_data(inputs, v_pad)._replace(rect=views)
    params = schedule_params(PatchMatchParams(), 0, None)
    st0 = st_mod.init_pm_state(inputs, v_pad, jax.random.key(3), False)
    st1 = stages._init_j(data, st0, params, rh.statics)
    tdata = torch_parity.port_inputs(data._replace(rect=None), views)
    return dict(data=data, rh=rh, params=params, st0=st0, st1=st1,
                tdata=tdata, statics=torch_parity.port_statics(rh.statics))


def _port_state(st_j, key):
    return tst.pm_state_from_numpy(torch_parity.to_numpy(st_j), key, "cpu")


def test_init_stage(setup):
    s = setup
    ts0 = _port_state(s["st0"], torch_parity.JaxKey(s["st0"].key))
    ts1 = tsr.initialize_rect(s["tdata"], ts0,
                              torch_parity.port_params(s["params"]),
                              s["statics"])
    ref = torch_parity.to_numpy(s["st1"])
    np.testing.assert_allclose(ts1.plane.numpy(), ref.plane, rtol=1e-5,
                               atol=1e-5)
    torch_parity.assert_costs_close(ts1.cost.numpy(), ref.cost)
    sel = ts1.selected.numpy().view(np.uint32)
    assert (sel == ref.selected).mean() >= 0.999
    # The key handed on is the JAX function's.
    np.testing.assert_array_equal(jax.random.key_data(ts1.key.key),
                                  jax.random.key_data(s["st1"].key))


@pytest.mark.parametrize("propagate_stride", [None, 2])
def test_one_strong_iteration(setup, propagate_stride):
    """Auto screening stride (1 at this frame size) and forced stride-2
    screening with the strided EvalCache (the 800x600 main path's mode)."""
    s = setup
    params = s["params"].replace(propagate_stride=propagate_stride)
    keys = jax.random.split(s["st1"].key, 32)
    key_it = jax.random.fold_in(keys[1], 0)
    sup = pm.Support(*([None] * len(pm.Support._fields)))
    ref = torch_parity.to_numpy(stages._strong_j(
        s["data"], sup, s["st1"], jnp.int32(0), key_it, params,
        s["rh"].statics))
    ts1 = _port_state(s["st1"], None)
    out = tstages._strong_iter(s["tdata"], ts1, 0,
                               torch_parity.JaxKey(key_it),
                               torch_parity.port_params(params),
                               s["statics"])
    close = np.isclose(out.plane.numpy(), ref.plane, rtol=1e-4,
                       atol=1e-4).all(-1)
    assert close.mean() >= 0.98, close.mean()
    tie = np.abs(out.cost.numpy() - ref.cost) <= 1e-4
    assert (close | tie).mean() >= 0.995, (close | tie).mean()
    # The iteration moved the planes (the comparison is not vacuous).
    moved = ~np.isclose(ref.plane, torch_parity.to_numpy(s["st1"]).plane,
                        rtol=1e-4, atol=1e-4).all(-1)
    assert moved.mean() > 0.2
    agree = (out.selected.numpy().view(np.uint32) == ref.selected)
    assert agree.mean() >= 0.95
