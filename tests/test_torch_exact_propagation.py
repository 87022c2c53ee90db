"""The exact engine's pass-B propagation of the PyTorch port against the
JAX package: one strong color with edges and one weak color with the
geometric term, on the 48x36x3 weak-patch scene of
``torch_parity.weak_scene`` (support maps, the exact init's state and the
iteration's fit planes from JAX), drawing the same random numbers
(``torch_parity.JaxKey``); and the exact disparity sweep, classify and
refine stages with the geometric term.

Past the candidate argmins parity is statistical, and on this scene (priors
near the ground truth, a texture-less patch) near-ties are common: JAX's
compiled and op-by-op runs of the same color agree on only 94-95% of the
planes. So each color is held two ways:
  * the port as it runs, against compiled JAX: planes to 1e-4 on >= 90% of
    the sites and, where they agree, costs to 1e-4 on >= 85% (the weak
    patch has no texture, so its NCC variances cancel: compiled and op-by-op
    JAX costs agree to 1e-4 on 94% of its sites);
  * the port with XLA:CPU's ``exp``, ``sqrt`` and summation order
    substituted (``torch_parity.xla_cpu_float``), against JAX run op by op:
    planes on >= 99.5% of the sites, costs on >= 99.9% where they agree
    (measured: 99.9% and 100% strong, 100% and 100% weak). What is left
    between the port and JAX is the float library, not the port's
    arithmetic or its random draws.
"""
import numpy as np
import pytest

import torch_parity
from test_torch_engine import agree, check_disparity_classify_refine
from dpe_mvs_tpu_torch.engine import patchmatch as tpm
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.ops import weak as tweak

import jax
from dpe_mvs_tpu.engine import patchmatch as jpm
from dpe_mvs_tpu.engine import sweep as jsweep
from dpe_mvs_tpu.ops import checker as jchecker
from dpe_mvs_tpu.ops import weak as jweak


def _tstate(st):
    return tst.pm_state_from_numpy(torch_parity.to_numpy(st), None, "cpu")


def _tsup(sup):
    return tst.support_from_numpy(torch_parity.to_numpy(sup), "cpu")


def exact_pass(folder, geom):
    """JAX-side inputs of one exact-engine iteration on
    ``torch_parity.weak_scene``: the support maps, the state after the exact
    init and the iteration's fit planes, with the port's copies of the data
    and params. ``geom`` selects pass B, else round-1 pass A
    (REFINE_INIT)."""
    ws = torch_parity.weak_scene(folder, geom=geom)
    data = ws.data._replace(rect=None)
    sup, st = jax.jit(lambda d, s, k: jsweep.build_support(
        d, s, ws.params, k))(data, ws.st0, jax.random.key(5))
    st1 = jax.jit(jpm.initialize, static_argnames="params")(
        data, st, params=ws.params)
    fit = jax.jit(lambda d, sp, s, k: jweak.fit_plane_ransac(
        k, d, sp, s, ws.params))(data, sup, st1, jax.random.key(8))
    return dict(ws=ws, data=data, sup=sup, st1=st1,
                sup_it=sup._replace(**fit),
                tparams=torch_parity.port_params(ws.params),
                tdata=tst.sweep_data_from_numpy(torch_parity.to_numpy(data),
                                                "cpu"))


@pytest.fixture(scope="module")
def pass_b(tmp_path_factory):
    return exact_pass(tmp_path_factory.mktemp("torch_exact_b"), geom=True)


def hold(c, jax_fn, port_fn, xla_float, monkeypatch, sites, color,
         moved_bar=0.05):
    key = jax.random.key(21)
    if xla_float:
        with jax.disable_jit():
            ref = torch_parity.to_numpy(jax_fn(key))
        torch_parity.xla_cpu_float(monkeypatch)
        bars = (0.995, 0.999)
    else:
        ref = torch_parity.to_numpy(jax.jit(jax_fn)(key))
        bars = (0.90, 0.85)
    ours = port_fn(torch_parity.JaxKey(key))
    planes, costs = agree(ours, ref, sites)
    assert planes >= bars[0], planes
    assert costs >= bars[1], costs
    moved = ~np.isclose(ref[0], np.asarray(jchecker.compact(
        c["st1"].plane, color)), rtol=1e-4, atol=1e-4).all(-1)[sites]
    if moved_bar is not None:
        assert moved.mean() > moved_bar          # the proposal did work
    return ours


@pytest.mark.parametrize("xla_float", [False, True])
def test_one_strong_color_with_edges(pass_b, xla_float, monkeypatch):
    c = pass_b
    params = c["ws"].params
    assert params.use_edge
    sites = np.ones(np.asarray(jchecker.compact(c["st1"].weak, 1)).shape,
                    bool)
    hold(c,
          lambda k: jpm.propagate_strong(k, c["data"], c["sup"], c["st1"],
                                         params, 0, 1),
          lambda k: tpm.propagate_strong(k, c["tdata"], _tsup(c["sup"]),
                                         _tstate(c["st1"]), c["tparams"], 0,
                                         1),
          xla_float, monkeypatch, sites, 1)


@pytest.mark.parametrize("xla_float", [False, True])
def test_one_weak_color(pass_b, xla_float, monkeypatch):
    c = pass_b
    params = c["ws"].params
    assert params.geom_consistency
    sites = np.asarray(jchecker.compact(c["st1"].weak == 0, 0))
    assert sites.sum() > 30
    hold(c,
          lambda k: jweak.propagate_weak(k, c["data"], c["sup_it"], c["st1"],
                                         params, 0, 0),
          lambda k: tweak.propagate_weak(k, c["tdata"], _tsup(c["sup_it"]),
                                         _tstate(c["st1"]), c["tparams"], 0,
                                         0),
          xla_float, monkeypatch, sites, 0)


def test_disparity_sweep_classify_refine_geom(pass_b):
    check_disparity_classify_refine(pass_b, pass_b["ws"].params, geom=True)
