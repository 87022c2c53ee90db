"""The exact engine's round-1 pass A (``RunState.REFINE_INIT``) of the
PyTorch port against the JAX package: one strong color with edges and one
weak color, on ``torch_parity.weak_scene(geom=False)``, with the bars of
``test_torch_exact_propagation.py`` (compiled JAX: planes on >= 90% of the
sites, costs on >= 85% where they agree; with XLA:CPU's float functions
substituted, against JAX run op by op: >= 99.5% and >= 99.9%).

REFINE_INIT is where each color keeps its upsampled prior unless the new
plane's cost is lower by 0.1 (the hysteresis at the end of
``propagate_strong`` and of ``propagate_weak``). On this scene, whose
priors are near the ground truth, it keeps nearly every plane: JAX moves
1.4% of the strong sites and none of the weak ones. So in place of the
other file's check that the proposal moved planes, each test checks that
the hysteresis held most of the sites that the same proposal under
REFINE_ITER moves (measured: 86% strong, 93% weak).
"""
import numpy as np
import pytest

import torch_parity
from test_torch_exact_propagation import _tstate, _tsup, exact_pass, hold
from dpe_mvs_tpu_torch.config import RunState
from dpe_mvs_tpu_torch.engine import patchmatch as tpm
from dpe_mvs_tpu_torch.ops import weak as tweak

import jax
from dpe_mvs_tpu.engine import patchmatch as jpm
from dpe_mvs_tpu.ops import checker as jchecker
from dpe_mvs_tpu.ops import weak as jweak


@pytest.fixture(scope="module")
def pass_r1(tmp_path_factory):
    c = exact_pass(tmp_path_factory.mktemp("torch_exact_r1"), geom=False)
    assert c["ws"].params.state == RunState.REFINE_INIT
    assert c["ws"].params.use_edge and c["ws"].params.use_APD
    return c


def _held_by_hysteresis(c, port_fn, ours, sites, color):
    """The share of sites kept at the prior under REFINE_INIT that the same
    proposal moves under REFINE_ITER."""
    prior = c["tparams"]
    it = port_fn(torch_parity.JaxKey(jax.random.key(21)),
                 prior.replace(state=RunState.REFINE_ITER))
    before = np.asarray(jchecker.compact(c["st1"].plane, color))

    def kept(out):
        return np.isclose(out[0].numpy(), before, rtol=1e-4,
                          atol=1e-4).all(-1)[sites]
    return (kept(ours) & ~kept(it)).mean()


@pytest.mark.parametrize("xla_float", [False, True])
def test_refine_init_strong_color(pass_r1, xla_float, monkeypatch):
    c = pass_r1
    params = c["ws"].params
    sites = np.ones(np.asarray(jchecker.compact(c["st1"].weak, 1)).shape,
                    bool)

    def port_fn(k, p=c["tparams"]):
        return tpm.propagate_strong(k, c["tdata"], _tsup(c["sup"]),
                                    _tstate(c["st1"]), p, 0, 1)
    ours = hold(c,
                lambda k: jpm.propagate_strong(k, c["data"], c["sup"],
                                               c["st1"], params, 0, 1),
                port_fn, xla_float, monkeypatch, sites, 1, moved_bar=None)
    held = _held_by_hysteresis(c, port_fn, ours, sites, 1)
    assert held > 0.5, held


@pytest.mark.parametrize("xla_float", [False, True])
def test_refine_init_weak_color(pass_r1, xla_float, monkeypatch):
    c = pass_r1
    params = c["ws"].params
    sites = np.asarray(jchecker.compact(c["st1"].weak == 0, 0))
    assert sites.sum() > 30

    def port_fn(k, p=c["tparams"]):
        return tweak.propagate_weak(k, c["tdata"], _tsup(c["sup_it"]),
                                    _tstate(c["st1"]), p, 0, 0)
    ours = hold(c,
                lambda k: jweak.propagate_weak(k, c["data"], c["sup_it"],
                                               c["st1"], params, 0, 0),
                port_fn, xla_float, monkeypatch, sites, 0, moved_bar=None)
    held = _held_by_hysteresis(c, port_fn, ours, sites, 0)
    assert held > 0.5, held
