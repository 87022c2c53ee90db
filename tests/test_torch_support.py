"""Support maps, anchor search and checkerboard compaction of the PyTorch
port against the JAX package, drawing the same random numbers
(``torch_parity.JaxKey``, ``randint`` included).

  * the pointer-doubling maps (edge steps, label runs, line of sight, jump
    flooding) and the box density: exact; the complexity map (a sigmoid,
    which XLA and PyTorch round differently) to 1.2e-7;
  * ``build_support`` / ``gen_neighbours`` on the 48x36x3 weak-patch scene,
    for round-1 pass A and for pass B (the normal-consistency branch): the
    maps, the nearest-strong field and the new weak map exact; the anchors
    exact as a set at every pixel. Their slot order follows the residual
    ranking against the RANSAC plane, in which the three points that define
    the plane have residuals at float-rounding level, so near-ties can rank
    in another order (XLA contracts the plane's cross products into fused
    multiply-adds, PyTorch does not); the order is held to >= 95% of the
    pixels;
  * ``checker.compact`` / ``scatter`` and ``sweep.apply_compacted``: exact.
"""
import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.engine import sweep as tsweep
from dpe_mvs_tpu_torch.ops import checker as tchecker
from dpe_mvs_tpu_torch.ops import support as tsup
from dpe_mvs_tpu_torch.utils.rng import TorchKey

import jax
import jax.numpy as jnp
from dpe_mvs_tpu.engine import sweep as jsweep
from dpe_mvs_tpu.ops import checker, support


def _masks(seed, H=29, W=37):
    rng = np.random.default_rng(seed)
    edge = rng.uniform(size=(H, W)) < 0.15
    label = rng.integers(0, 4, (H // 4 + 1, W // 4 + 1)).repeat(4, 0) \
        .repeat(4, 1)[:H, :W].astype(np.int32)
    return edge, label


@pytest.mark.parametrize("seed", [0, 1])
def test_support_maps_exact(seed):
    edge, label = _masks(seed)
    H, W = edge.shape
    te, tl = torch.from_numpy(edge), torch.from_numpy(label)
    je, jl = jnp.asarray(edge), jnp.asarray(label)
    vecs = np.array([[2, 1], [-1, 3], [0, -1]], np.int32)
    pairs = [
        (tsup.ray_first_hit_multi(te, vecs, 64),
         support.ray_first_hit_multi(je, vecs, 64)),
        (tsup.edge_steps(te, 64), support.edge_steps(je, 64)),
        (tsup.label_run_length(tl, 64), support.label_run_length(jl, 64)),
        (tsup.box_density(te, 5), support.box_density(je, 5)),
    ]
    for ours, ref in pairs:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # The logistic of XLA and torch.sigmoid round differently: one float32
    # rounding of values in (0, 1).
    np.testing.assert_allclose(
        tsup.complexity_map(te, tl, 5, True).numpy(),
        np.asarray(support.complexity_map(je, jl, 5, True)), rtol=0,
        atol=1.2e-7)
    for ours, ref in zip(tsup.jfa_nearest(te, 6.0),
                         support.jfa_nearest(je, 6.0)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))

    low = edge[::2, ::2]
    los_t = tsup.build_line_of_sight(torch.from_numpy(low), W, H, True)
    los_j = support.build_line_of_sight(jnp.asarray(low), W, H, True)
    np.testing.assert_array_equal(los_t.free_dist.numpy(),
                                  np.asarray(los_j.free_dist))
    assert los_t.max_len == float(los_j.max_len)
    rng = np.random.default_rng(seed + 10)
    pts = rng.uniform(-2, max(H, W) + 2, (4, 6, 9)).astype(np.float32)
    ours = los_t.crossing(*(torch.from_numpy(p) for p in pts), te)
    ref = los_j.crossing(*(jnp.asarray(p) for p in pts), je)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.fixture(scope="module", params=[False, True], ids=["passA1", "passB"])
def support_case(request, tmp_path_factory):
    ws = torch_parity.weak_scene(tmp_path_factory.mktemp("torch_support"),
                                 geom=request.param)
    key = jax.random.key(5)
    sup, st = jax.jit(lambda d, s, k: jsweep.build_support(
        d, s, ws.params, k))(ws.data, ws.st0, key)
    return ws, key, torch_parity.to_numpy(sup), torch_parity.to_numpy(st)


def test_build_support_matches_jax(support_case):
    ws, key, sup, st = support_case
    tdata = torch_parity.port_inputs(ws.data, ws.views)
    tstate = tst.pm_state_from_numpy(torch_parity.to_numpy(ws.st0), None,
                                     "cpu")
    tsupp, tstate2 = tsweep.build_support(
        tdata, tstate, torch_parity.port_params(ws.params),
        torch_parity.JaxKey(key))
    for name in ("edge_steps", "complexity", "label_runs", "nearest_strong"):
        np.testing.assert_array_equal(getattr(tsupp, name).numpy(),
                                      np.asarray(getattr(sup, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tsupp.los.free_dist.numpy(),
                                  sup.los.free_dist)
    np.testing.assert_array_equal(tstate2.weak.numpy(), st.weak)
    ours, ref = tsupp.neighbours.numpy(), np.asarray(sup.neighbours)
    assert ours.shape == ref.shape == (8, 36, 48, 2)
    valid = ref[..., 0] >= 0
    assert valid.any(0).mean() > 0.05          # the search found anchors
    assert (ws.maps[2] > 0).mean() > 0.01     # label regions exist

    def as_set(a):
        k = a[..., 0].astype(np.int64) * 100000 + a[..., 1]
        return np.sort(k, axis=0)
    np.testing.assert_array_equal(as_set(ours), as_set(ref))
    same_order = (ours == ref).all(-1).all(0)
    assert same_order.mean() >= 0.95, same_order.mean()


def test_randint_key_protocol():
    k = jax.random.key(3)
    ours = torch_parity.JaxKey(k).randint((5, 7), 0, 8)
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jax.random.randint(k, (5, 7), 0, 8)))
    a = TorchKey(11).randint((64, 64), -3, 5)
    b = TorchKey(11).randint((64, 64), -3, 5)
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert int(a.min()) == -3 and int(a.max()) == 4
    assert not torch.equal(a, TorchKey(11).fold_in(1).randint((64, 64), -3,
                                                              5))


@pytest.mark.parametrize("W", [10, 11])
@pytest.mark.parametrize("color", [0, 1])
def test_checker_and_apply_compacted(W, color):
    from dpe_mvs_tpu.engine import state as st_mod
    rng = np.random.default_rng(W * 2 + color)
    H, V = 7, 3
    full = rng.standard_normal((H, W, 4)).astype(np.float32)
    comp = np.asarray(checker.compact(jnp.asarray(full), color))
    np.testing.assert_array_equal(
        tchecker.compact(torch.from_numpy(full), color).numpy(), comp)
    new = rng.standard_normal(comp.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tchecker.scatter(torch.from_numpy(full), torch.from_numpy(new),
                         color).numpy(),
        np.asarray(checker.scatter(jnp.asarray(full), jnp.asarray(new),
                                   color)))

    st = st_mod.PMState(
        plane=jnp.asarray(full), cost=jnp.asarray(full[..., 0]),
        selected=jnp.asarray(rng.integers(0, 8, (H, W)).astype(np.uint32)),
        view_weight=jnp.asarray(rng.integers(0, 5, (H, W, V), np.int32)),
        weak=jnp.asarray(rng.integers(0, 3, (H, W)).astype(np.uint8)),
        key=jax.random.key(0))
    W2 = comp.shape[1]
    out = (new, rng.standard_normal((H, W2)).astype(np.float32),
           rng.integers(0, 8, (H, W2)).astype(np.uint32),
           rng.integers(0, 5, (V, H, W2)).astype(np.int32))
    mask = np.asarray(st.weak) == 0
    ref = torch_parity.to_numpy(jsweep.apply_compacted(
        st, jnp.asarray(mask), color, *(jnp.asarray(o) for o in out)))
    tstate = tst.pm_state_from_numpy(torch_parity.to_numpy(st), None, "cpu")
    tout = [torch.from_numpy(o) for o in out]
    tout[2] = torch.from_numpy(out[2].view(np.int32))
    res = tsweep.apply_compacted(tstate, torch.from_numpy(mask), color, *tout)
    for name in ("plane", "cost", "view_weight"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      getattr(ref, name))
    np.testing.assert_array_equal(res.selected.numpy().view(np.uint32),
                                  ref.selected)
