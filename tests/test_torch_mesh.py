"""The pieces of the PyTorch port's view-parallel path against the JAX
package, on the CPU:

  * ``build_src_index`` and ``pad_problem_count`` equal JAX's;
  * ``parallel_schedule.reinit_state`` equals JAX ``_reinit_exec``, bit for
    bit, on random states with NaN, infinite and out-of-range depths, with
    and without the weak machinery;
  * ``exchange_depths`` in 2- and 4-rank gloo groups (ranks started by
    ``tests/torch_dist_driver.py``) equals JAX ``exchange_depths`` on a
    2- and 4-device mesh bit for bit, for pair graphs that take the
    all-gather and graphs that take the pruned ring (``+1``; ``+1, +2,
    -1`` as ``tests/test_parallel.py::test_exchange_depths_pruned_ring``),
    padding slots and padding problems all zeros;
  * the bootstrap through ``DPE_MVS_COORDINATOR`` / ``DPE_MVS_NUM_PROCS`` /
    ``DPE_MVS_PROC_ID`` (every rank prints ``MULTIHOST OK p<rank>``, the
    counterpart of ``tests/test_multihost.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_driver as drv
import torch_parity  # noqa: F401  (one torch thread per worker)
from dpe_mvs_tpu.engine.state import PMState as JPMState
from dpe_mvs_tpu.parallel import mesh as jmesh
from dpe_mvs_tpu.pipeline import parallel_schedule as jps
from dpe_mvs_tpu_torch.engine.state import PMState
from dpe_mvs_tpu_torch.parallel import mesh
from dpe_mvs_tpu_torch.pipeline import parallel_schedule as ps

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The exchange cases run by a 2-rank and a 4-rank gloo group (started
    together): {world: (outputs, result folder)}."""
    out = tmp_path_factory.mktemp("torch_mesh")
    procs = {w: drv.start_group(w, out, {"exchange": None}) for w in WORLDS}
    return {w: (drv.wait_group(p, 240), out) for w, p in procs.items()}


def test_build_src_index_and_padding_equal_jax():
    ids = [10, 20, 30, 40]
    srcs = [[20, 30, 99], [10], [99], [40, 10, 20, 30, 10]]
    for v_pad in (1, 2, 4):
        np.testing.assert_array_equal(
            mesh.build_src_index(ids, srcs, v_pad),
            jmesh.build_src_index(ids, srcs, v_pad))
    for n in range(0, 11):
        for d in (1, 2, 3, 4, 8):
            assert mesh.pad_problem_count(n, d) == \
                jmesh.pad_problem_count(n, d)


def test_local_blocks_cover_the_problems():
    for n in (1, 3, 4, 7, 8):
        for world in (1, 2, 3, 4):
            blocks = [mesh.local_block(n, mesh.ViewGroup(r, world, "cpu"))
                      for r in range(world)]
            assert [i for b in blocks for i in b] == list(range(n))
            b_loc = mesh.pad_problem_count(n, world) // world
            assert all(b.start == min(r * b_loc, n)
                       for r, b in enumerate(blocks))


@pytest.mark.parametrize("use_weak", [False, True])
def test_reinit_state_equals_jax(use_weak):
    rng = np.random.default_rng(3 + use_weak)
    B, H, W, V = 3, 7, 9, 4
    plane = rng.standard_normal((B, H, W, 4)).astype(np.float32)
    depth = rng.uniform(0.0, 12.0, (B, H, W)).astype(np.float32)
    for bad, frac in ((np.nan, 0.05), (np.inf, 0.03), (-np.inf, 0.03),
                      (-1.0, 0.03)):
        depth[rng.random(depth.shape) < frac] = bad
    plane[..., 3] = depth
    cost = rng.random((B, H, W)).astype(np.float32)
    sel = rng.integers(0, 2**32, (B, H, W), np.uint64).astype(np.uint32)
    vw = rng.integers(0, 9, (B, H, W, V), np.int32)
    weak = rng.integers(0, 3, (B, H, W), np.uint8)
    dmin = np.array([1.0, 2.5, 0.5], np.float32)
    dmax = np.array([10.0, 8.0, 11.5], np.float32)
    keys = np.zeros((B, 2), np.uint32)
    ref = jps._reinit_exec(use_weak)(
        JPMState(plane=jnp.asarray(plane), cost=jnp.asarray(cost),
                 selected=jnp.asarray(sel), view_weight=jnp.asarray(vw),
                 weak=jnp.asarray(weak), key=jnp.asarray(keys)),
        jnp.asarray(dmin), jnp.asarray(dmax), jnp.asarray(keys))
    for b in range(B):
        st = PMState(plane=torch.from_numpy(plane[b]),
                     cost=torch.from_numpy(cost[b]),
                     selected=torch.from_numpy(sel[b].view(np.int32)),
                     view_weight=torch.from_numpy(vw[b]),
                     weak=torch.from_numpy(weak[b]), key=None)
        out = ps.reinit_state(st, torch.tensor(dmin[b]),
                              torch.tensor(dmax[b]), "key", use_weak)
        assert out.key == "key"
        for name in ("plane", "cost", "view_weight", "weak"):
            got = getattr(out, name).numpy()
            want = np.asarray(getattr(ref, name))[b]
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.view(np.uint8), err_msg=name)
        np.testing.assert_array_equal(out.selected.numpy().view(np.uint32),
                                      np.asarray(ref.selected)[b])
    # The reset did happen: some depths were zeroed, their pixels UNKNOWN.
    assert (np.asarray(ref.plane)[..., 3] == 0).sum() > 0.1 * B * H * W


def test_exchange_plans_take_both_branches():
    plans = {(w, g, n): mesh.exchange_plan(drv.exchange_inputs(g, n, w)[1],
                                           w)
             for w in WORLDS for g, n in drv.EXCHANGES}
    assert plans[(4, "ring", 8)] == [0, 1, 3]
    assert plans[(4, "next", 4)] == [1]
    assert plans[(4, "far", 8)] is None
    assert all(plans[(2, g, n)] is None for g, n in drv.EXCHANGES)


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_depths_equals_jax(groups, world):
    _, out = groups[world]
    devices = jax.devices()
    if len(devices) < world:
        pytest.skip(f"needs {world} virtual devices")
    jm = jmesh.make_mesh(devices[:world])
    for graph, n in drv.EXCHANGES:
        depth, idx = drv.exchange_inputs(graph, n, world)
        got = np.concatenate([
            np.load(out / f"exchange_w{world}_r{r}.npz")[f"{graph}_{n}"]
            for r in range(world)])
        want = np.asarray(jmesh.exchange_depths(
            jm, jmesh.shard_put(jm, jnp.asarray(depth)), idx))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32),
                                      err_msg=f"{graph} {n} w{world}")
        # Padding slots and padding problems' rows are zeros.
        assert (got[idx < 0] == 0).all()
        for b in range(n):
            for v, src in enumerate(drv.GRAPHS[graph](b, n)[:idx.shape[1]]):
                np.testing.assert_array_equal(got[b, v], depth[src])


@pytest.mark.parametrize("world", WORLDS)
def test_env_bootstrap_every_rank(groups, world):
    outs, _ = groups[world]
    assert len(outs) == world
    for rank, text in enumerate(outs):
        assert f"MULTIHOST OK p{rank}" in text


def test_no_bootstrap_without_coordinator(monkeypatch):
    monkeypatch.delenv("DPE_MVS_COORDINATOR", raising=False)
    assert not torch.distributed.is_initialized()
    assert mesh.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    g = mesh.make_group("cpu")
    assert (g.rank, g.world, g.group) == (0, 1, None)
    # A single process's collectives are local.
    t = torch.arange(6.0).reshape(2, 3)
    assert mesh.all_gather(g, t)[0] is not None
    assert mesh.agree_min(g, 5) == 5
