"""Tile sharding with halo refresh and the mesh fusion of the PyTorch port,
on the CPU, ranks in gloo groups started by ``tests/torch_dist_driver.py``:

  * ``build_tile_inputs`` and ``_crop_rows`` equal the JAX package's;
  * the halo refresh over 4 ranks equals JAX ``_halo_refresh`` under
    ``shard_map`` on 4 devices, bit for bit, on random state fields (NaNs
    and signed zeros among them);
  * ``tile_sharded_sweep`` (FIRST_INIT, 96x80x3, halo 16, 2 iterations)
    over 4 ranks meets ``tests/test_tiles.py``'s ground-truth and seam bars
    beside the unsharded sweep (4 bands, as that test has), and over 2
    ranks its ground-truth bars, its one seam held to the unsharded sweep's
    error on the same rows: that seam is row 40, where the unsharded sweep
    itself errs by a median 0.022 (the JAX package's 2-band sweep too), so
    the absolute seam bar of 0.015 is no bar for 2 bands; ``use_APD`` is
    rejected;
  * ``run_fusion_mesh`` over 2 ranks, on the maps of a 48x36x6 one-round
    parallel pipeline: voting to the fixpoint of its mask replay (the
    default) it writes the port's ``run_fusion`` cloud byte for byte, so
    within the 1% of ``tests/test_parallel.py::
    test_mesh_fusion_point_count_parity``; stopped after the JAX package's
    two passes (``max_passes=2``) its point count is within 0.1% of JAX
    ``run_fusion_mesh`` on the same ``.dmb`` maps.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_driver as drv
import torch_parity  # noqa: F401  (one torch thread per worker)
from dpe_mvs_tpu.engine.state import PMState as JPMState
from dpe_mvs_tpu.io import scene as jscene
from dpe_mvs_tpu.parallel import tiles as jtiles
from dpe_mvs_tpu_torch.config import PatchMatchParams, schedule_params
from dpe_mvs_tpu_torch.engine import rectcost
from dpe_mvs_tpu_torch.engine import state as st_mod
from dpe_mvs_tpu_torch.engine.stages import run_sweep_staged
from dpe_mvs_tpu_torch.io import formats as tformats
from dpe_mvs_tpu_torch.io import scene as tscene
from dpe_mvs_tpu_torch.parallel import mesh, tiles
from dpe_mvs_tpu_torch.pipeline import fusion as tfusion
from dpe_mvs_tpu_torch.utils import synthetic as tsynth
from dpe_mvs_tpu_torch.utils.rng import TorchKey

TILE = dict(w=96, h=80, views=3, seed=5, halo=16, iters=2)
HALO_RANKS = 4


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Started together: the halo refresh and the tile sweep on 4 ranks,
    the tile sweep on 2, and the 48x36x6 one-round pipeline on 6 (one
    problem each, state kept), then its maps fused by ``run_fusion_mesh``
    on 2 ranks, in two copies: to the fixpoint, and after two passes.
    Returns the result folder, the fusion scene's folder (fused to the
    fixpoint), the two-pass copy and the state before the mesh fusion."""
    out = tmp_path_factory.mktemp("torch_tiles")
    sc = tsynth.make_plane_scene(width=48, height=36, num_views=6, seed=11)
    folder = tsynth.write_scene_folder(sc, out / "fusion")
    first = [drv.start_group(HALO_RANKS, out, {"halo": None,
                                               "tiles": TILE}),
             drv.start_group(2, out, {"tiles": TILE}),
             drv.start_group(6, out, {"pipeline": dict(
                 folder=str(folder), keep=True,
                 cfg={"min_rounds": 1, "coarse_target": 48})})]
    for procs in first[::-1]:
        drv.wait_group(procs, 900)
    state = shutil.copytree(folder, out / "state")
    two = shutil.copytree(folder, out / "two_passes")
    drv.wait_group(drv.start_group(2, out, {"fusion": [
        [str(folder), None], [str(two), 2]]}), 600)
    return out, folder, two, state


def _port_inputs():
    return tsynth.make_plane_scene(width=TILE["w"], height=TILE["h"],
                                   num_views=TILE["views"],
                                   seed=TILE["seed"]).problem_inputs(0)


def _jax_inputs(inputs):
    return jscene.ProblemInputs(
        images=inputs.images, depth_min=inputs.depth_min,
        depth_max=inputs.depth_max, width=inputs.width,
        height=inputs.height,
        cameras=[jscene.CameraData(K=c.K, R=c.R, t=c.t,
                                   depth_min=c.depth_min,
                                   depth_max=c.depth_max, width=c.width,
                                   height=c.height)
                 for c in inputs.cameras],
        src_depths=np.random.default_rng(0).random(
            inputs.images.shape).astype(np.float32))


def test_tile_inputs_equal_jax():
    inputs = _port_inputs()
    inputs.src_depths = _jax_inputs(inputs).src_depths
    arr = np.arange(2 * 9 * 4).reshape(2, 9, 4)
    for o, rows in ((-3, 6), (2, 5), (6, 7)):
        np.testing.assert_array_equal(tiles._crop_rows(arr, o, rows),
                                      jtiles._crop_rows(arr, o, rows))
    for n_tiles, halo in ((1, 16), (2, 16), (3, 5), (4, 64)):
        got, hb = tiles.build_tile_inputs(inputs, n_tiles, halo)
        want, jhb = jtiles.build_tile_inputs(_jax_inputs(inputs), n_tiles,
                                             halo)
        assert hb == jhb and len(got) == len(want) == n_tiles
        for g, w in zip(got, want):
            assert (g.width, g.height) == (w.width, w.height)
            assert (g.depth_min, g.depth_max) == (w.depth_min, w.depth_max)
            np.testing.assert_array_equal(g.images, w.images)
            np.testing.assert_array_equal(g.src_depths, w.src_depths)
            for cg, cw in zip(g.cameras, w.cameras):
                np.testing.assert_array_equal(cg.K, cw.K)
                assert cg.height == cw.height


def test_halo_refresh_equals_jax(groups):
    out = groups[0]
    devices = jax.devices()
    if len(devices) < HALO_RANKS:
        pytest.skip(f"needs {HALO_RANKS} virtual devices")
    f = drv.halo_inputs(HALO_RANKS, **drv.HALO)
    hb, halo = drv.HALO["hb"], drv.HALO["halo"]
    st = JPMState(key=jnp.zeros((HALO_RANKS, 2), jnp.uint32),
                  **{k: jnp.asarray(v) for k, v in f.items()})
    from jax.sharding import PartitionSpec as P
    from dpe_mvs_tpu.parallel import mesh as jmesh
    jm = jmesh.make_mesh(devices[:HALO_RANKS], axis="tile")

    def body(s):
        s = jax.tree.map(lambda x: x[0], s)
        s = jtiles._halo_refresh(s, halo, hb, "tile", HALO_RANKS)
        return jax.tree.map(lambda x: x[None], s)
    ref = jax.jit(jax.shard_map(body, mesh=jm, in_specs=P("tile"),
                                out_specs=P("tile"), check_vma=False))(st)
    moved = 0
    for r in range(HALO_RANKS):
        got = np.load(out / f"halo_w{HALO_RANKS}_r{r}.npz")
        for k in f:
            want = np.asarray(getattr(ref, k))[r]
            g = got[k]
            if k == "selected":
                g = g.view(np.uint32)
            assert g.dtype == want.dtype and g.shape == want.shape, k
            np.testing.assert_array_equal(g.view(np.uint8),
                                          want.view(np.uint8),
                                          err_msg=f"{k} rank {r}")
            moved += int((g.view(np.uint8) != f[k][r].view(np.uint8)).any())
    assert moved > 0                          # the halos did change


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded FIRST_INIT sweep's relative depth error, and the
    ground truth."""
    w, h, views = TILE["w"], TILE["h"], TILE["views"]
    sc = tsynth.make_plane_scene(width=w, height=h, num_views=views,
                                 seed=TILE["seed"])
    inputs = sc.problem_inputs(0)
    v_pad = views - 1
    params = schedule_params(PatchMatchParams(), 0, None).replace(
        max_iterations=TILE["iters"], use_APD=False)
    rh = rectcost.build_rect_host(inputs.cameras, w, h, v_pad)
    data = st_mod.build_sweep_data(inputs, v_pad, device="cpu").replace(
        rect=rectcost.build_rect_views(rh, inputs.images, "cpu"))
    st = st_mod.init_pm_state(inputs, v_pad, TorchKey(0), False, "cpu")
    st = run_sweep_staged(data, st, params, rstat=rh.statics)
    gt = sc.gt_depths[0]
    return np.abs(st.plane[..., 3].numpy() - gt) / gt, gt


def _tile_run(out, world, gt):
    runs = [np.load(out / f"tiles_w{world}_r{r}.npz") for r in range(world)]
    for r in runs[1:]:                        # every rank stitched alike
        np.testing.assert_array_equal(r["depth"], runs[0]["depth"])
    d = runs[0]["depth"]
    assert d.shape == gt.shape
    return np.abs(d - gt) / gt, int(runs[0]["hb"])


@pytest.mark.parametrize("world", [4, 2])
def test_tile_sharded_sweep_meets_the_jax_bars(groups, unsharded, world):
    out = groups[0]
    rel_ref, gt = unsharded
    rel_tile, hb = _tile_run(out, world, gt)
    med_ref = float(np.median(rel_ref))
    med_tile = float(np.median(rel_tile))
    assert med_ref < 0.01
    assert med_tile < max(2.0 * med_ref, 0.01), (med_ref, med_tile)
    rows = np.concatenate([np.arange(t * hb - 2, t * hb + 2)
                           for t in range(1, world)])
    seam_med = float(np.median(rel_tile[rows]))
    if world == 4:
        assert seam_med < max(3.0 * med_tile, 0.015), (seam_med, med_tile)
    else:
        ref_rows = float(np.median(rel_ref[rows]))
        assert seam_med < max(1.5 * ref_rows, 0.015), (seam_med, ref_rows)


def test_tile_sharding_rejects_apd():
    params = schedule_params(PatchMatchParams(), 1, None)
    assert params.use_APD
    with pytest.raises(ValueError, match="APD"):
        tiles.tile_sharded_sweep(mesh.make_group("cpu"), None, None, params,
                                 None, 8)


def test_mesh_fusion_point_count_parity(groups, tmp_path):
    from dpe_mvs_tpu.io import formats as jformats
    from dpe_mvs_tpu.parallel import mesh as jmesh
    from dpe_mvs_tpu.pipeline import fusion as jfusion
    _, folder, two, state = groups
    ply = "DPE/DPE.ply"
    pts_mesh, cols = tformats.read_ply(folder / ply)
    assert cols.shape == pts_mesh.shape and np.isfinite(pts_mesh).all()

    seq = shutil.copytree(state, tmp_path / "seq")
    tfusion.run_fusion(seq, tscene.generate_sample_list(seq), device="cpu")
    pts_seq, _ = tformats.read_ply(seq / ply)
    assert pts_seq.shape[0] > 100
    assert (folder / ply).read_bytes() == (seq / ply).read_bytes()

    pts_two, _ = tformats.read_ply(two / ply)
    jx = shutil.copytree(state, tmp_path / "jax")
    jfusion.run_fusion_mesh(jx, jscene.generate_sample_list(jx),
                            jmesh.make_mesh(jax.devices()[:2]))
    pts_jax, _ = jformats.read_ply(jx / ply)
    rel = abs(pts_two.shape[0] - pts_jax.shape[0]) / pts_jax.shape[0]
    assert rel <= 0.001, (pts_jax.shape[0], pts_two.shape[0])
