"""The disparity sweeps' memory bounds, forced on a small frame.

``patchmatch.SWEEP_CHUNK_BYTES`` bounds the rect disparity sweep
(``weak_rect.rect_disparity_sweep``: the probes in chunks, each chunk's rect
volume evaluated, masked, warped back and added to its rows of the
accumulator view by view) and ``depth_to_weak``'s per-pixel analysis (row
bands). Both are exact, so with the constant forced small:

  * (a) the chunked sweep equals the one-piece sweep bit for bit at strides
    1 and 2, with and without the geometric term (61 probes in 9 chunks, the
    last one ragged);
  * (b) ``depth_to_weak``'s labels (its sweep chunked and its analysis in 7
    row bands) and ``local_refine``'s depths equal the one-piece ones bit
    for bit, with and without the geometric term;
  * (c) the chunked sweep agrees with the JAX package's
    ``rect_disparity_sweep`` run op by op (``jax.disable_jit()``) within
    ``tests/test_torch_rectcost.py``'s tolerance for it
    (``torch_parity.assert_costs_close``: atol 1e-4 on 99.9% of the costs,
    2e-4 everywhere);
  * (d) the anchor search (``anchors.gen_neighbours``, whose (D, H, W) and
    (H, W, pool) fields are the next holder at 6048x4032) in row bands
    (``anchors.BAND_BYTES`` forced small: 5 bands, the last ragged) equals
    it in one piece bit for bit, through ``sweep.build_support`` on the
    48x36 weak-patch scene with round 3's 32 sector rays, for pass A and
    pass B (the normal-consistency branch); and the weak bundle warping its
    probe volumes back in chunks (``SWEEP_CHUNK_BYTES`` forced small)
    equals it in one piece bit for bit;
  * ``sampling.spans`` itself: balanced spans that cover every item once,
    within the bytes, one span where everything fits (and the disparity
    sweeps and the anchor search in one piece at 1600x1200);
  * ``utils.synthetic.write_coarse_priors`` (the probe's and ``chip_smoke.py``
    phase 12c's priors of a later round) reads back through
    ``io.scene.add_pass_inputs`` as the ground truth at half the frame.

The scene is ``tests/test_torch_fullres.py``'s (80x64, 3 source views with
their ground-truth depths rectified for the geometric term), built once per
module.
"""
import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch.engine import patchmatch as tpm
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.engine import strong_rect as tstrong
from dpe_mvs_tpu_torch.engine import sweep as tsweep
from dpe_mvs_tpu_torch.engine import weak_rect as twr
from dpe_mvs_tpu_torch.ops import anchors as tanchors
from dpe_mvs_tpu_torch.ops import sampling as tsampling
from dpe_mvs_tpu_torch.utils.profiling import BRANCHES
from dpe_mvs_tpu_torch.utils.rng import TorchKey

import jax
import jax.numpy as jnp
from dpe_mvs_tpu.config import PatchMatchParams, schedule_params
from dpe_mvs_tpu.engine import rectcost
from dpe_mvs_tpu.engine import state as st_mod
from dpe_mvs_tpu.engine import weak_rect
from dpe_mvs_tpu.io import scene as scene_mod
from dpe_mvs_tpu.utils.synthetic import make_plane_scene

V_PAD = 3
CLASSIFY = np.arange(-30, 31, dtype=np.float32)      # DepthToWeak's probes
REFINE = np.arange(-5, 6, dtype=np.float32)          # LocalRefine's


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    torch.set_num_threads(1)
    folder = tmp_path_factory.mktemp("torch_disparity_bands_scene")
    sc = make_plane_scene(folder, width=80, height=64, num_views=4, seed=5)
    problems = scene_mod.generate_sample_list(sc.folder)
    inputs = scene_mod.load_problem_inputs(
        problems[0], 1, need_prior=False, need_weak=False,
        need_src_depths=False)
    data = st_mod.build_sweep_data(inputs, V_PAD)
    rh = rectcost.build_rect_host(inputs.cameras, inputs.width,
                                  inputs.height, V_PAD)
    src_depths = np.stack([sc.gt_depths[i + 1] for i in range(V_PAD)])
    views = rectcost.build_rect_views(rh, inputs.images, src_depths,
                                      cameras=inputs.cameras)
    H, W = inputs.height, inputs.width
    rng = np.random.default_rng(11)
    depth = sc.gt_depths[0] * rng.uniform(0.97, 1.03, (H, W))
    plane = np.concatenate([sc.gt_normals[0], depth[..., None]],
                           axis=-1).astype(np.float32)   # (n_world, depth)
    st = st_mod.PMState(
        plane=jnp.asarray(plane), cost=jnp.zeros((H, W), jnp.float32),
        selected=jnp.asarray(rng.integers(1, 8, (H, W)).astype(np.uint32)),
        view_weight=jnp.asarray(rng.integers(0, 5, (H, W, 3))
                                .astype(np.int32)),
        weak=jnp.ones((H, W), jnp.uint8), key=jax.random.key(0))
    params = {g: schedule_params(PatchMatchParams(), 1, 0 if g else None)
              for g in (False, True)}
    return dict(sc=sc, inputs=inputs, data=data._replace(rect=views), rh=rh,
                tdata=torch_parity.port_inputs(data, views), st=st,
                tstate=tst.pm_state_from_numpy(torch_parity.to_numpy(st),
                                               None, "cpu"),
                params=params,
                tparams={g: torch_parity.port_params(p)
                         for g, p in params.items()},
                statics=torch_parity.port_statics(rh.statics))


def _probe_bytes(s, stride):
    """Bytes of one probe's float32 volume as the sweep counts them."""
    H, W = s["inputs"].height, s["inputs"].width
    rect_px = max(rv.ref_rect.numel() for rv in s["tdata"].rect) // stride ** 2
    return 4.0 * max(H * W, rect_px)


def _sweep(s, disps, stride, geom):
    return twr.rect_disparity_sweep(s["tdata"], s["tstate"],
                                    s["tparams"][geom], s["statics"], disps,
                                    stride=stride)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.uint8)


@pytest.mark.parametrize("stride,geom", [(1, False), (1, True), (2, False),
                                         (2, True)])
def test_chunked_sweep_equals_one_piece(scene, monkeypatch, stride, geom):
    """(a) 61 probes in chunks of 7 (the last of 5) equal one chunk."""
    monkeypatch.setattr(tpm, "SWEEP_CHUNK_BYTES", float("inf"))
    whole = _sweep(scene, CLASSIFY, stride, geom)
    monkeypatch.setattr(tpm, "SWEEP_CHUNK_BYTES",
                        7 * _probe_bytes(scene, stride))
    BRANCHES.clear()
    chunked = _sweep(scene, CLASSIFY, stride, geom)
    assert BRANCHES["disparity-sweep chunks"] == 9
    assert whole.shape == chunked.shape == (61, 64, 80)
    assert (whole < 1).float().mean() > 0.04           # good matches
    assert torch.equal(_bits(chunked), _bits(whole))


@pytest.mark.parametrize("geom", [False, True])
def test_banded_classify_and_refine_equal_one_piece(scene, monkeypatch,
                                                    geom):
    """(b) ``depth_to_weak`` with its sweep chunked and its analysis in 7
    row bands (the last ragged), and ``local_refine`` with its 11 probes in
    chunks, against both with the bound off."""
    s = scene
    args = (s["tdata"], s["tstate"], s["tparams"][geom], s["statics"])
    monkeypatch.setattr(tpm, "SWEEP_CHUNK_BYTES", float("inf"))
    BRANCHES.clear()
    weak = tpm.depth_to_weak(*args)
    depth = tpm.local_refine(*args)
    assert not BRANCHES
    # Rows of 10 (bands 10 x 6 + 4); the sweeps then take chunks of 9 and
    # 3 probes.
    monkeypatch.setattr(tpm, "SWEEP_CHUNK_BYTES", 10 * 4.0 * 61 * 80)
    weak_b = tpm.depth_to_weak(*args)
    assert BRANCHES["classify bands"] == 7
    assert BRANCHES["disparity-sweep chunks"] > 1
    BRANCHES.clear()
    monkeypatch.setattr(tpm, "SWEEP_CHUNK_BYTES",
                        3 * _probe_bytes(s, 1))
    depth_b = tpm.local_refine(*args)
    assert BRANCHES["disparity-sweep chunks"] == 4
    labels = set(np.unique(weak.numpy()).tolist())
    assert len(labels) == 3, labels                # weak, strong, unknown
    assert torch.equal(weak_b, weak)
    assert (depth != s["tstate"].plane[..., 3]).float().mean() > 0.01
    assert torch.equal(_bits(depth_b), _bits(depth))


@pytest.mark.parametrize("stride,geom", [(1, False), (2, True)])
def test_chunked_sweep_matches_jax(scene, monkeypatch, stride, geom):
    """(c) The chunked sweep against the JAX package's, op by op."""
    s = scene
    with jax.disable_jit():
        ref = np.asarray(weak_rect.rect_disparity_sweep(
            s["data"], s["st"], s["params"][geom], s["rh"].statics, REFINE,
            stride=stride))
    monkeypatch.setattr(tpm, "SWEEP_CHUNK_BYTES",
                        4 * _probe_bytes(s, stride))
    BRANCHES.clear()
    out = _sweep(s, REFINE, stride, geom).numpy()
    assert BRANCHES["disparity-sweep chunks"] == 3
    assert (ref < 1.0).mean() > 0.2
    torch_parity.assert_costs_close(out, ref)


@pytest.fixture(scope="module", params=[False, True],
                ids=["passA3", "passB3"])
def anchor_case(request, tmp_path_factory):
    ws = torch_parity.weak_scene(tmp_path_factory.mktemp("torch_bands_weak"),
                                 geom=request.param)
    params = torch_parity.port_params(ws.params).replace(rotate_time=4)
    return (torch_parity.port_inputs(ws.data, ws.views),
            tst.pm_state_from_numpy(torch_parity.to_numpy(ws.st0), None,
                                    "cpu"), params,
            torch_parity.port_statics(ws.rh.statics))


def test_banded_anchor_search_equals_one_piece(anchor_case, monkeypatch):
    """(d) ``gen_neighbours`` in 5 row bands of 8 rows (the last of 4)."""
    tdata, tstate, params, _statics = anchor_case
    assert params.use_APD and params.use_label and params.use_limit

    def support():
        sup, st = tsweep.build_support(tdata, tstate, params, TorchKey(5))
        return sup.neighbours, sup.complexity, st.weak

    monkeypatch.setattr(tanchors, "BAND_BYTES", float("inf"))
    whole = support()
    monkeypatch.setattr(tanchors, "BAND_BYTES", 8 * 64.0 * 32 * 48)
    assert len(tsampling.spans(36, 64.0 * 32 * 48,
                               tanchors.BAND_BYTES)) == 5
    banded = support()
    assert (whole[0][..., 0] >= 0).any(0).float().mean() > 0.05
    for a, b in zip(banded, whole):
        assert torch.equal(_bits(a), _bits(b))


def test_chunked_weak_bundle_equals_one_piece(anchor_case, monkeypatch):
    """(d) ``build_weak_bundle`` warping its 16-probe volumes back in 4
    chunks (streaming mode, so the packed rect-frame volumes too) against
    one piece."""
    tdata, tstate, params, statics = anchor_case
    monkeypatch.setattr(twr, "AP_STORE_MAX_PX", 0)
    sup, st = tsweep.build_support(tdata, tstate, params, TorchKey(5))
    st = tstrong.initialize_rect(tdata, st.replace(key=TorchKey(6)), params,
                                 statics)
    monkeypatch.setattr(tpm, "SWEEP_CHUNK_BYTES", float("inf"))
    whole = twr.build_weak_bundle(tdata, sup, st, params, statics)
    rect_px = tdata.rect[0].ref_rect.numel()
    monkeypatch.setattr(tpm, "SWEEP_CHUNK_BYTES",
                        4 * 4.0 * max(36 * 48, rect_px))
    chunked = twr.build_weak_bundle(tdata, sup, st, params, statics)
    assert (whole.vol_geom is not None) == params.geom_consistency
    assert whole.w_chans is not None
    for name in ("vol_center", "vol_geom", "d0", "w_chans"):
        a, b = getattr(chunked, name), getattr(whole, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(_bits(a), _bits(b)), name
    assert (whole.vol_center.float() < 1.0).float().mean() > 0.2


def test_spans(monkeypatch):
    """Covering, within the bound, equal but for a shorter last span; one
    span where all fits."""
    for n, item, cap in ((61, 4.0, 1e9), (61, 10.0, 70.0), (61, 10.0, 5.0),
                         (11, 3.0, 9.0), (4032, 1e6, 7e6), (1, 1e12, 1.0),
                         (61, 1e12, float("inf"))):
        sp = tsampling.spans(n, item, cap)
        assert sp[0][0] == 0 and sp[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(sp, sp[1:]))
        sizes = [b - a for a, b in sp]
        assert set(sizes[:-1]) <= {sizes[0]} and sizes[-1] <= sizes[0]
        assert max(sizes) == 1 or max(sizes) * item <= cap
        if n * item <= cap:
            assert sp == [(0, n)]
    # 1600x1200 (rect frames 1920x1920): classify's 61 probes, its analysis
    # and the anchor search of round 1 (16 rays) in one piece.
    assert tsampling.spans(61, 4.0 * 1920 * 1920,
                           tpm.SWEEP_CHUNK_BYTES) == [(0, 61)]
    assert tsampling.spans(1200, 4.0 * 61 * 1600,
                           tpm.SWEEP_CHUNK_BYTES) == [(0, 1200)]
    assert tsampling.spans(1200, 64.0 * 16 * 1600,
                           tanchors.BAND_BYTES) == [(0, 1200)]


def test_coarse_priors_read_back(tmp_path):
    """The previous round's writeback that ``write_coarse_priors`` makes,
    read back at the frame by the round loop's own reader."""
    from dpe_mvs_tpu_torch.config import PixelState
    from dpe_mvs_tpu_torch.io import scene as tscene
    from dpe_mvs_tpu_torch.utils import synthetic
    sc = synthetic.make_plane_scene(width=24, height=16, num_views=3, seed=2)
    synthetic.write_coarse_priors(sc, 0, tmp_path)
    inp = tscene.add_pass_inputs(sc.problem_inputs(0), tmp_path, [],
                                 need_prior=True, need_weak=True,
                                 need_src_depths=False)
    r = (np.arange(16) // 2) * 2
    c = (np.arange(24) // 2) * 2
    np.testing.assert_array_equal(inp.prior_depth,
                                  sc.gt_depths[0][np.ix_(r, c)])
    np.testing.assert_array_equal(inp.prior_normal,
                                  sc.gt_normals[0][np.ix_(r, c)])
    assert (inp.prior_selected_views == 3).all()
    assert (inp.weak_info == int(PixelState.STRONG)).all()
