"""Bilateral NCC and the geometric term of the PyTorch port against the
JAX package.

  * ``bilateral_ncc`` with and without ``ref_cache``, with and without the
    adaptive ``scale``, at a (H, W2) checkerboard site grid (36-sample
    strong window) and an (8, H, W2) anchor grid (9-sample weak window);
  * ``ncc_cost_vector`` over every view of a SweepData with a padded view,
    and a stack of candidate planes in one call;
  * ``geom_consistency_cost`` / ``geom_cost_vector`` with NaN and zero
    source depths.

Tolerances. Against JAX run op by op (``jax.disable_jit()``) the costs
agree to 1e-5 on >= 97% of the entries and to 1e-4 everywhere: XLA:CPU's
``exp`` is not libm's (an ulp apart on ~10% of the bilateral weights) and
it sums a window of more than 32 samples as two halves, torch in its own
order; the one-pass variances amplify those ulps (max 5e-5 measured on
this scene, 98% within 1e-5). Against compiled JAX, the stated ~1e-4 of
``torch_parity.assert_costs_close``. The geometric term has no reduction
and no ``exp``: it is bit-equal to op-by-op JAX. Padded views are exactly
COST_MAX / GEOM_COST_MAX. Then the six cases of ``tests/test_ncc.py`` run
on the port's side.
"""
import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch.engine import patchmatch as tpm
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.geometry import cameras as tgeo
from dpe_mvs_tpu_torch.ops import ncc as tncc
from dpe_mvs_tpu_torch.ops import sampling as tsampling

import jax
import jax.numpy as jnp
from dpe_mvs_tpu.config import PatchMatchParams
from dpe_mvs_tpu.engine import patchmatch as jpm
from dpe_mvs_tpu.engine import state as st_mod
from dpe_mvs_tpu.geometry import cameras as jgeo
from dpe_mvs_tpu.io import scene as scene_mod
from dpe_mvs_tpu.ops import checker as jchecker
from dpe_mvs_tpu.ops import ncc as jncc
from dpe_mvs_tpu.utils.synthetic import make_plane_scene

H, W = 36, 48


def _ncc(ref, src, *args, **kw):
    """``bilateral_ncc`` with the images' corner maps built here."""
    return tncc.bilateral_ncc(ref, src, *args,
                              ref_corners=tsampling.corner_map(ref),
                              src_corners=tsampling.corner_map(src), **kw)


def _ref_cache(ref, *args, **kw):
    """``make_ref_cache`` with the reference's corner map built here."""
    return tncc.make_ref_cache(ref, *args, corners=tsampling.corner_map(ref),
                               **kw)


def _close(got, want, atol=1e-5, frac=0.97, atol_max=2e-4):
    torch_parity.assert_costs_close(got, want, atol=atol, frac=frac,
                                    atol_max=atol_max)


@pytest.fixture(scope="module")
def pair():
    """A reference, a shifted source and a tilted plane field."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (H, W + 8)).astype(np.float32)
    ref, src = img[:, :W], img[:, 3:W + 3].copy()
    K = np.array([[45.0, 0, W / 2], [0, 45.0, H / 2], [0, 0, 1]], np.float32)
    n = rng.normal(size=(H, W, 3)).astype(np.float32) * 0.1 + \
        np.array([0, 0, -1], np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    plane = np.concatenate([n, rng.uniform(3, 4, (H, W, 1))], -1
                           ).astype(np.float32)
    t_rel = np.array([0.07, 0.01, 0.0], np.float32)
    return dict(ref=ref, src=src, K=K, plane=plane, t_rel=t_rel, rng=rng)


def _grid(p, grid):
    """(cx, cy, ref_center, plane at the sites) as numpy: the color-0 site
    grid, or 8 anchors per site."""
    cx, cy = (np.asarray(a) for a in jchecker.sites(H, W, 0))
    rc = np.asarray(jchecker.compact(jnp.asarray(p["ref"]), 0))
    pl = np.asarray(jchecker.compact(jnp.asarray(p["plane"]), 0))
    if grid == "anchors":
        r = np.random.default_rng(1)
        cx = np.clip(cx[None] + r.integers(-6, 7, (8,) + cx.shape), 0,
                     W - 1).astype(np.float32)
        cy = np.clip(cy[None] + r.integers(-6, 7, (8,) + cy.shape), 0,
                     H - 1).astype(np.float32)
    return cx, cy, rc, pl


@pytest.mark.parametrize("grid", ["sites", "anchors"])
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("xla_float", [False, True])
def test_bilateral_ncc(pair, grid, cached, scaled, xla_float, monkeypatch):
    p = pair
    cx, cy, rc, pl = _grid(p, grid)
    offs = jncc.window_offsets(5, 2 if grid == "sites" else 5)
    scale = (np.random.default_rng(2).uniform(1.0, 2.0, cx.shape)
             .astype(np.float32) if scaled else None)

    def jax_cost():
        cam = jgeo.Camera(K=jnp.asarray(p["K"]), R=jnp.eye(3),
                          t=jnp.zeros(3))
        a = [jnp.asarray(v) for v in (cx, cy, rc)]
        sc = None if scale is None else jnp.asarray(scale)
        hom = jncc.homography_field(cam, cam.K, jnp.eye(3),
                                    jnp.asarray(p["t_rel"]), jnp.asarray(pl),
                                    a[0], a[1])
        cache = jncc.make_ref_cache(jnp.asarray(p["ref"]), a[0], a[1], offs,
                                    5.0, 3.0, a[2], scale=sc) \
            if cached else None
        return jncc.bilateral_ncc(
            jnp.asarray(p["ref"]), jnp.asarray(p["src"]), hom, a[0], a[1],
            offs, 5.0, 3.0, a[2], scale=sc, ref_cache=cache)

    with jax.disable_jit():
        eager = np.asarray(jax_cost())
    compiled = np.asarray(jax.jit(jax_cost)())
    if xla_float:
        torch_parity.xla_cpu_float(monkeypatch)

    cam = tgeo.Camera(K=torch.tensor(p["K"]), R=torch.eye(3),
                      t=torch.zeros(3))
    a = [torch.from_numpy(np.ascontiguousarray(v)) for v in (cx, cy, rc)]
    sc = None if scale is None else torch.from_numpy(scale)
    hom = tncc.homography_field(cam, cam.K, torch.eye(3),
                                torch.from_numpy(p["t_rel"]),
                                torch.from_numpy(pl), a[0], a[1])
    ref = torch.from_numpy(np.ascontiguousarray(p["ref"]))
    cache = _ref_cache(ref, a[0], a[1], offs, 5.0, 3.0, a[2],
                       scale=sc) if cached else None
    ours = _ncc(ref, torch.from_numpy(p["src"]), hom, a[0],
                a[1], offs, 5.0, 3.0, a[2], scale=sc,
                ref_cache=cache).numpy()
    assert ours.shape == cx.shape
    assert (ours < 2.0).mean() > 0.5                # mostly valid windows
    if xla_float:
        np.testing.assert_array_equal(ours, eager)
        return
    _close(ours, eager)
    if grid == "sites":
        torch_parity.assert_costs_close(ours, compiled)
    else:
        # Compiled JAX contracts the 9-sample windows' sums into FMAs.
        torch_parity.assert_costs_close(ours, compiled, frac=0.995,
                                        atol_max=1e-3)


@pytest.fixture(scope="module")
def sweep_case(tmp_path_factory):
    """JAX SweepData of a 48x36x3 plane scene padded to 3 source views (one
    padded), a candidate stack and source depths with zeros and NaNs."""
    sc = make_plane_scene(str(tmp_path_factory.mktemp("torch_ncc")),
                          width=W, height=H, num_views=3, seed=2)
    inputs = scene_mod.load_problem_inputs(
        scene_mod.generate_sample_list(sc.folder)[0], 1, need_prior=False,
        need_weak=False, need_src_depths=False)
    rng = np.random.default_rng(3)
    inputs.src_depths = np.stack(
        [sc.gt_depths[i] * rng.uniform(0.99, 1.01, (H, W))
         for i in range(3)]).astype(np.float32)
    inputs.src_depths[1:, ::7, ::5] = 0.0
    inputs.src_depths[1:, 3::11, ::3] = np.nan
    data = st_mod.build_sweep_data(inputs, 3)
    params = PatchMatchParams()
    gt = np.concatenate([sc.gt_normals[0], sc.gt_depths[0][..., None]], -1)
    planes = []
    for s in (1.0, 1.03, 0.97):
        g = gt.copy()
        g[..., 3] *= s
        n_cam = jgeo.normal_world_to_cam(data.ref_cam, jnp.asarray(g[..., :3]))
        px, py = jgeo.pixel_grid(H, W)
        planes.append(np.asarray(jgeo.plane_from_depth_normal(
            data.ref_cam, px, py, jnp.asarray(g[..., 3]), n_cam)))
    return dict(data=data, params=params, planes=np.stack(planes),
                tdata=tst.sweep_data_from_numpy(torch_parity.to_numpy(data),
                                                "cpu"))


@pytest.mark.parametrize("xla_float", [False, True])
def test_ncc_cost_vector_padded_views(sweep_case, xla_float, monkeypatch):
    c = sweep_case
    data, tdata = c["data"], c["tdata"]
    offs = jpm.strong_offsets(c["params"])
    plane = c["planes"][0]

    def jax_cost():
        cache = jpm.strong_ref_cache(data, c["params"])
        return jpm.ncc_cost_vector(data, jnp.asarray(plane), offs,
                                   ref_cache=cache)
    with jax.disable_jit():
        eager = np.asarray(jax_cost())
    compiled = np.asarray(jax.jit(jax_cost)())
    if xla_float:
        torch_parity.xla_cpu_float(monkeypatch)
    cache = tpm.strong_ref_cache(tdata, torch_parity.port_params(c["params"]))
    ours = tpm.ncc_cost_vector(tdata, torch.from_numpy(plane), offs,
                               ref_cache=cache).numpy()
    assert ours.shape == (3, H, W)
    assert (ours[2] == 2.0).all() and (eager[2] == 2.0).all()  # padded view
    assert (ours[:2] < 2.0).mean() > 0.7
    if xla_float:
        np.testing.assert_array_equal(ours, eager)
        return
    # The rendered texture is smoother than the random pair's: more of the
    # costs see the variance cancellation (79% within 1e-5 measured).
    _close(ours, eager, frac=0.75)
    torch_parity.assert_costs_close(ours, compiled)

    # A stack of candidates in one call equals one call per candidate.
    stack = tpm.ncc_cost_vector(tdata, torch.from_numpy(c["planes"]), offs,
                                ref_cache=cache)
    assert stack.shape == (3, 3, H, W)
    for i in range(3):
        one = tpm.ncc_cost_vector(tdata, torch.from_numpy(c["planes"][i]),
                                  offs, ref_cache=cache)
        assert torch.equal(stack[i], one)


def test_ncc_cost_vector_at_sites_without_cache(sweep_case):
    """Compacted sites with their own ref centre, no cache, and candidates
    evaluated in groups of one (the large-frame path) equal to one batch."""
    c = sweep_case
    data, tdata = c["data"], c["tdata"]
    offs = jpm.strong_offsets(c["params"])
    ccx, ccy = jchecker.sites(H, W, 1)
    rc = jchecker.compact(data.ref_image, 1)
    pl = np.stack([np.asarray(jchecker.compact(jnp.asarray(p), 1))
                   for p in c["planes"]])
    with jax.disable_jit():
        eager = np.asarray(jpm.ncc_cost_vector(
            data, jnp.asarray(pl[1]), offs, cx=ccx, cy=ccy, ref_center=rc))
    t = [torch.from_numpy(np.asarray(a)) for a in (ccx, ccy, rc)]
    ours = tpm.ncc_cost_vector(tdata, torch.from_numpy(pl), offs, cx=t[0],
                               cy=t[1], ref_center=t[2])
    _close(ours[1].numpy(), eager, frac=0.75)
    old = tpm.BATCH_ELEMS
    try:
        tpm.BATCH_ELEMS = 1
        grouped = tpm.ncc_cost_vector(tdata, torch.from_numpy(pl), offs,
                                      cx=t[0], cy=t[1], ref_center=t[2])
    finally:
        tpm.BATCH_ELEMS = old
    assert torch.equal(grouped, ours)


def test_geom_cost_vector_nan_and_zero_depths(sweep_case, monkeypatch):
    c = sweep_case
    data, tdata = c["data"], c["tdata"]
    with jax.disable_jit():
        eager = np.asarray(jpm.geom_cost_vector(data, jnp.asarray(
            c["planes"][1])))
    compiled = np.asarray(jax.jit(jpm.geom_cost_vector)(
        data, jnp.asarray(c["planes"][1])))
    ours = tpm.geom_cost_vector(tdata, torch.from_numpy(c["planes"])).numpy()
    assert ours.shape == (3, 3, H, W)
    # XLA:CPU's sqrt is an ulp from libm's on some arguments.
    np.testing.assert_allclose(ours[1], eager, rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(ours[1], compiled, rtol=1e-4, atol=1e-4)
    assert (ours[:, 2] == 3.0).all()                      # padded view
    assert (ours[1, 1] == 3.0).mean() > 0.02              # zero depths
    assert (eager[1] == 3.0).sum() == (ours[1, 1] == 3.0).sum()
    torch_parity.xla_cpu_float(monkeypatch)
    ours = tpm.geom_cost_vector(tdata, torch.from_numpy(c["planes"])).numpy()
    np.testing.assert_array_equal(ours[1], eager)
    # Direct call, one view, against JAX's function.
    cam = jgeo.Camera(K=data.src_cams.K[0], R=data.src_cams.R[0],
                      t=data.src_cams.t[0])
    px, py = jgeo.pixel_grid(H, W)
    with jax.disable_jit():
        want = np.asarray(jncc.geom_consistency_cost(
            data.ref_cam, cam, data.src_depths[1], jnp.asarray(c["planes"][2]),
            px, py))
    tcam = tgeo.Camera(K=tdata.src_cams.K[0], R=tdata.src_cams.R[0],
                       t=tdata.src_cams.t[0])
    tpx, tpy = tgeo.pixel_grid(H, W)
    got = tncc.geom_consistency_cost(tdata.ref_cam, tcam, tdata.src_depths[1],
                                     torch.from_numpy(c["planes"][2]), tpx,
                                     tpy).numpy()
    np.testing.assert_array_equal(got, want)


# ---- the six cases of tests/test_ncc.py, on the port ----

def _setup(rng, Hs=40, Ws=50, shift=0):
    img = rng.uniform(0, 255, (Hs, Ws + 8)).astype(np.float32)
    ref = torch.from_numpy(np.ascontiguousarray(img[:, :Ws]))
    src = torch.from_numpy(np.ascontiguousarray(img[:, shift:Ws + shift]))
    K = torch.tensor([[45.0, 0, Ws / 2], [0, 45.0, Hs / 2], [0, 0, 1]])
    cam = tgeo.Camera(K=K, R=torch.eye(3), t=torch.zeros(3))
    px, py = tgeo.pixel_grid(Hs, Ws)
    return ref, src, cam, px, py


def _const_plane(px, n, d):
    return torch.cat([torch.tensor(n).expand(*px.shape, 3),
                      torch.full((*px.shape, 1), d)], -1)


def test_identity_warp_zero_cost(rng):
    ref, _src, cam, px, py = _setup(rng)
    hom = tncc.homography_field(cam, cam.K, torch.eye(3), torch.zeros(3),
                                _const_plane(px, [0.0, 0.0, -1.0], 4.0),
                                px, py)
    cost = _ncc(ref, ref, hom, px, py,
                tncc.window_offsets(5, 2), 5.0, 3.0, ref)
    assert float(cost.median()) < 0.01


def test_flat_patch_cost_max():
    ref = torch.full((30, 30), 128.0)
    cam = tgeo.Camera(K=torch.tensor([[30.0, 0, 15], [0, 30, 15], [0, 0, 1]]),
                      R=torch.eye(3), t=torch.zeros(3))
    px, py = tgeo.pixel_grid(30, 30)
    hom = tncc.homography_field(cam, cam.K, torch.eye(3), torch.zeros(3),
                                _const_plane(px, [0.0, 0.0, -1.0], 2.0),
                                px, py)
    cost = _ncc(ref, ref, hom, px, py,
                tncc.window_offsets(5, 2), 5.0, 3.0, ref)
    np.testing.assert_allclose(cost.numpy(), 2.0)


def test_oob_center_cost_max(rng):
    ref, src, cam, px, py = _setup(rng)
    hom = tncc.homography_field(cam, cam.K, torch.eye(3),
                                torch.tensor([100.0, 0.0, 0.0]),
                                _const_plane(px, [0.0, 0.0, -1.0], 0.5),
                                px, py)
    cost = _ncc(ref, src, hom, px, py,
                tncc.window_offsets(5, 2), 5.0, 3.0, ref)
    assert float((cost == 2.0).float().mean()) > 0.9


def test_adaptive_scale_matches_explicit_offsets(rng):
    ref, src, cam, px, py = _setup(rng)
    hom = tncc.homography_field(cam, cam.K, torch.eye(3),
                                torch.tensor([0.05, 0.0, 0.0]),
                                _const_plane(px, [0.0, 0.0, -1.0], 4.0),
                                px, py)
    scaled = _ncc(ref, src, hom, px, py,
                  tncc.window_offsets(5, 2), 5.0, 3.0, ref,
                  scale=torch.full(px.shape, 2.0))
    explicit = _ncc(ref, src, hom, px, py,
                    tncc.window_offsets(10, 4), 5.0, 3.0, ref)
    np.testing.assert_allclose(scaled.numpy(), explicit.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_geom_consistency_perfect_depths():
    Hs, Ws = 24, 32
    K = torch.tensor([[30.0, 0, 16], [0, 30, 12], [0, 0, 1]])
    ref = tgeo.Camera(K=K, R=torch.eye(3), t=torch.zeros(3))
    src = tgeo.Camera(K=K, R=torch.eye(3), t=torch.tensor([0.2, 0.0, 0.0]))
    px, py = tgeo.pixel_grid(Hs, Ws)
    plane = tgeo.plane_from_depth_normal(ref, px, py,
                                         torch.full((Hs, Ws), 3.0),
                                         torch.tensor([0.0, 0.0, -1.0]))
    cost = tncc.geom_consistency_cost(ref, src, torch.full((Hs, Ws), 3.0),
                                      plane, px, py)
    assert float(cost.median()) < 0.05


def test_ref_cache_equivalence(rng):
    ref, src, cam, px, py = _setup(rng)
    hom = tncc.homography_field(cam, cam.K, torch.eye(3),
                                torch.tensor([0.07, 0.01, 0.0]),
                                _const_plane(px, [0.1, -0.05, -0.99], 3.5),
                                px, py)
    offs = tncc.window_offsets(5, 2)
    base = _ncc(ref, src, hom, px, py, offs, 5.0, 3.0, ref)
    cache = _ref_cache(ref, px, py, offs, 5.0, 3.0, ref)
    cached = _ncc(ref, src, hom, px, py, offs, 5.0, 3.0, ref,
                  ref_cache=cache)
    np.testing.assert_allclose(cached.numpy(), base.numpy(), rtol=1e-5,
                               atol=1e-5)
    scale = torch.full(px.shape, 2.0)
    base_s = _ncc(ref, src, hom, px, py, offs, 5.0, 3.0, ref,
                  scale=scale)
    cache_s = _ref_cache(ref, px, py, offs, 5.0, 3.0, ref,
                         scale=scale)
    cached_s = _ncc(ref, src, hom, px, py, offs, 5.0, 3.0, ref,
                    scale=scale, ref_cache=cache_s)
    close = np.isclose(cached_s.numpy(), base_s.numpy(), rtol=1e-4,
                       atol=1e-4)
    assert close.mean() > 0.995, close.mean()
