"""Weak-texture machinery of the PyTorch port against the JAX package, from
identical carried inputs (the JAX package's support maps, post-init state
and bundle, handed over through the ``*_from_numpy`` carriers), drawing the
same random numbers (``torch_parity.JaxKey``). The scene is the 48x36x3
weak-patch scene of ``torch_parity.weak_scene`` in pass B (geometric
consistency on).

  * ``fit_plane_ransac``: the same picks (which pixels get a fit plane, and
    the adaptive radius, at >= 99.9% of the pixels); fit planes within 1e-4
    on >= 99.9% of the pixels (the 3x3 plane solve rounds in another order);
  * ``build_weak_bundle``, store and forced streaming mode: the bf16 volumes
    equal on >= 99% of the entries and within one bf16 unit in the last
    place elsewhere (a float32 cost one rounding apart can round to the
    neighbouring bf16 value); the probe-center disparities to atol 1e-4;
  * ``interp_profile`` and ``weak_cost``'s cost and geometric term (JAX's
    ``deformable_cost_rect`` and ``geom_term_rect``) on carried inputs, in the store, the regathered-a_d0 and the streaming
    mode: ``assert_costs_close``;
  * one weak color's proposal: planes agree on >= 95% of the color's weak
    sites (statistical past the argmins, as the strong iteration);
  * the port's store and streaming modes give identical weak proposals,
    unbanded and banded.
"""
import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.engine import weak_rect as twr
from dpe_mvs_tpu_torch.ops import weak as tweak

import jax
import jax.numpy as jnp
from dpe_mvs_tpu.engine import stages
from dpe_mvs_tpu.engine import sweep as jsweep
from dpe_mvs_tpu.engine import weak_rect
from dpe_mvs_tpu.ops import checker as jchecker
from dpe_mvs_tpu.ops import weak as jweak


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    ws = torch_parity.weak_scene(tmp_path_factory.mktemp("torch_weak"))
    sup, st = jax.jit(lambda d, s, k: jsweep.build_support(
        d, s, ws.params, k))(ws.data, ws.st0, jax.random.key(5))
    st1 = stages._init_j(ws.data, st, ws.params, ws.rh.statics)
    k_fit = jax.random.key(8)
    fit = jax.jit(lambda d, sp, s, k: jweak.fit_plane_ransac(
        k, d, sp, s, ws.params))(ws.data, sup, st1, k_fit)
    sup_it = sup._replace(**fit)
    bundle = stages._weakprep_j(ws.data, sup, st1, ws.params, ws.rh.statics)
    return dict(ws=ws, sup=sup, st1=st1, k_fit=k_fit, fit=fit,
                sup_it=sup_it, bundle=bundle,
                tdata=torch_parity.port_inputs(ws.data, ws.views),
                tparams=torch_parity.port_params(ws.params),
                statics=torch_parity.port_statics(ws.rh.statics))


def _tstate(st):
    return tst.pm_state_from_numpy(torch_parity.to_numpy(st), None, "cpu")


def _tsup(sup):
    return tst.support_from_numpy(torch_parity.to_numpy(sup), "cpu")


def test_fit_plane_ransac(case):
    c = case
    ours = tweak.fit_plane_ransac(torch_parity.JaxKey(c["k_fit"]),
                                  c["tdata"], _tsup(c["sup"]),
                                  _tstate(c["st1"]), c["tparams"])
    ref = torch_parity.to_numpy(c["fit"])
    fp, fr = ours["fit_plane"].numpy(), ref["fit_plane"]
    weak = np.asarray(c["st1"].weak) == 0
    assert (np.abs(fr[weak][:, :3]).sum(-1) > 0).mean() > 0.5  # fits found
    picked = (fp[..., :3] != 0).any(-1) == (fr[..., :3] != 0).any(-1)
    assert picked.mean() >= 0.999, picked.mean()
    close = np.isclose(fp, fr, rtol=1e-4, atol=1e-4).all(-1)
    assert close.mean() >= 0.999, close.mean()
    same_r = ours["radius"].numpy() == ref["radius"]
    assert same_r.mean() >= 0.999, same_r.mean()


def _bf16_close(ours, ref):
    """bf16 tensors equal on >= 99% of the entries; elsewhere one bf16 unit
    in the last place apart, or within the float32 cost tolerance (2e-4,
    ``assert_costs_close``) where that is wider (small costs)."""
    a = ours.view(torch.int16).numpy()
    b = np.asarray(ref).view(np.int16)
    assert a.shape == b.shape
    fa = torch.from_numpy(a).view(torch.bfloat16).float().numpy()
    fb = torch.from_numpy(b.copy()).view(torch.bfloat16).float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(fb), 1e-30))) - 7)
    d = np.abs(fa - fb)
    assert (d <= np.maximum(ulp, 2e-4)).all(), float(d.max())
    assert (a == b).mean() >= 0.99, (a == b).mean()


@pytest.mark.parametrize("mode", ["store", "stream"])
def test_build_weak_bundle(case, mode, monkeypatch):
    c = case
    if mode == "stream":
        monkeypatch.setattr(weak_rect, "AP_STORE_MAX_PX", 0)
        monkeypatch.setattr(twr, "AP_STORE_MAX_PX", 0)
        ref = torch_parity.to_numpy(jax.jit(
            lambda d, sp, s: weak_rect.build_weak_bundle(
                d, sp, s, c["ws"].params, c["ws"].rh.statics))(
            c["ws"].data, c["sup"], c["st1"]))
    else:
        ref = torch_parity.to_numpy(c["bundle"])
    ours = twr.build_weak_bundle(c["tdata"], _tsup(c["sup"]),
                                 _tstate(c["st1"]), c["tparams"],
                                 c["statics"])
    _bf16_close(ours.vol_center, ref.vol_center)
    _bf16_close(ours.vol_geom, ref.vol_geom)
    np.testing.assert_allclose(ours.d0.numpy(), ref.d0, rtol=0, atol=1e-4)
    if mode == "store":
        assert ours.w_chans is None and ref.w_chans is None
        _bf16_close(ours.ap, ref.ap)
        np.testing.assert_allclose(ours.a_d0.numpy(), ref.a_d0, rtol=0,
                                   atol=1e-4)
    else:
        assert ours.ap is None and ours.a_d0 is None
        carried = tst.weak_bundle_from_numpy(ref, "cpu")
        for rv, wo, wr in zip(c["tdata"].rect, ours.w_chans,
                              carried.w_chans):
            xs = torch.arange(48, dtype=torch.int32)[None, None].expand(
                8, 36, 48)
            ys = torch.arange(36, dtype=torch.int32)[None, :, None].expand(
                8, 36, 48)
            po, do = twr._gather_profiles(rv, wo, xs, ys)
            pr, dr = twr._gather_profiles(rv, wr, xs, ys)
            _bf16_close(po, pr.view(torch.int16).numpy())
            np.testing.assert_allclose(do.numpy(), dr.numpy(), rtol=0,
                                       atol=1e-4)


def test_interp_profile():
    rng = np.random.default_rng(0)
    S = twr.PROBE_S
    prof = rng.uniform(0, 2, (3, S, 8, 16)).astype(np.float32)
    prof[:, 5] = twr.VOL_INVALID
    srel = (rng.uniform(-1.2, 1.2, (3, 8, 16)) * (S / 2)
            * twr.PROBE_STEP).astype(np.float32)
    srel[0, 0, :4] = [0.0, -15.0, 15.0, 7.0]          # the probe lattice
    val, ok = twr.interp_profile(torch.from_numpy(prof),
                                 torch.from_numpy(srel))
    rval, rok = weak_rect.interp_profile(jnp.asarray(prof),
                                         jnp.asarray(srel))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    torch_parity.assert_costs_close(np.where(rok, val.numpy(), 0),
                                    np.where(rok, np.asarray(rval), 0))
    assert np.asarray(rok).mean() > 0.3


@pytest.mark.parametrize("mode", ["store", "regather_a_d0", "stream"])
def test_deformable_and_geom_terms(case, mode, monkeypatch):
    c = case
    ws = c["ws"]
    if mode == "store":
        bundle = c["bundle"]
    else:
        gate = "AP_STORE_MAX_PX" if mode == "stream" else "A_D0_STORE_MAX_PX"
        monkeypatch.setattr(weak_rect, gate, 0)
        bundle = jax.jit(lambda d, sp, s: weak_rect.build_weak_bundle(
            d, sp, s, ws.params, ws.rh.statics))(ws.data, c["sup"], c["st1"])
    sites = weak_rect.build_weak_sites(ws.data, c["sup_it"], c["st1"],
                                       bundle, 0)
    if sites.ap is None:
        ap, ad0 = weak_rect._gather_band_profiles(ws.data, bundle, sites.a_x,
                                                  sites.a_y)
        sites = sites._replace(ap=ap, a_d0=ad0)
    tbundle = tst.weak_bundle_from_numpy(torch_parity.to_numpy(bundle), "cpu")
    tsites = twr.build_weak_sites(c["tdata"], _tsup(c["sup_it"]),
                                  _tstate(c["st1"]), tbundle, 0)
    if tsites.ap is None:
        ap, ad0 = twr._gather_band_profiles(c["tdata"], tbundle, tsites.a_x,
                                            tsites.a_y)
        tsites = tsites._replace(ap=ap, a_d0=ad0)
    np.testing.assert_array_equal(tsites.anchor_plane.numpy(),
                                  np.asarray(sites.anchor_plane))
    np.testing.assert_array_equal(tsites.anchor_sel.numpy().view(np.uint32),
                                  np.asarray(sites.anchor_sel))
    planes = [c["st1"].plane, sites.anchor_plane[0], c["fit"]["fit_plane"]]
    for pl in planes:
        ref = weak_rect.deformable_cost_rect(ws.data, sites, pl, ws.params)
        ours = twr.weak_cost(c["tdata"], tsites,
                             torch.from_numpy(np.asarray(pl)))
        torch_parity.assert_costs_close(ours.numpy(), np.asarray(ref))
        ref = weak_rect.geom_term_rect(ws.data, sites, pl)
        ours = twr.weak_cost(c["tdata"], tsites,
                             torch.from_numpy(np.asarray(pl)), photo=False,
                             geom=True)
        torch_parity.assert_costs_close(ours.numpy(), np.asarray(ref))
    assert (np.asarray(ref) < 3.0).mean() > 0.3       # geometry is informative


def _weak_color(c, bundle, tbundle, key):
    """One weak color (0) in both packages from identical inputs; returns
    (port, JAX) compacted proposals and the color's weak sites."""
    ws = c["ws"]
    ref = jax.jit(lambda k, d, sp, s, b: weak_rect.propagate_weak_rect(
        k, d, sp, s, ws.params, 0, 0, ws.rh.statics, b))(
        key, ws.data, c["sup_it"], c["st1"], bundle)
    ours = twr.propagate_weak_rect(
        torch_parity.JaxKey(key), c["tdata"], _tsup(c["sup_it"]),
        _tstate(c["st1"]), c["tparams"], 0, 0, c["statics"], tbundle)
    sites = np.asarray(jchecker.compact(c["st1"].weak == 0, 0))
    return ours, torch_parity.to_numpy(ref), sites


def test_one_weak_color_matches_jax(case):
    """One weak color's proposal: planes agree on >= 95% of the color's weak
    sites. Past the candidate argmin and the refinement acceptances parity
    is statistical, as in the strong iteration (costs agree to ~1e-4)."""
    c = case
    tbundle = tst.weak_bundle_from_numpy(torch_parity.to_numpy(c["bundle"]),
                                         "cpu")
    ours, ref, sites = _weak_color(c, c["bundle"], tbundle,
                                   jax.random.key(21))
    assert sites.sum() > 50
    close = np.isclose(ours[0].numpy(), ref[0], rtol=1e-4,
                       atol=1e-4).all(-1)[sites]
    assert close.mean() >= 0.95, close.mean()
    moved = ~np.isclose(ref[0], np.asarray(jchecker.compact(
        c["st1"].plane, 0)), rtol=1e-4, atol=1e-4).all(-1)[sites]
    assert moved.mean() > 0.05                  # the proposal did work


def test_port_store_and_streaming_agree(case, monkeypatch):
    """The port's streaming mode (no anchor-profile store, per-band profile
    gathers) gives the store mode's weak proposal exactly, unbanded and
    banded."""
    c = case
    tsup_ = _tsup(c["sup"])
    key = torch_parity.JaxKey(jax.random.key(21))

    def color(bundle):
        return twr.propagate_weak_rect(
            key, c["tdata"], _tsup(c["sup_it"]), _tstate(c["st1"]),
            c["tparams"], 0, 0, c["statics"], bundle)

    store = twr.build_weak_bundle(c["tdata"], tsup_, _tstate(c["st1"]),
                                  c["tparams"], c["statics"])
    monkeypatch.setattr(twr, "AP_STORE_MAX_PX", 0)
    stream = twr.build_weak_bundle(c["tdata"], tsup_, _tstate(c["st1"]),
                                   c["tparams"], c["statics"])
    assert stream.ap is None and stream.w_chans is not None
    for bands in (1, 4):
        monkeypatch.setattr(twr, "_weak_band_count", lambda H, W: bands)
        for a, b in zip(color(stream), color(store)):
            assert torch.equal(a, b)
