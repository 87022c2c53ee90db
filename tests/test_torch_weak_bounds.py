"""The weak bundle's exact memory bounds, on a small frame.

At the ETH3D final round (6048x4032, a 6528x6456 rect frame) the modal
pass B peaks in weakprep. Three holders live at that peak are bounded, each
without changing a number or drawing anything new:

  * (a) ``rectcost._sweep_ncc_spans`` keeps only each window offset's
    weight ``w`` and forms ``w * ref`` again where a chunk reads it. Its
    (vol, gvol) equal, bit for bit, those of the earlier code that kept
    every ``(w, w * ref)`` pair resident for the whole sweep (written out
    below as ``_resident_spans``), at strides 1 and 2, with and without the
    geometric term, in one span and in three, each span's probes in chunks
    of 3 (``rectcost.GATHER_BYTES`` forced small);
  * (b) it yields no valid volume: a probe is valid exactly where
    vol != VOL_INVALID, and the disparity sweeps of classify and refine,
    which read validity so, hand the backward warp the same costs, bit for
    bit, as the earlier code did from its valid volume;
  * (c) ``weak_rect.build_weak_bundle`` ends each view's fields where they
    die: when a view's probe volumes are built, no field of the view
    before it is alive (weak references to the probe volumes, their
    probe-centre disparities and the packed channels); and its outputs,
    with stored and with streamed anchor profiles, equal bit for bit those
    built over ``_resident_spans``.

Through the round loop every problem of a round sweeps in the round's
common rect frame (7296x6456 at 6048x4032x6), and pass B then peaks in the
weak stage. Two more holders are bounded there, again exactly:

  * (d) ``weak_rect.propagate_weak_rect`` ends its sites before its
    full-frame cost evaluation (the proposal body runs in
    ``_weak_proposal``, whose locals die as it returns);
  * (e) ``build_weak_sites`` copies ``anchor_sel`` out of the anchors'
    six-word gather, which a view of it kept alive with the sites.
  Both colours' outputs equal, bit for bit, those of the code before
  (``_propagate_before``), whole and in row bands, with stored and
  streamed anchor profiles.

The scene: ``torch_parity.weak_scene`` (48x36, 2 source views), round 1's
pass A and its pass B (the geometric term), after the support and init
stages.
"""
import weakref

import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch.engine import patchmatch as tpm
from dpe_mvs_tpu_torch.engine import rectcost as trc
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.engine import strong_rect as tstrong
from dpe_mvs_tpu_torch.engine import sweep as tsweep
from dpe_mvs_tpu_torch.engine import weak_rect as twr
from dpe_mvs_tpu_torch.utils.rng import TorchKey

CLASSIFY = np.arange(-30, 31, dtype=np.float32)      # DepthToWeak's probes


def _resident_spans(rv, coeff_fn, spans, offsets, sigma_spatial,
                    sigma_color, with_geom, stride=1):
    """``rectcost._sweep_ncc_spans`` as it was before the bounds: every
    window offset's ``(w, w * ref)`` pair resident for the whole sweep, and
    a valid volume beside vol and gvol."""
    Hp, Wp = rv.ref_rect.shape
    dev = rv.ref_rect.device
    Hs, Ws = Hp // stride, Wp // stride
    u = (torch.arange(Ws, dtype=torch.float32, device=dev) * stride)[None, :]
    v = (torch.arange(Hs, dtype=torch.float32, device=dev) * stride)[:, None]

    def sub(a):
        return a[::stride, ::stride] if stride > 1 else a

    rows = trc._row_offsets(offsets)
    ref_c = sub(rv.ref_rect)
    inv_2ss = 1.0 / (2.0 * sigma_spatial * sigma_spatial)
    inv_2sc = 1.0 / (2.0 * sigma_color * sigma_color)
    z = torch.zeros((Hs, Ws), dtype=torch.float32, device=dev)
    sum_w, sum_ref, sum_ref2 = z, z.clone(), z.clone()
    ws_by_oy, src_by_oy = [], []
    for oy, oxs in rows:
        src_by_oy.append(trc._shift3(rv.src_rect, int(oy), 0)[::stride]
                         .contiguous())
        wwr = []
        for ox in oxs:
            r = sub(trc._shift3(rv.ref_rect, int(oy), int(ox)))
            spatial = float(np.sqrt(ox * ox + oy * oy))
            w = torch.exp(-spatial * inv_2ss - torch.abs(r - ref_c) * inv_2sc)
            wr = w * r
            wwr.append((w, wr))
            sum_w = sum_w + w
            sum_ref = sum_ref + wr
            sum_ref2 = sum_ref2 + wr * r
        ws_by_oy.append(wwr)
    inv_w = 1.0 / sum_w
    m_ref = sum_ref * inv_w
    var_ref = sum_ref2 * inv_w - m_ref * m_ref
    del sum_w, sum_ref, sum_ref2

    k_max = max(len(oxs) for _, oxs in rows)
    sc_cap = max(1, min(trc.S_CHUNK,
                        int(trc.GATHER_BYTES // (k_max * Hs * Ws * 4))))
    ref_ok_s = sub(rv.ref_ok)[:, None] > 0.5
    src_ok_rows = rv.src_ok[::stride].contiguous()
    dep_rows = rv.src_depth_rect[::stride].contiguous() if with_geom else None
    vq = v.reshape(Hs, 1, 1)
    uq = u.reshape(1, 1, Ws)

    def chunk(c0, c1):
        gxs, gys, g0s = coeff_fn(c0, c1)
        n = gxs.shape[0]
        gxs_t = gxs.transpose(0, 1)
        gys_t = gys.transpose(0, 1)
        g0s_t = g0s.transpose(0, 1)
        zc = torch.zeros((Hs, n, Ws), dtype=torch.float32, device=dev)
        sum_src, sum_src2, sum_rs = zc, zc.clone(), zc.clone()
        for (oy, oxs), src_rows, wwr in zip(rows, src_by_oy, ws_by_oy):
            k = len(oxs)
            us = u[0][None, :] + torch.tensor(oxs, dtype=torch.float32,
                                              device=dev)[:, None]
            us4 = us[None, None]
            xs4 = us4 + gxs_t[:, :, None] * (us4 - rv.cx) + \
                (gys_t * (vq + (oy - rv.cy)))[:, :, None] + \
                g0s_t[:, :, None]
            xs4 = torch.where(torch.isfinite(xs4), xs4, torch.zeros_like(xs4))
            src = trc.rowgather.bilinear_x(
                src_rows, xs4.reshape(Hs, n * k * Ws).contiguous())
            src = src.reshape(Hs, n, k, Ws)
            for j in range(k):
                w, wr = wwr[j]
                s_j = src[:, :, j]
                ws_ = w[:, None] * s_j
                sum_src += ws_
                sum_src2.addcmul_(ws_, s_j)
                sum_rs.addcmul_(wr[:, None], s_j)

        iw = inv_w[:, None]
        m_src = sum_src * iw
        var_src = sum_src2 * iw - m_src * m_src
        covar = sum_rs * iw - m_ref[:, None] * m_src
        den = torch.sqrt(torch.clamp(var_ref[:, None] * var_src,
                                     min=trc.K_MIN_VAR ** 2))
        cost_c = torch.clamp(1.0 - covar / den, 0.0, trc.COST_MAX)
        cost_c = torch.where((var_ref[:, None] < trc.K_MIN_VAR) |
                             (var_src < trc.K_MIN_VAR),
                             torch.full_like(cost_c, trc.COST_MAX), cost_c)
        d_c = gxs_t * (uq - rv.cx) + gys_t * (vq - rv.cy) + g0s_t
        d_c = torch.where(torch.isfinite(d_c), d_c,
                          torch.full_like(d_c, trc.BIG))
        xs_c = uq + d_c
        xs_i = xs_c.reshape(Hs, n * Ws).clamp(0.0, Wp - 1).to(torch.int32) \
            .contiguous()
        src_ok_c = trc.rowgather.row_gather(src_ok_rows, xs_i) \
            .reshape(Hs, n, Ws)
        valid = ref_ok_s & (src_ok_c > 0.5) & (xs_c >= 0.0) & \
            (xs_c <= Wp - 1.0) & (d_c < 0)
        vol = torch.where(valid, cost_c,
                          torch.full_like(cost_c, trc.VOL_INVALID))
        gvol = None
        if with_geom:
            z_src = trc.rowgather.row_gather(dep_rows, xs_i) \
                .reshape(Hs, n, Ws)
            x_back = xs_c + rv.f * rv.b / torch.where(
                z_src > 0, z_src, torch.full_like(z_src, 1e30))
            err = torch.clamp(torch.abs(x_back - uq), max=trc.GEOM_COST_MAX)
            err = torch.where((z_src > 0) & valid, err,
                              torch.full_like(err, trc.GEOM_COST_MAX))
            gvol = torch.where(valid, err, torch.full_like(
                err, trc.VOL_INVALID)).transpose(0, 1)
        return vol.transpose(0, 1), gvol, valid.transpose(0, 1)

    def span(s0, s1):
        n_chunks = -(-(s1 - s0) // sc_cap)
        sc = -(-(s1 - s0) // n_chunks)
        vol = torch.empty((s1 - s0, Hs, Ws), dtype=torch.float32, device=dev)
        gvol = torch.empty_like(vol) if with_geom else None
        valid = torch.empty((s1 - s0, Hs, Ws), dtype=torch.bool, device=dev)
        for c0 in range(s0, s1, sc):
            c1 = min(s1, c0 + sc)
            v_, g_, ok_ = chunk(c0, c1)
            vol[c0 - s0:c1 - s0] = v_
            valid[c0 - s0:c1 - s0] = ok_
            if with_geom:
                gvol[c0 - s0:c1 - s0] = g_
        return vol, gvol, valid

    for s0, s1 in spans:
        yield span(s0, s1)


def _resident_vols(*args):
    """``_resident_spans`` with the current signature: (vol, gvol)."""
    for vol, gvol, _valid in _resident_spans(*args):
        yield vol, gvol


@pytest.fixture(scope="module", params=[False, True],
                ids=["passA1", "passB1"])
def case(request, tmp_path_factory):
    """Round 1's sweep inputs after support and init: (data, support,
    state, params, statics)."""
    torch.set_num_threads(1)
    ws = torch_parity.weak_scene(tmp_path_factory.mktemp("torch_weak_bounds"),
                                 geom=request.param)
    tdata = torch_parity.port_inputs(ws.data, ws.views)
    params = torch_parity.port_params(ws.params)
    statics = torch_parity.port_statics(ws.rh.statics)
    tstate = tst.pm_state_from_numpy(torch_parity.to_numpy(ws.st0), None,
                                     "cpu")
    sup, st = tsweep.build_support(tdata, tstate, params, TorchKey(5))
    st = tstrong.initialize_rect(tdata, st.replace(key=TorchKey(6)), params,
                                 statics)
    return tdata, sup, st, params, statics


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.uint8)


def _probe_args(case, stride):
    """``_sweep_ncc_spans``' arguments for view 0's 16 probes around the
    state's planes (the weak bundle's centre volume), at ``stride``."""
    tdata, _sup, st, params, statics = case
    rv = tdata.rect[0]
    gx, gy, g0 = twr._rect_plane_coeffs(rv, st.plane, statics, 0)
    Hs, Ws = (n // stride for n in rv.ref_rect.shape)
    gx, gy, g0 = (f[:Hs * stride:stride, :Ws * stride:stride]
                  for f in (gx, gy, g0))
    ds = torch.as_tensor(twr.probe_offsets())[:, None, None]

    def coeff_fn(c0, c1):
        n = c1 - c0
        return (gx[None].expand(n, Hs, Ws), gy[None].expand(n, Hs, Ws),
                g0[None] + ds[c0:c1])
    return (rv, coeff_fn, tpm.strong_offsets(params), params.sigma_spatial,
            params.sigma_color, params.geom_consistency, stride)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("spans", [[(0, 16)], [(0, 5), (5, 11), (11, 16)]],
                         ids=["one_span", "three_spans"])
def test_spans_equal_resident_products(case, monkeypatch, stride, spans):
    """(a) and (b): vol and gvol of every span against the resident
    products' code, whose valid volume is where vol != VOL_INVALID."""
    rv, coeff_fn, offs, ss, sc, geom, _ = _probe_args(case, stride)
    Hs, Ws = (n // stride for n in rv.ref_rect.shape)
    k_max = max(len(oxs) for _, oxs in trc._row_offsets(offs))
    monkeypatch.setattr(trc, "GATHER_BYTES", 3 * k_max * Hs * Ws * 4)
    old = list(_resident_spans(rv, coeff_fn, spans, offs, ss, sc, geom,
                               stride))
    new = list(trc._sweep_ncc_spans(rv, coeff_fn, spans, offs, ss, sc, geom,
                                    stride))
    assert len(old) == len(new) == len(spans)
    for (c0, c1), (v0, g0, ok0), (v1, g1) in zip(spans, old, new):
        assert v1.shape == (c1 - c0, Hs, Ws)
        assert torch.equal(_bits(v1), _bits(v0))
        assert torch.equal(v1 != trc.VOL_INVALID, ok0)
        assert (g0 is None) == (g1 is None) == (not geom)
        if geom:
            assert torch.equal(_bits(g1), _bits(g0))
    ok = torch.cat([ok for _, _, ok in old])
    vol = torch.cat([v for v, _, _ in old])
    assert ok.float().mean() > 0.05 and (vol < 1).float().mean() > 0.02


@pytest.mark.parametrize("stride", [1, 2])
def test_disparity_sweep_reads_validity_from_vol(case, monkeypatch, stride):
    """(b) The disparity sweep (classify's 61 probes) hands the backward
    warp, chunk by chunk, the costs the earlier code made from its valid
    volume: COST_MAX (and GEOM_COST_MAX in the geometric term) where a
    probe is invalid."""
    tdata, sup, st, params, statics = case
    expected, got = [], []

    def spans(rv, coeff_fn, spans, offsets, sigma_spatial, sigma_color,
              with_geom, stride=1):
        for vol, gvol, valid in _resident_spans(
                rv, coeff_fn, spans, offsets, sigma_spatial, sigma_color,
                with_geom, stride):
            cost = torch.where(valid, vol, torch.full_like(vol, trc.COST_MAX))
            if with_geom:
                cost = cost + params.geom_factor * torch.where(
                    valid, gvol, torch.full_like(gvol, trc.GEOM_COST_MAX))
            expected.append(cost)
            yield vol, gvol
    warp = trc.warp_bwd_channels_strided

    def warp_rec(rv, statics, i, cost, stride):
        got.append(cost.clone())
        return warp(rv, statics, i, cost, stride)
    monkeypatch.setattr(trc, "_sweep_ncc_spans", spans)
    monkeypatch.setattr(trc, "warp_bwd_channels_strided", warp_rec)
    twr.rect_disparity_sweep(tdata, st, params, statics, CLASSIFY,
                             stride=stride)
    assert len(got) == len(expected) >= len(tdata.rect)
    for a, b in zip(got, expected):
        assert torch.equal(_bits(a), _bits(b))
    costs = torch.cat([c.flatten() for c in expected])
    assert (costs >= trc.COST_MAX).any() and (costs < 1.0).any()


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["stored_profiles", "streamed_profiles"])
def test_bundle_equals_resident_products(case, monkeypatch, streamed):
    """(c) ``build_weak_bundle`` over the bounded spans against the bundle
    over ``_resident_spans``, bit for bit."""
    tdata, sup, st, params, statics = case
    if streamed:
        monkeypatch.setattr(twr, "AP_STORE_MAX_PX", 0)
    with monkeypatch.context() as m:
        m.setattr(trc, "_sweep_ncc_spans", _resident_vols)
        old = twr.build_weak_bundle(tdata, sup, st, params, statics)
    new = twr.build_weak_bundle(tdata, sup, st, params, statics)
    assert (new.w_chans is not None) == streamed == (new.ap is None)
    assert (new.vol_geom is not None) == params.geom_consistency
    for name in old._fields:
        a, b = getattr(new, name), getattr(old, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(_bits(a), _bits(b)), name
    assert (new.vol_center.float() < 1.0).float().mean() > 0.2


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["stored_profiles", "streamed_profiles"])
def test_bundle_ends_each_views_fields(case, monkeypatch, streamed):
    """(c) When a view's probe volumes are built, the fields of the view
    before it are gone: its probe volumes, their probe-centre disparities
    and (with stored profiles) the packed channels of its weak-window
    volume."""
    tdata, sup, st, params, statics = case
    if streamed:
        monkeypatch.setattr(twr, "AP_STORE_MAX_PX", 0)
    refs = []                       # (view, name, weak reference)
    calls = []
    probe, gather = twr._probe_volume_one, twr._gather_profiles

    def probe_rec(*args, **kw):
        view = len(calls) // 2
        calls.append(view)
        alive = [(v, n) for v, n, r in refs if v < view and r() is not None]
        assert not alive, f"view {view}'s probe volumes with {alive} alive"
        out = probe(*args, **kw)
        refs.extend((view, f"probe {len(calls)} output {j}", weakref.ref(t))
                    for j, t in enumerate(out) if t is not None)
        return out

    def gather_rec(rv, chans, ax, ay):
        refs.append((calls[-1], "packed channels", weakref.ref(chans)))
        return gather(rv, chans, ax, ay)
    monkeypatch.setattr(twr, "_probe_volume_one", probe_rec)
    monkeypatch.setattr(twr, "_gather_profiles", gather_rec)
    twr.build_weak_bundle(tdata, sup, st, params, statics)
    assert calls == [0, 0, 1, 1] == sorted(calls)
    assert any(n == "packed channels" for _, n, _ in refs) != streamed


def _propagate_before(key, data, sup, state, params, it, color, rstat,
                      bundle):
    """``weak_rect.propagate_weak_rect`` as it was before its sites ended
    early: the sites (and the last band's slice) alive through the final
    full-frame cost evaluation, ``anchor_sel`` a view of the anchors'
    six-word gather."""
    H, W = data.ref_image.shape
    sites = twr.build_weak_sites(data, sup, state, bundle, color)
    plane_now = state.plane
    selected_now = state.selected
    nb = twr._weak_band_count(H, W)
    if nb == 1:
        if sites.ap is None:
            ap_f, ad0_f = twr._gather_band_profiles(data, bundle, sites.a_x,
                                                    sites.a_y)
            sites = sites._replace(ap=ap_f, a_d0=ad0_f)
        plane, selected, view_weight, weight_norm = twr._weak_body(
            key, data, sites, plane_now, selected_now, sup.fit_plane,
            params, it)
    else:
        hb = -(-H // nb)
        nb = -(-H // hb)
        outs = []
        for b in range(nb):
            r0 = min(b * hb, H - hb)
            s_b = twr._slice_sites(sites, r0, hb)
            if s_b.ap is None:
                ap_b, ad0_b = twr._gather_band_profiles(data, bundle,
                                                        s_b.a_x, s_b.a_y)
                s_b = s_b._replace(ap=ap_b, a_d0=ad0_b)
            o = twr._weak_body(key.fold_in(b), data, s_b,
                               plane_now.narrow(0, r0, hb),
                               selected_now.narrow(0, r0, hb),
                               sup.fit_plane.narrow(0, r0, hb), params, it)
            keep = hb if b < nb - 1 else H - b * hb
            outs.append((o[0][hb - keep:], o[1][hb - keep:],
                         o[2][:, hb - keep:], o[3][hb - keep:]))
        plane = torch.cat([o[0] for o in outs])
        selected = torch.cat([o[1] for o in outs])
        view_weight = torch.cat([o[2] for o in outs], dim=1)
        weight_norm = torch.cat([o[3] for o in outs])
    wsum = weight_norm.clamp(min=1e-30)
    cmask = tsweep.checkerboard_mask(H, W, color, data.device)
    plane_full = torch.where(cmask[..., None], plane, state.plane)
    final_vec = trc.rect_cost_vector_stacked(
        trc.build_rect_stack(data.rect, rstat), plane_full, data.view_valid,
        params, tpm.strong_offsets(params), geom=False)
    final_cost = (view_weight * final_vec).sum(0) / wsum
    final_cost = torch.where(weight_norm > 0, final_cost,
                             torch.full_like(final_cost, trc.COST_MAX))
    from dpe_mvs_tpu_torch.ops import checker
    return (checker.compact(plane, color), checker.compact(final_cost, color),
            checker.compact(selected, color),
            checker.compact(view_weight.permute(1, 2, 0), color)
            .permute(2, 0, 1))


@pytest.mark.parametrize("bands", [1, 3], ids=["whole", "three_bands"])
@pytest.mark.parametrize("streamed", [False, True],
                         ids=["stored_profiles", "streamed_profiles"])
def test_weak_sites_end_before_the_final_cost(case, monkeypatch, bands,
                                              streamed):
    """(d) ``propagate_weak_rect`` ends its sites (the anchors' gathered
    state, several full-frame maps) before its full-frame cost evaluation,
    the weak stage's largest: weak references to them are dead when the
    evaluation starts. (e) ``build_weak_sites``' ``anchor_sel`` owns its
    storage (a view kept the six-word gather alive with the sites) and
    equals that gather's fifth word. Both colours' outputs equal, bit for
    bit, those of the code before (``_propagate_before``), whole and in row
    bands, with stored and streamed anchor profiles."""
    from dpe_mvs_tpu_torch.ops import sampling
    from dpe_mvs_tpu_torch.ops import weak as tweak
    tdata, sup, st, params, statics = case
    if streamed:
        monkeypatch.setattr(twr, "AP_STORE_MAX_PX", 0)
    monkeypatch.setattr(twr, "_weak_band_count", lambda H, W: bands)
    bundle = twr.build_weak_bundle(tdata, sup, st, params, statics)
    sup = sup._replace(**tweak.fit_plane_ransac(TorchKey(7), tdata, sup, st,
                                                params))
    assert (st.weak == twr.WEAK).any()
    refs = []
    build, cost = twr.build_weak_sites, trc.rect_cost_vector_stacked

    def build_rec(*args):
        sites = build(*args)
        # The sites' own fields (the rest are the bundle's).
        refs.extend((n, weakref.ref(getattr(sites, n))) for n in (
            "cx", "cy", "xr", "yr", "a_x", "a_y", "anchor_valid",
            "anchor_strong", "anchor_sel", "anchor_plane"))
        return sites

    def cost_rec(*args, **kw):
        alive = [n for n, r in refs if r() is not None]
        assert refs and not alive, f"the sites' {alive} are alive"
        return cost(*args, **kw)
    for color in (0, 1):
        key = TorchKey(9).fold_in(color)
        want = _propagate_before(key, tdata, sup, st, params, 0, color,
                                 statics, bundle)
        with monkeypatch.context() as m:
            m.setattr(twr, "build_weak_sites", build_rec)
            m.setattr(trc, "rect_cost_vector_stacked", cost_rec)
            got = twr.propagate_weak_rect(key, tdata, sup, st, params, 0,
                                          color, statics, bundle)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))
        refs.clear()
    sites = twr.build_weak_sites(tdata, sup, st, bundle, 0)
    sel = sites.anchor_sel
    assert sel.is_contiguous()
    assert sel.untyped_storage().nbytes() == sel.numel() * sel.element_size()
    H, W = st.weak.shape
    packed = torch.cat([st.plane.contiguous().view(torch.int32),
                        st.selected[..., None],
                        st.weak.to(torch.int32)[..., None]], dim=-1)
    g = sampling.gather_map(packed, sites.a_y.reshape(8 * H, W),
                            sites.a_x.reshape(8 * H, W)).reshape(8, H, W, 6)
    assert torch.equal(sel, g[..., 4])
