"""The weak stage's cost kernel (``ops/weakcost``, ``csrc/weakcost.cu``)
against its plain version (``engine.weak_rect.deformable_cost_rect_ref`` /
``geom_term_rect_ref``, composed by ``weak_rect.weak_cost_ref``), both
reached through the entry point ``weak_rect.weak_cost``.

CPU: the entry point takes the plain path and launches nothing; the
launcher refuses a wrong dtype, shape, rank or device; driven down its
launch path with a fake kernel library, it passes every operand in place
(the pointers of the sites' own tensors, their strides: narrowed bands, the
streaming mode's transposed profile stack) and counts the launch; the
per-view constants are packed on the views' device; the bytes bound counts
each operand's bytes once.

GPU (marked ``gpu``, skipped without a CUDA device): the kernel against the
plain version, bit for bit (float32 words, NaN payloads included), at the
ETH3D cell's band (five views, 144 x 1512 sites) in the store and streaming
layouts and at the final round's band (42 x 6048, streaming), in each mode
(cost, term, cost + factor * term), over candidate planes with NaN and
infinite entries and zero distances, invalid anchors, anchors outside every
profile, profiles with invalid, NaN, negative and -0 taps, and a view whose
``view_valid`` is false. This file imports no JAX: on the card run it with
``--noconftest``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from dpe_mvs_tpu_torch.engine import weak_rect as twr
from dpe_mvs_tpu_torch.engine.rectcost import VOL_INVALID
from dpe_mvs_tpu_torch.ops import weakcost as wc

S, K = twr.PROBE_S, 8


def gpu(fn):
    """Mark a test for the GPU tier; it skips where torch sees no card."""
    skip = pytest.mark.skipif("not torch.cuda.is_available()",
                              reason="needs a CUDA device")
    return pytest.mark.gpu(skip(fn))


def _rotation(rng):
    a = rng.normal(0.0, 0.05, 3)
    t = np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / t
    return np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k


def _profiles(gen, shape, hi, dev):
    """bf16 probe profiles in [-0.05, hi]: ~8% VOL_INVALID, ~1% NaN, ~1%
    -0.0 (negative taps come from the range)."""
    u = torch.rand(shape, generator=gen, device=dev)
    p = torch.rand(shape, generator=gen, device=dev) * (hi + 0.05) - 0.05
    p = torch.where(u < 0.08, torch.full_like(p, VOL_INVALID), p)
    p = torch.where((u >= 0.08) & (u < 0.09), torch.full_like(p, np.nan), p)
    p = torch.where((u >= 0.09) & (u < 0.10), torch.full_like(p, -0.0), p)
    return p.to(torch.bfloat16)


def _disparity(rv, plane, x, y):
    """The plain chain's disparity of ``plane`` at rect coordinates (x, y)
    (to place the probe centres around it)."""
    from dpe_mvs_tpu_torch.engine import rectcost
    from dpe_mvs_tpu_torch.geometry import rectify
    pr = rectcost.plane_to_rect(plane, rv.R2r)
    gx, gy, g0 = rectify.disparity_coeffs(pr[..., :3], pr[..., 3], rv.f, rv.b)
    return gx * (x - rv.cx) + gy * (y - rv.cy) + g0


def make_case(V, h, W, layout, seed=0, device="cpu", margin=8):
    """(data, sites, planes): synthetic weak sites of a (h, W) band, as
    ``build_weak_sites`` / ``_slice_sites`` / ``_gather_band_profiles`` lay
    them out. ``layout`` "store": every field is narrowed out of a frame
    ``2 * margin`` rows taller (the bundle's (V, 8, S, H, W) profile store);
    "stream": the profiles are the band gather's transposed stack. The probe
    centres lie within ~14 px of a smooth base plane's disparity (most taps
    in range), some BIG (outside every profile); the view V - 1 is not
    valid; ``planes`` are the base plane perturbed, the anchor planes (a
    strided view), and a field with NaN, infinite and zero entries."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(dev).manual_seed(seed)
    f32 = torch.float32

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)      # 0-d stays 0-d

    rect = []
    for _ in range(V):
        Hm = np.eye(3) + rng.normal(0.0, 1e-3, (3, 3))
        Hm[:2, 2] = rng.uniform(-30.0, 30.0, 2)
        Hm[2] = [rng.normal(0.0, 1e-6), rng.normal(0.0, 1e-6), 1.0]
        rect.append(SimpleNamespace(
            R2r=t(_rotation(rng).astype(np.float32)),
            H_ref=t(Hm.astype(np.float32)),
            f=t(np.float32(rng.uniform(1000.0, 2000.0))),
            b=t(np.float32(rng.uniform(0.1, 0.4))),
            cx=t(np.float32(W / 2 + rng.normal(0.0, 5.0))),
            cy=t(np.float32(h / 2 + rng.normal(0.0, 5.0)))))
    valid = np.ones(V, bool)
    valid[-1] = V == 1
    data = SimpleNamespace(rect=tuple(rect), view_valid=t(valid))

    store = layout == "store"
    Hf = h + 2 * margin if store else h
    yy, xx = torch.meshgrid(torch.arange(Hf, device=dev, dtype=f32),
                            torch.arange(W, device=dev, dtype=f32),
                            indexing="ij")
    n = torch.stack([0.2 * torch.sin(xx / 97.0), 0.2 * torch.cos(yy / 61.0),
                     -torch.ones_like(xx)], -1)
    n = n / n.norm(dim=-1, keepdim=True)
    base = torch.cat([n, (4.0 + torch.sin(xx / 150.0 + yy / 90.0))[..., None]],
                     -1)

    def jitter(p, scale):
        noise = torch.randn(p.shape, generator=gen, device=dev) * scale
        return p + noise * torch.tensor([0.02, 0.02, 0.0, 1.0], device=dev)

    def smooth_offsets(shape):
        """~14 px smooth offsets with per-site noise, 3% BIG."""
        ph = torch.rand(shape[:-2] + (1, 1), generator=gen, device=dev) * 6
        off = 14.0 * torch.sin(xx / 41.0 + ph) * torch.cos(yy / 29.0) \
            + torch.rand(shape, generator=gen, device=dev) - 0.5
        big = torch.rand(shape, generator=gen, device=dev) < 0.03
        return off, big

    a_valid = torch.rand((K, Hf, W), generator=gen, device=dev) < 0.85
    ax = (xx + torch.randint(-40, 41, (K, Hf, W), generator=gen,
                             device=dev)).clamp(0, W - 1)
    ay = (yy + torch.randint(-40, 41, (K, Hf, W), generator=gen,
                             device=dev)).clamp(0, Hf - 1)
    a_x = torch.where(a_valid, ax, xx).to(torch.int32)
    a_y = torch.where(a_valid, ay, yy).to(torch.int32)
    a_sel = torch.randint(-2 ** 31, 2 ** 31 - 1, (K, Hf, W), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
    anchor_plane = jitter(base.expand(K, Hf, W, 4), 0.05)

    xr, yr, d0, a_d0 = [], [], [], []
    for rv in rect:
        x, y = twr._anchor_rect_coords(rv, xx, yy)
        xr.append(x)
        yr.append(y)
        off, big = smooth_offsets((Hf, W))
        d = _disparity(rv, base, x, y) + off
        d0.append(torch.where(big, torch.full_like(d, twr.BIG), d))
        axr, ayr = twr._anchor_rect_coords(rv, a_x, a_y)
        off, big = smooth_offsets((K, Hf, W))
        d = _disparity(rv, base[None], axr, ayr) + off
        a_d0.append(torch.where(big, torch.full_like(d, twr.BIG), d))
    vol_center = _profiles(gen, (V, S, Hf, W), 2.0, dev)
    vol_geom = _profiles(gen, (V, S, Hf, W), 3.0, dev)
    if store:
        ap = _profiles(gen, (V, K, S, Hf, W), 2.0, dev)
    else:
        ap = torch.stack([_profiles(gen, (S, K, h, W), 2.0, dev)
                          for _ in range(V)]).transpose(1, 2)

    r0 = margin if store else 0

    def band(a, ax_):
        return a.narrow(ax_, r0, h)

    sites = SimpleNamespace(
        vol_center=band(vol_center, 2), vol_geom=band(vol_geom, 2),
        d0=band(torch.stack(d0), 1),
        ap=band(ap, 3) if store else ap,
        a_d0=band(torch.stack(a_d0), 2),
        xr=band(torch.stack(xr), 1), yr=band(torch.stack(yr), 1),
        a_x=band(a_x, 1), a_y=band(a_y, 1), anchor_valid=band(a_valid, 1),
        anchor_sel=band(a_sel, 1),
        rect_consts=wc.pack_consts(data.rect, data.view_valid))

    odd = band(jitter(base, 0.05), 0).clone()
    u = torch.rand((h, W), generator=gen, device=dev)
    for lo, comp, val in ((0.00, 0, np.nan), (0.02, 3, np.inf),
                          (0.04, 2, -np.inf), (0.06, 3, 0.0),
                          (0.08, 3, -0.0), (0.10, 1, np.nan)):
        odd[..., comp] = torch.where((u >= lo) & (u < lo + 0.02),
                                     torch.full_like(u, val), odd[..., comp])
    planes = [band(jitter(base, 0.05), 0).contiguous(),
              band(anchor_plane[3], 0), odd]
    return data, sites, planes


def _bits(t):
    return t.contiguous().view(torch.int32)


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["store", "stream"])
def test_cpu_path_is_the_plain_version(layout):
    """On the CPU the entry point returns the plain chain's bits, launches
    nothing, and writes ``out`` in place."""
    data, sites, planes = make_case(3, 6, 10, layout, seed=1)
    wc.reset_launches()
    for plane in planes:
        c = twr.deformable_cost_rect_ref(data, sites, plane)
        g = twr.geom_term_rect_ref(data, sites, plane)
        assert torch.equal(_bits(twr.weak_cost(data, sites, plane)), _bits(c))
        assert torch.equal(_bits(twr.weak_cost(data, sites, plane,
                                               photo=False, geom=True)),
                           _bits(g))
        both = twr.weak_cost(data, sites, plane, geom=True, geom_factor=0.2)
        assert torch.equal(_bits(both), _bits(c + 0.2 * g))
        assert torch.equal(_bits(both), _bits(twr.weak_cost_ref(
            data, sites, plane, geom=True, geom_factor=0.2)))
        out = torch.empty((3, 6, 10))
        assert twr.weak_cost(data, sites, plane, out=out) is out
        assert torch.equal(_bits(out), _bits(c))
    assert wc.LAUNCHES == {"weakcost": 0}
    # The case reaches every branch: valid and invalid centres, anchors in
    # and out of their profiles, the invalid view.
    c = twr.deformable_cost_rect_ref(data, sites, planes[0])
    assert (c[:2] < 2.0).float().mean() > 0.3
    assert (c[2] == 2.0).all()


def test_anchor_mean_is_the_fold_in_anchor_order():
    """The plain version's anchor sum is an explicit fold over anchors 0..7,
    the kernel's order. With every tap read at a whole probe (the centres
    one px below the candidate's disparity: weights 1 and 0, the profile's
    value exactly) the cost is 0.25 c0 + 0.75 (((a0 + a1) + a2) ... + a7) /
    8, with small values that another order would round otherwise."""
    data, sites, planes = make_case(1, 2, 3, "stream", seed=2)
    rv, plane = data.rect[0], planes[0]
    sites.d0 = (_disparity(rv, plane, sites.xr[0], sites.yr[0]) - 1.0)[None]
    axr, ayr = twr._anchor_rect_coords(rv, sites.a_x, sites.a_y)
    sites.a_d0 = (_disparity(rv, plane[None], axr, ayr) - 1.0)[None]
    sites.anchor_valid = torch.ones_like(sites.anchor_valid)
    sites.vol_center = torch.full_like(sites.vol_center, 0.5)
    vals = torch.tensor([1.0, 3e-8, 3e-8, 0.25, 3e-8, 0.125, 3e-8, 1.5]
                        ).to(torch.bfloat16)
    sites.ap = vals[None, :, None, None, None].expand(sites.ap.shape)
    got = twr.deformable_cost_rect_ref(data, sites, plane)
    a = vals.to(torch.float32)
    fold = a[0]
    for v in a[1:]:
        fold = fold + v
    assert fold != a.double().sum().float()     # the order shows
    want = 0.25 * torch.tensor(0.5) + 0.75 * (fold / 8.0)
    assert torch.equal(got, want.expand_as(got))


def _operands(sites, photo=True, geom=True):
    return twr._kernel_operands(sites, photo, geom)


@pytest.mark.parametrize("launch", [False, True])
def test_wrapper_rejects_bad_input(launch, monkeypatch):
    """Without the launch mocked, the entry point refuses a request for
    nothing and a device that is neither the CPU nor CUDA, and the launcher
    CPU tensors. With it mocked (any device accepted, a library that must
    not be called), the launcher refuses wrong dtypes, shapes, ranks and
    devices, and a partial set of the cost's operands, before anything
    runs."""
    data, sites, planes = make_case(2, 4, 6, "stream", seed=3)
    p = planes[0]
    if not launch:
        with pytest.raises(ValueError):
            twr.weak_cost(data, sites, p, photo=False)
        with pytest.raises(ValueError):
            twr.weak_cost(data, sites, p.to("meta"))
        with pytest.raises(ValueError, match="CUDA"):
            wc.launch(p, **_operands(sites))
        return

    def no_library():
        raise AssertionError("the kernel was reached")
    monkeypatch.setattr(wc, "_load", no_library)
    monkeypatch.setattr(wc, "_require_card", lambda device: None)
    bad = [
        (TypeError, dict(plane=p.double())),
        (ValueError, dict(plane=p[..., :3])),
        (ValueError, dict(plane=p[None])),
        (TypeError, dict(xr=sites.xr.double())),
        (ValueError, dict(xr=sites.xr[0])),                      # rank
        (ValueError, dict(d0=sites.d0[0])),                      # rank
        (TypeError, dict(ap=sites.ap.float())),
        (ValueError, dict(ap=sites.ap[:, :, :8])),               # S
        (TypeError, dict(a_sel=sites.anchor_sel.long())),
        (TypeError, dict(a_valid=sites.anchor_valid.int())),
        (ValueError, dict(consts=sites.rect_consts[:-1])),
        (ValueError, dict(consts=sites.rect_consts[::2])),
        (ValueError, dict(vol_center=sites.vol_center.to("meta"))),
        (ValueError, dict(vol_center=None)),                     # partial
        (ValueError, dict(out=torch.empty(2, 4, 5))),
        (ValueError, dict(out=torch.empty(2, 6, 4).transpose(1, 2))),
    ]
    for exc, change in bad:
        plane = change.pop("plane", p)
        with pytest.raises(exc):
            wc.launch(plane, **{**_operands(sites), **change})
    with pytest.raises(ValueError):                 # nothing asked for
        wc.launch(p, **_operands(sites, photo=False, geom=False))


class _FakeCard:
    """Stands in for ``torch.cuda.device``, the current stream and the
    kernel library: records the devices entered and the ``Args`` of each
    launch."""

    def __init__(self):
        self.entered, self.args = [], []

    def device(self, device):
        entered = self.entered

        class Ctx:
            def __enter__(self):
                entered.append(device)

            def __exit__(self, *exc):
                pass
        return Ctx()

    def library(self):
        card = self

        class Lib:
            def dpe_weakcost(self, ref, stream):
                card.args.append(ref._obj)
                return 0
        return Lib()


@pytest.mark.parametrize("layout", ["store", "stream"])
@pytest.mark.parametrize("photo,geom,mode", [(True, False, 1),
                                             (False, True, 2),
                                             (True, True, 3)])
def test_launch_passes_operands_in_place(layout, photo, geom, mode,
                                         monkeypatch):
    """Driven down the launch path with CPU tensors and a fake library, the
    launcher enters the tensors' device, hands the kernel the sites' own
    tensors (no copies), as the entry point names them, with their strides,
    and counts one launch."""
    card = _FakeCard()
    monkeypatch.setattr(torch.cuda, "device", card.device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(wc, "_load", card.library)
    monkeypatch.setattr(wc, "_require_card", lambda device: None)
    data, sites, planes = make_case(3, 5, 7, layout, seed=4)
    plane = planes[1]                         # a strided view
    wc.reset_launches()
    out = wc.launch(plane, **_operands(sites, photo, geom), geom_factor=0.25)
    assert out.shape == (3, 5, 7) and out.is_contiguous()
    assert wc.LAUNCHES == {"weakcost": 1}
    assert card.entered == [plane.device]
    (a,) = card.args
    assert (a.V, a.h, a.W, a.mode, a.geom_factor) == (3, 5, 7, mode, 0.25)
    assert a.out == out.data_ptr()
    assert a.consts == sites.rect_consts.data_ptr()
    fields = {"plane": plane, "xr": sites.xr, "yr": sites.yr, "d0": sites.d0}
    if geom:
        fields["vol_geom"] = sites.vol_geom
    if photo:
        fields.update(vol_center=sites.vol_center, ap=sites.ap,
                      a_d0=sites.a_d0, a_x=sites.a_x, a_y=sites.a_y,
                      a_valid=sites.anchor_valid, a_sel=sites.anchor_sel)
    for name in ("plane", "xr", "yr", "d0", "vol_center", "vol_geom", "ap",
                 "a_d0", "a_x", "a_y", "a_valid", "a_sel"):
        f = getattr(a, name)
        if name not in fields:
            assert f.p is None
            continue
        t = fields[name]
        assert f.p == t.data_ptr(), name
        assert list(f.st)[:t.dim()] == list(t.stride()), name
    if photo and layout == "stream":         # the transposed stack, in place
        assert not sites.ap.is_contiguous()
        assert list(a.ap.st) == list(sites.ap.stride())


def test_pack_consts_layout():
    data, sites, _ = make_case(3, 2, 3, "stream", seed=5)
    c = sites.rect_consts
    assert c.shape == (3 * 23,) and c.dtype == torch.float32
    for i, rv in enumerate(data.rect):
        row = c[22 * i:22 * (i + 1)]
        assert torch.equal(row[:9], rv.R2r.reshape(9))
        assert torch.equal(row[9:18], rv.H_ref.reshape(9))
        assert torch.equal(row[18:], torch.stack([rv.f, rv.b, rv.cx, rv.cy]))
    assert c[66:].tolist() == [1.0, 1.0, 0.0]


@pytest.mark.parametrize("photo,geom", [(True, False), (False, True),
                                        (True, True)])
def test_site_bytes_counts_each_operand_once(photo, geom):
    """The bound's bytes a site: every operand the launch reads, a site's
    share of it, with the profiles read as two taps of PROBE_S, and the
    output."""
    V, h, W = 5, 2, 3
    _, sites, planes = make_case(V, h, W, "stream", seed=6)
    n = planes[0].numel() * planes[0].element_size() + 4 * V * h * W
    for name, t in _operands(sites, photo, geom).items():
        if name == "consts":
            continue                      # per view, not per site
        part = 2 / S if name in ("vol_center", "ap", "vol_geom") else 1
        n += t.numel() * t.element_size() * part
    assert wc.site_bytes(V, photo, geom) * h * W == n


# --------------------------------------------------------------------------
# GPU tier
# --------------------------------------------------------------------------

# (V, h, W, layout): the ETH3D cell's band (1512x1008: 7 bands of 144 rows)
# in both layouts, the final round's (6048x4032: 96 bands of 42 rows,
# streaming), and a ragged one.
GPU_CASES = [(5, 144, 1512, "store"), (5, 144, 1512, "stream"),
             (5, 42, 6048, "stream"), (3, 7, 33, "store")]


@gpu
@pytest.mark.parametrize("V,h,W,layout", GPU_CASES)
def test_gpu_weakcost_bit_exact(V, h, W, layout):
    data, sites, planes = make_case(V, h, W, layout, seed=h + W,
                                    device="cuda")
    wc.reset_launches()
    for i, plane in enumerate(planes):
        for photo, geom in ((True, False), (False, True), (True, True)):
            got = twr.weak_cost(data, sites, plane, photo=photo, geom=geom,
                                geom_factor=0.2)
            want = twr.weak_cost_ref(data, sites, plane, photo=photo,
                                     geom=geom, geom_factor=0.2)
            torch.cuda.synchronize()
            diff = (_bits(got) != _bits(want)).sum().item()
            assert diff == 0, (i, photo, geom, diff)
    assert wc.LAUNCHES == {"weakcost": 3 * len(planes)}
    # The case reached both sides of every branch.
    c = twr.weak_cost_ref(data, sites, planes[0])
    assert 0.2 < (c[:-1] < 2.0).float().mean() < 0.98


@gpu
def test_gpu_weakcost_writes_out_in_place():
    data, sites, planes = make_case(5, 9, 40, "store", seed=6, device="cuda")
    cost = torch.full((8, 5, 9, 40), -1.0, device="cuda")
    for k in range(8):
        twr.weak_cost(data, sites, planes[k % 3], out=cost[k])
    for k in range(8):
        want = twr.deformable_cost_rect_ref(data, sites, planes[k % 3])
        assert torch.equal(_bits(cost[k]), _bits(want))
