"""Weak-texture machinery on the rectified cost engine.

Port of :mod:`dpe_mvs_tpu.engine.weak_rect`. The reference evaluates the
deformable NCC (``ComputeBilateralNCCNew``, DPE.cu:557-690) with ~9 scattered
windows per (pixel, view, candidate). This engine restructures the weak
pipeline (``CheckerboardPropagationWeak``, DPE.cu:1668-1862) around two
per-sweep precomputations, so that every plane evaluation afterwards is
elementwise work:

  1. **Disparity probe volume**: per source view, in its rectified frame, the
     bilateral-NCC window cost at every pixel for ``PROBE_S`` disparity
     offsets around the sweep-initial plane's disparity (keeping that plane's
     slope across the window); in geometric-consistency passes a parallel
     volume of forward-backward reprojection errors.
  2. **Anchor profiles**: the weak-window volume and its probe-center
     disparity, gathered once per sweep at the 8 deformable anchors of every
     pixel (the ``gather2d`` kernel).

Each such evaluation (a candidate plane field's cost, term, or both, at
every view) goes through :func:`weak_cost`: on the card one launch of the
``weakcost`` kernel (:mod:`..ops.weakcost`), on the CPU the ``_ref``
functions, its plain version.

A candidate plane's deformable cost at pixel p for view v is

    0.25 * lerp(center profile at p,   disparity of the candidate at p)
  + 0.75 * mean_j lerp(anchor profile, disparity of the candidate at a_j)

with the reference's 0.25/0.75 blend (DPE.cu:680-686), its selected-view
out-of-bounds accounting (DPE.cu:595-607) and its center invalidation
(DPE.cu:577-580). The deviations from the reference are the JAX package's
(probe-lattice sampling with the initial plane's slope, the anchor window's
own center as its bilateral color anchor, no adaptive center radius).

Also here: :func:`rect_disparity_sweep`, the probe loops of DepthToWeak and
LocalRefine. The memory gates (``AP_STORE_MAX_PX``, ``A_D0_STORE_MAX_PX``,
:func:`_weak_band_count`) keep the JAX package's constants; banding is part
of the result (each band draws from ``key.fold_in(b)``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import (COST_MAX, GEOM_COST_MAX, PatchMatchParams, PixelState,
                      RunState)
from ..geometry import cameras as geo
from ..geometry import rectify
from ..ops import checker, ncc, sampling, weakcost
from ..ops import gather2d as g2d
from ..utils import profiling
from ..utils.profiling import BRANCHES
from . import patchmatch as pm
from . import rectcost
from . import strong_rect, sweep
from .rectcost import VALID_THRESH, VOL_INVALID, _sweep_ncc_volume
from .state import PMState, SweepData

WEAK = int(PixelState.WEAK)
STRONG = int(PixelState.STRONG)
BIG = float(1e30)

PROBE_S = 16           # probes per pixel per view
PROBE_STEP = 2.0       # px between probes
A_D0_STORE_MAX_PX = 1_000_000   # above this, a_d0 is regathered per color
# Above this pixel count the (V, 8, S, H, W) anchor-profile store is never
# materialized: the bundle keeps the packed rect-frame weak-window volumes and
# every weak iteration gathers its row band's anchor profiles on the fly.
AP_STORE_MAX_PX = 1_500_000


def probe_offsets() -> np.ndarray:
    """Static disparity offsets, centred on 0 (the initial plane)."""
    return ((np.arange(PROBE_S) - (PROBE_S - 1) / 2.0) * PROBE_STEP
            ).astype(np.float32)


class WeakRectBundle(NamedTuple):
    """Per-sweep device products of :func:`build_weak_bundle`."""

    vol_center: torch.Tensor         # (V, S, H, W) bf16 strong-window NCC
    vol_geom: Optional[torch.Tensor]  # (V, S, H, W) bf16 geom err, or None
    d0: torch.Tensor                 # (V, H, W) f32 probe-center disparity
                                     # (BIG where invalid in that view)
    ap: Optional[torch.Tensor]       # (V, 8, S, H, W) bf16 anchor weak-window
                                     # profiles; None above AP_STORE_MAX_PX
    a_d0: Optional[torch.Tensor]     # (V, 8, H, W) f32 probe-center disparity
                                     # at the anchors; None above
                                     # A_D0_STORE_MAX_PX (regathered per color)
    w_chans: Optional[torch.Tensor] = None
                                     # streaming mode only: (V, S/2+1, Hp, Wp)
                                     # int32, bf16-packed weak-window volumes +
                                     # d0 bits in each view's rect frame


# ---------------------------------------------------------------------------
# Volume construction (row-local)
# ---------------------------------------------------------------------------

def _rect_plane_coeffs(rv, plane: torch.Tensor, statics, i: int):
    """Warp the (H, W, 4) ref-cam plane field into rv's rect frame and
    return its affine disparity coefficient fields (gx, gy, g0), (Hp, Wp)."""
    pr = rectcost.plane_to_rect(plane, rv.R2r)
    prw = rectcost.warp_fwd_channels(rv, statics, i, pr.permute(2, 0, 1))
    prw = prw.permute(1, 2, 0)
    return rectify.disparity_coeffs(prw[..., :3], prw[..., 3], rv.f, rv.b)


def _probe_volume_one(rv, gx, gy, g0, offsets: np.ndarray,
                      sigma_spatial: float, sigma_color: float,
                      with_geom: bool):
    """(S, Hp, Wp) probe-window NCC volume (+ optional geom volume) in rv's
    rect frame, probing disparities d0 + ds around the plane field behind
    (gx, gy, g0) while keeping its within-window slope; also returns d0."""
    Hp, Wp = rv.ref_rect.shape
    dev = rv.ref_rect.device
    u = torch.arange(Wp, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(Hp, dtype=torch.float32, device=dev)[:, None]
    d0 = gx * (u - rv.cx) + gy * (v - rv.cy) + g0
    d0 = torch.where(torch.isfinite(d0), d0, torch.full_like(d0, BIG))
    ds = torch.as_tensor(probe_offsets(), device=dev)[:, None, None]

    def coeff_fn(c0, c1):
        n = c1 - c0
        return (gx[None].expand(n, Hp, Wp), gy[None].expand(n, Hp, Wp),
                g0[None] + ds[c0:c1])

    ok0 = torch.abs(d0) < BIG
    vol, gvol = _sweep_ncc_volume(
        rv, coeff_fn, PROBE_S, offsets, sigma_spatial, sigma_color,
        with_geom)
    vol.masked_fill_(~ok0[None], VOL_INVALID)
    if gvol is not None:
        gvol.masked_fill_(~ok0[None], VOL_INVALID)
    d0 = torch.where((rv.ref_ok > 0.5) & ok0, d0, torch.full_like(d0, BIG))
    return vol, gvol, d0


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate/det)."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    Hc = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv = torch.stack([torch.stack([A, B, C]), torch.stack([D, E, F]),
                       torch.stack([G, Hc, I])])
    return inv / det


def rect_disparity_sweep(data: SweepData, state: PMState,
                         params: PatchMatchParams, statics,
                         disps: np.ndarray, stride: int = 1) -> torch.Tensor:
    """(S, H, W) selected-view-weighted costs over disparity offsets around
    the current depth (probe loops of ``DepthToWeak`` DPE.cu:2593-2747 and
    ``LocalRefine`` DPE.cu:2749-2835), plus the weighted geometric term in
    geom passes. All S probes share one set of ref-side window sums, and
    their source gathers ride batched row-gather launches.

    ``stride=2`` evaluates the probe centers on the rect frame's even
    subgrid and nearest-upsamples through the backward warp (classify).

    The probes run in chunks (``patchmatch.SWEEP_CHUNK_BYTES``): per view, each
    chunk's rect volume is evaluated, masked, warped back and added to its
    rows of the (S, H, W) accumulator, so every transient is a chunk's and
    every element sums its views in view order, as in one piece."""
    H, W = data.ref_image.shape
    dev = data.device
    S = len(disps)
    cam = data.ref_cam
    n_cam, origin_depth, bl, _cnt = pm._disparity_setup(data, state)
    f = cam.fx
    offs = pm.strong_offsets(params)
    geom = params.geom_consistency

    bits = pm.selected_bits(state.selected, data.num_src)
    w_v = torch.where(bits, state.view_weight.permute(2, 0, 1),
                      torch.zeros((), dtype=torch.int32, device=dev))
    wsum = w_v.sum(0).to(torch.float32).clamp(min=1e-30)

    dispsj = torch.as_tensor(disps, dtype=torch.float32,
                             device=dev)[:, None, None]
    big = torch.full_like(origin_depth, 1e30)
    disp0 = f * bl / torch.where(origin_depth > 0, origin_depth, big)
    cmax = COST_MAX + (params.geom_factor * GEOM_COST_MAX if geom else 0.0)
    rect_px = max(rv.ref_rect.numel() for rv in data.rect) // stride ** 2
    chunks = sampling.spans(S, 4.0 * max(H * W, rect_px),
                            pm.SWEEP_CHUNK_BYTES)
    if len(chunks) > 1:
        BRANCHES["disparity-sweep chunks"] += len(chunks)

    total = torch.zeros((S, H, W), dtype=torch.float32, device=dev)
    for i, rv in enumerate(data.rect):
        # The probe-independent fields of view i, once for all chunks.
        Hp, Wp = rv.ref_rect.shape
        u = (torch.arange(Wp // stride, dtype=torch.float32, device=dev)
             * stride)[None, :]
        v = (torch.arange(Hp // stride, dtype=torch.float32, device=dev)
             * stride)[:, None]
        ch = rectcost.warp_fwd_channels(
            rv, statics, i,
            torch.stack([n_cam[..., 0], n_cam[..., 1], n_cam[..., 2],
                         origin_depth, bl]))
        ncx, ncy, ncz, od_r, bl_r = ch[:, ::stride, ::stride].contiguous() \
            .unbind(0)
        del ch
        # Rect-frame normal (plane distances are frame-invariant).
        R = rv.R2r
        nrx = R[0, 0] * ncx + R[0, 1] * ncy + R[0, 2] * ncz
        nry = R[1, 0] * ncx + R[1, 1] * ncy + R[1, 2] * ncz
        nrz = R[2, 0] * ncx + R[2, 1] * ncy + R[2, 2] * ncz
        # Probed depth per rect pixel; plane distance from the original
        # pixel ray: original coords via the inverse rect homography.
        disp0_r = f * bl_r / torch.where(od_r > 0, od_r,
                                         torch.full_like(od_r, 1e30))
        Hi = _inv3(rv.H_ref)
        wdiv = Hi[2, 0] * u + Hi[2, 1] * v + Hi[2, 2]
        wdiv = torch.where(wdiv.abs() < 1e-20, torch.full_like(wdiv, 1e-20),
                           wdiv)
        pox = (Hi[0, 0] * u + Hi[0, 1] * v + Hi[0, 2]) / wdiv
        poy = (Hi[1, 0] * u + Hi[1, 1] * v + Hi[1, 2]) / wdiv
        ndotp = ncx * (pox - cam.cx) / cam.fx + \
            ncy * (poy - cam.cy) / cam.fy + ncz

        def coeff_fn(c0, c1, rv=rv, nrx=nrx, nry=nry, nrz=nrz,
                     bl_r=bl_r, disp0_r=disp0_r, ndotp=ndotp):
            # Probe depths -> plane distances -> rect coeffs, per chunk.
            pdep = f * bl_r[None] / (disp0_r[None] + dispsj[c0:c1])
            w_s = -pdep * ndotp[None]                        # plane dist
            safe = torch.where(w_s.abs() < 1e-30, torch.full_like(w_s, 1e-30),
                               w_s)
            return (rv.b * nrx[None] / safe, rv.b * nry[None] / safe,
                    rv.b * rv.f * nrz[None] / safe)

        not_ok = ~((rv.orig_ok[None] > 0.5) & data.view_valid[i])
        vols = rectcost._sweep_ncc_spans(
            rv, coeff_fn, chunks, offs, params.sigma_spatial,
            params.sigma_color, with_geom=geom, stride=stride)
        for c0, c1 in chunks:
            vol, gvol = next(vols)
            invalid = vol == VOL_INVALID
            cost_i = vol.masked_fill_(invalid, COST_MAX)
            if geom:
                cost_i = cost_i + params.geom_factor * gvol.masked_fill_(
                    invalid, GEOM_COST_MAX)
            del vol, gvol, invalid
            back = rectcost.warp_bwd_channels_strided(
                rv, statics, i, cost_i, stride)              # (n, H, W)
            del cost_i
            back.masked_fill_(not_ok, cmax)
            total[c0:c1].add_(w_v[i][None] * back)
            del back

    for c0, c1 in chunks:
        p_depth = f * bl[None] / (disp0[None] + dispsj[c0:c1])
        in_range = (p_depth >= data.depth_min) & (p_depth <= data.depth_max)
        total[c0:c1].div_(wsum[None]).clamp_(max=COST_MAX) \
            .masked_fill_(~in_range, COST_MAX)
    return total


def _anchor_rect_coords(rv, ax: torch.Tensor, ay: torch.Tensor):
    """Orig-grid anchor pixel coords -> rv's rect frame (float)."""
    Hm = rv.H_ref
    axf = ax.to(torch.float32)
    ayf = ay.to(torch.float32)
    wdiv = Hm[2, 0] * axf + Hm[2, 1] * ayf + Hm[2, 2]
    wdiv = torch.where(wdiv.abs() < 1e-20, torch.full_like(wdiv, 1e-20), wdiv)
    xr = (Hm[0, 0] * axf + Hm[0, 1] * ayf + Hm[0, 2]) / wdiv
    yr = (Hm[1, 0] * axf + Hm[1, 1] * ayf + Hm[1, 2]) / wdiv
    return xr, yr


def _gather_profiles(rv, chans: torch.Tensor, ax: torch.Tensor,
                     ay: torch.Tensor):
    """Gather the packed rect-frame weak-window volume ``chans``
    (S/2+1, Hp, Wp) int32 at the orig-grid anchors (8, h, W): returns
    ((S, 8, h, W) bf16 profiles, (8, h, W) f32 probe-center disparities)."""
    h, W = ax.shape[1:]
    axr, ayr = _anchor_rect_coords(rv, ax, ay)
    qy = torch.round(ayr).to(torch.int32).reshape(8 * h, W)
    qx = torch.round(axr).to(torch.int32).reshape(8 * h, W)
    g2 = g2d.gather2d(chans, qy, qx)                         # (C, 8h, W)
    prof = g2d.unpack_bf16_pairs(g2[:PROBE_S // 2])
    return (prof.reshape(PROBE_S, 8, h, W),
            g2[PROBE_S // 2].view(torch.float32).reshape(8, h, W))


def build_weak_bundle(data: SweepData, sup, state: PMState,
                      params: PatchMatchParams, statics) -> WeakRectBundle:
    """Build the per-sweep probe volumes + anchor profiles.

    ``state`` must be post-init (plane in ref-cam (n, dist) layout,
    DPE.cu:3195 ordering: GenNeighbours' anchors in ``sup.neighbours``)."""
    H, W = data.ref_image.shape
    dev = data.device
    offs_strong = pm.strong_offsets(params)
    offs_weak = ncc.window_offsets(params.weak_radius, params.weak_increment)
    geom = params.geom_consistency

    anchors = sup.neighbours                    # (8, H, W, 2) int32, -1 pad
    # Invalid anchors (-1) gather from the pixel's own position: it keeps
    # the queries local (the values are masked downstream).
    xg8 = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :] \
        .expand(8, H, W)
    yg8 = torch.arange(H, dtype=torch.int32, device=dev)[None, :, None] \
        .expand(8, H, W)
    ax = torch.where(anchors[..., 0] >= 0, anchors[..., 0], xg8)
    ay = torch.where(anchors[..., 1] >= 0, anchors[..., 1], yg8)

    store_ap = H * W <= AP_STORE_MAX_PX
    inv = torch.full((), VOL_INVALID, device=dev)
    # The per-view products land in preallocated stacks (a list and its
    # stacked copy would hold them twice at the stage's peak).
    V = len(data.rect)
    vol_c = torch.empty((V, PROBE_S, H, W), dtype=torch.bfloat16, device=dev)
    vol_g = torch.empty_like(vol_c) if geom else None
    d0 = torch.empty((V, H, W), dtype=torch.float32, device=dev)
    w_chans = None if store_ap else torch.empty(
        (V, PROBE_S // 2 + 1, *data.rect[0].ref_rect.shape),
        dtype=torch.int32, device=dev)
    aps, a_d0s = [], []
    chunks = sampling.spans(
        PROBE_S, 4.0 * max(H * W, data.rect[0].ref_rect.numel()),
        pm.SWEEP_CHUNK_BYTES)
    for i, rv in enumerate(data.rect):
        gx, gy, g0 = _rect_plane_coeffs(rv, state.plane, statics, i)
        # Strong-window (center) volume, warped to the orig grid.
        vc, vg, d0r = _probe_volume_one(
            rv, gx, gy, g0, offs_strong, params.sigma_spatial,
            params.sigma_color, with_geom=geom)

        def back(chans, i=i, rv=rv):
            return rectcost.warp_bwd_channels(rv, statics, i, chans)

        ok_o = rv.orig_ok > 0.5
        # Warped back a chunk of probes at a time: the warp's transposed and
        # expanded copies are a chunk's (each channel warps on its own).
        for c0, c1 in chunks:
            vol_c[i, c0:c1] = torch.where(ok_o[None], back(vc[c0:c1]), inv)
            if geom:
                vol_g[i, c0:c1] = torch.where(ok_o[None], back(vg[c0:c1]),
                                              inv)
        d0[i] = torch.where(ok_o, back(d0r[None])[0],
                            torch.full((), BIG, device=dev))
        del vc, vg

        # Weak-window (anchor) volume; the profiles ride the gather as
        # packed bf16 pairs, the probe-center disparity as its float bits.
        vw = _probe_volume_one(
            rv, gx, gy, g0, offs_weak, params.sigma_spatial,
            params.sigma_color, with_geom=False)[0]
        chans = torch.cat([g2d.pack_bf16_pairs(vw),
                           d0r.contiguous().view(torch.int32)[None]])
        # This view's fields end here: held until the next view rebinds
        # their names, they would live through its probe volumes, the
        # stage's peak.
        del vw, gx, gy, g0, d0r, ok_o
        if not store_ap:
            # Streaming mode: keep the rect-frame volume; weak iterations
            # gather their band's anchor profiles on the fly.
            w_chans[i] = chans
            del chans
            continue
        prof, a_d0 = _gather_profiles(rv, chans, ax, ay)
        del chans
        aps.append(prof)
        a_d0s.append(a_d0)
    store_a_d0 = store_ap and H * W <= A_D0_STORE_MAX_PX
    if not store_ap:
        BRANCHES["streamed anchor profiles"] += 1
    if not store_a_d0:
        BRANCHES["regathered a_d0"] += 1

    return WeakRectBundle(
        vol_center=vol_c, vol_geom=vol_g, d0=d0,
        ap=(torch.stack(aps).transpose(1, 2).contiguous()    # (V, 8, S, H, W)
            if store_ap else None),
        a_d0=torch.stack(a_d0s) if store_a_d0 else None,
        w_chans=w_chans,
    )


def _gather_band_profiles(data: SweepData, bundle: WeakRectBundle,
                          a_x: torch.Tensor, a_y: torch.Tensor):
    """Streaming-mode anchor profiles for one row band: gather the packed
    rect-frame weak-window volumes (bundle.w_chans) at the band's anchor
    coords. a_x/a_y: (8, hb, W) orig-grid int32 (invalid anchors already
    substituted with own coords). Returns ((V, 8, S, hb, W) bf16 profiles,
    (V, 8, hb, W) f32 probe-center disparities)."""
    aps, ad0s = [], []
    for i, rv in enumerate(data.rect):
        prof, a_d0 = _gather_profiles(rv, bundle.w_chans[i], a_x, a_y)
        aps.append(prof)
        ad0s.append(a_d0)
    return torch.stack(aps).transpose(1, 2), torch.stack(ad0s)


# ---------------------------------------------------------------------------
# Profile interpolation
# ---------------------------------------------------------------------------

def interp_profile(prof: torch.Tensor, srel: torch.Tensor):
    """Linear interpolation of (*B, S, H, W) profiles along S at ``srel`` px
    (shape (*B, H, W)); returns (value f32, valid bool).

    The two taps around the sample are picked with ``torch.gather``; their
    hat weights, validity (a tap is valid below ``VALID_THRESH``) and sum are
    the JAX package's parallel hat-weight contraction over S with only the
    two non-zero terms (the contraction was a TPU workaround for the
    serialized gather)."""
    sf = srel / PROBE_STEP + (PROBE_S - 1) / 2.0
    in_range = (sf >= 0.0) & (sf <= PROBE_S - 1.0)
    sfc = sf.clamp(0.0, PROBE_S - 1.0)
    s0 = torch.floor(sfc).clamp(max=PROBE_S - 2.0)
    w0 = (1.0 - torch.abs(sfc - s0)).clamp(min=0.0)
    w1 = (1.0 - torch.abs(sfc - (s0 + 1.0))).clamp(min=0.0)
    i0 = s0.to(torch.int64).unsqueeze(-3)
    p0 = torch.gather(prof, -3, i0).squeeze(-3).to(torch.float32)
    p1 = torch.gather(prof, -3, i0 + 1).squeeze(-3).to(torch.float32)
    v0 = p0 < VALID_THRESH
    v1 = p1 < VALID_THRESH
    zero = torch.zeros((), device=prof.device)
    val = torch.where(v0, w0 * p0, zero) + torch.where(v1, w1 * p1, zero)
    wv = torch.where(v0, w0, zero) + torch.where(v1, w1, zero)
    ok = in_range & (wv > 0.9999)
    return val / wv.clamp(min=1e-9), ok


class WeakSites(NamedTuple):
    """Per-(sweep, color) inputs of the deformable cost, at full width (the
    caller masks to the active color when writing back)."""

    vol_center: torch.Tensor      # (V, S, H, W)
    vol_geom: Optional[torch.Tensor]
    d0: torch.Tensor              # (V, H, W)
    ap: Optional[torch.Tensor]    # (V, 8, S, H, W); None in streaming mode
                                  # until the band gather fills it
    a_d0: Optional[torch.Tensor]  # (V, 8, H, W); None likewise
    cx: torch.Tensor              # (H, W) pixel coords
    cy: torch.Tensor
    xr: torch.Tensor              # (V, H, W) pixel coords in each rect frame
    yr: torch.Tensor
    # Anchor pixel coords (orig grid, int32); their per-view rect-frame
    # coords are recomputed in weak_cost.
    a_x: torch.Tensor             # (8, H, W) int32
    a_y: torch.Tensor
    anchor_valid: torch.Tensor    # (8, H, W)
    anchor_strong: torch.Tensor   # (8, H, W) anchor is STRONG
    anchor_sel: torch.Tensor      # (8, H, W) int32 selected views @ anchor
    anchor_plane: torch.Tensor    # (8, H, W, 4) current plane @ anchor
    rect_consts: torch.Tensor     # the views' rect constants, packed for
                                  # the kernel (weakcost.pack_consts)


def build_weak_sites(data: SweepData, sup, state: PMState, bundle,
                     color) -> WeakSites:
    """Bundle views + fresh anchor state gathers (full width; ``color`` only
    affects the caller's writeback mask). Anchor planes / selected views /
    states are re-gathered each call: the reference reads them live
    (DPE.cu:1690-1716, 2928-2945)."""
    H, W = data.ref_image.shape
    dev = data.device
    xg = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    yg = torch.arange(H, dtype=torch.int32, device=dev)[:, None].expand(H, W)
    cx = xg.to(torch.float32)
    cy = yg.to(torch.float32)
    anchors = sup.neighbours                                 # (8, H, W, 2)
    a_valid = anchors[..., 0] >= 0
    # Invalid anchors gather from the pixel's own position.
    a_x = torch.where(a_valid, anchors[..., 0], xg[None])
    a_y = torch.where(a_valid, anchors[..., 1], yg[None])

    # Fresh state at the anchors: plane (4 words, float bits), selected and
    # weak state, one gather of 32-bit words.
    packed = torch.cat([
        state.plane.contiguous().view(torch.int32),
        state.selected[..., None],
        state.weak.to(torch.int32)[..., None],
    ], dim=-1)                                               # (H, W, 6)
    q_y = a_y.reshape(8 * H, W)
    q_x = a_x.reshape(8 * H, W)
    g = sampling.gather_map(packed, q_y, q_x).reshape(8, H, W, 6)
    anchor_plane = g[..., :4].contiguous().view(torch.float32)
    # A copy: a view would keep the whole gather (six words an anchor)
    # alive with the sites.
    anchor_sel = g[..., 4].contiguous()
    anchor_strong = g[..., 5] == STRONG

    xr_l, yr_l = [], []
    for rv in data.rect:
        xr, yr = _anchor_rect_coords(rv, cx, cy)
        xr_l.append(xr)
        yr_l.append(yr)

    a_d0 = bundle.a_d0
    if a_d0 is None and bundle.ap is not None:
        # Gather the anchors' probe-center disparity from the orig-grid d0
        # field (V channels) instead of carrying the (V, 8, H, W) store.
        V = bundle.d0.shape[0]
        gq = g2d.gather2d(bundle.d0.contiguous(), q_y.contiguous(),
                          q_x.contiguous())                  # (V, 8H, W)
        a_d0 = gq.reshape(V, 8, H, W)
    # Streaming mode (bundle.ap is None): ap and a_d0 stay None here and are
    # gathered per row band in propagate_weak_rect.

    return WeakSites(
        vol_center=bundle.vol_center, vol_geom=bundle.vol_geom,
        d0=bundle.d0, ap=bundle.ap, a_d0=a_d0, cx=cx, cy=cy,
        xr=torch.stack(xr_l), yr=torch.stack(yr_l), a_x=a_x, a_y=a_y,
        anchor_valid=a_valid, anchor_strong=anchor_strong,
        anchor_sel=anchor_sel, anchor_plane=anchor_plane,
        rect_consts=weakcost.pack_consts(data.rect, data.view_valid),
    )


def weak_cost(data: SweepData, sites: WeakSites, plane: torch.Tensor,
              photo: bool = True, geom: bool = False,
              geom_factor: float = 0.0,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(V, H, W) of a candidate plane field at the sites: the photometric
    deformable cost (``photo``), the geometric term (``geom``) or, with both,
    cost + geom_factor * term (the refinement's weighted candidate); written
    into ``out`` (contiguous) if given. On a CUDA device one launch of the
    ``weakcost`` kernel (:func:`..ops.weakcost.launch`), on the CPU the plain
    version (:func:`weak_cost_ref`); bit for bit the same."""
    if not (photo or geom):
        raise ValueError("weak_cost: nothing asked for")
    if plane.device.type == "cuda":
        return weakcost.launch(plane, **_kernel_operands(sites, photo, geom),
                               geom_factor=geom_factor, out=out)
    if plane.device.type != "cpu":
        raise ValueError(f"weak_cost: unsupported device {plane.device}")
    res = weak_cost_ref(data, sites, plane, photo, geom, geom_factor)
    return res if out is None else out.copy_(res)


def _kernel_operands(sites: WeakSites, photo: bool, geom: bool) -> dict:
    """The sites' fields that ``weakcost.launch`` reads for the cost
    (``photo``) and the term (``geom``), by its argument names."""
    ops = dict(consts=sites.rect_consts, xr=sites.xr, yr=sites.yr,
               d0=sites.d0)
    if photo:
        ops.update(vol_center=sites.vol_center, ap=sites.ap, a_d0=sites.a_d0,
                   a_x=sites.a_x, a_y=sites.a_y, a_valid=sites.anchor_valid,
                   a_sel=sites.anchor_sel)
    if geom:
        ops["vol_geom"] = sites.vol_geom
    return ops


def weak_cost_ref(data: SweepData, sites: WeakSites, plane: torch.Tensor,
                  photo: bool = True, geom: bool = False,
                  geom_factor: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`weak_cost` (on any device): the plain chains,
    summed as the refinement sums them."""
    if not photo:
        return geom_term_rect_ref(data, sites, plane)
    res = deformable_cost_rect_ref(data, sites, plane)
    if geom:
        res = res + geom_factor * geom_term_rect_ref(data, sites, plane)
    return res


def deformable_cost_rect_ref(data: SweepData, sites: WeakSites,
                             plane: torch.Tensor) -> torch.Tensor:
    """(V, H, W) photometric deformable NCC of a candidate plane field at the
    sites, through profile interpolation (semantics of
    ``ComputeBilateralNCCNew``, DPE.cu:557-690): the plain version of
    :func:`weak_cost`'s cost. The geometric term is separate
    (:func:`geom_term_rect_ref`): the reference adds it after view selection
    (DPE.cu:1786-1798)."""
    out = []
    for i, rv in enumerate(data.rect):
        pr = rectcost.plane_to_rect(plane, rv.R2r)           # (H, W, 4)
        gx, gy, g0 = rectify.disparity_coeffs(pr[..., :3], pr[..., 3],
                                              rv.f, rv.b)
        d_c = gx * (sites.xr[i] - rv.cx) + gy * (sites.yr[i] - rv.cy) + g0
        d_c = torch.where(torch.isfinite(d_c), d_c, torch.full_like(d_c, BIG))
        c0, ok_c = interp_profile(sites.vol_center[i], d_c - sites.d0[i])

        # Anchor windows: the candidate's disparity at each anchor.
        a_xr, a_yr = _anchor_rect_coords(rv, sites.a_x, sites.a_y)
        d_a = gx[None] * (a_xr - rv.cx) + gy[None] * (a_yr - rv.cy) + \
            g0[None]                                         # (8, H, W)
        d_a = torch.where(torch.isfinite(d_a), d_a, torch.full_like(d_a, BIG))
        val_a, ok_a = interp_profile(sites.ap[i], d_a - sites.a_d0[i])
        sel_here = ((sites.anchor_sel >> i) & 1) == 1
        # Out-of-profile anchor ~ the reference's out-of-image anchor: it
        # counts COST_MAX only if that anchor had selected this view
        # (DPE.cu:595-607).
        zero = torch.zeros((), device=d_c.device)
        cmax = torch.full((), COST_MAX, device=d_c.device)
        one = torch.ones((), device=d_c.device)
        contrib = torch.where(ok_a, val_a.clamp(0.0, COST_MAX),
                              torch.where(sel_here, cmax, zero))
        counts = torch.where(ok_a, one, torch.where(sel_here, one, zero))
        # Summed in anchor order, as the kernel does (a reduction's order
        # is the device's choice).
        masked = torch.where(sites.anchor_valid, contrib, zero)
        strong_sum = masked[0]
        for j in range(1, masked.shape[0]):
            strong_sum = strong_sum + masked[j]
        strong_cnt = torch.where(sites.anchor_valid, counts, zero).sum(0)
        strong_cost = (strong_sum / strong_cnt.clamp(min=1.0)) \
            .clamp(max=COST_MAX)

        c0 = c0.clamp(0.0, COST_MAX)
        cost = torch.where(strong_cnt > 0, 0.25 * c0 + 0.75 * strong_cost, c0)
        cost = torch.where(ok_c & data.view_valid[i], cost, cmax)
        out.append(cost)
    return torch.stack(out)


def geom_term_rect_ref(data: SweepData, sites: WeakSites,
                       plane: torch.Tensor) -> torch.Tensor:
    """(V, H, W) forward-backward geometric consistency of a candidate at
    the sites, from the probe volume (``ComputeGeomConsistencyCost``,
    DPE.cu:915-953): the plain version of :func:`weak_cost`'s term."""
    out = []
    for i, rv in enumerate(data.rect):
        pr = rectcost.plane_to_rect(plane, rv.R2r)
        gx, gy, g0 = rectify.disparity_coeffs(pr[..., :3], pr[..., 3],
                                              rv.f, rv.b)
        d_c = gx * (sites.xr[i] - rv.cx) + gy * (sites.yr[i] - rv.cy) + g0
        d_c = torch.where(torch.isfinite(d_c), d_c, torch.full_like(d_c, BIG))
        gval, ok_g = interp_profile(sites.vol_geom[i], d_c - sites.d0[i])
        out.append(torch.where(ok_g, gval.clamp(0.0, GEOM_COST_MAX),
                               torch.full_like(gval, GEOM_COST_MAX)))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Weak checkerboard propagation (CheckerboardPropagationWeak, DPE.cu:1668)
# ---------------------------------------------------------------------------

def _weak_band_count(H: int, W: int) -> int:
    """Row-band count of the weak proposal body, bounding its transients:
    working sizes (<= 500k px) run unbanded; above 1M px the cap is ~250k
    sites per band."""
    px = H * W
    want = -(-px // (500_000 if px <= 1_000_000 else 250_000))
    return max(1, min(want, H))


def _slice_sites(sites: WeakSites, r0: int, hb: int) -> WeakSites:
    """Rows [r0, r0 + hb) of every per-site field."""
    def sl(a, ax):
        return None if a is None else a.narrow(ax, r0, hb)

    return WeakSites(
        vol_center=sl(sites.vol_center, 2), vol_geom=sl(sites.vol_geom, 2),
        d0=sl(sites.d0, 1), ap=sl(sites.ap, 3), a_d0=sl(sites.a_d0, 2),
        cx=sl(sites.cx, 0), cy=sl(sites.cy, 0),
        xr=sl(sites.xr, 1), yr=sl(sites.yr, 1),
        a_x=sl(sites.a_x, 1), a_y=sl(sites.a_y, 1),
        anchor_valid=sl(sites.anchor_valid, 1),
        anchor_strong=sl(sites.anchor_strong, 1),
        anchor_sel=sl(sites.anchor_sel, 1),
        anchor_plane=sl(sites.anchor_plane, 1),
        rect_consts=sites.rect_consts,
    )


def propagate_weak_rect(key, data: SweepData, sup, state: PMState,
                        params: PatchMatchParams, it, color, rstat,
                        bundle: WeakRectBundle):
    """One color's weak-pixel proposal on the rect engine. Returns the
    color's compacted (plane, cost, selected, view_weight (V, H, W2)); the
    caller scatters and masks (``sweep.apply_compacted``).

    At working sizes the proposal body runs in one piece; above
    ``_weak_band_count``'s gate it runs per row band, band ``b`` drawing from
    ``key.fold_in(b)`` (the last band's rows start at H - hb and only its
    fresh tail is kept, as the JAX package's clamped slices do)."""
    H, W = data.ref_image.shape
    plane, selected, view_weight, weight_norm = _weak_proposal(
        key, data, sup, state, params, it, color, bundle)

    with profiling.span("weak.final_cost"):
        wsum = weight_norm.clamp(min=1e-30)
        # Re-express the stored cost with the standard strong NCC of the
        # field the writeback would store, so weak and strong costs are
        # comparable during propagation (DPE.cu:1845-1861).
        cmask = sweep.checkerboard_mask(H, W, color, data.device)
        plane_full = torch.where(cmask[..., None], plane, state.plane)
        final_vec = rectcost.rect_cost_vector_stacked(
            rectcost.build_rect_stack(data.rect, rstat), plane_full,
            data.view_valid, params, pm.strong_offsets(params),
            geom=False)                                      # (V, H, W)
        final_cost = (view_weight * final_vec).sum(0) / wsum
        final_cost = torch.where(weight_norm > 0, final_cost,
                                 torch.full_like(final_cost, COST_MAX))

        return (checker.compact(plane, color),
                checker.compact(final_cost, color),
                checker.compact(selected, color),
                checker.compact(view_weight.permute(1, 2, 0), color)
                .permute(2, 0, 1))


def _weak_proposal(key, data: SweepData, sup, state: PMState,
                   params: PatchMatchParams, it, color,
                   bundle: WeakRectBundle):
    """:func:`propagate_weak_rect`'s proposal body, whole or per row band:
    (plane, selected, view_weight, weight_norm). Its sites (the anchors'
    gathered state, several full-frame maps) end when it returns, before
    the caller's full-frame cost evaluation."""
    H, W = data.ref_image.shape
    with profiling.span("weak.sites"):
        sites = build_weak_sites(data, sup, state, bundle, color)
    plane_now = state.plane
    selected_now = state.selected

    nb = _weak_band_count(H, W)
    if nb == 1:
        if sites.ap is None:
            with profiling.span("weak.sites"):
                ap_f, ad0_f = _gather_band_profiles(data, bundle, sites.a_x,
                                                    sites.a_y)
            sites = sites._replace(ap=ap_f, a_d0=ad0_f)
        return _weak_body(key, data, sites, plane_now, selected_now,
                          sup.fit_plane, params, it)
    hb = -(-H // nb)
    nb = -(-H // hb)
    BRANCHES["weak bands"] += nb
    outs = []
    for b in range(nb):
        r0 = min(b * hb, H - hb)
        with profiling.span("weak.sites"):
            s_b = _slice_sites(sites, r0, hb)
            if s_b.ap is None:
                ap_b, ad0_b = _gather_band_profiles(data, bundle, s_b.a_x,
                                                    s_b.a_y)
                s_b = s_b._replace(ap=ap_b, a_d0=ad0_b)
        o = _weak_body(key.fold_in(b), data, s_b,
                       plane_now.narrow(0, r0, hb),
                       selected_now.narrow(0, r0, hb),
                       sup.fit_plane.narrow(0, r0, hb), params, it)
        keep = hb if b < nb - 1 else H - b * hb             # fresh rows
        outs.append((o[0][hb - keep:], o[1][hb - keep:],
                     o[2][:, hb - keep:], o[3][hb - keep:]))
    with profiling.span("weak.final_cost"):
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]),
                torch.cat([o[2] for o in outs], dim=1),
                torch.cat([o[3] for o in outs]))


def _weak_body(key, data: SweepData, sites: WeakSites, plane_now,
               selected_now, fit_plane, params: PatchMatchParams, it):
    """Candidate evaluation + view selection + refinement for (a band of)
    the weak sites; returns (plane, selected, view_weight, weight_norm)
    before the final cost (CheckerboardPropagationWeak, DPE.cu:1668-1843).
    The 8 anchor candidates are evaluated one after another, each cost and
    term in one ``weakcost`` launch on the card."""
    with profiling.span("weak.candidates"):
        nview = data.num_src
        dev = data.device
        k_sel, k_ref = key.split(2)
        geom = params.geom_consistency
        px, py = sites.cx, sites.cy
        zero = torch.zeros((), device=dev)

        flags = sites.anchor_valid & sites.anchor_strong     # (8, H, W)
        cand_planes = sites.anchor_plane                     # (8, H, W, 4)
        cost_array = torch.empty(
            (cand_planes.shape[0], len(data.rect), *px.shape),
            dtype=torch.float32, device=dev)                 # (8, V, H, W)
        for k in range(cand_planes.shape[0]):
            weak_cost(data, sites, cand_planes[k], out=cost_array[k])
        cost_array = torch.where(flags[:, None], cost_array, zero)

        # Priors from all valid anchors (DPE.cu:1717-1730).
        sh = torch.arange(nview, dtype=torch.int32,
                          device=dev)[None, :, None, None]
        bits = ((sites.anchor_sel[:, None] >> sh) & 1) == 1
        prior = torch.where(sites.anchor_valid[:, None],
                            torch.where(bits, torch.full((), 0.9, device=dev),
                                        torch.full((), 0.1, device=dev)),
                            zero).sum(0)

        view_weight, temp_selected, weight_norm = pm.view_selection(
            k_sel, cost_array, prior, data.view_valid, it)
        wsum = weight_norm.clamp(min=1e-30)

        if geom:
            # Geom is excluded from view selection and added to the final
            # weighted costs (DPE.cu:1786-1798), one candidate at a time.
            gmax = torch.full((), GEOM_COST_MAX, device=dev)
            final_costs = torch.stack([
                (view_weight * (cost_array[k] + params.geom_factor
                                * torch.where(flags[k][None],
                                              weak_cost(data, sites,
                                                        cand_planes[k],
                                                        photo=False,
                                                        geom=True),
                                              gmax))).sum(0) / wsum
                for k in range(cand_planes.shape[0])])
        else:
            final_costs = (view_weight[None] * cost_array).sum(1) / wsum[None]
        min_idx = torch.argmin(final_costs, dim=0)
        min_flag = strong_rect._select_k(flags, min_idx)
        min_cost = strong_rect._select_k(final_costs, min_idx)
        min_plane = strong_rect._select_k(cand_planes, min_idx)

    def eval_weighted(cand):
        c = weak_cost(data, sites, cand, geom=geom,
                      geom_factor=params.geom_factor)
        return (view_weight * c).sum(0) / wsum

    with profiling.span("weak.refine"):
        cost_now = eval_weighted(plane_now)
        cost_now = torch.where(weight_norm > 0, cost_now,
                               torch.full_like(cost_now, COST_MAX))
        stored_cost = cost_now

        depth_now = geo.depth_from_plane(data.ref_cam, plane_now, px, py)
        depth_before = geo.depth_from_plane(data.ref_cam, min_plane, px, py)
        accept = min_flag & (depth_before >= data.depth_min) & \
            (depth_before <= data.depth_max) & (min_cost < cost_now)

        plane = torch.where(accept[..., None], min_plane, plane_now)
        depth = torch.where(accept, depth_before, depth_now)
        cost = torch.where(accept, min_cost, cost_now)
        selected = torch.where(accept, temp_selected, selected_now)

        # Refinement (PlaneHypothesisRefinementWeak, DPE.cu:1120-1212): the
        # RANSAC fit plane first, then the 5 perturbation combos.
        fit = fit_plane
        fit_nonzero = (fit[..., :3] != 0.0).any(-1)
        c_fit = eval_weighted(fit)
        d_fit = geo.depth_from_plane(data.ref_cam, fit, px, py)
        ok = fit_nonzero & (d_fit >= data.depth_min) & \
            (d_fit <= data.depth_max) & (c_fit < cost) & (weight_norm > 0)
        plane = torch.where(ok[..., None], fit, plane)
        depth = torch.where(ok, d_fit, depth)
        cost = torch.where(ok, c_fit, cost)

        depths_c, normals_c = pm.refine_combos(k_ref, data, plane, depth,
                                               px, py)
        for d_i, n_i in zip(depths_c, normals_c):
            cand = geo.plane_from_depth_normal(data.ref_cam, px, py, d_i, n_i)
            c = eval_weighted(cand)
            d_chk = geo.depth_from_plane(data.ref_cam, cand, px, py)
            ok = (d_chk >= data.depth_min) & (d_chk <= data.depth_max) & \
                (c < cost) & (weight_norm > 0)
            plane = torch.where(ok[..., None], cand, plane)
            depth = torch.where(ok, d_chk, depth)
            cost = torch.where(ok, c, cost)

        if params.state == RunState.REFINE_INIT:
            accept_final = cost < stored_cost - 0.1
            plane = torch.where(accept_final[..., None], plane, plane_now)

    return plane, selected, view_weight, weight_norm
