"""The rectified cost engine: every NCC sample as a row-local gather.

Port of :mod:`dpe_mvs_tpu.engine.rectcost`. Every cost evaluation runs in
the pairwise-rectified frames of :mod:`..geometry.rectify`, where a window sample of the source
image lies on the same row as its reference sample for any plane hypothesis
and its column is affine in the rectified pixel. One evaluation of a plane
field against the source views is:

  1. transport the plane field original -> rect frame with a nearest
     two-pass warp (ops/warp, two row_gather launches);
  2. for each static window offset row: one bilinear_x launch gathering the
     source samples of all views, plus static shifts of the rectified
     reference, accumulated into the six NCC sums;
  3. transport the cost field rect -> original with a nearest two-pass warp.

Costs keep the reference semantics: in [0, 2], COST_MAX for invalid centers.
In geometric-consistency passes (pass B) the forward-backward reprojection
error against the source views' depth maps, rectified into each view's rect
frame (:func:`rectify_src_depths`), is added with weight ``geom_factor``
(``ComputeGeomConsistencyCost``, DPE.cu:915-953).

Frames whose view-stacked cost field exceeds ``BAND_FULL_BYTES`` are
evaluated in row bands (:func:`band_rows`), which bounds the memory of the
offset accumulation at full-resolution frames and changes no number: every
read is row-local in the rect frame.

Not ported (TPU workarounds that give the same results): the stacked
runtime-flag warps and the optimization barriers.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import COST_MAX, GEOM_COST_MAX, PatchMatchParams
from ..geometry import cameras as geo
from ..geometry import rectify
from ..ops import rowgather
from ..ops import warp as warp_ops
from ..ops.ncc import K_MIN_VAR
from ..ops.sampling import shift as _shift3
from ..utils.profiling import BRANCHES

# Row banding of the stacked cost evaluation: a (V, Hs, Ws) float32 field
# over BAND_FULL_BYTES is evaluated in row bands of BAND_FIELD_BYTES per
# field (the JAX package's constants). Module-level so that tests can force
# banding on small frames.
BAND_FULL_BYTES = 96e6
BAND_FIELD_BYTES = 48e6
GATHER_BYTES = 256e6   # bound of one bilinear_x launch's queries
BIG = float(1e30)
S_CHUNK = 8        # probes per row-gather launch (bounds transient memory)
VOL_INVALID = 1e4  # marker for invalid volume entries (bf16-exact)
VALID_THRESH = 1e3


@dataclasses.dataclass
class RectView:
    """Device-side rectification data for one (ref, src) pair."""

    ref_rect: torch.Tensor     # (Hp, Wp) f32 rectified reference image
    src_rect: torch.Tensor     # (Hp, Wp) f32 rectified source image
    ref_ok: torch.Tensor       # (Hp, Wp) f32 1 where rect px has ref content
    src_ok: torch.Tensor       # (Hp, Wp) f32 1 where rect px has src content
    src_depth_rect: torch.Tensor  # (Hp, Wp) f32 src depth in its rect frame
                                  # (zeros unless a geom pass)
    R2r: torch.Tensor          # (3, 3) ref-cam -> rect rotation
    f: torch.Tensor            # () rect focal
    cx: torch.Tensor           # () rect principal point
    cy: torch.Tensor
    b: torch.Tensor            # () baseline (src at +x)
    f_vy: torch.Tensor         # orig -> rect transport: vertical-pass rows
    f_hx: torch.Tensor         #                         horizontal-pass cols
    b_vy: torch.Tensor         # rect -> orig transport
    b_hx: torch.Tensor
    orig_ok: torch.Tensor      # (H, W) f32 1 where the orig px maps into the
                               # rect frame
    H_ref: torch.Tensor        # (3, 3) f32 orig ref pixel -> rect pixel


class RectStatics(NamedTuple):
    """Per-problem layout constants."""

    f_transposed: Tuple[bool, ...]   # per view, forward warp
    b_transposed: Tuple[bool, ...]   # per view, backward warp
    hp: int
    wp: int


class RectHost(NamedTuple):
    """Host-side product of :func:`build_rect_host`."""

    pairs: tuple                     # per-view rectify.RectPair
    fwd: tuple                       # per-view WarpFields (orig -> rect)
    bwd: tuple                       # per-view WarpFields (rect -> orig)
    sfwd: tuple                      # per-view WarpFields (src orig -> rect)
    statics: RectStatics


def _src_warp_fields(pair: rectify.RectPair, width: int, height: int,
                     device=None):
    return rectify.build_warp_fields(pair.H_src, width, height,
                                     pair.width, pair.height, device)


def build_rect_host(cameras: Sequence, width: int, height: int, v_pad: int,
                    max_scale: float = 1.6,
                    force_size: Optional[Tuple[int, int]] = None,
                    device=None) -> RectHost:
    """Rectify every (ref, src) pair of a problem; the result is host-side
    (numpy), its warp fields evaluated on ``device`` (the CPU by default).

    ``cameras``: [ref, src...] objects with .K/.R/.t numpy arrays. Padding
    views replicate the last real pair (masked out at cost time by
    ``view_valid``). ``force_size=(wp, hp)`` forces a common rect frame."""
    ref = cameras[0]
    pairs = []
    for src in cameras[1:]:
        pairs.append(rectify.build_rect_pair(
            ref.K, ref.R, ref.t, src.K, src.R, src.t, width, height,
            max_scale=max_scale))
    if not pairs:
        raise ValueError("problem has no source views")
    while len(pairs) < v_pad:
        pairs.append(pairs[-1])
    pairs = pairs[:v_pad]

    if force_size is not None:
        wp, hp = force_size
    else:
        hp = max(p.height for p in pairs)
        wp = max(p.width for p in pairs)
    rebuilt = []
    for p, src in zip(pairs, (list(cameras[1:]) + [cameras[-1]] * v_pad)):
        rebuilt.append(rectify.build_rect_pair(
            ref.K, ref.R, ref.t, src.K, src.R, src.t, width, height,
            max_scale=max_scale, force_size=(wp, hp)))
    pairs = rebuilt

    fwd, bwd, sfwd = [], [], []
    for p in pairs:
        fwd.append(rectify.build_warp_fields(p.H_ref, width, height, wp, hp,
                                             device))
        bwd.append(rectify.build_warp_fields(
            np.linalg.inv(p.H_ref), wp, hp, width, height, device))
        sfwd.append(_src_warp_fields(p, width, height, device))
    statics = RectStatics(
        f_transposed=tuple(w.transposed_input for w in fwd),
        b_transposed=tuple(w.transposed_input for w in bwd),
        hp=hp, wp=wp,
    )
    return RectHost(pairs=tuple(pairs), fwd=tuple(fwd), bwd=tuple(bwd),
                    sfwd=tuple(sfwd), statics=statics)


# ---------------------------------------------------------------------------
# Per-view warps
# ---------------------------------------------------------------------------

def warp_fwd_channels(rv: RectView, statics: RectStatics, i: int,
                      chans: torch.Tensor, nearest: bool = True
                      ) -> torch.Tensor:
    """(C, H, W) orig-grid channels -> (C, Hp, Wp) in rv's rect frame."""
    return warp_ops.warp_channels(
        chans, rv.f_vy, rv.f_hx, transposed_input=statics.f_transposed[i],
        nearest=nearest)


def warp_bwd(rv: RectView, statics: RectStatics, i: int, img: torch.Tensor,
             nearest: bool = True) -> torch.Tensor:
    """(Hp, Wp) rect field -> (H, W) orig grid."""
    return warp_ops.warp_separable(
        img, rv.b_vy, rv.b_hx, transposed_input=statics.b_transposed[i],
        nearest=nearest)


def warp_bwd_channels(rv: RectView, statics: RectStatics, i: int,
                      chans: torch.Tensor, nearest: bool = True
                      ) -> torch.Tensor:
    """(C, Hp, Wp) rect channels -> (C, H, W) orig grid."""
    return warp_ops.warp_channels(
        chans, rv.b_vy, rv.b_hx, transposed_input=statics.b_transposed[i],
        nearest=nearest)


def warp_bwd_channels_strided(rv: RectView, statics: RectStatics, i: int,
                              chans: torch.Tensor, stride: int
                              ) -> torch.Tensor:
    """(C, Hp//stride, Wp//stride) rect-subgrid channels -> (C, H, W) orig
    grid, nearest: subsampled vertical-pass columns and stride-scaled index
    values."""
    if stride == 1:
        return warp_bwd_channels(rv, statics, i, chans)
    s = 1.0 / stride
    return warp_ops.warp_channels(
        chans, rv.b_vy[:, ::stride] * s, rv.b_hx * s,
        transposed_input=statics.b_transposed[i], nearest=True)


def build_rect_views(rh: RectHost, images: np.ndarray, device,
                     src_depths=None, cameras: Optional[Sequence] = None
                     ) -> Tuple[RectView, ...]:
    """Warp the images into the rect frames and assemble the RectView tuple.
    ``images`` (1 + n_src, H, W) float32 host images; ``src_depths``
    (n_src, H, W) source depth maps of a geom pass, with ``cameras``
    [ref, src...] (see :func:`rectify_src_depths`)."""
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    n_src = images.shape[0] - 1
    ref_img = t(images[0])
    views = []
    for i, (pair, wf, wb) in enumerate(zip(rh.pairs, rh.fwd, rh.bwd)):
        src_i = min(i, n_src - 1)
        sf = rh.sfwd[i]
        ref_r = warp_ops.warp_separable(
            ref_img, t(wf.vpass_y), t(wf.hpass_x),
            transposed_input=wf.transposed_input)
        src_r = warp_ops.warp_separable(
            t(images[1 + src_i]), t(sf.vpass_y), t(sf.hpass_x),
            transposed_input=sf.transposed_input)
        views.append(RectView(
            ref_rect=ref_r,
            src_rect=src_r,
            ref_ok=t(wf.valid.astype(np.float32)),
            src_ok=t(sf.valid.astype(np.float32)),
            src_depth_rect=torch.zeros_like(ref_r),
            R2r=t(pair.R2r.astype(np.float32)),
            f=t(np.float32(pair.f)),
            cx=t(np.float32(pair.cx)),
            cy=t(np.float32(pair.cy)),
            b=t(np.float32(pair.b)),
            f_vy=t(wf.vpass_y),
            f_hx=t(wf.hpass_x),
            b_vy=t(wb.vpass_y),
            b_hx=t(wb.hpass_x),
            orig_ok=t(wb.valid.astype(np.float32)),
            H_ref=t(pair.H_ref.astype(np.float32)),
        ))
    views = tuple(views)
    if src_depths is not None:
        views = rectify_src_depths(views, rh, src_depths, cameras)
    return views


def rectify_src_depths(views: Tuple[RectView, ...], rh: RectHost,
                       src_depths, cameras: Sequence
                       ) -> Tuple[RectView, ...]:
    """Warp the source views' depth maps into each view's rect frame (geom
    passes). ``src_depths`` (n_src, H, W) host array or tensor, in each
    source's pixel grid along its z-axis; the rect frame needs z along the
    rect z-axis, ``z_rect = depth * (r3 . p~_src)`` with a static factor
    field per pair (:func:`..geometry.rectify.src_depth_factor`). Nearest
    warp, zero outside the source's content."""
    dev = views[0].ref_rect.device
    deps = torch.as_tensor(np.asarray(src_depths) if not isinstance(
        src_depths, torch.Tensor) else src_depths, dtype=torch.float32,
        device=dev)
    n_src = deps.shape[0]
    H, W = deps.shape[1:]
    out = []
    for i, rv in enumerate(views):
        src_i = min(i, n_src - 1)
        sf = rh.sfwd[i]
        factor = rectify.src_depth_factor(rh.pairs[i], cameras[1 + src_i].K,
                                          W, H, dev)
        dep_r = warp_ops.warp_separable(
            deps[src_i] * factor, torch.as_tensor(sf.vpass_y, device=dev),
            torch.as_tensor(sf.hpass_x, device=dev),
            transposed_input=sf.transposed_input, nearest=True)
        ok = torch.as_tensor(sf.valid, device=dev)
        out.append(dataclasses.replace(
            rv, src_depth_rect=torch.where(ok, dep_r,
                                           torch.zeros_like(dep_r))))
    return tuple(out)


# ---------------------------------------------------------------------------
# View-stacked operands: every view in one kernel launch
# ---------------------------------------------------------------------------
#
# The row-gather kernels treat rows independently, so the V views' rectified
# frames (which share one (Hp, Wp) thanks to build_rect_host's common frame)
# stack along the row axis: one (V*Hp, Wp) operand, one launch for all views.


class _WarpGroup(NamedTuple):
    """Views sharing one warp orientation, stacked for one launch pair."""

    idx: Tuple[int, ...]
    transposed: bool
    vy: torch.Tensor               # (g, h_out, w_in)
    hx: torch.Tensor               # (g, h_out, w_out)


@dataclasses.dataclass
class RectStack:
    """View-stacked device operands of a problem's RectView tuple."""

    ref_rect: torch.Tensor       # (V, Hp, Wp)
    src_rect: torch.Tensor       # (V, Hp, Wp)
    ref_ok: torch.Tensor         # (V, Hp, Wp)
    src_ok: torch.Tensor         # (V, Hp, Wp)
    src_depth: torch.Tensor      # (V, Hp, Wp)
    orig_ok: torch.Tensor        # (V, H, W)
    R2r: torch.Tensor            # (V, 3, 3)
    f: torch.Tensor              # (V, 1, 1)
    cx: torch.Tensor             # (V, 1, 1)
    cy: torch.Tensor             # (V, 1, 1)
    b: torch.Tensor              # (V, 1, 1)
    fwd: Tuple[_WarpGroup, ...]
    bwd: Tuple[_WarpGroup, ...]
    # Per-row valid source-column interval of src_ok (a homography-warped
    # rectangle's per-row valid set is convex): the center-validity lookup
    # becomes two compares.
    src_lo: torch.Tensor         # (V, Hp, 1) f32
    src_hi: torch.Tensor         # (V, Hp, 1) f32


def _groups(flag_list, vys, hxs):
    out = []
    for val in (False, True):
        idx = tuple(i for i, t in enumerate(flag_list) if t == val)
        if idx:
            out.append(_WarpGroup(idx, val,
                                  torch.stack([vys[i] for i in idx]),
                                  torch.stack([hxs[i] for i in idx])))
    return tuple(out)


def build_rect_stack(views: Tuple[RectView, ...],
                     statics: RectStatics) -> RectStack:
    """Assemble the view-stacked operands."""
    def scal(g):
        return torch.stack([g(rv) for rv in views])[:, None, None]

    fwd = _groups(statics.f_transposed, [rv.f_vy for rv in views],
                  [rv.f_hx for rv in views])
    bwd = _groups(statics.b_transposed, [rv.b_vy for rv in views],
                  [rv.b_hx for rv in views])
    src_ok = torch.stack([rv.src_ok for rv in views])
    okb = (src_ok > 0.5).to(torch.uint8)
    Wp = src_ok.shape[-1]
    any_ok = okb.amax(dim=-1, keepdim=True) > 0
    lo = okb.argmax(dim=-1, keepdim=True)
    hi = Wp - 1 - okb.flip(-1).argmax(dim=-1, keepdim=True)
    src_lo = torch.where(any_ok, lo, torch.ones_like(lo)).to(torch.float32)
    src_hi = torch.where(any_ok, hi, torch.zeros_like(hi)).to(torch.float32)
    return RectStack(
        ref_rect=torch.stack([rv.ref_rect for rv in views]),
        src_rect=torch.stack([rv.src_rect for rv in views]),
        ref_ok=torch.stack([rv.ref_ok for rv in views]),
        src_ok=src_ok,
        src_depth=torch.stack([rv.src_depth_rect for rv in views]),
        orig_ok=torch.stack([rv.orig_ok for rv in views]),
        R2r=torch.stack([rv.R2r for rv in views]),
        f=scal(lambda rv: rv.f), cx=scal(lambda rv: rv.cx),
        cy=scal(lambda rv: rv.cy), b=scal(lambda rv: rv.b),
        fwd=fwd, bwd=bwd, src_lo=src_lo, src_hi=src_hi,
    )


def _stack_warp(imgs, vys, hxs, nearest):
    """One launch pair warping N images by N separable warp fields.

    imgs (N, H_in, W_in); vys (N, h_out, w_in); hxs (N, h_out, w_out)."""
    N, h_in, w_in = imgs.shape
    h_out, w_out = hxs.shape[1:]
    imgT = imgs.transpose(1, 2).reshape(N * w_in, h_in).contiguous()
    vyT = vys.transpose(1, 2).reshape(N * w_in, h_out).contiguous()
    if nearest:
        tmpT = rowgather.row_gather(imgT, torch.round(vyT).to(torch.int32))
    else:
        tmpT = rowgather.bilinear_x(imgT, vyT)
    tmp = tmpT.reshape(N, w_in, h_out).transpose(1, 2) \
        .reshape(N * h_out, w_in).contiguous()
    hx = hxs.reshape(N * h_out, w_out).contiguous()
    if nearest:
        out = rowgather.row_gather(tmp, torch.round(hx).to(torch.int32))
    else:
        out = rowgather.bilinear_x(tmp, hx)
    return out.reshape(N, h_out, w_out)


def _warp_groups(groups: Tuple[_WarpGroup, ...], chans: torch.Tensor,
                 nearest: bool, stride: int = 1) -> torch.Tensor:
    """(V, C, H_in, W_in) channels -> (V, C, h_out, w_out) through the
    grouped per-view warp fields (<= 2 launch pairs for all V*C channels).

    ``stride > 1``: the inputs live on the warp's stride-subgrid — the field
    columns are subsampled and index values scaled."""
    V, C = chans.shape[:2]
    h_out, w_out = groups[0].hx.shape[1:]
    outs = [None] * V
    s = 1.0 / stride
    for grp in groups:
        sub = chans[list(grp.idx)]                       # (g, C, H, W)
        vy, hx = grp.vy, grp.hx
        if stride > 1:
            vy = vy[:, :, ::stride] * s
            hx = hx * s
        if grp.transposed:
            sub = sub.transpose(2, 3)
        g = len(grp.idx)
        imgs = sub.reshape(g * C, *sub.shape[2:])
        vys = vy.repeat_interleave(C, dim=0)
        hxs = hx.repeat_interleave(C, dim=0)
        out = _stack_warp(imgs, vys, hxs, nearest).reshape(g, C, h_out, w_out)
        for j, i in enumerate(grp.idx):
            outs[i] = out[j]
    return torch.stack(outs)


@dataclasses.dataclass
class EvalCache:
    """Candidate-independent pieces of the stacked cost evaluation, built
    once per stage and shared by every evaluation in it (the ref-side window
    weights and the shifted source rows). For ``stride > 1`` everything is
    stored pre-subsampled."""

    stride: int
    fwd: Tuple[_WarpGroup, ...]   # forward groups, output-strided
    ref_ok: torch.Tensor          # (V, Hs, Ws) f32
    src_lo: torch.Tensor          # (V, Hs, 1)
    src_hi: torch.Tensor
    src_rows: Tuple[torch.Tensor, ...]   # per oy: (V, Hs, Wp) shifted rows
    w: Tuple[torch.Tensor, ...]          # per (oy, ox): (V, Hs, Ws)
    wr: Tuple[torch.Tensor, ...]         # per (oy, ox): w * ref_s
    inv_w: torch.Tensor           # (V, Hs, Ws)
    m_ref: torch.Tensor
    var_ref: torch.Tensor
    src_depth: Optional[torch.Tensor]    # (V, Hs, Wp) row-subsampled (geom)


def _row_offsets(offsets: np.ndarray):
    """[(oy, [ox...]), ...] in sorted oy order."""
    oys = sorted(set(float(o[1]) for o in offsets))
    return [(oy, [float(o[0]) for o in offsets if float(o[1]) == oy])
            for oy in oys]


def _strided_groups(groups, stride):
    return tuple(g._replace(vy=g.vy[:, ::stride],
                            hx=g.hx[:, ::stride, ::stride]) for g in groups)


def build_eval_cache(stack: RectStack, params: PatchMatchParams,
                     offsets: np.ndarray, stride: int = 1,
                     geom: bool = False,
                     budget_bytes: float = 2.2e9) -> Optional[EvalCache]:
    """Build the per-stage EvalCache, or None when the cached fields would
    exceed ``budget_bytes`` (evaluations then recompute inline)."""
    V, Hp, Wp = stack.src_rect.shape
    Hs, Ws = -(-Hp // stride), -(-Wp // stride)
    rows = _row_offsets(offsets)
    total = (2 * len(offsets) + 3) * V * Hs * Ws * 4 + \
        len(rows) * V * Hs * Wp * 4
    if total > budget_bytes:
        return None

    def sub(a):
        return a[..., ::stride, ::stride] if stride > 1 else a

    def subr(a):
        return a[..., ::stride, :] if stride > 1 else a

    fwd = _strided_groups(stack.fwd, stride) if stride > 1 else stack.fwd
    inv_2ss = 1.0 / (2.0 * params.sigma_spatial * params.sigma_spatial)
    inv_2sc = 1.0 / (2.0 * params.sigma_color * params.sigma_color)
    ref_c = sub(stack.ref_rect)
    src_rows, ws, wrs = [], [], []
    z = torch.zeros((V, Hs, Ws), dtype=torch.float32,
                    device=stack.ref_rect.device)
    sum_w, sum_ref, sum_ref2 = z, z.clone(), z.clone()
    for oy, oxs in rows:
        src_rows.append(subr(_shift3(stack.src_rect, int(oy), 0))
                        .contiguous())
        for ox in oxs:
            ref_s = sub(_shift3(stack.ref_rect, int(oy), int(ox)))
            spatial = float(np.sqrt(ox * ox + oy * oy))
            w = torch.exp(-spatial * inv_2ss
                          - torch.abs(ref_s - ref_c) * inv_2sc)
            wr = w * ref_s
            ws.append(w)
            wrs.append(wr)
            sum_w = sum_w + w
            sum_ref = sum_ref + wr
            sum_ref2 = sum_ref2 + wr * ref_s
    inv_w = 1.0 / sum_w
    m_ref = sum_ref * inv_w
    var_ref = sum_ref2 * inv_w - m_ref * m_ref
    return EvalCache(
        stride=stride, fwd=fwd, ref_ok=sub(stack.ref_ok),
        src_lo=subr(stack.src_lo), src_hi=subr(stack.src_hi),
        src_rows=tuple(src_rows), w=tuple(ws), wr=tuple(wrs),
        inv_w=inv_w, m_ref=m_ref, var_ref=var_ref,
        src_depth=subr(stack.src_depth).contiguous() if geom else None,
    )


def _rotate(R: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(V, 3, 3) x (V, 3, h, w) -> (V, 3, h, w), unrolled."""
    Rv = R[:, :, :, None, None]
    return torch.stack([Rv[:, i, 0] * q[:, 0] + Rv[:, i, 1] * q[:, 1]
                        + Rv[:, i, 2] * q[:, 2] for i in range(3)], dim=1)


def band_rows(V: int, Hs: int, Ws: int) -> Tuple[int, int]:
    """(hb, nb): band height and band count of a (V, Hs, Ws) float32 cost
    field. Fields up to ``BAND_FULL_BYTES`` are one band; larger ones get
    bands of ``BAND_FIELD_BYTES`` per field (a multiple of 8 rows, at least
    8, at most Hs)."""
    if V * Hs * Ws * 4 <= BAND_FULL_BYTES:
        return Hs, 1
    hb = min(max(8, int(BAND_FIELD_BYTES // (V * Ws * 4)) // 8 * 8), Hs)
    return hb, -(-Hs // hb)


def rect_cost_vector_stacked(
    stack: RectStack,
    plane: torch.Tensor,             # (H, W, 4) orig-grid ref-cam plane field
    view_valid: torch.Tensor,        # (V,) bool
    params: PatchMatchParams,
    offsets: np.ndarray,
    geom: bool = False,
    stride: int = 1,
    cache: Optional[EvalCache] = None,
) -> torch.Tensor:
    """(V, H, W) bilateral NCC costs of one plane field against every source
    view, on the original pixel grid; every launch carries all V views.

    ``stride > 1`` evaluates only the rect frame's stride-subgrid of window
    CENTERS (window samples keep full-resolution texture) and
    nearest-upsamples through the backward warp — the candidate-screening
    approximation (strong_rect.screen_stride). ``geom`` adds the
    forward-backward reprojection error times ``params.geom_factor``.

    The rect-frame cost field is evaluated in the row bands of
    :func:`band_rows`: the plane transport, the window sums and the geometric
    term run per band, the last band starting at Hs - hb (its rows overlap
    its neighbour's with the same values). A band reads its shifted texture
    rows by clamped row indices, so no padded copy of a texture is made."""
    V, Hp, Wp = stack.src_rect.shape
    H, W = plane.shape[:2]
    dev = plane.device
    if cache is not None:
        assert cache.stride == stride

    def sub(a):
        return a[..., ::stride, ::stride] if stride > 1 else a

    def subr(a):
        return a[..., ::stride, :] if stride > 1 else a

    # Transport n/d (the disparity coefficients are linear in n/d and the
    # cheirality sign is sign(-1 / (n/d . dir))); rotation into each rect
    # frame happens after the warp.
    d_o = plane[..., 3]
    q_o = plane[..., :3] / torch.where(d_o.abs() < 1e-30,
                                       torch.full_like(d_o, 1e-30),
                                       d_o)[..., None]       # (H, W, 3)
    chans = q_o.permute(2, 0, 1)[None].expand(V, 3, H, W)
    if cache is not None:
        fwd_groups = cache.fwd
    elif stride > 1:
        fwd_groups = _strided_groups(stack.fwd, stride)
    else:
        fwd_groups = stack.fwd

    Hs, Ws = -(-Hp // stride), -(-Wp // stride)
    u = (torch.arange(Ws, dtype=torch.float32, device=dev)
         * stride)[None, None, :]
    if cache is not None:
        ref_oks, lo_s, hi_s = cache.ref_ok, cache.src_lo, cache.src_hi
        inv_ws, m_refs, var_refs = cache.inv_w, cache.m_ref, cache.var_ref
    else:
        ref_oks = sub(stack.ref_ok)
        lo_s, hi_s = subr(stack.src_lo), subr(stack.src_hi)
        inv_2ss = 1.0 / (2.0 * params.sigma_spatial * params.sigma_spatial)
        inv_2sc = 1.0 / (2.0 * params.sigma_color * params.sigma_color)
        ref_cs = sub(stack.ref_rect)
    if geom:
        deps = (cache.src_depth if cache is not None
                and cache.src_depth is not None else subr(stack.src_depth))
    rows = _row_offsets(offsets)
    hb, nb = band_rows(V, Hs, Ws)
    # Offsets per bilinear_x launch, so that its (V, hb, k, Ws) queries and
    # samples stay within GATHER_BYTES each.
    k_cap = max(1, int(GATHER_BYTES // (V * hb * Ws * 4)))

    def band(r0):
        """Rows [r0, r0 + hb) of the (V, Hs, Ws) rect-frame cost field."""
        def rs(a):                                   # the band's rows of a
            return a[:, r0:r0 + hb]

        def texture_rows(img, oy):
            """Rows stride * (r0 + i) + oy of a (V, Hp, Wp) texture, edge-
            clamped (= subr(shift(img, oy, 0)) at the band's rows)."""
            r = (torch.arange(hb, device=dev) + r0) * stride + int(oy)
            return img.index_select(1, r.clamp(0, Hp - 1))

        fwd_b = tuple(g._replace(vy=g.vy[:, r0:r0 + hb],
                                 hx=g.hx[:, r0:r0 + hb]) for g in fwd_groups)
        qw = _warp_groups(fwd_b, chans, nearest=True)        # (V, 3, hb, Ws)
        nq = _rotate(stack.R2r, qw)
        gx = stack.b * nq[:, 0]
        gy = stack.b * nq[:, 1]
        g0 = stack.b * stack.f * nq[:, 2]
        v_b = ((torch.arange(hb, dtype=torch.float32, device=dev) + r0)
               * stride)[None, :, None]

        # Depth sign (cheirality) at the window center.
        denom_q = (nq[:, 0] * (u - stack.cx)
                   + nq[:, 1] * (v_b - stack.cy)) / stack.f + nq[:, 2]
        z_pos = denom_q < 0
        xs_c = u + gx * (u - stack.cx) + gy * (v_b - stack.cy) + g0
        xs_c = torch.where(torch.isfinite(xs_c), xs_c,
                           torch.full_like(xs_c, -1.0))
        # Center validity via the per-row valid interval of src_ok.
        valid = (rs(ref_oks) > 0.5) & z_pos & \
            (xs_c >= rs(lo_s).clamp(min=0.0)) & \
            (xs_c < rs(hi_s) + 1.0) & (xs_c <= Wp - 1.0)

        z = torch.zeros((V, hb, Ws), dtype=torch.float32, device=dev)
        sum_src, sum_src2, sum_rs = z, z.clone(), z.clone()
        if cache is None:
            sum_w, sum_ref, sum_ref2 = z.clone(), z.clone(), z.clone()
            ref_c = rs(ref_cs)

        flat = 0
        for oy_i, (oy, oxs) in enumerate(rows):
            # Window rows keep full-res texture; only the center rows are
            # subsampled (gathered columns span the full frame width).
            if cache is not None:
                src_row = rs(cache.src_rows[oy_i]).contiguous()
            else:
                src_row = texture_rows(stack.src_rect, oy)
                ref_rows = texture_rows(stack.ref_rect, oy)
            vs = v_b + oy
            for c0 in range(0, len(oxs), k_cap):
                ox_c = oxs[c0:c0 + k_cap]
                xs_list, ref_list, w_list = [], [], []
                for ox in ox_c:
                    us = u + ox
                    xs = us + gx * (us - stack.cx) + gy * (vs - stack.cy) + g0
                    xs_list.append(torch.where(torch.isfinite(xs), xs,
                                               torch.zeros_like(xs)))
                    if cache is None:
                        ref_s = _shift3(ref_rows, 0, int(ox))[..., ::stride]
                        ref_list.append(ref_s)
                        spatial = float(np.sqrt(ox * ox + oy * oy))
                        w_list.append(torch.exp(
                            -spatial * inv_2ss
                            - torch.abs(ref_s - ref_c) * inv_2sc))
                k = len(ox_c)
                # Each chunk's transients are freed before the next's.
                xs_cat = torch.stack(xs_list, dim=2)         # (V, hb, k, Ws)
                del xs_list
                src_s = rowgather.bilinear_x(
                    src_row.reshape(V * hb, Wp),
                    xs_cat.reshape(V * hb, k * Ws)).reshape(V, hb, k, Ws)
                del xs_cat
                for j in range(k):
                    s = src_s[:, :, j]
                    if cache is None:
                        w, r = w_list[j], ref_list[j]
                        wr = w * r
                        sum_w += w
                        sum_ref += wr
                        sum_ref2.addcmul_(wr, r)
                    else:
                        w = rs(cache.w[flat + j])
                        wr = rs(cache.wr[flat + j])
                    ws_ = w * s
                    sum_src += ws_
                    sum_src2.addcmul_(ws_, s)
                    sum_rs.addcmul_(wr, s)
                flat += k
                del src_s, ref_list, w_list

        if cache is None:
            inv_w = 1.0 / sum_w
            m_ref = sum_ref * inv_w
            var_ref = sum_ref2 * inv_w - m_ref * m_ref
        else:
            inv_w, m_ref, var_ref = rs(inv_ws), rs(m_refs), rs(var_refs)
        m_src = sum_src * inv_w
        var_src = sum_src2 * inv_w - m_src * m_src
        covar = sum_rs * inv_w - m_ref * m_src
        den = torch.sqrt(torch.clamp(var_ref * var_src,
                                     min=K_MIN_VAR * K_MIN_VAR))
        nccv = torch.clamp(1.0 - covar / den, 0.0, COST_MAX)
        cmax = torch.full_like(nccv, COST_MAX)
        c = torch.where((var_ref < K_MIN_VAR) | (var_src < K_MIN_VAR), cmax,
                        nccv)
        c = torch.where(valid, c, cmax)

        if geom:
            z_src = rowgather.row_gather(
                rs(deps).contiguous().reshape(V * hb, Wp),
                xs_c.clamp(0.0, Wp - 1).to(torch.int32).reshape(V * hb, Ws)
            ).reshape(V, hb, Ws)
            ok_g = (xs_c >= 0.0) & (xs_c <= Wp - 1.0)
            x_back = xs_c + stack.f * stack.b / torch.where(
                z_src > 0, z_src, torch.full_like(z_src, 1e30))
            err = torch.clamp(torch.abs(x_back - u), max=GEOM_COST_MAX)
            g = torch.where(ok_g & (z_src > 0), err,
                            torch.full_like(err, GEOM_COST_MAX))
            c = c + params.geom_factor * g
        return c

    if nb == 1:
        c = band(0)
    else:
        BRANCHES["banded cost evaluations"] += 1
        BRANCHES["cost bands"] += nb
        c = torch.empty((V, Hs, Ws), dtype=torch.float32, device=dev)
        for b in range(nb):
            r0 = min(b * hb, Hs - hb)
            c[:, r0:r0 + hb] = band(r0)

    back = _warp_groups(stack.bwd, c[:, None], nearest=True,
                        stride=stride)[:, 0]                 # (V, H, W)
    ok = (stack.orig_ok > 0.5) & view_valid[:, None, None]
    cmax_o = COST_MAX + (params.geom_factor * GEOM_COST_MAX if geom else 0.0)
    return torch.where(ok, back, torch.full_like(back, cmax_o))


def plane_to_rect(plane: torch.Tensor, R2r: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 4) plane hypotheses into the rect frame (d invariant)."""
    nr = geo.mat3_vec(R2r.expand(*plane.shape[:-1], 3, 3), plane[..., :3])
    return torch.cat([nr, plane[..., 3:4]], dim=-1)


# ---------------------------------------------------------------------------
# Batched volume evaluation: S plane-coefficient fields through one pass
# ---------------------------------------------------------------------------

def _sweep_ncc_volume(rv: RectView, coeff_fn, S: int, offsets: np.ndarray,
                      sigma_spatial: float, sigma_color: float,
                      with_geom: bool, stride: int = 1):
    """(S, Hp//stride, Wp//stride) window-NCC cost of S plane-coefficient
    fields against rv, sharing the probe-independent ref-side sums across
    all S and batching the source gathers (a chunk of probes x one row of
    window offsets per launch).

    ``coeff_fn(c0, c1) -> (gxs, gys, g0s)`` gives the (c1 - c0, Hs, Ws)
    affine disparity coefficient fields of probes [c0, c1), computed per
    chunk. ``stride > 1`` evaluates the volume only on the rect frame's
    stride-subgrid of window centers (window samples keep full-resolution
    texture). Returns (vol VOL_INVALID-marked, gvol VOL_INVALID-marked or
    None): a probe is valid exactly where vol != VOL_INVALID (its cost is at
    most COST_MAX, or NaN); gvol is the forward-backward reprojection error
    (``ComputeGeomConsistencyCost``, DPE.cu:915-953)."""
    return next(_sweep_ncc_spans(rv, coeff_fn, [(0, S)], offsets,
                                 sigma_spatial, sigma_color, with_geom,
                                 stride))


def _sweep_ncc_spans(rv: RectView, coeff_fn, spans, offsets: np.ndarray,
                     sigma_spatial: float, sigma_color: float,
                     with_geom: bool, stride: int = 1):
    """:func:`_sweep_ncc_volume` one span of probes at a time: yields, for
    each ``(c0, c1)`` of ``spans`` in order, the (vol, gvol) of probes
    [c0, c1), every span sharing one set of ref-side sums. A probe's
    numbers do not depend on the spans."""
    Hp, Wp = rv.ref_rect.shape
    dev = rv.ref_rect.device
    Hs, Ws = Hp // stride, Wp // stride
    u = (torch.arange(Ws, dtype=torch.float32, device=dev) * stride)[None, :]
    v = (torch.arange(Hs, dtype=torch.float32, device=dev) * stride)[:, None]

    def sub(a):
        return a[::stride, ::stride] if stride > 1 else a

    rows = _row_offsets(offsets)
    ref_c = sub(rv.ref_rect)
    inv_2ss = 1.0 / (2.0 * sigma_spatial * sigma_spatial)
    inv_2sc = 1.0 / (2.0 * sigma_color * sigma_color)

    # The reference frame edge-padded once by the window's reach: shifted by
    # a window offset with clamped edges on the stride grid,
    # sub(_shift3(rv.ref_rect, oy, ox)), it is a view of the padded frame.
    reach = int(np.abs(offsets).max())
    ref_pad = torch.nn.functional.pad(rv.ref_rect[None, None], (reach,) * 4,
                                      mode="replicate")[0, 0]

    def ref_at(oy, ox):
        y0, x0 = reach + int(oy), reach + int(ox)
        return ref_pad[y0:y0 + Hs * stride:stride, x0:x0 + Ws * stride:stride]

    # Ref-side sums are probe-independent: one set serves all S probes. Per
    # window offset only its weight w stays; a chunk forms w * ref again
    # where it reads it (the same float32 product: neither a shifted
    # reference frame nor the product per offset fits at full-resolution
    # frames, and the exp is dearer to redo than the product).
    z = torch.zeros((Hs, Ws), dtype=torch.float32, device=dev)
    sum_w, sum_ref, sum_ref2 = z, z.clone(), z.clone()
    ws_by_oy, src_by_oy = [], []
    for oy, oxs in rows:
        src_by_oy.append(_shift3(rv.src_rect, int(oy), 0)[::stride]
                         .contiguous())
        ws = []
        for ox in oxs:
            r = ref_at(oy, ox)
            spatial = float(np.sqrt(ox * ox + oy * oy))
            w = torch.exp(-spatial * inv_2ss - torch.abs(r - ref_c) * inv_2sc)
            wr = w * r
            ws.append(w)
            sum_w = sum_w + w
            sum_ref = sum_ref + wr
            sum_ref2 = sum_ref2 + wr * r
        ws_by_oy.append(ws)
    del r, w, wr
    inv_w = 1.0 / sum_w
    m_ref = sum_ref * inv_w
    var_ref = sum_ref2 * inv_w - m_ref * m_ref
    del sum_w, sum_ref, sum_ref2

    # Probe chunks bounded so the (Hs, sc, k, Ws) gather-index transient
    # stays near GATHER_BYTES; balanced chunk size within each span.
    k_max = max(len(oxs) for _, oxs in rows)
    sc_cap = max(1, min(S_CHUNK, int(GATHER_BYTES // (k_max * Hs * Ws * 4))))
    ref_ok_s = sub(rv.ref_ok)[:, None] > 0.5
    src_ok_rows = rv.src_ok[::stride].contiguous()
    dep_rows = rv.src_depth_rect[::stride].contiguous() if with_geom else None
    vq = v.reshape(Hs, 1, 1)
    uq = u.reshape(1, 1, Ws)

    def chunk(c0, c1):
        """(vol, gvol or None, valid), each (c1 - c0, Hs, Ws)."""
        gxs, gys, g0s = coeff_fn(c0, c1)                     # (n, Hs, Ws)
        n = gxs.shape[0]
        gxs_t = gxs.transpose(0, 1)                          # (Hs, n, Ws)
        gys_t = gys.transpose(0, 1)
        g0s_t = g0s.transpose(0, 1)
        zc = torch.zeros((Hs, n, Ws), dtype=torch.float32, device=dev)
        sum_src, sum_src2, sum_rs = zc, zc.clone(), zc.clone()
        for (oy, oxs), src_rows, ws in zip(rows, src_by_oy, ws_by_oy):
            k = len(oxs)
            us = u[0][None, :] + torch.tensor(oxs, dtype=torch.float32,
                                              device=dev)[:, None]
            us4 = us[None, None]                             # (1, 1, k, Ws)
            xs4 = us4 + gxs_t[:, :, None] * (us4 - rv.cx) + \
                (gys_t * (vq + (oy - rv.cy)))[:, :, None] + \
                g0s_t[:, :, None]                            # (Hs, n, k, Ws)
            xs4 = torch.where(torch.isfinite(xs4), xs4, torch.zeros_like(xs4))
            src = rowgather.bilinear_x(
                src_rows, xs4.reshape(Hs, n * k * Ws).contiguous())
            src = src.reshape(Hs, n, k, Ws)
            for j in range(k):
                w = ws[j]
                s_j = src[:, :, j]                           # (Hs, n, Ws)
                ws_ = w[:, None] * s_j
                sum_src += ws_
                sum_src2.addcmul_(ws_, s_j)
                sum_rs.addcmul_((w * ref_at(oy, oxs[j]))[:, None], s_j)

        iw = inv_w[:, None]
        m_src = sum_src * iw
        var_src = sum_src2 * iw - m_src * m_src
        covar = sum_rs * iw - m_ref[:, None] * m_src
        den = torch.sqrt(torch.clamp(var_ref[:, None] * var_src,
                                     min=K_MIN_VAR ** 2))
        cost_c = torch.clamp(1.0 - covar / den, 0.0, COST_MAX)
        cost_c = torch.where((var_ref[:, None] < K_MIN_VAR) |
                             (var_src < K_MIN_VAR),
                             torch.full_like(cost_c, COST_MAX), cost_c)

        # Center validity per probe (DPE.cu:577-580 + rect content masks).
        d_c = gxs_t * (uq - rv.cx) + gys_t * (vq - rv.cy) + g0s_t
        d_c = torch.where(torch.isfinite(d_c), d_c, torch.full_like(d_c, BIG))
        xs_c = uq + d_c
        xs_i = xs_c.reshape(Hs, n * Ws).clamp(0.0, Wp - 1).to(torch.int32) \
            .contiguous()
        src_ok_c = rowgather.row_gather(src_ok_rows, xs_i).reshape(Hs, n, Ws)
        # Cheirality: with the source at +x, a point in front of the cameras
        # has disparity -f*b/z < 0.
        valid = ref_ok_s & (src_ok_c > 0.5) & (xs_c >= 0.0) & \
            (xs_c <= Wp - 1.0) & (d_c < 0)
        vol = torch.where(valid, cost_c, torch.full_like(cost_c, VOL_INVALID))
        gvol = None
        if with_geom:
            z_src = rowgather.row_gather(dep_rows, xs_i).reshape(Hs, n, Ws)
            x_back = xs_c + rv.f * rv.b / torch.where(
                z_src > 0, z_src, torch.full_like(z_src, 1e30))
            err = torch.clamp(torch.abs(x_back - uq), max=GEOM_COST_MAX)
            err = torch.where((z_src > 0) & valid, err,
                              torch.full_like(err, GEOM_COST_MAX))
            gvol = torch.where(valid, err, torch.full_like(
                err, VOL_INVALID)).transpose(0, 1)
        return vol.transpose(0, 1), gvol

    def span(s0, s1):
        n_chunks = -(-(s1 - s0) // sc_cap)
        sc = -(-(s1 - s0) // n_chunks)
        vol = torch.empty((s1 - s0, Hs, Ws), dtype=torch.float32, device=dev)
        gvol = torch.empty_like(vol) if with_geom else None
        for c0 in range(s0, s1, sc):
            c1 = min(s1, c0 + sc)
            v_, g_ = chunk(c0, c1)
            vol[c0 - s0:c1 - s0] = v_
            if with_geom:
                gvol[c0 - s0:c1 - s0] = g_
        return vol, gvol

    # A span's volumes are bound to no name here while the caller holds them.
    for s0, s1 in spans:
        yield span(s0, s1)
