"""Image sampling: static window shifts and point gathers of images and
fields.

Port of :mod:`dpe_mvs_tpu.ops.sampling`:

  - :func:`shift`, the clamp-padded static shift used for reference-image
    window reads and cost-map neighbourhood scans (last two axes of a tensor
    of any rank);
  - :func:`gather_map`, the clamped 2-D point gather, through the
    channel-last ``gather2d_hwc`` kernel; :func:`lookup_int` and
    :func:`nearest` are gathers of one channel;
  - :func:`bilinear`, clamp-to-edge bilinear sampling (CUDA ``tex2D``
    linear filtering at ``(x + 0.5, y + 0.5)``). Its four texels come from a
    :func:`corner_map` of the image, (H, W, 4), read by one ``gather2d_hwc``
    launch of 16 bytes per sample, :func:`gather_2x2` (the JAX package's
    four flat takes there were a TPU layout choice);
  - :func:`to_int32`, the float -> int32 cast as XLA performs it;
  - :func:`take_last` / :func:`pick_last`, picks along a small last axis
    (``torch.gather``; the JAX package's one-hot chain there is a TPU
    workaround).
"""
from __future__ import annotations

import math

import torch

from . import gather2d as g2d


def _shift_axis(a: torch.Tensor, d: int, dim: int, fill=None) -> torch.Tensor:
    """result[..., i, ...] = a[..., i + d, ...] along ``dim``; out-of-range
    reads take the edge value (``fill=None``) or ``fill``."""
    if d == 0:
        return a
    n = a.shape[dim]
    k = min(abs(d), n)
    if fill is None:
        edge = a.narrow(dim, n - 1 if d > 0 else 0, 1)
        shape = list(a.shape)
        shape[dim] = k
        pad = edge.expand(shape)
    else:
        shape = list(a.shape)
        shape[dim] = k
        pad = torch.full(shape, fill, dtype=a.dtype, device=a.device)
    if d > 0:
        return torch.cat([a.narrow(dim, k, n - k), pad], dim=dim)
    return torch.cat([pad, a.narrow(dim, 0, n - k)], dim=dim)


def shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Static clamp-padded shift on the last two axes:
    result[..., y, x] = img[..., clamp(y+dy), clamp(x+dx)]."""
    out = _shift_axis(img, int(dy), img.dim() - 2)
    return _shift_axis(out, int(dx), img.dim() - 1)


def to_int32(x: torch.Tensor, rounding: bool = False) -> torch.Tensor:
    """Float -> int32 as XLA converts (``astype(int32)``): truncated toward
    zero (``rounding=True``: rounded half to even first), saturated to the
    int32 range, NaN to 0. A plain ``.to(torch.int32)`` of NaN or of a value
    past 2^31 is undefined in C++ and differs between the CPU and the
    card."""
    r = torch.round(x) if rounding else torch.trunc(x)
    r = torch.where(torch.isnan(r), 0.0, r.clamp(-2.0 ** 31, 2.0 ** 31))
    return r.to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32)


def gather_map(arr: torch.Tensor, iy: torch.Tensor,
               ix: torch.Tensor) -> torch.Tensor:
    """arr[(iy, ix)] with clamp; arr (H, W, ...) and integer index tensors of
    a common (broadcast) shape S -> (*S, ...).

    Goes through :func:`.gather2d.gather2d_hwc`: the CUDA kernel on a CUDA
    tensor, its plain version on the CPU. The array stays channel-last and
    keeps its dtype (a bool or uint8 map moves as bytes); a view whose
    trailing axes are contiguous among themselves is read in place, any
    other layout is copied to a contiguous one first."""
    H, W = arr.shape[:2]
    iy, ix = torch.broadcast_tensors(iy, ix)
    trail = tuple(arr.shape[2:])
    img = arr.reshape(H, W, math.prod(trail))
    if img.shape[2] > 1 and img.stride(2) != 1:
        img = img.contiguous()
    out = g2d.gather2d_hwc(img, iy.to(torch.int32).contiguous(),
                           ix.to(torch.int32).contiguous())
    return out.reshape(*iy.shape, *trail)


def lookup_int(img: torch.Tensor, ix: torch.Tensor,
               iy: torch.Tensor) -> torch.Tensor:
    """Integer lookup with clamp for any dtype: img (H, W), ix/iy integer
    tensors of a common (broadcast) shape."""
    return gather_map(img, iy, ix)


def nearest(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            view=None) -> torch.Tensor:
    """Nearest (truncating) lookup with clamp, as the reference's integer
    depth-map reads: ``tex2D(depth, (int)x + 0.5, (int)y + 0.5)``
    (DPE.cu:936).

    img (H, W), or (V, H, W) with ``view`` an integer tensor broadcastable
    to x holding each sample's view index."""
    H, W = img.shape[-2:]
    ix = to_int32(x).clamp(0, W - 1)
    iy = to_int32(y).clamp(0, H - 1)
    if view is not None:
        iy = iy + view * H
    return gather_map(img.reshape(-1, W), iy, ix)


def corner_map(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H, W, 4): the texels ``[img[y, x], img[y, x+1],
    img[y+1, x], img[y+1, x+1]]`` of every bilinear cell, edge-clamped.
    Built once per image and sweep; :func:`bilinear` reads a sample's four
    with one 16-byte gather."""
    right = shift(img, 0, 1)
    return torch.stack([img, right, shift(img, 1, 0), shift(right, 1, 0)],
                       dim=-1).contiguous()


def gather_2x2(corners: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
               view=None):
    """The 2x2 patch corners ``img[y0:y0+2, x0:x0+2]`` per index pair, read
    from the image's (..., H, W, 4) :func:`corner_map`: y0/x0 int32 already
    clamped to [0, H-2] / [0, W-2]; ``view`` as in :func:`nearest`. Returns
    (p00, p01, p10, p11)."""
    H, W = corners.shape[-3:-1]
    if view is not None:
        y0 = y0 + view * H
    c = gather_map(corners.reshape(-1, W, 4), y0, x0)
    return c.unbind(-1)


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             corners: torch.Tensor, view=None) -> torch.Tensor:
    """Clamp-to-edge bilinear sample of ``img`` at float coords (x, y), as
    CUDA ``tex2D`` linear filtering with unnormalized coordinates and clamp
    addressing at (x + 0.5, y + 0.5): integer coordinates hit texel centers
    exactly.

    img (H, W), or (V, H, W) with ``view`` as in :func:`nearest`;
    ``corners`` its :func:`corner_map`. The lerps are written op by op as
    the JAX package writes them (no fused multiply-add)."""
    H, W = img.shape[-2:]
    x = x.clamp(0.0, W - 1.0)
    y = y.clamp(0.0, H - 1.0)
    x0f = torch.floor(x).clamp(0.0, W - 2.0) if W > 1 else \
        torch.zeros_like(x)
    y0f = torch.floor(y).clamp(0.0, H - 2.0) if H > 1 else \
        torch.zeros_like(y)
    fx = x - x0f
    fy = y - y0f
    p00, p01, p10, p11 = gather_2x2(corners, to_int32(y0f), to_int32(x0f),
                                    view)
    gx = 1.0 - fx
    top = p00 * gx + p01 * fx
    bot = p10 * gx + p11 * fx
    return top * (1.0 - fy) + bot * fy


def spans(n: int, item_bytes: float, cap: float):
    """[a, b) ranges over n items of ``item_bytes`` each, balanced, every
    range within ``cap`` bytes (at least one item): the chunks and row bands
    that bound memory at full-resolution frames."""
    per = n if n * item_bytes <= cap else max(1, int(cap // item_bytes))
    size = -(-n // -(-n // per))
    return [(a, min(a + size, n)) for a in range(0, n, size)]


def take_last(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(arr, idx, axis=-1)``: arr (..., P), idx (..., K)
    integer -> (..., K)."""
    shape = torch.broadcast_shapes(arr.shape[:-1], idx.shape[:-1])
    return torch.gather(arr.expand(*shape, arr.shape[-1]), -1,
                        idx.long().expand(*shape, idx.shape[-1]))


def pick_last(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One pick per element along the last axis: arr (..., P), idx (...)
    integer -> (...)."""
    return take_last(arr, idx[..., None])[..., 0]
