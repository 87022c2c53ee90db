"""Static window shifts and point gathers of images and fields.

Port of the pieces of :mod:`dpe_mvs_tpu.ops.sampling` that the rectified
engine reaches:

  - :func:`shift`, the clamp-padded static shift used for reference-image
    window reads and cost-map neighbourhood scans (last two axes of a tensor
    of any rank);
  - :func:`gather_map`, the clamped 2-D point gather of the weak-texture
    machinery, through the channel-last ``gather2d_hwc`` kernel;
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
