"""Scattered 2-D point gather: the anchor reads of the weak-texture machinery.

Port of :mod:`dpe_mvs_tpu.ops.gather2d`: one hand-written CUDA kernel for
Hopper (``csrc/gather2d.cu``) with a plain PyTorch version beside it,

    gather2d(imgs, iy, ix)  out[c, i, j] = imgs[c, clamp(iy[i, j]),
                                                 clamp(ix[i, j])]

The JAX package has two TPU kernels for this function (the image channel in
VMEM or in HBM); the CUDA kernel computes the same function for both.

The wrapper takes the plain version for a tensor on the CPU and launches the
kernel for a tensor on a CUDA device; it never falls back from one to the
other. ``LAUNCHES`` counts kernel launches.

``pack_bf16_pairs`` / ``unpack_bf16_pairs`` carry two bf16 channels in one
32-bit word (a bitcast, no arithmetic), so a bf16 volume moves through the
32-bit gather at half the bytes of its float32 form.
"""
from __future__ import annotations

import ctypes

import torch

from . import cudalib

SOURCE = cudalib.CSRC / "gather2d.cu"

# Kernel launches since the last reset_launches().
LAUNCHES = {"gather2d": 0}

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
         ctypes.c_void_p]
_WORDS = (torch.float32, torch.int32, torch.uint32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False):
    """Compile ``csrc/gather2d.cu`` (if the cached build is stale) and return
    the shared library's path. Raises on a failed build."""
    return cudalib.build_many([SOURCE], verbose)[0]


def _load():
    return cudalib.load(SOURCE, {"dpe_gather2d": _ARGS})


def pack_bf16_pairs(x: torch.Tensor) -> torch.Tensor:
    """(C, ...) float -> (C//2, ...) int32 words, each holding the bf16
    values of channels (2k, 2k+1)."""
    assert x.shape[0] % 2 == 0
    xb = x.to(torch.bfloat16)
    pairs = torch.stack([xb[0::2], xb[1::2]], dim=-1).contiguous()
    return pairs.view(torch.int32)[..., 0]


def unpack_bf16_pairs(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bf16_pairs`: (C2, ...) int32 -> (2*C2, ...)
    bf16."""
    b = p.contiguous()[..., None].view(torch.bfloat16)       # (C2, ..., 2)
    out = torch.stack([b[..., 0], b[..., 1]], dim=1)         # (C2, 2, ...)
    return out.reshape((2 * p.shape[0],) + tuple(p.shape[1:]))


def gather2d_ref(imgs: torch.Tensor, iy: torch.Tensor,
                 ix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather2d` (the same clamps)."""
    squeeze = imgs.dim() == 2
    if squeeze:
        imgs = imgs[None]
    _C, H, W = imgs.shape
    words = imgs.view(torch.int32) if imgs.dtype == torch.uint32 else imgs
    out = words[:, iy.clamp(0, H - 1).long(), ix.clamp(0, W - 1).long()]
    if imgs.dtype == torch.uint32:
        out = out.view(torch.uint32)
    return out[0] if squeeze else out


def gather2d(imgs: torch.Tensor, iy: torch.Tensor,
             ix: torch.Tensor) -> torch.Tensor:
    """out[c, i, j] = imgs[c, iy[i, j], ix[i, j]] (indices clamped in range).

    imgs (C, H, W) or (H, W) float32, int32 or uint32; iy/ix (Qh, Qw) int32.
    Returns (C, Qh, Qw) (or (Qh, Qw) for 2-D imgs) of imgs' dtype."""
    if imgs.dim() not in (2, 3) or iy.dim() != 2 or ix.shape != iy.shape:
        raise ValueError(f"gather2d: imgs (C, H, W) or (H, W) and iy/ix of "
                         f"one (Qh, Qw) shape, got {tuple(imgs.shape)}, "
                         f"{tuple(iy.shape)}, {tuple(ix.shape)}")
    if imgs.dtype not in _WORDS:
        raise TypeError(f"gather2d: imgs dtype {imgs.dtype} not supported")
    if iy.dtype != torch.int32 or ix.dtype != torch.int32:
        raise TypeError(f"gather2d: index dtypes {iy.dtype}, {ix.dtype}, "
                        f"expected int32")
    if not (imgs.device == iy.device == ix.device):
        raise ValueError(f"gather2d: operands on {imgs.device}, {iy.device}, "
                         f"{ix.device}")
    if imgs.shape[-1] < 1 or imgs.shape[-2] < 1:
        raise ValueError("gather2d: empty image")
    if imgs.device.type == "cpu":
        return gather2d_ref(imgs, iy, ix)
    if imgs.device.type != "cuda":
        raise ValueError(f"gather2d: unsupported device {imgs.device}")
    if not (imgs.is_contiguous() and iy.is_contiguous()
            and ix.is_contiguous()):
        raise ValueError("gather2d: operands must be contiguous")
    squeeze = imgs.dim() == 2
    C, H, W = (1,) + tuple(imgs.shape) if squeeze else tuple(imgs.shape)
    if C > 8 * 65535:
        raise ValueError(f"gather2d: too many channels ({C})")
    if H * W >= 2 ** 31:
        raise ValueError(f"gather2d: image plane too large ({H}x{W})")
    out = torch.empty((C,) + tuple(iy.shape), dtype=imgs.dtype,
                      device=imgs.device)
    stream = torch.cuda.current_stream(imgs.device).cuda_stream
    err = _load().dpe_gather2d(imgs.data_ptr(), iy.data_ptr(), ix.data_ptr(),
                               out.data_ptr(), C, H, W, iy.numel(), stream)
    if err != 0:
        raise RuntimeError(f"gather2d: kernel launch failed, cudaError_t "
                           f"{err}")
    LAUNCHES["gather2d"] += 1
    return out[0] if squeeze else out
