"""Row-local gathers: the texture unit of the rectified cost engine.

Port of :mod:`dpe_mvs_tpu.ops.rowgather`. Two operations, each a
hand-written CUDA kernel for Hopper (``csrc/rowgather.cu``) with a plain
PyTorch version beside it:

    row_gather(img, ix)  out[h, l] = img[h, clamp(ix[h, l], 0, W-1)]
    bilinear_x(img, x)   linear interpolation along the row at float column x
                         (clamp addressing; the row axis is not interpolated)

A wrapper takes the plain version for a tensor on the CPU and launches the
kernel for a tensor on a CUDA device; it never falls back from one to the
other. ``LAUNCHES`` counts kernel launches per kernel, so a run can show that
it went through the kernels.

The kernels are compiled with ``nvcc`` at first use, from the package's own
source (:mod:`.cudalib`).
"""
from __future__ import annotations

import ctypes

import torch

from . import cudalib

SOURCE = cudalib.CSRC / "rowgather.cu"

# Kernel launches since the last reset_launches(), per kernel.
LAUNCHES = {"row_gather": 0, "bilinear_x": 0}

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False):
    """Compile ``csrc/rowgather.cu`` (if the cached build is stale) and return
    the shared library's path. Raises on a failed build."""
    return cudalib.build_many([SOURCE], verbose)[0]


def _load():
    return cudalib.load(SOURCE, {"dpe_row_gather": _ARGS,
                                 "dpe_bilinear_x": _ARGS})


def _check(img: torch.Tensor, idx: torch.Tensor, idx_dtype, name: str):
    if img.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"{name}: img and index must be 2-D, got "
                         f"{tuple(img.shape)} and {tuple(idx.shape)}")
    if img.shape[0] != idx.shape[0]:
        raise ValueError(f"{name}: row counts differ: {tuple(img.shape)} vs "
                         f"{tuple(idx.shape)}")
    if img.shape[1] < 1:
        raise ValueError(f"{name}: empty rows")
    if idx.dtype != idx_dtype:
        raise TypeError(f"{name}: index dtype {idx.dtype}, expected "
                        f"{idx_dtype}")
    if img.device != idx.device:
        raise ValueError(f"{name}: img on {img.device}, index on "
                         f"{idx.device}")


def _launch(fn, name: str, img, idx, out):
    if not (img.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    H, W = img.shape
    L = idx.shape[1]
    if W >= 2 ** 31 or L >= 2 ** 31:
        raise ValueError(f"{name}: row too long ({W}, {L})")
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = fn(img.data_ptr(), idx.data_ptr(), out.data_ptr(), H, W, L, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
    LAUNCHES[name] += 1
    return out


def row_gather_ref(img: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`row_gather`."""
    W = img.shape[1]
    return torch.gather(img, 1, ix.clamp(0, W - 1).long())


def bilinear_x_ref(img: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bilinear_x`: the same clamps and lerp
    order as the JAX fast path (``dpe_mvs_tpu/ops/rowgather.py``)."""
    W = img.shape[1]
    xc = x.clamp(0.0, W - 1.0)
    x0 = xc.floor().clamp(0.0, W - 2.0) if W > 1 else torch.zeros_like(xc)
    f = xc - x0
    ix0 = x0.long()
    g0 = torch.gather(img, 1, ix0)
    g1 = torch.gather(img, 1, (ix0 + 1).clamp(max=W - 1))
    return g0 * (1.0 - f) + g1 * f


def row_gather(img: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """out[h, l] = img[h, clamp(ix[h, l], 0, W-1)].

    img (H, W) float32, int32 or uint32; ix (H, L) int32, any values.
    Returns (H, L) of img's dtype."""
    _check(img, ix, torch.int32, "row_gather")
    if img.dtype not in (torch.float32, torch.int32, torch.uint32):
        raise TypeError(f"row_gather: img dtype {img.dtype} not supported")
    if img.device.type == "cpu":
        if img.dtype == torch.uint32:
            return row_gather_ref(img.view(torch.int32), ix).view(torch.uint32)
        return row_gather_ref(img, ix)
    if img.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {img.device}")
    out = torch.empty(ix.shape, dtype=img.dtype, device=img.device)
    return _launch(_load().dpe_row_gather, "row_gather", img, ix, out)


def bilinear_x(img: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation along rows at float columns, clamp addressing:
    out[h, l] = lerp(img[h, floor(x)], img[h, floor(x)+1], frac(x)).

    img (H, W) float32; x (H, L) float32 (finite). Returns (H, L) float32."""
    _check(img, x, torch.float32, "bilinear_x")
    if img.dtype != torch.float32:
        raise TypeError(f"bilinear_x: img dtype {img.dtype}, expected float32")
    if img.device.type == "cpu":
        return bilinear_x_ref(img, x)
    if img.device.type != "cuda":
        raise ValueError(f"bilinear_x: unsupported device {img.device}")
    out = torch.empty(x.shape, dtype=torch.float32, device=img.device)
    return _launch(_load().dpe_bilinear_x, "bilinear_x", img, x, out)
