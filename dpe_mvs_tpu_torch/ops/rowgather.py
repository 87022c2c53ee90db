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

How a launch is cut (16-byte vectors or single words, rows staged in shared
memory or read through the read-only path, the persistent grid) is decided by
:func:`launch_plan`, plain Python so that the CPU tests reach it.

The kernels are compiled with ``nvcc`` at first use, from the package's own
source (:mod:`.cudalib`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import cudalib

SOURCE = cudalib.CSRC / "rowgather.cu"

# Kernel launches since the last reset_launches(), per kernel.
LAUNCHES = {"row_gather": 0, "bilinear_x": 0}

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
         ctypes.c_int32, ctypes.c_int32,
         ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
         ctypes.c_void_p]

# Mirrors of csrc/rowgather.cu's constants.
THREADS = 256                   # kThreads
PASS_ELEMS = THREADS * 4 * 4    # outputs per block pass (kVecs 16-byte vectors)
BLOCKS_PER_SM = 4               # kBlocksPerSM (__launch_bounds__)
# Staging: a block's dynamic shared memory holds two mbarriers (BARRIER_BYTES)
# and two buffers of one image row each. It must fit the 48 KB a launch gets
# without opting in (four such blocks fit an SM's 227 KB).
SMEM_BYTES = 48 * 1024
BARRIER_BYTES = 16
# Shape class where staging wins: each staged row word feeds at least
# STAGE_MIN_REUSE outputs (L >= STAGE_MIN_REUSE * W). Below that, the
# unstaged kernel moves only the row sectors the indices touch. Set from
# both variants timed at every shape of the 800x600 sweeps (PERF.md):
# of the thresholds 1/4 to 16, 1 gave the least summed time.
STAGE_MIN_REUSE = 1


class Plan(NamedTuple):
    vec: bool       # 16-byte index and output vectors (else single words)
    staged: bool    # rows staged in shared memory by bulk async copy
                    # (else read through __ldg)
    grid: int       # blocks of THREADS threads
    smem: int       # dynamic shared memory bytes per block (all it uses)


def launch_plan(H: int, W: int, L: int, img_addr: int, idx_addr: int,
                out_addr: int, n_sm: int,
                staged: Optional[bool] = None) -> Plan:
    """How to launch a row gather of (H, W) rows at (H, L) indices, with the
    three arrays at the given device addresses, on a card of ``n_sm`` SMs.

    ``staged`` None takes the shape class's choice (staged where a row word
    feeds at least ``STAGE_MIN_REUSE`` outputs); True or False asks for one
    variant. Rows the bulk copy cannot move (W % 4 != 0, an image off 16
    bytes, or two rows and the barriers over ``SMEM_BYTES``) are never
    staged."""
    return _plan(H, W, L, img_addr % 16 == 0, idx_addr % 16 == 0,
                 out_addr % 16 == 0, n_sm, staged)


@functools.lru_cache(maxsize=4096)
def _plan(H, W, L, img16, idx16, out16, n_sm, staged) -> Plan:
    vec = L % 4 == 0 and idx16 and out16
    if staged is None:
        staged = L >= STAGE_MIN_REUSE * W
    slots = n_sm * BLOCKS_PER_SM
    smem = BARRIER_BYTES + 2 * 4 * W
    if not (staged and W % 4 == 0 and img16 and smem <= SMEM_BYTES):
        passes = -(-(H * L) // PASS_ELEMS)
        return Plan(vec, False, max(1, min(passes, slots)), 0)
    return Plan(vec, True, max(1, min(H, slots)), smem)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _launch(name: str, img, idx, staged: Optional[bool] = None):
    """Launch kernel ``name`` on CUDA tensors that passed the wrapper's
    checks, in the plan's variant or the one ``staged`` asks for (the GPU
    tests and chip_smoke.py time and check both)."""
    if not (img.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    H, W = img.shape
    L = idx.shape[1]
    if W >= 2 ** 31 or L >= 2 ** 31:
        raise ValueError(f"{name}: row too long ({W}, {L})")
    # The tensors' card is made current for the launch: CUDA refuses a
    # launch into a stream of a card that is not the current one.
    with torch.cuda.device(img.device):
        out = torch.empty(idx.shape, dtype=img.dtype, device=img.device)
        p = launch_plan(H, W, L, img.data_ptr(), idx.data_ptr(),
                        out.data_ptr(), _n_sm(img.device.index), staged)
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = getattr(_load(), "dpe_" + name)(
            img.data_ptr(), idx.data_ptr(), out.data_ptr(), H, W, L,
            int(p.vec), int(p.staged), p.grid, p.smem, stream)
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
    return _launch("row_gather", img, ix)


def bilinear_x(img: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation along rows at float columns, clamp addressing:
    out[h, l] = lerp(img[h, floor(x)], img[h, floor(x)+1], frac(x)).

    img (H, W) float32; x (H, L) float32 (finite; +-inf clamp to the row's
    ends). Returns (H, L) float32."""
    _check(img, x, torch.float32, "bilinear_x")
    if img.dtype != torch.float32:
        raise TypeError(f"bilinear_x: img dtype {img.dtype}, expected float32")
    if img.device.type == "cpu":
        return bilinear_x_ref(img, x)
    if img.device.type != "cuda":
        raise ValueError(f"bilinear_x: unsupported device {img.device}")
    return _launch("bilinear_x", img, x)
