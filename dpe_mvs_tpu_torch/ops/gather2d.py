"""Scattered 2-D point gathers: the anchor reads of the weak-texture machinery
and the line-of-sight lookups.

Port of :mod:`dpe_mvs_tpu.ops.gather2d`: three entries of one hand-written
CUDA source for Hopper (``csrc/gather2d.cu``), each with a plain PyTorch
version beside it,

    gather2d(imgs, iy, ix)           out[c, i, j] = imgs[c, clamp(iy[i, j]),
                                                         clamp(ix[i, j])]
    gather2d_hwc(img, iy, ix)        out[..., :] = img[clamp(iy[...]),
                                                       clamp(ix[...]), :]
    gather2d_pick(imgs, ic, iy, ix)  out[...] = imgs[clamp(ic[...]),
                                                     clamp(iy[...]),
                                                     clamp(ix[...])]

``gather2d`` keeps the JAX signature; the JAX package has two TPU kernels
for it (the image channel in VMEM or in HBM), and the CUDA kernel computes
the same function for both, a block per (16, 128) query tile
(:func:`tile_plan`). ``gather2d_hwc`` is the
channel-last form that ``sampling.gather_map`` calls: no transpose, no
widening of bool or uint8 maps, a unit of the widest aligned vector per
query (:func:`hwc_plan`). ``gather2d_pick`` is what the line-of-sight test
needs: one channel per query, instead of every channel and a pick.

Each wrapper takes the plain version for a tensor on the CPU and launches
the kernel for a tensor on a CUDA device; it never falls back from one to the
other. ``LAUNCHES`` counts kernel launches per entry.

``pack_bf16_pairs`` / ``unpack_bf16_pairs`` carry two bf16 channels in one
32-bit word (a bitcast, no arithmetic), so a bf16 volume moves through the
32-bit gather at half the bytes of its float32 form.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cudalib

SOURCE = cudalib.CSRC / "gather2d.cu"

# Kernel launches since the last reset_launches().
LAUNCHES = {"gather2d": 0, "gather2d_hwc": 0, "gather2d_pick": 0}

# gather2d query tiles (csrc/gather2d.cu kTileRows x kTileCols).
TILE_ROWS, TILE_COLS = 16, 128

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_SIGS = {
    "dpe_gather2d": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
                     _I32, _I32, _P],
    "dpe_gather2d_hwc": [_P, _P, _P, _P, _I32, _I32, _I64, _I64, _I64, _I32,
                         _I32, _I32, _P],
    "dpe_gather2d_pick": [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I64, _I32,
                          _P],
}
_WORDS = (torch.float32, torch.int32, torch.uint32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False):
    """Compile ``csrc/gather2d.cu`` (if the cached build is stale) and return
    the shared library's path. Raises on a failed build."""
    return cudalib.build_many([SOURCE], verbose)[0]


def _load():
    return cudalib.load(SOURCE, _SIGS)


# --------------------------------------------------------------------------
# Launch plans (pure Python: the CPU tests reach them)
# --------------------------------------------------------------------------

def index_vec(n: int, *ptrs: int) -> bool:
    """Indices (and 32-bit outputs) move as 16-byte vectors of 4 queries:
    the query count per row is a multiple of 4 and every pointer is 16-byte
    aligned."""
    return n % 4 == 0 and all(p % 16 == 0 for p in ptrs)


class TilePlan(NamedTuple):
    vec: bool          # 16-byte index loads and output stores
    tiles: int         # blocks: one per TILE_ROWS x TILE_COLS query tile
    tiles_x: int


def tile_plan(Qh: int, Qw: int, iy_ptr: int, ix_ptr: int) -> TilePlan:
    """The launch of :func:`gather2d` for (Qh, Qw) queries."""
    tiles_x = -(-Qw // TILE_COLS)
    tiles = -(-Qh // TILE_ROWS) * tiles_x
    if tiles >= 2 ** 31:
        raise ValueError(f"gather2d: too many query tiles ({Qh}x{Qw})")
    return TilePlan(vec=index_vec(Qw, iy_ptr, ix_ptr), tiles=tiles,
                    tiles_x=tiles_x)


class HwcPlan(NamedTuple):
    unit: int          # bytes moved per load and store: 16, 8, 4, 2 or 1
    upq: int           # units per query
    vec: bool          # 16-byte index loads


def hwc_plan(row_bytes: int, img_ptr: int, s_h: int, s_w: int, out_ptr: int,
             Q: int, iy_ptr: int, ix_ptr: int) -> HwcPlan:
    """The launch of :func:`gather2d_hwc`: the widest unit that divides a
    query's row of channels (``row_bytes``) and that the image's address,
    its row and pixel strides (bytes) and the output's address allow."""
    unit = next(u for u in (16, 8, 4, 2, 1)
                if row_bytes % u == 0 and img_ptr % u == 0 and s_h % u == 0
                and s_w % u == 0 and out_ptr % u == 0)
    return HwcPlan(unit=unit, upq=row_bytes // unit,
                   vec=index_vec(Q, iy_ptr, ix_ptr))


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _as_words(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _like(out: torch.Tensor, dtype) -> torch.Tensor:
    return out.view(torch.uint32) if dtype == torch.uint32 else out


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
    out = _as_words(imgs)[:, iy.clamp(0, H - 1).long(),
                          ix.clamp(0, W - 1).long()]
    out = _like(out, imgs.dtype)
    return out[0] if squeeze else out


def gather2d_hwc_ref(img: torch.Tensor, iy: torch.Tensor,
                     ix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather2d_hwc` (the same clamps)."""
    H, W = img.shape[:2]
    out = _as_words(img)[iy.clamp(0, H - 1).long(),
                         ix.clamp(0, W - 1).long()]
    return _like(out, img.dtype)


def gather2d_pick_ref(imgs: torch.Tensor, ic: torch.Tensor, iy: torch.Tensor,
                      ix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather2d_pick` (the same clamps)."""
    C, H, W = imgs.shape
    out = _as_words(imgs)[ic.clamp(0, C - 1).long(),
                          iy.clamp(0, H - 1).long(),
                          ix.clamp(0, W - 1).long()]
    return _like(out, imgs.dtype)


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

def _check(name: str, img: torch.Tensor, *idx: torch.Tensor) -> bool:
    """Shared checks; True where the kernel is to be launched (a CUDA
    tensor), False for the plain version (a CPU tensor). The last two index
    tensors (iy, ix) are int32; the pick's channel index before them is
    checked by its wrapper."""
    if any(t.dtype != torch.int32 for t in idx[-2:]):
        raise TypeError(f"{name}: index dtypes "
                        f"{[str(t.dtype) for t in idx]}, expected int32")
    if any(t.shape != idx[0].shape for t in idx):
        raise ValueError(f"{name}: index shapes differ: "
                         f"{[tuple(t.shape) for t in idx]}")
    if any(t.device != img.device for t in idx):
        raise ValueError(f"{name}: operands on {img.device}, "
                         f"{[str(t.device) for t in idx]}")
    if img.device.type == "cpu":
        return False
    if img.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {img.device}")
    if not all(t.is_contiguous() for t in idx):
        raise ValueError(f"{name}: index tensors must be contiguous")
    return True


def _launch(name: str, t: torch.Tensor, *args) -> None:
    """Call the C entry ``dpe_<name>(*args, stream)`` on ``t``'s card, made
    current for the launch (CUDA refuses a launch into a stream of a card
    that is not the current one), and count it."""
    with torch.cuda.device(t.device):
        err = getattr(_load(), "dpe_" + name)(
            *args, torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError_t {err}")
    LAUNCHES[name] += 1


def gather2d(imgs: torch.Tensor, iy: torch.Tensor,
             ix: torch.Tensor) -> torch.Tensor:
    """out[c, i, j] = imgs[c, iy[i, j], ix[i, j]] (indices clamped in range).

    imgs (C, H, W) or (H, W) float32, int32 or uint32; iy/ix (Qh, Qw) int32.
    Returns (C, Qh, Qw) (or (Qh, Qw) for 2-D imgs) of imgs' dtype."""
    if imgs.dim() not in (2, 3) or iy.dim() != 2:
        raise ValueError(f"gather2d: imgs (C, H, W) or (H, W) and iy/ix of "
                         f"one (Qh, Qw) shape, got {tuple(imgs.shape)}, "
                         f"{tuple(iy.shape)}, {tuple(ix.shape)}")
    if imgs.dtype not in _WORDS:
        raise TypeError(f"gather2d: imgs dtype {imgs.dtype} not supported")
    if imgs.shape[-1] < 1 or imgs.shape[-2] < 1:
        raise ValueError("gather2d: empty image")
    if not _check("gather2d", imgs, iy, ix):
        return gather2d_ref(imgs, iy, ix)
    if not imgs.is_contiguous():
        raise ValueError("gather2d: operands must be contiguous")
    squeeze = imgs.dim() == 2
    C, H, W = (1,) + tuple(imgs.shape) if squeeze else tuple(imgs.shape)
    if H * W >= 2 ** 31:
        raise ValueError(f"gather2d: image plane too large ({H}x{W})")
    Qh, Qw = iy.shape
    out = torch.empty((C, Qh, Qw), dtype=imgs.dtype, device=imgs.device)
    if C and Qh and Qw:
        p = tile_plan(Qh, Qw, iy.data_ptr(), ix.data_ptr())
        _launch("gather2d", imgs, imgs.data_ptr(), iy.data_ptr(),
                ix.data_ptr(), out.data_ptr(), C, H, W, Qh, Qw, int(p.vec),
                p.tiles, p.tiles_x)
    return out[0] if squeeze else out


def gather2d_hwc(img: torch.Tensor, iy: torch.Tensor,
                 ix: torch.Tensor) -> torch.Tensor:
    """out[..., :] = img[iy[...], ix[...], :] (indices clamped in range).

    img (H, W, C) of any dtype whose channels are contiguous (any row and
    pixel strides: a slice such as ``plane[..., :3]`` is read in place);
    iy/ix int32 of one shape S. Returns (*S, C) of img's dtype."""
    if img.dim() != 3:
        raise ValueError(f"gather2d_hwc: img (H, W, C), got "
                         f"{tuple(img.shape)}")
    H, W, C = img.shape
    if H < 1 or W < 1:
        raise ValueError("gather2d_hwc: empty image")
    if not _check("gather2d_hwc", img, iy, ix):
        return gather2d_hwc_ref(img, iy, ix)
    es = img.element_size()
    s_h = img.stride(0) * es if H > 1 else 0
    s_w = img.stride(1) * es if W > 1 else 0
    if (C > 1 and img.stride(2) != 1) or s_h < 0 or s_w < 0:
        raise ValueError(f"gather2d_hwc: channels must be contiguous, got "
                         f"strides {img.stride()}")
    out = torch.empty(tuple(iy.shape) + (C,), dtype=img.dtype,
                      device=img.device)
    Q = iy.numel()
    if Q and C:
        p = hwc_plan(C * es, img.data_ptr(), s_h, s_w, out.data_ptr(), Q,
                     iy.data_ptr(), ix.data_ptr())
        _launch("gather2d_hwc", img, img.data_ptr(), iy.data_ptr(),
                ix.data_ptr(), out.data_ptr(), H, W, s_h, s_w, Q, p.unit,
                p.upq, int(p.vec))
    return out


def gather2d_pick(imgs: torch.Tensor, ic: torch.Tensor, iy: torch.Tensor,
                  ix: torch.Tensor) -> torch.Tensor:
    """out[...] = imgs[ic[...], iy[...], ix[...]] (indices clamped in range):
    one channel per query.

    imgs (C, H, W) float32, int32 or uint32; ic int64 (what ``argmin``
    gives), iy/ix int32, all of one shape S. Returns S of imgs' dtype."""
    if imgs.dim() != 3:
        raise ValueError(f"gather2d_pick: imgs (C, H, W), got "
                         f"{tuple(imgs.shape)}")
    if imgs.dtype not in _WORDS:
        raise TypeError(f"gather2d_pick: imgs dtype {imgs.dtype} not "
                        f"supported")
    C, H, W = imgs.shape
    if C < 1 or H < 1 or W < 1:
        raise ValueError("gather2d_pick: empty image")
    if ic.dtype != torch.int64:
        raise TypeError(f"gather2d_pick: channel index dtype {ic.dtype}, "
                        f"expected int64")
    if not _check("gather2d_pick", imgs, ic, iy, ix):
        return gather2d_pick_ref(imgs, ic, iy, ix)
    if not imgs.is_contiguous():
        raise ValueError("gather2d_pick: operands must be contiguous")
    if H * W >= 2 ** 31:
        raise ValueError(f"gather2d_pick: image plane too large ({H}x{W})")
    out = torch.empty(iy.shape, dtype=imgs.dtype, device=imgs.device)
    Q = iy.numel()
    if Q:
        vec = index_vec(Q, ic.data_ptr(), iy.data_ptr(), ix.data_ptr(),
                        out.data_ptr())
        _launch("gather2d_pick", imgs, imgs.data_ptr(), ic.data_ptr(),
                iy.data_ptr(), ix.data_ptr(), out.data_ptr(), C, H, W, Q,
                int(vec))
    return out
