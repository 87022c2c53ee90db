"""The weak stage's per-view deformable NCC cost and geometric term of one
candidate plane field, in one launch of a hand-written CUDA kernel for
Hopper (``csrc/weakcost.cu``).

    launch(plane, consts, xr, yr, d0, vol_center=, ap=, a_d0=, a_x=, a_y=,
           a_valid=, a_sel=)        the photometric cost
                                    (engine.weak_rect.deformable_cost_rect_ref)
    launch(plane, consts, xr, yr, d0, vol_geom=)    the geometric term
                                    (engine.weak_rect.geom_term_rect_ref)
    launch(..., both sets, geom_factor=g)           cost + g * term (the
                                    refinement's weighted candidate)

each (V, h, W) float32 over the sites' (h, W) grid (a row band or the whole
frame): the operands given decide what is computed. The kernel follows the
plain versions operation for operation and gives their bits. It reads every
operand in place through its strides: row bands narrowed out of the frame's
fields, the streaming mode's transposed (V, 8, S, h, W) anchor-profile
stack, bf16 volumes, bool masks. The rectification constants of each view
come packed in one small device tensor (:func:`pack_consts`), so nothing is
read back to the host.

``engine.weak_rect.weak_cost`` is the entry point: it calls :func:`launch`
for tensors on a CUDA device and the plain versions for tensors on the CPU.
``launch`` takes CUDA tensors only. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cudalib

SOURCE = cudalib.CSRC / "weakcost.cu"

# Kernel launches since the last reset_launches().
LAUNCHES = {"weakcost": 0}

PROBE_S = 16               # probes a profile (engine.weak_rect.PROBE_S)
ANCHORS = 8
CONSTS_PER_VIEW = 22       # R2r (9), H_ref (9), f, b, cx, cy
_PHOTO, _GEOM = 1, 2
_PHOTO_NAMES = ("vol_center", "ap", "a_d0", "a_x", "a_y", "a_valid", "a_sel")


class _Field(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("st", ctypes.c_int64 * 5)]


class _Args(ctypes.Structure):
    """``Args`` of ``csrc/weakcost.cu``, field for field."""
    _fields_ = ([("consts", ctypes.c_void_p)]
                + [(n, _Field) for n in (
                    "plane", "xr", "yr", "d0", "vol_center", "vol_geom", "ap",
                    "a_d0", "a_x", "a_y", "a_valid", "a_sel")]
                + [("out", ctypes.c_void_p), ("V", ctypes.c_int32),
                   ("h", ctypes.c_int32), ("W", ctypes.c_int32),
                   ("mode", ctypes.c_int32), ("geom_factor", ctypes.c_float)])


_SIGS = {"dpe_weakcost": [ctypes.POINTER(_Args), ctypes.c_void_p]}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False):
    """Compile ``csrc/weakcost.cu`` (if the cached build is stale) and return
    the shared library's path. Raises on a failed build."""
    return cudalib.build_many([SOURCE], verbose)[0]


def _load():
    return cudalib.load(SOURCE, _SIGS)


def pack_consts(rect, view_valid: torch.Tensor) -> torch.Tensor:
    """The kernel's per-view constants, on the views' device:
    (V * CONSTS_PER_VIEW + V,) float32, per view R2r and H_ref (row-major),
    f, b, cx, cy, then each view's ``view_valid`` as 0 or 1."""
    parts = [t.reshape(-1) for rv in rect
             for t in (rv.R2r, rv.H_ref, rv.f, rv.b, rv.cx, rv.cy)]
    parts.append(view_valid[:len(rect)].to(torch.float32))
    return torch.cat(parts)


def site_bytes(V: int, photo: bool, geom: bool) -> int:
    """Bytes a launch needs per site, each once: the plane (16), per view the
    rect coordinates and probe centre (12), two bf16 taps of each profile
    read and the output (4); with the cost, per anchor its pixel, selected
    views and validity (13, shared by the views) and per view its probe
    centre (4). Over the memory rate: the least time a launch can take."""
    n = 16 + V * (12 + 4)
    if geom:
        n += V * 4
    if photo:
        n += V * 4 + ANCHORS * 13 + V * ANCHORS * (4 + 4)
    return n


# --------------------------------------------------------------------------
# Checks (pure Python: the CPU tests reach them), launch
# --------------------------------------------------------------------------

def _check(plane: torch.Tensor, ops: dict, out) -> tuple:
    """Checks the plane, every operand (``ops`` by ``Args`` name, None where
    not given) and ``out`` for dtype (a TypeError), shape and device (a
    ValueError); returns (mode, V, h, W)."""
    if plane.dim() != 3 or plane.shape[-1] != 4:
        raise ValueError(f"weakcost: plane (h, W, 4), got "
                         f"{tuple(plane.shape)}")
    h, W = plane.shape[:2]
    xr = ops["xr"]
    V = xr.shape[0] if xr.dim() == 3 else -1
    if not 1 <= V <= 32:
        raise ValueError(f"weakcost: xr (V, h, W) with 1 <= V <= 32, got "
                         f"{tuple(xr.shape)}")
    if h * W >= 2 ** 31:
        raise ValueError(f"weakcost: too many sites ({h}x{W})")
    given = [n for n in _PHOTO_NAMES if ops[n] is not None]
    if given and len(given) != len(_PHOTO_NAMES):
        raise ValueError(f"weakcost: the cost reads all of {_PHOTO_NAMES}, "
                         f"got {given}")
    photo, geom = bool(given), ops["vol_geom"] is not None
    if not (photo or geom):
        raise ValueError("weakcost: nothing asked for")
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    want = {"plane": (f32, (h, W, 4)),
            "consts": (f32, (V * (CONSTS_PER_VIEW + 1),)),
            "xr": (f32, (V, h, W)), "yr": (f32, (V, h, W)),
            "d0": (f32, (V, h, W)),
            "vol_center": (bf16, (V, PROBE_S, h, W)),
            "ap": (bf16, (V, ANCHORS, PROBE_S, h, W)),
            "a_d0": (f32, (V, ANCHORS, h, W)),
            "a_x": (i32, (ANCHORS, h, W)), "a_y": (i32, (ANCHORS, h, W)),
            "a_valid": (torch.bool, (ANCHORS, h, W)),
            "a_sel": (i32, (ANCHORS, h, W)),
            "vol_geom": (bf16, (V, PROBE_S, h, W)),
            "out": (f32, (V, h, W))}
    for name, t in {"plane": plane, **ops, "out": out}.items():
        if t is None:
            continue
        dtype, shape = want[name]
        if t.dtype != dtype:
            raise TypeError(f"weakcost: {name} dtype {t.dtype}, expected "
                            f"{dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"weakcost: {name} shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != plane.device:
            raise ValueError(f"weakcost: {name} on {t.device}, plane on "
                             f"{plane.device}")
    if not ops["consts"].is_contiguous():
        raise ValueError("weakcost: consts must be contiguous")
    if out is not None and not out.is_contiguous():
        raise ValueError("weakcost: out must be contiguous")
    return (_PHOTO if photo else 0) | (_GEOM if geom else 0), V, h, W


def _require_card(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"weakcost: the kernel runs on a CUDA device, not "
                         f"on {device}")


def _field(t) -> _Field:
    f = _Field()
    if t is not None:
        f.p = t.data_ptr()
        for i, s in enumerate(t.stride()):
            f.st[i] = s
    return f


def launch(plane: torch.Tensor, consts: torch.Tensor, xr: torch.Tensor,
           yr: torch.Tensor, d0: torch.Tensor, *,
           vol_center: Optional[torch.Tensor] = None,
           ap: Optional[torch.Tensor] = None,
           a_d0: Optional[torch.Tensor] = None,
           a_x: Optional[torch.Tensor] = None,
           a_y: Optional[torch.Tensor] = None,
           a_valid: Optional[torch.Tensor] = None,
           a_sel: Optional[torch.Tensor] = None,
           vol_geom: Optional[torch.Tensor] = None,
           geom_factor: float = 0.0,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(V, h, W) float32 of the candidate ``plane`` (h, W, 4) over the
    sites' (h, W) grid, one launch on the current stream of the operands'
    card (made current for it): the photometric cost where the cost's
    operands (``vol_center`` to ``a_sel``) are given, the geometric term
    where ``vol_geom`` is, with both cost + geom_factor * term. ``consts``:
    :func:`pack_consts`. ``out``, if given, is a contiguous (V, h, W)
    float32 tensor written in place."""
    ops = {"consts": consts, "xr": xr, "yr": yr, "d0": d0,
           "vol_center": vol_center, "ap": ap, "a_d0": a_d0, "a_x": a_x,
           "a_y": a_y, "a_valid": a_valid, "a_sel": a_sel,
           "vol_geom": vol_geom}
    mode, V, h, W = _check(plane, ops, out)
    _require_card(plane.device)
    if out is None:
        out = torch.empty((V, h, W), dtype=torch.float32, device=plane.device)
    args = _Args(consts=consts.data_ptr(), out=out.data_ptr(), V=V, h=h, W=W,
                 mode=mode, geom_factor=float(geom_factor))
    args.plane = _field(plane)
    for name, t in ops.items():
        if name != "consts":
            setattr(args, name, _field(t))
    dev = out.device
    with torch.cuda.device(dev):
        err = _load().dpe_weakcost(
            ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"weakcost: kernel launch failed, cudaError_t "
                           f"{err}")
    LAUNCHES["weakcost"] += 1
    return out
