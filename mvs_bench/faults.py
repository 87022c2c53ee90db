"""Faults planted under the timed path: for the readings that set a cell's
limits (``readings.py``) and for the tests that see the check fail
(``tests/test_mvs_bench_faults.py``).

A program fault is a context manager that breaks the program
(``dpe_mvs_tpu_torch``) underneath while it is open. A map fault alters
what a sweep writes back, where the program writes it
(``io.formats.write_dmb``); :func:`on_maps` applies the same alteration to
maps already read, so that one sound sweep gives the reading of each.
"""
from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

from . import reference


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


# --------------------------------------------------------------------------
# The program broken underneath
# --------------------------------------------------------------------------

def state_unchanged():
    """A sweep that returns the state it was given."""
    from dpe_mvs_tpu_torch.pipeline import schedule
    return patched(schedule, "run_sweep_staged",
                   lambda data, st, params, **kw: st)


def half_frame():
    """The bottom half of the frame keeps the state it came in with."""
    from dpe_mvs_tpu_torch.pipeline import schedule
    orig = schedule.run_sweep_staged

    def half(data, st, params, **kw):
        out = orig(data, st, params, **kw)
        h = out.plane.shape[0] // 2
        kept = {}
        for f in ("plane", "cost", "selected", "weak"):
            t = getattr(out, f).clone()
            t[h:] = getattr(st, f)[h:]
            kept[f] = t
        return out.replace(**kept)
    return patched(schedule, "run_sweep_staged", half)


def kernel_altered():
    """One element of every ``bilinear_x`` output altered."""
    from dpe_mvs_tpu_torch.ops import rowgather
    orig = rowgather.bilinear_x

    def altered(img, x):
        out = orig(img, x)
        out.view(-1)[0] += 1.0
        return out
    return patched(rowgather, "bilinear_x", altered)


def weak_skipped():
    """The weak stage's iterations (fit-plane RANSAC and weak propagation)
    leave the state as they found it."""
    from dpe_mvs_tpu_torch.engine import stages
    return patched(stages, "_weak_iter",
                   lambda data, sup, state, *args: state)


def cost_bf16():
    """Every stacked cost evaluation (the strong stage's and the weak
    stage's final one) returns its costs rounded to bfloat16."""
    import torch
    from dpe_mvs_tpu_torch.engine import rectcost
    orig = rectcost.rect_cost_vector_stacked

    def low(*args, **kw):
        out = orig(*args, **kw)
        return out.to(torch.bfloat16).to(out.dtype)
    return patched(rectcost, "rect_cost_vector_stacked", low)


PROGRAM_FAULTS: Dict[str, Callable] = {
    "state_unchanged": state_unchanged, "half_frame": half_frame,
    "kernel_altered": kernel_altered, "weak_skipped": weak_skipped,
    "cost_bf16": cost_bf16}


# --------------------------------------------------------------------------
# The written maps altered
# --------------------------------------------------------------------------

ROTATE_DEG = 5.0


def _scaled(arr, box, factor):
    out = arr.copy()
    if box is None:
        out *= np.float32(factor)
    else:
        y0, y1, x0, x1 = box
        out[y0:y1, x0:x1] *= np.float32(factor)
    return out


def rotate_normals(n: np.ndarray, deg: float) -> np.ndarray:
    """Every unit normal tilted by exactly ``deg`` degrees (about an axis
    at right angles to it)."""
    n = np.asarray(n, np.float64)
    a = np.broadcast_to(np.array([1.0, 0.0, 0.0]), n.shape)
    k = np.cross(n, a)
    par = np.linalg.norm(k, axis=-1) < 1e-6
    k[par] = np.cross(n[par], np.array([0.0, 1.0, 0.0]))
    k /= np.maximum(np.linalg.norm(k, axis=-1, keepdims=True), 1e-12)
    t = np.radians(deg)
    return (n * np.cos(t) + np.cross(k, n) * np.sin(t)).astype(np.float32)


def _unknown(arr, box):
    out = arr.copy()
    y0, y1, x0, x1 = box
    out[y0:y1, x0:x1] = reference.UNKNOWN
    return out


# name -> (file written, alteration(arr, patch box at the round's size))
MAP_FAULTS: Dict[str, Tuple[str, Callable]] = {
    "depth_altered": ("depths.dmb", lambda a, box: _scaled(a, None, 1.01)),
    "patch_depth_altered": ("depths.dmb",
                            lambda a, box: _scaled(a, box, 1.01)),
    "normals_rotated": ("normals.dmb",
                        lambda a, box: rotate_normals(a, ROTATE_DEG)),
    "patch_unknown": ("weak.bin", _unknown),
}

_FIELD = {"depths.dmb": "depth", "normals.dmb": "normal", "weak.bin": "weak"}


def patch_box(scene, scale: int):
    """The texture-less patch at the round's size."""
    return tuple(int(round(b / scale)) for b in scene.weak_box)


def at_write(name: str, box):
    """Map fault ``name`` planted where the program writes the map."""
    from dpe_mvs_tpu_torch.io import formats
    fname, alter = MAP_FAULTS[name]
    orig = formats.write_dmb

    def write(path, arr):
        if Path(path).name == fname:
            arr = alter(arr, box)
        return orig(path, arr)
    return patched(formats, "write_dmb", write)


def on_maps(name: str, maps: reference.SweepMaps, box
            ) -> reference.SweepMaps:
    """The maps a sweep would have written under map fault ``name``."""
    fname, alter = MAP_FAULTS[name]
    field = _FIELD[fname]
    return dataclasses.replace(maps, **{field: alter(getattr(maps, field),
                                                     box)})
