"""The ``.dmb`` mat container, bit-compatible with the reference tool chain.

The port's own copy of the ``.dmb`` reader and writer of
:mod:`dpe_mvs_tpu.io.formats` (``ReadBinMat``/``WriteBinMat``,
DPE.cpp:293-339): a little-endian header {version=1, rows, cols, cvtype}
followed by the raw data. Pure numpy.
"""
from __future__ import annotations

import os
import struct

import numpy as np

# OpenCV type codes (CV_8U=0, CV_8S=1, CV_32S=4, CV_32F=5, channels packed as
# depth + (channels-1)*8).
_CV_DEPTH_TO_DTYPE = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
                      4: np.int32, 5: np.float32, 6: np.float64}
_DTYPE_TO_CV_DEPTH = {np.dtype(v): k for k, v in _CV_DEPTH_TO_DTYPE.items()}


def cv_type(depth: int, channels: int) -> int:
    return depth + ((channels - 1) << 3)


def read_dmb(path: os.PathLike) -> np.ndarray:
    """Read a ``.dmb`` mat. Returns (rows, cols) or (rows, cols, ch)."""
    with open(path, "rb") as f:
        version, rows, cols, type_ = struct.unpack("<iiii", f.read(16))
        if version != 1:
            raise ValueError(f"dmb version {version} != 1 in {path}")
        depth = type_ & 7
        channels = (type_ >> 3) + 1
        dtype = np.dtype(_CV_DEPTH_TO_DTYPE[depth])
        data = np.fromfile(f, dtype=dtype, count=rows * cols * channels)
    arr = data.reshape(rows, cols, channels)
    return arr[..., 0] if channels == 1 else arr


def write_dmb(path: os.PathLike, arr: np.ndarray) -> None:
    """Write a ``.dmb`` mat."""
    arr = np.ascontiguousarray(arr)
    if arr.ndim == 2:
        rows, cols, channels = arr.shape[0], arr.shape[1], 1
    elif arr.ndim == 3:
        rows, cols, channels = arr.shape
    else:
        raise ValueError(f"dmb arrays must be 2D/3D, got shape {arr.shape}")
    depth = _DTYPE_TO_CV_DEPTH[arr.dtype]
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", 1, rows, cols, cv_type(depth, channels)))
        arr.tofile(f)
