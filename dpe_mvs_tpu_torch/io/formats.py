"""Binary and text scene formats, bit-compatible with the reference tool
chain.

The port's own copy of :mod:`dpe_mvs_tpu.io.formats`:
  - the ``.dmb`` mat container (``ReadBinMat``/``WriteBinMat``,
    DPE.cpp:293-339): a little-endian header {version=1, rows, cols, cvtype}
    followed by the raw data;
  - ``*_cam.txt`` camera files (``ReadCamera``, DPE.cpp:341-382);
  - ``pair.txt`` view-selection lists (``GenerateSampleList``,
    main.cpp:264-308);
  - the fused point cloud, a binary ``.ply`` (``ExportPointCloud``,
    DPE.cpp:532-572);
  - the ``<dense>/DPE/<%08d>`` result folder of a view.
Pure numpy (the JAX package's native PLY writer is not ported).
"""
from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import List, Sequence, Tuple

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
    # Written aside and renamed into place, so that a reader (the
    # pipeline's prefetch thread) sees the old file or the new one whole.
    tmp = Path(f"{os.fspath(path)}.tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<iiii", 1, rows, cols, cv_type(depth, channels)))
        arr.tofile(f)
    os.replace(tmp, path)


def read_cam_txt(path: os.PathLike) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, float, float]:
    """Parse a ``%08d_cam.txt``: extrinsic 4x4, intrinsic 3x3 and the depth
    line ``depth_min interval depth_num depth_max`` (ETH/TnT) or
    ``depth_min interval`` (DTU). Returns (K, R, t, depth_min, depth_max);
    raises ValueError on a malformed file."""
    tokens: List[str] = []
    with open(path, "r") as f:
        for line in f:
            tokens.extend(line.split())
    it = iter(tokens)

    def expect(word):
        w = next(it)
        if w != word:
            raise ValueError(f"expected '{word}' in {path}, got '{w}'")

    expect("extrinsic")
    ext = np.array([float(next(it)) for _ in range(16)],
                   np.float32).reshape(4, 4)
    expect("intrinsic")
    K = np.array([float(next(it)) for _ in range(9)],
                 np.float32).reshape(3, 3)
    depth_min = float(next(it))
    interval = float(next(it))
    rest = [float(x) for x in it]
    # ETH/TnT files carry "min interval num max"; DTU files "min interval"
    # (DPE.cpp:369-379).
    if len(rest) >= 2:
        depth_max = rest[1]
    elif len(rest) == 1:
        depth_max = rest[0]
    else:
        depth_max = depth_min + interval * 192.0
    return K, ext[:3, :3].copy(), ext[:3, 3].copy(), depth_min, depth_max


def write_cam_txt(path: os.PathLike, K: np.ndarray, R: np.ndarray,
                  t: np.ndarray, depth_min: float, interval: float,
                  depth_num: float, depth_max: float) -> None:
    """Write a camera file in the layout of the reference converter
    (colmap2mvsnet.py:454-466)."""
    ext = np.eye(4, dtype=np.float64)
    ext[:3, :3] = R
    ext[:3, 3] = t
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in ext:
            f.write(" ".join(f"{v}" for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in np.asarray(K):
            f.write(" ".join(f"{v}" for v in row) + "\n")
        f.write(f"\n{depth_min} {interval} {depth_num} {depth_max}\n")


def read_pair_txt(path: os.PathLike
                  ) -> List[Tuple[int, List[Tuple[int, float]]]]:
    """Parse ``pair.txt``: the count, then per image a "ref_id" line and an
    "n src_id score ..." line."""
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n = int(lines[0].split()[0])
    out = []
    idx = 1
    for _ in range(n):
        ref_id = int(lines[idx].split()[0])
        parts = lines[idx + 1].split()
        srcs = [(int(parts[1 + 2 * j]), float(parts[2 + 2 * j]))
                for j in range(int(parts[0]))]
        out.append((ref_id, srcs))
        idx += 2
    return out


def write_pair_txt(path: os.PathLike,
                   pairs: Sequence[Tuple[int, Sequence[Tuple[int, float]]]]
                   ) -> None:
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref_id, srcs in pairs:
            f.write(f"{ref_id}\n{len(srcs)} ")
            f.write(" ".join(f"{i} {s}" for i, s in srcs) + "\n")


_PLY_VERTEX = np.dtype([("xyz", np.float32, 3), ("bgr", np.uint8, 3)])


def write_ply(path: os.PathLike, points: np.ndarray,
              colors_bgr: np.ndarray) -> None:
    """Binary little-endian PLY with the reference's vertex layout: float
    xyz, then uchar diffuse_blue/green/red."""
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    colors_bgr = np.ascontiguousarray(colors_bgr, np.uint8).reshape(-1, 3)
    n = points.shape[0]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "property uchar diffuse_blue\n"
        "property uchar diffuse_green\n"
        "property uchar diffuse_red\n"
        "end_header\n"
    )
    rec = np.zeros(n, dtype=_PLY_VERTEX)
    rec["xyz"] = points
    rec["bgr"] = colors_bgr
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def read_ply(path: os.PathLike) -> Tuple[np.ndarray, np.ndarray]:
    """Read a PLY written by :func:`write_ply` (or the reference binary):
    (points (N, 3) float32, colours (N, 3) uint8 BGR)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY without end_header")
            header += line
        n = int([ln for ln in header.decode().splitlines()
                 if ln.startswith("element vertex")][0].split()[-1])
        rec = np.fromfile(f, dtype=_PLY_VERTEX, count=n)
    if rec.shape[0] != n:
        raise ValueError(f"{path}: {rec.shape[0]} of {n} vertices")
    return rec["xyz"].copy(), rec["bgr"].copy()


def result_folder(dense_folder: os.PathLike, image_id: int) -> Path:
    """``<dense>/DPE/<%08d>`` per-view output folder (main.cpp:289)."""
    return Path(dense_folder) / "DPE" / f"{image_id:08d}"
