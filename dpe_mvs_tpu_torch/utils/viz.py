"""Debug images of the intermediate maps (reference ``ShowDepthMap``,
``ShowNormalMap``, ``ShowWeakImage``, ``ShowEdgeImage``, DPE.cpp:384-530,
and the coloured regions of ``main.cpp:382``).

Port of :mod:`dpe_mvs_tpu.utils.viz`. Each map becomes a BGR uint8 array
(``*_to_color``, equal to what the JAX package hands ``cv2.imwrite``), and
the ``save_*`` writers store it as PNG bytes through :mod:`..io.imread`, under
whatever name they are given (the pipeline keeps the reference's ``.jpg``
names; readers decode by signature). No OpenCV and no Pillow is needed.
"""
from __future__ import annotations

import numpy as np

from ..config import PixelState
from ..io import imread


def depth_to_color(depth: np.ndarray, depth_min: float, depth_max: float
                   ) -> np.ndarray:
    """Jet-style BGR colour map of a depth map (ShowDepthMap,
    DPE.cpp:384-448); black outside [depth_min, depth_max]."""
    delta = max(depth_max - depth_min, 1e-12)
    valid = np.isfinite(depth) & (depth >= depth_min) & (depth <= depth_max)
    v = np.clip((depth_max - depth) / delta, 0.0, 1.0) * 255.0
    img = np.zeros((*depth.shape, 3), np.uint8)
    b = np.zeros_like(v)
    g = np.zeros_like(v)
    r = np.zeros_like(v)
    m = v <= 51
    b[m] = 255
    g[m] = v[m] * 5
    m = (v > 51) & (v <= 102)
    b[m] = 255 - (v[m] - 51) * 5
    g[m] = 255
    m = (v > 102) & (v <= 153)
    g[m] = 255
    r[m] = (v[m] - 102) * 5
    m = (v > 153) & (v <= 204)
    g[m] = 255 - np.uint8((v[m] - 153) * 128.0 / 51 + 0.5)
    r[m] = 255
    m = v > 204
    g[m] = 127 - np.uint8((v[m] - 204) * 127.0 / 51 + 0.5)
    r[m] = 255
    img[..., 0] = np.where(valid, b, 0).astype(np.uint8)
    img[..., 1] = np.where(valid, g, 0).astype(np.uint8)
    img[..., 2] = np.where(valid, r, 0).astype(np.uint8)
    return img


def normal_to_color(normal: np.ndarray) -> np.ndarray:
    """Unit normals mapped to [0, 255] per channel (ShowNormalMap,
    DPE.cpp:450-473); zero normals stay at 127."""
    norm = np.linalg.norm(normal, axis=-1, keepdims=True)
    n = np.where(norm > 0, normal / np.maximum(norm, 1e-12), 0.0)
    return np.clip(n * 127.5 + 127.5, 0, 255).astype(np.uint8)


def weak_to_color(weak: np.ndarray) -> np.ndarray:
    """ShowWeakImage (DPE.cpp:475-502): WEAK white, STRONG green, UNKNOWN
    red."""
    img = np.zeros((*weak.shape, 3), np.uint8)
    img[weak == int(PixelState.WEAK)] = (255, 255, 255)
    img[weak == int(PixelState.STRONG)] = (0, 255, 0)
    img[weak == int(PixelState.UNKNOWN)] = (0, 0, 255)
    return img


def edge_to_color(edge: np.ndarray) -> np.ndarray:
    """ShowEdgeImage (DPE.cpp:504-530): edges white on black."""
    img = np.zeros((*edge.shape, 3), np.uint8)
    img[edge > 0] = (255, 255, 255)
    return img


def label_to_color(label: np.ndarray) -> np.ndarray:
    """The coarse regions coloured by id (``connect_<s>.jpg``,
    main.cpp:382): a colour per id from ``default_rng(0)``, black on edges
    (0) and small regions (-1)."""
    rng = np.random.default_rng(0)
    colors = rng.integers(0, 256, (label.max() + 2, 3), np.uint8)
    colors[0] = 0
    img = colors[np.maximum(label, 0)]
    img[label < 0] = 0
    return img


def save_depth_map(path, depth, depth_min, depth_max) -> None:
    imread.write_png_color(path, depth_to_color(depth, depth_min, depth_max))


def save_normal_map(path, normal: np.ndarray) -> None:
    imread.write_png_color(path, normal_to_color(normal))


def save_weak_map(path, weak: np.ndarray) -> None:
    imread.write_png_color(path, weak_to_color(weak))


def save_edge_map(path, edge: np.ndarray) -> None:
    imread.write_png_color(path, edge_to_color(edge))


def save_label_map(path, label: np.ndarray) -> None:
    imread.write_png_color(path, label_to_color(label))
