"""The benchmark's scenes: a frozen copy of the port's synthetic plane scene.

A seeded textured plane (optionally with a texture-less patch) seen by a
ring of cameras, with its analytic ground truth, and the writers that lay it
out as a dense folder (``images/%08d.jpg`` as lossless PNG bytes,
``cams/%08d_cam.txt``, ``pair.txt``) and write a view's truth at a coarser
size as the previous round's output (``depths.dmb``, ``normals.dmb``,
``selected_views.bin``, ``weak.bin``).

Copied from ``dpe_mvs_tpu_torch/utils/synthetic.py`` (``make_plane_scene``,
``write_scene_folder`` without the JPEG option, ``write_coarse_priors``) and
``dpe_mvs_tpu_torch/io/formats.py`` / ``io/imread.py`` (the ``.dmb``, camera,
pair and PNG writers), so that the benchmark's traffic stays what it is
whatever the program later changes. It imports nothing of the program;
``mvs_bench/tests/test_mvs_bench_scene.py`` holds it bit-equal to the program's
generator.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import struct
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np

STRONG = 1          # PixelState.STRONG of the program's weak map


@dataclasses.dataclass
class Camera:
    K: np.ndarray            # (3, 3) float32
    R: np.ndarray            # (3, 3) float32, world -> camera
    t: np.ndarray            # (3,) float32
    depth_min: float
    depth_max: float
    width: int
    height: int


@dataclasses.dataclass
class PlaneScene:
    images: List[np.ndarray]           # per view (H, W) float32 in [0, 255]
    cameras: List[Camera]
    gt_depths: List[np.ndarray]        # per view (H, W) float32
    gt_normals: List[np.ndarray]       # per view (H, W, 3), world frame
    width: int
    height: int
    plane_normal: np.ndarray           # (3,) world-frame unit normal n
    plane_offset: float                # the plane is n . X = plane_offset
    weak_box: Optional[tuple] = None   # (y0, y1, x0, x1) of the patch

    def src_ids(self, ref: int) -> List[int]:
        """Source views of problem ``ref`` as ``pair.txt`` lists them."""
        return [s for s in range(len(self.images)) if s != ref]


def _cubic_matrix(n_out: int, n_in: int) -> np.ndarray:
    a = -0.75
    sx = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(sx).astype(np.int64)
    t = sx - x0
    M = np.zeros((n_out, n_in), np.float64)
    for k in range(-1, 3):
        d = np.abs(t - k)
        w = np.where(d <= 1, ((a + 2) * d - (a + 3)) * d * d + 1,
                     np.where(d < 2, ((a * d - 5 * a) * d + 8 * a) * d - 4 * a,
                              0.0))
        idx = np.clip(x0 + k, 0, n_in - 1)
        np.add.at(M, (np.arange(n_out), idx), w)
    return M


def procedural_texture(rng: np.random.Generator, size: int = 1024
                       ) -> np.ndarray:
    tex = np.zeros((size, size), np.float32)
    for octave, amp in [(8, 0.5), (32, 0.3), (128, 0.2)]:
        g = rng.standard_normal((octave, octave)).astype(np.float32)
        M = _cubic_matrix(size, octave)
        tex += amp * (M @ g @ M.T).astype(np.float32)
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return (tex * 235.0 + 10.0).astype(np.float32)


def _bilinear(tex: np.ndarray, u: np.ndarray, w: np.ndarray) -> np.ndarray:
    H, W = tex.shape
    x0 = np.clip(np.floor(u).astype(np.int64), 0, W - 1)
    y0 = np.clip(np.floor(w).astype(np.int64), 0, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = (u - x0).astype(np.float32)
    fy = (w - y0).astype(np.float32)
    top = tex[y0, x0] * (1 - fx) + tex[y0, x1] * fx
    bot = tex[y1, x0] * (1 - fx) + tex[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def _look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0, -1.0, 0])):
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


def _ring_camera(K, width, height, v, num_views, radius, depth0):
    ang = 2 * np.pi * v / max(num_views, 1)
    eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 0.0],
                   np.float32)
    if v == 0:
        eye = np.zeros(3, np.float32)
    R, t = _look_at(eye, np.array([0, 0, depth0], np.float32))
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    rays = np.stack([(xs - K[0, 2]) / K[0, 0],
                     (ys - K[1, 2]) / K[1, 1],
                     np.ones_like(xs)], axis=-1)
    return eye, R, t, rays @ R


def weak_box(width: int, height: int) -> tuple:
    """(y0, y1, x0, x1): the texture-less patch, the same pixels in every
    view."""
    return (int(0.35 * height), int(0.65 * height), int(0.2 * width),
            int(0.6 * width))


def make_plane_scene(*, width: int, height: int, num_views: int,
                     depth0: float = 4.0, tilt: float = 0.15,
                     weak_patch: bool = False, seed: int = 0) -> PlaneScene:
    """Render a tilted textured plane (optionally with a texture-less patch
    in image space) from a ring of cameras: view 0 at the origin, the others
    on a circle of radius 0.25, all looking at (0, 0, depth0)."""
    rng = np.random.default_rng(seed)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]],
                 np.float32)
    tex = procedural_texture(rng)
    tex_scale = 80.0

    n1 = np.array([0.0, np.sin(tilt), -np.cos(tilt)], np.float32)
    n1 = n1 / np.linalg.norm(n1)
    c1 = float(n1 @ np.array([0, 0, depth0]))
    radius = 0.25
    box = weak_box(width, height) if weak_patch else None

    def render(v):
        eye_w, R, t, rays_w = _ring_camera(K, width, height, v, num_views,
                                           radius, depth0)
        denom = rays_w @ n1
        s1 = (c1 - eye_w @ n1) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
        Xw = eye_w + rays_w * s1[..., None]
        depth = (Xw - eye_w) @ R[2]
        normal = np.broadcast_to(n1, Xw.shape)
        u = np.mod(Xw[..., 0] * tex_scale, tex.shape[1] - 1)
        w_ = np.mod(Xw[..., 1] * tex_scale, tex.shape[0] - 1)
        img = _bilinear(tex, u, w_)
        if box is not None:
            y0, y1, x0, x1 = box
            band = np.zeros((height, width), bool)
            band[y0:y1, x0:x1] = True
            img = np.where(band, float(img.mean()), img)
        dmin = float(depth.min() * 0.9)
        dmax = float(depth.max() * 1.1)
        return (np.clip(img, 0, 255).astype(np.uint8).astype(np.float32),
                Camera(K=K.copy(), R=R, t=t, depth_min=dmin, depth_max=dmax,
                       width=width, height=height),
                depth.astype(np.float32), normal.astype(np.float32))

    with cf.ThreadPoolExecutor(max(1, min(num_views, os.cpu_count() or 1))
                               ) as pool:
        views = list(pool.map(render, range(num_views)))
    images, cameras, gt_depths, gt_normals = (list(x) for x in zip(*views))
    return PlaneScene(images=images, cameras=cameras, gt_depths=gt_depths,
                      gt_normals=gt_normals, width=width, height=height,
                      plane_normal=n1.astype(np.float64), plane_offset=c1,
                      weak_box=box)


# --------------------------------------------------------------------------
# Writers (the program's file formats)
# --------------------------------------------------------------------------

_CV_DEPTH = {np.dtype(np.uint8): 0, np.dtype(np.int8): 1,
             np.dtype(np.uint16): 2, np.dtype(np.int16): 3,
             np.dtype(np.int32): 4, np.dtype(np.float32): 5,
             np.dtype(np.float64): 6}
_CV_DTYPE = {v: k for k, v in _CV_DEPTH.items()}


def write_dmb(path, arr: np.ndarray) -> None:
    """A ``.dmb`` mat: little-endian {1, rows, cols, cvtype}, then the
    data."""
    arr = np.ascontiguousarray(arr)
    rows, cols = arr.shape[:2]
    channels = arr.shape[2] if arr.ndim == 3 else 1
    cvtype = _CV_DEPTH[arr.dtype] + ((channels - 1) << 3)
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", 1, rows, cols, cvtype))
        arr.tofile(f)


def read_dmb(path) -> np.ndarray:
    with open(path, "rb") as f:
        version, rows, cols, cvtype = struct.unpack("<iiii", f.read(16))
        if version != 1:
            raise ValueError(f"dmb version {version} in {path}")
        channels = (cvtype >> 3) + 1
        data = np.fromfile(f, dtype=_CV_DTYPE[cvtype & 7],
                           count=rows * cols * channels)
    arr = data.reshape(rows, cols, channels)
    return arr[..., 0] if channels == 1 else arr


def write_png_gray(path, img: np.ndarray) -> None:
    """An 8-bit gray PNG, one IDAT, filter 0 on every row."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_cam_txt(path, cam: Camera) -> None:
    """The reference converter's layout, with the depth line ``dmin,
    (dmax - dmin) / 192, 192, dmax``."""
    ext = np.eye(4, dtype=np.float64)
    ext[:3, :3] = cam.R
    ext[:3, 3] = cam.t
    dmin, dmax = cam.depth_min, cam.depth_max
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in ext:
            f.write(" ".join(f"{v}" for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in np.asarray(cam.K):
            f.write(" ".join(f"{v}" for v in row) + "\n")
        f.write(f"\n{dmin} {(dmax - dmin) / 192.0} 192 {dmax}\n")


def write_scene_folder(scene: PlaneScene, folder) -> Path:
    """The scene as a dense folder; ``pair.txt`` lists every other view at
    score 100. PNG encoding runs in threads (zlib releases the interpreter
    lock)."""
    folder = Path(folder)
    (folder / "images").mkdir(parents=True, exist_ok=True)
    (folder / "cams").mkdir(parents=True, exist_ok=True)

    def write(v):
        write_png_gray(folder / "images" / f"{v:08d}.jpg",
                       scene.images[v].astype(np.uint8))
        write_cam_txt(folder / "cams" / f"{v:08d}_cam.txt", scene.cameras[v])

    n = len(scene.images)
    with cf.ThreadPoolExecutor(max(1, min(n, os.cpu_count() or 1))) as pool:
        list(pool.map(write, range(n)))
    with open(folder / "pair.txt", "w") as f:
        f.write(f"{n}\n")
        for v in range(n):
            srcs = scene.src_ids(v)
            f.write(f"{v}\n{len(srcs)} ")
            f.write(" ".join(f"{s} {100.0}" for s in srcs) + "\n")
    return folder


def result_folder(dense_folder, view: int) -> Path:
    return Path(dense_folder) / "DPE" / f"{view:08d}"


def write_coarse_priors(scene: PlaneScene, ref: int, result_dir,
                        step: int) -> Path:
    """View ``ref``'s ground truth at 1 / ``step`` of the frame, written as
    the previous round's output: the depth and normal of every
    ``step``-th pixel, every source selected, every pixel STRONG."""
    rf = Path(result_dir)
    rf.mkdir(parents=True, exist_ok=True)
    depth = scene.gt_depths[ref][::step, ::step]
    n_src = len(scene.images) - 1
    write_dmb(rf / "depths.dmb", depth.astype(np.float32))
    write_dmb(rf / "normals.dmb",
              scene.gt_normals[ref][::step, ::step].astype(np.float32))
    write_dmb(rf / "selected_views.bin",
              np.full(depth.shape, (1 << min(n_src, 31)) - 1, np.int32))
    write_dmb(rf / "weak.bin", np.full(depth.shape, STRONG, np.uint8))
    return rf
