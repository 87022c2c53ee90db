"""Synthetic MVS scenes with known ground truth.

Port of :func:`dpe_mvs_tpu.utils.synthetic.make_plane_scene` and
:func:`~dpe_mvs_tpu.utils.synthetic.make_rich_scene` without OpenCV,
rendered in memory: the same cameras, depth ranges and ground-truth depths
and normals for the same arguments and seed, and a texture of the same kind
(three octaves of seeded noise, bicubic-upsampled) sampled bilinearly. The
images are quantized to uint8 as the folder version's are.
:func:`write_scene_folder` writes a scene as a dense folder, its images as
lossless PNG bytes (the JAX package stores JPEG; asked for, the pixels a
JPEG decodes to).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..config import PixelState
from ..engine.state import CameraData, ProblemInputs
from ..io import formats, imread


def _cubic_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bicubic resampling matrix (Keys, a = -0.75; half-pixel
    centers; edge-clamped taps)."""
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


def procedural_texture(rng: np.random.Generator, size: int = 1024) -> np.ndarray:
    """Smooth but feature-rich grayscale texture in [0, 255]."""
    tex = np.zeros((size, size), np.float32)
    for octave, amp in [(8, 0.5), (32, 0.3), (128, 0.2)]:
        g = rng.standard_normal((octave, octave)).astype(np.float32)
        M = _cubic_matrix(size, octave)
        tex += amp * (M @ g @ M.T).astype(np.float32)
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return (tex * 235.0 + 10.0).astype(np.float32)


def _bilinear(tex: np.ndarray, u: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Bilinear sample of ``tex`` at float (column u, row w), in range."""
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
    """World->cam extrinsics of a camera at ``eye`` looking at ``target``."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


def _ring_camera(K: np.ndarray, width: int, height: int, v: int,
                 num_views: int, radius: float, depth0: float):
    """View v of the ring of cameras looking at (0, 0, depth0): view 0 at
    the origin, the others on a circle of ``radius`` in the z = 0 plane.
    Returns (eye, R, t, world-frame ray directions (H, W, 3))."""
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
    return eye, R, t, rays @ R  # R^T applied row-wise


@dataclasses.dataclass
class PlaneScene:
    images: List[np.ndarray]           # per-view (H, W) float32 in [0, 255]
    cameras: List[CameraData]          # per-view, depth range from the scene
    gt_depths: List[np.ndarray]        # per-view (H, W) float32
    gt_normals: List[np.ndarray]       # per-view (H, W, 3) world-frame
    width: int
    height: int
    weak_region: Optional[np.ndarray] = None

    def src_ids(self, ref: int) -> List[int]:
        """Source views of problem ``ref``, as the folder's pair.txt lists
        them (every other view, in index order)."""
        return [s for s in range(len(self.images)) if s != ref]

    def problem_inputs(self, ref: int) -> ProblemInputs:
        """The inputs of problem ``ref`` as ``scene.load_problem_inputs``
        assembles them at scale 1 (depth range widened by 0.6 / 1.2)."""
        ids = [ref] + self.src_ids(ref)
        cams = [self.cameras[i] for i in ids]
        return ProblemInputs(
            images=np.stack([self.images[i] for i in ids]),
            cameras=cams,
            depth_min=cams[0].depth_min * 0.6,
            depth_max=cams[0].depth_max * 1.2,
            width=self.width, height=self.height)


def make_plane_scene(*, width: int = 160, height: int = 120,
                     num_views: int = 4, depth0: float = 4.0,
                     tilt: float = 0.15, step: bool = False,
                     weak_patch: bool = False, seed: int = 0) -> PlaneScene:
    """Render a tilted textured plane (optionally with a depth step and a
    texture-less patch) from a ring of cameras."""
    rng = np.random.default_rng(seed)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]],
                 np.float32)
    tex = procedural_texture(rng)
    tex_scale = 80.0  # world-units -> texture pixels

    n1 = np.array([0.0, np.sin(tilt), -np.cos(tilt)], np.float32)
    n1 = n1 / np.linalg.norm(n1)
    c1 = float(n1 @ np.array([0, 0, depth0]))
    n2 = n1
    c2 = float(n1 @ np.array([0, 0, depth0 * 0.8]))

    radius = 0.25

    def render(v):
        eye_w, R, t, rays_w = _ring_camera(K, width, height, v, num_views,
                                           radius, depth0)

        def hit(n, c):
            denom = rays_w @ n
            return (c - eye_w @ n) / np.where(np.abs(denom) > 1e-9, denom,
                                              1e-9)

        s1 = hit(n1, c1)
        Xw = eye_w + rays_w * s1[..., None]
        use2 = np.zeros((height, width), bool)
        if step:
            s2 = hit(n2, c2)
            X2 = eye_w + rays_w * s2[..., None]
            use2 = (X2[..., 0] > 0.35) & (s2 > 0)
            Xw = np.where(use2[..., None], X2, Xw)
        depth = (Xw - eye_w) @ R[2]  # z in camera frame
        normal = np.where(use2[..., None], n2, n1)

        u = np.mod(Xw[..., 0] * tex_scale, tex.shape[1] - 1)
        w_ = np.mod(Xw[..., 1] * tex_scale, tex.shape[0] - 1)
        img = _bilinear(tex, u, w_)
        band = None
        if weak_patch:
            wy0, wy1 = int(0.35 * height), int(0.65 * height)
            wx0, wx1 = int(0.2 * width), int(0.6 * width)
            band = np.zeros((height, width), bool)
            band[wy0:wy1, wx0:wx1] = True
            img = np.where(band, float(img.mean()), img)
        dmin = float(depth.min() * 0.9)
        dmax = float(depth.max() * 1.1)
        return (np.clip(img, 0, 255).astype(np.uint8).astype(np.float32),
                CameraData(K=K.copy(), R=R, t=t, depth_min=dmin,
                           depth_max=dmax, width=width, height=height),
                depth.astype(np.float32), normal.astype(np.float32), band)

    # The views share nothing but the texture: render them in threads
    # (numpy releases the interpreter lock in the large array operations).
    with cf.ThreadPoolExecutor(max(1, min(num_views,
                                          os.cpu_count() or 1))) as pool:
        views = list(pool.map(render, range(num_views)))
    images, cameras, gt_depths, gt_normals, bands = (list(x)
                                                     for x in zip(*views))
    return PlaneScene(images=images, cameras=cameras, gt_depths=gt_depths,
                      gt_normals=gt_normals, width=width, height=height,
                      weak_region=bands[0])


def make_rich_scene(*, width: int = 640, height: int = 480,
                    num_views: int = 10, depth0: float = 4.0,
                    weak_fraction: float = 0.25, seed: int = 0) -> PlaneScene:
    """A harder ground-truth scene: two oblique planes, a sphere cap (curved
    surface), a foreground occluder slab, and large view-consistent
    weak-texture regions (blanked in texture space, so every view sees the
    same textureless world area). Ray-cast per view: nearest positive hit
    over all surfaces, so occlusions fall out naturally."""
    rng = np.random.default_rng(seed)
    f = 0.9 * width
    K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]],
                 np.float32)
    tex = procedural_texture(rng)
    # View-consistent weak regions: blank rectangles of the texture itself.
    for _ in range(max(1, int(weak_fraction * 8))):
        ty = rng.integers(0, tex.shape[0] - tex.shape[0] // 3)
        tx = rng.integers(0, tex.shape[1] - tex.shape[1] // 3)
        th = rng.integers(tex.shape[0] // 6, tex.shape[0] // 3)
        tw = rng.integers(tex.shape[1] // 6, tex.shape[1] // 3)
        tex[ty:ty + th, tx:tx + tw] = float(tex.mean())
    tex_scale = 80.0

    # Surfaces: the base plane tilted about x; a side plane strongly oblique
    # about y covering x > 0.45; a sphere cap bulging toward the cameras; an
    # occluder slab floating nearer, over a small (x, y) window.
    tilt = 0.18
    n1 = np.array([0.0, np.sin(tilt), -np.cos(tilt)], np.float32)
    n1 /= np.linalg.norm(n1)
    c1 = float(n1 @ np.array([0, 0, depth0]))
    obl = 0.5
    n2 = np.array([np.sin(obl), 0.0, -np.cos(obl)], np.float32)
    n2 /= np.linalg.norm(n2)
    c2 = float(n2 @ np.array([0.45, 0, depth0 * 0.97]))
    sph_c = np.array([-0.45, -0.25, depth0 * 0.92], np.float32)
    sph_r = 0.5
    n4 = np.array([0.0, 0.0, -1.0], np.float32)
    c4 = float(n4 @ np.array([0, 0, depth0 * 0.55]))
    BIG = 1e30

    images, cameras, gt_depths, gt_normals = [], [], [], []
    for v in range(num_views):
        eye, R, t, d = _ring_camera(K, width, height, v, num_views, 0.3,
                                    depth0)

        def plane_hit(n, c, limit=None):
            denom = d @ n
            s = (c - eye @ n) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
            ok = s > 0.1
            if limit is not None:
                ok &= limit(eye + d * s[..., None])
            return np.where(ok, s, BIG), np.broadcast_to(n, d.shape)

        s1, nn1 = plane_hit(n1, c1)
        s2, nn2 = plane_hit(n2, c2, limit=lambda X: X[..., 0] > 0.45)
        # Sphere: |eye + s d - C|^2 = r^2, the smaller positive root.
        oc = eye - sph_c
        b = 2.0 * (d * oc).sum(-1)
        a = (d * d).sum(-1)
        cq = float(oc @ oc) - sph_r * sph_r
        disc = b * b - 4 * a * cq
        sq = np.sqrt(np.maximum(disc, 0.0))
        s3 = (-b - sq) / (2 * a)
        s3 = np.where((disc > 0) & (s3 > 0.1), s3, BIG)
        nn3 = (eye + d * s3[..., None] - sph_c) / sph_r
        flip = (nn3 * d).sum(-1) > 0
        nn3 = np.where(flip[..., None], -nn3, nn3)
        s4, nn4 = plane_hit(
            n4, c4, limit=lambda X: (np.abs(X[..., 0] - 0.1) < 0.22)
            & (np.abs(X[..., 1] - 0.3) < 0.15))

        ss = np.stack([s1, s2, s3, s4])
        pick = np.argmin(ss, axis=0)
        s = np.take_along_axis(ss, pick[None], axis=0)[0]
        normal = np.take_along_axis(np.stack([nn1, nn2, nn3, nn4]),
                                    pick[None, ..., None], axis=0)[0]
        Xw = eye + d * s[..., None]
        depth = (Xw - eye) @ R[2]

        u = np.mod(Xw[..., 0] * tex_scale, tex.shape[1] - 1)
        w_ = np.mod(Xw[..., 1] * tex_scale, tex.shape[0] - 1)
        img = _bilinear(tex, u.astype(np.float32), w_.astype(np.float32))
        images.append(np.clip(img, 0, 255).astype(np.uint8)
                      .astype(np.float32))
        dmin = float(depth.min() * 0.9)
        dmax = float(depth.max() * 1.1)
        cameras.append(CameraData(K=K.copy(), R=R, t=t, depth_min=dmin,
                                  depth_max=dmax, width=width, height=height))
        gt_depths.append(depth.astype(np.float32))
        gt_normals.append(normal.astype(np.float32))
    return PlaneScene(images=images, cameras=cameras, gt_depths=gt_depths,
                      gt_normals=gt_normals, width=width, height=height)


def write_scene_folder(scene: PlaneScene, folder,
                       jpeg_quality: Optional[int] = None) -> Path:
    """Write ``scene`` as a dense folder (the folder half of the JAX
    package's ``make_plane_scene``): each view's uint8 image as PNG bytes at
    ``images/%08d.jpg`` (readers decode by signature), ``cams/%08d_cam.txt``
    with the depth line ``dmin, (dmax - dmin) / 192, 192, dmax``, and
    ``pair.txt`` listing every other view at score 100. With
    ``jpeg_quality`` the images hold the pixels a JPEG at that quality
    decodes to (``imread.jpeg_roundtrip_gray``; the JAX package writes JPEG
    at 98), still as PNG bytes. Returns the folder."""
    folder = Path(folder)
    (folder / "images").mkdir(parents=True, exist_ok=True)
    (folder / "cams").mkdir(parents=True, exist_ok=True)
    pairs = []
    for v, (img, cam) in enumerate(zip(scene.images, scene.cameras)):
        img = img.astype(np.uint8)
        if jpeg_quality is not None:
            img = imread.jpeg_roundtrip_gray(img, jpeg_quality)
        imread.write_png_gray(folder / "images" / f"{v:08d}.jpg", img)
        dmin, dmax = cam.depth_min, cam.depth_max
        formats.write_cam_txt(folder / "cams" / f"{v:08d}_cam.txt", cam.K,
                              cam.R, cam.t, dmin, (dmax - dmin) / 192.0, 192,
                              dmax)
        pairs.append((v, [(s, 100.0) for s in scene.src_ids(v)]))
    formats.write_pair_txt(folder / "pair.txt", pairs)
    return folder


def write_coarse_priors(scene: PlaneScene, ref: int, result_folder,
                        step: int = 2) -> Path:
    """Write view ``ref``'s ground truth at 1 / ``step`` of the frame (half
    by default) into ``result_folder`` as the previous sweep's writeback,
    which a later pass reads through ``io.scene.add_pass_inputs``
    (``rescale_nearest`` brings it to the frame): the depth and normal of
    every ``step``-th pixel, every source view selected, every pixel
    STRONG."""
    rf = Path(result_folder)
    rf.mkdir(parents=True, exist_ok=True)
    depth = scene.gt_depths[ref][::step, ::step]
    n_src = len(scene.images) - 1
    formats.write_dmb(rf / "depths.dmb", depth.astype(np.float32))
    formats.write_dmb(rf / "normals.dmb",
                      scene.gt_normals[ref][::step, ::step].astype(
                          np.float32))
    formats.write_dmb(rf / "selected_views.bin",
                      np.full(depth.shape, (1 << n_src) - 1, np.int32))
    formats.write_dmb(rf / "weak.bin", np.full(
        depth.shape, int(PixelState.STRONG), np.uint8))
    return rf


def support_maps(image: np.ndarray, edge_percentile: float = 85.0):
    """In-memory stand-in for a problem's (edge, edge_low, label) support
    maps, for driving the weak machinery and the edge-bounded sampling
    without a dense folder.

    The pipeline's maps come from :mod:`dpe_mvs_tpu_torch.edges.dual_level`
    (Canny edges and Hough-completed Roberts regions, cached per scale by
    ``pipeline.schedule.get_problem_edges``). Here, with numpy and scipy:

      - ``edge``: the Sobel gradient magnitude above its
        ``edge_percentile``-th percentile;
      - ``edge_low``: its 2x reduction (a low-res pixel is an edge where any
        of its 2x2 block is), standing in for the coarse round's edge map;
      - ``label``: the connected non-edge regions (``scipy.ndimage.label``)
        with the reference's convention: 0 on edges, -1 for regions of at
        most H*W/1024 pixels, a region id > 0 otherwise.
    """
    from scipy import ndimage
    img = np.asarray(image, np.float32)
    H, W = img.shape
    mag = np.hypot(ndimage.sobel(img, axis=1), ndimage.sobel(img, axis=0))
    edge = mag > np.percentile(mag, edge_percentile)
    h2, w2 = max(H // 2, 1), max(W // 2, 1)
    edge_low = edge[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2).any(axis=(1, 3))
    lab, _n = ndimage.label(~edge)
    counts = np.bincount(lab.ravel())
    small = counts[lab] <= int(H * W / 1024)
    label = np.where(small & (lab != 0), -1, lab).astype(np.int32)
    return edge, edge_low, label
