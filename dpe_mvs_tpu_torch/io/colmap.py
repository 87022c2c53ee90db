"""COLMAP sparse model -> DPE scene converter (reference C13,
``src/DPE_MVS/colmap2mvsnet.py``).

Port of :mod:`dpe_mvs_tpu.io.colmap`, host numpy, with no OpenCV: images
are read through :mod:`.imread` (BGR, as OpenCV's ``imread`` gives them),
nearest-resampled by OpenCV's ``INTER_NEAREST`` index map
(:func:`resize_nearest`) and written as JPEG at quality 95 through Pillow
(the cams and ``pair.txt`` are byte for byte the JAX package's; the images
decode to the same pixels). Run as
``python -m dpe_mvs_tpu_torch.io.colmap --dense_folder ... --save_folder
...``.

Produces ``cams/%08d_cam.txt``, ``pair.txt`` and padded ``images/%08d.jpg``
with the reference's exact conventions:
  - per-image depth range from sparse-point z percentiles
    ``[1%·0.75, 99%·1.25]`` (colmap2mvsnet.py:394-408);
  - inverse-depth plane count when ``max_d == 0`` (:411-424);
  - pairwise view score = count of shared 3D points, zeroed when the 75th
    percentile triangulation angle is < 1° (``calc_score``, :305-327) — here
    vectorized with NumPy instead of a multiprocessing pool;
  - top-20 source views per image (:443-446);
  - images zero-padded to the common max size, nearest-resampled by
    ``scale_factor`` (:475-494).

Improvement over the reference: the sparse-model directory is a parameter
(the reference hardcodes the ETH3D layout ``dslr_calibration_undistorted``,
:332); ``sparse/0``-style COLMAP outputs work out of the box.
"""
from __future__ import annotations

import dataclasses
import os
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import imread


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}

PARAM_TYPE = {
    "SIMPLE_PINHOLE": ["f", "cx", "cy"],
    "PINHOLE": ["fx", "fy", "cx", "cy"],
    "SIMPLE_RADIAL": ["f", "cx", "cy", "k"],
    "SIMPLE_RADIAL_FISHEYE": ["f", "cx", "cy", "k"],
    "RADIAL": ["f", "cx", "cy", "k1", "k2"],
    "RADIAL_FISHEYE": ["f", "cx", "cy", "k1", "k2"],
    "OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"],
    "OPENCV_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"],
    "FULL_OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3",
                    "k4", "k5", "k6"],
    "FOV": ["fx", "fy", "cx", "cy", "omega"],
    "THIN_PRISM_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2",
                           "k3", "k4", "sx1", "sy1"],
}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    q = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    return -q if q[0] < 0 else q


# ---------------------------------------------------------------------------
# Model readers (txt + bin)
# ---------------------------------------------------------------------------

def read_cameras_txt(path) -> Dict[int, ColmapCamera]:
    out = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        out[int(el[0])] = ColmapCamera(
            id=int(el[0]), model=el[1], width=int(el[2]), height=int(el[3]),
            params=np.array([float(x) for x in el[4:]]))
    return out


def read_images_txt(path) -> Dict[int, ColmapImage]:
    out = {}
    lines = [ln.strip() for ln in open(path)
             if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(x) for x in pts]).reshape(-1, 3) if pts else \
            np.zeros((0, 3))
        out[int(el[0])] = ColmapImage(
            id=int(el[0]),
            qvec=np.array([float(x) for x in el[1:5]]),
            tvec=np.array([float(x) for x in el[5:8]]),
            camera_id=int(el[8]), name=el[9],
            xys=xys[:, :2], point3D_ids=xys[:, 2].astype(np.int64))
    return out


def read_points3d_txt(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        out[int(el[0])] = ColmapPoint3D(
            id=int(el[0]), xyz=np.array([float(x) for x in el[1:4]]),
            rgb=np.array([int(x) for x in el[4:7]]), error=float(el[7]))
    return out


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_bin(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, mid, w, h = _read(f, 24, "iiQQ")
            name, num_params = CAMERA_MODELS[mid]
            params = np.array(_read(f, 8 * num_params, "d" * num_params))
            out[cid] = ColmapCamera(id=cid, model=name, width=w, height=h,
                                    params=params)
    return out


def read_images_bin(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            q = np.array(_read(f, 32, "dddd"))
            t = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (npts,) = _read(f, 8, "Q")
            data = np.frombuffer(f.read(24 * npts),
                                 dtype=[("xy", np.float64, 2),
                                        ("id", np.int64)])
            out[iid] = ColmapImage(
                id=iid, qvec=q, tvec=t, camera_id=cam_id,
                name=name.decode(), xys=data["xy"].copy(),
                point3D_ids=data["id"].copy())
    return out


def read_points3d_bin(path) -> Dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            pid = _read(f, 8, "Q")[0]
            xyz = np.array(_read(f, 24, "ddd"))
            rgb = np.array(_read(f, 3, "BBB"))
            (err,) = _read(f, 8, "d")
            (track_len,) = _read(f, 8, "Q")
            f.read(8 * track_len)
            out[pid] = ColmapPoint3D(id=pid, xyz=xyz, rgb=rgb, error=err)
    return out


def read_model(model_dir, ext: Optional[str] = None):
    model_dir = Path(model_dir)
    if ext is None:
        ext = ".bin" if (model_dir / "cameras.bin").exists() else ".txt"
    if ext == ".txt":
        return (read_cameras_txt(model_dir / "cameras.txt"),
                read_images_txt(model_dir / "images.txt"),
                read_points3d_txt(model_dir / "points3D.txt"))
    return (read_cameras_bin(model_dir / "cameras.bin"),
            read_images_bin(model_dir / "images.bin"),
            read_points3d_bin(model_dir / "points3D.bin"))


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

def resize_nearest(img: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """OpenCV's nearest resize (``INTER_NEAREST``) to (rows, cols): source
    index ``floor(dst * (1 / (dst_size / src_size)))`` per axis, in double
    precision as OpenCV computes it, clipped to the last pixel."""
    H, W = img.shape[:2]
    ify = 1.0 / (rows / H)
    ifx = 1.0 / (cols / W)
    ys = np.minimum(np.floor(np.arange(rows) * ify).astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(cols) * ifx).astype(np.int64), W - 1)
    return img[ys[:, None], xs[None, :]]


def _find_model_dir(dense_folder: Path) -> Path:
    for cand in ("dslr_calibration_undistorted", "sparse/0", "sparse",
                 "model", "."):
        d = dense_folder / cand
        if (d / "cameras.txt").exists() or (d / "cameras.bin").exists():
            return d
    raise FileNotFoundError(f"no COLMAP model found under {dense_folder}")


def view_scores(images: Dict[int, ColmapImage],
                points3d: Dict[int, ColmapPoint3D],
                extrinsics: Dict[int, np.ndarray]) -> np.ndarray:
    """Pairwise shared-point counts, zeroed if the 75th-percentile
    triangulation angle is < 1 degree (``calc_score``), vectorized."""
    n = len(images)
    ids = sorted(images.keys())
    pt_ids = [set(int(p) for p in images[i].point3D_ids if p != -1)
              for i in ids]
    centers = []
    for i in ids:
        e = extrinsics[i]
        centers.append(-e[:3, :3].T @ e[:3, 3])
    score = np.zeros((n, n))
    xyz = {pid: p.xyz for pid, p in points3d.items()}
    for a in range(n):
        for b in range(a + 1, n):
            shared = pt_ids[a] & pt_ids[b]
            if not shared:
                continue
            P = np.stack([xyz[p] for p in shared])
            va = centers[a][None] - P
            vb = centers[b][None] - P
            cosang = np.sum(va * vb, -1) / (
                np.linalg.norm(va, axis=-1) * np.linalg.norm(vb, axis=-1))
            theta = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
            s = float(len(shared))
            t75 = np.sort(theta)[int(len(theta) * 0.75)]
            if t75 < 1.0:
                s = 0.0
            score[a, b] = score[b, a] = s
    return score


def colmap_to_dpe(
    dense_folder,
    save_folder,
    *,
    model_dir=None,
    model_ext: Optional[str] = None,
    max_d: int = 192,
    interval_scale: float = 1.0,
    scale_factor: float = 1.0,
    num_src_views: int = 20,
) -> None:
    """Convert a COLMAP workspace into the DPE scene layout
    (``processing_single_scene``, colmap2mvsnet.py:329-494)."""
    dense_folder = Path(dense_folder)
    save_folder = Path(save_folder)
    image_dir = dense_folder / "images"
    model_dir = Path(model_dir) if model_dir else _find_model_dir(dense_folder)
    cam_dir = save_folder / "cams"
    out_img_dir = save_folder / "images"
    cam_dir.mkdir(parents=True, exist_ok=True)
    out_img_dir.mkdir(parents=True, exist_ok=True)

    cameras, images_raw, points3d = read_model(model_dir, model_ext)

    # Renumber images 1..N in sorted-id order (colmap2mvsnet.py:377-380).
    images = {i + 1: images_raw[k]
              for i, k in enumerate(sorted(images_raw.keys()))}
    num_images = len(images)

    intrinsic = {}
    for cid, cam in cameras.items():
        pd = dict(zip(PARAM_TYPE[cam.model], cam.params))
        if "f" in PARAM_TYPE[cam.model]:
            pd["fx"] = pd["fy"] = pd["f"]
        intrinsic[cid] = np.array([
            [pd["fx"] / scale_factor, 0, pd["cx"] / scale_factor],
            [0, pd["fy"] / scale_factor, pd["cy"] / scale_factor],
            [0, 0, 1.0]])

    extrinsic = {}
    for iid, im in images.items():
        e = np.eye(4)
        e[:3, :3] = qvec2rotmat(im.qvec)
        e[:3, 3] = im.tvec
        extrinsic[iid] = e

    # Depth ranges from sparse z percentiles (colmap2mvsnet.py:394-427).
    depth_ranges = {}
    for i in range(num_images):
        im = images[i + 1]
        zs = []
        e = extrinsic[i + 1]
        for pid in im.point3D_ids:
            if pid == -1 or pid not in points3d:
                continue
            z = (e[:3, :3] @ points3d[pid].xyz + e[:3, 3])[2]
            zs.append(float(z))
        depth_min = depth_max = 0.0
        if zs:
            zs_sorted = sorted(zs)
            depth_min = zs_sorted[int(len(zs) * 0.01)] * 0.75
            depth_max = zs_sorted[int(len(zs) * 0.99)] * 1.25
        if max_d == 0:
            Kinv = np.linalg.inv(intrinsic[im.camera_id])
            R = e[:3, :3]
            t = e[:3, 3]
            p1 = np.array([intrinsic[im.camera_id][0, 2],
                           intrinsic[im.camera_id][1, 2], 1.0])
            p2 = p1 + np.array([1.0, 0, 0])
            P1 = np.linalg.inv(R) @ (Kinv @ p1 * depth_min - t)
            P2 = np.linalg.inv(R) @ (Kinv @ p2 * depth_min - t)
            depth_num = (1 / depth_min - 1 / depth_max) / (
                1 / depth_min - 1 / (depth_min + np.linalg.norm(P2 - P1)))
        else:
            depth_num = max_d
        interval = (depth_max - depth_min) / (depth_num - 1) / interval_scale
        depth_ranges[i + 1] = (depth_min, interval, depth_num, depth_max)

    score = view_scores(images, points3d, extrinsic)
    num_view = min(num_src_views, num_images - 1)
    view_sel = []
    for i in range(num_images):
        order = np.argsort(score[i])[::-1]
        view_sel.append([(int(k), int(score[i, k])) for k in order[:num_view]])

    for i in range(num_images):
        dr = depth_ranges[i + 1]
        with open(cam_dir / f"{i:08d}_cam.txt", "w") as f:
            f.write("extrinsic\n")
            for row in extrinsic[i + 1]:
                f.write(" ".join(str(v) for v in row) + " \n")
            f.write("\nintrinsic\n")
            for row in intrinsic[images[i + 1].camera_id]:
                f.write(" ".join(str(v) for v in row) + " \n")
            f.write("\n%f %f %f %f\n" % dr)

    with open(save_folder / "pair.txt", "w") as f:
        f.write(f"{num_images}\n")
        for i, sel in enumerate(view_sel):
            f.write(f"{i}\n{len(sel)} ")
            for k, s in sel:
                f.write(f"{k} {s} ")
            f.write("\n")

    # Pad to the common max size, nearest-resample, convert to jpg
    # (colmap2mvsnet.py:475-494).
    max_w = max_h = 0
    for i in range(num_images):
        img = imread.read_color_u8(image_dir / images[i + 1].name)
        max_h = max(max_h, img.shape[0])
        max_w = max(max_w, img.shape[1])
    for i in range(num_images):
        img = imread.read_color_u8(image_dir / images[i + 1].name)
        pad = np.pad(img, ((0, max_h - img.shape[0]),
                           (0, max_w - img.shape[1]), (0, 0)), "constant")
        if scale_factor != 1.0:
            pad = resize_nearest(pad, int(pad.shape[1] / scale_factor),
                                 int(pad.shape[0] / scale_factor))
        imread.write_jpeg_color(out_img_dir / f"{i:08d}.jpg", pad)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Convert COLMAP model to DPE scene")
    p.add_argument("--dense_folder", required=True)
    p.add_argument("--save_folder", required=True)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--max_d", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.0)
    p.add_argument("--scale_factor", type=float, default=1.0)
    p.add_argument("--model_ext", default=None, choices=[None, ".txt", ".bin"])
    a = p.parse_args(argv)
    colmap_to_dpe(a.dense_folder, a.save_folder, model_dir=a.model_dir,
                  model_ext=a.model_ext, max_d=a.max_d,
                  interval_scale=a.interval_scale, scale_factor=a.scale_factor)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
