"""Cross-view depth-map fusion to a point cloud (``RunFusion`` ETH variant,
DPE.cpp:1220-1370).

Port of :mod:`dpe_mvs_tpu.pipeline.fusion`. Every
pixel of a reference view is projected into all its source views at once,
gathers the source depth, normal and used-pixel mask there, and accumulates
the consistency vote:

    consistent if reproj_err < 2px AND rel_depth_diff < 0.01 AND angle < 10°
    score = sum exp(-(err + 200*dd + 10*angle)) must exceed
            0.45*n (weak) / 0.3*n (strong)

The vote runs on the pipeline's device; its three gathers per source go
through ``ops.sampling.gather_map`` (the ``gather2d_hwc`` kernel on the
card). The colour average and the used-pixel marks stay numpy on the host,
as in the JAX package.

The reference masks out every *used* source pixel while scanning
sequentially (DPE.cpp:1299, 1353); like the JAX package, this port applies
the masks between reference views, which can only add points, never drop
them (a defect of the reference port kept on purpose, ROADMAP.md).
:func:`run_fusion_mesh` votes the reference views sharded over the ranks
of a view group, in two passes that replay that mask schedule.
"""
from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..config import PixelState
from ..edges import imgproc
from ..geometry import cameras as geo
from ..io import formats, imread, scene
from ..ops import sampling
from ..parallel import mesh as mesh_mod


def _camera(c, device) -> geo.Camera:
    return geo.Camera(K=torch.as_tensor(c.K, device=device),
                      R=torch.as_tensor(c.R, device=device),
                      t=torch.as_tensor(c.t, device=device))


def _fuse_view(ref_cam: geo.Camera, src_cams: geo.Camera, ref_depth,
               ref_normal, ref_weak, ref_mask, src_depths, src_normals,
               src_masks):
    """Consistency vote of one reference view against its V source views.

    ``src_cams`` holds (V, ...) stacks, ``src_depths`` (V, H, W),
    ``src_normals`` (V, H, W, 3), ``src_masks`` (V, H, W) bool, all on the
    reference's device. Returns (accept (H, W) bool, world points (H, W, 3),
    num_consistent (H, W) int32, used (V, H, W) bool, used_x, used_y
    (V, H, W) int32)."""
    H, W = ref_depth.shape
    px, py = geo.pixel_grid(H, W, device=ref_depth.device)
    Xw = geo.backproject_to_world(ref_cam, px, py, ref_depth)
    oks, sxs, sys_ = [], [], []
    num = torch.zeros((H, W), dtype=torch.int32, device=ref_depth.device)
    total = torch.zeros((H, W), dtype=torch.float32, device=ref_depth.device)
    for v in range(src_depths.shape[0]):
        cam = geo.Camera(K=src_cams.K[v], R=src_cams.R[v], t=src_cams.t[v])
        sx, sy, _ = geo.project_to_camera(cam, Xw)
        sxi = sampling.to_int32(sx, rounding=True)
        syi = sampling.to_int32(sy, rounding=True)
        inb = (sxi >= 0) & (sxi < W) & (syi >= 0) & (syi < H)
        d_src = sampling.gather_map(src_depths[v], syi, sxi)
        n_src = sampling.gather_map(src_normals[v], syi, sxi)
        m_src = sampling.gather_map(src_masks[v], syi, sxi)
        X_src = geo.backproject_to_world(cam, sxi.to(torch.float32),
                                         syi.to(torch.float32), d_src)
        bx, by, proj_d = geo.project_to_camera(ref_cam, X_src)
        err = torch.sqrt((px - bx) ** 2 + (py - by) ** 2)
        dd = torch.abs(proj_d - ref_depth) / torch.clamp_min(ref_depth,
                                                             1e-30)
        dot = (ref_normal[..., 0] * n_src[..., 0]
               + ref_normal[..., 1] * n_src[..., 1]
               + ref_normal[..., 2] * n_src[..., 2])
        ang = torch.arccos(dot.clamp(-1.0, 1.0))
        ang = torch.where(torch.isnan(ang), 0.0, ang)
        ok = inb & ~m_src & (d_src > 0) & (err < 2.0) & (dd < 0.01) & \
            (ang < 0.174533)
        score = torch.where(ok, torch.exp(-(err + 200.0 * dd + 10.0 * ang)),
                            0.0)
        num = num + ok.to(torch.int32)
        total = total + score
        oks.append(ok)
        sxs.append(sxi)
        sys_.append(syi)
    factor = torch.where(ref_weak == int(PixelState.WEAK), 0.45, 0.3)
    accept = ~ref_mask & (ref_depth > 0) & (num >= 1) & \
        (total > factor * num.to(torch.float32))
    used = torch.stack(oks) & accept[None]
    return accept, Xw, num, used, torch.stack(sxs), torch.stack(sys_)


def export_depth_image_point_cloud(out_path, image_bgr: np.ndarray,
                                   cam: scene.CameraData, depth: np.ndarray,
                                   depth_min: float, depth_max: float
                                   ) -> Path:
    """Back-project a single depth map to a coloured PLY
    (``ExportDepthImagePointCloud``, DPE.cpp:1691-1724), on the host."""
    H, W = depth.shape
    px, py = geo.pixel_grid(H, W)
    Xw = geo.backproject_to_world(
        _camera(cam, "cpu"), px, py,
        torch.from_numpy(np.asarray(depth, np.float32))).numpy()
    valid = (depth >= depth_min) & (depth <= depth_max) & np.isfinite(depth)
    formats.write_ply(out_path, Xw[valid].astype(np.float32),
                      image_bgr[valid].astype(np.uint8))
    return Path(out_path)


def _resize_color_u8(img: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """``cv2.resize`` of a uint8 BGR image, INTER_LINEAR (OpenCV's
    fixed-point path), one channel at a time."""
    return np.stack([imgproc.resize_linear_u8(img[..., c], cols, rows)
                     for c in range(img.shape[2])], axis=-1)


class _ViewCache:
    """Bounded LRU loader for per-view fusion inputs.

    The reference loads every view's image, depth, normal and weak map up
    front (DPE.cpp:1248-1282). Fusion touches views with pair-graph
    locality (each reference view and its sources), so a small cache
    streams them from the per-view .dmb files instead; the depth and normal
    maps are put on ``device`` once per stay in the cache. The used-pixel
    masks live outside it (they accumulate across reference views)."""

    def __init__(self, problems, max_views: int = 24, device="cpu"):
        self.problems = problems
        self.max_views = max_views
        self.device = torch.device(device)
        self._cache = OrderedDict()

    def get(self, i: int) -> dict:
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        p = self.problems[i]
        rf = p.result_folder
        d = formats.read_dmb(rf / "depths.dmb").astype(np.float32)
        nm = formats.read_dmb(rf / "normals.dmb").astype(np.float32)
        w = formats.read_dmb(rf / "weak.bin").astype(np.uint8)
        img = scene.load_image_color(p.dense_folder, p.ref_image_id)
        if img is None:
            raise FileNotFoundError(
                f"image {scene.image_path(p.dense_folder, p.ref_image_id)} "
                "is missing")
        cam = scene.load_camera(p.dense_folder, p.ref_image_id)
        H, W = d.shape
        if img.shape[:2] != (H, W):
            sx = W / img.shape[1]
            sy = H / img.shape[0]
            img = _resize_color_u8(img, W, H)
            cam = cam.scaled(sx, sy, W, H)
        if w.shape != (H, W):
            w = scene.rescale_nearest(w, W, H)
        entry = {"depth": d, "normal": nm, "weak": w, "img": img, "cam": cam,
                 "t_depth": torch.from_numpy(d).to(self.device),
                 "t_normal": torch.from_numpy(nm).to(self.device)}
        self._cache[i] = entry
        while len(self._cache) > self.max_views:
            self._cache.popitem(last=False)
        return entry


def _sky_mask(path: Path, W: int, H: int) -> np.ndarray:
    """True where the sky mask ``blocks/mask_<id>.jpg`` blocks a pixel
    (< 128), read as gray and resized to (H, W) as OpenCV's uint8 linear
    resize does."""
    b = imread.read_gray_u8(path)
    if b.shape != (H, W):
        b = imgproc.resize_linear_u8(b, W, H)
    return b < 128


def run_fusion(dense_folder, problems: List[scene.Problem],
               verbose: bool = False, max_resident_views: int = 24,
               device="cuda") -> Path:
    """Fuse every problem's depth map (from its result folder's .dmb files)
    into ``<dense>/DPE/DPE.ply``, voting on ``device`` (the card unless the
    caller asks for "cpu"). Returns the PLY's path."""
    dense_folder = Path(dense_folder)
    device = torch.device(device)
    id_to_idx = {p.ref_image_id: i for i, p in enumerate(problems)}
    block_dir = dense_folder / "blocks"
    cache = _ViewCache(problems, max_resident_views, device)

    # Used-pixel masks are the only whole-scene state.
    masks = {}

    def mask_of(i):
        if i not in masks:
            masks[i] = np.zeros(cache.get(i)["depth"].shape, bool)
        return masks[i]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    pts_out, col_out = [], []
    for i, p in enumerate(problems):
        if verbose:
            print(f"  fusing image {p.ref_image_id:08d}")
        src_idx = [id_to_idx[s] for s in p.src_image_ids if s in id_to_idx]
        if not src_idx:
            continue
        ref = cache.get(i)
        srcs = [cache.get(j) for j in src_idx]
        src_cams = geo.Camera(
            K=put(np.stack([s["cam"].K for s in srcs])),
            R=put(np.stack([s["cam"].R for s in srcs])),
            t=put(np.stack([s["cam"].t for s in srcs])))
        ref_mask = mask_of(i).copy()
        bp = block_dir / f"mask_{p.ref_image_id}.jpg"
        if bp.exists():
            H, W = ref["depth"].shape
            ref_mask |= _sky_mask(bp, W, H)       # True = blocked (sky)

        out = _fuse_view(
            _camera(ref["cam"], device), src_cams, ref["t_depth"],
            ref["t_normal"], put(ref["weak"]), put(ref_mask),
            torch.stack([s["t_depth"] for s in srcs]),
            torch.stack([s["t_normal"] for s in srcs]),
            put(np.stack([mask_of(j) for j in src_idx])))
        accept, Xw, num_c, used, sxs, sys_ = (t.cpu().numpy() for t in out)

        # Colour average over ref + used src pixels (DPE.cpp:1348-1362).
        col = ref["img"].astype(np.float32).copy()
        for v, j in enumerate(src_idx):
            uv = used[v] & accept
            col[uv] += srcs[v]["img"][sys_[v][uv], sxs[v][uv]] \
                .astype(np.float32)
            # Mark used src pixels (DPE.cpp:1353).
            mask_of(j)[sys_[v][uv], sxs[v][uv]] = True
        col[accept] /= (num_c[accept] + 1)[:, None]

        pts_out.append(Xw[accept])
        col_out.append(col[accept].astype(np.uint8))

    pts = (np.concatenate(pts_out, axis=0) if pts_out
           else np.zeros((0, 3), np.float32))
    cols = (np.concatenate(col_out, axis=0) if col_out
            else np.zeros((0, 3), np.uint8))
    out_path = dense_folder / "DPE" / "DPE.ply"
    out_path.parent.mkdir(exist_ok=True)
    formats.write_ply(out_path, pts, cols)
    if verbose:
        print(f"  fused point cloud: {pts.shape[0]} points -> {out_path}")
    return out_path


def run_fusion_mesh(dense_folder, problems: List[scene.Problem],
                    group: mesh_mod.ViewGroup, verbose: bool = False,
                    max_passes: Optional[int] = None) -> Path:
    """``run_fusion`` with the reference views sharded over the ranks of
    ``group`` (the JAX package's ``run_fusion_mesh``), one call on every
    rank: each rank votes its block of reference views on its device with
    :func:`_fuse_view` against the depth, normal and camera stacks of every
    view, all-gathered once.

    The sequential used-pixel masks depend on the order of the reference
    views (each masks source pixels for the views after it, DPE.cpp:1299,
    1353). Vote passes reproduce that schedule: pass 1 votes without
    masks; the used maps of a pass, gathered from every rank, replay the
    sequential mask schedule on the host (on every rank alike, so no mask
    is sent), and the next pass votes with those masks. The JAX package
    stops after pass 2 (``max_passes=2``), which leaves duplicates of
    duplicates (pixels suppressed only because their suppressor was itself
    suppressed) and drops 6-11% of ``run_fusion``'s points on maps close to
    the ground truth (ROADMAP queue 3); by default the passes go on until
    the replayed masks repeat, where the vote is ``run_fusion``'s. Rank 0
    colours the last pass's accepted points and writes
    ``<dense>/DPE/DPE.ply``; every rank returns its path."""
    dense_folder = Path(dense_folder)
    dev = group.device
    B = len(problems)
    b_loc = mesh_mod.block_size(B, group)
    own = mesh_mod.local_block(B, group)
    id_to_idx = {p.ref_image_id: i for i, p in enumerate(problems)}
    v_pad = max(1, max(len(p.src_image_ids) for p in problems))
    cache = _ViewCache(problems, max_views=len(problems) + 1, device=dev)
    H, W = cache.get(0)["depth"].shape
    idx = np.full((b_loc * group.world, v_pad), -1, np.int64)
    sky = np.zeros((B, H, W), bool)
    block_dir = dense_folder / "blocks"
    for i, p in enumerate(problems):
        for v, s in enumerate(p.src_image_ids[:v_pad]):
            if s in id_to_idx:
                idx[i, v] = id_to_idx[s]
        bp = block_dir / f"mask_{p.ref_image_id}.jpg"
        if bp.exists():
            sky[i] = _sky_mask(bp, W, H)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def local(field, shape, dtype):
        """This rank's block of a per-view field (padding slots zeros,
        which nothing reads)."""
        out = torch.zeros((b_loc,) + shape, dtype=dtype, device=dev)
        for k, i in enumerate(own):
            out[k] = field(cache.get(i))
        return out

    K_all, R_all, t_all, d_all, n_all = (
        torch.cat(mesh_mod.all_gather(group, local(f, shape, torch.float32)))
        for f, shape in ((lambda e: put(e["cam"].K), (3, 3)),
                         (lambda e: put(e["cam"].R), (3, 3)),
                         (lambda e: put(e["cam"].t), (3,)),
                         (lambda e: e["t_depth"], (H, W)),
                         (lambda e: e["t_normal"], (H, W, 3))))

    def vote(ref_mask: np.ndarray, src_mask: np.ndarray):
        """One sharded vote pass with the (B, H, W) reference masks and
        (B, V, H, W) source masks; every rank's outputs gathered, each
        (world * b_loc, ...) on the host (padding slots zeros)."""
        outs = []
        for i in own:
            sel = torch.as_tensor(np.maximum(idx[i], 0), device=dev)
            e = cache.get(i)
            outs.append(_fuse_view(
                geo.Camera(K=K_all[i], R=R_all[i], t=t_all[i]),
                geo.Camera(K=K_all[sel], R=R_all[sel], t=t_all[sel]),
                e["t_depth"], e["t_normal"], put(e["weak"]),
                put(ref_mask[i]), d_all[sel], n_all[sel],
                put(src_mask[i] | (idx[i] < 0)[:, None, None])))
        shapes = [((H, W), torch.bool), ((H, W, 3), torch.float32),
                  ((H, W), torch.int32), ((v_pad, H, W), torch.bool),
                  ((v_pad, H, W), torch.int32), ((v_pad, H, W), torch.int32)]
        gathered = []
        for f, (shape, dtype) in enumerate(shapes):
            blk = torch.zeros((b_loc,) + shape, dtype=dtype, device=dev)
            for k, o in enumerate(outs):
                blk[k] = o[f]
            gathered.append(torch.cat(mesh_mod.all_gather(group, blk))
                            .cpu().numpy())
        return gathered

    def replay(used=None, sx=None, sy=None):
        """The sequential mask schedule (each reference view masks the
        source pixels it used for the views after it) over one vote pass's
        used maps; without them, no pixel is used yet."""
        sup = np.zeros((B, H, W), bool)
        ref_mask = np.zeros((B, H, W), bool)
        src_mask = np.zeros((B, v_pad, H, W), bool)
        for i in range(B):
            ref_mask[i] = sup[i] | sky[i]
            for v in range(v_pad):
                j = idx[i, v]
                if j >= 0:
                    src_mask[i, v] = sup[j]
            if used is None:
                continue
            for v in range(v_pad):
                j = idx[i, v]
                if j >= 0:
                    uv = used[i, v]
                    sup[j][sy[i, v][uv], sx[i, v][uv]] = True
        return ref_mask, src_mask

    # Pass 1 votes without masks; every later pass with the masks replayed
    # from the pass before, until they repeat. After pass k the first k
    # reference views' masks are the sequential ones, so at most B passes
    # reach that fixpoint, where the vote is run_fusion's.
    masks = replay()
    for n_pass in range(1, B + 1):
        accept, Xw, num_c, used, sxs, sys_ = vote(*masks)
        if n_pass == max_passes:
            break
        new = replay(used, sxs, sys_)
        if all(np.array_equal(a, b) for a, b in zip(new, masks)):
            break
        masks = new
    out_path = dense_folder / "DPE" / "DPE.ply"
    if group.rank == 0:
        pts_out, col_out = [], []
        for i in range(B):
            col = cache.get(i)["img"].astype(np.float32).copy()
            acc = accept[i]
            for v in range(v_pad):
                j = idx[i, v]
                if j < 0:
                    continue
                uv = used[i, v] & acc
                col[uv] += cache.get(j)["img"][sys_[i, v][uv],
                                               sxs[i, v][uv]].astype(
                                                   np.float32)
            col[acc] /= (num_c[i][acc] + 1)[:, None]
            pts_out.append(Xw[i][acc])
            col_out.append(col[acc].astype(np.uint8))
        pts = np.concatenate(pts_out, 0)
        cols = np.concatenate(col_out, 0)
        out_path.parent.mkdir(exist_ok=True)
        formats.write_ply(out_path, pts, cols)
        if verbose:
            print(f"  fused point cloud (ranks x{group.world}, {n_pass} vote "
                  f"passes): {pts.shape[0]} points -> {out_path}")
    mesh_mod.barrier(group)
    return out_path
