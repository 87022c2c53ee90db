"""The plain reference that decides ``correct``.

Plain numpy (and torch on the CPU for the gathers), independent of the
program: it imports nothing of ``dpe_mvs_tpu_torch`` and takes nothing the
program made. From the scene the benchmark rendered (its images, cameras and
analytic plane) it works out

  1. the truth of every written map at the round's size: the plane's depth
     along each pixel's ray through the round's camera, and its normal;
  2. the matching cost of a plane at a pixel: bilateral-weighted NCC over
     the window the program uses, between the round's reference image and
     each source image (resized here from the full frames), through the
     plane's homography, averaged over the ``top_k`` best sources;
  3. the output of each hand-written kernel entry from its inputs: the same
     clamps and float32 arithmetic as the entries state.

and reduces the program's outputs to the numbers ``checks`` compares with
their limits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

UNKNOWN = 2                # PixelState.UNKNOWN of the written weak map
COST_MAX = 2.0
WINDOW_RADIUS = 5          # PatchMatchParams.strong_radius
WINDOW_STEP = 2            # PatchMatchParams.strong_increment
SIGMA_SPATIAL = 5.0
SIGMA_COLOR = 3.0
DEPTH_QUANTILE = 90.0


# --------------------------------------------------------------------------
# Cameras and images at a round's size
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RoundCamera:
    K: np.ndarray      # (3, 3) float64
    R: np.ndarray      # (3, 3) float64
    t: np.ndarray      # (3,) float64


def scaled_size(width: int, height: int, scale: int):
    """The round's frame: the full frame over ``scale``, rounded."""
    return int(round(width / scale)), int(round(height / scale))


def round_camera(cam, width: int, height: int, scale: int) -> RoundCamera:
    """The camera of the image resized by 1 / ``scale`` (focal lengths and
    principal point scaled by the size ratio)."""
    cols, rows = scaled_size(width, height, scale)
    K = np.asarray(cam.K, np.float64).copy()
    K[0, :] *= cols / width
    K[1, :] *= rows / height
    K[2, :] = (0.0, 0.0, 1.0)
    return RoundCamera(K=K, R=np.asarray(cam.R, np.float64),
                       t=np.asarray(cam.t, np.float64))


def resize(img: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """Bilinear resize with half-pixel centres, taps clamped at the
    border, in float64."""
    H, W = img.shape

    def taps(n_out, n_in):
        s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        s = np.clip(s, 0.0, n_in - 1.0)
        i0 = np.floor(s).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, s - i0

    x0, x1, fx = taps(cols, W)
    y0, y1, fy = taps(rows, H)
    src = np.asarray(img, np.float64)
    hor = src[:, x0] * (1 - fx) + src[:, x1] * fx
    return hor[y0] * (1 - fy)[:, None] + hor[y1] * fy[:, None]


def plane_in_camera(normal_w: np.ndarray, offset_w: float, cam: RoundCamera):
    """The world plane n . X = c as (n_c, c_c) in the camera's frame."""
    n_c = cam.R @ normal_w
    return n_c, offset_w + n_c @ cam.t


def truth_depth(normal_w, offset_w, cam: RoundCamera, cols: int,
                rows: int) -> np.ndarray:
    """(rows, cols) float64: the plane's depth along every pixel's ray."""
    n_c, c_c = plane_in_camera(normal_w, offset_w, cam)
    Ki = np.linalg.inv(cam.K)
    ys, xs = np.mgrid[0:rows, 0:cols].astype(np.float64)
    denom = (n_c[0] * (Ki[0, 0] * xs + Ki[0, 1] * ys + Ki[0, 2])
             + n_c[1] * (Ki[1, 0] * xs + Ki[1, 1] * ys + Ki[1, 2])
             + n_c[2])
    return c_c / denom


def nearest_rescale(src: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """Nearest-neighbour rescale, row i from source row floor(i * h_s / h)
    (the rescale the program states for its priors)."""
    if src.shape[:2] == (rows, cols):
        return src
    r = np.minimum((np.arange(rows) * (src.shape[0] / rows)).astype(np.int64),
                   src.shape[0] - 1)
    c = np.minimum((np.arange(cols) * (src.shape[1] / cols)).astype(np.int64),
                   src.shape[1] - 1)
    return src[np.ix_(r, c)]


# --------------------------------------------------------------------------
# Matching cost
# --------------------------------------------------------------------------

def _window():
    o = np.arange(-WINDOW_RADIUS, WINDOW_RADIUS + 1, WINDOW_STEP,
                  dtype=np.float64)
    dy, dx = np.meshgrid(o, o, indexing="ij")
    return dx.ravel(), dy.ravel()


def _bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Samples of ``img`` at (x, y) and whether each lies inside."""
    H, W = img.shape
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    xc = np.clip(x, 0, W - 1)
    yc = np.clip(y, 0, H - 1)
    x0 = np.minimum(np.floor(xc).astype(np.int64), max(W - 2, 0))
    y0 = np.minimum(np.floor(yc).astype(np.int64), max(H - 2, 0))
    fx, fy = xc - x0, yc - y0
    x1, y1 = np.minimum(x0 + 1, W - 1), np.minimum(y0 + 1, H - 1)
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy, inside


def matching_cost(ref_img: np.ndarray, src_imgs: Sequence[np.ndarray],
                  ref_cam: RoundCamera, src_cams: Sequence[RoundCamera],
                  px: np.ndarray, py: np.ndarray, depth: np.ndarray,
                  normal_c: np.ndarray, top_k: int) -> np.ndarray:
    """(N,) cost of the plane through each pixel (px, py) at ``depth`` with
    camera-frame normal ``normal_c`` (N, 3): per source 1 - NCC (bilateral
    weights, COST_MAX where a window leaves the source or has no texture),
    averaged over the ``top_k`` lowest sources."""
    dx, dy = _window()
    qx = px[:, None] + dx[None]                       # (N, S)
    qy = py[:, None] + dy[None]
    Ki = np.linalg.inv(ref_cam.K)
    ray_p = (Ki @ np.stack([px, py, np.ones_like(px)]))           # (3, N)
    X_p = ray_p * depth[None]
    off = np.einsum("in,in->n", normal_c.T, X_p)                  # (N,)
    rays = np.einsum("ij,jns->ins", Ki,
                     np.stack([qx, qy, np.ones_like(qx)]))        # (3, N, S)
    denom = np.einsum("in,ins->ns", normal_c.T, rays)
    z = off[:, None] / np.where(np.abs(denom) > 1e-12, denom, 1e-12)
    X = rays * z[None]                                            # (3, N, S)
    ref_v, _ = _bilinear(ref_img, qx, qy)
    ref_c = ref_img[np.clip(py.astype(np.int64), 0, ref_img.shape[0] - 1),
                    np.clip(px.astype(np.int64), 0, ref_img.shape[1] - 1)]
    w = np.exp(-(dx ** 2 + dy ** 2)[None] / (2 * SIGMA_SPATIAL ** 2)
               - (ref_v - ref_c[:, None]) ** 2 / (2 * SIGMA_COLOR ** 2))
    wsum = w.sum(1)
    rm = (w * ref_v).sum(1) / wsum
    rvar = (w * (ref_v - rm[:, None]) ** 2).sum(1) / wsum
    costs = []
    for img, cam in zip(src_imgs, src_cams):
        R_rel = cam.R @ ref_cam.R.T
        t_rel = cam.t - R_rel @ ref_cam.t
        Xs = np.einsum("ij,jns->ins", R_rel, X) + t_rel[:, None, None]
        uv = np.einsum("ij,jns->ins", cam.K, Xs)
        front = uv[2] > 1e-9
        zz = np.where(front, uv[2], 1.0)
        src_v, inside = _bilinear(img, uv[0] / zz, uv[1] / zz)
        sm = (w * src_v).sum(1) / wsum
        svar = (w * (src_v - sm[:, None]) ** 2).sum(1) / wsum
        cov = (w * (ref_v - rm[:, None]) * (src_v - sm[:, None])).sum(1) / wsum
        ok = (inside & front).all(1) & (rvar > 1e-5) & (svar > 1e-5)
        ncc = cov / np.sqrt(np.where(ok, rvar * svar, 1.0))
        costs.append(np.where(ok, np.clip(1.0 - ncc, 0.0, COST_MAX),
                              COST_MAX))
    costs = np.sort(np.stack(costs, 1), axis=1)[:, :max(1, top_k)]
    return costs.mean(1)


# --------------------------------------------------------------------------
# The hand-written kernels' functions
# --------------------------------------------------------------------------

def kernel_reference(name: str, args, dtype=None):
    """The output of kernel entry ``name`` on CPU tensors ``args``: the
    clamps and float32 arithmetic each entry states. ``dtype``
    ``torch.bfloat16`` computes the float values in that precision, the
    coordinates still in float32 (the control), and returns their float32
    form."""
    import torch

    def words(t):
        return t.view(torch.int32) if t.dtype == torch.uint32 else t

    def back(out, like):
        if like.dtype == torch.uint32:
            return out.view(torch.uint32)
        return out.to(like.dtype)

    def low(t):
        if dtype is not None and t.dtype == torch.float32:
            return t.to(dtype)
        return t

    if name == "row_gather":
        img, ix = args
        W = img.shape[1]
        out = torch.gather(low(words(img)), 1, ix.clamp(0, W - 1).long())
        return back(out, img)
    if name == "bilinear_x":
        img, x = args
        W = img.shape[1]
        xc = x.clamp(0.0, W - 1.0)
        x0 = (xc.floor().clamp(0.0, W - 2.0) if W > 1
              else torch.zeros_like(xc))
        f = low(xc - x0)
        i0 = x0.long()
        img = low(img)
        g0 = torch.gather(img, 1, i0)
        g1 = torch.gather(img, 1, (i0 + 1).clamp(max=W - 1))
        return (g0 * (1.0 - f) + g1 * f).to(torch.float32)
    if name == "gather2d":
        imgs, iy, ix = args
        squeeze = imgs.dim() == 2
        src = low(words(imgs[None] if squeeze else imgs))
        H, W = src.shape[-2:]
        out = src[:, iy.clamp(0, H - 1).long(), ix.clamp(0, W - 1).long()]
        out = back(out, imgs)
        return out[0] if squeeze else out
    if name == "gather2d_hwc":
        img, iy, ix = args
        H, W = img.shape[:2]
        return back(low(words(img))[iy.clamp(0, H - 1).long(),
                                    ix.clamp(0, W - 1).long()], img)
    if name == "gather2d_pick":
        imgs, ic, iy, ix = args
        C, H, W = imgs.shape
        return back(low(words(imgs))[ic.clamp(0, C - 1).long(),
                                     iy.clamp(0, H - 1).long(),
                                     ix.clamp(0, W - 1).long()], imgs)
    raise KeyError(name)


def mismatches(out, ref) -> int:
    """Elements of ``out`` that differ from ``ref`` bit for bit (shapes
    must agree; a differing shape counts every element)."""
    import torch
    if tuple(out.shape) != tuple(ref.shape) or out.dtype != ref.dtype:
        return max(out.numel(), ref.numel(), 1)
    a = out.contiguous().view(torch.uint8).reshape(out.numel(), -1)
    b = ref.contiguous().view(torch.uint8).reshape(ref.numel(), -1)
    return int((a != b).any(1).sum())


# --------------------------------------------------------------------------
# The numbers of one sweep
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SweepMaps:
    """What one timed sweep wrote back, and the prior it started from."""
    view: int
    depth: np.ndarray          # (H, W) float32
    normal: np.ndarray         # (H, W, 3) float32, world frame
    weak: np.ndarray           # (H, W) uint8
    selected: np.ndarray       # (H, W) int32 source bitmask
    prior_depth: np.ndarray    # (H, W) float32 at the round's size
    prior_selected: np.ndarray  # (H, W) int32 at the round's size


def sweep_numbers(maps: SweepMaps, scene, scale: int, top_k: int,
                  rng: np.random.Generator, n_cost: int,
                  images_at_round: Dict[int, np.ndarray]) -> Dict[str, float]:
    """The numbers ``checks`` compares for one sweep (see PERF.md)."""
    cols, rows = scaled_size(scene.width, scene.height, scale)
    v = maps.view
    cam = round_camera(scene.cameras[v], scene.width, scene.height, scale)
    z = truth_depth(scene.plane_normal, scene.plane_offset, cam, cols, rows)
    d = maps.depth.astype(np.float64)
    valid = (d > 0) & (maps.weak != UNKNOWN) & np.isfinite(d)
    n_valid = int(valid.sum())
    out = {"invalid": 1.0 - n_valid / valid.size}
    rel = np.abs(d - z) / z
    # Valid pixels whose depth the sweep left as it found it, bit for bit.
    same = (maps.depth.view(np.int32) == maps.prior_depth.view(np.int32))
    patch = np.zeros_like(valid)       # the patch's interior
    near = np.zeros_like(valid)        # the patch and its rim
    if scene.weak_box is not None:
        y0, y1, x0, x1 = (int(round(b / scale)) for b in scene.weak_box)
        m = WINDOW_RADIUS
        patch[y0 + m:y1 - m, x0 + m:x1 - m] = True
        near[max(y0 - m, 0):y1 + m, max(x0 - m, 0):x1 + m] = True
        pv = patch & valid
        out["depth_err_patch"] = (float(np.median(rel[pv])) if pv.any()
                                  else 1.0)
        out["invalid_patch"] = 1.0 - float(pv.sum()) / max(patch.sum(), 1)
        out["unchanged_patch"] = float(same[pv].mean()) if pv.any() else 1.0
    # The textured pixels' error at its 90th percentile: a sweep that
    # leaves a part of the frame at its prior shows there.
    tv = valid & ~near
    out["depth_err"] = (float(np.percentile(rel[tv], DEPTH_QUANTILE))
                        if tv.any() else 1.0)
    n = maps.normal.astype(np.float64)
    norm = np.linalg.norm(n, axis=-1)
    cosang = (n @ scene.plane_normal) / np.maximum(norm, 1e-12)
    ang = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
    out["normal_err_deg"] = float(np.median(ang[valid])) if n_valid else 180.0
    # Shares of the valid pixels that the sweep left as it found them.
    out["unchanged"] = (float(same[valid].mean()) if n_valid else 1.0)
    same = maps.selected == maps.prior_selected
    out["views_unchanged"] = (float(same[valid].mean()) if n_valid
                              else 1.0)

    # Matching cost of the written planes against the truth's, at pixels
    # drawn from the seed: textured, valid, away from borders and patch.
    m = WINDOW_RADIUS + 3
    cand = valid.copy()
    cand[:m] = cand[-m:] = False
    cand[:, :m] = cand[:, -m:] = False
    if scene.weak_box is not None:
        y0, y1, x0, x1 = (int(round(b / scale)) for b in scene.weak_box)
        cand[max(y0 - m, 0):y1 + m, max(x0 - m, 0):x1 + m] = False
    ys, xs = np.nonzero(cand)
    if len(ys) == 0:
        out["cost_excess"] = COST_MAX
        return out
    pick = rng.choice(len(ys), size=min(n_cost, len(ys)), replace=False)
    py, px = ys[pick].astype(np.float64), xs[pick].astype(np.float64)
    srcs = scene.src_ids(v)
    src_cams = [round_camera(scene.cameras[s], scene.width, scene.height,
                             scale) for s in srcs]
    args = (images_at_round[v], [images_at_round[s] for s in srcs], cam,
            src_cams, px, py)
    n_true = np.broadcast_to(cam.R @ scene.plane_normal, (len(px), 3))
    c_true = matching_cost(*args, z[ys[pick], xs[pick]], n_true, top_k)
    n_port = n[ys[pick], xs[pick]] @ cam.R.T
    c_port = matching_cost(*args, d[ys[pick], xs[pick]], n_port, top_k)
    out["cost_excess"] = float(np.maximum(c_port - c_true, 0.0).mean())
    return out


def worst(per_sweep: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst (largest) value over the sweeps."""
    keys = sorted({k for s in per_sweep for k in s})
    return {k: max(s[k] for s in per_sweep if k in s) for k in keys}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, dict]:
    """Every number that has a limit, with the limit and whether it is
    within it (at or under it; a limit without its number fails)."""
    out = {}
    for k in sorted(limits):
        v, lim = numbers.get(k), limits.get(k)
        ok = (v is not None and lim is not None and np.isfinite(v)
              and v <= lim)
        out[k] = {"value": v, "limit": lim, "ok": bool(ok)}
    return out


def images_at_round(scene, views: Optional[Sequence[int]], scale: int
                    ) -> Dict[int, np.ndarray]:
    cols, rows = scaled_size(scene.width, scene.height, scale)
    views = range(len(scene.images)) if views is None else views
    return {v: (scene.images[v].astype(np.float64) if scale == 1
                else resize(scene.images[v], cols, rows)) for v in views}
