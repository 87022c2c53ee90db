"""Device-side state for one PatchMatch problem.

Port of :mod:`dpe_mvs_tpu.engine.state`. Two dataclasses of tensors:

  - :class:`SweepData` — per-sweep inputs (images, cameras, edges, rect
    views or the exact engine's corner maps);
  - :class:`PMState`  — the per-pixel state a sweep transforms (plane
    hypotheses, costs, view selection, pixel classification) and its key.

The view-selection bitmask ``selected`` is carried as int32 (PyTorch's uint32
has no shifts or reductions on CUDA); at most 31 source views fit, as
``config.MAX_IMAGES = 32`` allows. It is written back with the same bits as
the JAX package's uint32.

The ``*_from_numpy`` functions take the JAX package's ``SweepData`` /
``PMState`` / ``RectView`` / ``Support`` / ``WeakRectBundle`` with numpy
leaves (``jax.tree.map(np.asarray, x)``) so both packages can compute from
identical state.

Entry points put their tensors on the card unless the caller asks for
another device (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..config import PixelState
from ..geometry import cameras as geo


@dataclasses.dataclass
class CameraData:
    """Host-side camera of one view (the fields of the JAX package's
    ``io.scene.CameraData``)."""

    K: np.ndarray  # (3, 3) float32
    R: np.ndarray  # (3, 3) float32
    t: np.ndarray  # (3,)  float32
    depth_min: float
    depth_max: float
    width: int = 0
    height: int = 0

    def scaled(self, scale_x: float, scale_y: float,
               width: int, height: int) -> "CameraData":
        """The camera of the image resized by (scale_x, scale_y) to
        (width, height)."""
        K = self.K.copy()
        K[0, 0] *= scale_x
        K[0, 2] *= scale_x
        K[1, 1] *= scale_y
        K[1, 2] *= scale_y
        return dataclasses.replace(self, K=K, width=width, height=height)


@dataclasses.dataclass
class ProblemInputs:
    """Host-side inputs of one problem (the fields of the JAX package's
    ``io.scene.ProblemInputs``): images and cameras, and for later passes
    the priors, the weak map and the source depth maps (1 + S, H, W)."""

    images: np.ndarray               # (1+S, H, W) float32
    cameras: List[CameraData]        # len 1+S
    depth_min: float
    depth_max: float
    width: int
    height: int
    prior_depth: Optional[np.ndarray] = None
    prior_normal: Optional[np.ndarray] = None
    prior_selected_views: Optional[np.ndarray] = None
    weak_info: Optional[np.ndarray] = None
    src_depths: Optional[np.ndarray] = None


@dataclasses.dataclass
class SweepData:
    ref_image: torch.Tensor     # (H, W) f32 grayscale in [0, 255]
    src_images: torch.Tensor    # (V, H, W) f32
    ref_cam: geo.Camera
    src_cams: geo.Camera        # stacked (V, ...) cameras
    R_rel: torch.Tensor         # (V, 3, 3)
    t_rel: torch.Tensor         # (V, 3)
    baseline: torch.Tensor      # (V,)
    view_valid: torch.Tensor    # (V,) bool — padding mask
    src_depths: torch.Tensor    # (V, H, W) f32 (zeros unless geom pass)
    depth_min: torch.Tensor     # () f32
    depth_max: torch.Tensor     # () f32
    edge: torch.Tensor          # (H, W) bool
    edge_low: torch.Tensor      # (Hl, Wl) bool
    label: torch.Tensor         # (H, W) i32
    rect: Optional[tuple] = None  # per-view rectcost.RectView
    # Bilinear corner maps (sampling.corner_map) of the exact engine, built
    # once per sweep: (H, W, 4) of the reference, (V, H, W, 4) of the
    # sources.
    ref_corners: Optional[torch.Tensor] = None
    src_corners: Optional[torch.Tensor] = None

    @property
    def height(self) -> int:
        return self.ref_image.shape[0]

    @property
    def width(self) -> int:
        return self.ref_image.shape[1]

    @property
    def num_src(self) -> int:
        return self.src_images.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ref_image.device

    def replace(self, **kw) -> "SweepData":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class PMState:
    plane: torch.Tensor         # (H, W, 4) — (n_cam, dist) during the sweep;
                                # (n_world, depth) at sweep boundaries
    cost: torch.Tensor          # (H, W) f32
    selected: torch.Tensor      # (H, W) int32 view bitmask
    view_weight: torch.Tensor   # (H, W, V) int32 MC view weights
    weak: torch.Tensor          # (H, W) uint8 PixelState
    key: object                 # utils.rng key

    def replace(self, **kw) -> "PMState":
        return dataclasses.replace(self, **kw)


def pad_views(arr: np.ndarray, v_pad: int, fill=0.0) -> np.ndarray:
    """Pad the leading view axis to ``v_pad``."""
    v = arr.shape[0]
    if v == v_pad:
        return arr
    if v > v_pad:
        return arr[:v_pad]
    pad_shape = (v_pad - v,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


def build_sweep_data(inputs, v_pad: int,
                     edge: Optional[np.ndarray] = None,
                     edge_low: Optional[np.ndarray] = None,
                     label: Optional[np.ndarray] = None,
                     device="cuda") -> SweepData:
    """Assemble device inputs from host-side problem inputs (all prep math
    in numpy, as the JAX package does). ``edge`` (H, W), ``edge_low`` (the
    coarse edge map) and ``label`` (H, W) are the support maps; zero maps
    when absent."""
    n_src = inputs.images.shape[0] - 1
    H, W = inputs.height, inputs.width
    ref_c = inputs.cameras[0]
    ref_cam = geo.Camera(K=_t(ref_c.K, device), R=_t(ref_c.R, device),
                         t=_t(ref_c.t, device))

    z33 = np.zeros((0, 3, 3), np.float32)
    src_K = np.stack([c.K for c in inputs.cameras[1:]]) if n_src else z33
    src_R = np.stack([c.R for c in inputs.cameras[1:]]) if n_src else z33
    src_t = (np.stack([c.t for c in inputs.cameras[1:]]) if n_src
             else np.zeros((0, 3), np.float32))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (v_pad, 3, 3)).copy()
    src_K = pad_views(src_K, v_pad)
    src_K[n_src:] = np.eye(3, dtype=np.float32)
    src_R = pad_views(src_R, v_pad)
    src_R[n_src:] = eye[n_src:]
    src_t = pad_views(src_t, v_pad)
    src_cams = geo.Camera(K=_t(src_K, device), R=_t(src_R, device),
                          t=_t(src_t, device))

    R_ref = np.asarray(ref_c.R, np.float32)
    t_ref = np.asarray(ref_c.t, np.float32)
    center_ref = -R_ref.T @ t_ref
    centers_src = -np.einsum("vij,vi->vj", src_R, src_t)
    R_rel = np.einsum("vik,jk->vij", src_R, R_ref)
    t_rel = np.einsum("vij,vj->vi", src_R, center_ref[None] - centers_src)
    baseline = np.linalg.norm(center_ref[None, :] - centers_src, axis=-1)

    valid = np.zeros((v_pad,), bool)
    valid[:n_src] = True
    src_images = pad_views(inputs.images[1:], v_pad)
    if inputs.src_depths is not None:
        src_depths = pad_views(inputs.src_depths[1:], v_pad)
    else:
        src_depths = np.zeros((v_pad, H, W), np.float32)
    if edge is None:
        edge = np.zeros((H, W), bool)
    if edge_low is None:
        edge_low = np.zeros((max(H // 2, 1), max(W // 2, 1)), bool)
    if label is None:
        label = np.zeros((H, W), np.int32)

    return SweepData(
        ref_image=_t(inputs.images[0], device, torch.float32),
        src_images=_t(src_images, device, torch.float32),
        ref_cam=ref_cam,
        src_cams=src_cams,
        R_rel=_t(R_rel, device),
        t_rel=_t(t_rel, device),
        baseline=_t(baseline, device, torch.float32),
        view_valid=_t(valid, device),
        src_depths=_t(src_depths, device, torch.float32),
        depth_min=torch.tensor(inputs.depth_min, dtype=torch.float32,
                               device=device),
        depth_max=torch.tensor(inputs.depth_max, dtype=torch.float32,
                               device=device),
        edge=_t(edge.astype(bool), device),
        edge_low=_t(edge_low.astype(bool), device),
        label=_t(label.astype(np.int32), device),
    )


def init_pm_state(inputs, v_pad: int, key, use_APD: bool,
                  device="cuda") -> PMState:
    """Initial per-pixel state from priors (DPE.cpp:846-912). ``plane``
    holds (world normal, depth) when priors exist; the init stage re-frames
    it into camera coordinates."""
    H, W = inputs.height, inputs.width
    plane = np.zeros((H, W, 4), np.float32)
    if inputs.prior_depth is not None:
        plane[..., 3] = inputs.prior_depth
        plane[..., :3] = inputs.prior_normal
    selected = (inputs.prior_selected_views.astype(np.uint32).view(np.int32)
                if inputs.prior_selected_views is not None
                else np.zeros((H, W), np.int32))
    if use_APD and inputs.weak_info is not None:
        weak = inputs.weak_info.astype(np.uint8)
    else:
        weak = np.full((H, W), int(PixelState.STRONG), np.uint8)
    return PMState(
        plane=_t(plane, device),
        cost=torch.full((H, W), 2.0, dtype=torch.float32, device=device),
        selected=_t(selected, device),
        view_weight=torch.zeros((H, W, v_pad), dtype=torch.int32,
                                device=device),
        weak=_t(weak, device),
        key=key,
    )


def _cam_from(c, device) -> geo.Camera:
    return geo.Camera(K=_t(c.K, device), R=_t(c.R, device),
                      t=_t(c.t, device))


def sweep_data_from_numpy(d, device, rect=None) -> SweepData:
    """The JAX package's SweepData (numpy leaves) as a port SweepData."""
    return SweepData(
        ref_image=_t(d.ref_image, device), src_images=_t(d.src_images, device),
        ref_cam=_cam_from(d.ref_cam, device),
        src_cams=_cam_from(d.src_cams, device),
        R_rel=_t(d.R_rel, device), t_rel=_t(d.t_rel, device),
        baseline=_t(d.baseline, device), view_valid=_t(d.view_valid, device),
        src_depths=_t(d.src_depths, device),
        depth_min=_t(d.depth_min, device), depth_max=_t(d.depth_max, device),
        edge=_t(d.edge, device), edge_low=_t(d.edge_low, device),
        label=_t(d.label, device), rect=rect,
    )


def pm_state_from_numpy(s, key, device) -> PMState:
    """The JAX package's PMState (numpy leaves) as a port PMState; the key
    is given separately (a JAX key has no numpy form)."""
    return PMState(
        plane=_t(s.plane, device), cost=_t(s.cost, device),
        selected=_t(np.asarray(s.selected).astype(np.uint32).view(np.int32),
                    device),
        view_weight=_t(s.view_weight, device), weak=_t(s.weak, device),
        key=key,
    )


def rect_views_from_numpy(views, device) -> tuple:
    """The JAX package's RectView tuple (numpy leaves) as port RectViews."""
    from .rectcost import RectView
    names = [f.name for f in dataclasses.fields(RectView)]
    return tuple(RectView(**{n: _t(getattr(rv, n), device, torch.float32)
                             for n in names}) for rv in views)


def support_from_numpy(sup, device):
    """The JAX package's Support (numpy leaves; absent maps None) as the
    port's."""
    from ..ops import support as sup_ops
    from .patchmatch import Support

    def t(a):
        return None if a is None else _t(a, device)

    los = None
    if sup.los is not None:
        los = sup_ops.LineOfSight(
            free_dist=_t(sup.los.free_dist, device),
            scale_x=float(sup.los.scale_x), scale_y=float(sup.los.scale_y),
            max_len=float(np.asarray(sup.los.max_len)))
    return Support(edge_steps=t(sup.edge_steps), complexity=t(sup.complexity),
                   label_runs=t(sup.label_runs), los=los,
                   nearest_strong=t(sup.nearest_strong),
                   neighbours=t(sup.neighbours), radius=t(sup.radius),
                   fit_plane=t(sup.fit_plane))


def _bf16(a, device):
    """A numpy bfloat16 array (ml_dtypes) as a torch bfloat16 tensor."""
    if a is None:
        return None
    bits = np.asarray(a).view(np.uint16).astype(np.int16)
    return torch.as_tensor(bits, device=device).view(torch.bfloat16)


def weak_bundle_from_numpy(b, device):
    """The JAX package's WeakRectBundle (numpy leaves) as the port's: the
    bf16 volumes bit for bit, the packed streaming volumes as their 32-bit
    words."""
    from .weak_rect import WeakRectBundle
    return WeakRectBundle(
        vol_center=_bf16(b.vol_center, device),
        vol_geom=_bf16(b.vol_geom, device),
        d0=_t(b.d0, device),
        ap=_bf16(b.ap, device),
        a_d0=None if b.a_d0 is None else _t(b.a_d0, device),
        w_chans=(None if b.w_chans is None else
                 _t(np.asarray(b.w_chans).view(np.int32), device)),
    )
