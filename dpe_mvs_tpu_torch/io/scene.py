"""Scene loading: the directory-tree-as-database layer.

Port of :mod:`dpe_mvs_tpu.io.scene` (``DPE::InuputInitialization``,
DPE.cpp:733-914, and ``GenerateSampleList``, main.cpp:264-308): a dense
folder holds ``images/%08d.jpg``, ``cams/%08d_cam.txt`` and ``pair.txt``,
and each view's state lives in ``DPE/%08d/``. Images are read through
:mod:`.imread` (no OpenCV) and scaled by :func:`resize_linear`.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

# CameraData and ProblemInputs live with the sweep state; scene re-exports
# them, as the JAX package's scene module defines them.
from ..edges import imgproc
from ..engine.state import CameraData, ProblemInputs
from . import formats, imread


@dataclasses.dataclass
class Problem:
    """One reference view and its source set (reference ``Problem``,
    main.h:108-118)."""

    index: int
    ref_image_id: int
    src_image_ids: List[int]
    dense_folder: Path
    scale_size: int = 1
    show_medium_result: bool = False
    iteration: int = 0

    @property
    def result_folder(self) -> Path:
        return formats.result_folder(self.dense_folder, self.ref_image_id)


def generate_sample_list(dense_folder, viz: bool = False) -> List[Problem]:
    """Build the problem list from ``pair.txt``; source views with score
    <= 0 are dropped (main.cpp:297-305)."""
    dense_folder = Path(dense_folder)
    problems = []
    for i, (ref_id, srcs) in enumerate(
            formats.read_pair_txt(dense_folder / "pair.txt")):
        p = Problem(index=i, ref_image_id=ref_id,
                    src_image_ids=[sid for sid, score in srcs if score > 0.0],
                    dense_folder=dense_folder, show_medium_result=viz)
        p.result_folder.mkdir(parents=True, exist_ok=True)
        problems.append(p)
    return problems


def check_images(problems: List[Problem]) -> bool:
    """All reference images must exist and share one size
    (main.cpp:310-329)."""
    if not problems:
        return False
    size = None
    for p in problems:
        img = load_image_gray(p.dense_folder, p.ref_image_id)
        if img is None:
            return False
        if size is None:
            size = img.shape
        elif img.shape != size:
            return False
    return True


def image_path(dense_folder, image_id: int) -> Path:
    return Path(dense_folder) / "images" / f"{image_id:08d}.jpg"


def cam_path(dense_folder, image_id: int) -> Path:
    return Path(dense_folder) / "cams" / f"{image_id:08d}_cam.txt"


def load_image_gray(dense_folder, image_id: int) -> Optional[np.ndarray]:
    """Grayscale float32 image in [0, 255] (DPE.cpp:744-748); None if the
    file does not exist (a file it cannot decode raises)."""
    path = image_path(dense_folder, image_id)
    if not path.is_file():
        return None
    return imread.read_gray(path)


def load_image_color(dense_folder, image_id: int) -> Optional[np.ndarray]:
    """BGR uint8 (H, W, 3) image (fusion reads colour, DPE.cpp:1253); None
    if the file does not exist."""
    path = image_path(dense_folder, image_id)
    if not path.is_file():
        return None
    return imread.read_color_u8(path)


def load_camera(dense_folder, image_id: int) -> CameraData:
    K, R, t, dmin, dmax = formats.read_cam_txt(cam_path(dense_folder,
                                                        image_id))
    return CameraData(K=K, R=R, t=t, depth_min=dmin, depth_max=dmax)


def resize_linear(img: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """Bilinear resize of a float32 image, as ``cv2.resize(img, (cols,
    rows), interpolation=INTER_LINEAR)``: half-pixel centres; along x a tap
    beyond the border is clamped with weight 0 on the far pixel, along y the
    row index is clipped. Weights and sums in float64, rounded once to
    float32: exact wherever the result is a float32 (the halvings of an
    integer image), else within 1e-4 of OpenCV on [0, 255] images
    (``tests/test_torch_scene.py``)."""
    H, W = img.shape
    x0, x1, a0, a1 = imgproc.linear_taps(cols, W, True, np.float64)
    y0, y1, b0, b1 = imgproc.linear_taps(rows, H, False, np.float64)
    src = np.asarray(img, np.float64)
    hor = src[:, x0] * a0 + src[:, x1] * a1
    return (hor[y0] * b0[:, None] + hor[y1] * b1[:, None]).astype(np.float32)


def scaled_size(cols: int, rows: int, scale_size: int) -> Tuple[int, int]:
    """Round-to-nearest scaled size (DPE.cpp:800-802)."""
    factor = 1.0 / float(scale_size)
    return int(round(cols * factor)), int(round(rows * factor))


def rescale_nearest(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """Nearest-neighbour rescale of priors between rounds
    (``RescaleMatToTargetSize``, DPE.cpp:1146-1168; the intended mapping,
    not the reference's swapped scale_x / scale_y)."""
    if src.shape[1] == width and src.shape[0] == height:
        return src
    r_idx = np.minimum(
        (np.arange(height) * (src.shape[0] / height)).astype(np.int64),
        src.shape[0] - 1)
    c_idx = np.minimum(
        (np.arange(width) * (src.shape[1] / width)).astype(np.int64),
        src.shape[1] - 1)
    return src[np.ix_(r_idx, c_idx)]


def add_pass_inputs(inputs: ProblemInputs, result_folder,
                    view_folders: Sequence, *, need_prior: bool,
                    need_weak: bool, need_src_depths: bool) -> ProblemInputs:
    """The stored inputs of a later pass (DPE.cpp:846-912), each rescaled to
    the inputs' size: the prior depth, normal and selected views and the
    weak map from the problem's own ``result_folder``, and the depth map of
    every view of the problem (``view_folders``: the result folders of
    [ref, src...]; zeros where a view has none yet)."""
    W, H = inputs.width, inputs.height
    out = dataclasses.replace(inputs)
    rf = Path(result_folder)
    if need_prior:
        out.prior_depth = rescale_nearest(
            formats.read_dmb(rf / "depths.dmb").astype(np.float32), W, H)
        out.prior_normal = rescale_nearest(
            formats.read_dmb(rf / "normals.dmb").astype(np.float32), W, H)
        out.prior_selected_views = rescale_nearest(
            formats.read_dmb(rf / "selected_views.bin").astype(np.int32),
            W, H)
    if need_weak:
        out.weak_info = rescale_nearest(
            formats.read_dmb(rf / "weak.bin").astype(np.uint8), W, H)
    if need_src_depths:
        depths = []
        for folder in view_folders:
            p = Path(folder) / "depths.dmb"
            d = (formats.read_dmb(p).astype(np.float32) if p.exists()
                 else np.zeros((H, W), np.float32))
            depths.append(rescale_nearest(d, W, H))
        out.src_depths = np.stack(depths, axis=0)
    return out


def view_folders(problem: Problem) -> List[Path]:
    """The result folders of the problem's [ref, src...] views."""
    return [formats.result_folder(problem.dense_folder, iid)
            for iid in [problem.ref_image_id] + list(problem.src_image_ids)]


def load_problem_inputs(problem: Problem, scale_size: int, *,
                        need_prior: bool, need_weak: bool,
                        need_src_depths: bool) -> ProblemInputs:
    """Load and scale one problem's inputs (DPE.cpp:733-914): images and
    cameras of [ref, src...] at ``1 / scale_size`` of the full size, the
    depth range widened by 0.6 / 1.2 (DPE.cpp:788-789), and the stored
    inputs the pass reads (:func:`add_pass_inputs`)."""
    dense = problem.dense_folder
    ids = [problem.ref_image_id] + list(problem.src_image_ids)
    imgs, cams = [], []
    for iid in ids:
        img = load_image_gray(dense, iid)
        if img is None:
            raise FileNotFoundError(f"image {image_path(dense, iid)} is "
                                    "missing")
        cam = load_camera(dense, iid)
        if scale_size != 1:
            cols, rows = scaled_size(img.shape[1], img.shape[0], scale_size)
            cam = cam.scaled(cols / img.shape[1], rows / img.shape[0], cols,
                             rows)
            img = resize_linear(img, cols, rows)
        else:
            cam = dataclasses.replace(cam, width=img.shape[1],
                                      height=img.shape[0])
        imgs.append(img)
        cams.append(cam)
    height, width = imgs[0].shape
    inputs = ProblemInputs(images=np.stack(imgs, axis=0), cameras=cams,
                           depth_min=cams[0].depth_min * 0.6,
                           depth_max=cams[0].depth_max * 1.2,
                           width=width, height=height)
    return add_pass_inputs(
        inputs, problem.result_folder, view_folders(problem),
        need_prior=need_prior, need_weak=need_weak,
        need_src_depths=need_src_depths)
