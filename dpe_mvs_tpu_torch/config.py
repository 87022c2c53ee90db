"""Runtime configuration of the PyTorch port.

The port's own copy of :mod:`dpe_mvs_tpu.config` (same fields, defaults and
schedule), so that the port imports nothing of the JAX package. The
reference hard-codes its knobs as compile-time constants and a mutable
``PatchMatchParams`` struct (``csrc/DPE-MVS/main.h:38-106``); here every knob
is an explicit dataclass field and dataset profiles are presets.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

# Reference compile-time constants (main.h:38-42).
MAX_IMAGES = 32          # hard cap on 1 ref + src views (bitmask lives in uint32)
NEIGHBOUR_NUM = 9        # 1 center + 8 deformable strong anchors per weak pixel
MAX_SEARCH_RADIUS = 4096  # anchor search reach (GenNeighbours)

COST_MAX = 2.0           # NCC cost ceiling (DPE.cu:573)
GEOM_COST_MAX = 3.0      # geometric consistency cost ceiling (DPE.cu:925)


class RunState(enum.IntEnum):
    """Schedule state (main.h:66-70)."""

    FIRST_INIT = 0    # round 0 pass A: random plane init
    REFINE_INIT = 1   # later rounds pass A: keep prior unless better by 0.1
    REFINE_ITER = 2   # geometric-consistency passes


class PixelState(enum.IntEnum):
    """Per-pixel texture classification (main.h:72-76)."""

    WEAK = 0
    STRONG = 1
    UNKNOWN = 2


@dataclasses.dataclass(frozen=True)
class PatchMatchParams:
    """Per-sweep parameters (reference ``PatchMatchParams``, main.h:78-106).

    Frozen, so a params instance is hashable and can key caches.
    """

    max_iterations: int = 3
    sigma_spatial: float = 5.0
    sigma_color: float = 3.0
    top_k: int = 4                 # ETH3D: 4, TnT: 8 (main.h:83)
    geom_consistency: bool = False
    strong_radius: int = 5
    strong_increment: int = 2
    weak_radius: int = 5
    weak_increment: int = 5
    use_APD: bool = True           # weak-pixel machinery on/off
    use_edge: bool = True          # edge-bounded strong propagation sampling
    use_limit: bool = True         # Bresenham edge limit for weak anchors
    use_label: bool = True         # label-region anchor extension
    use_radius: bool = True        # adaptive NCC radius for weak pixels
    high_res_img: bool = True      # ETH3D: True, TnT: False (main.h:97)
    weak_peak_radius: int = 2
    rotate_time: int = 4
    ransac_threshold: float = 0.005
    geom_factor: float = 0.2
    state: RunState = RunState.FIRST_INIT
    # Stride of the strong-propagation candidate-screening evaluations on
    # the rect engine: None = auto (2 once the rect frame exceeds 384x512);
    # candidates + view selection are scored on the stride-subgrid of
    # window centers, then the winner is re-scored exactly
    # (strong_rect.screen_stride). 1 forces exact screening everywhere.
    propagate_stride: Optional[int] = None
    # Probe-center stride for the DepthToWeak classify sweep on the rect
    # engine: None = auto (stride 2 once the rect frame exceeds 384x512 —
    # neighbouring pixels share a 61-probe profile, measured 96% argmin
    # agreement in the JAX package's measurements); 1 forces the exact
    # per-pixel reference semantics (DPE.cu:2593), 2 forces the strided
    # path at any size (test coverage of the production labeling path).
    classify_stride: Optional[int] = None

    def replace(self, **kw) -> "PatchMatchParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    """Named preset replacing the reference's recompile-to-switch knobs."""

    name: str
    top_k: int
    high_res_img: bool

    def apply(self, params: PatchMatchParams) -> PatchMatchParams:
        return params.replace(top_k=self.top_k, high_res_img=self.high_res_img)


ETH3D = DatasetProfile(name="eth3d", top_k=4, high_res_img=True)
TANKS_AND_TEMPLES = DatasetProfile(name="tnt", top_k=8, high_res_img=False)

PROFILES = {p.name: p for p in (ETH3D, TANKS_AND_TEMPLES)}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Global engine configuration (no reference analogue)."""

    # Static padded source-view count per compiled engine. Problems with fewer
    # sources are masked; more are truncated (reference truncates at 32 too).
    max_src_views: int = 20
    # Round target: halve resolution until max dim <= this (main.cpp:390-408).
    coarse_target: int = 800
    min_rounds: int = 2
    # PRNG seed (the reference seeds curand with clock64(); we are deterministic).
    seed: int = 20240817
    profile: DatasetProfile = ETH3D
    # Cap on padded images kept resident on device at once.
    max_images: int = MAX_IMAGES
    # Cost engine: False runs the exact engine (per-pixel homography NCC,
    # every 2-D gather through gather2d_hwc); True or None the rectified
    # row-local engine. The JAX package's None picks the exact engine on
    # the CPU, a TPU workaround; the port's None keeps the rect engine on
    # every device, so a default run computes the same on the CPU as on the
    # card (a deliberate difference, ROADMAP queue 3).
    use_rect: Optional[bool] = None


def compute_round_num(width: int, height: int, cfg: EngineConfig) -> int:
    """Coarse-to-fine round count (main.cpp:390-408)."""
    max_size = max(width, height)
    round_num = 1
    while max_size > cfg.coarse_target:
        max_size //= 2
        round_num += 1
    return max(round_num, cfg.min_rounds)


def schedule_params(
    base: PatchMatchParams, round_idx: int, geom_pass: Optional[int]
) -> PatchMatchParams:
    """Parameter schedule for (round, pass) — mirrors main.cpp:508-556.

    ``geom_pass`` is None for the photometric pass A, else 0..2 for the three
    geometric-consistency passes B.
    """
    i = round_idx
    if geom_pass is None:
        p = base.replace(
            state=RunState.FIRST_INIT if i == 0 else RunState.REFINE_INIT,
            use_APD=i > 0,
            use_edge=i > 0,
            geom_consistency=False,
            max_iterations=3,
            weak_peak_radius=6,
        )
    else:
        j = geom_pass
        p = base.replace(
            state=RunState.REFINE_ITER,
            use_APD=i > 0,
            use_edge=i > 0,
            geom_consistency=True,
            max_iterations=3,
            weak_peak_radius=max(4 - 2 * j, 2),
        )
    if i > 0:
        p = p.replace(
            ransac_threshold=0.01 - i * 0.00125,
            rotate_time=min(2 ** i, 4),
        )
    return p
