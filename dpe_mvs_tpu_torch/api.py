"""Public API with reference signature parity.

``dpe_mvs(dense_folder, gpu_index, verbose, fusion, viz, depth, normal,
weak, edge) -> int`` has the positional signature and defaults of the JAX
package's ``dpe_mvs_tpu.api.dpe_mvs`` (``src/DPE_MVS/__init__.py:6-18``);
``gpu_index`` selects ``cuda:<gpu_index>`` (the reference calls
``cudaSetDevice``, main.cpp:478).
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import EngineConfig


def _device(gpu_index: int, device) -> torch.device:
    """``device`` if given, else the card ``gpu_index`` (``cuda:0`` when
    the index is out of range); raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("DPE-MVS needs a CUDA device (torch.cuda is not "
                           "available); pass device='cpu' to run on the CPU")
    n = torch.cuda.device_count()
    return torch.device("cuda", gpu_index if 0 <= gpu_index < n else 0)


def dpe_mvs(
    dense_folder: str,
    gpu_index: int = 0,
    verbose: bool = True,
    fusion: bool = False,
    viz: bool = False,
    depth: bool = True,
    normal: bool = False,
    weak: bool = False,
    edge: bool = False,
    *,
    cfg: Optional[EngineConfig] = None,
    parallel: bool = False,
    resume: bool = False,
    device=None,
) -> int:
    """Run the full DPE-MVS pipeline on one device. Returns 0 on success;
    raises RuntimeError on failure (as the reference bindings do,
    csrc/bindings.cpp:27).

    ``fusion=True`` writes the fused point cloud ``DPE/DPE.ply``;
    ``viz=True`` the debug images of every sweep and scale.
    ``resume=True`` continues from the last completed iteration.
    ``device``: "cpu" (or any torch device) in place of the card.
    ``parallel=True`` (several devices) is not ported yet and raises
    NotImplementedError."""
    if parallel:
        raise NotImplementedError(
            "parallel=True (several devices) is not ported yet: it arrives "
            "with slice 6")
    dev = _device(gpu_index, device)
    from .pipeline.schedule import run_pipeline
    try:
        ret = run_pipeline(dense_folder, verbose=verbose, fusion=fusion,
                           viz=viz, depth=depth, normal=normal, weak=weak,
                           edge=edge, cfg=cfg, resume=resume, device=dev)
    except (KeyboardInterrupt, RuntimeError):
        raise
    except Exception as e:
        # Reference parity: any pipeline failure surfaces as RuntimeError
        # (csrc/bindings.cpp:27 turns any nonzero return into one).
        raise RuntimeError(f"DPE-MVS failed: {e}") from e
    if ret != 0:
        raise RuntimeError(f"DPE-MVS failed with code {ret}")
    return ret
