"""Public API with reference signature parity.

``dpe_mvs(dense_folder, gpu_index, verbose, fusion, viz, depth, normal,
weak, edge) -> int`` has the positional signature and defaults of the JAX
package's ``dpe_mvs_tpu.api.dpe_mvs`` (``src/DPE_MVS/__init__.py:6-18``);
``gpu_index`` selects ``cuda:<gpu_index>`` (the reference calls
``cudaSetDevice``, main.cpp:478); ``parallel=True`` runs on several devices
instead.
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


def _rank_main(rank: int, world: int, port: int, dense_folder: str,
               kw: dict) -> None:
    """One worker of ``dpe_mvs(parallel=True)`` on a host with several
    cards: rank ``rank`` of ``world`` on ``cuda:<rank>``, NCCL over a local
    TCP rendezvous."""
    import torch.distributed as dist
    from .parallel import mesh
    from .pipeline.parallel_schedule import run_pipeline_parallel
    dev = torch.device("cuda", rank)
    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, device=dev)
    try:
        ret = run_pipeline_parallel(dense_folder, group=mesh.make_group(dev),
                                    device=dev, **kw)
        if ret != 0:
            raise RuntimeError(f"rank {rank} failed with code {ret}")
    finally:
        dist.destroy_process_group()


def _run_parallel(dense_folder, gpu_index: int, device, kw: dict) -> int:
    """``dpe_mvs(parallel=True)``: see its docstring for the three cases."""
    import torch.distributed as dist
    from .parallel import mesh
    want = torch.device("cuda" if device is None else device)
    mesh.initialize_distributed(device=want)
    if dist.is_initialized() and dist.get_world_size() > 1:
        from .pipeline.parallel_schedule import run_pipeline_parallel
        group = mesh.make_group(want)
        return run_pipeline_parallel(dense_folder, group=group,
                                     device=group.device, **kw)
    if not dist.is_initialized() and want.type == "cuda" and \
            torch.cuda.is_available() and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        torch.multiprocessing.spawn(
            _rank_main, args=(n, mesh.free_port(), str(dense_folder), kw),
            nprocs=n, join=True)
        return 0
    from .pipeline.schedule import run_pipeline
    return run_pipeline(dense_folder, device=_device(gpu_index, device), **kw)


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
    """Run the full DPE-MVS pipeline. Returns 0 on success; raises
    RuntimeError on failure (as the reference bindings do,
    csrc/bindings.cpp:27).

    ``fusion=True`` writes the fused point cloud ``DPE/DPE.ply``;
    ``viz=True`` the debug images of every sweep and scale.
    ``resume=True`` continues from the last completed iteration (with
    ``parallel``, the last completed round). ``device``: "cpu" (or any
    torch device) in place of the card.

    ``parallel=True`` shards the problem list over devices, one process
    (rank) per device (``pipeline.parallel_schedule.run_pipeline_parallel``):
      (a) in a process group of more than one rank, made before the call
          or by ``parallel.mesh.initialize_distributed`` from the
          ``DPE_MVS_COORDINATOR`` / ``DPE_MVS_NUM_PROCS`` / ``DPE_MVS_PROC_ID``
          variables (``DPE_MVS_COORDINATOR=auto``: torchrun's), this
          process runs its rank on ``cuda:<LOCAL_RANK or rank % cards>``,
          or on the CPU over gloo with ``device="cpu"``;
      (b) with no process group and more than one card visible, one worker
          per card is started here (NCCL, a local rendezvous);
      (c) otherwise the sequential pipeline runs on one device, as without
          ``parallel``."""
    kw = dict(verbose=verbose, fusion=fusion, viz=viz, depth=depth,
              normal=normal, weak=weak, edge=edge, cfg=cfg, resume=resume)
    try:
        if parallel:
            ret = _run_parallel(dense_folder, gpu_index, device, kw)
        else:
            from .pipeline.schedule import run_pipeline
            ret = run_pipeline(dense_folder, device=_device(gpu_index,
                                                            device), **kw)
    except (KeyboardInterrupt, RuntimeError):
        raise
    except Exception as e:
        # Reference parity: any pipeline failure surfaces as RuntimeError
        # (csrc/bindings.cpp:27 turns any nonzero return into one).
        raise RuntimeError(f"DPE-MVS failed: {e}") from e
    if ret != 0:
        raise RuntimeError(f"DPE-MVS failed with code {ret}")
    return ret
