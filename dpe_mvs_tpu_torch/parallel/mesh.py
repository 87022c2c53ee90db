"""View-data parallelism over ranks of ``torch.distributed``.

Port of :mod:`dpe_mvs_tpu.parallel.mesh`. The reference is single-GPU and
sweeps the reference views one after another (main.cpp:508-567); its only
cross-view coupling is that geometric-consistency sweeps read *other*
views' depth maps from disk (DPE.cpp:826-844).

Here each rank owns one device and a contiguous block of problems (the
torch counterpart of a JAX ``Mesh`` over the ``views`` axis with
``shard_map`` + ``lax.map``): it sweeps its own problems one after another
(:func:`sharded_sweep`), and between sweeps the disk round-trip becomes a
collective over the ranks (:func:`exchange_depths`): an all-gather of the
ranks' depth blocks, or, when the pair graph touches few neighbouring
ranks, one point-to-point ring shift per used rank offset. NCCL carries the
collectives between cards, gloo between CPU processes.

Multi-host: :func:`initialize_distributed` sets up the process group from
the ``DPE_MVS_*`` environment variables (or torchrun's ``env://``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import PatchMatchParams
from ..engine import rectcost, stages
from ..engine.state import PMState, SweepData


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device a rank owns: ``cuda:<LOCAL_RANK or rank % cards>`` for a
    ``device`` of type cuda without an index, else ``device`` itself."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", index)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda") -> bool:
    """Multi-process bootstrap: ``dist.init_process_group`` behind env vars.

    Reads ``DPE_MVS_COORDINATOR`` (host:port), ``DPE_MVS_NUM_PROCS`` and
    ``DPE_MVS_PROC_ID`` when the arguments are not given;
    ``DPE_MVS_COORDINATOR=auto`` takes torchrun's ``env://`` rendezvous
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). The
    backend follows ``device``: NCCL for cuda (the rank's card is made the
    current device first), gloo for the CPU. Returns True if a process
    group exists afterwards; a second call is a no-op that returns True."""
    coordinator = coordinator or os.environ.get("DPE_MVS_COORDINATOR")
    if dist.is_initialized():
        return True
    if not coordinator:
        return False
    backend = _backend(device)
    if coordinator == "auto":
        rank = int(os.environ["RANK"])
        kw = dict(init_method="env://")
    else:
        if num_processes is None:
            num_processes = int(os.environ["DPE_MVS_NUM_PROCS"])
        if process_id is None:
            process_id = int(os.environ["DPE_MVS_PROC_ID"])
        rank = process_id
        kw = dict(init_method=f"tcp://{coordinator}",
                  world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device, rank))
    dist.init_process_group(backend, **kw)
    return True


@dataclasses.dataclass(frozen=True)
class ViewGroup:
    """The ranks that share the problem list (a JAX ``Mesh`` over its one
    ``views`` axis): this process's ``rank`` of ``world``, the ``device``
    it owns, and the process ``group`` (None for a single process without
    ``torch.distributed``, whose collectives are local copies)."""

    rank: int
    world: int
    device: torch.device
    group: object = None

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def make_group(device=None) -> ViewGroup:
    """The view group of this process: every rank of the default process
    group when one exists, else this process alone. ``device``: as
    :func:`rank_device` resolves it (the card by default)."""
    device = "cuda" if device is None else device
    if not dist.is_initialized():
        return ViewGroup(0, 1, rank_device(device, 0))
    rank, world = dist.get_rank(), dist.get_world_size()
    return ViewGroup(rank, world, rank_device(device, rank),
                     dist.group.WORLD)


def pad_problem_count(n: int, n_devices: int) -> int:
    return ((n + n_devices - 1) // n_devices) * n_devices


def block_size(n: int, group: ViewGroup) -> int:
    """Problems per rank: the padded count over the ranks (at least 1)."""
    return max(pad_problem_count(n, group.world), group.world) // group.world


def local_block(n: int, group: ViewGroup) -> range:
    """The real problems (of ``n``) this rank owns: the contiguous block
    ``[rank * b_loc, (rank + 1) * b_loc)`` cut at ``n``; the slots past
    ``n`` are padding (zero blocks in the exchange, never swept)."""
    b = block_size(n, group)
    return range(min(group.rank * b, n), min((group.rank + 1) * b, n))


# ---------------------------------------------------------------------------
# Collectives (a single process without a group: local copies)
# ---------------------------------------------------------------------------

def all_gather(group: ViewGroup, t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on every rank), in rank
    order."""
    t = t.contiguous()
    if group.group is None:
        return [t]
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for _ in range(group.world)]
    dist.all_gather(out, t, group=group.group)
    return out


def p2p(group: ViewGroup, sends: Sequence[torch.Tensor],
        send_to: Optional[int],
        recv_from: Optional[int]) -> List[torch.Tensor]:
    """Send ``sends`` to rank ``send_to`` and receive as many tensors of
    the same shapes and dtypes from ``recv_from``, in one
    ``dist.batch_isend_irecv`` round; either peer may be None (the ends of
    a non-cyclic shift). Returns the received tensors (none when
    ``recv_from`` is None)."""
    recv = ([torch.empty(t.shape, dtype=t.dtype, device=t.device)
             for t in sends] if recv_from is not None else [])
    ops = []
    if send_to is not None:
        ops += [dist.P2POp(dist.isend, t.contiguous(), send_to,
                           group=group.group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, recv_from, group=group.group)
            for t in recv]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def barrier(group: ViewGroup) -> None:
    if group.group is None:
        return
    if group.backend == "nccl":
        dist.barrier(group=group.group, device_ids=[group.device.index])
    else:
        dist.barrier(group=group.group)


def agree_min(group: ViewGroup, value: int) -> int:
    """The smallest ``value`` over the ranks."""
    if group.group is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=group.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group.group)
    return int(t.item())


# ---------------------------------------------------------------------------
# The sweep and the depth exchange
# ---------------------------------------------------------------------------

def sharded_sweep(group: ViewGroup, datas: Sequence[SweepData],
                  states: Sequence[PMState], params: PatchMatchParams,
                  rects=None) -> List[PMState]:
    """One PatchMatch sweep of this rank's problems, one after another
    (every rank in parallel): the counterpart of the JAX package's
    ``sharded_sweep`` / ``sharded_sweep_staged``, through the port's
    ``engine.stages.run_sweep_staged``. ``rects``: per problem, the rect
    engine's (``RectHost``, cameras), or None for the exact engine. In a
    geometric pass with the rect engine, the exchanged source depths
    (``data.src_depths``) are first warped into the rect frames
    (``rectcost.rectify_src_depths``, on the device)."""
    out = []
    for i, (data, st) in enumerate(zip(datas, states)):
        rstat = None
        if rects is not None:
            rh, cams = rects[i]
            rstat = rh.statics
            if params.geom_consistency:
                data = data.replace(rect=rectcost.rectify_src_depths(
                    data.rect, rh, data.src_depths[:len(cams) - 1], cams))
        out.append(stages.run_sweep_staged(data, st, params, rstat=rstat))
    return out


def exchange_plan(src_index: np.ndarray, world: int) -> Optional[List[int]]:
    """The rank shifts a pruned ring exchange of ``src_index`` uses, or
    None where the all-gather moves fewer blocks (``mesh.py:322-335`` of
    the JAX package: prune when the used nonzero shifts are fewer than
    ``world - 1``). Every rank decides alike from the host pair graph."""
    idx = np.asarray(src_index)
    B = idx.shape[0]
    b_loc = B // world
    if b_loc == 0:
        return None
    own = (np.arange(B) // b_loc)[:, None]
    src_dev = np.where(idx >= 0, idx // b_loc, 0)
    sh = (src_dev - own) % world
    used = sorted(set(np.unique(sh[idx >= 0]).tolist()))
    if len([s for s in used if s != 0]) < world - 1:
        return used
    return None


def exchange_depths(group: ViewGroup, local_depths: torch.Tensor,
                    src_index: np.ndarray) -> torch.Tensor:
    """The depth-exchange collective (replaces the reference's
    ``depths.dmb`` reads between sweeps, DPE.cpp:826-844).

    ``local_depths``: (b_loc, H, W) this rank's sanitised depth maps on its
    device (padding slots zeros). ``src_index``: the host pair graph,
    (world * b_loc, V) global problem index of every source slot, -1 for
    padding (:func:`build_src_index`). Returns (b_loc, V, H, W) source
    depth stacks of this rank's problems, zeros at padding slots: by one
    ring shift per used rank offset where :func:`exchange_plan` prunes,
    else by an all-gather of the blocks."""
    idx = np.asarray(src_index)
    b_loc = local_depths.shape[0]
    if idx.shape[0] != b_loc * group.world:
        raise ValueError(f"src_index has {idx.shape[0]} rows for "
                         f"{group.world} ranks of {b_loc} problems")
    mine = idx[group.rank * b_loc:(group.rank + 1) * b_loc]     # (b, V)
    used = exchange_plan(idx, group.world)
    dev = local_depths.device
    if used is None:
        flat = torch.cat(all_gather(group, local_depths))      # (B, H, W)
        sel = torch.as_tensor(np.maximum(mine, 0), dtype=torch.int64,
                              device=dev)
    else:
        # Shift s: rank k receives rank (k + s) % world's block.
        k, w = group.rank, group.world
        blocks = {0: local_depths}
        for s in used:
            if s != 0:
                blocks[s] = p2p(group, [local_depths], (k - s) % w,
                                (k + s) % w)[0]
        order = sorted(blocks)
        flat = torch.cat([blocks[s] for s in order])           # (T*b, H, W)
        src_dev = np.where(mine >= 0, mine // b_loc, k)
        pos = np.searchsorted(order, (src_dev - k) % w)
        pos = np.minimum(pos, len(order) - 1)
        sel = torch.as_tensor(pos * b_loc + np.where(mine >= 0, mine % b_loc,
                                                     0),
                              dtype=torch.int64, device=dev)
    picked = flat[sel]                                         # (b, V, H, W)
    valid = torch.as_tensor(mine >= 0, device=dev)[..., None, None]
    return torch.where(valid, picked, torch.zeros((), dtype=picked.dtype,
                                                  device=dev))


def build_src_index(problem_ids: List[int],
                    src_ids: List[List[int]], v_pad: int) -> np.ndarray:
    """(B, V) map from each problem's padded source slots to global problem
    indices (pair.txt adjacency)."""
    id_to_idx = {pid: i for i, pid in enumerate(problem_ids)}
    out = np.full((len(problem_ids), v_pad), -1, np.int32)
    for b, srcs in enumerate(src_ids):
        for v, sid in enumerate(srcs[:v_pad]):
            if sid in id_to_idx:
                out[b, v] = id_to_idx[sid]
    return out


def free_port() -> int:
    """A free TCP port on the loopback interface (for a local
    rendezvous)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
