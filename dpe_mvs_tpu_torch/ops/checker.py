"""Checkerboard compaction: one red-black color on (H, ceil(W/2)).

Port of :mod:`dpe_mvs_tpu.ops.checker`:

  - :func:`sites` gives the (x, y) pixel coordinates of color ``c``'s
    sites as a dense (H, W2) array: row y holds x = 2*j + ((y + c) % 2);
  - :func:`compact` reads those sites of a full-res array into a dense
    (H, W2, ...) array (:func:`compact_stack` over a leading batch axis);
  - :func:`scatter` writes a compacted result back (non-site pixels keep
    their values).

Odd widths are edge-padded: the padded site column computes values that
:func:`scatter` never reads back.
"""
from __future__ import annotations

import torch


def width2(W: int) -> int:
    return (W + 1) // 2


def sites(H: int, W: int, color: int, dtype=torch.float32, device="cpu"):
    """(ccx, ccy) of shape (H, W2): full-res coordinates of color's sites;
    x is clamped to W - 1 (odd-W padding sites compute throwaway values)."""
    W2 = width2(W)
    y = torch.arange(H, dtype=torch.int32, device=device)[:, None]
    j = torch.arange(W2, dtype=torch.int32, device=device)[None, :]
    x = torch.minimum(2 * j + (y + color) % 2,
                      torch.full((), W - 1, dtype=torch.int32, device=device))
    return x.expand(H, W2).to(dtype), y.expand(H, W2).to(dtype)


def _compact(arr: torch.Tensor, color: int, lead: int) -> torch.Tensor:
    """Color's sites of ``arr`` (*L, H, W, *C) with ``lead`` = len(L)."""
    H, W = arr.shape[lead:lead + 2]
    if W % 2:
        arr = torch.cat([arr, arr.narrow(lead + 1, W - 1, 1)], dim=lead + 1)
    W2 = arr.shape[lead + 1] // 2
    fp = arr.reshape(*arr.shape[:lead], H, W2, 2, *arr.shape[lead + 2:])
    par = (torch.arange(H, device=arr.device) + color) % 2
    parb = par.reshape(H, *([1] * (arr.dim() - lead - 1)))
    return torch.where(parb == 0, fp.select(lead + 2, 0),
                       fp.select(lead + 2, 1))


def compact(full: torch.Tensor, color: int) -> torch.Tensor:
    """Color's sites of ``full`` (H, W, *C) -> (H, W2, *C)."""
    return _compact(full, color, 0)


def compact_stack(arr: torch.Tensor, color: int) -> torch.Tensor:
    """compact() over a leading batch axis: (B, H, W, *C) -> (B, H, W2,
    *C)."""
    return _compact(arr, color, 1)


def scatter(full: torch.Tensor, comp: torch.Tensor, color: int
            ) -> torch.Tensor:
    """Write ``comp`` (H, W2, *C) into ``full`` (H, W, *C) at color's sites:
    full[y, x] = comp[y, x // 2] where (x + y) % 2 == color."""
    H, W = full.shape[:2]
    rep = torch.repeat_interleave(comp, 2, dim=1)[:, :W]
    y = torch.arange(H, device=full.device)[:, None]
    x = torch.arange(W, device=full.device)[None, :]
    mask = ((x + y) % 2) == color
    mask = mask.reshape(H, W, *([1] * (full.dim() - 2)))
    return torch.where(mask, rep, full)
