"""Checkerboard compaction: one red-black color on (H, ceil(W/2)).

Port of :mod:`dpe_mvs_tpu.ops.checker`:

  - :func:`compact` reads color ``c``'s sites of a full-res array into a
    dense (H, W2, ...) array: row y holds x = 2*j + ((y + c) % 2);
  - :func:`scatter` writes a compacted result back (non-site pixels keep
    their values).

Odd widths are edge-padded: the padded site column computes values that
:func:`scatter` never reads back.
"""
from __future__ import annotations

import torch


def compact(full: torch.Tensor, color: int) -> torch.Tensor:
    """Color's sites of ``full`` (H, W, *C) -> (H, W2, *C)."""
    H, W = full.shape[:2]
    if W % 2:
        full = torch.cat([full, full[:, -1:]], dim=1)
    W2 = full.shape[1] // 2
    fp = full.reshape(H, W2, 2, *full.shape[2:])
    par = (torch.arange(H, device=full.device) + color) % 2
    parb = par.reshape(H, *([1] * (full.dim() - 1)))
    return torch.where(parb == 0, fp[:, :, 0], fp[:, :, 1])


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
