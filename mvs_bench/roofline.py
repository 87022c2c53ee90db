"""The card's peaks and the work of each hand-written kernel.

A launch's bound is the least time the card could take for it: the larger
of the bytes it must move over the memory rate and its float32 operations
over the float32 peak outside the tensor cores (NVIDIA H100 SXM data sheet,
at the full 700 W). Bytes count each index and output element once and each
image element that the launch's indices reach once: a gather's work depends
on its data, so the image is counted as far as these indices need it, not
whole. Copied from ``chip_smoke.py``'s ``bound`` (granule 1), with the
channel index of ``gather2d_pick`` counted at its own 8 bytes.

One function per kernel entry gives (bytes, operations) from the launch's
shapes and the count of distinct image elements it touches;
:func:`touched` computes that count on the launch's device from its indices,
without waiting for the device.
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, device memory
F32_OPS_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores
KERNELS = ("row_gather", "bilinear_x", "gather2d", "gather2d_hwc",
           "gather2d_pick")
# Substrings of the kernels' device names (csrc/rowgather.cu,
# csrc/gather2d.cu): the trace's name of each launch.
DEVICE_NAMES = ("rowgather_flat", "rowgather_staged", "gather2d_tiles",
                "gather2d_hwc_kernel", "gather2d_pick_kernel")
BILINEAR_OPS = 10   # per output: 2 clamps of x, floor, 2 clamps of x0,
                    # 1 - f, x - x0, two products and a sum

Work = Tuple[int, int]           # (bytes, float32 operations)


def row_gather_work(H: int, L: int, touched: int, elem: int = 4) -> Work:
    """(H, W) image of ``elem``-byte words, (H, L) int32 indices, (H, L)
    output; ``touched`` distinct image words."""
    return elem * touched + 4 * H * L + elem * H * L, 0


def bilinear_x_work(H: int, L: int, touched: int) -> Work:
    """(H, W) float32 image, (H, L) float32 columns, (H, L) output;
    ``touched`` distinct image words of both taps."""
    return 4 * touched + 8 * H * L, BILINEAR_OPS * H * L


def gather2d_work(C: int, Q: int, touched: int, elem: int = 4) -> Work:
    """(C, H, W) image, Q (iy, ix) int32 queries, (C, Q) output;
    ``touched`` distinct pixels (each read in every channel)."""
    return C * elem * touched + 8 * Q + C * elem * Q, 0


def gather2d_hwc_work(row_bytes: int, Q: int, touched: int) -> Work:
    """(H, W, C) image whose pixel holds ``row_bytes``, Q int32 (iy, ix)
    queries, Q pixels out; ``touched`` distinct pixels."""
    return row_bytes * touched + 8 * Q + row_bytes * Q, 0


def gather2d_pick_work(Q: int, touched: int, elem: int = 4,
                       ic_elem: int = 8) -> Work:
    """(C, H, W) image, Q (ic, iy, ix) queries (ic int64), Q words out;
    ``touched`` distinct (channel, pixel) words."""
    return elem * touched + (ic_elem + 8) * Q + elem * Q, 0


def bound_s(n_bytes: float, ops: float) -> float:
    """Seconds: the larger of the memory bound and the float32 bound."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def touched(flat_index, n_cells: int):
    """The number of distinct values in ``flat_index`` (int64, each in
    [0, n_cells)), as a 0-d tensor on its device: a mark per cell, no host
    synchronisation."""
    import torch
    mark = torch.zeros(n_cells, dtype=torch.bool, device=flat_index.device)
    mark[flat_index.reshape(-1)] = True
    return mark.sum()


def launch_work(name: str, args, out):
    """(bytes, ops) of one launch of kernel entry ``name`` on ``args`` (the
    entry's positional arguments) giving ``out``; bytes is a 0-d device
    tensor (the touched count is the launch's data), ops an int."""
    import torch
    if name in ("row_gather", "bilinear_x"):
        img, idx = args
        H, W = img.shape
        L = idx.shape[1]
        rows = torch.arange(H, device=img.device, dtype=torch.int64)[:, None]
        if name == "row_gather":
            words = rows * W + idx.clamp(0, W - 1).long()
            b, ops = row_gather_work(H, L, 0, img.element_size())
            return b + img.element_size() * touched(words, H * W), ops
        x0 = idx.clamp(0.0, W - 1.0).floor().clamp(0.0, max(W - 2.0, 0.0))
        x0 = x0.long()
        words = torch.cat([(rows * W + x0).reshape(-1),
                           (rows * W + (x0 + 1).clamp(max=W - 1)).reshape(-1)])
        b, ops = bilinear_x_work(H, L, 0)
        return b + 4 * touched(words, H * W), ops
    if name == "gather2d":
        imgs, iy, ix = args
        C = imgs.shape[0] if imgs.dim() == 3 else 1
        H, W = imgs.shape[-2:]
        pix = iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long()
        b, ops = gather2d_work(C, iy.numel(), 0, imgs.element_size())
        return b + C * imgs.element_size() * touched(pix, H * W), ops
    if name == "gather2d_hwc":
        img, iy, ix = args
        H, W, C = img.shape
        row = C * img.element_size()
        pix = iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long()
        b, ops = gather2d_hwc_work(row, iy.numel(), 0)
        return b + row * touched(pix, H * W), ops
    if name == "gather2d_pick":
        imgs, ic, iy, ix = args
        C, H, W = imgs.shape
        words = ((ic.clamp(0, C - 1).long() * H + iy.clamp(0, H - 1).long())
                 * W + ix.clamp(0, W - 1).long())
        b, ops = gather2d_pick_work(iy.numel(), 0, imgs.element_size(),
                                    ic.element_size())
        return b + imgs.element_size() * touched(words, C * H * W), ops
    raise KeyError(name)
