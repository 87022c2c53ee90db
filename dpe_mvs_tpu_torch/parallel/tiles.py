"""Tile-level sharding with halo refresh.

Port of :mod:`dpe_mvs_tpu.parallel.tiles`. View-data parallelism
(:mod:`.mesh`) scales the problem list; this module scales a single
problem: the image's rows are banded over the ranks of a view group, one
band (tile) per rank, each rank sweeps its band, and the propagation
stencil's reads across bands are served by a halo of rows that is refreshed
from the neighbouring ranks after every strong iteration (two
point-to-point shifts, down and up). The reference has no counterpart (it
is single-GPU, main.cpp:478).

Each band is a cropped sub-problem on the host (cameras with the principal
point shifted by the band origin), so the rect engine runs unchanged on
it. Every rank computes every band's natural rect frame on the host, so
all ranks agree on the common frame without a collective. Rectification
preserves rows, which is what makes the costs of a crop match the whole
frame's away from its borders; what is left (each band's frame is fitted
to its crop, each band draws its own numbers) is statistical.

Scope, as in the JAX package: the photometric strong path (FIRST_INIT /
REFINE_INIT). The weak machinery's anchor search reaches up to
MAX_SEARCH_RADIUS = 4096 px (main.h:42), beyond any halo, so
:func:`tile_sharded_sweep` rejects ``use_APD``. Its known defects are kept
(ROADMAP queue 3): ``HALO = 64`` rows, and the halos are refreshed after
both colours of an iteration. It is wired into no runner.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..config import PatchMatchParams
from ..engine import patchmatch as pm
from ..engine import rectcost
from ..engine import stages as stg
from ..engine import state as st_mod
from ..engine.state import PMState, ProblemInputs, SweepData
from . import mesh as mesh_mod

HALO = 64   # rows; >= 2x the edge-mode candidate reach of ~45/2 per color


def _crop_rows(arr: np.ndarray, o: int, rows: int) -> np.ndarray:
    """Rows [o, o+rows) with edge replication outside the image."""
    H = arr.shape[-2] if arr.ndim >= 2 else arr.shape[0]
    idx = np.clip(np.arange(o, o + rows), 0, H - 1)
    return np.take(arr, idx, axis=arr.ndim - 2)


def build_tile_inputs(inputs: ProblemInputs, n_tiles: int,
                      halo: int = HALO) -> Tuple[List[ProblemInputs], int]:
    """Split one problem into ``n_tiles`` row-band sub-problems of uniform
    height (band + 2*halo, edge-replicated at the image borders). The
    cropped cameras shift the principal point by the band origin, so every
    projective relation holds as it is on the crop. Returns (tiles, band
    height)."""
    H = inputs.height
    hb = -(-H // n_tiles)
    rows = hb + 2 * halo
    tiles = []
    for t in range(n_tiles):
        o = t * hb - halo
        cams = []
        for c in inputs.cameras:
            K = c.K.copy()
            K[1, 2] -= o
            cams.append(dataclasses.replace(c, K=K, height=rows))
        tiles.append(ProblemInputs(
            images=_crop_rows(inputs.images, o, rows),
            cameras=cams,
            depth_min=inputs.depth_min, depth_max=inputs.depth_max,
            width=inputs.width, height=rows,
            src_depths=(_crop_rows(inputs.src_depths, o, rows)
                        if inputs.src_depths is not None else None),
        ))
    return tiles, hb


def build_tile_data(inputs: ProblemInputs, n_tiles: int, tile: int,
                    v_pad: int, halo: int = HALO, device="cuda"):
    """Tile ``tile``'s sweep inputs on ``device``: its ``SweepData`` with
    rect views on the common frame of all ``n_tiles`` tiles (the largest
    of their natural frames). Returns (data, rect statics, band height)."""
    tiles, hb = build_tile_inputs(inputs, n_tiles, halo)
    frames = [rectcost.build_rect_host(ti.cameras, ti.width, ti.height,
                                       v_pad).statics for ti in tiles]
    frame = (max(f.wp for f in frames), max(f.hp for f in frames))
    ti = tiles[tile]
    rh = rectcost.build_rect_host(ti.cameras, ti.width, ti.height, v_pad,
                                  force_size=frame, device=device)
    data = st_mod.build_sweep_data(ti, v_pad, device=device).replace(
        rect=rectcost.build_rect_views(rh, ti.images, device))
    return data, rh.statics, hb


def _halo_refresh(group: mesh_mod.ViewGroup, state: PMState, halo: int,
                  hb: int) -> PMState:
    """Refresh both halos of every per-pixel state field from the
    neighbouring ranks' interiors (two point-to-point shifts: each rank's
    last interior rows down to the next rank, its first interior rows up to
    the one before). The outermost halos (no neighbour) keep their
    values."""
    t, n = group.rank, group.world
    names = [f.name for f in dataclasses.fields(PMState) if f.name != "key"]
    fields = {k: getattr(state, k) for k in names
              if getattr(state, k).ndim >= 2
              and getattr(state, k).shape[0] == hb + 2 * halo}
    if n == 1 or not fields:
        return state
    xs = list(fields.values())
    from_above = mesh_mod.p2p(group, [x[hb:hb + halo] for x in xs],
                              t + 1 if t < n - 1 else None,
                              t - 1 if t > 0 else None)
    from_below = mesh_mod.p2p(group, [x[halo:2 * halo] for x in xs],
                              t - 1 if t > 0 else None,
                              t + 1 if t < n - 1 else None)
    out = {}
    for i, (k, x) in enumerate(fields.items()):
        top = from_above[i] if t > 0 else x[:halo]
        bot = from_below[i] if t < n - 1 else x[hb + halo:]
        out[k] = torch.cat([top, x[halo:hb + halo], bot], 0)
    return state.replace(**out)


def tile_sharded_sweep(group: mesh_mod.ViewGroup, data: SweepData,
                       state: PMState, params: PatchMatchParams, rstat,
                       hb: int, halo: int = HALO) -> PMState:
    """One photometric PatchMatch sweep of a single problem, its rows
    banded over the ranks of ``group``: this rank's tile (``data``,
    ``state`` from :func:`build_tile_data` / :func:`build_tile_inputs`).
    The key schedule is ``run_sweep_staged``'s; the halos are refreshed
    after every strong iteration. Returns the tile's interior rows (hb, W,
    ...); :func:`stitch_tiles` joins them."""
    if params.use_APD:
        raise ValueError("tile sharding covers the photometric strong "
                         "path; APD anchors reach past any halo "
                         "(MAX_SEARCH_RADIUS) — shard APD passes over "
                         "views instead")
    keys = state.key.split(32)
    sup = pm.EMPTY_SUPPORT
    if params.use_edge:
        sup, state = stg._support_stage(data, state, keys[0], params)
    state = stg._init_stage(data, state, params, rstat)
    for it in range(params.max_iterations):
        state = stg._strong_iter(data, state, it, keys[1].fold_in(it),
                                 params, rstat, sup)
        state = _halo_refresh(group, state, halo, hb)
    state = stg._finish_stage(data, state, params)
    state = stg._classify_stage(data, state, params, rstat)
    state = stg._refine_stage(data, state, params, rstat)
    inner = {f.name: getattr(state, f.name)[halo:halo + hb]
             for f in dataclasses.fields(PMState) if f.name != "key"}
    return state.replace(key=keys[-1], **inner)


def stitch_tiles(group: mesh_mod.ViewGroup, state: PMState,
                 H: int) -> PMState:
    """Every rank's (hb, W, ...) interior rows -> the (H, W, ...) state of
    the whole problem (an all-gather); the key stays this rank's."""
    out = {f.name: torch.cat(mesh_mod.all_gather(
        group, getattr(state, f.name)))[:H]
        for f in dataclasses.fields(PMState) if f.name != "key"}
    return state.replace(**out)
