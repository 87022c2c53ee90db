"""Checkerboard compaction of the PyTorch port against the JAX package:
``sites``, ``compact``, ``compact_stack`` and ``scatter`` bit-equal at
(6, 8), (5, 7), (7, 8) and (4, 9), both colors, and the invariants of
``tests/test_checker.py`` on the port's side."""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one thread per worker)
from dpe_mvs_tpu_torch.ops import checker as tc

import jax.numpy as jnp
from dpe_mvs_tpu.ops import checker as jc

SIZES = [(6, 8), (5, 7), (7, 8), (4, 9)]


def _site_x(y, j, color, W):
    return min(2 * j + ((y + color) % 2), W - 1)


@pytest.mark.parametrize("H,W", SIZES)
@pytest.mark.parametrize("color", [0, 1])
def test_equal_to_jax(rng, H, W, color):
    full = rng.normal(size=(H, W, 3)).astype(np.float32)
    stack = rng.normal(size=(4, H, W, 2)).astype(np.float32)
    base = rng.normal(size=(H, W, 3)).astype(np.float32)
    assert tc.width2(W) == jc.width2(W)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.int32, jnp.int32)):
        ccx, ccy = tc.sites(H, W, color, dt)
        jx, jy = jc.sites(H, W, color, jdt)
        assert ccx.dtype == dt
        np.testing.assert_array_equal(ccx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ccy.numpy(), np.asarray(jy))
    comp = tc.compact(torch.from_numpy(full), color)
    np.testing.assert_array_equal(
        comp.numpy(), np.asarray(jc.compact(jnp.asarray(full), color)))
    np.testing.assert_array_equal(
        tc.compact_stack(torch.from_numpy(stack), color).numpy(),
        np.asarray(jc.compact_stack(jnp.asarray(stack), color)))
    np.testing.assert_array_equal(
        tc.scatter(torch.from_numpy(base), comp, color).numpy(),
        np.asarray(jc.scatter(jnp.asarray(base), jnp.asarray(comp.numpy()),
                              color)))


@pytest.mark.parametrize("H,W", SIZES)
@pytest.mark.parametrize("color", [0, 1])
def test_roundtrip(rng, H, W, color):
    full = rng.normal(size=(H, W, 3)).astype(np.float32)
    base = rng.normal(size=(H, W, 3)).astype(np.float32)
    W2 = tc.width2(W)
    comp = tc.compact(torch.from_numpy(full), color).numpy()
    ccx, ccy = (a.numpy() for a in tc.sites(H, W, color))
    assert comp.shape == (H, W2, 3)
    exp_x = np.array([[_site_x(y, j, color, W) for j in range(W2)]
                      for y in range(H)])
    np.testing.assert_array_equal(ccx, exp_x)
    np.testing.assert_array_equal(ccy, np.arange(H)[:, None] + 0 * exp_x)
    np.testing.assert_allclose(comp, full[np.arange(H)[:, None], exp_x])
    out = tc.scatter(torch.from_numpy(base), torch.from_numpy(comp),
                     color).numpy()
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    site = ((xs + ys) % 2) == color
    np.testing.assert_allclose(out[site], full[site])     # sites written
    np.testing.assert_allclose(out[~site], base[~site])   # others untouched


def test_both_colors_cover_image():
    rng = np.random.default_rng(2)
    full = torch.from_numpy(rng.normal(size=(6, 9, 2)).astype(np.float32))
    out = torch.zeros_like(full)
    for color in (0, 1):
        out = tc.scatter(out, tc.compact(full, color), color)
    np.testing.assert_array_equal(out.numpy(), full.numpy())
