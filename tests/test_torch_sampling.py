"""Image sampling of the PyTorch port against the JAX package.

``bilinear`` (four texels from the corner map by one gather), ``nearest``,
``lookup_int`` and ``gather_2x2`` are bit-equal to JAX's run op by op
(``jax.disable_jit()``; compiled XLA contracts the lerps into FMAs) on
random coordinates with out-of-range, +-inf and NaN values, on ragged,
W == 1 and H == 1 images, and in the view-stacked form the exact engine
uses. ``to_int32`` equals XLA's ``astype(int32)`` (and, rounding, JAX's
``round(x).astype(int32)``) on NaN, +-inf and values past 2^31. The cases
of ``tests/test_sampling.py`` run on the port's side.
"""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one thread per worker)
from dpe_mvs_tpu_torch.ops import sampling as ts

import jax
import jax.numpy as jnp
from dpe_mvs_tpu.ops import sampling as js

SHAPES = [(37, 53), (37, 1), (1, 53), (1, 1), (2, 2)]


def _coords(rng, shape, H, W):
    x = rng.uniform(-5, W + 5, shape).astype(np.float32)
    y = rng.uniform(-5, H + 5, shape).astype(np.float32)
    x.reshape(-1)[::11] = np.inf
    x.reshape(-1)[1::13] = -np.inf
    y.reshape(-1)[2::17] = np.nan
    x.reshape(-1)[3::19] = np.nan
    y.reshape(-1)[4::7] = np.round(y.reshape(-1)[4::7])   # texel centres
    return x, y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bilinear(img, x, y):
    """The port's bilinear sample of a numpy image at numpy coordinates."""
    return ts.bilinear(_t(img), _t(x), _t(y), ts.corner_map(_t(img))).numpy()


@pytest.mark.parametrize("H,W", SHAPES)
def test_bilinear_bit_equal(rng, H, W):
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    x, y = _coords(rng, (11, 13), H, W)
    with jax.disable_jit():
        want = np.asarray(js.bilinear(jnp.asarray(img), jnp.asarray(x),
                                      jnp.asarray(y)))
    corners = ts.corner_map(_t(img))
    assert corners.shape == (H, W, 4)
    np.testing.assert_array_equal(
        ts.bilinear(_t(img), _t(x), _t(y), corners).numpy(), want)


@pytest.mark.parametrize("H,W", SHAPES)
def test_nearest_and_lookup_int_bit_equal(rng, H, W):
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    x, y = _coords(rng, (9, 7), H, W)
    x.reshape(-1)[5::23] = 3e9                      # past the int32 range
    y.reshape(-1)[6::29] = -3e9
    with jax.disable_jit():
        want = np.asarray(js.nearest(jnp.asarray(img), jnp.asarray(x),
                                     jnp.asarray(y)))
    np.testing.assert_array_equal(ts.nearest(_t(img), _t(x), _t(y)).numpy(),
                                  want)
    lab = rng.integers(-5, 100, (H, W)).astype(np.int32)
    ix = rng.integers(-3, W + 3, (9, 7)).astype(np.int32)
    iy = rng.integers(-3, H + 3, (9, 7)).astype(np.int32)
    want = np.asarray(js.lookup_int(jnp.asarray(lab), jnp.asarray(ix),
                                    jnp.asarray(iy)))
    np.testing.assert_array_equal(
        ts.lookup_int(_t(lab), _t(ix), _t(iy)).numpy(), want)


def test_gather_2x2_bit_equal(rng):
    H, W = 23, 31
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    y0 = rng.integers(0, H - 1, (5, 6)).astype(np.int32)
    x0 = rng.integers(0, W - 1, (5, 6)).astype(np.int32)
    want = js.gather_2x2(jnp.asarray(img), jnp.asarray(y0), jnp.asarray(x0))
    got = ts.gather_2x2(ts.corner_map(_t(img)), _t(y0), _t(x0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_view_stacked_forms_equal_per_view(rng):
    """(V, H, W) images with a per-sample view index: each sample equals
    the single-image function on its own view."""
    V, H, W = 3, 17, 21
    imgs = rng.uniform(0, 255, (V, H, W)).astype(np.float32)
    x, y = _coords(rng, (V, 4, 6), H, W)
    view = torch.arange(V).reshape(V, 1, 1)
    corners = ts.corner_map(_t(imgs))
    assert corners.shape == (V, H, W, 4)
    bil = ts.bilinear(_t(imgs), _t(x), _t(y), corners, view).numpy()
    near = ts.nearest(_t(imgs), _t(x), _t(y), view).numpy()
    for v in range(V):
        np.testing.assert_array_equal(
            bil[v], _bilinear(imgs[v], x[v], y[v]))
        np.testing.assert_array_equal(
            near[v], ts.nearest(_t(imgs[v]), _t(x[v]), _t(y[v])).numpy())


def test_to_int32_is_xla_cast(rng):
    vals = np.concatenate([
        np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0 ** 31,
                  -2.0 ** 31, 2.0 ** 31 - 128, 0.5, 1.5, 2.5, -0.5, -1.5,
                  -2.5, -0.0, 2.7, -2.7], np.float32),
        rng.uniform(-1e4, 1e4, 200).astype(np.float32)])
    want = np.asarray(jnp.asarray(vals).astype(jnp.int32))
    np.testing.assert_array_equal(ts.to_int32(_t(vals)).numpy(), want)
    want_r = np.asarray(jnp.round(jnp.asarray(vals)).astype(jnp.int32))
    np.testing.assert_array_equal(ts.to_int32(_t(vals), rounding=True)
                                  .numpy(), want_r)


# ---- the cases of tests/test_sampling.py, on the port ----

def _np_bilinear_clamp(img, x, y):
    H, W = img.shape
    x = np.clip(x, 0.0, W - 1.0)
    y = np.clip(y, 0.0, H - 1.0)
    x0 = np.clip(np.floor(x), 0, W - 2).astype(int)
    y0 = np.clip(np.floor(y), 0, H - 2).astype(int)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + \
        (v10 * (1 - fx) + v11 * fx) * fy


def test_bilinear_matches_numpy(rng):
    img = rng.uniform(0, 255, size=(37, 53)).astype(np.float32)
    x = rng.uniform(-5, 60, size=(11, 13)).astype(np.float32)
    y = rng.uniform(-5, 45, size=(11, 13)).astype(np.float32)
    got = _bilinear(img, x, y)
    np.testing.assert_allclose(got, _np_bilinear_clamp(img, x, y), rtol=1e-5,
                               atol=1e-3)


def test_bilinear_integer_coords_exact(rng):
    img = rng.uniform(0, 255, size=(20, 30)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(20), np.arange(30), indexing="ij")
    got = _bilinear(img, xs.astype(np.float32), ys.astype(np.float32))
    np.testing.assert_allclose(got, img, rtol=1e-6)


def test_nearest_floor_semantics(rng):
    img = rng.uniform(0, 10, size=(16, 16)).astype(np.float32)
    x = torch.tensor([3.9, 7.2, 15.99, -2.0])
    y = torch.tensor([0.1, 7.9, 15.01, 20.0])
    got = ts.nearest(_t(img), x, y).numpy()
    np.testing.assert_allclose(got, img[[0, 7, 15, 15], [3, 7, 15, 0]])


def test_shift_clamps_edges(rng):
    img = rng.uniform(size=(8, 9)).astype(np.float32)
    for dy, dx in [(0, 0), (1, 0), (-1, 0), (0, 3), (-2, -2), (3, -1)]:
        got = ts.shift(_t(img), dy, dx).numpy()
        yy = np.clip(np.arange(8) + dy, 0, 7)
        xx = np.clip(np.arange(9) + dx, 0, 8)
        np.testing.assert_allclose(got, img[np.ix_(yy, xx)])


def test_lookup_int(rng):
    img = rng.integers(0, 100, size=(10, 12)).astype(np.int32)
    ix = torch.tensor([0, 11, 13, -1], dtype=torch.int32)
    iy = torch.tensor([0, 9, -3, 12], dtype=torch.int32)
    got = ts.lookup_int(_t(img), ix, iy).numpy()
    np.testing.assert_allclose(got, img[[0, 9, 0, 9], [0, 11, 11, 0]])
