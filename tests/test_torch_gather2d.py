"""The port's 2-D point gather (``ops/gather2d``, ``ops/sampling``) against
the JAX package.

CPU: the plain version ``gather2d_ref`` (which the wrapper takes for CPU
tensors) against JAX ``gather2d`` in Pallas interpret mode (the TPU kernels'
own logic, both the VMEM and the forced HBM path) and on its CPU fast path;
``gather_map`` against JAX ``gather_map``; the bf16 pair packing through the
gather. Every comparison is exact, on the 32-bit words (NaN payloads
included).

GPU (marked ``gpu``, skipped without a CUDA device): the CUDA kernel against
the plain version, bit-exact, at ragged shapes, in both of the JAX package's
size regimes (a channel up to 6 MB and above), with clustered and scattered
queries; the wrapper's checks and launch counter.
"""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from dpe_mvs_tpu_torch.ops import gather2d as tg
from dpe_mvs_tpu_torch.ops import sampling as tsamp


def gpu(fn):
    """Mark a test for the GPU tier; it skips where torch sees no card."""
    skip = pytest.mark.skipif("not torch.cuda.is_available()",
                              reason="needs a CUDA device")
    return pytest.mark.gpu(skip(fn))


def _jg():
    from dpe_mvs_tpu.ops import gather2d
    return gather2d


def _words(a):
    """int32 view of 32-bit words, so NaN payloads compare by bits."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _image(rng, C, H, W, kind):
    if kind == "f32":
        return rng.standard_normal((C, H, W)).astype(np.float32)
    if kind == "i32":
        return rng.integers(-2**31, 2**31 - 1, (C, H, W),
                            dtype=np.int64).astype(np.int32)
    # uint32 masks whose float view holds NaN payloads (the bitcast
    # selected-view masks of the weak machinery).
    words = rng.integers(0, 2**32, (C, H, W), dtype=np.uint64)
    words[:, ::3] = 0x7FC00000 | (words[:, ::3] & 0x3FFFFF)
    words[:, 1::5] = 0xFF800001
    return words.astype(np.uint32)


def _queries(rng, H, W, Qh, Qw, clustered):
    if clustered:
        yy, xx = np.meshgrid(np.arange(Qh), np.arange(Qw), indexing="ij")
        iy = (yy * H // max(Qh, 1) + rng.integers(-6, 6, (Qh, Qw)))
        ix = (xx * W // max(Qw, 1) + rng.integers(-10, 10, (Qh, Qw)))
    else:
        iy = rng.integers(-4, H + 4, (Qh, Qw))
        ix = rng.integers(-4, W + 4, (Qh, Qw))
    return iy.astype(np.int32), ix.astype(np.int32)


def _to_torch(a):
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(a)


CASES = [
    # (C, H, W, Qh, Qw, dtype, clustered, squeeze)
    (2, 40, 64, 8, 24, "f32", True, False),
    (1, 32, 48, 4, 12, "f32", False, False),
    (3, 24, 32, 5, 7, "i32", True, False),
    (5, 17, 29, 3, 33, "u32", False, False),
    (1, 24, 32, 4, 8, "i32", False, True),
]


@pytest.mark.parametrize("C,H,W,Qh,Qw,kind,clustered,squeeze", CASES)
def test_gather2d_ref_matches_jax(C, H, W, Qh, Qw, kind, clustered, squeeze):
    import jax.numpy as jnp
    g2d = _jg()
    rng = np.random.default_rng(C * 100 + H)
    imgs = _image(rng, C, H, W, kind)
    if squeeze:
        imgs = imgs[0]
    iy, ix = _queries(rng, H, W, Qh, Qw, clustered)
    ours = tg.gather2d(_to_torch(imgs), torch.from_numpy(iy),
                       torch.from_numpy(ix))
    assert ours.dtype == _to_torch(imgs).dtype
    ours = _words(ours.view(torch.int32).numpy() if kind == "u32"
                  else ours.numpy())
    args = (jnp.asarray(imgs), jnp.asarray(iy), jnp.asarray(ix))
    interp = g2d.gather2d(*args, interpret=True)
    fast = g2d.gather2d(*args)
    np.testing.assert_array_equal(ours, _words(interp))
    np.testing.assert_array_equal(ours, _words(fast))


def test_gather2d_ref_matches_jax_hbm_path():
    """The windowed-DMA kernel (a channel > 6 MB on the TPU), forced at a
    small size with a tile-misaligned band, as tests/test_gather2d.py, on
    words carrying NaN payloads."""
    import jax.numpy as jnp
    g2d = _jg()
    rng = np.random.default_rng(5)
    C, H, W = 1, 96, 160
    imgs = _image(rng, C, H, W, "u32")
    Qh, Qw = g2d.QROWS, g2d.LANES
    iy = rng.integers(7, min(H, 7 + g2d.BR + 8), (Qh, Qw)).astype(np.int32)
    ix = rng.integers(5, W, (Qh, Qw)).astype(np.int32)
    ref = g2d._gather2d_hbm(jnp.asarray(imgs), jnp.asarray(iy),
                            jnp.asarray(ix), interpret=True)[:C, :Qh, :Qw]
    ours = tg.gather2d(_to_torch(imgs), torch.from_numpy(iy),
                       torch.from_numpy(ix))
    np.testing.assert_array_equal(_words(ours.view(torch.int32).numpy()),
                                  _words(ref))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8, np.bool_])
@pytest.mark.parametrize("trail", [(), (2,), (3, 2)])
def test_gather_map_matches_jax(dtype, trail):
    import jax.numpy as jnp
    from dpe_mvs_tpu.ops import sampling
    rng = np.random.default_rng(len(trail) * 7 + np.dtype(dtype).itemsize)
    H, W = 13, 21
    arr = rng.uniform(-50, 300, (H, W) + trail)
    arr = arr > 100 if dtype == np.bool_ else arr.astype(dtype)
    iy = rng.integers(-3, H + 3, (4, 5, 6)).astype(np.int32)
    ix = rng.integers(-3, W + 3, (1, 5, 6)).astype(np.int32)
    ours = tsamp.gather_map(torch.from_numpy(arr), torch.from_numpy(iy),
                            torch.from_numpy(ix))
    ref = np.asarray(sampling.gather_map(jnp.asarray(arr), jnp.asarray(iy),
                                         jnp.asarray(ix)))
    assert ours.dtype == torch.from_numpy(arr).dtype
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_take_last_and_pick_last():
    rng = np.random.default_rng(4)
    arr = rng.standard_normal((5, 6, 9)).astype(np.float32)
    idx = rng.integers(0, 9, (5, 6, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tsamp.take_last(torch.from_numpy(arr), torch.from_numpy(idx)).numpy(),
        np.take_along_axis(arr, idx, axis=-1))
    idx1 = rng.integers(0, 9, (5, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        tsamp.pick_last(torch.from_numpy(arr), torch.from_numpy(idx1)).numpy(),
        np.take_along_axis(arr, idx1[..., None], axis=-1)[..., 0])


def test_bf16_pairs_through_the_gather():
    """unpack(gather(pack(x))) equals the JAX package's, value for value."""
    import jax.numpy as jnp
    g2d = _jg()
    rng = np.random.default_rng(9)
    vol = rng.uniform(0, 2, (16, 12, 20)).astype(np.float32)
    vol[3, 2:5, 4:9] = 1e4                               # VOL_INVALID marker
    iy, ix = _queries(rng, 12, 20, 6, 9, True)
    ref = g2d.unpack_bf16_pairs(g2d.gather2d(
        g2d.pack_bf16_pairs(jnp.asarray(vol)), jnp.asarray(iy),
        jnp.asarray(ix)))
    ours = tg.unpack_bf16_pairs(tg.gather2d(
        tg.pack_bf16_pairs(torch.from_numpy(vol)), torch.from_numpy(iy),
        torch.from_numpy(ix)))
    assert ours.dtype == torch.bfloat16 and ours.shape == (16, 6, 9)
    np.testing.assert_array_equal(ours.to(torch.float32).numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_wrapper_rejects_bad_input():
    img = torch.zeros(2, 4, 8)
    q = torch.zeros(3, 5, dtype=torch.int32)
    with pytest.raises(TypeError):
        tg.gather2d(img, q.long(), q)
    with pytest.raises(TypeError):
        tg.gather2d(img.double(), q, q)
    with pytest.raises(ValueError):
        tg.gather2d(img, q, q[:, :4])
    with pytest.raises(ValueError):
        tg.gather2d(img[None], q, q)


def test_cpu_path_launches_nothing():
    tg.reset_launches()
    tsamp.gather_map(torch.zeros(6, 7, 3), torch.zeros(4, 5, dtype=torch.int32),
                     torch.ones(4, 5, dtype=torch.int32))
    assert tg.LAUNCHES == {"gather2d": 0}


# --------------------------------------------------------------------------
# GPU tier
# --------------------------------------------------------------------------

# Ragged shapes, the anchor-profile shape of the 800x600 main path (9 packed
# channels over the 960x1024 rect frame, (4800, 800) queries) and one above
# the JAX package's 6 MB channel gate (9 channels over 1920x2048, (9600,
# 1600) queries).
GPU_CASES = CASES + [
    (6, 600, 800, 4800, 800, "i32", True, False),
    (9, 960, 1024, 4800, 800, "u32", True, False),
    (9, 1920, 2048, 9600, 1600, "u32", True, False),
    (17, 70, 33, 129, 257, "f32", False, False),
]


@gpu
@pytest.mark.parametrize("C,H,W,Qh,Qw,kind,clustered,squeeze", GPU_CASES)
def test_gpu_gather2d_bit_exact(C, H, W, Qh, Qw, kind, clustered, squeeze):
    rng = np.random.default_rng(C + H + Qw)
    imgs = _image(rng, C, H, W, kind)
    if squeeze:
        imgs = imgs[0]
    iy, ix = _queries(rng, H, W, Qh, Qw, clustered)
    img_t = _to_torch(imgs).cuda()
    iy_t, ix_t = torch.from_numpy(iy).cuda(), torch.from_numpy(ix).cuda()
    tg.reset_launches()
    out = tg.gather2d(img_t, iy_t, ix_t)
    torch.cuda.synchronize()
    assert tg.LAUNCHES["gather2d"] == 1
    ref = tg.gather2d_ref(img_t, iy_t, ix_t)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@gpu
def test_gpu_wrapper_rejects_bad_input():
    img = torch.zeros(2, 4, 8, device="cuda")
    q = torch.zeros(3, 10, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):           # not contiguous
        tg.gather2d(img, q[:, ::2], q[:, ::2])
    with pytest.raises(ValueError):           # devices differ
        tg.gather2d(img, q.cpu(), q)
    tg.reset_launches()
    tsamp.gather_map(img.permute(1, 2, 0), q, q)
    tg.gather2d(img, q, q)
    assert tg.LAUNCHES == {"gather2d": 2}
