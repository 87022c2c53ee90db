"""The port's 2-D point gathers (``ops/gather2d``, ``ops/sampling``) against
the JAX package.

CPU: the plain version ``gather2d_ref`` (which the wrapper takes for CPU
tensors) against JAX ``gather2d`` in Pallas interpret mode (the TPU kernels'
own logic, both the VMEM and the forced HBM path) and on its CPU fast path;
``gather2d_hwc_ref`` against JAX ``gather_map`` and ``gather2d_pick_ref``
against JAX ``pick_last(gather_map(...))``; ``gather_map`` against JAX
``gather_map``; the bf16 pair packing through the gather; the launch plans
(vector widths, tiles). Every comparison is exact, on the 32-bit words (NaN
payloads included) or bytes.

GPU (marked ``gpu``, skipped without a CUDA device): each CUDA entry against
its plain version, bit-exact, at ragged shapes and in every branch: the
channel-first tiles with vector and word I/O, in both of the JAX package's
size regimes (a channel up to 6 MB and above), with clustered and scattered
queries; the channel-last gather over bytes and words at every vector width,
at a 4-byte offset, on strided views and, through ``gather_map``, on a view
with permuted channels; the pick with channels out of range; the wrappers'
checks and launch counters.
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
    with pytest.raises(TypeError):
        tg.gather2d_pick(img.double(), q, q, q)
    with pytest.raises(TypeError):
        tg.gather2d_pick(img, q, q.long(), q)
    with pytest.raises(TypeError):
        tg.gather2d_pick(img, q.to(torch.int16), q, q)
    with pytest.raises(TypeError):            # channels int64 only
        tg.gather2d_pick(img, q, q, q)
    with pytest.raises(ValueError):
        tg.gather2d_pick(img, q[:, :4].long(), q, q)
    with pytest.raises(ValueError):
        tg.gather2d_hwc(img[0], q, q)
    with pytest.raises(TypeError):
        tg.gather2d_hwc(img, q, q.long())


def _hwc_image(rng, H, W, C, dtype):
    if dtype == np.bool_:
        return rng.uniform(size=(H, W, C)) < 0.3
    if dtype == np.uint8:
        return rng.integers(0, 256, (H, W, C)).astype(np.uint8)
    return _image(rng, C, H, W, "f32" if dtype == np.float32 else "i32"
                  ).transpose(1, 2, 0).copy()


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8, np.bool_])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 6, 16])
def test_gather2d_hwc_ref_matches_jax(C, dtype):
    """The channel-last plain version equals JAX ``gather_map`` on an
    (H, W, C) array, bit for bit, indices out of range included."""
    import jax.numpy as jnp
    from dpe_mvs_tpu.ops import sampling
    rng = np.random.default_rng(C * 31 + np.dtype(dtype).itemsize)
    H, W = 19, 27
    img = _hwc_image(rng, H, W, C, dtype)
    iy = rng.integers(-3, H + 3, (5, 11)).astype(np.int32)
    ix = rng.integers(-3, W + 3, (5, 11)).astype(np.int32)
    ours = tg.gather2d_hwc(torch.from_numpy(img), torch.from_numpy(iy),
                           torch.from_numpy(ix))
    ref = np.asarray(sampling.gather_map(jnp.asarray(img), jnp.asarray(iy),
                                         jnp.asarray(ix)))
    assert ours.shape == (5, 11, C) and ours.dtype == torch.from_numpy(
        img).dtype
    np.testing.assert_array_equal(_words(ours.numpy()), _words(ref))


@pytest.mark.parametrize("kind", ["f32", "i32", "u32"])
@pytest.mark.parametrize("shape", [(16, 13, 21, (4, 5, 6)), (3, 7, 9, (37,)),
                                   (1, 4, 5, (2, 3))])
def test_gather2d_pick_ref_matches_jax(shape, kind):
    """One channel per query equals JAX ``pick_last`` of the channel-last
    ``gather_map`` of every channel (the line-of-sight lookup)."""
    import jax.numpy as jnp
    from dpe_mvs_tpu.ops import sampling
    C, H, W, S = shape
    rng = np.random.default_rng(C + H)
    imgs = _image(rng, C, H, W, kind)
    ic = rng.integers(0, C, S).astype(np.int64)
    iy = rng.integers(-3, H + 3, S).astype(np.int32)
    ix = rng.integers(-3, W + 3, S).astype(np.int32)
    ours = tg.gather2d_pick(_to_torch(imgs), *(torch.from_numpy(a)
                                                for a in (ic, iy, ix)))
    chan = jnp.moveaxis(jnp.asarray(imgs), 0, -1)
    ref = sampling.pick_last(
        sampling.gather_map(chan, jnp.asarray(iy), jnp.asarray(ix)),
        jnp.asarray(ic))
    assert ours.shape == S
    np.testing.assert_array_equal(_words(ours.view(torch.int32).numpy()),
                                  _words(ref))


def test_gather2d_pick_ref_clamps_the_channel():
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(_image(rng, 5, 6, 7, "f32"))
    iy = torch.tensor([0, 7, -1, 2], dtype=torch.int32)
    ix = torch.tensor([3, 2, 8, -5], dtype=torch.int32)
    want = torch.stack([imgs[0, 0, 3], imgs[0, 5, 2], imgs[4, 0, 6],
                        imgs[4, 2, 0]])
    for ic in ([-4, 0, 4, 9], [-2**40, 0, 4, 2**40]):
        assert torch.equal(tg.gather2d_pick(
            imgs, torch.tensor(ic, dtype=torch.int64), iy, ix), want)


def test_gather2d_hwc_ref_reads_strided_views():
    """Slices of a channel-last array (``plane[..., :3]``,
    ``plane[..., 3]``) gather as their copies do."""
    rng = np.random.default_rng(8)
    plane = torch.from_numpy(rng.standard_normal((9, 14, 4)).astype(
        np.float32))
    iy = torch.from_numpy(rng.integers(-2, 11, (6, 5)).astype(np.int32))
    ix = torch.from_numpy(rng.integers(-2, 16, (6, 5)).astype(np.int32))
    for view in (plane[..., :3], plane[..., 3:], plane[:, 1:12]):
        assert torch.equal(tg.gather2d_hwc(view, iy, ix),
                           tg.gather2d_hwc(view.contiguous(), iy, ix))
    assert torch.equal(tsamp.gather_map(plane[..., 3], iy, ix),
                       tsamp.gather_map(plane[..., 3].contiguous(), iy, ix))


@pytest.mark.parametrize("n,ptrs,want", [
    (8, (0, 16, 4096), True),
    (6, (0, 16), False),                      # a row of queries not % 4
    (8, (0, 20), False),                      # a pointer off 16 bytes
    (0, (), True),
])
def test_index_vec(n, ptrs, want):
    assert tg.index_vec(n, *ptrs) is want


@pytest.mark.parametrize("row,img,s_h,s_w,out,unit", [
    (16, 0, 16 * 20, 16, 0, 16),              # C = 4 words
    (8, 0, 8 * 20, 8, 256, 8),                # C = 2 words
    (12, 0, 12 * 20, 12, 0, 4),               # C = 3 words
    (12, 0, 16 * 20, 16, 0, 4),               # plane[..., :3]
    (4, 12, 16 * 20, 16, 0, 4),               # plane[..., 3]
    (24, 0, 24 * 7, 24, 0, 8),                # C = 6 words
    (64, 0, 64 * 3, 64, 0, 16),               # C = 16 words
    (64, 4, 64 * 3, 64, 0, 4),                # image at a 4-byte offset
    (1, 0, 37, 1, 0, 1),                      # a bool map
    (2, 0, 2 * 37, 2, 0, 2),                  # C = 2 bytes
    (4, 0, 4 * 37, 4, 3, 1),                  # output at an odd address
    (16, 0, 0, 0, 0, 16),                     # H = W = 1 (no strides)
])
def test_hwc_plan_vector_width(row, img, s_h, s_w, out, unit):
    p = tg.hwc_plan(row, img, s_h, s_w, out, 8, 0, 0)
    assert (p.unit, p.upq, p.vec) == (unit, row // unit, True)
    assert not tg.hwc_plan(row, img, s_h, s_w, out, 10, 0, 0).vec


def test_tile_plan():
    p = tg.tile_plan(9600, 1600, 0, 0)
    assert p.vec and (p.tiles_x, p.tiles) == (13, 600 * 13)
    p = tg.tile_plan(4800, 800, 0, 16)
    assert p.vec and (p.tiles_x, p.tiles) == (7, 300 * 7)
    p = tg.tile_plan(5, 33, 0, 0)
    assert not p.vec and (p.tiles_x, p.tiles) == (1, 1)
    assert not tg.tile_plan(4, 32, 8, 0).vec                 # iy off 16 B
    assert not tg.tile_plan(4, 32, 0, 4).vec                 # ix off 16 B
    assert tg.tile_plan(17, 129, 0, 0).tiles == 2 * 2
    with pytest.raises(ValueError):
        tg.tile_plan(2 ** 31 * 16, 128, 0, 0)


def test_cpu_path_launches_nothing():
    tg.reset_launches()
    q = torch.zeros(4, 5, dtype=torch.int32)
    tsamp.gather_map(torch.zeros(6, 7, 3), q, q + 1)
    tg.gather2d(torch.zeros(2, 6, 7), q, q)
    tg.gather2d_pick(torch.zeros(2, 6, 7), q.long(), q, q)
    assert tg.LAUNCHES == {"gather2d": 0, "gather2d_hwc": 0,
                           "gather2d_pick": 0}


class _DeviceGuard:
    """Stands in for ``torch.cuda.device``: records the devices entered and
    which are current while a fake kernel library is called."""

    def __init__(self):
        self.entered, self.current, self.calls = [], [], []

    def __call__(self, device):
        guard = self

        class Ctx:
            def __enter__(self):
                guard.entered.append(device)
                guard.current.append(device)

            def __exit__(self, *exc):
                guard.current.pop()
        return Ctx()

    def library(self):
        guard = self

        class Lib:
            def __getattr__(self, name):
                def launch(*args):
                    guard.calls.append((name, list(guard.current)))
                    return 0
                return launch
        return Lib()


@pytest.mark.parametrize("entry", ["row_gather", "bilinear_x", "gather2d",
                                   "gather2d_hwc", "gather2d_pick"])
def test_launch_enters_the_tensors_device(entry, monkeypatch):
    """Every kernel launch runs with its tensors' card current (CUDA refuses
    a launch into a stream of a card that is not the current one): the
    guard, ``torch.cuda.device``, is mocked and the launch path driven with
    CPU tensors and a fake kernel library."""
    from dpe_mvs_tpu_torch.ops import rowgather as trg
    guard = _DeviceGuard()
    monkeypatch.setattr(torch.cuda, "device", guard)

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream)
    monkeypatch.setattr(tg, "_load", guard.library)
    monkeypatch.setattr(trg, "_load", guard.library)
    monkeypatch.setattr(trg, "_n_sm", lambda index: 132)
    check = tg._check

    def launch_on_cpu(*args):
        check(*args)                 # the wrapper's own checks still run
        return True
    monkeypatch.setattr(tg, "_check", launch_on_cpu)
    tg.reset_launches()
    trg.reset_launches()
    q = torch.zeros(4, 8, dtype=torch.int32)
    img = torch.zeros(2, 6, 7)
    if entry == "row_gather":
        trg._launch(entry, img[0], torch.zeros(6, 8, dtype=torch.int32))
    elif entry == "bilinear_x":
        trg._launch(entry, img[0], torch.zeros(6, 8))
    elif entry == "gather2d":
        tg.gather2d(img, q, q)
    elif entry == "gather2d_hwc":
        img = img.permute(1, 2, 0).contiguous()
        tg.gather2d_hwc(img, q, q)
    else:
        tg.gather2d_pick(img, q.long(), q, q)
    assert guard.entered == [img.device]
    assert guard.calls == [("dpe_" + entry, [img.device])]
    launches = {**tg.LAUNCHES, **trg.LAUNCHES}
    assert launches == {k: int(k == entry) for k in launches}


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


# The channel-first tiles: clustered and scattered queries, W % 4 != 0,
# scalar index I/O (Qw % 4 != 0), C in {1, 9, 17} (an odd C ends on one
# channel of a pair), row 4 of the TPU kernel table (a channel > 6 MB) and
# the anchor-profile shape of the 800x600 main path.
BRANCH_CASES = [
    # (C, H, W, Qh, Qw, clustered)
    (1, 200, 256, 64, 256, True),
    (9, 100, 132, 45, 260, True),
    (17, 70, 33, 129, 257, True),
    (9, 300, 400, 40, 384, False),
    (9, 960, 1024, 4800, 800, True),
    (9, 1920, 2048, 9600, 1600, True),
]


def _gpu_queries(rng, H, W, Qh, Qw, clustered):
    iy, ix = _queries(rng, H, W, Qh, Qw, clustered)
    return torch.from_numpy(iy).cuda(), torch.from_numpy(ix).cuda()


@gpu
@pytest.mark.parametrize("C,H,W,Qh,Qw,clustered", BRANCH_CASES)
def test_gpu_gather2d_branches_bit_exact(C, H, W, Qh, Qw, clustered):
    rng = np.random.default_rng(C * 7 + W)
    img = _to_torch(_image(rng, C, H, W, "u32")).cuda()
    iy, ix = _gpu_queries(rng, H, W, Qh, Qw, clustered)
    out = tg.gather2d(img, iy, ix)
    ref = tg.gather2d_ref(img, iy, ix)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def _off4(t):
    """A contiguous copy of t that starts 4 bytes (8 for 8-byte elements)
    past a 16-byte boundary."""
    n = t.numel() * t.element_size()
    o = max(4, t.element_size())
    flat = torch.empty(n + 16, dtype=torch.uint8, device=t.device)
    return flat[o:o + n].view(t.dtype).view(t.shape).copy_(t)


@gpu
def test_gpu_gather2d_misaligned_bit_exact():
    """Image and indices 4 bytes off 16: scalar index I/O."""
    rng = np.random.default_rng(12)
    img = _off4(_to_torch(_image(rng, 5, 64, 128, "f32")).cuda())
    iy, ix = (_off4(t) for t in _gpu_queries(rng, 64, 128, 33, 128, True))
    assert img.data_ptr() % 16 == 4 and iy.data_ptr() % 16 == 4
    out = tg.gather2d(img, iy, ix)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32),
                       tg.gather2d_ref(img, iy, ix).view(torch.int32))


def _hwc_cuda(rng, H, W, C, dtype):
    return torch.from_numpy(_hwc_image(rng, H, W, C, dtype)).cuda()


@gpu
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8, np.bool_])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 6, 16])
def test_gpu_gather2d_hwc_bit_exact(C, dtype, offset):
    rng = np.random.default_rng(C * 5 + np.dtype(dtype).itemsize)
    H, W = 131, 77
    img = _hwc_cuda(rng, H, W, C, dtype)
    iy, ix = _gpu_queries(rng, H, W, 37, 203, False)
    if offset:
        img, iy, ix = _off4(img), _off4(iy), _off4(ix)
    tg.reset_launches()
    out = tg.gather2d_hwc(img, iy, ix)
    torch.cuda.synchronize()
    assert tg.LAUNCHES["gather2d_hwc"] == 1
    ref = tg.gather2d_hwc_ref(img, iy, ix)
    assert out.shape == (37, 203, C) and out.dtype == img.dtype
    assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))


@gpu
def test_gpu_gather2d_hwc_views_bit_exact():
    """Strided views read in place (plane[..., :3], plane[..., 3]), int64 and
    float16 elements, the main path's 480k queries, an index row of 4."""
    rng = np.random.default_rng(21)
    plane = torch.from_numpy(rng.standard_normal((600, 800, 4)).astype(
        np.float32)).cuda()
    iy, ix = _gpu_queries(rng, 600, 800, 600, 800, True)
    cases = [plane[..., :3], plane[..., 3:], plane[:, 3:700],
             plane.to(torch.int64), plane[..., :2].to(torch.float16)]
    for img in cases:
        out = tg.gather2d_hwc(img, iy, ix)
        torch.cuda.synchronize()
        assert torch.equal(out, tg.gather2d_hwc_ref(img, iy, ix))
    edge = plane[..., 0] > 0.5
    q = (iy[:1, :4].contiguous(), ix[:1, :4].contiguous())
    for args in [(edge, iy, ix), (edge, *q)]:
        out = tsamp.gather_map(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, tg.gather2d_hwc_ref(args[0][..., None],
                                                    *args[1:])[..., 0])


@gpu
@pytest.mark.parametrize("C,H,W,S", [
    (16, 300, 400, (600, 800)),
    (16, 30, 41, (8, 6, 9)),
    (3, 17, 29, (1001,)),
    (1, 5, 5, (3,)),
])
def test_gpu_gather2d_pick_bit_exact(C, H, W, S):
    """One channel per query, channels and positions out of range (channels
    beyond 32 bits) included, word and vector index I/O."""
    rng = np.random.default_rng(C + W)
    imgs = _to_torch(_image(rng, C, H, W, "u32")).cuda()
    ic = rng.integers(-2, C + 2, S).astype(np.int64)
    ic.reshape(-1)[::7] = 2**40
    ic.reshape(-1)[3::7] = -2**40
    ic = torch.from_numpy(ic).cuda()
    iy = torch.from_numpy(rng.integers(-3, H + 3, S).astype(np.int32)).cuda()
    ix = torch.from_numpy(rng.integers(-3, W + 3, S).astype(np.int32)).cuda()
    for args in [(ic, iy, ix), tuple(_off4(t) for t in (ic, iy, ix))]:
        tg.reset_launches()
        out = tg.gather2d_pick(imgs, *args)
        torch.cuda.synchronize()
        assert tg.LAUNCHES["gather2d_pick"] == 1
        assert torch.equal(out.view(torch.int32),
                           tg.gather2d_pick_ref(imgs, *args).view(
                               torch.int32))


@gpu
def test_gpu_wrapper_rejects_bad_input():
    img = torch.zeros(2, 4, 8, device="cuda")
    q = torch.zeros(3, 10, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):           # not contiguous
        tg.gather2d(img, q[:, ::2], q[:, ::2])
    with pytest.raises(ValueError):           # devices differ
        tg.gather2d(img, q.cpu(), q)
    with pytest.raises(ValueError):           # channels not contiguous
        tg.gather2d_hwc(img.permute(1, 2, 0), q, q)
    with pytest.raises(ValueError):
        tg.gather2d_pick(img.permute(0, 2, 1), q.long(), q, q)
    tg.reset_launches()
    tsamp.gather_map(img.permute(1, 2, 0), q, q)
    tg.gather2d(img, q, q)
    tg.gather2d_pick(img, q.long(), q, q)
    assert tg.LAUNCHES == {"gather2d": 1, "gather2d_hwc": 1,
                           "gather2d_pick": 1}


@gpu
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_gpu_gather_map_permuted_channels_bit_exact(dtype):
    """gather_map of views whose channels are not contiguous (a channel-first
    array moved last, every other channel) equals the plain gather of their
    contiguous copies, bit for bit."""
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    chw = torch.from_numpy(_hwc_image(rng, 5, 97, 61, dtype)).cuda()
    hw32 = torch.from_numpy(_hwc_image(rng, 97, 61, 6, dtype)).cuda()
    iy, ix = _gpu_queries(rng, 97, 61, 23, 41, False)
    for view in (chw.permute(1, 2, 0), hw32[..., ::2]):
        assert view.stride(-1) != 1
        tg.reset_launches()
        out = tsamp.gather_map(view, iy, ix)
        torch.cuda.synchronize()
        assert tg.LAUNCHES["gather2d_hwc"] == 1
        flat = view.contiguous().reshape(97, 61, -1)
        ref = tg.gather2d_hwc_ref(flat, iy, ix).reshape(out.shape)
        assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))
