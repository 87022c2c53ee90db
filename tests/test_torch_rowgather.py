"""Row-gather kernels of the PyTorch port against the JAX package.

CPU: the plain versions (``row_gather_ref``, ``bilinear_x_ref``, which the
wrappers take for CPU tensors) against JAX ``row_gather`` / ``bilinear_x`` on
its CPU fast path and in Pallas interpret mode. row_gather is exact.
bilinear_x is exact against the JAX math evaluated op by op; compiled, XLA
on the CPU contracts ``g0 * (1 - f) + g1 * f`` into a fused multiply-add, so
there the two agree to one float32 rounding of the lerp (rtol 1e-6).

CPU also: the launch plan (``launch_plan``), which decides the vector
flag, staged or unstaged rows, the shared memory and the persistent grid.

GPU (marked ``gpu``, skipped without a CUDA device): the CUDA kernels
against the plain versions, bit-exact, at ragged shapes, at shapes of the
800x600 main path and in every branch of the plan (vector and word I/O,
rows staged by bulk copy or read through __ldg); the wrappers' input checks
and launch counters.
"""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from dpe_mvs_tpu_torch.ops import rowgather as trg


def gpu(fn):
    """Mark a test for the GPU tier; it skips where torch sees no card."""
    skip = pytest.mark.skipif("not torch.cuda.is_available()",
                              reason="needs a CUDA device")
    return pytest.mark.gpu(skip(fn))


def _jax_rg():
    from dpe_mvs_tpu.ops import rowgather
    return rowgather


def _inputs(seed, H, W, L, dtype=np.float32):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    if dtype == np.int32:
        img = rng.integers(-2**31, 2**31 - 1, (H, W), dtype=np.int64) \
            .astype(np.int32)
    x = rng.uniform(-7.0, W + 7.0, (H, L)).astype(np.float32)
    ix = rng.integers(-40, W + 40, (H, L)).astype(np.int32)
    return img, x, ix


SHAPES = [(1, 1, 5), (5, 1, 17), (8, 2, 3), (19, 37, 130), (64, 200, 500)]


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("H,W,L", SHAPES)
def test_row_gather_exact(H, W, L, dtype):
    import jax.numpy as jnp
    rg = _jax_rg()
    img, _, ix = _inputs(H * 7 + W, H, W, L, dtype)
    ours = trg.row_gather(torch.from_numpy(img), torch.from_numpy(ix)).numpy()
    assert ours.dtype == img.dtype
    fast = np.asarray(rg.row_gather(jnp.asarray(img), jnp.asarray(ix)))
    np.testing.assert_array_equal(ours, fast)
    interp = np.asarray(rg.row_gather(jnp.asarray(img), jnp.asarray(ix),
                                      interpret=True))
    np.testing.assert_array_equal(ours, interp)


def test_row_gather_uint32_view():
    img = np.arange(40, dtype=np.uint32).reshape(4, 10) * np.uint32(2**28)
    ix = np.array([[0, 9, 12, -3]] * 4, np.int32)
    out = trg.row_gather(torch.from_numpy(img), torch.from_numpy(ix))
    assert out.dtype == torch.uint32
    np.testing.assert_array_equal(
        out.numpy(), np.take_along_axis(img, np.clip(ix, 0, 9), axis=1))


@pytest.mark.parametrize("H,W,L", SHAPES)
def test_bilinear_x(H, W, L):
    import jax
    import jax.numpy as jnp
    rg = _jax_rg()
    img, x, _ = _inputs(H * 11 + W, H, W, L)
    # Integral and boundary columns hit the clamps and the W-2 floor.
    k = min(3, L)
    x[:, :k] = np.array([0.0, W - 1.0, max(W - 2.0, 0.0)], np.float32)[:k]
    ours = trg.bilinear_x(torch.from_numpy(img), torch.from_numpy(x)).numpy()
    with jax.disable_jit():
        opwise = np.asarray(rg.bilinear_x(jnp.asarray(img), jnp.asarray(x)))
    np.testing.assert_array_equal(ours, opwise)
    fast = np.asarray(rg.bilinear_x(jnp.asarray(img), jnp.asarray(x)))
    np.testing.assert_allclose(ours, fast, rtol=1e-6, atol=0)
    interp = np.asarray(rg.bilinear_x(jnp.asarray(img), jnp.asarray(x),
                                      interpret=True))
    np.testing.assert_allclose(ours, interp, rtol=1e-6, atol=0)


def test_wrapper_rejects_bad_input():
    img = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        trg.row_gather(img, torch.zeros(4, 3, dtype=torch.int64))
    with pytest.raises(TypeError):
        trg.bilinear_x(img.to(torch.int32), torch.zeros(4, 3))
    with pytest.raises(ValueError):
        trg.bilinear_x(img, torch.zeros(5, 3))
    with pytest.raises(TypeError):
        trg.row_gather(img.to(torch.float64), torch.zeros(4, 3,
                                                          dtype=torch.int32))


def test_cpu_path_launches_nothing():
    trg.reset_launches()
    img, x, ix = _inputs(0, 6, 9, 11)
    trg.bilinear_x(torch.from_numpy(img), torch.from_numpy(x))
    trg.row_gather(torch.from_numpy(img), torch.from_numpy(ix))
    assert trg.LAUNCHES == {"row_gather": 0, "bilinear_x": 0}


# --------------------------------------------------------------------------
# Launch plan (pure Python)
# --------------------------------------------------------------------------

N_SM = 132
A16 = 1 << 20                     # a 16-byte aligned address


@pytest.mark.parametrize("L", [480, 481, 482, 483])
@pytest.mark.parametrize("idx_off,out_off", [(0, 0), (4, 0), (0, 8)])
def test_plan_vector_flag(L, idx_off, out_off):
    p = trg.launch_plan(96, 800, L, A16, A16 + idx_off, A16 + out_off, N_SM)
    assert p.vec == (L % 4 == 0 and idx_off == 0 and out_off == 0)


# The widest rows that two buffers and the barriers fit into the 48 KB a
# launch gets without opting in, and the next rows of 16 bytes.
W_STAGE_MAX = (48 * 1024 - 16) // 8 // 4 * 4          # 6140
W_STAGE_OVER = W_STAGE_MAX + 4                         # 6144


@pytest.mark.parametrize("W", [1, 3, 800, 1024, W_STAGE_MAX, W_STAGE_OVER,
                               70001])
@pytest.mark.parametrize("img_off", [0, 4])
def test_plan_stage_budget(W, img_off):
    """Staged only where the bulk copy can move the rows: 16-byte rows
    (W % 4 == 0), a 16-byte aligned image, and the block's whole shared
    memory (two row buffers and two 8-byte mbarriers) within 48 KB."""
    H, L = 960, 8192
    p = trg.launch_plan(H, W, L, A16 + img_off, A16, A16, N_SM, staged=True)
    assert p.staged == (W % 4 == 0 and img_off == 0 and W <= W_STAGE_MAX)
    if not p.staged:
        assert p.smem == 0
        return
    assert p.smem == 2 * W * 4 + 2 * 8 <= 48 * 1024
    # Never more blocks than rows, never more than the resident slots.
    assert 1 <= p.grid <= min(H, N_SM * trg.BLOCKS_PER_SM)


def test_plan_shape_class_choice():
    # A row word feeding >= STAGE_MIN_REUSE outputs is staged by default.
    r = trg.STAGE_MIN_REUSE
    assert trg.launch_plan(960, 1024, 1024 * r, A16, A16, A16, N_SM).staged
    assert not trg.launch_plan(960, 1024, 1024 * r - 4, A16, A16, A16,
                               N_SM).staged
    for staged in (False, True):
        assert trg.launch_plan(960, 1024, 8192, A16, A16, A16, N_SM,
                               staged=staged).staged == staged


@pytest.mark.parametrize("H", [65535, 65536, 70001, 2 ** 31 + 5])
@pytest.mark.parametrize("staged", [False, True])
def test_plan_persistent_grid_tall(H, staged):
    """H > 65535 rides a 1-D persistent grid: the block count stays at the
    resident slots however tall the array, and the blocks' passes or rows
    cover every row."""
    W, L = 8, 8
    p = trg.launch_plan(H, W, L, A16, A16, A16, N_SM, staged=staged)
    slots = N_SM * trg.BLOCKS_PER_SM
    assert p.staged == staged
    if staged:
        assert p.grid == min(slots, H)
        assert p.grid * -(-H // p.grid) >= H
    else:
        passes = -(-(H * L) // trg.PASS_ELEMS)
        assert p.grid == min(slots, passes)
        assert p.grid * -(-passes // p.grid) * trg.PASS_ELEMS >= H * L


def test_plan_small_launch_grid():
    p = trg.launch_plan(3, 5, 7, A16, A16, A16, N_SM, staged=False)
    assert (p.vec, p.staged, p.grid) == (False, False, 1)
    p = trg.launch_plan(3, 8, 7, A16, A16, A16, N_SM, staged=True)
    assert (p.vec, p.staged, p.grid, p.smem) == (False, True, 3, 80)


@pytest.mark.parametrize("H", [960, 2400, 7200, 70001])
def test_plan_stage_rows(H):
    """A staged block holds one image row per buffer, whatever H: the
    shared memory does not grow with H, and the grid takes one block per
    row up to the resident slots."""
    p = trg.launch_plan(H, 800, 8192, A16, A16, A16, N_SM, staged=True)
    assert p.staged
    assert p.smem == 16 + 2 * 800 * 4
    assert p.grid == min(H, N_SM * trg.BLOCKS_PER_SM)


# --------------------------------------------------------------------------
# GPU tier
# --------------------------------------------------------------------------

# Ragged shapes plus shapes the 800x600x6 main path gives the kernels: the
# signatures that carried the most bilinear_x and row_gather traffic in a
# chip_smoke.py run, and a classify probe chunk (8 probes x 6 offsets x 512
# centers per rect row).
GPU_SHAPES = SHAPES + [(70001, 9, 3), (2400, 1024, 3072), (480, 1024, 24576),
                       (7200, 800, 480)]


@gpu
@pytest.mark.parametrize("H,W,L", GPU_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gpu_row_gather_bit_exact(H, W, L, dtype):
    img, _, ix = _inputs(H + W + L, H, W, L, dtype)
    img_t, ix_t = torch.from_numpy(img).cuda(), torch.from_numpy(ix).cuda()
    trg.reset_launches()
    out = trg.row_gather(img_t, ix_t)
    torch.cuda.synchronize()
    assert trg.LAUNCHES["row_gather"] == 1
    assert torch.equal(out, trg.row_gather_ref(img_t, ix_t))


@gpu
@pytest.mark.parametrize("H,W,L", GPU_SHAPES)
def test_gpu_bilinear_x_bit_exact(H, W, L):
    img, x, _ = _inputs(H + W + L, H, W, L)
    img_t, x_t = torch.from_numpy(img).cuda(), torch.from_numpy(x).cuda()
    trg.reset_launches()
    out = trg.bilinear_x(img_t, x_t)
    torch.cuda.synchronize()
    assert trg.LAUNCHES["bilinear_x"] == 1
    assert torch.equal(out, trg.bilinear_x_ref(img_t, x_t))


@gpu
def test_gpu_wrapper_rejects_bad_input():
    img = torch.zeros(4, 8, device="cuda")
    ix = torch.zeros(4, 16, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):           # not contiguous
        trg.row_gather(img, ix[:, ::2])
    with pytest.raises(ValueError):           # devices differ
        trg.row_gather(img, ix.cpu())
    with pytest.raises(TypeError):
        trg.bilinear_x(img.to(torch.float64), torch.zeros(4, 3,
                                                          device="cuda"))
    trg.reset_launches()
    trg.bilinear_x(img, torch.zeros(4, 3, device="cuda"))
    trg.row_gather(img, ix)
    trg.row_gather(img, ix)
    assert trg.LAUNCHES == {"row_gather": 2, "bilinear_x": 1}


def _words(a):
    return a.view(torch.int32)


def _gpu_case(seed, H, W, L, x_lo=-7.0, x_hi=None):
    """uint32 image words with quiet-NaN payloads in every third column,
    float32 rows for the lerp, columns with +-inf and huge values."""
    img, x, ix = _inputs(seed, H, W, L)
    rng = np.random.default_rng(seed + 1)
    words = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64) \
        .astype(np.uint32)
    words[:, ::3] = 0x7FC00001
    x.ravel()[::5] = np.inf
    x.ravel()[1::7] = -np.inf
    x.ravel()[2::11] = 1e30
    return (torch.from_numpy(words).cuda(), torch.from_numpy(img).cuda(),
            torch.from_numpy(x).cuda(), torch.from_numpy(ix).cuda())


def _check_both(words, img, x, ix, staged):
    """Both kernels bit-exact in the plan's variant (``staged`` None, through
    the public wrappers) or the one ``staged`` asks for."""
    if staged is None:
        got = trg.row_gather(words, ix)
    else:
        got = trg._launch("row_gather", words, ix, staged)
    assert got.dtype == torch.uint32
    assert torch.equal(_words(got), _words(trg.row_gather_ref(
        words.view(torch.int32), ix)))
    if staged is None:
        got = trg.bilinear_x(img, x)
    else:
        got = trg._launch("bilinear_x", img, x, staged)
    torch.cuda.synchronize()
    assert torch.equal(_words(got), _words(trg.bilinear_x_ref(img, x)))


@gpu
@pytest.mark.parametrize("staged", [None, False, True])
@pytest.mark.parametrize("L", [37, 64])
@pytest.mark.parametrize("W", [1, 2, 3, 800, 1024, 70001])
def test_gpu_plan_branches_bit_exact(W, L, staged):
    """Every branch of the plan: word I/O (L = 37) and vector I/O (L = 64);
    rows staged by bulk copy (W % 4 == 0) or read through __ldg (unstaged;
    W % 4 != 0; W = 70001 beyond the stage budget)."""
    H = 5 if W == 70001 else 33
    _check_both(*_gpu_case(W + L, H, W, L), staged)


@gpu
@pytest.mark.parametrize("staged", [None, False, True])
def test_gpu_misaligned_slices_bit_exact(staged):
    """Contiguous inputs at a 4-byte (not 16-byte) offset: word I/O, rows
    read through __ldg whatever ``staged`` asks."""
    H, W, L = 40, 1024, 2048
    words, img, x, ix = _gpu_case(5, H + 1, W, L)
    sl = [t.reshape(-1)[1:1 + H * n].view(H, n)
          for t, n in ((words, W), (img, W), (x, L), (ix, L))]
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 4 for t in sl)
    _check_both(*sl, staged)


@gpu
@pytest.mark.parametrize("staged", [False, True])
def test_gpu_tall_bit_exact(staged):
    """H = 70001 > 65535 with vector I/O and bulk-copied tiles."""
    _check_both(*_gpu_case(3, 70001, 8, 8), staged)


@gpu
@pytest.mark.parametrize("staged", [None, False, True])
@pytest.mark.parametrize("H,W,L", [(3, W_STAGE_MAX, 2 * W_STAGE_MAX),
                                   (3, W_STAGE_OVER, 2 * W_STAGE_OVER),
                                   (12672, 1024, 2048)])
def test_gpu_stage_budget_bit_exact(H, W, L, staged):
    """The largest staged block (W = 6140: 48 KB of shared memory with the
    barriers), the first row too wide to stage (W = 6144), and a tall staged
    launch at the main path's width."""
    words, img, x, ix = _gpu_case(W + H, H, W, L)
    p = trg.launch_plan(H, W, L, img.data_ptr(), x.data_ptr(), 0,
                        trg._n_sm(img.device.index), staged)
    assert p.staged == (staged is not False and W <= W_STAGE_MAX)
    _check_both(words, img, x, ix, staged)
