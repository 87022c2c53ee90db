// Row-local gathers for Hopper (sm_90a): the texture unit of the rectified
// cost engine.
//
//   dpe_row_gather  replaces dpe_mvs_tpu/ops/rowgather.py _row_gather_kernel
//                   (entry row_gather):  out[h, l] = img[h, clamp(ix[h, l], 0, W-1)]
//   dpe_bilinear_x  replaces dpe_mvs_tpu/ops/rowgather.py _bilinear_x_kernel
//                   (entry bilinear_x):  linear interpolation along the row at a
//                   float column, clamp addressing.
//
// What bounds them on this card: bytes. A row_gather output costs 12 B of
// device traffic (4 B index read, 4 B store, a 4 B row word that neighbouring
// outputs share) and a bilinear_x output 12-16 B; the arithmetic is a few
// clamps and a lerp. So the design is about keeping enough bytes in flight
// and reading each byte once:
//
// - 16-byte vectors. Index / x reads and output stores move as uint4; a thread
//   handles kVecs vectors per pass (16 outputs), issuing all index loads
//   before the first gather and all gathers before the first store, so each
//   thread keeps 64 B of index reads and then 16 row reads in flight (about
//   64 KB per SM at 4 blocks of 256 threads, where HBM's latency needs
//   15-20 KB). Index reads are streamed (evict-first) so that they do not push
//   the row words out of L2. Where the index and output rows are not 16-byte
//   aligned (L % 4 != 0, or a pointer off 16 bytes) the same passes move
//   single words (scalar path of the same kernels).
// - Two ways to read the rows, chosen per launch by the plan
//   (ops/rowgather.py launch_plan) by shape class, from timings of both on
//   the main path's shapes (PERF.md):
//   * unstaged (rowgather_flat), where a row word feeds few outputs
//     (L < W): the row words are read through the read-only path (__ldg),
//     so only the sectors that the indices touch move; a grid of resident
//     blocks strides over passes.
//   * staged (rowgather_staged), where L >= W: a block owns one image row
//     at a time and all of its L outputs. One thread copies the row into
//     shared memory with one 1-D bulk asynchronous copy (TMA's 1-D form,
//     cp.async.bulk ... mbarrier::complete_tx) that completes on an
//     mbarrier; it is issued for the block's next row while this one
//     gathers (two buffers), and the row's index loads are issued before
//     the wait, so index reads, the copy and the previous row's gathers
//     overlap. Gathers then read shared memory. A persistent grid walks the
//     rows. The bulk copy needs 16-byte aligned rows: where W % 4 != 0, the
//     image is off 16 bytes, or the two buffers and their barriers exceed
//     the 48 KB of dynamic shared memory a launch gets without opting in,
//     the plan takes the unstaged kernel.
//
// Bit-exactness: row_gather moves 32-bit words and never treats them as
// floats (NaN payloads survive). bilinear_x is bit-identical to the plain
// PyTorch version (rowgather.bilinear_x_ref) and to the JAX fast path
// evaluated op by op: the lerp is written with __fmul_rn / __fadd_rn so nvcc
// cannot contract it into an FMA, in the order g0 * (1 - f) + g1 * f.
//
// Rows are the flattened leading axes (callers stack views and channels on the
// row axis), so row and element offsets are 64-bit and the grids are 1-D
// (no grid.y limit on H).
//
// The TPU kernels loop over 128-lane blocks of the source row because Mosaic's
// gather is an in-vreg lane shuffle; a Hopper thread addresses the row
// directly, so that loop has no counterpart here.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kVecs = 4;        // 16-byte vectors per thread per pass
constexpr int kBlocksPerSM = 4; // residency the plan's grid assumes

struct Args {
  const uint32_t* img;   // (H, W) 32-bit words
  const uint32_t* idx;   // (H, L) int32 indices or float32 columns, as words
  uint32_t* out;         // (H, L)
  int64_t H;
  int32_t W;
  int32_t L;
};

// ---------------------------------------------------------------------------
// The two operations, on 32-bit words, reading row words through Row.
// ---------------------------------------------------------------------------

struct GlobalRow {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator[](int32_t i) const {
    return __ldg(p + i);
  }
};

struct SharedRow {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator[](int32_t i) const {
    return p[i];
  }
};

struct Nearest {
  template <class Row>
  __device__ __forceinline__ static uint32_t eval(uint32_t q, Row row,
                                                  int32_t W) {
    int32_t i = (int32_t)q;
    i = i < 0 ? 0 : (i > W - 1 ? W - 1 : i);
    return row[i];
  }
};

struct Lerp {
  template <class Row>
  __device__ __forceinline__ static uint32_t eval(uint32_t q, Row row,
                                                  int32_t W) {
    const float wmax = (float)(W - 1);
    const float x0max = (float)(W - 2);
    float xc = __uint_as_float(q);
    xc = xc < 0.0f ? 0.0f : xc;
    xc = xc > wmax ? wmax : xc;
    float x0 = 0.0f;
    if (W > 1) {
      x0 = floorf(xc);
      x0 = x0 < 0.0f ? 0.0f : x0;
      x0 = x0 > x0max ? x0max : x0;
    }
    const float f = __fsub_rn(xc, x0);
    int32_t i0 = (int32_t)x0;
    // Memory safety for non-finite x (callers pass finite columns).
    i0 = i0 < 0 ? 0 : (i0 > W - 1 ? W - 1 : i0);
    const int32_t i1 = i0 + 1 > W - 1 ? W - 1 : i0 + 1;
    const float g0 = __uint_as_float(row[i0]);
    const float g1 = __uint_as_float(row[i1]);
    return __float_as_uint(
        __fadd_rn(__fmul_rn(g0, __fsub_rn(1.0f, f)), __fmul_rn(g1, f)));
  }
};

template <class Op, class Row>
__device__ __forceinline__ uint4 apply(uint4 q, Row row, int32_t W) {
  return make_uint4(Op::eval(q.x, row, W), Op::eval(q.y, row, W),
                    Op::eval(q.z, row, W), Op::eval(q.w, row, W));
}

template <class Op, class Row>
__device__ __forceinline__ uint32_t apply(uint32_t q, Row row, int32_t W) {
  return Op::eval(q, row, W);
}

// Row of a unit (vector or word) u, with n units per row: 32-bit division
// when u fits, which is every launch below 2^32 units.
__device__ __forceinline__ int64_t row_of(int64_t u, int64_t n) {
  return ((uint64_t)u >> 32) == 0 ? (int64_t)((uint32_t)u / (uint32_t)n)
                                  : u / n;
}

// Row accessors: rows of the image in device memory, or the one staged row.
struct GlobalRows {
  const uint32_t* img;
  int32_t W;
  __device__ __forceinline__ GlobalRow operator()(int64_t r) const {
    return GlobalRow{img + r * (int64_t)W};
  }
};

struct SharedRows {
  const uint32_t* buf;
  __device__ __forceinline__ SharedRow operator()(int64_t) const {
    return SharedRow{buf};
  }
};

// ---------------------------------------------------------------------------
// mbarrier and 1-D bulk copy (PTX).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

// A copy that never lands (a fault elsewhere) traps after ~2 s instead of
// hanging the card.
constexpr long long kWaitTrapCycles = 4000000000LL;

struct BarrierWait {
  uint32_t bar;
  uint32_t parity;
  __device__ __forceinline__ void operator()() const {
    if (mbar_try_wait(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(bar, parity)) {
      if (clock64() - t0 > kWaitTrapCycles) __trap();
    }
  }
};

// ---------------------------------------------------------------------------
// One block's passes over a span of the flattened (rows, L) index and output
// arrays that starts at a row boundary. Unit = uint4 (vector path) or one
// word (scalar path); a pass covers kThreads * kPer units of the span, and
// this block takes passes first, first + step, ... Within a pass: all index
// loads, then ready() (the staged row's copy), then all gathers, then all
// stores.
// ---------------------------------------------------------------------------

template <class Op, class Unit, class Rows, class Ready>
__device__ __forceinline__ void sweep_span(const uint32_t* idx, uint32_t* out,
                                           int64_t n_units, int64_t row_units,
                                           int32_t W, int64_t first,
                                           int64_t step, Rows rows,
                                           Ready ready) {
  constexpr int kPer = sizeof(Unit) == 16 ? kVecs : 4 * kVecs;
  constexpr int64_t kPass = (int64_t)kThreads * kPer;
  const Unit* idx_u = reinterpret_cast<const Unit*>(idx);
  Unit* out_u = reinterpret_cast<Unit*>(out);
  for (int64_t u0 = first * kPass; u0 < n_units; u0 += step * kPass) {
    Unit q[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t u = u0 + k * kThreads + threadIdx.x;
      if (u < n_units) q[k] = __ldcs(idx_u + u);
    }
    ready();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t u = u0 + k * kThreads + threadIdx.x;
      if (u < n_units) q[k] = apply<Op>(q[k], rows(row_of(u, row_units)), W);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t u = u0 + k * kThreads + threadIdx.x;
      if (u < n_units) out_u[u] = q[k];
    }
  }
}

// Unstaged: the whole (H, L) array as one span, grid-stride over passes; row
// words through __ldg.
template <class Op, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    rowgather_flat(Args a) {
  const GlobalRows rows{a.img, a.W};
  const int64_t n = a.H * (int64_t)a.L;
  if constexpr (kVec) {
    sweep_span<Op, uint4>(a.idx, a.out, n / 4, a.L / 4, a.W, blockIdx.x,
                          gridDim.x, rows, NoWait{});
  } else {
    sweep_span<Op, uint32_t>(a.idx, a.out, n, a.L, a.W, blockIdx.x,
                             gridDim.x, rows, NoWait{});
  }
}

// Thread 0 only: arm the barrier at bar for row h and start the row's bulk
// copy into the shared buffer at dst.
__device__ __forceinline__ void issue_row(const Args& a, int64_t h,
                                          uint32_t dst, uint32_t bar) {
  const uint32_t bytes = (uint32_t)a.W * 4;
  mbar_arrive_expect_tx(bar, bytes);
  bulk_copy_g2s(dst, a.img + h * a.W, bytes, bar);
}

// Staged: persistent blocks over the image rows. Dynamic shared memory holds
// the two barriers (16 bytes) and then two row buffers of W words; the plan
// counts all of it, and the kernel has no static shared memory.
template <class Op, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    rowgather_staged(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  if ((int64_t)blockIdx.x >= a.H) return;
  // Barrier b at bar0 + 8 b, buffer b at stage0 + 4 W b: addressed by
  // arithmetic, so no run-time indexed array lands in local memory.
  const uint32_t bar0 = smem_u32(smem);
  const uint32_t stage0 = bar0 + 16;
  const uint32_t* stage = smem + 4;

  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) issue_row(a, blockIdx.x, stage0, bar0);
  int it = 0;
  for (int64_t h = blockIdx.x; h < a.H; h += gridDim.x, ++it) {
    const int b = it & 1;
    const uint32_t* idx = a.idx + h * a.L;
    uint32_t* out = a.out + h * a.L;
    const SharedRows rows{stage + b * a.W};
    // Buffer b^1 was released by the __syncthreads that ended row h - grid.
    if (threadIdx.x == 0 && h + gridDim.x < a.H)
      issue_row(a, h + gridDim.x, stage0 + (b ^ 1) * a.W * 4,
                bar0 + (b ^ 1) * 8);
    const BarrierWait ready{bar0 + b * 8, (uint32_t)((it >> 1) & 1)};
    if constexpr (kVec) {
      sweep_span<Op, uint4>(idx, out, a.L / 4, a.L / 4, a.W, 0, 1, rows,
                            ready);
    } else {
      sweep_span<Op, uint32_t>(idx, out, a.L, a.L, a.W, 0, 1, rows, ready);
    }
    __syncthreads();
  }
}

template <class Op>
int launch(const void* img, const void* idx, void* out, int64_t H, int32_t W,
           int32_t L, int32_t vec, int32_t staged, int32_t grid, int32_t smem,
           void* stream) {
  if (H <= 0 || L <= 0) return 0;
  const Args a{(const uint32_t*)img, (const uint32_t*)idx, (uint32_t*)out,
               H, W, L};
  const cudaStream_t s = (cudaStream_t)stream;
  if (staged) {
    if (vec)
      rowgather_staged<Op, true><<<grid, kThreads, smem, s>>>(a);
    else
      rowgather_staged<Op, false><<<grid, kThreads, smem, s>>>(a);
  } else {
    if (vec)
      rowgather_flat<Op, true><<<grid, kThreads, 0, s>>>(a);
    else
      rowgather_flat<Op, false><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The plan arguments (vec, staged, grid, smem) come from
// dpe_mvs_tpu_torch/ops/rowgather.py launch_plan, which checks the alignment
// and budget conditions each of them relies on.
extern "C" int dpe_row_gather(const void* img, const void* ix, void* out,
                              int64_t H, int32_t W, int32_t L, int32_t vec,
                              int32_t staged, int32_t grid, int32_t smem,
                              void* stream) {
  return launch<Nearest>(img, ix, out, H, W, L, vec, staged, grid, smem,
                         stream);
}

extern "C" int dpe_bilinear_x(const void* img, const void* x, void* out,
                              int64_t H, int32_t W, int32_t L, int32_t vec,
                              int32_t staged, int32_t grid, int32_t smem,
                              void* stream) {
  return launch<Lerp>(img, x, out, H, W, L, vec, staged, grid, smem, stream);
}
