// Scattered 2-D point gathers for Hopper (sm_90a): the anchor reads of the
// weak-texture machinery and the line-of-sight lookups.
//
//   dpe_gather2d       channel-first, the JAX signature; replaces
//                      dpe_mvs_tpu/ops/gather2d.py _gather2d_vmem_kernel (entry
//                      gather2d, a channel <= 6 MB) and _gather2d_kernel (entry
//                      _gather2d_hbm, a channel > 6 MB):
//                      out[c, i, j] = img[c, clamp(iy[i, j]), clamp(ix[i, j])]
//   dpe_gather2d_hwc   channel-last, what dpe_mvs_tpu/ops/sampling.py
//                      gather_map feeds those kernels after moving channels
//                      first and widening narrow types to 32 bits:
//                      out[q, :] = img[clamp(iy[q]), clamp(ix[q]), :]
//   dpe_gather2d_pick  one channel per query, what
//                      dpe_mvs_tpu/ops/support.py LineOfSight.crossing computes
//                      with those kernels and a pick along the channel axis:
//                      out[q] = img[clamp(ic[q]), clamp(iy[q]), clamp(ix[q])]
//
// The TPU kernels walk the row/column band of each (16, 128) query tile block
// by block, because Mosaic's gather is an in-register lane shuffle; the second
// one DMAs 64x512 windows of the band into VMEM first, because the image does
// not fit there. Channels go first and narrow types are widened because
// Pallas wants 32-bit (8, 128) tiles. A Hopper thread addresses the image
// directly, one query's channels are contiguous in a channel-last array, and
// a byte moves as a byte, so those layout steps have no counterpart here.
//
// What bounds all three: bytes. Per query they read its 4-byte indices and
// the image bytes it touches and write its output bytes; the arithmetic is a
// few clamps. The design:
//
// - dpe_gather2d: a block owns a tile of 16 query rows x 128 columns, the
//   counterpart of the TPU's (16, 128) tile; each thread holds 4 consecutive
//   queries of two rows and loads their indices as 16-byte vectors (streamed,
//   evict-first) where the query rows allow it. Indices are read once for all
//   channels. Image words come through the read-only path (__ldg), two
//   channels' 16 loads issued before their stores (one channel's 8 with word
//   I/O); a tile's clustered queries reuse image sectors through L1. Outputs
//   are written with streaming stores, 16 bytes at a time where the query
//   rows allow it, so they do not push image rows out of L2. Staging each
//   tile's image box in shared memory (the counterpart of the TPU's window
//   walk) was measured on an H100 and lost to these plain reads (PERF.md).
// - dpe_gather2d_hwc: a block owns 1024 queries. Its threads load the indices
//   (16-byte vectors where possible), clamp them and leave each query's byte
//   offset in shared memory; then consecutive threads move consecutive units
//   of the output, a unit being the widest of 16, 8, 4, 2 or 1 bytes that
//   divides a query's row of channels and that the image's address and
//   strides and the output's address allow (the wrapper's hwc_plan). Any
//   element size works (bool and uint8 maps move as bytes); the image may have
//   any row and pixel strides as long as each pixel's channels are
//   contiguous, so slices such as plane[..., :3] are read in place.
// - dpe_gather2d_pick: a thread per 4 queries, 16-byte index loads and
//   stores where possible, one image word per query: 1/C of the bytes of a
//   gather of every channel followed by a pick. Channel indices are int64,
//   what argmin gives the line-of-sight test, clamped before they narrow.
//
// The kernels move bits and never do float arithmetic on them, so float32
// payloads (NaN patterns included), int32 and uint32 words, bool and uint8
// maps, and pairs of bf16 values packed into one word all come out bit for
// bit. Image plane offsets (y * W + x, H * W < 2^31, which the wrappers check)
// are 32-bit; channel, output and byte offsets are 64-bit: at full ETH3D size
// 8 * H * W queries x C channels nears 2^31 elements.
//
// They launch on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// dpe_gather2d tiles: 32 lanes x 4 queries wide, kWarps rows per pass.
constexpr int kTileCols = 128;
constexpr int kPasses = 2;
constexpr int kTileRows = kWarps * kPasses;   // 16
constexpr int kPer = 4 * kPasses;             // queries per thread
// dpe_gather2d_hwc / dpe_gather2d_pick: queries per block.
constexpr int kBlockQueries = 4 * kThreads;

__device__ __forceinline__ int32_t clampi(int32_t v, int32_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// dpe_gather2d: channel-first tiles.
// ---------------------------------------------------------------------------

struct TileArgs {
  const uint32_t* img;   // (C, H, W) 32-bit words
  const int32_t* iy;     // (Qh, Qw)
  const int32_t* ix;
  uint32_t* out;         // (C, Qh, Qw)
  int64_t C;
  int32_t H, W;
  int32_t Qh, Qw;
  int32_t tiles_x;       // tiles along a query row
};

// The thread's queries: rows r0 + warp + kWarps * p (p < kPasses), columns
// col .. col + 3.
struct TileQueries {
  int32_t r0, col;
  int32_t y[kPer], x[kPer];
  uint32_t ok;           // bit i: query i lies inside (Qh, Qw)
};

template <bool kVec>
__device__ __forceinline__ void load_tile(const TileArgs& a, TileQueries& t) {
  const int warp = threadIdx.x >> 5;
  t.ok = 0;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int32_t r = t.r0 + warp + kWarps * p;
    const int64_t base = (int64_t)r * a.Qw + t.col;
    const bool row_ok = r < a.Qh;
    if constexpr (kVec) {
      // Qw % 4 == 0: the 4 queries are all inside or all outside.
      int4 vy = make_int4(0, 0, 0, 0), vx = vy;
      if (row_ok && t.col < a.Qw) {
        vy = __ldcs(reinterpret_cast<const int4*>(a.iy + base));
        vx = __ldcs(reinterpret_cast<const int4*>(a.ix + base));
        t.ok |= 0xFu << (4 * p);
      }
      t.y[4 * p + 0] = vy.x; t.y[4 * p + 1] = vy.y;
      t.y[4 * p + 2] = vy.z; t.y[4 * p + 3] = vy.w;
      t.x[4 * p + 0] = vx.x; t.x[4 * p + 1] = vx.y;
      t.x[4 * p + 2] = vx.z; t.x[4 * p + 3] = vx.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = row_ok && t.col + k < a.Qw;
        t.y[4 * p + k] = in ? __ldcs(a.iy + base + k) : 0;
        t.x[4 * p + k] = in ? __ldcs(a.ix + base + k) : 0;
        t.ok |= (in ? 1u : 0u) << (4 * p + k);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    t.y[i] = clampi(t.y[i], a.H - 1);
    t.x[i] = clampi(t.x[i], a.W - 1);
  }
}

template <bool kVec>
__device__ __forceinline__ void store_tile(const TileArgs& a,
                                           const TileQueries& t, int64_t c,
                                           const uint32_t (&v)[kPer]) {
  const int warp = threadIdx.x >> 5;
  uint32_t* o = a.out + c * ((int64_t)a.Qh * a.Qw);
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int64_t base =
        (int64_t)(t.r0 + warp + kWarps * p) * a.Qw + t.col;
    if constexpr (kVec) {
      if ((t.ok >> (4 * p)) & 1u)
        __stcs(reinterpret_cast<uint4*>(o + base),
               make_uint4(v[4 * p], v[4 * p + 1], v[4 * p + 2],
                          v[4 * p + 3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if ((t.ok >> (4 * p + k)) & 1u) __stcs(o + base + k, v[4 * p + k]);
    }
  }
}

// One block per tile.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    gather2d_tiles(TileArgs a) {
  const int lane = threadIdx.x & 31;
  TileQueries t;
  t.r0 = (int32_t)(blockIdx.x / (uint32_t)a.tiles_x) * kTileRows;
  t.col = (int32_t)(blockIdx.x % (uint32_t)a.tiles_x) * kTileCols + 4 * lane;
  load_tile<kVec>(a, t);
  const int64_t plane = (int64_t)a.H * a.W;

  // Two channels' loads in flight before their stores with vector I/O; one
  // channel with word I/O, whose per-word store addresses need the
  // registers.
  constexpr int kGroup = kVec ? 2 : 1;
  int32_t go[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) go[i] = t.y[i] * a.W + t.x[i];
  for (int64_t c = 0; c < a.C; c += kGroup) {
    const uint32_t* p0 = a.img + c * plane;
    const bool two = kGroup == 2 && c + 1 < a.C;
    uint32_t v0[kPer], v1[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) v0[i] = __ldg(p0 + go[i]);
    if (two) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) v1[i] = __ldg(p0 + plane + go[i]);
    }
    store_tile<kVec>(a, t, c, v0);
    if (two) store_tile<kVec>(a, t, c + 1, v1);
  }
}

// ---------------------------------------------------------------------------
// dpe_gather2d_hwc: channel-last rows of bytes.
// ---------------------------------------------------------------------------

struct HwcArgs {
  const char* img;       // (H, W, row) bytes, pixel (y, x) at y*s_h + x*s_w
  const int32_t* iy;     // (Q,)
  const int32_t* ix;
  char* out;             // (Q, row) bytes
  int32_t H, W;
  int64_t s_h, s_w;      // byte strides
  int64_t Q;
  int32_t upq;           // units per query: row bytes / sizeof(Unit)
};

template <class Unit, bool kVec>
__global__ void __launch_bounds__(kThreads) gather2d_hwc_kernel(HwcArgs a) {
  __shared__ int64_t offs[kBlockQueries];
  const int64_t q0 = (int64_t)blockIdx.x * kBlockQueries;
  const int64_t q = q0 + 4 * threadIdx.x;
  int32_t y[4], x[4];
  if constexpr (kVec) {
    // Q % 4 == 0: the 4 queries are all inside or all outside.
    int4 vy = make_int4(0, 0, 0, 0), vx = vy;
    if (q < a.Q) {
      vy = __ldcs(reinterpret_cast<const int4*>(a.iy + q));
      vx = __ldcs(reinterpret_cast<const int4*>(a.ix + q));
    }
    y[0] = vy.x; y[1] = vy.y; y[2] = vy.z; y[3] = vy.w;
    x[0] = vx.x; x[1] = vx.y; x[2] = vx.z; x[3] = vx.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = q + k < a.Q;
      y[k] = in ? __ldcs(a.iy + q + k) : 0;
      x[k] = in ? __ldcs(a.ix + q + k) : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    offs[4 * threadIdx.x + k] = (int64_t)clampi(y[k], a.H - 1) * a.s_h +
                                (int64_t)clampi(x[k], a.W - 1) * a.s_w;
  __syncthreads();

  const int64_t left = a.Q - q0;
  const int32_t nq = left < kBlockQueries ? (int32_t)left : kBlockQueries;
  const int32_t units = nq * a.upq;
  Unit* out = reinterpret_cast<Unit*>(a.out) + q0 * a.upq;
  for (int32_t u0 = threadIdx.x; u0 < units; u0 += 4 * kThreads) {
    Unit v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int32_t u = u0 + k * kThreads;
      if (u < units) {
        const int32_t qq = a.upq == 1 ? u : u / a.upq;
        const int32_t j = u - qq * a.upq;
        v[k] = __ldg(reinterpret_cast<const Unit*>(a.img + offs[qq]) + j);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int32_t u = u0 + k * kThreads;
      if (u < units) out[u] = v[k];
    }
  }
}

template <class Unit>
int launch_hwc(const HwcArgs& a, int32_t vec, cudaStream_t s) {
  const int64_t blocks = (a.Q + kBlockQueries - 1) / kBlockQueries;
  if (vec)
    gather2d_hwc_kernel<Unit, true><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  else
    gather2d_hwc_kernel<Unit, false><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dpe_gather2d_pick: one channel per query.
// ---------------------------------------------------------------------------

struct PickArgs {
  const uint32_t* img;   // (C, H, W) 32-bit words
  const long long* ic;   // (Q,) int64
  const int32_t* iy;
  const int32_t* ix;
  uint32_t* out;         // (Q,)
  int32_t C, H, W;
  int64_t Q;
};

__device__ __forceinline__ int32_t clamp64(long long v, int32_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : (int32_t)v);
}

__device__ __forceinline__ void load_ic4(const long long* p,
                                         int32_t (&c)[4], int32_t hi) {
  const longlong2 v0 = __ldcs(reinterpret_cast<const longlong2*>(p));
  const longlong2 v1 = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
  c[0] = clamp64(v0.x, hi); c[1] = clamp64(v0.y, hi);
  c[2] = clamp64(v1.x, hi); c[3] = clamp64(v1.y, hi);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) gather2d_pick_kernel(PickArgs a) {
  const int64_t q = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (q >= a.Q) return;
  const long long* ic = a.ic + q;
  int32_t c[4], y[4], x[4];
  if constexpr (kVec) {
    load_ic4(ic, c, a.C - 1);
    const int4 vy = __ldcs(reinterpret_cast<const int4*>(a.iy + q));
    const int4 vx = __ldcs(reinterpret_cast<const int4*>(a.ix + q));
    y[0] = vy.x; y[1] = vy.y; y[2] = vy.z; y[3] = vy.w;
    x[0] = vx.x; x[1] = vx.y; x[2] = vx.z; x[3] = vx.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = q + k < a.Q;
      c[k] = in ? clamp64(__ldcs(ic + k), a.C - 1) : 0;
      y[k] = in ? __ldcs(a.iy + q + k) : 0;
      x[k] = in ? __ldcs(a.ix + q + k) : 0;
    }
  }
  const int64_t plane = (int64_t)a.H * a.W;
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = __ldg(a.img + (int64_t)c[k] * plane +
                 clampi(y[k], a.H - 1) * a.W + clampi(x[k], a.W - 1));
  if constexpr (kVec) {
    __stcs(reinterpret_cast<uint4*>(a.out + q),
           make_uint4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (q + k < a.Q) __stcs(a.out + q + k, v[k]);
  }
}

}  // namespace

// The plan arguments come from dpe_mvs_tpu_torch/ops/gather2d.py (tile_plan,
// hwc_plan, index_vec), which checks the alignment and size conditions each
// of them relies on.
extern "C" int dpe_gather2d(const void* img, const void* iy, const void* ix,
                            void* out, int64_t C, int32_t H, int32_t W,
                            int32_t Qh, int32_t Qw, int32_t vec,
                            int32_t tiles, int32_t tiles_x, void* stream) {
  if (C <= 0 || tiles <= 0) return 0;
  const TileArgs a{(const uint32_t*)img, (const int32_t*)iy,
                   (const int32_t*)ix, (uint32_t*)out, C, H, W, Qh, Qw,
                   tiles_x};
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    gather2d_tiles<true><<<(unsigned)tiles, kThreads, 0, s>>>(a);
  else
    gather2d_tiles<false><<<(unsigned)tiles, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int dpe_gather2d_hwc(const void* img, const void* iy,
                                const void* ix, void* out, int32_t H,
                                int32_t W, int64_t s_h, int64_t s_w,
                                int64_t Q, int32_t unit, int32_t upq,
                                int32_t vec, void* stream) {
  if (Q <= 0 || upq <= 0) return 0;
  const HwcArgs a{(const char*)img, (const int32_t*)iy, (const int32_t*)ix,
                  (char*)out, H, W, s_h, s_w, Q, upq};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (unit) {
    case 16: return launch_hwc<uint4>(a, vec, s);
    case 8: return launch_hwc<uint2>(a, vec, s);
    case 4: return launch_hwc<uint32_t>(a, vec, s);
    case 2: return launch_hwc<uint16_t>(a, vec, s);
    case 1: return launch_hwc<uint8_t>(a, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dpe_gather2d_pick(const void* img, const void* ic,
                                 const void* iy, const void* ix, void* out,
                                 int32_t C, int32_t H, int32_t W, int64_t Q,
                                 int32_t vec, void* stream) {
  if (C <= 0 || Q <= 0) return 0;
  const PickArgs a{(const uint32_t*)img, (const long long*)ic,
                   (const int32_t*)iy, (const int32_t*)ix, (uint32_t*)out, C,
                   H, W, Q};
  const int64_t blocks = (a.Q + kBlockQueries - 1) / kBlockQueries;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    gather2d_pick_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  else
    gather2d_pick_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
