// Scattered 2-D point gather for Hopper (sm_90a): the anchor reads of the
// weak-texture machinery.
//
//   dpe_gather2d  replaces dpe_mvs_tpu/ops/gather2d.py _gather2d_vmem_kernel
//                 (entry gather2d, a channel <= 6 MB) and _gather2d_kernel
//                 (entry _gather2d_hbm, a channel > 6 MB):
//                 out[c, q] = img[c, clamp(iy[q], 0, H-1), clamp(ix[q], 0, W-1)]
//
// The TPU kernels walk the row/column band of each (16, 128) query tile block
// by block, because Mosaic's gather is an in-register lane shuffle; the second
// one DMAs 64x512 windows of the band into VMEM first, because the image does
// not fit there. The 6 MB split is about where the TPU keeps the image. A
// Hopper thread addresses the image directly, so one kernel serves both.
//
// What bounds it: bytes. Per query it reads two 4 B indices and, per channel,
// one 4 B word of the image and writes one 4 B word. The bound is
// (8 B * Q + 4 B * C * Q + the touched image words) / 3.35 TB/s; the touched
// image is at most the whole image, and far less for anchor queries, which
// cluster around their pixel. The design:
//   - one thread per (query, chunk of 8 channels); consecutive threads take
//     consecutive queries, so index reads and output stores are coalesced
//     along the query axis in every channel plane;
//   - the image reads are data-dependent but local (anchors lie near their
//     pixel, invalid anchors read the pixel's own position), so neighbouring
//     threads hit the same cache lines and L2 serves them through the
//     read-only path (__ldg);
//   - 64-bit offsets throughout and a grid-stride loop over queries: at full
//     ETH3D resolution 8*H*W queries x C channels nears 2^31 elements.
//
// The kernel copies 32-bit words and never does float arithmetic on them, so
// float32 payloads (NaN patterns included), int32 and uint32 words, and pairs
// of bf16 values packed into one word all come out bit for bit.
//
// It launches on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChanChunk = 8;
constexpr int64_t kMaxBlocks = 1 << 20;

__global__ void gather2d_kernel(const uint32_t* __restrict__ img,
                                const int32_t* __restrict__ iy,
                                const int32_t* __restrict__ ix,
                                uint32_t* __restrict__ out,
                                int64_t C, int32_t H, int32_t W, int64_t Q) {
  const int64_t c0 = (int64_t)blockIdx.y * kChanChunk;
  const int64_t nc = C - c0 < kChanChunk ? C - c0 : kChanChunk;
  const int64_t plane = (int64_t)H * (int64_t)W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < Q;
       q += stride) {
    int32_t y = iy[q];
    int32_t x = ix[q];
    y = y < 0 ? 0 : (y > H - 1 ? H - 1 : y);
    x = x < 0 ? 0 : (x > W - 1 ? W - 1 : x);
    const uint32_t* src = img + c0 * plane + (int64_t)y * W + x;
    uint32_t* dst = out + c0 * Q + q;
#pragma unroll
    for (int c = 0; c < kChanChunk; ++c) {
      if (c < nc) dst[c * Q] = __ldg(src + c * plane);
    }
  }
}

}  // namespace

extern "C" int dpe_gather2d(const void* img, const void* iy, const void* ix,
                            void* out, int64_t C, int32_t H, int32_t W,
                            int64_t Q, void* stream) {
  if (C <= 0 || Q <= 0) return 0;
  int64_t blocks = (Q + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int64_t chunks = (C + kChanChunk - 1) / kChanChunk;
  dim3 grid((unsigned)blocks, (unsigned)chunks, 1);
  gather2d_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)img, (const int32_t*)iy, (const int32_t*)ix,
      (uint32_t*)out, C, H, W, Q);
  return (int)cudaGetLastError();
}
