// The weak stage's per-view deformable NCC cost and geometric term of one
// candidate plane field, for Hopper (sm_90a): dpe_weakcost.
//
// It replaces no Pallas kernel. It is the hand-written counterpart of the
// elementwise chain that XLA fuses for the JAX package
// (dpe_mvs_tpu/engine/weak_rect.py deformable_cost_rect and geom_term_rect)
// and that the port's plain versions (dpe_mvs_tpu_torch/engine/weak_rect.py
// deformable_cost_rect_ref, geom_term_rect_ref) run as some 870 and 400
// eager PyTorch launches a call at five views. Per view i and site (r, c):
//
//   rotate the candidate plane into view i's rect frame (plane_to_rect) and
//   take its affine disparity coefficients (disparity_coeffs); its disparity
//   at the site's rect coordinates reads the centre probe profile
//   (interp_profile: two taps of 16, hat weights, taps valid below
//   VALID_THRESH, the sample valid where their weights sum past 0.9999);
//   at each of the 8 anchors, whose rect coordinates come from the anchor's
//   pixel through H_ref, it reads the anchor's profile; an anchor out of its
//   profile counts COST_MAX where it had selected view i; the anchors' mean
//   (summed in anchor order) and the centre blend 0.25 / 0.75; a view or a
//   centre out of its profile costs COST_MAX. The geometric term reads the
//   geometric profile at the centre disparity.
//
// mode bit 1 writes the photometric cost, bit 2 the geometric term, both
// their sum cost + geom_factor * term (the refinement's weighted candidate).
//
// Every float operation is the plain chain's, in its order, through the
// _rn intrinsics, which nvcc never contracts into an FMA: each of PyTorch's
// eager launches rounds its result to float32, so the kernel does too.
// Divisions are IEEE (PyTorch's tensor / tensor, and its 1 / d, are correctly
// rounded); a division by a Python scalar is PyTorch's multiplication by the
// scalar's reciprocal (/ 2 is * 0.5). Clamps keep PyTorch's rule (NaN passes
// through, else fminf(fmaxf(v, lo), hi)), and Python constants are their
// float32 images. So the output is bit for bit the plain version's.
//
// What bounds it on the card: bytes. Per site and view it reads the plane
// (16 B), its rect coordinates and centre disparity (12 B), two bf16 taps of
// the centre profile, and per anchor its pixel, selected-view bits, validity
// (13 B, shared by the views), probe-centre disparity (4 B) and two bf16
// taps; it writes 4 B. At five views 540 B a site (ops/weakcost.py
// site_bytes): ~118 MB for a band of 144 x 1512 sites, ~35 us at 3.35 TB/s;
// a few hundred float operations a site are far below the card's rate. The
// design:
//
// - a thread per (view, site): sites along W are consecutive threads, so
//   every planar field (plane, coordinates, disparities, anchors, output)
//   is read and written coalesced, and neighbouring sites' taps, whose S
//   index mostly agrees, fall in the same sectors of one probe plane;
// - consecutive blocks take the views of one tile of sites, so the anchors'
//   fields, which every view reads, come from L2 after the first view;
// - every operand is read through its own strides (narrowed row bands, the
//   streaming mode's transposed (V, 8, S, h, W) stack, bf16 volumes, bool
//   masks): nothing is copied to make it contiguous;
// - the per-view constants (R2r, H_ref, f, b, cx, cy, view_valid) are one
//   small device array, read through the constant-broadcast path of L1.
//
// It launches on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAnchors = 8;
constexpr int kConsts = 22;        // per view: R2r (9), H_ref (9), f, b, cx, cy
constexpr int kPhoto = 1, kGeom = 2;

// The plain chain's Python constants as PyTorch casts them to float32.
constexpr float kBig = (float)1e30;          // BIG
constexpr float kCostMax = 2.0f;             // COST_MAX
constexpr float kGeomMax = 3.0f;             // GEOM_COST_MAX
constexpr float kValid = 1000.0f;            // VALID_THRESH
constexpr float kWvOk = (float)0.9999;
constexpr float kWvMin = (float)1e-9;
constexpr float kWdivMin = (float)1e-20;
constexpr float kHalfStep = 0.5f;            // 1 / PROBE_STEP
constexpr float kCentre = 7.5f;              // (PROBE_S - 1) / 2
constexpr float kLast = 15.0f;               // PROBE_S - 1

struct Field {             // a strided view: base pointer, element strides
  const void* p;
  int64_t st[5];
};

struct Args {
  const float* consts;     // (V * kConsts + V): per view R2r, H_ref, f, b,
                           // cx, cy; then each view's view_valid (0 or 1)
  Field plane;             // (h, W, 4) f32: row, column, component
  Field xr, yr, d0;        // (V, h, W) f32
  Field vol_center;        // (V, S, h, W) bf16
  Field vol_geom;          // (V, S, h, W) bf16 (geometric term only)
  Field ap;                // (V, 8, S, h, W) bf16
  Field a_d0;              // (V, 8, h, W) f32
  Field a_x, a_y;          // (8, h, W) int32
  Field a_valid;           // (8, h, W) bool
  Field a_sel;             // (8, h, W) int32
  float* out;              // (V, h, W) f32, contiguous
  int32_t V, h, W, mode;
  float geom_factor;
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}

__device__ __forceinline__ bool is_nan(float v) { return v != v; }
__device__ __forceinline__ bool is_finite(float v) {
  return fabsf(v) < __int_as_float(0x7f800000);    // false for inf and NaN
}

// torch.clamp, clamp(min=), clamp(max=) on float32.
__device__ __forceinline__ float clamp_both(float v, float lo, float hi) {
  return is_nan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return is_nan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return is_nan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float ld_f32(const Field& f, int64_t off) {
  return __ldg(static_cast<const float*>(f.p) + off);
}
__device__ __forceinline__ int32_t ld_i32(const Field& f, int64_t off) {
  return __ldg(static_cast<const int32_t*>(f.p) + off);
}
__device__ __forceinline__ float ld_bf16(const Field& f, int64_t off) {
  const unsigned short u = __ldg(static_cast<const unsigned short*>(f.p) + off);
  return __uint_as_float((uint32_t)u << 16);
}

// The candidate's disparity at rect coordinates (x, y), non-finite -> BIG.
__device__ __forceinline__ float disparity(float gx, float gy, float g0,
                                           float x, float y, float cx,
                                           float cy) {
  const float d = add_rn(add_rn(mul_rn(gx, sub_rn(x, cx)),
                                mul_rn(gy, sub_rn(y, cy))), g0);
  return is_finite(d) ? d : kBig;
}

struct Lerp {
  float val;
  bool ok;
};

// interp_profile: the profile whose tap s lies at base + s * s_stride, read
// srel px from its probe centre.
__device__ __forceinline__ Lerp interp(const Field& f, int64_t base,
                                       int64_t s_stride, float srel) {
  const float sf = add_rn(mul_rn(srel, kHalfStep), kCentre);
  const bool in_range = sf >= 0.0f && sf <= kLast;
  const float sfc = clamp_both(sf, 0.0f, kLast);
  const float s0 = clamp_hi(floorf(sfc), kLast - 1.0f);
  const float w0 = clamp_lo(sub_rn(1.0f, fabsf(sub_rn(sfc, s0))), 0.0f);
  const float w1 =
      clamp_lo(sub_rn(1.0f, fabsf(sub_rn(sfc, add_rn(s0, 1.0f)))), 0.0f);
  const int i0 = (int)s0;    // 0..14 (a NaN converts to 0)
  const float p0 = ld_bf16(f, base + (int64_t)i0 * s_stride);
  const float p1 = ld_bf16(f, base + (int64_t)(i0 + 1) * s_stride);
  const bool v0 = p0 < kValid, v1 = p1 < kValid;
  const float val =
      add_rn(v0 ? mul_rn(w0, p0) : 0.0f, v1 ? mul_rn(w1, p1) : 0.0f);
  const float wv = add_rn(v0 ? w0 : 0.0f, v1 ? w1 : 0.0f);
  return {div_rn(val, clamp_lo(wv, kWvMin)), in_range && wv > kWvOk};
}

__global__ void __launch_bounds__(kThreads) weakcost_kernel(const Args a) {
  const int v = (int)(blockIdx.x % (unsigned)a.V);
  const int64_t q =
      (int64_t)(blockIdx.x / (unsigned)a.V) * kThreads + threadIdx.x;
  if (q >= (int64_t)a.h * a.W) return;
  const int64_t r = q / a.W, c = q - r * a.W;
  const float* k = a.consts + v * kConsts;

  // plane_to_rect, disparity_coeffs.
  const int64_t po = r * a.plane.st[0] + c * a.plane.st[1];
  const float n0 = ld_f32(a.plane, po), n1 = ld_f32(a.plane, po + a.plane.st[2]);
  const float n2 = ld_f32(a.plane, po + 2 * a.plane.st[2]);
  const float dist = ld_f32(a.plane, po + 3 * a.plane.st[2]);
  float nr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    nr[i] = add_rn(add_rn(mul_rn(__ldg(k + 3 * i), n0),
                          mul_rn(__ldg(k + 3 * i + 1), n1)),
                   mul_rn(__ldg(k + 3 * i + 2), n2));
  const float f = __ldg(k + 18), b = __ldg(k + 19);
  const float cx = __ldg(k + 20), cy = __ldg(k + 21);
  const float inv_d = mul_rn(div_rn(1.0f, dist), 1.0f);   // 1.0 / d
  const float gx = mul_rn(mul_rn(b, nr[0]), inv_d);
  const float gy = mul_rn(mul_rn(b, nr[1]), inv_d);
  const float g0 = mul_rn(mul_rn(mul_rn(b, f), nr[2]), inv_d);

  const float xr = ld_f32(a.xr, v * a.xr.st[0] + r * a.xr.st[1] + c * a.xr.st[2]);
  const float yr = ld_f32(a.yr, v * a.yr.st[0] + r * a.yr.st[1] + c * a.yr.st[2]);
  const float d0 = ld_f32(a.d0, v * a.d0.st[0] + r * a.d0.st[1] + c * a.d0.st[2]);
  const float srel = sub_rn(disparity(gx, gy, g0, xr, yr, cx, cy), d0);

  float geom = 0.0f;
  if (a.mode & kGeom) {
    const Field& g = a.vol_geom;
    const Lerp l =
        interp(g, v * g.st[0] + r * g.st[2] + c * g.st[3], g.st[1], srel);
    geom = l.ok ? clamp_both(l.val, 0.0f, kGeomMax) : kGeomMax;
  }
  float photo = 0.0f;
  if (a.mode & kPhoto) {
    const Field& vc = a.vol_center;
    const Lerp centre =
        interp(vc, v * vc.st[0] + r * vc.st[2] + c * vc.st[3], vc.st[1], srel);
    const float* hm = k + 9;
    const int shift = v < 31 ? v : 31;    // torch's >> on int32
    float sum = 0.0f, cnt = 0.0f;
#pragma unroll 2
    for (int j = 0; j < kAnchors; ++j) {
      const int64_t ao = j * a.a_x.st[0] + r * a.a_x.st[1] + c * a.a_x.st[2];
      const float ax = (float)ld_i32(a.a_x, ao);
      const float ay = (float)ld_i32(
          a.a_y, j * a.a_y.st[0] + r * a.a_y.st[1] + c * a.a_y.st[2]);
      // _anchor_rect_coords.
      float wdiv = add_rn(add_rn(mul_rn(__ldg(hm + 6), ax),
                                 mul_rn(__ldg(hm + 7), ay)), __ldg(hm + 8));
      if (fabsf(wdiv) < kWdivMin) wdiv = kWdivMin;
      const float axr = div_rn(add_rn(add_rn(mul_rn(__ldg(hm + 0), ax),
                                             mul_rn(__ldg(hm + 1), ay)),
                                      __ldg(hm + 2)), wdiv);
      const float ayr = div_rn(add_rn(add_rn(mul_rn(__ldg(hm + 3), ax),
                                             mul_rn(__ldg(hm + 4), ay)),
                                      __ldg(hm + 5)), wdiv);
      const float ad0 = ld_f32(a.a_d0, v * a.a_d0.st[0] + j * a.a_d0.st[1] +
                                           r * a.a_d0.st[2] + c * a.a_d0.st[3]);
      const Field& p = a.ap;
      const Lerp l = interp(
          p, v * p.st[0] + j * p.st[1] + r * p.st[3] + c * p.st[4], p.st[2],
          sub_rn(disparity(gx, gy, g0, axr, ayr, cx, cy), ad0));
      const int32_t sel = ld_i32(
          a.a_sel, j * a.a_sel.st[0] + r * a.a_sel.st[1] + c * a.a_sel.st[2]);
      const bool sel_here = ((sel >> shift) & 1) == 1;
      const bool valid = __ldg(static_cast<const unsigned char*>(a.a_valid.p) +
                               j * a.a_valid.st[0] + r * a.a_valid.st[1] +
                               c * a.a_valid.st[2]) != 0;
      const float contrib = l.ok ? clamp_both(l.val, 0.0f, kCostMax)
                                 : (sel_here ? kCostMax : 0.0f);
      const float m = valid ? contrib : 0.0f;
      sum = j == 0 ? m : add_rn(sum, m);          // anchor order
      cnt += (valid && (l.ok || sel_here)) ? 1.0f : 0.0f;  // exact
    }
    const float strong = clamp_hi(div_rn(sum, clamp_lo(cnt, 1.0f)), kCostMax);
    const float c0 = clamp_both(centre.val, 0.0f, kCostMax);
    const float cost =
        cnt > 0.0f ? add_rn(mul_rn(0.25f, c0), mul_rn(0.75f, strong)) : c0;
    const bool view_ok = __ldg(a.consts + a.V * kConsts + v) != 0.0f;
    photo = centre.ok && view_ok ? cost : kCostMax;
  }
  float res = geom;
  if (a.mode == (kPhoto | kGeom))
    res = add_rn(photo, mul_rn(geom, a.geom_factor));
  else if (a.mode == kPhoto)
    res = photo;
  a.out[(int64_t)v * a.h * a.W + q] = res;
}

}  // namespace

// The arguments come from dpe_mvs_tpu_torch/ops/weakcost.py (weak_cost),
// which checks every operand's dtype, shape and device, and h * W < 2^31,
// 1 <= V <= 32 and mode in 1..3. ``args`` points to an Args (a void pointer
// here: a signature naming a type of the unnamed namespace would not be
// exported).
extern "C" int dpe_weakcost(const void* args, void* stream) {
  const Args a = *static_cast<const Args*>(args);
  const int64_t tiles = ((int64_t)a.h * a.W + kThreads - 1) / kThreads;
  if (tiles <= 0 || a.V <= 0) return 0;
  if (tiles * a.V >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  weakcost_kernel<<<(unsigned)(tiles * a.V), kThreads, 0,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
