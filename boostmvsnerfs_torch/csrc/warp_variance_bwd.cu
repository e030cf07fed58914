// Backward of the fused plane-sweep warp + variance cost volume, f32, for
// sm_90a.
//
// Replaces the Pallas TPU kernel _warp_bwd_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/warp_variance.py:419), entry
// _warp_variance_bwd (:371), the backward of fused_warp_variance_diff: given
// the variance cotangent g (B, D, Ht, Wt, C), it returns
//
//   d feats (B, S, Hs, Ws, C): the per-view cotangent
//       g_s = g * (2/S) * (w_s - mean)
//     scattered through the transposed bilinear interpolation (each tap
//     receives g_s times its bilinear weight);
//   d depth (B, D, Ht, Wt): the x/y derivatives of the triangle weights,
//     chained through x = sx / max(sz, 1e-6) with sx, sy, sz linear in
//     1/depth, summed over views and channels.
//
// Conventions of the Pallas kernel (trap: they differ from autodiff of a
// floor-based sampler at exact integers and clamp bounds): the derivative of
// a triangle weight max(0, 1 - |j - x|) is sign(j - x) where |j - x| < 1 and
// 0 elsewhere, so dx = 0 at an integer x; the coordinates clamped to
// [-2, size+1] carry a gradient only inside that range, bounds included; a
// clamped z (sz <= 1e-6) carries none.
//
// What bounds it on an H100: memory and atomics. From device memory it needs
// the features, depths and cotangent once and writes d feats and d depth
// once (~10 flops per channel per view per tap); the feature cotangent is a
// scatter into source pixels that neighbouring voxels share, so it uses one
// atomicAdd per channel per tap (4 per view per channel). The design mirrors
// the forward: one thread per (voxel, group of 4 channels) recomputes each
// view's 4 taps in the forward's rounding order, first to form the mean over
// views (recomputing it is cheaper than storing the 181 MB per-view sum the
// Pallas forward saves), then to emit the cotangents. The depth cotangent is
// summed over views in registers and over the voxel's channel groups with
// warp shuffles (a voxel's groups are neighbouring lanes), so each voxel's
// d depth is written by one thread with no atomic.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float proj_row(const float* P, float u, float v, float dep) {
  // ((P0*u + P1*v) + P2) + P3/depth, each op rounded as in the forward
  float base = __fadd_rn(__fadd_rn(__fmul_rn(P[0], u), __fmul_rn(P[1], v)), P[2]);
  return __fadd_rn(base, __fdiv_rn(P[3], dep));
}

struct Taps {
  float tx, ty, w00, w01, w10, w11, xu, yu, sz;
  int x0, y0;
  bool v00, v01, v10, v11, live, mask_x, mask_y;
};

// one view's projection and bilinear taps at a voxel, as the forward
// computes them (csrc/warp_variance.cu)
__device__ __forceinline__ Taps view_taps(const float* P, float u, float v, float dep, int Hs,
                                          int Ws) {
  Taps t;
  const float sz_raw = proj_row(P + 8, u, v, dep);
  t.live = sz_raw > 1e-6f;
  t.sz = fmaxf(sz_raw, 1e-6f);
  t.xu = __fdiv_rn(proj_row(P, u, v, dep), t.sz);
  t.yu = __fdiv_rn(proj_row(P + 4, u, v, dep), t.sz);
  t.mask_x = t.xu >= -2.f && t.xu <= Ws + 1.f;
  t.mask_y = t.yu >= -2.f && t.yu <= Hs + 1.f;
  const float sx = fminf(fmaxf(t.xu, -2.f), Ws + 1.f);
  const float sy = fminf(fmaxf(t.yu, -2.f), Hs + 1.f);
  const float x0f = floorf(sx), y0f = floorf(sy);
  t.tx = __fsub_rn(sx, x0f);
  t.ty = __fsub_rn(sy, y0f);
  t.x0 = (int)x0f;
  t.y0 = (int)y0f;
  const bool vx0 = t.x0 >= 0 && t.x0 <= Ws - 1, vx1 = t.x0 + 1 >= 0 && t.x0 + 1 <= Ws - 1;
  const bool vy0 = t.y0 >= 0 && t.y0 <= Hs - 1, vy1 = t.y0 + 1 >= 0 && t.y0 + 1 <= Hs - 1;
  t.v00 = vy0 && vx0;
  t.v01 = vy0 && vx1;
  t.v10 = vy1 && vx0;
  t.v11 = vy1 && vx1;
  t.w00 = __fmul_rn(__fsub_rn(1.f, t.ty), __fsub_rn(1.f, t.tx));
  t.w01 = __fmul_rn(__fsub_rn(1.f, t.ty), t.tx);
  t.w10 = __fmul_rn(t.ty, __fsub_rn(1.f, t.tx));
  t.w11 = __fmul_rn(t.ty, t.tx);
  return t;
}

__device__ __forceinline__ float4 load_tap(const float4* img, bool valid, long long idx) {
  return valid ? img[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 axpy4(float4 acc, float4 v, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
  return acc;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ void scatter4(float* dst, float4 gs, float w) {
  atomicAdd(dst + 0, gs.x * w);
  atomicAdd(dst + 1, gs.y * w);
  atomicAdd(dst + 2, gs.z * w);
  atomicAdd(dst + 3, gs.w * w);
}

__global__ void warp_variance_bwd_kernel(
    const float* __restrict__ feats,  // (B, S, Hs, Ws, C)
    const float* __restrict__ proj,   // (B, S, 3, 4)
    const float* __restrict__ depth,  // (B, D, Ht, Wt)
    const float* __restrict__ g,      // (B, D, Ht, Wt, C)
    float* __restrict__ dfeats,       // (B, S, Hs, Ws, C), zeroed
    float* __restrict__ ddepth,       // (B, D, Ht, Wt), zeroed
    int B, int S, int Hs, int Ws, int C, int D, int Ht, int Wt, int shuffle) {
  const int G = C >> 2;  // float4 groups per voxel
  const long long n = (long long)B * D * Ht * Wt * G;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = t < n;  // every lane stays for the shuffles below
  float gdep = 0.f;
  const long long vox = active ? t / G : 0;
  if (active) {
    const int grp = (int)(t % G);
    const int x = (int)(vox % Wt);
    const int y = (int)((vox / Wt) % Ht);
    const int b = (int)(vox / ((long long)Wt * Ht * D));
    const float dep = depth[vox];
    const float u = (float)x, v = (float)y;
    const long long plane = (long long)Hs * Ws * C;

    // pass 1: the mean over views of the warped features
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      const float* P = proj + ((long long)b * S + s) * 12;
      const Taps k = view_taps(P, u, v, dep, Hs, Ws);
      const float4* img = reinterpret_cast<const float4*>(feats + ((long long)b * S + s) * plane);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k.v00) acc = axpy4(acc, img[((long long)k.y0 * Ws + k.x0) * G + grp], k.w00);
      if (k.v01) acc = axpy4(acc, img[((long long)k.y0 * Ws + k.x0 + 1) * G + grp], k.w01);
      if (k.v10) acc = axpy4(acc, img[((long long)(k.y0 + 1) * Ws + k.x0) * G + grp], k.w10);
      if (k.v11) acc = axpy4(acc, img[((long long)(k.y0 + 1) * Ws + k.x0 + 1) * G + grp], k.w11);
      sum.x = __fadd_rn(sum.x, acc.x);
      sum.y = __fadd_rn(sum.y, acc.y);
      sum.z = __fadd_rn(sum.z, acc.z);
      sum.w = __fadd_rn(sum.w, acc.w);
    }
    const float fs = (float)S;
    const float4 mean = make_float4(sum.x / fs, sum.y / fs, sum.z / fs, sum.w / fs);
    const float4 gv = reinterpret_cast<const float4*>(g)[t];
    const float c2 = 2.f / fs;
    const float inv_d = 1.f / dep;

    // pass 2: per-view cotangent, feature scatter, coordinate gradients
    for (int s = 0; s < S; ++s) {
      const float* P = proj + ((long long)b * S + s) * 12;
      const Taps k = view_taps(P, u, v, dep, Hs, Ws);
      const float4* img = reinterpret_cast<const float4*>(feats + ((long long)b * S + s) * plane);
      const long long i00 = ((long long)k.y0 * Ws + k.x0) * G + grp;
      const long long i01 = i00 + G, i10 = i00 + (long long)Ws * G, i11 = i10 + G;
      const float4 p00 = load_tap(img, k.v00, i00), p01 = load_tap(img, k.v01, i01);
      const float4 p10 = load_tap(img, k.v10, i10), p11 = load_tap(img, k.v11, i11);
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      w = axpy4(w, p00, k.w00);
      w = axpy4(w, p01, k.w01);
      w = axpy4(w, p10, k.w10);
      w = axpy4(w, p11, k.w11);
      const float4 gs = make_float4(gv.x * c2 * (w.x - mean.x), gv.y * c2 * (w.y - mean.y),
                                    gv.z * c2 * (w.z - mean.z), gv.w * c2 * (w.w - mean.w));
      float* dimg = dfeats + ((long long)b * S + s) * plane;
      if (k.v00 && k.w00 != 0.f) scatter4(dimg + 4 * i00, gs, k.w00);
      if (k.v01 && k.w01 != 0.f) scatter4(dimg + 4 * i01, gs, k.w01);
      if (k.v10 && k.w10 != 0.f) scatter4(dimg + 4 * i10, gs, k.w10);
      if (k.v11 && k.w11 != 0.f) scatter4(dimg + 4 * i11, gs, k.w11);
      // d w / d x: the right taps minus the left ones along each row (zero
      // at an integer x); d w / d y likewise down each column
      float gx = 0.f, gy = 0.f;
      if (k.tx != 0.f && k.mask_x) {
        const float4 row0 = sub4(p01, p00), row1 = sub4(p11, p10);
        gx = dot4(gs, make_float4((1.f - k.ty) * row0.x + k.ty * row1.x,
                                  (1.f - k.ty) * row0.y + k.ty * row1.y,
                                  (1.f - k.ty) * row0.z + k.ty * row1.z,
                                  (1.f - k.ty) * row0.w + k.ty * row1.w));
      }
      if (k.ty != 0.f && k.mask_y) {
        const float4 col0 = sub4(p10, p00), col1 = sub4(p11, p01);
        gy = dot4(gs, make_float4((1.f - k.tx) * col0.x + k.tx * col1.x,
                                  (1.f - k.tx) * col0.y + k.tx * col1.y,
                                  (1.f - k.tx) * col0.z + k.tx * col1.z,
                                  (1.f - k.tx) * col0.w + k.tx * col1.w));
      }
      const float pz = k.live ? P[11] : 0.f;
      const float dx_dinvd = (P[3] - k.xu * pz) / k.sz;
      const float dy_dinvd = (P[7] - k.yu * pz) / k.sz;
      gdep += gx * dx_dinvd + gy * dy_dinvd;
    }
    gdep *= -inv_d * inv_d;
  }
  if (shuffle) {
    // G is a power of two <= 32: the voxel's groups are G neighbouring lanes
    for (int off = G >> 1; off > 0; off >>= 1) gdep += __shfl_down_sync(0xffffffffu, gdep, off, G);
    if (active && t % G == 0) ddepth[vox] = gdep;
  } else if (active) {
    atomicAdd(ddepth + vox, gdep);
  }
}

}  // namespace

extern "C" int warp_variance_bwd_launch(const void* feats, const void* proj, const void* depth,
                                        const void* g, void* dfeats, void* ddepth, int B, int S,
                                        int Hs, int Ws, int C, int D, int Ht, int Wt,
                                        void* stream) {
  if (C % 4 != 0 || S < 1) return (int)cudaErrorInvalidValue;
  const int G = C / 4;
  const long long n = (long long)B * D * Ht * Wt * G;
  if (n == 0) return 0;
  const int shuffle = G <= 32 && (G & (G - 1)) == 0;
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  warp_variance_bwd_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)feats, (const float*)proj, (const float*)depth, (const float*)g,
      (float*)dfeats, (float*)ddepth, B, S, Hs, Ws, C, D, Ht, Wt, shuffle);
  return (int)cudaGetLastError();
}
