// Fused plane-sweep warp + variance cost volume, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel _warp_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/warp_variance.py:211), entry
// fused_warp_variance (:150): for every (batch, depth plane, target pixel)
// project through each of S source views' 3x4 matrices at metric depth,
// sample the C-channel source features bilinearly with zeros padding, and
// write the population variance over the views.
//
// What bounds it on an H100: memory. From device memory it needs the
// features and depths once and writes C floats of variance per voxel; the
// arithmetic is ~12 flops per channel per view, far below the f32 rate.
// Each voxel also gathers S views x 4 taps x C floats, about ten times the
// device-memory bytes, which neighbouring voxels share through L1/L2
// (they hit neighbouring source pixels), so the cache rate limits it too.
// The design therefore does a direct gather (no TPU y-bands or windows:
// exact for every tap), one thread per (voxel, group of 4 channels) so a
// warp writes contiguous 16-byte vectors of the channels-last output, keeps
// the sum and sum of squares over views in registers (no S-sized volume
// ever reaches memory), and computes the projection in the exact rounding
// order of the plain version (cost_volume.warp_coords) so both agree on
// every tap.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float proj_row(const float* P, float u, float v, float dep) {
  // ((P0*u + P1*v) + P2) + P3/depth, each op rounded as in the plain version
  float base = __fadd_rn(__fadd_rn(__fmul_rn(P[0], u), __fmul_rn(P[1], v)), P[2]);
  return __fadd_rn(base, __fdiv_rn(P[3], dep));
}

__device__ __forceinline__ float4 axpy4(float4 acc, float4 v, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
  return acc;
}

__global__ void warp_variance_kernel(
    const float* __restrict__ feats,  // (B, S, Hs, Ws, C)
    const float* __restrict__ proj,   // (B, S, 3, 4)
    const float* __restrict__ depth,  // (B, D, Ht, Wt)
    float* __restrict__ out,          // (B, D, Ht, Wt, C)
    int B, int S, int Hs, int Ws, int C, int D, int Ht, int Wt) {
  const int G = C >> 2;  // float4 groups per voxel
  const long long n = (long long)B * D * Ht * Wt * G;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int g = (int)(t % G);
  const long long vox = t / G;  // (b, d, y, x) row-major, the depth layout
  const int x = (int)(vox % Wt);
  const int y = (int)((vox / Wt) % Ht);
  const int b = (int)(vox / ((long long)Wt * Ht * D));
  const float dep = depth[vox];
  const float u = (float)x, v = (float)y;

  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 sq = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < S; ++s) {
    const float* P = proj + ((long long)b * S + s) * 12;
    const float z = fmaxf(proj_row(P + 8, u, v, dep), 1e-6f);
    // clamp to [-2, size+1]: taps beyond carry zero weight, and the clamp
    // keeps the float->int conversion of behind-camera points defined
    const float sx = fminf(fmaxf(__fdiv_rn(proj_row(P, u, v, dep), z), -2.f), Ws + 1.f);
    const float sy = fminf(fmaxf(__fdiv_rn(proj_row(P + 4, u, v, dep), z), -2.f), Hs + 1.f);
    const float x0f = floorf(sx), y0f = floorf(sy);
    const float tx = __fsub_rn(sx, x0f), ty = __fsub_rn(sy, y0f);
    const int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
    const bool vx0 = x0 >= 0 && x0 <= Ws - 1, vx1 = x1 >= 0 && x1 <= Ws - 1;
    const bool vy0 = y0 >= 0 && y0 <= Hs - 1, vy1 = y1 >= 0 && y1 <= Hs - 1;
    const float w00 = __fmul_rn(__fsub_rn(1.f, ty), __fsub_rn(1.f, tx));
    const float w01 = __fmul_rn(__fsub_rn(1.f, ty), tx);
    const float w10 = __fmul_rn(ty, __fsub_rn(1.f, tx));
    const float w11 = __fmul_rn(ty, tx);
    const float4* img =
        reinterpret_cast<const float4*>(feats + ((long long)b * S + s) * Hs * Ws * C);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (vy0 && vx0) acc = axpy4(acc, img[((long long)y0 * Ws + x0) * G + g], w00);
    if (vy0 && vx1) acc = axpy4(acc, img[((long long)y0 * Ws + x1) * G + g], w01);
    if (vy1 && vx0) acc = axpy4(acc, img[((long long)y1 * Ws + x0) * G + g], w10);
    if (vy1 && vx1) acc = axpy4(acc, img[((long long)y1 * Ws + x1) * G + g], w11);
    sum.x = __fadd_rn(sum.x, acc.x); sq.x = __fadd_rn(sq.x, __fmul_rn(acc.x, acc.x));
    sum.y = __fadd_rn(sum.y, acc.y); sq.y = __fadd_rn(sq.y, __fmul_rn(acc.y, acc.y));
    sum.z = __fadd_rn(sum.z, acc.z); sq.z = __fadd_rn(sq.z, __fmul_rn(acc.z, acc.z));
    sum.w = __fadd_rn(sum.w, acc.w); sq.w = __fadd_rn(sq.w, __fmul_rn(acc.w, acc.w));
  }
  const float fs = (float)S;
  float4 var;
  var.x = __fsub_rn(__fdiv_rn(sq.x, fs), __fmul_rn(__fdiv_rn(sum.x, fs), __fdiv_rn(sum.x, fs)));
  var.y = __fsub_rn(__fdiv_rn(sq.y, fs), __fmul_rn(__fdiv_rn(sum.y, fs), __fdiv_rn(sum.y, fs)));
  var.z = __fsub_rn(__fdiv_rn(sq.z, fs), __fmul_rn(__fdiv_rn(sum.z, fs), __fdiv_rn(sum.z, fs)));
  var.w = __fsub_rn(__fdiv_rn(sq.w, fs), __fmul_rn(__fdiv_rn(sum.w, fs), __fdiv_rn(sum.w, fs)));
  reinterpret_cast<float4*>(out)[t] = var;
}

}  // namespace

extern "C" int warp_variance_launch(const void* feats, const void* proj, const void* depth,
                                    void* out, int B, int S, int Hs, int Ws, int C, int D,
                                    int Ht, int Wt, void* stream) {
  if (C % 4 != 0 || S < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * D * Ht * Wt * (C / 4);
  if (n == 0) return 0;
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  warp_variance_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)feats, (const float*)proj, (const float*)depth, (float*)out, B, S, Hs, Ws,
      C, D, Ht, Wt);
  return (int)cudaGetLastError();
}
