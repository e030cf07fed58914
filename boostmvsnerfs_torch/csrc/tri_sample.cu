// Trilinear sampling of a channels-last volume at per-sample (x, y, z),
// f32, zeros padding, align-corners voxel units, for sm_90a.
//
// Replaces the Pallas TPU kernel _tri_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/tri_sample.py:231), entry fused_tri_sample
// (:161). On the TPU the gather had to become a (z-window x y-band) slab
// DMA plus interpolation matmuls, exact only when every tap fell inside
// the windows; here it is a direct gather, exact everywhere.
//
// What bounds it on an H100: memory. Each sample reads 12 bytes of
// coordinates and writes C floats; the eight taps come mostly from L1/L2,
// because neighbouring samples (the depth samples of one ray, then the
// next ray) hit neighbouring voxels. The interpolation is ~2 flops per
// channel per tap. The design is one thread per (sample, group of 4
// channels): each tap is one 16-byte load of the channels-last volume
// (C = 8 gives two threads per sample and two loads per tap), and a warp
// writes one contiguous run of 16-byte vectors. The coordinates are clamped
// to [-2, size+1] before floor, as in the Pallas kernel (tri_sample.py:89-91)
// and the plain version: taps that far out carry zero weight either way,
// and the clamp keeps the float->int conversion of behind-camera samples
// defined. The tap weights and their sum follow the plain version
// (sampling.grid_sample_3d) operation by operation, so both agree exactly.

#include <cuda_runtime.h>

namespace {

__global__ void tri_sample_kernel(
    const float* __restrict__ vol,  // (B, D, H, W, C)
    const float* __restrict__ xyz,  // (B, P, 3)
    float* __restrict__ out,        // (B, P, C)
    int B, int D, int H, int W, int C, long long P) {
  const int G = C >> 2;  // float4 groups per voxel
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * P * G) return;
  const int g = (int)(t % G);
  const long long s = t / G;  // (b, p) row-major
  const int b = (int)(s / P);
  const float x = fminf(fmaxf(xyz[s * 3 + 0], -2.f), W + 1.f);
  const float y = fminf(fmaxf(xyz[s * 3 + 1], -2.f), H + 1.f);
  const float z = fminf(fmaxf(xyz[s * 3 + 2], -2.f), D + 1.f);
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  const float tx = __fsub_rn(x, x0f), ty = __fsub_rn(y, y0f), tz = __fsub_rn(z, z0f);
  const int x0 = (int)x0f, y0 = (int)y0f, z0 = (int)z0f;
  const float4* v4 = reinterpret_cast<const float4*>(vol + (long long)b * D * H * W * C);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xi = x0 + dx, yi = y0 + dy, zi = z0 + dz;
        if (xi < 0 || xi > W - 1 || yi < 0 || yi > H - 1 || zi < 0 || zi > D - 1) continue;
        const float w = __fmul_rn(__fmul_rn(dx ? tx : __fsub_rn(1.f, tx), dy ? ty : __fsub_rn(1.f, ty)),
                                  dz ? tz : __fsub_rn(1.f, tz));
        const float4 v = v4[(((long long)zi * H + yi) * W + xi) * G + g];
        acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
        acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
        acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
        acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
      }
    }
  }
  reinterpret_cast<float4*>(out)[t] = acc;
}

}  // namespace

extern "C" int tri_sample_launch(const void* vol, const void* xyz, void* out, int B, int D,
                                 int H, int W, int C, long long P, void* stream) {
  if (C % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * P * (C / 4);
  if (n == 0) return 0;
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  tri_sample_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (const float*)xyz, (float*)out, B, D, H, W, C, P);
  return (int)cudaGetLastError();
}
