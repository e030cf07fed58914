// Bilinear sampling of V channels-last maps at per-sample (x, y), f32,
// border or zeros padding, for sm_90a.
//
// Replaces the Pallas TPU kernel _sample_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/img_sample.py:431), entry fused_row_sample
// (:323). On the TPU the gather had to become banded interpolation matmuls,
// exact only when every tap fell inside the band; here it is a direct
// gather, exact everywhere.
//
// What bounds it on an H100: memory. Each sample reads its (x, y) and four
// taps of C channels and writes C channels once; the interpolation is ~7
// flops per channel. The design is one thread per (view, sample): the
// coordinates are read once, the four taps are gathered from the
// channels-last map (neighbouring samples hit neighbouring pixels, so the
// taps mostly come from L1/L2), and a warp writes one contiguous run of
// 32*C floats of the channels-last output. The tap weights and their sum
// follow the plain version (sampling.grid_sample_2d) operation by operation.

#include <cuda_runtime.h>

namespace {

__global__ void img_sample_kernel(
    const float* __restrict__ imgs,  // (V, H, W, C)
    const float* __restrict__ xs,    // (V, P)
    const float* __restrict__ ys,    // (V, P)
    float* __restrict__ out,         // (V, P, C)
    int V, int H, int W, int C, long long P, int border) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)V * P) return;
  const int v = (int)(t / P);
  float x = xs[t], y = ys[t];
  if (border) {
    x = fminf(fmaxf(x, 0.f), (float)(W - 1));
    y = fminf(fmaxf(y, 0.f), (float)(H - 1));
  } else {
    // taps beyond [-2, size+1] carry zero weight; the clamp keeps the
    // float->int conversion defined
    x = fminf(fmaxf(x, -2.f), W + 1.f);
    y = fminf(fmaxf(y, -2.f), H + 1.f);
  }
  const float x0f = floorf(x), y0f = floorf(y);
  const float tx = __fsub_rn(x, x0f), ty = __fsub_rn(y, y0f);
  int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
  float w00 = __fmul_rn(__fsub_rn(1.f, ty), __fsub_rn(1.f, tx));
  float w01 = __fmul_rn(__fsub_rn(1.f, ty), tx);
  float w10 = __fmul_rn(ty, __fsub_rn(1.f, tx));
  float w11 = __fmul_rn(ty, tx);
  if (!border) {
    const bool vx0 = x0 >= 0 && x0 <= W - 1, vx1 = x1 >= 0 && x1 <= W - 1;
    const bool vy0 = y0 >= 0 && y0 <= H - 1, vy1 = y1 >= 0 && y1 <= H - 1;
    if (!(vy0 && vx0)) w00 = 0.f;
    if (!(vy0 && vx1)) w01 = 0.f;
    if (!(vy1 && vx0)) w10 = 0.f;
    if (!(vy1 && vx1)) w11 = 0.f;
  }
  x0 = min(max(x0, 0), W - 1); x1 = min(max(x1, 0), W - 1);
  y0 = min(max(y0, 0), H - 1); y1 = min(max(y1, 0), H - 1);
  const float* img = imgs + (long long)v * H * W * C;
  const float* p00 = img + ((long long)y0 * W + x0) * C;
  const float* p01 = img + ((long long)y0 * W + x1) * C;
  const float* p10 = img + ((long long)y1 * W + x0) * C;
  const float* p11 = img + ((long long)y1 * W + x1) * C;
  float* o = out + t * C;
  for (int c = 0; c < C; ++c) {
    float acc = __fmul_rn(p00[c], w00);
    acc = __fadd_rn(acc, __fmul_rn(p01[c], w01));
    acc = __fadd_rn(acc, __fmul_rn(p10[c], w10));
    o[c] = __fadd_rn(acc, __fmul_rn(p11[c], w11));
  }
}

}  // namespace

extern "C" int img_sample_launch(const void* imgs, const void* xs, const void* ys, void* out,
                                 int V, int H, int W, int C, long long P, int border,
                                 void* stream) {
  const long long n = (long long)V * P;
  if (n == 0) return 0;
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  img_sample_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)imgs, (const float*)xs, (const float*)ys, (float*)out, V, H, W, C, P,
      border);
  return (int)cudaGetLastError();
}
