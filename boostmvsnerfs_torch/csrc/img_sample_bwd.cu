// Backward of the bilinear sampling of V channels-last maps at per-sample
// (x, y), f32, border or zeros padding, for sm_90a.
//
// Replaces the Pallas TPU kernel _sample_bwd_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/img_sample.py:742), entry
// _row_sample_bwd_impl (:664), the backward of fused_row_sample_diff: given
// the output cotangent g (V, P, C), it returns
//
//   d imgs (V, H, W, C): g scattered to each sample's four taps with their
//     bilinear weights;
//   d x, d y (V, P): the derivatives of the triangle weights, summed over
//     channels, for the caller's chain into projected coordinates and depth.
//
// Conventions of the Pallas kernel (trap: they differ from autodiff of a
// floor-based sampler at exact integers and clamp bounds): the derivative of
// a triangle weight max(0, 1 - |j - x|) is sign(j - x) where |j - x| < 1 and
// 0 elsewhere, so d x = 0 at an integer x; a coordinate carries a gradient
// only inside its clamp range, bounds included ([0, W-1] with border
// padding, [-2, W+1] with zeros). Coordinates are clamped before floor, as in
// the forward, which keeps the float->int conversion of behind-camera
// projections defined.
//
// What bounds it on an H100: memory and atomics. It reads each sample's
// (x, y), C cotangents and four taps of C channels, writes d x, d y once and
// adds 4 C floats into d imgs; the arithmetic is ~10 flops per channel. The
// image cotangent is a scatter into source pixels shared by neighbouring
// samples, so it is one atomicAdd per channel per tap (taps of zero weight
// are skipped). The design mirrors the forward (csrc/img_sample.cu): one
// thread per (view, sample) recomputes the taps in the forward's rounding
// order and loops over the channels, so d x and d y are per-thread sums and
// need no atomic. (C is 35 and 11 on the training path: not a multiple of 4,
// so there are no 16-byte rows to split across threads.)

#include <cuda_runtime.h>

namespace {

__global__ void img_sample_bwd_kernel(
    const float* __restrict__ imgs,  // (V, H, W, C)
    const float* __restrict__ xs,    // (V, P)
    const float* __restrict__ ys,    // (V, P)
    const float* __restrict__ g,     // (V, P, C)
    float* __restrict__ dimgs,       // (V, H, W, C), zeroed
    float* __restrict__ dxs,         // (V, P)
    float* __restrict__ dys,         // (V, P)
    int V, int H, int W, int C, long long P, int border) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)V * P) return;
  const int v = (int)(t / P);
  const float xr = xs[t], yr = ys[t];
  float x, y;
  bool mx, my;
  if (border) {
    x = fminf(fmaxf(xr, 0.f), (float)(W - 1));
    y = fminf(fmaxf(yr, 0.f), (float)(H - 1));
    mx = xr >= 0.f && xr <= (float)(W - 1);
    my = yr >= 0.f && yr <= (float)(H - 1);
  } else {
    x = fminf(fmaxf(xr, -2.f), W + 1.f);
    y = fminf(fmaxf(yr, -2.f), H + 1.f);
    mx = xr >= -2.f && xr <= W + 1.f;
    my = yr >= -2.f && yr <= H + 1.f;
  }
  const float x0f = floorf(x), y0f = floorf(y);
  const float tx = __fsub_rn(x, x0f), ty = __fsub_rn(y, y0f);
  int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
  float w00 = __fmul_rn(__fsub_rn(1.f, ty), __fsub_rn(1.f, tx));
  float w01 = __fmul_rn(__fsub_rn(1.f, ty), tx);
  float w10 = __fmul_rn(ty, __fsub_rn(1.f, tx));
  float w11 = __fmul_rn(ty, tx);
  // per-tap value factor: 0 for a tap outside the image with zeros padding
  float f00 = 1.f, f01 = 1.f, f10 = 1.f, f11 = 1.f;
  if (!border) {
    const bool vx0 = x0 >= 0 && x0 <= W - 1, vx1 = x1 >= 0 && x1 <= W - 1;
    const bool vy0 = y0 >= 0 && y0 <= H - 1, vy1 = y1 >= 0 && y1 <= H - 1;
    if (!(vy0 && vx0)) w00 = f00 = 0.f;
    if (!(vy0 && vx1)) w01 = f01 = 0.f;
    if (!(vy1 && vx0)) w10 = f10 = 0.f;
    if (!(vy1 && vx1)) w11 = f11 = 0.f;
  }
  x0 = min(max(x0, 0), W - 1); x1 = min(max(x1, 0), W - 1);
  y0 = min(max(y0, 0), H - 1); y1 = min(max(y1, 0), H - 1);
  const long long base = (long long)v * H * W * C;
  const long long o00 = base + ((long long)y0 * W + x0) * C;
  const long long o01 = base + ((long long)y0 * W + x1) * C;
  const long long o10 = base + ((long long)y1 * W + x0) * C;
  const long long o11 = base + ((long long)y1 * W + x1) * C;
  const float* gr = g + t * C;
  const bool dx_on = mx && tx != 0.f, dy_on = my && ty != 0.f;
  float gx = 0.f, gy = 0.f;
  for (int c = 0; c < C; ++c) {
    const float gc = gr[c];
    if (w00 != 0.f) atomicAdd(dimgs + o00 + c, gc * w00);
    if (w01 != 0.f) atomicAdd(dimgs + o01 + c, gc * w01);
    if (w10 != 0.f) atomicAdd(dimgs + o10 + c, gc * w10);
    if (w11 != 0.f) atomicAdd(dimgs + o11 + c, gc * w11);
    if (dx_on || dy_on) {
      const float p00 = f00 * imgs[o00 + c], p01 = f01 * imgs[o01 + c];
      const float p10 = f10 * imgs[o10 + c], p11 = f11 * imgs[o11 + c];
      gx += gc * ((1.f - ty) * (p01 - p00) + ty * (p11 - p10));
      gy += gc * ((1.f - tx) * (p10 - p00) + tx * (p11 - p01));
    }
  }
  dxs[t] = dx_on ? gx : 0.f;
  dys[t] = dy_on ? gy : 0.f;
}

}  // namespace

extern "C" int img_sample_bwd_launch(const void* imgs, const void* xs, const void* ys,
                                     const void* g, void* dimgs, void* dxs, void* dys, int V,
                                     int H, int W, int C, long long P, int border,
                                     void* stream) {
  const long long n = (long long)V * P;
  if (n == 0) return 0;
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  img_sample_bwd_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)imgs, (const float*)xs, (const float*)ys, (const float*)g, (float*)dimgs,
      (float*)dxs, (float*)dys, V, H, W, C, P, border);
  return (int)cudaGetLastError();
}
