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
// adds 4 C floats into d imgs; the arithmetic is ~18 flops per channel. The
// image cotangent is a scatter into source pixels shared by neighbouring
// samples: one atomicAdd per channel per tap whose result is unused, so it
// compiles to a fire-and-forget reduction (RED) in L2; taps of zero weight
// are skipped.
//
// Design (the forward's, csrc/img_sample.cu): a block takes a tile of
// samples in three passes. First one thread per sample computes its four tap
// offsets, weights and validities, tx, ty and the masks of d x and d y into
// shared memory, in the forward's rounding order. Then the block's threads
// walk the tile's (sample, channel) elements in order: each loads its
// cotangent (a warp reads one contiguous run), adds its four shares to
// d imgs (a warp's reductions hit runs of contiguous addresses) and writes
// its channel's terms of d x and d y to shared memory, [sample][channel].
// Last one thread per sample sums its C terms in channel order and applies
// the masks, so d x and d y need no atomic and come out the same in every
// run; only d imgs keeps the run-to-run order of atomics. The tile is as
// many samples as fit C terms each into a fixed share of shared memory (3,072
// floats per derivative: 87 samples at C = 35, 256 at C = 11).
//
// Why: one thread per sample over its C channels, the first design, made
// each of a warp's loads and reductions touch 32 different 128-byte lines
// (4*C bytes apart); at C = 35 it took 3.8 ms, 1.5x the backward of
// F.grid_sample on NCHW maps (NVIDIA H100 80GB HBM3, 700.00 W,
// chip_smoke.py).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 256;        // samples per block at most
constexpr int kTermFloats = 3072;    // d x terms per block (as many for d y)
constexpr int kDx = 16, kDy = 32;    // flag bits beside the 4 tap validities

__global__ void __launch_bounds__(kThreads) img_sample_bwd_kernel(
    const float* __restrict__ imgs,  // (V, H, W, C)
    const float* __restrict__ xs,    // (V, P)
    const float* __restrict__ ys,    // (V, P)
    const float* __restrict__ g,     // (V, P, C)
    float* __restrict__ dimgs,       // (V, H, W, C), zeroed
    float* __restrict__ dxs,         // (V, P)
    float* __restrict__ dys,         // (V, P)
    int V, int H, int W, int C, long long P, int border, int tile, int Cp) {
  // shared memory: per sample 4 tap offsets (64-bit), 4 weights, tx, ty and
  // the flags; then the tile's d x and d y terms, sample s at s * Cp (Cp is
  // C made odd, so the per-sample sums read distinct banks)
  extern __shared__ long long smem[];
  long long* s_off = smem;                              // [4][tile]
  float* s_w = reinterpret_cast<float*>(s_off + 4 * tile);  // [4][tile]
  float* s_tx = s_w + 4 * tile;
  float* s_ty = s_tx + tile;
  int* s_flags = reinterpret_cast<int*>(s_ty + tile);
  float* s_px = reinterpret_cast<float*>(s_flags + tile);  // [tile][Cp]
  float* s_py = s_px + tile * Cp;

  const long long t0 = (long long)blockIdx.x * tile;
  const int ns = (int)min((long long)tile, (long long)V * P - t0);

  for (int i = threadIdx.x; i < ns; i += kThreads) {
    const long long t = t0 + i;
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
    // bit k: tap k lies inside the image (its value counts); 0 with zeros
    // padding for a tap outside, whose weight is then 0 as well
    int flags = 15;
    if (!border) {
      const bool vx0 = x0 >= 0 && x0 <= W - 1, vx1 = x1 >= 0 && x1 <= W - 1;
      const bool vy0 = y0 >= 0 && y0 <= H - 1, vy1 = y1 >= 0 && y1 <= H - 1;
      if (!(vy0 && vx0)) { w00 = 0.f; flags &= ~1; }
      if (!(vy0 && vx1)) { w01 = 0.f; flags &= ~2; }
      if (!(vy1 && vx0)) { w10 = 0.f; flags &= ~4; }
      if (!(vy1 && vx1)) { w11 = 0.f; flags &= ~8; }
    }
    if (mx && tx != 0.f) flags |= kDx;
    if (my && ty != 0.f) flags |= kDy;
    x0 = min(max(x0, 0), W - 1); x1 = min(max(x1, 0), W - 1);
    y0 = min(max(y0, 0), H - 1); y1 = min(max(y1, 0), H - 1);
    const long long base = (long long)v * H * W;
    s_off[0 * tile + i] = (base + (long long)y0 * W + x0) * C;
    s_off[1 * tile + i] = (base + (long long)y0 * W + x1) * C;
    s_off[2 * tile + i] = (base + (long long)y1 * W + x0) * C;
    s_off[3 * tile + i] = (base + (long long)y1 * W + x1) * C;
    s_w[0 * tile + i] = w00; s_w[1 * tile + i] = w01;
    s_w[2 * tile + i] = w10; s_w[3 * tile + i] = w11;
    s_tx[i] = tx; s_ty[i] = ty; s_flags[i] = flags;
  }
  __syncthreads();

  // element e = s * C + c of the tile; (s, c) advance by (ds, dc) per step
  const float* gt = g + t0 * C;
  const int ne = ns * C, ds = kThreads / C, dc = kThreads % C;
  int s = threadIdx.x / C, c = threadIdx.x % C;
  for (int e = threadIdx.x; e < ne; e += kThreads) {
    const float gc = gt[e];
    const long long o00 = s_off[0 * tile + s] + c, o01 = s_off[1 * tile + s] + c;
    const long long o10 = s_off[2 * tile + s] + c, o11 = s_off[3 * tile + s] + c;
    const float w00 = s_w[0 * tile + s], w01 = s_w[1 * tile + s];
    const float w10 = s_w[2 * tile + s], w11 = s_w[3 * tile + s];
    if (w00 != 0.f) atomicAdd(dimgs + o00, gc * w00);
    if (w01 != 0.f) atomicAdd(dimgs + o01, gc * w01);
    if (w10 != 0.f) atomicAdd(dimgs + o10, gc * w10);
    if (w11 != 0.f) atomicAdd(dimgs + o11, gc * w11);
    const int flags = s_flags[s];
    float px = 0.f, py = 0.f;
    if (flags & (kDx | kDy)) {
      const float tx = s_tx[s], ty = s_ty[s];
      const float p00 = (flags & 1 ? 1.f : 0.f) * imgs[o00];
      const float p01 = (flags & 2 ? 1.f : 0.f) * imgs[o01];
      const float p10 = (flags & 4 ? 1.f : 0.f) * imgs[o10];
      const float p11 = (flags & 8 ? 1.f : 0.f) * imgs[o11];
      px = gc * ((1.f - ty) * (p01 - p00) + ty * (p11 - p10));
      py = gc * ((1.f - tx) * (p10 - p00) + tx * (p11 - p01));
    }
    s_px[s * Cp + c] = px;
    s_py[s * Cp + c] = py;
    s += ds;
    c += dc;
    if (c >= C) { c -= C; ++s; }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < ns; i += kThreads) {
    const float* px = s_px + i * Cp;
    const float* py = s_py + i * Cp;
    float gx = 0.f, gy = 0.f;
    for (int k = 0; k < C; ++k) {
      gx += px[k];
      gy += py[k];
    }
    const int flags = s_flags[i];
    dxs[t0 + i] = flags & kDx ? gx : 0.f;
    dys[t0 + i] = flags & kDy ? gy : 0.f;
  }
}

}  // namespace

extern "C" int img_sample_bwd_launch(const void* imgs, const void* xs, const void* ys,
                                     const void* g, void* dimgs, void* dxs, void* dys, int V,
                                     int H, int W, int C, long long P, int border,
                                     void* stream) {
  const long long n = (long long)V * P;
  if (n == 0) return 0;
  if (C == 0) {  // no channel: d imgs stays zero, and so do the coordinate sums
    cudaMemsetAsync(dxs, 0, n * sizeof(float), (cudaStream_t)stream);
    cudaMemsetAsync(dys, 0, n * sizeof(float), (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  const int Cp = C | 1;
  const int tile = std::max(1, std::min(kMaxTile, kTermFloats / Cp));
  const size_t smem = (size_t)tile * (4 * sizeof(long long) + 7 * sizeof(float)) +
                      2 * (size_t)tile * Cp * sizeof(float);
  if (smem > 48 * 1024) {  // only for C above ~6,000
    const cudaError_t err = cudaFuncSetAttribute(
        img_sample_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = (n + tile - 1) / tile;
  img_sample_bwd_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)imgs, (const float*)xs, (const float*)ys, (const float*)g, (float*)dimgs,
      (float*)dxs, (float*)dys, V, H, W, C, P, border, tile, Cp);
  return (int)cudaGetLastError();
}
