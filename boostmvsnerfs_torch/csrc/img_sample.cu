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
// flops per channel. The maps are channels-last with C = 35, 11 or 3 on the
// model paths, rows of 140, 44 or 12 bytes that do not split into 16-byte
// vectors.
//
// Design (img_sample_kernel): a block takes a tile of kTile samples. One
// thread per sample reads its coordinates, clamps them and computes its four
// taps (the offset of the first and the steps to the others) and their
// weights into shared memory. Then the block's threads walk the tile's
// kTile * C output elements in order, one (sample, channel) each: a warp's
// 32 stores are one contiguous run of the output, and its tap loads are runs
// of C floats per tap, which neighbouring samples (the depth samples of one
// ray, then the next ray) share in L1/L2. Each thread issues the loads of
// kBatch elements before it uses them, so a small grid (a ray block of the
// fine-tuning step, ~2,000 tiles) is not held to one load latency per
// element. The tile's sample and channel indices advance by increments, with
// no division per element; map and output offsets are 64-bit.
//
// Why: one thread per sample over its C channels, the first design, put a
// warp's stores and tap loads 4*C bytes apart; at C = 35 it ran at 6% of its
// bytes bound, 6x slower than F.grid_sample on NCHW maps (NVIDIA H100 80GB
// HBM3, 700.00 W, chip_smoke.py). Rows of at most kDirectC channels keep
// that mapping (img_sample_kernel_rows): a warp's 32 samples then write one
// contiguous run of 32*C floats anyway, and a thread's 4*C independent loads
// hide latency better than staging does (the MVSNeRF colour lookup, C = 3,
// 12 x 2,523,136 samples: 0.47 ms against 0.57 ms staged, same card).
//
// The tap weights and their sum follow the plain version
// (sampling.grid_sample_2d) operation by operation, with no contraction into
// FMAs, so both agree exactly.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;   // samples per block
constexpr int kBatch = 4;    // elements whose loads a thread issues together
constexpr int kDirectC = 4;  // up to this many channels, one thread per sample
static_assert(kTile == kThreads, "one thread per sample of a tile (and of a rows block)");

// The four bilinear taps of sample t: the element offset of tap 00 in imgs,
// the steps to the taps of the next column and row (0 where the index is
// clamped), and their weights (0 for a tap outside the image with zeros
// padding), in the plain version's rounding order.
__device__ __forceinline__ void sample_taps(const float* __restrict__ xs,
                                            const float* __restrict__ ys, long long t, int H,
                                            int W, int C, long long P, int border,
                                            long long& o00, int& dx, int& dy, float4& w) {
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
  w = make_float4(__fmul_rn(__fsub_rn(1.f, ty), __fsub_rn(1.f, tx)),
                  __fmul_rn(__fsub_rn(1.f, ty), tx), __fmul_rn(ty, __fsub_rn(1.f, tx)),
                  __fmul_rn(ty, tx));
  if (!border) {
    const bool vx0 = x0 >= 0 && x0 <= W - 1, vx1 = x1 >= 0 && x1 <= W - 1;
    const bool vy0 = y0 >= 0 && y0 <= H - 1, vy1 = y1 >= 0 && y1 <= H - 1;
    if (!(vy0 && vx0)) w.x = 0.f;
    if (!(vy0 && vx1)) w.y = 0.f;
    if (!(vy1 && vx0)) w.z = 0.f;
    if (!(vy1 && vx1)) w.w = 0.f;
  }
  x0 = min(max(x0, 0), W - 1); x1 = min(max(x1, 0), W - 1);
  y0 = min(max(y0, 0), H - 1); y1 = min(max(y1, 0), H - 1);
  o00 = ((long long)v * H * W + (long long)y0 * W + x0) * C;
  dx = (x1 - x0) * C;
  dy = (y1 - y0) * W * C;
}

// The weighted sum of one channel's four tap values, in the plain version's
// order, with no contraction into FMAs.
__device__ __forceinline__ float blend(float p00, float p01, float p10, float p11, float4 w) {
  float acc = __fmul_rn(p00, w.x);
  acc = __fadd_rn(acc, __fmul_rn(p01, w.y));
  acc = __fadd_rn(acc, __fmul_rn(p10, w.z));
  return __fadd_rn(acc, __fmul_rn(p11, w.w));
}

// Rows of at most kDirectC channels: one thread per sample over its channels.
__global__ void __launch_bounds__(kThreads) img_sample_kernel_rows(
    const float* __restrict__ imgs, const float* __restrict__ xs, const float* __restrict__ ys,
    float* __restrict__ out, int V, int H, int W, int C, long long P, int border) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)V * P) return;
  long long o00;
  int dx, dy;
  float4 w;
  sample_taps(xs, ys, t, H, W, C, P, border, o00, dx, dy, w);
  const float* p = imgs + o00;
  for (int c = 0; c < C; ++c)
    out[t * C + c] = blend(p[c], p[c + dx], p[c + dy], p[c + dy + dx], w);
}

struct __align__(16) Taps {
  long long o00;
  int dx, dy;
};

// Wider rows: a tile of kTile samples, then one thread per (sample, channel).
__global__ void __launch_bounds__(kThreads) img_sample_kernel(
    const float* __restrict__ imgs,  // (V, H, W, C)
    const float* __restrict__ xs,    // (V, P)
    const float* __restrict__ ys,    // (V, P)
    float* __restrict__ out,         // (V, P, C)
    int V, int H, int W, int C, long long P, int border) {
  __shared__ Taps s_taps[kTile];
  __shared__ float4 s_w[kTile];
  const long long t0 = (long long)blockIdx.x * kTile;
  const int ns = (int)min((long long)kTile, (long long)V * P - t0);
  for (int i = threadIdx.x; i < ns; i += kThreads) {
    Taps tp;
    sample_taps(xs, ys, t0 + i, H, W, C, P, border, tp.o00, tp.dx, tp.dy, s_w[i]);
    s_taps[i] = tp;
  }
  __syncthreads();

  // element e = s * C + c of the tile; (s, c) advance by (ds, dc) per thread step
  float* o = out + t0 * C;
  const int ne = ns * C, ds = kThreads / C, dc = kThreads % C;
  int s = threadIdx.x / C, c = threadIdx.x % C;
  for (int e = threadIdx.x; e < ne; e += kBatch * kThreads) {
    float p[kBatch][4];
    float4 w[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (e + k * kThreads < ne) {
        const Taps tp = s_taps[s];
        const float* q = imgs + tp.o00 + c;
        p[k][0] = q[0];
        p[k][1] = q[tp.dx];
        p[k][2] = q[tp.dy];
        p[k][3] = q[tp.dy + tp.dx];
        w[k] = s_w[s];
      }
      s += ds;
      c += dc;
      if (c >= C) { c -= C; ++s; }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (e + k * kThreads < ne)
        o[e + k * kThreads] = blend(p[k][0], p[k][1], p[k][2], p[k][3], w[k]);
    }
  }
}

}  // namespace

extern "C" int img_sample_launch(const void* imgs, const void* xs, const void* ys, void* out,
                                 int V, int H, int W, int C, long long P, int border,
                                 void* stream) {
  const long long n = (long long)V * P;
  if (n == 0 || C == 0) return 0;
  if ((long long)W * C > INT_MAX) return (int)cudaErrorInvalidValue;  // a row step is an int
  auto kernel = C <= kDirectC ? img_sample_kernel_rows : img_sample_kernel;
  const long long grid = (n + kTile - 1) / kTile;
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)imgs, (const float*)xs, (const float*)ys, (float*)out, V, H, W, C, P,
      border);
  return (int)cudaGetLastError();
}
