// Data gradient of a float32 3D convolution with kernel 3, padding 1 and
// stride 1 or 2, for sm_90a: the input gradient of a Conv3d, and the forward
// of a ConvTranspose3d (its weight read as the adjoint convolution's).
//
// Replaces no TPU kernel: the JAX package left the convolutions to XLA. It was
// added because cuDNN's float32 kernel for this operation on the networks'
// small-channel volumes (dgrad2d_grouped_direct) runs at a few percent of the
// card's float32 rate, in every eval frame (the U-Nets' transposed
// convolutions) and in every training step (the input gradients).
//
//   dX[n, iz, iy, ix, c] = sum over m, kz, ky, kx of
//       G[n, oz, oy, ox, m] * W[m, c, kz, ky, kx],   i + 1 - k = o * s
//
// with G the output's gradient (a transposed convolution's input), W the
// convolution's weight (M, C, 3, 3, 3), both G and dX channels-last, and the
// terms whose o is not a whole number inside G left out. As a GEMM: M' = the
// output voxels (millions), N' = C (1-64), and the reduction K' = M x 27.
//
// What bounds it on an H100: f32 operations on most layers (the largest of
// the ENeRF fine-tuning step, level 0's conv0, does 76 GFLOP against 0.9 GB:
// 1.1 ms at 67 TFLOP/s, 0.27 ms at 3.35 TB/s), bytes on the 8 -> 1 head and
// the stride-2 layers with 8 output channels. No tensor cores: operands and
// sums are float32, as the configurations state (no TF32).
//
// Design. Gather form: a thread owns 4 (stride 1) or 8 (stride 2) consecutive
// output voxels along x of one output row (n, iz, iy) and kTileC output
// channels, sums their taps in registers and writes each output once: no
// atomics, and two launches give the same bits. Stride 2 is split by parity,
// so that no zero-stuffed tap is ever multiplied: along x half the thread's
// outputs are even ones, which meet one tap (kx 1), and half odd ones, which
// meet two (kx 0 and 2); along z and y a row meets one or two taps by its
// parity, and the rows are numbered parity-major so that a block's threads
// share their tap pattern.
// Per (kz, ky) tap row and 4 channels m of G, a thread loads the window of G
// along x that its outputs read (6 voxels at stride 1, 5 at stride 2) with
// 16-byte loads, and every kx tap reads the window in registers: each voxel
// of G is loaded once for the three taps along x. The block's weight slice
// (27 x M x kTileC floats, zero past C) is staged once in shared memory,
// where the threads read it as broadcasts. G is read through L1 and L2: the
// rows of a block and of its neighbours read the same rows of G at their
// taps ky and kz, and the blocks of one run of outputs' channel tiles are
// launched side by side.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // blocks an SM holds: at most 128 registers
constexpr int kTileC = 8;      // output channels a thread owns
constexpr int kTaps = 27;

struct Geometry {
  int n, di, hi, wi, c;  // dX (n, di, hi, wi, c) channels-last
  int od, oh, ow, m;     // G (n, od, oh, ow, m) channels-last
  int sd, sh;            // strides along z and y (1 or 2); along x the template's
};

template <int MV>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float at(const T& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float at(const T& v, int) { return v; }
};

// Output voxels along x a thread owns: at stride 2 twice as many, for the
// same multiply-adds per weight load as at stride 1.
template <int S>
__host__ __device__ constexpr int out_x() {
  return S == 1 ? 4 : 8;
}

// The window slot of G that output t of a thread reads at tap kx, or -1: at
// stride 1 the window starts one voxel left of the thread's first output; at
// stride 2 at the G voxel of its first (even) output.
template <int S>
__host__ __device__ constexpr int slot(int t, int kx) {
  return S == 1 ? t + 2 - kx : ((t + 1 - kx) & 1) ? -1 : (t + 1 - kx) / 2;
}

// Index along a stride-2 axis of length len of the a-th row in parity-major
// order (the even rows first); the identity at stride 1.
__device__ __forceinline__ int parity_major(int a, int len, int s) {
  if (s == 1) return a;
  const int evens = (len + 1) / 2;
  return a < evens ? 2 * a : 2 * (a - evens) + 1;
}

template <int S, int MV>
__global__ void __launch_bounds__(kThreads, kMinBlocks) conv_dgrad_kernel(
    const float* __restrict__ g, const float* __restrict__ w, float* __restrict__ dx,
    Geometry q) {
  extern __shared__ float4 ws4[];  // [tap][m][kTileC] of this block's channels
  float* ws = reinterpret_cast<float*>(ws4);
  // the channel tiles of one run of outputs are neighbouring blocks, so that
  // they read G and write their rows of dX at about the same time
  const int ctiles = (q.c + kTileC - 1) / kTileC;
  const int c0 = (int)(blockIdx.x % ctiles) * kTileC;
  const int wn = kTaps * q.m * kTileC;
  for (int i = threadIdx.x; i < wn; i += kThreads) {
    const int cl = i % kTileC, mt = i / kTileC, m = mt % q.m, tap = mt / q.m;
    const int c = c0 + cl;
    ws[i] = c < q.c ? __ldg(w + ((long long)m * q.c + c) * kTaps + tap) : 0.f;
  }
  __syncthreads();

  constexpr int kOutX = out_x<S>();
  const int xtiles = (q.wi + kOutX - 1) / kOutX;
  const long long item = (long long)(blockIdx.x / ctiles) * kThreads + threadIdx.x;
  const long long rows = (long long)q.n * q.di * q.hi;
  if (item >= rows * xtiles) return;
  const int xt = (int)(item % xtiles);
  const long long row = item / xtiles;
  const int iy = parity_major((int)(row % q.hi), q.hi, q.sh);
  const int nz = (int)(row / q.hi);
  const int iz = parity_major(nz % q.di, q.di, q.sd), n = nz / q.di;

  constexpr int kWin = S == 1 ? kOutX + 2 : kOutX / 2 + 1;
  const int ob = S == 1 ? xt * kOutX - 1 : xt * (kOutX / 2);  // G voxel of window slot 0
  float acc[kOutX][kTileC] = {};
  using V = Vec<MV>;
  for (int kz = 0; kz < 3; ++kz) {
    const int tz = iz + 1 - kz;
    if (tz < 0 || (q.sd == 2 && (tz & 1))) continue;
    const int oz = tz / q.sd;
    if (oz >= q.od) continue;
    for (int ky = 0; ky < 3; ++ky) {
      const int ty = iy + 1 - ky;
      if (ty < 0 || (q.sh == 2 && (ty & 1))) continue;
      const int oy = ty / q.sh;
      if (oy >= q.oh) continue;
      const float* grow = g + (((long long)n * q.od + oz) * q.oh + oy) * q.ow * q.m;
      const float* wrow = ws + (kz * 3 + ky) * 3 * q.m * kTileC;
      for (int m0 = 0; m0 < q.m; m0 += MV) {
        typename V::T win[kWin];
#pragma unroll
        for (int d = 0; d < kWin; ++d) {
          const int o = ob + d;
          win[d] = o >= 0 && o < q.ow ? V::load(grow + (long long)o * q.m + m0) : V::zero();
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int mm = 0; mm < MV; ++mm) {
            const float4* wp =
                reinterpret_cast<const float4*>(wrow + (kx * q.m + m0 + mm) * kTileC);
            float wv[kTileC];
#pragma unroll
            for (int j = 0; j < kTileC / 4; ++j) {
              const float4 v = wp[j];
              wv[4 * j] = v.x, wv[4 * j + 1] = v.y, wv[4 * j + 2] = v.z, wv[4 * j + 3] = v.w;
            }
#pragma unroll
            for (int t = 0; t < kOutX; ++t) {
              const int d = slot<S>(t, kx);
              if (d < 0) continue;
              const float gv = V::at(win[d], mm);
#pragma unroll
              for (int j = 0; j < kTileC; ++j) acc[t][j] = fmaf(gv, wv[j], acc[t][j]);
            }
          }
        }
      }
    }
  }

  const bool vec = q.c % 4 == 0 && c0 + kTileC <= q.c;
  float* out = dx + (((long long)n * q.di + iz) * q.hi + iy) * q.wi * q.c + c0;
#pragma unroll
  for (int t = 0; t < kOutX; ++t) {
    const int ix = xt * kOutX + t;
    if (ix >= q.wi) break;
    float* p = out + (long long)ix * q.c;
    if (vec) {
#pragma unroll
      for (int j = 0; j < kTileC; j += 4)
        *reinterpret_cast<float4*>(p + j) =
            make_float4(acc[t][j], acc[t][j + 1], acc[t][j + 2], acc[t][j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTileC; ++j)
        if (c0 + j < q.c) p[j] = acc[t][j];
    }
  }
}

template <int S, int MV>
cudaError_t launch(const float* g, const float* w, float* dx, const Geometry& q,
                   cudaStream_t s) {
  const long long items = (long long)q.n * q.di * q.hi * ((q.wi + out_x<S>() - 1) / out_x<S>());
  const int smem = kTaps * q.m * kTileC * (int)sizeof(float);
  auto kernel = conv_dgrad_kernel<S, MV>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned grid =
      (unsigned)((items + kThreads - 1) / kThreads) * (unsigned)((q.c + kTileC - 1) / kTileC);
  kernel<<<grid, kThreads, smem, s>>>(g, w, dx, q);
  return cudaGetLastError();
}

}  // namespace

// dx (n, di, hi, wi, c) channels-last from g (n, od, oh, ow, m) channels-last
// and the weight (m, c, 3, 3, 3) contiguous; padding 1, strides sd, sh, sw of
// 1 or 2. g's channels are read 4 at a time with 16-byte loads where m % 4 ==
// 0 (its base 16-byte aligned), one at a time otherwise.
extern "C" int conv_dgrad_launch(const void* g, const void* w, void* dx, int n, int di, int hi,
                                 int wi, int c, int od, int oh, int ow, int m, int sd, int sh,
                                 int sw, void* stream) {
  const Geometry q{n, di, hi, wi, c, od, oh, ow, m, sd, sh};
  if (sd < 1 || sd > 2 || sh < 1 || sh > 2 || sw < 1 || sw > 2 || m < 1 || c < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)n * di * hi * wi == 0) return 0;
  const float* gf = (const float*)g;
  const float* wf = (const float*)w;
  float* xf = (float*)dx;
  cudaStream_t s = (cudaStream_t)stream;
  const bool v4 = m % 4 == 0 && ((unsigned long long)g & 15) == 0;
  cudaError_t err;
  if (sw == 1)
    err = v4 ? launch<1, 4>(gf, wf, xf, q, s) : launch<1, 1>(gf, wf, xf, q, s);
  else
    err = v4 ? launch<2, 4>(gf, wf, xf, q, s) : launch<2, 1>(gf, wf, xf, q, s);
  return (int)err;
}
