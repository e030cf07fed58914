// Weight gradient of a float32 convolution (3D; 2D as depth 1; a transposed
// convolution as its adjoint), for sm_90a.
//
// Replaces no TPU kernel: the JAX package left the convolutions' backward to
// XLA. It was added because cuDNN's float32 weight gradient for the networks'
// small-channel convolutions (wgrad2d_grouped_direct) gives each weight
// element one thread and loops it over every voxel of the batch: a few
// thousand threads each running a loop of millions of steps, so most of the
// card idles, and the fine-tuning step spent half its time there.
//
//   dW[m, c, kz, ky, kx] = sum over n, oz, oy, ox of
//       G[n, oz, oy, ox, m] * X[n, oz*sd - pd + kz, oy*sh - ph + ky, ox*sw - pw + kx, c]
//
// with G the output's gradient and X the input, both channels-last, X zero
// outside. As a GEMM: M = the output channels (1-64), N = input channels x
// taps (8-1,728), and the reduction K = the batch's output voxels (tens of
// thousands to ~11 million). A transposed convolution's weight gradient is
// the same sum with the roles swapped: its input is G and the gradient of its
// output is X (the wrapper swaps them).
//
// What bounds it on an H100: f32 operations. Each (voxel, m, c, tap) is one
// FMA, while each voxel's channels are read once from memory: the largest
// layers of the fine-tuning step need ~70 GFLOP against ~1 GB (1.1 ms at
// 67 TFLOP/s, 0.3 ms at 3.35 TB/s). No tensor cores: the operands and the sums
// are float32, as the configurations state (no TF32).
//
// Design. Split K, which is long, not the small weight. A thread owns TM output
// channels, 4 input channels and one tap (conv_wgrad_kernel), or the three
// taps along x of one (kz, ky) where kw = 3, pw = 1 and the stride along x is
// 1 or 2 (conv_wgrad_kernel_row3: most layers), with TM x 4 sums per tap in
// registers, and walks a slice of the output voxels along x: per voxel TM of
// G's channels and 4 of X's at its taps, 16-byte loads, then TM x 4 FMAs a
// tap. In the three-tap kernel a window of three input vectors slides along
// x, so each is loaded once for the taps that read it. The threads of one
// slice (consecutive thread indices, taps outermost) walk the same voxels in
// step, so G's loads are broadcasts and X's, the same voxels' channels at
// neighbouring taps, hit L1: L1 stages the tiles, with no shared memory and
// no barrier. A slice is a few output rows (n, oz, oy), walked a tile of
// kTileX columns at a time over all its rows, so that an input row is still
// in L1 when the next output rows read it at their taps ky. The slices are as
// many as give the card about kSliceThreadsPerSm threads an SM; each writes
// its partial sums to a scratch buffer (slice, m, c, tap), and a second kernel
// adds them in slice order, kRedRuns interleaved runs per output combined in a
// fixed order. No atomics: two runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRedOut = 32;    // outputs per block of the reduction
constexpr int kRedRuns = kThreads / kRedOut;  // interleaved runs of slices per output
constexpr int kTileX = 32;     // outputs along x a slice walks before its next row
constexpr int kRowThreads = 128;  // a block of the three-tap kernel
constexpr int kRowMinBlocks = 5;  // its blocks an SM holds: at most 96 registers, no spill
constexpr int kRowMaxTm = 4;      // its output channels per thread, at most
constexpr int kSliceThreadsPerSm = 2048;  // threads a launch aims for per SM

struct Geometry {
  int n, di, hi, wi, cx;  // X (n, di, hi, wi, cx) channels-last, cx % 4 == 0
  int od, oh, ow, cg;     // G (n, od, oh, ow, cg) channels-last, cg % TM == 0
  int kd, kh, kw;         // taps
  int sd, sh, sw;         // strides
  int pd, ph, pw;         // paddings
  int slices, rows_per_slice;  // rows are (n, oz, oy)
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// G's TM channels at p: 16-byte loads, or one float for TM = 1
template <int TM>
__device__ __forceinline__ void load_g(const float* __restrict__ p, float (&gs)[TM]) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = ld4(p + i);
      gs[i] = v.x, gs[i + 1] = v.y, gs[i + 2] = v.z, gs[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) gs[i] = __ldg(p + i);
  }
}

template <int TM>
__device__ __forceinline__ void fma_tap(float (&acc)[TM][4], const float (&gs)[TM], float4 v) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    acc[i][0] = fmaf(gs[i], v.x, acc[i][0]);
    acc[i][1] = fmaf(gs[i], v.y, acc[i][1]);
    acc[i][2] = fmaf(gs[i], v.z, acc[i][2]);
    acc[i][3] = fmaf(gs[i], v.w, acc[i][3]);
  }
}

// The partial sums of taps [tap0, tap0 + K) of a thread into its slice's part.
template <int TM, int K>
__device__ __forceinline__ void store_part(float* __restrict__ part, const Geometry& q, int taps,
                                           int slice, int mt, int cq, int tap0,
                                           const float (&acc)[K][TM][4]) {
  float* out = part + (long long)slice * q.cg * q.cx * taps;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[((long long)(mt * TM + i) * q.cx + cq * 4 + j) * taps + tap0 + k] = acc[k][i][j];
}

template <int TM>
__global__ void __launch_bounds__(kThreads) conv_wgrad_kernel(const float* __restrict__ x,
                                                              const float* __restrict__ g,
                                                              float* __restrict__ part,
                                                              Geometry q) {
  const int mtiles = q.cg / TM, cquads = q.cx / 4, taps = q.kd * q.kh * q.kw;
  const int combos = mtiles * cquads * taps;
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int slice = (int)(gid / combos);
  if (slice >= q.slices) return;
  const int combo = (int)(gid - (long long)slice * combos);
  const int mt = combo % mtiles;
  const int cq = (combo / mtiles) % cquads;
  const int tap = combo / (mtiles * cquads);
  const int kx = tap % q.kw, ky = (tap / q.kw) % q.kh, kz = tap / (q.kw * q.kh);
  // the outputs ox whose input column ox*sw - pw + kx lies in [0, wi)
  const int lo = q.pw - kx, hi = q.wi - 1 + q.pw - kx;
  const int ox0 = lo > 0 ? (lo + q.sw - 1) / q.sw : 0;
  const int ox1 = hi < 0 ? 0 : min(q.ow, hi / q.sw + 1);

  float acc[1][TM][4] = {};
  const int rows = q.n * q.od * q.oh;
  const int r0 = slice * q.rows_per_slice, r1 = min(rows, r0 + q.rows_per_slice);
  const long long xstep = (long long)q.sw * q.cx;
  for (int xt = 0; xt < q.ow; xt += kTileX) {
    const int xa = max(ox0, xt), xb = min(ox1, xt + kTileX);
    if (xa >= xb) continue;
    for (int r = r0; r < r1; ++r) {
      const int oy = r % q.oh, nz = r / q.oh, oz = nz % q.od, n = nz / q.od;
      const int iz = oz * q.sd - q.pd + kz, iy = oy * q.sh - q.ph + ky;
      if (iz < 0 || iz >= q.di || iy < 0 || iy >= q.hi) continue;
      const float* gp = g + ((long long)r * q.ow + xa) * q.cg + mt * TM;
      const float* xp = x + ((((long long)n * q.di + iz) * q.hi + iy) * q.wi +
                             (xa * q.sw - q.pw + kx)) * (long long)q.cx + cq * 4;
#pragma unroll 4
      for (int ox = xa; ox < xb; ++ox) {
        float gs[TM];
        load_g<TM>(gp, gs);
        fma_tap<TM>(acc[0], gs, ld4(xp));
        gp += q.cg;
        xp += xstep;
      }
    }
  }
  store_part<TM, 1>(part, q, taps, slice, mt, cq, tap, acc);
}

// conv_wgrad_kernel with the three taps kx of one (kz, ky) in one thread, for
// kw = 3, pw = 1 and sw = S of 1 or 2: output ox reads input columns S*ox - 1,
// S*ox and S*ox + 1, so a window of three 4-channel vectors slides along x, S
// new ones a step, and each input vector is loaded once for all the taps that
// read it: a third (S = 1) or two thirds (S = 2) of the loads and L1 traffic
// per FMA.
template <int TM, int S>
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks) conv_wgrad_kernel_row3(
    const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ part,
    Geometry q) {
  const int mtiles = q.cg / TM, cquads = q.cx / 4, trows = q.kd * q.kh;
  const int combos = mtiles * cquads * trows;
  const long long gid = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  const int slice = (int)(gid / combos);
  if (slice >= q.slices) return;
  const int combo = (int)(gid - (long long)slice * combos);
  const int mt = combo % mtiles;
  const int cq = (combo / mtiles) % cquads;
  const int tr = combo / (mtiles * cquads);
  const int ky = tr % q.kh, kz = tr / q.kh;

  float acc[3][TM][4] = {};
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int rows = q.n * q.od * q.oh;
  const int r0 = slice * q.rows_per_slice, r1 = min(rows, r0 + q.rows_per_slice);
  for (int xt = 0; xt < q.ow; xt += kTileX) {
    const int xb = min(q.ow, xt + kTileX);
    for (int r = r0; r < r1; ++r) {
      const int oy = r % q.oh, nz = r / q.oh, oz = nz % q.od, n = nz / q.od;
      const int iz = oz * q.sd - q.pd + kz, iy = oy * q.sh - q.ph + ky;
      if (iz < 0 || iz >= q.di || iy < 0 || iy >= q.hi) continue;
      const float* gp = g + ((long long)r * q.ow + xt) * q.cg + mt * TM;
      const float* xrow = x + (((long long)n * q.di + iz) * q.hi + iy) * (long long)q.wi * q.cx +
                          cq * 4;
      // the input vector at column c, zero outside the row
      auto col = [&](int c) {
        return c >= 0 && c < q.wi ? ld4(xrow + (long long)c * q.cx) : zero;
      };
      float4 w0 = col(S * xt - 1), w1 = S == 1 ? col(xt) : zero, w2;
#pragma unroll 2
      for (int ox = xt; ox < xb; ++ox) {
        if (S == 1) {
          w2 = col(ox + 1);
        } else {
          w1 = col(S * ox);
          w2 = col(S * ox + 1);
        }
        float gs[TM];
        load_g<TM>(gp, gs);
        fma_tap<TM>(acc[0], gs, w0);
        fma_tap<TM>(acc[1], gs, w1);
        fma_tap<TM>(acc[2], gs, w2);
        if (S == 1) {
          w0 = w1;
          w1 = w2;
        } else {
          w0 = w2;
        }
        gp += q.cg;
      }
    }
  }
  store_part<TM, 3>(part, q, trows * 3, slice, mt, cq, tr * 3, acc);
}

// out[m, c, tap] (m < m_out, c < c_out) = the sum of part[s, m, c, tap] over the
// slices s: run j of a block's kRedRuns adds the slices j, j + kRedRuns, ... in
// order, and the runs are added in order.
__global__ void __launch_bounds__(kThreads) conv_wgrad_kernel_reduce(
    const float* __restrict__ part, float* __restrict__ out, int slices, int cg, int cx,
    int taps, int m_out, int c_out) {
  __shared__ float sums[kRedRuns][kRedOut];
  const int lane = threadIdx.x % kRedOut, run = threadIdx.x / kRedOut;
  const long long e = (long long)blockIdx.x * kRedOut + lane;
  const long long total = (long long)m_out * c_out * taps;
  float s = 0.f;
  if (e < total) {
    const int tap = (int)(e % taps), c = (int)((e / taps) % c_out);
    const int m = (int)(e / ((long long)taps * c_out));
    const long long stride = (long long)cg * cx * taps;
    const float* p = part + ((long long)m * cx + c) * taps + tap + run * stride;
    for (int k = run; k < slices; k += kRedRuns, p += kRedRuns * stride) s += *p;
  }
  sums[run][lane] = s;
  __syncthreads();
  if (run == 0 && e < total) {
    float t = sums[0][lane];
#pragma unroll
    for (int k = 1; k < kRedRuns; ++k) t += sums[k][lane];
    out[e] = t;
  }
}

}  // namespace

// Partial sums into part (slices * cg * cx * kd*kh*kw floats), then their sum
// into out (m_out, c_out, kd, kh, kw), contiguous. tm is 1, 4, 8 or 16; row_taps
// 3 takes conv_wgrad_kernel_row3 (kw 3, pw 1, sw 1 or 2, tm at most kRowMaxTm),
// 1 the one-tap kernel.
extern "C" int conv_wgrad_launch(const void* x, const void* g, void* part, void* out, int n,
                                 int di, int hi, int wi, int cx, int od, int oh, int ow, int cg,
                                 int kd, int kh, int kw, int sd, int sh, int sw, int pd, int ph,
                                 int pw, int m_out, int c_out, int tm, int row_taps, int slices,
                                 int rows_per_slice, void* stream) {
  const Geometry q{n, di, hi, wi, cx, od, oh, ow, cg, kd, kh, kw, sd, sh, sw, pd, ph, pw,
                   slices, rows_per_slice};
  const bool row3 = row_taps == 3;
  if (cx % 4 || cg % tm || m_out > cg || c_out > cx || (row_taps != 1 && !row3) ||
      (row3 && (kw != 3 || pw != 1 || sw < 1 || sw > 2 || tm > kRowMaxTm)))
    return (int)cudaErrorInvalidValue;
  const int taps = kd * kh * kw;
  const long long threads = (long long)(cg / tm) * (cx / 4) * (taps / row_taps) * slices;
  if (threads == 0) return 0;
  const int block = row3 ? kRowThreads : kThreads;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* gf = (const float*)g;
  float* pf = (float*)part;
  switch (row3 ? tm * 4 + sw : tm * 4) {
    case 1 * 4: conv_wgrad_kernel<1><<<grid, block, 0, s>>>(xf, gf, pf, q); break;
    case 4 * 4: conv_wgrad_kernel<4><<<grid, block, 0, s>>>(xf, gf, pf, q); break;
    case 8 * 4: conv_wgrad_kernel<8><<<grid, block, 0, s>>>(xf, gf, pf, q); break;
    case 16 * 4: conv_wgrad_kernel<16><<<grid, block, 0, s>>>(xf, gf, pf, q); break;
    case 1 * 4 + 1: conv_wgrad_kernel_row3<1, 1><<<grid, block, 0, s>>>(xf, gf, pf, q); break;
    case 1 * 4 + 2: conv_wgrad_kernel_row3<1, 2><<<grid, block, 0, s>>>(xf, gf, pf, q); break;
    case 4 * 4 + 1: conv_wgrad_kernel_row3<4, 1><<<grid, block, 0, s>>>(xf, gf, pf, q); break;
    case 4 * 4 + 2: conv_wgrad_kernel_row3<4, 2><<<grid, block, 0, s>>>(xf, gf, pf, q); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)m_out * c_out * taps;
  conv_wgrad_kernel_reduce<<<(unsigned)((total + kRedOut - 1) / kRedOut), kThreads, 0, s>>>(
      pf, (float*)out, slices, cg, cx, taps, m_out, c_out);
  return (int)cudaGetLastError();
}
