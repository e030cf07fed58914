// The MVSNeRF renderer MLP (Renderer_ours) per sample, f32, for sm_90a.
//
// Replaces the Pallas TPU kernels _mlp_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/mlp.py:150, entry fused_renderer_mlp :102)
// and _mlp_rows_kernel (pallas_call at :309, entry fused_renderer_mlp_rows
// :254). Both compute, per sample,
//   bias = pts_bias(feat)
//   h = enc;  h = relu(pts_i(h) * bias) for i < 6, h = [enc, h] after i = 4
//   alpha = relu(alpha(h)), rgb = sigmoid(rgb(relu(views_0([feature(h), dir]))))
// The rows layout of the second exists for TPU tiling; here one kernel
// takes flat (N, .) inputs, in two instances: PIN = 63 (the encoding given)
// and PIN = 3 (raw coordinates, [x, sin(2^f x), cos(2^f x)] for f < 10
// built in the kernel with accurate sinf/cosf: the arguments reach 2^9 |x|).
//
// What bounds it on an H100: f32 arithmetic. A sample costs 125,696
// multiply-adds against ~100 bytes of input and 16 of output, so at the
// f32 SIMT rate (67 TFLOP/s) the flops take ~100x longer than the bytes.
// The weights (~125k floats, 0.5 MB) do not fit in shared memory, and one
// sample per thread would hold a 191-wide activation in registers. So a
// block of 256 threads takes NB = 128 samples and keeps their activations
// in shared memory, transposed ([row][sample]): the encoding (63 rows),
// the trunk (128 rows, updated in place) and the view directions (3 rows)
// are contiguous, so the skip input [enc, h] and the views_0 input
// [feature, dir] are plain row ranges, and pts_bias's output stays beside
// them for the whole trunk. Each layer is a small SGEMM: the weights,
// pre-transposed to (in, out), stream from L2 through shared memory in
// 32-row slices (the next slice is fetched into registers while the
// current one is used), and each thread accumulates an 8-sample x 8-output
// register tile, 64 FMAs per four 16-byte shared loads. The narrow alpha
// and rgb heads run one thread per sample. Only (rgb, alpha) is written
// back. The tensor cores are left for a later version.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 128;            // samples per block
constexpr int THREADS = 256;       // 16 sample groups x 16 output groups
constexpr int LD = NB + 4;         // smem row stride (floats): 16-byte rows
constexpr int WID = 128;           // trunk width
constexpr int DEPTH = 6;           // trunk layers, skip after layer 4
constexpr int ENC = 63;            // encoded position width (3 + 3*2*10)
constexpr int FREQS = 10;
constexpr int H0 = ENC;            // first trunk row of the activations
constexpr int DIR0 = H0 + WID;     // view-direction rows
constexpr int ROWS = DIR0 + 3;
constexpr int KC = 32;             // weight rows per shared-memory slice
constexpr size_t SMEM = sizeof(float) * ((size_t)ROWS * LD + (size_t)WID * LD + (size_t)KC * WID);

// Offsets (floats) of each segment of the packed weights
// (ops/cuda/renderer_mlp.py::pack_mlp_weights), each padded to 4 floats.
struct Layout {
  int pb, pbb, p[DEPTH], pB[DEPTH], ft, ftb, v0, v0b, al, alb, rgb, rgbb, n;
};

Layout layout(int F) {
  Layout L;
  int o = 0;
  auto seg = [&](int n) {
    const int at = o;
    o += (n + 3) & ~3;
    return at;
  };
  L.pb = seg(F * WID);
  L.pbb = seg(WID);
  for (int i = 0; i < DEPTH; ++i) {
    const int K = i == 0 ? ENC : (i == 5 ? ENC + WID : WID);
    L.p[i] = seg(K * WID);
    L.pB[i] = seg(WID);
  }
  L.ft = seg(WID * WID);
  L.ftb = seg(WID);
  L.v0 = seg((WID + 3) * (WID / 2));
  L.v0b = seg(WID / 2);
  L.al = seg(WID);
  L.alb = seg(1);
  L.rgb = seg(3 * (WID / 2));
  L.rgbb = seg(3);
  L.n = o;
  return L;
}

// Thread tile: samples n = tx*4 + q and 64 + tx*4 + q (tx = lane % 16, so a
// quarter-warp reads or writes 128 contiguous bytes of an activation row),
// outputs o = ty*4 + c and 64 + ty*4 + c (ty = thread / 16; the weight
// loads of a warp are two broadcasts).
__device__ __forceinline__ int tile_sample(int i) { return (threadIdx.x & 15) * 4 + (i & 3) + (i >> 2) * 64; }
__device__ __forceinline__ int tile_output(int j) { return (threadIdx.x >> 4) * 4 + (j & 3) + (j >> 2) * 64; }

// One slice of KC weight rows from k0 on (rows past K read as 0), PER
// float4 per thread, into registers.
template <int O, int PER>
__device__ __forceinline__ void fetch_slice(const float* __restrict__ wt, int K, int k0,
                                            float4 (&pre)[PER]) {
  constexpr int Q = O / 4;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int idx = threadIdx.x + r * THREADS, row = k0 + idx / Q;
    pre[r] = row < K ? __ldg(reinterpret_cast<const float4*>(wt + (long long)row * O) + idx % Q)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc[i][j] = sum_k in[k][n_i] * wt[k][o_j] for K input rows of ``in``
// (shared memory, stride LD) and the (K, O) weights ``wt`` (device memory).
template <int O>
__device__ __forceinline__ void dense(const float* __restrict__ wt, const float* in, int K,
                                      float* wbuf, float (&acc)[8][O / 16]) {
  constexpr int TO = O / 16;
  constexpr int PER = KC * O / 4 / THREADS;  // float4 per thread per slice
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[i][j] = 0.f;
  float4 pre[PER];
  fetch_slice<O>(wt, K, 0, pre);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous slice is consumed
#pragma unroll
    for (int r = 0; r < PER; ++r) reinterpret_cast<float4*>(wbuf)[tid + r * THREADS] = pre[r];
    __syncthreads();
    if (k0 + KC < K) fetch_slice<O>(wt, K, k0 + KC, pre);
    const int kc = min(KC, K - k0);
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      const float* a = in + (k0 + k) * LD;
      const float4 a0 = *reinterpret_cast<const float4*>(a + tx * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float* w = wbuf + k * O;
      float wv[TO];
#pragma unroll
      for (int h = 0; h < TO / 4; ++h) {
        const float4 w4 = *reinterpret_cast<const float4*>(w + h * 64 + ty * 4);
        wv[h * 4 + 0] = w4.x;
        wv[h * 4 + 1] = w4.y;
        wv[h * 4 + 2] = w4.z;
        wv[h * 4 + 3] = w4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
}

enum Epilogue { kLinear, kRelu, kReluMod };

// dst[o][n] = act(acc + b[o]) (kReluMod: relu((acc + b[o]) * mod[o][n])).
template <int O, Epilogue E>
__device__ __forceinline__ void store(const float (&acc)[8][O / 16], const float* __restrict__ b,
                                      const float* mod, float* dst) {
#pragma unroll
  for (int j = 0; j < O / 16; ++j) {
    const int o = tile_output(j);
    const float bo = __ldg(b + o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = tile_sample(h * 4);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = acc[h * 4 + q][j] + bo;
      if (E == kReluMod) {
        const float4 m = *reinterpret_cast<const float4*>(mod + o * LD + n);
        v[0] *= m.x;
        v[1] *= m.y;
        v[2] *= m.z;
        v[3] *= m.w;
      }
      if (E != kLinear) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = fmaxf(v[q], 0.f);
      }
      *reinterpret_cast<float4*>(dst + o * LD + n) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// rows [r0, r0 + width) of act for the block's samples <- src (N, width)
__device__ __forceinline__ void load_rows(float* act, int r0, const float* __restrict__ src,
                                          int width, long long s0, long long N) {
  const long long avail = N - s0 < NB ? N - s0 : NB;
  for (int idx = threadIdx.x; idx < NB * width; idx += THREADS) {
    const int n = idx / width, k = idx - n * width;
    act[(r0 + k) * LD + n] = n < avail ? src[s0 * width + idx] : 0.f;
  }
}

template <int PIN>
__global__ void __launch_bounds__(THREADS, 1) renderer_mlp_kernel(
    const float* __restrict__ weights,  // packed, Layout
    const float* __restrict__ pts,      // (N, PIN)
    const float* __restrict__ feat,     // (N, F)
    const float* __restrict__ dirs,     // (N, 3)
    float* __restrict__ out,            // (N, 4) rgb, alpha
    long long N, int F, Layout L) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                  // (ROWS, LD): enc | trunk | dirs
  float* bias = act + ROWS * LD;      // (WID, LD): pts_bias(feat)
  float* wbuf = bias + WID * LD;      // (KC, WID): weight slice
  const long long s0 = (long long)blockIdx.x * NB;
  const int tid = threadIdx.x;

  load_rows(act, 0, pts, PIN, s0, N);
  load_rows(act, H0, feat, F, s0, N);  // the trunk rows hold feat until layer 0
  load_rows(act, DIR0, dirs, 3, s0, N);
  __syncthreads();
  if (PIN == 3) {
    for (int idx = tid; idx < NB * 2 * 3 * FREQS; idx += THREADS) {
      const int r = idx / NB, n = idx - r * NB, j = r % (3 * FREQS);
      const float x = act[(j % 3) * LD + n] * (float)(1 << (j / 3));
      act[(3 + r) * LD + n] = r < 3 * FREQS ? sinf(x) : cosf(x);
    }
  }

  float acc[8][8];
  dense<WID>(weights + L.pb, act + H0 * LD, F, wbuf, acc);
  store<WID, kLinear>(acc, weights + L.pbb, nullptr, bias);
  for (int i = 0; i < DEPTH; ++i) {
    const float* in = i == 0 || i == 5 ? act : act + H0 * LD;  // layer 5 reads [enc, h]
    const int K = i == 0 ? ENC : (i == 5 ? ENC + WID : WID);
    dense<WID>(weights + L.p[i], in, K, wbuf, acc);
    __syncthreads();  // every thread has read the rows it overwrites
    store<WID, kReluMod>(acc, weights + L.pB[i], bias, act + H0 * LD);
  }
  __syncthreads();

  float alpha = 0.f;
  if (tid < NB) {
    float a = __ldg(weights + L.alb);
    for (int k = 0; k < WID; ++k) a = fmaf(act[(H0 + k) * LD + tid], __ldg(weights + L.al + k), a);
    alpha = fmaxf(a, 0.f);
  }
  dense<WID>(weights + L.ft, act + H0 * LD, WID, wbuf, acc);
  __syncthreads();
  store<WID, kLinear>(acc, weights + L.ftb, nullptr, act + H0 * LD);  // feature
  float acc2[8][WID / 32];
  dense<WID / 2>(weights + L.v0, act + H0 * LD, WID + 3, wbuf, acc2);  // [feature, dir]
  __syncthreads();
  store<WID / 2, kRelu>(acc2, weights + L.v0b, nullptr, act + H0 * LD);
  __syncthreads();

  if (tid < NB && s0 + tid < N) {
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float a = __ldg(weights + L.rgbb + c);
      for (int k = 0; k < WID / 2; ++k)
        a = fmaf(act[(H0 + k) * LD + tid], __ldg(weights + L.rgb + c * (WID / 2) + k), a);
      rgb[c] = 1.f / (1.f + expf(-a));
    }
    reinterpret_cast<float4*>(out)[s0 + tid] = make_float4(rgb[0], rgb[1], rgb[2], alpha);
  }
}

template <int PIN>
int launch(const float* weights, const void* pts, const void* feat, const void* dirs, void* out,
           long long N, int F, const Layout& L, cudaStream_t stream) {
  auto kernel = renderer_mlp_kernel<PIN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (N + NB - 1) / NB;
  kernel<<<(unsigned)grid, THREADS, SMEM, stream>>>(weights, (const float*)pts, (const float*)feat,
                                                    (const float*)dirs, (float*)out, N, F, L);
  return (int)cudaGetLastError();
}

}  // namespace

// pin = 63: encoded input (Pallas kernel #7); pin = 3: raw coordinates
// encoded in the kernel with 10 frequencies (#8 and the main path).
extern "C" int renderer_mlp_launch(const void* weights, int n_weights, const void* pts,
                                   const void* feat, const void* dirs, void* out, long long N,
                                   int F, int pin, void* stream) {
  if (F < 1 || F > WID) return (int)cudaErrorInvalidValue;
  const Layout L = layout(F);
  if (n_weights != L.n) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const float* w = (const float*)weights;
  cudaStream_t st = (cudaStream_t)stream;
  if (pin == ENC) return launch<ENC>(w, pts, feat, dirs, out, N, F, L, st);
  if (pin == 3) return launch<3>(w, pts, feat, dirs, out, N, F, L, st);
  return (int)cudaErrorInvalidValue;
}
