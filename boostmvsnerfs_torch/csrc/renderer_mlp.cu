// The MVSNeRF renderer MLP (Renderer_ours) per sample, for sm_90a: an f32
// kernel (compute_dtype float32) and a bf16 tensor-core kernel (bfloat16,
// the default, as in JAX), described below the f32 one.
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
// back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ------------------------------------------------------------------ bf16
//
// The contract of the Pallas kernels (mlp.py:56-63, compute_dtype bf16):
// every dense layer rounds both operands to bf16 and sums in f32; biases,
// ReLUs, the pts_bias modulation and the sigmoid stay in f32.
//
// What bounds it on an H100: bf16 tensor-core operations. A sample costs
// 125,696 multiply-adds (2.5 TFLOP for the 10.1 M samples of a frame, 2.6
// ms at 989 TFLOP/s) against 120 bytes (0.36 ms at 3.35 TB/s).
//
// Design. mma.sync m16n8k16 (bf16 in, f32 sums) with samples on M: each of
// the WARPS warps of a block owns 16 samples through all nine dense layers.
// A layer's f32 accumulators (16 x 128: 64 per thread) are, once packed to
// bf16x2, the A fragments of the next layer (the accumulator of n-tiles
// 2k and 2k+1 holds exactly the k-th 16-column A fragment), so nothing of
// the trunk goes back to shared memory. Each warp stages its 16 rows of
// the encoding (built from the raw coordinates with one accurate sincosf
// per argument, which reach 2^9 |x|, or loaded) and of feat in bf16 in
// its own shared memory, with one row per step of coalesced loads, and
// takes their A fragments with ldmatrix: the encoding at pts_0 and again
// for the skip at pts_5. pts_bias's f32 output is kept per warp in shared
// memory in the accumulator layout for the six modulations. The
// weights, packed once by the wrapper in nn.Linear's (out, in) layout (the
// col B operand) with zero-padded k16 widths and rows 8 elements longer
// than the width (conflict-free ldmatrix), do not fit in shared memory
// (~270 KB): a persistent grid of one block per SM streams them layer by
// layer from L2 through a double buffer filled by cp.async, the next layer
// in flight while the current one runs (pts_5 as two layers, over enc and
// over h, so that no buffer is larger than a 128 x 128 layer). The narrow alpha and rgb heads run
// on the bf16-rounded activations as partial dot products in each thread
// and two quad shuffles.
namespace tc {

// 12 warps a block: faster than 8 on the main path (PERF.md, section 6). Their
// staging leaves shared memory for feat up to MAX_FEAT wide (checked
// below); the wrapper reads MAX_FEAT from this line to reject a wider feat
// before it builds anything.
constexpr int WARPS = 12;
constexpr int MAX_FEAT = 64;
constexpr int TB = WARPS * 32;
constexpr int TILE = WARPS * 16;                   // samples per block step
constexpr int NT = WID / 8;                        // n-tiles of a trunk layer
// pts_bias, pts_0..4, pts_5 over enc, pts_5 over h, feature, views_0
constexpr int NLAYERS = 10;
constexpr int MAX_LAYER_BYTES = WID * (WID + 8) * 2;  // a trunk layer (pts_bias: F <= 128)
constexpr int BIAS_BYTES = WARPS * NT * 2 * 32 * 8;        // per warp (16, 128) f32
constexpr int ENC_LD = 64 + 8;                             // staged encoding row (bf16)
static_assert(3 * FREQS + 2 == 32, "one lane per sine/cosine argument, one for x, one for the pad");
// float offsets of the vector buffer (ops/cuda/renderer_mlp.py::pack_mlp_weights_bf16)
constexpr int VEC_PB = 0, VEC_P = WID, VEC_FT = VEC_P + DEPTH * WID, VEC_V0 = VEC_FT + WID,
              VEC_AW = VEC_V0 + WID / 2, VEC_AB = VEC_AW + WID, VEC_RW = VEC_AB + 4,
              VEC_RB = VEC_RW + 3 * (WID / 2), VEC_N = VEC_RB + 4;
constexpr size_t SMEM_FIXED = 2 * (size_t)MAX_LAYER_BYTES + BIAS_BYTES + sizeof(float) * VEC_N;

// feat's staged row (bf16), a warp's staging (the encoding, feat, the raw
// coordinates) and the whole dynamic shared memory for kf k-steps of feat
__host__ __device__ constexpr int feat_ld(int kf) { return 16 * kf + 8; }
__host__ __device__ constexpr int stage_bytes(int kf) { return 2 * 16 * (ENC_LD + feat_ld(kf)) + 4 * 16 * 3; }
constexpr size_t smem_bytes(int kf) { return SMEM_FIXED + (size_t)WARPS * stage_bytes(kf); }
constexpr size_t SMEM_MAX = 232448;  // a block's dynamic shared memory on sm_90
static_assert(MAX_FEAT % 16 == 0 && smem_bytes(MAX_FEAT / 16) <= SMEM_MAX &&
                  smem_bytes(MAX_FEAT / 16 + 1) > SMEM_MAX,
              "MAX_FEAT is the widest feat whose staging fits");

// Element offset and byte size of each layer's rows in the matrix buffer.
struct Layers {
  int off[NLAYERS], bytes[NLAYERS], n;
};

Layers layers(int kf) {
  const int K[NLAYERS] = {16 * kf, 64, WID, WID, WID, WID, 64, WID, WID, WID + 16};
  Layers L;
  int o = 0;
  for (int l = 0; l < NLAYERS; ++l) {
    const int rows = l == NLAYERS - 1 ? WID / 2 : WID;
    L.off[l] = o;
    L.bytes[l] = rows * (K[l] + 8) * 2;
    o += rows * (K[l] + 8);
  }
  L.n = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16x2 of (lo, hi), round to nearest even (torch's .to(bfloat16)); lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_of(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_of(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// One k16 step over N8 n-tiles: B fragments of tiles j and j + 1 from one
// ldmatrix.x4 at ``addr`` (this lane's row of the step's first tile pair)
template <int N8>
__device__ __forceinline__ void mma_step(float (&acc)[N8][4], const uint32_t (&a)[4], uint32_t addr,
                                         int ldw_bytes) {
#pragma unroll
  for (int j = 0; j < N8; j += 2) {
    uint32_t b[4];
    ldmatrix_x4(b, addr + j * 8 * ldw_bytes);
    mma(acc[j], a, b[0], b[1]);
    mma(acc[j + 1], a, b[2], b[3]);
  }
}

// This lane's ldmatrix row address in a layer at shared address w: matrix
// m = lane / 8 is (n-tile m / 2, k half m % 2), row lane % 8
__device__ __forceinline__ uint32_t lane_row(uint32_t w, int ldw_bytes) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  return w + (uint32_t)((8 * (m >> 1) + (lane & 7)) * ldw_bytes + (m & 1) * 16);
}

// The A fragment of k-step k of a warp's 16 staged bf16 rows (LD elements
// each) at shared address rows: matrix m = lane / 8 is (rows 8 (m % 2) on,
// k half m / 2)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t rows, int ld, int k) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  ldmatrix_x4(a, rows + (uint32_t)((((m & 1) * 8 + (lane & 7)) * ld + k * 16 + (m >> 1) * 8) * 2));
}

template <int N8>
__device__ __forceinline__ void zero(float (&acc)[N8][4]) {
#pragma unroll
  for (int j = 0; j < N8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc += a (16 x 16 KS) * W^T for a layer of N8 * 8 rows of LDW elements at w
template <int KS, int N8, int LDW>
__device__ __forceinline__ void dense_acc(const uint32_t (&a)[KS][4], uint32_t w, float (&acc)[N8][4]) {
  const uint32_t base = lane_row(w, 2 * LDW);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_step(acc, a[kk], base + kk * 32, 2 * LDW);
}

template <int KS, int N8, int LDW>
__device__ __forceinline__ void dense(const uint32_t (&a)[KS][4], uint32_t w, float (&acc)[N8][4]) {
  zero(acc);
  dense_acc<KS, N8, LDW>(a, w, acc);
}

// A fragments of the next layer from accumulators: k-step k takes n-tiles 2k, 2k + 1
template <int N8>
__device__ __forceinline__ void to_frags(const float (&v)[N8][4], uint32_t (&a)[N8 / 2][4]) {
#pragma unroll
  for (int k = 0; k < N8 / 2; ++k) {
    a[k][0] = pack(v[2 * k][0], v[2 * k][1]);
    a[k][1] = pack(v[2 * k][2], v[2 * k][3]);
    a[k][2] = pack(v[2 * k + 1][0], v[2 * k + 1][1]);
    a[k][3] = pack(v[2 * k + 1][2], v[2 * k + 1][3]);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A warp's 16 rows from s0 on of a (N, width) array, contiguous in device
// memory, into bf16 rows of ld elements (rows past N as zeros): coalesced
// runs, each lane issuing 8 loads before it stores any
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld, const float* __restrict__ src,
                                           int width, long long s0, long long N) {
  constexpr int U = 8;
  const int lane = threadIdx.x & 31, total = 16 * width;
  const long long avail = (N - s0 < 16 ? N - s0 : 16) * width;
  src += s0 * width;
  for (int i0 = lane; i0 < total; i0 += 32 * U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = i0 + 32 * u < avail ? __ldg(src + i0 + 32 * u) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u, row = i / width;
      if (i < total) dst[row * ld + i - row * width] = __float2bfloat16_rn(v[u]);
    }
  }
}

__device__ __forceinline__ float load(const float* __restrict__ p, long long row, int col, int width,
                                      long long N) {
  return row < N && col < width ? __ldg(p + row * width + col) : 0.f;
}


template <int PIN>
__global__ void __launch_bounds__(TB, 1) renderer_mlp_kernel_bf16(
    const __nv_bfloat16* __restrict__ mats,  // packed matrices, Layers
    const float* __restrict__ vecs,          // VEC_* layout
    const float* __restrict__ pts,           // (N, PIN)
    const float* __restrict__ feat,          // (N, F)
    const float* __restrict__ dirs,          // (N, 3)
    float* __restrict__ out,                 // (N, 4) rgb, alpha
    long long N, int F, Layers L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  float2* bias = reinterpret_cast<float2*>(smem + 2 * MAX_LAYER_BYTES) + warp * (NT * 2 * 32);
  float* vec = reinterpret_cast<float*>(smem + 2 * MAX_LAYER_BYTES + BIAS_BYTES);
  const long long tiles = (N + TILE - 1) / TILE;
  const int kf = (F + 15) / 16, fld = feat_ld(kf);
  // this warp's staged rows: the encoding (16, ENC_LD), then feat (16, fld)
  __nv_bfloat16* enc_s =
      reinterpret_cast<__nv_bfloat16*>(smem + SMEM_FIXED + warp * stage_bytes(kf));
  __nv_bfloat16* feat_s = enc_s + 16 * ENC_LD;
  float* xs = reinterpret_cast<float*>(feat_s + 16 * fld);  // the raw coordinates (16, 3)
  const uint32_t wbuf = smem_addr(smem), enc_a = smem_addr(enc_s), feat_a = smem_addr(feat_s);
  // the pad columns (enc 63, feat F..16 kf) stay zero; tiles write the rest
  for (int i = lane; i < 16 * (ENC_LD + fld); i += 32) enc_s[i] = __float2bfloat16_rn(0.f);
  for (int i = tid; i < VEC_N; i += TB) vec[i] = vecs[i];

  auto prefetch = [&](int l, int buf) {
    const char* src = reinterpret_cast<const char*>(mats + L.off[l]);
    const uint32_t dst = wbuf + buf * MAX_LAYER_BYTES;
    for (int i = tid; i < L.bytes[l] / 16; i += TB) cp_async16(dst + i * 16, src + i * 16);
    cp_async_commit();
  };
  int buf = 0;
  // Layer l's weights have landed and every warp is done with the other
  // buffer: start the next layer's copy there; returns layer l's address.
  auto next = [&](int l, bool more) {
    cp_async_wait_all();
    __syncthreads();
    if (l + 1 < NLAYERS) prefetch(l + 1, buf ^ 1);
    else if (more) prefetch(0, buf ^ 1);
    const uint32_t w = wbuf + buf * MAX_LAYER_BYTES;
    buf ^= 1;
    return w;
  };
  prefetch(0, 0);

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool more = tile + gridDim.x < tiles;
    const long long s0 = tile * TILE + warp * 16, r0 = s0 + g, r1 = r0 + 8;

    // stage the encoding [x, sin(2^f x_d), cos(2^f x_d)] (f-major, d-minor,
    // 63 wide) and feat in bf16: the tile's rows are contiguous in device
    // memory, so each is one coalesced run, loaded 8 elements a lane ahead
    __syncwarp();  // the previous tile's ldmatrix reads are done
    stage_rows(feat_s, fld, feat, F, s0, N);
    if (PIN == 3) {
      for (int i = lane; i < 16 * 3; i += 32) xs[i] = s0 * 3 + i < N * 3 ? __ldg(pts + s0 * 3 + i) : 0.f;
      __syncwarp();
      if (lane < 3 * FREQS) {  // argument j = lane: x_{j % 3} 2^{j / 3}
        const float scale = __int_as_float((127 + lane / 3) << 23);
#pragma unroll 4
        for (int r = 0; r < 16; ++r) {
          const float x = xs[r * 3 + lane % 3];
          float sn, cs;
          sincosf(x * scale, &sn, &cs);
          __nv_bfloat16* e = enc_s + r * ENC_LD;
          e[3 + lane] = __float2bfloat16_rn(sn);
          e[3 + 3 * FREQS + lane] = __float2bfloat16_rn(cs);
          if (lane < 3) e[lane] = __float2bfloat16_rn(x);
        }
      }
    } else {
      stage_rows(enc_s, ENC_LD, pts, ENC, s0, N);
    }
    __syncwarp();

    float acc[NT][4];
    // pts_bias: feat (F wide, kf k-steps) -> bias, kept in f32
    {
      const uint32_t w = next(0, more);
      const int ldw = 2 * fld;
      const uint32_t base = lane_row(w, ldw);
      zero(acc);
      for (int k = 0; k < kf; ++k) {
        uint32_t a[4];
        load_a(a, feat_a, fld, k);
        mma_step(acc, a, base + k * 32, ldw);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float b0 = vec[VEC_PB + 8 * j + 2 * t], b1 = vec[VEC_PB + 8 * j + 2 * t + 1];
        bias[(2 * j) * 32 + lane] = make_float2(acc[j][0] + b0, acc[j][1] + b1);
        bias[(2 * j + 1) * 32 + lane] = make_float2(acc[j][2] + b0, acc[j][3] + b1);
      }
    }

    // h = relu((W_i h + b_i) * bias), as A fragments of the next layer
    uint32_t h[NT / 2][4];
    auto modulate = [&](int i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float b0 = vec[VEC_P + i * WID + 8 * j + 2 * t], b1 = vec[VEC_P + i * WID + 8 * j + 2 * t + 1];
        const float2 m0 = bias[(2 * j) * 32 + lane], m1 = bias[(2 * j + 1) * 32 + lane];
        acc[j][0] = fmaxf((acc[j][0] + b0) * m0.x, 0.f);
        acc[j][1] = fmaxf((acc[j][1] + b1) * m0.y, 0.f);
        acc[j][2] = fmaxf((acc[j][2] + b0) * m1.x, 0.f);
        acc[j][3] = fmaxf((acc[j][3] + b1) * m1.y, 0.f);
      }
      to_frags(acc, h);
    };
    {
      uint32_t enc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) load_a(enc[k], enc_a, ENC_LD, k);
      dense<4, NT, 64 + 8>(enc, next(1, more), acc);
      modulate(0);
    }
#pragma unroll
    for (int i = 1; i < DEPTH - 1; ++i) {
      dense<NT / 2, NT, WID + 8>(h, next(1 + i, more), acc);
      modulate(i);
    }
    {  // the skip: W [enc, h] = W_enc enc + W_h h, two layers' buffers
      uint32_t enc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) load_a(enc[k], enc_a, ENC_LD, k);
      dense<4, NT, 64 + 8>(enc, next(DEPTH, more), acc);
      dense_acc<NT / 2, NT, WID + 8>(h, next(DEPTH + 1, more), acc);
      modulate(DEPTH - 1);
    }

    // alpha = relu(w . h + b) on the bf16 h
    float al0 = 0.f, al1 = 0.f;
#pragma unroll
    for (int k = 0; k < NT / 2; ++k) {
      const int c = 16 * k + 2 * t;
      const float w0 = vec[VEC_AW + c], w1 = vec[VEC_AW + c + 1], w8 = vec[VEC_AW + c + 8],
                  w9 = vec[VEC_AW + c + 9];
      al0 += lo_of(h[k][0]) * w0 + hi_of(h[k][0]) * w1 + lo_of(h[k][2]) * w8 + hi_of(h[k][2]) * w9;
      al1 += lo_of(h[k][1]) * w0 + hi_of(h[k][1]) * w1 + lo_of(h[k][3]) * w8 + hi_of(h[k][3]) * w9;
    }
    al0 = fmaxf(quad_sum(al0) + vec[VEC_AB], 0.f);
    al1 = fmaxf(quad_sum(al1) + vec[VEC_AB], 0.f);

    // feature = W h + b; views_0 over [feature, dir]
    dense<NT / 2, NT, WID + 8>(h, next(DEPTH + 2, more), acc);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = vec[VEC_FT + 8 * j + 2 * t], b1 = vec[VEC_FT + 8 * j + 2 * t + 1];
      acc[j][0] += b0;
      acc[j][1] += b1;
      acc[j][2] += b0;
      acc[j][3] += b1;
    }
    uint32_t a[NT / 2 + 1][4];
    to_frags(acc, h);
#pragma unroll
    for (int k = 0; k < NT / 2; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[k][r] = h[k][r];
    {  // k-step 8: columns 128 + 2t, +1 hold dir (t = 0: d0, d1; t = 1: d2, 0)
      const int c = 2 * t;
      a[NT / 2][0] = pack(load(dirs, r0, c, 3, N), t == 0 ? load(dirs, r0, 1, 3, N) : 0.f);
      a[NT / 2][1] = pack(load(dirs, r1, c, 3, N), t == 0 ? load(dirs, r1, 1, 3, N) : 0.f);
      a[NT / 2][2] = a[NT / 2][3] = 0u;
    }
    float hv[NT / 2][4];
    dense<NT / 2 + 1, NT / 2, WID + 16 + 8>(a, next(DEPTH + 3, more), hv);

    // rgb = sigmoid(W relu(hv + b) + b) on the bf16 relu(hv + b)
    float q0[3] = {0.f, 0.f, 0.f}, q1[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float b = vec[VEC_V0 + c];
        const float v0 = __bfloat162float(__float2bfloat16_rn(fmaxf(hv[j][e] + b, 0.f)));
        const float v1 = __bfloat162float(__float2bfloat16_rn(fmaxf(hv[j][2 + e] + b, 0.f)));
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          const float w = vec[VEC_RW + o * (WID / 2) + c];
          q0[o] += v0 * w;
          q1[o] += v1 * w;
        }
      }
    }
    float rgb0[3], rgb1[3];
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      rgb0[o] = 1.f / (1.f + expf(-(quad_sum(q0[o]) + vec[VEC_RB + o])));
      rgb1[o] = 1.f / (1.f + expf(-(quad_sum(q1[o]) + vec[VEC_RB + o])));
    }
    if (t == 0 && r0 < N) reinterpret_cast<float4*>(out)[r0] = make_float4(rgb0[0], rgb0[1], rgb0[2], al0);
    if (t == 1 && r1 < N) reinterpret_cast<float4*>(out)[r1] = make_float4(rgb1[0], rgb1[1], rgb1[2], al1);
  }
  cp_async_wait_all();
}

template <int PIN>
int launch(const void* mats, const float* vecs, const void* pts, const void* feat, const void* dirs,
           void* out, long long N, int F, int sms, const Layers& L, cudaStream_t stream) {
  auto kernel = renderer_mlp_kernel_bf16<PIN>;
  const size_t smem = smem_bytes((F + 15) / 16);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (N + TILE - 1) / TILE;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, TB, smem, stream>>>((const __nv_bfloat16*)mats, vecs, (const float*)pts,
                                     (const float*)feat, (const float*)dirs, (float*)out, N, F, L);
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// The bf16 tensor-core kernel, same instances; ``sms``: the persistent grid.
extern "C" int renderer_mlp_bf16_launch(const void* mats, int n_mats, const void* vecs, int n_vecs,
                                        const void* pts, const void* feat, const void* dirs,
                                        void* out, long long N, int F, int pin, int sms,
                                        void* stream) {
  if (F < 1 || F > tc::MAX_FEAT || sms < 1) return (int)cudaErrorInvalidValue;
  const tc::Layers L = tc::layers((F + 15) / 16);
  if (n_mats != L.n || n_vecs != tc::VEC_N) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const float* v = (const float*)vecs;
  cudaStream_t st = (cudaStream_t)stream;
  if (pin == ENC) return tc::launch<ENC>(mats, v, pts, feat, dirs, out, N, F, sms, L, st);
  if (pin == 3) return tc::launch<3>(mats, v, pts, feat, dirs, out, N, F, sms, L, st);
  return (int)cudaErrorInvalidValue;
}
