// The whole ENeRF IBR head per sample, on bf16 tensor cores, for sm_90a.
//
// Replaces the Pallas TPU kernel _head_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/enerf_head.py:221), entry fused_nerf_head
// (:186): view-direction conditioning, mean/var over views, global_fc,
// softmax view pooling, fc, lr0, softplus sigma, color0/color1 and the
// softmax blend of the source-view RGB. Its contract (enerf_head.py:28-30,
// precision DEFAULT: bf16 multipliers on the TPU) is kept: every dense
// layer rounds both operands to bf16 and sums in f32; the statistics,
// biases, ReLUs, softmaxes, softplus and the RGB blend (a selection matmul
// on the TPU, exact here) stay in f32.
//
// The image-feature-only head (VOX = false; use_vox_feat=False of the
// Pallas kernel, the head of every foreground layer of the layered
// composite variant) reads no voxel features: lr0 takes the pooled image
// feature [agg 16] and color0's per-sample part [x 64, agg 16], 80 wide,
// five k16 steps. It stages no voxel rows and takes no voxel buffer.
//
// What bounds it on an H100: bytes. A sample (S=3, C=11) moves ~228 bytes
// against 12,804 multiply-adds, which take a third of that time at the
// bf16 tensor-core rate.
//
// Design. Each warp takes 16 samples on M of mma.sync m16n8k16 (bf16 in,
// f32 sums) and walks over the sample tiles of a persistent grid. The
// tile's feat, dirs and vox rows are contiguous in device memory (one
// batch, 16 consecutive samples), so the warp copies them into its own
// shared memory with coalesced loads and reads its fragments from there;
// the staging is sized per launch by the view count S (2 to MAX_VIEWS).
// The per-view layers (view_fc, global_fc's image part, color0's [feat,
// dir] part) run once per view over the same B fragments; an f32
// accumulator of n-tiles 2k and 2k + 1, packed to bf16x2, is the k-th A
// fragment of the next layer, so activations stay in registers. The term
// shared by the views (global_fc over [var, avg], color0 over [x, vox,
// agg]) is computed once and starts every view's accumulator. The
// one-output layers (agg_w_fc, sigma, color1) are partial dot products in
// each thread plus two quad shuffles, and so are the softmaxes' sums over
// views. The weights (bf16, ~27-39 KB, in nn.Linear's (out, in) layout with
// zero-padded k16 widths and rows 8 elements longer, for conflict-free
// ldmatrix) are copied into shared memory once per block.
//
// Two instances per (C, view conditioning, voxel features). S = 3, the
// view count of every path (a combination of the boost recipe), is known at
// compile time: the views' conditioned features, pooled features and colour
// logits stay in registers, and the views' independent mma chains
// interleave. Any other S
// runs in run-time loops that hold one view at a time: the conditioned
// features (view_fc, one k-step) are recomputed in each of the three passes
// that need them (the mean, the variance about it, global_fc), and the two
// softmaxes over views (the pooling weights, the colour blend) are taken
// online, with a running maximum and the sums rescaled as it grows. One
// run-time instance alone, at S = 3, took 39% more device time than the
// compile-time one (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HID = 64;
constexpr int WARPS = 4;
constexpr int MAX_VIEWS = 8;  // the most views a launch takes (ops/cuda/enerf_head.py)

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// log1p(exp(-|x|)) + max(x, 0), the form jax.nn.softplus computes
__device__ __forceinline__ float softplus(float x) { return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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

// bf16x2 of (lo, hi), round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int N8>
__device__ __forceinline__ void zero(float (&acc)[N8][4]) {
#pragma unroll
  for (int j = 0; j < N8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc += a (16 x 16 KS) * W^T, W rows of LDW elements at shared address w
// from column k0 on: one ldmatrix.x4 gives the B fragments of two n-tiles
template <int KS, int N8, int LDW>
__device__ __forceinline__ void dense(const uint32_t (&a)[KS][4], uint32_t w, int k0, float (&acc)[N8][4]) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  const uint32_t base = w + (uint32_t)(((8 * (m >> 1) + (lane & 7)) * LDW + k0 + (m & 1) * 8) * 2);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int j = 0; j < N8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, base + (j * 8 * LDW + kk * 16) * 2);
      mma(acc[j], a[kk], b[0], b[1]);
      mma(acc[j + 1], a[kk], b[2], b[3]);
    }
}

// A fragments from accumulators: k-step k takes n-tiles 2k and 2k + 1
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

// Row r of a dot product of the accumulator rows with an f32 vector w of
// bf16 values: rows g (r = 0: elements 0, 1) or g + 8 (r = 1: 2, 3)
template <int N8>
__device__ __forceinline__ float row_dot(const float (&v)[N8][4], const float* w, int r) {
  const int t = threadIdx.x & 3;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < N8; ++j)
    s += bf(v[j][2 * r]) * w[8 * j + 2 * t] + bf(v[j][2 * r + 1]) * w[8 * j + 2 * t + 1];
  return quad_sum(s);
}

// Padded widths: CP = C in k16 steps (the per-view channels, view_fc's
// outputs and each third of global_fc's input), CV = C + 4 in k16 steps
// (color0's per-view input [feat, dir]). VOX: lr0's input is [vox 8, agg
// 16] (two k16 steps, the second half zero), else [agg 16] (one).
template <int C, bool VIEWDIR, bool VOX>
struct Layout {
  static constexpr int CP = (C + 15) / 16 * 16, CV = (C + 4 + 15) / 16 * 16;
  static constexpr int KL = VOX ? 2 : 1;            // lr0's k16 steps
  // bf16 matrices (ops/cuda/enerf_head.py::pack_head_weights), rows of K + 8
  static constexpr int LV = 16 + 8;                 // view_fc (CP, 16): [dir 4, 0]
  static constexpr int LG = 3 * CP + 8;             // global_fc (32, 3 CP): [img, var, avg]
  static constexpr int LF = 32 + 8;                 // fc (16, 32)
  // lr0 (64, 32): [vox 8, agg 16, 0], or (64, 16): [agg 16]
  static constexpr int LL = 16 * KL + 8;
  // color0 (64, 96): [x 64, vox 8, agg 16, 0], or (64, 80): [x 64, agg 16]
  static constexpr int LB = HID + 16 * KL + 8;
  static constexpr int LC = CV + 8;                 // color0 (64, CV): [feat C, dir 4, 0]
  static constexpr int MV = 0;
  static constexpr int MG = MV + (VIEWDIR ? CP * LV : 0);
  static constexpr int MF = MG + 32 * LG;
  static constexpr int ML = MF + 16 * LF;
  static constexpr int MB = ML + HID * LL;
  static constexpr int MC = MB + HID * LB;
  static constexpr int M_N = MC + HID * LC;
  // float32 vectors: biases, and the one-output layers' weights as bf16 values
  static constexpr int BV = 0;                      // view_fc bias (CP)
  static constexpr int BG = BV + CP;                // global_fc bias (32)
  static constexpr int WA = BG + 32, BA = WA + 32;  // agg_w_fc (32), bias (padded to 4)
  static constexpr int BF = BA + 4;                 // fc bias (16)
  static constexpr int BL = BF + 16;                // lr0 bias (64)
  static constexpr int WS = BL + HID, BS = WS + HID;  // sigma (64), bias (4)
  static constexpr int BC = BS + 4;                 // color0 bias (64)
  static constexpr int WC = BC + HID, BC1 = WC + HID;  // color1 (64), bias (4)
  static constexpr int V_N = BC1 + 4;
  // per warp staging (floats) of S views: feat (S, 16, C) at 0, dirs
  // (S, 16, 4) at SD, vox (16, 8) at SX when VOX
  static __host__ __device__ int SD(int S) { return S * 16 * C; }
  static __host__ __device__ int SX(int S) { return SD(S) + S * 16 * 4; }
  static __host__ __device__ int STAGE(int S) { return SX(S) + (VOX ? 16 * 8 : 0); }
  static size_t smem(int S) {
    return 2 * (size_t)M_N + 4 * (size_t)V_N + 4 * (size_t)WARPS * STAGE(S);
  }
};

// SN > 0: the view count is SN, known at compile time; every view's
// conditioned features, pooled features and colour logits stay in registers.
// SN = 0: S views at run time, in loops that hold one view at a time.
template <int C, bool VIEWDIR, bool VOX, int SN>
__global__ void __launch_bounds__(WARPS * 32, 3) enerf_head_kernel(
    const __nv_bfloat16* __restrict__ mats,  // Layout M*
    const float* __restrict__ vecs,          // Layout V*
    const float* __restrict__ vox,           // (B, P, 8); unread unless VOX
    const float* __restrict__ feat,          // (B, S, P, C)
    const float* __restrict__ dirs,          // (B, S, P, 4)
    float* __restrict__ out,                 // (B, P, 4)
    int B, int S_run, long long P) {
  using L = Layout<C, VIEWDIR, VOX>;
  constexpr int NC = L::CP / 8, KC = L::CP / 16, KV = L::CV / 16, KL = L::KL;
  const int S = SN > 0 ? SN : S_run;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int SD = L::SD(S), SX = L::SX(S);
  float* vec = reinterpret_cast<float*>(smem + 2 * L::M_N);
  float* stage = vec + L::V_N + warp * L::STAGE(S);
  for (int i = tid; i < L::M_N * 2 / 16; i += WARPS * 32)
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(mats)[i];
  for (int i = tid; i < L::V_N; i += WARPS * 32) vec[i] = vecs[i];
  __syncthreads();
  const uint32_t w = smem_addr(smem);

  const long long per_b = (P + 15) / 16, tiles = per_b * B;
  for (long long tile = (long long)blockIdx.x * WARPS + warp; tile < tiles;
       tile += (long long)gridDim.x * WARPS) {
    const long long b = tile / per_b, p0 = (tile - b * per_b) * 16;
    const int n = (int)(P - p0 < 16 ? P - p0 : 16);
    __syncwarp();  // the previous tile's reads of the staging are done
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* fp = feat + ((b * S + s) * P + p0) * C;
      const float* dp = dirs + ((b * S + s) * P + p0) * 4;
      for (int i = lane; i < 16 * C; i += 32) stage[s * 16 * C + i] = i < n * C ? __ldg(fp + i) : 0.f;
      for (int i = lane; i < 16 * 4; i += 32) stage[SD + s * 64 + i] = i < n * 4 ? __ldg(dp + i) : 0.f;
    }
    if constexpr (VOX)
      for (int i = lane; i < 16 * 8; i += 32)
        stage[SX + i] = i < n * 8 ? __ldg(vox + (b * P + p0) * 8 + i) : 0.f;
    __syncwarp();
    // staged values: feature channel c and dir component k of view s, tile row r
    auto f0 = [&](int s, int r, int c) { return c < C ? stage[(s * 16 + r) * C + c] : 0.f; };
    auto dir = [&](int s, int r, int k) { return k < 4 ? stage[SD + (s * 16 + r) * 4 + k] : 0.f; };
    // [feat, dir] column c of view s (color0's per-view input)
    auto fd = [&](int s, int r, int c) { return c < C ? f0(s, r, c) : dir(s, r, c - C); };
    // view s's features after the view-direction conditioning
    auto conditioned = [&](int s, float (&fs)[NC][4]) {
      if (VIEWDIR) {
        uint32_t a[1][4] = {{pack(dir(s, g, 2 * t), dir(s, g, 2 * t + 1)),
                             pack(dir(s, g + 8, 2 * t), dir(s, g + 8, 2 * t + 1)), 0u, 0u}};
        zero(fs);
        dense<1, NC, L::LV>(a, w + 2 * L::MV, 0, fs);
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), r = g + (e >> 1) * 8;
          fs[j][e] = f0(s, r, c) + (VIEWDIR ? relu(fs[j][e] + vec[L::BV + c]) : 0.f);
        }
    };
    // global_fc of one view: relu(stat + bias + [img] part)
    auto global_view = [&](float (&fs)[NC][4], const float (&stat)[4][4], float (&g32)[4][4]) {
      uint32_t a[KC][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) g32[j][e] = stat[j][e] + vec[L::BG + 8 * j + 2 * t + (e & 1)];
      to_frags(fs, a);
      dense<KC, 4, L::LG>(a, w + 2 * L::MG, 0, g32);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) g32[j][e] = relu(g32[j][e]);
    };
    // global_fc over [var, avg], shared by the views
    auto shared_stat = [&](float (&var)[NC][4], float (&avg)[NC][4], float (&stat)[4][4]) {
      uint32_t a[KC][4];
      zero(stat);
      to_frags(var, a);
      dense<KC, 4, L::LG>(a, w + 2 * L::MG, L::CP, stat);
      to_frags(avg, a);
      dense<KC, 4, L::LG>(a, w + 2 * L::MG, 2 * L::CP, stat);
    };

    // --- Agg: mean and variance over views, global_fc, softmax pooling ---
    float im[4][4];
    if constexpr (SN > 0) {
      float fs[SN][NC][4], avg[NC][4], var[NC][4], stat[4][4];
#pragma unroll
      for (int s = 0; s < SN; ++s) conditioned(s, fs[s]);
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float m = 0.f;
#pragma unroll
          for (int s = 0; s < SN; ++s) m += fs[s][j][e];
          m = m / SN;
          float v = 0.f;
#pragma unroll
          for (int s = 0; s < SN; ++s) v += (fs[s][j][e] - m) * (fs[s][j][e] - m);
          avg[j][e] = m;
          var[j][e] = v / SN;
        }
      shared_stat(var, avg, stat);
      float g32[SN][4][4], wt[2][SN];
#pragma unroll
      for (int s = 0; s < SN; ++s) global_view(fs[s], stat, g32[s]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = 0.f;  // the logits are relu outputs, so the max is >= 0
#pragma unroll
        for (int s = 0; s < SN; ++s) {
          wt[r][s] = relu(row_dot(g32[s], vec + L::WA, r) + vec[L::BA]);
          mx = fmaxf(mx, wt[r][s]);
        }
        float z = 0.f;
#pragma unroll
        for (int s = 0; s < SN; ++s) {
          wt[r][s] = expf(wt[r][s] - mx);
          z += wt[r][s];
        }
#pragma unroll
        for (int s = 0; s < SN; ++s) wt[r][s] = wt[r][s] / z;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a = 0.f;
#pragma unroll
          for (int s = 0; s < SN; ++s) a += g32[s][j][e] * wt[e >> 1][s];
          im[j][e] = a;
        }
    } else {
      // the conditioned features are recomputed in each pass over the
      // views: the mean, the variance about it, global_fc
      float avg[NC][4], var[NC][4], fs[NC][4], stat[4][4];
      zero(avg);
      zero(var);
      for (int s = 0; s < S; ++s) {
        conditioned(s, fs);
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) avg[j][e] += fs[j][e];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) avg[j][e] = avg[j][e] / S;
      for (int s = 0; s < S; ++s) {
        conditioned(s, fs);
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) var[j][e] += (fs[j][e] - avg[j][e]) * (fs[j][e] - avg[j][e]);
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) var[j][e] = var[j][e] / S;
      shared_stat(var, avg, stat);
      // the pooling softmax over views online (the logits are relu outputs,
      // so a running maximum that starts at 0 is the maximum)
      float mx[2] = {0.f, 0.f}, z[2] = {0.f, 0.f};
      zero(im);
      for (int s = 0; s < S; ++s) {
        conditioned(s, fs);
        float g32[4][4];
        global_view(fs, stat, g32);
        float ex[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float lg = relu(row_dot(g32, vec + L::WA, r) + vec[L::BA]);
          if (lg > mx[r]) {
            const float k = expf(mx[r] - lg);
            z[r] *= k;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              im[j][2 * r] *= k;
              im[j][2 * r + 1] *= k;
            }
            mx[r] = lg;
          }
          ex[r] = expf(lg - mx[r]);
          z[r] += ex[r];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) im[j][e] += g32[j][e] * ex[e >> 1];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) im[j][e] = im[j][e] / z[e >> 1];
    }
    // lr0's input, and color0's from column 64: [vox 8, agg 16, 0 8] | [agg 16]
    uint32_t va[KL][4];
    {
      uint32_t a[2][4];
      to_frags(im, a);
      float agg[2][4];
      zero(agg);
      dense<2, 2, L::LF>(a, w + 2 * L::MF, 0, agg);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) agg[j][e] = relu(agg[j][e] + vec[L::BF + 8 * j + 2 * t + (e & 1)]);
      if constexpr (VOX) {
        const float* vx = stage + SX;
        va[0][0] = pack(vx[g * 8 + 2 * t], vx[g * 8 + 2 * t + 1]);
        va[0][1] = pack(vx[(g + 8) * 8 + 2 * t], vx[(g + 8) * 8 + 2 * t + 1]);
        va[0][2] = pack(agg[0][0], agg[0][1]);
        va[0][3] = pack(agg[0][2], agg[0][3]);
        va[KL - 1][0] = pack(agg[1][0], agg[1][1]);
        va[KL - 1][1] = pack(agg[1][2], agg[1][3]);
        va[KL - 1][2] = va[KL - 1][3] = 0u;
      } else {
        to_frags(agg, va);
      }
    }

    // --- trunk and sigma ---
    float x[8][4];
    zero(x);
    dense<KL, 8, L::LL>(va, w + 2 * L::ML, 0, x);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = relu(x[j][e] + vec[L::BL + 8 * j + 2 * t + (e & 1)]);
    const float sg0 = softplus(row_dot(x, vec + L::WS, 0) + vec[L::BS]);
    const float sg1 = softplus(row_dot(x, vec + L::WS, 1) + vec[L::BS]);

    // --- color: color0 over [x, (vox,) agg] once, over [feat, dir] per view ---
    float base[8][4];
    {
      uint32_t xa[4][4], a[4 + KL][4];
      to_frags(x, xa);
#pragma unroll
      for (int k = 0; k < 4 + KL; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[k][r] = k < 4 ? xa[k][r] : va[k - 4][r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) base[j][e] = vec[L::BC + 8 * j + 2 * t + (e & 1)];
      dense<4 + KL, 8, L::LB>(a, w + 2 * L::MB, 0, base);
    }
    // view s's colour logits of rows g (cw0) and g + 8 (cw1)
    auto color_logits = [&](int s, float& cw0, float& cw1) {
      uint32_t a[KV][4];
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        const int c = 16 * k + 2 * t;
        a[k][0] = pack(fd(s, g, c), fd(s, g, c + 1));
        a[k][1] = pack(fd(s, g + 8, c), fd(s, g + 8, c + 1));
        a[k][2] = pack(fd(s, g, c + 8), fd(s, g, c + 9));
        a[k][3] = pack(fd(s, g + 8, c + 8), fd(s, g + 8, c + 9));
      }
      float h[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[j][e] = base[j][e];
      dense<KV, 8, L::LC>(a, w + 2 * L::MC, 0, h);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[j][e] = relu(h[j][e]);
      cw0 = relu(row_dot(h, vec + L::WC, 0) + vec[L::BC1]);
      cw1 = relu(row_dot(h, vec + L::WC, 1) + vec[L::BC1]);
    };
    // the softmax over views and the RGB blend (f32) of row g + 8 r, in
    // thread t = r
    const int r = t & 1;
    float rgb[3] = {0.f, 0.f, 0.f};
    if constexpr (SN > 0) {
      float cw[2][SN];
#pragma unroll
      for (int s = 0; s < SN; ++s) color_logits(s, cw[0][s], cw[1][s]);
      float mx = 0.f;
#pragma unroll
      for (int s = 0; s < SN; ++s) mx = fmaxf(mx, cw[r][s]);
      float z = 0.f, e[SN];
#pragma unroll
      for (int s = 0; s < SN; ++s) {
        e[s] = expf(cw[r][s] - mx);
        z += e[s];
      }
#pragma unroll
      for (int s = 0; s < SN; ++s)
#pragma unroll
        for (int j = 0; j < 3; ++j) rgb[j] += f0(s, g + 8 * r, C - 3 + j) * (e[s] / z);
    } else {
      // online: a running maximum, the sum and the blend rescaled as it grows
      float cmx = 0.f, cz = 0.f;
      for (int s = 0; s < S; ++s) {
        float cw0, cw1;
        color_logits(s, cw0, cw1);
        const float lg = r ? cw1 : cw0;
        if (lg > cmx) {
          const float k = expf(cmx - lg);
          cz *= k;
#pragma unroll
          for (int j = 0; j < 3; ++j) rgb[j] *= k;
          cmx = lg;
        }
        const float ex = expf(lg - cmx);
        cz += ex;
#pragma unroll
        for (int j = 0; j < 3; ++j) rgb[j] += f0(s, g + 8 * r, C - 3 + j) * ex;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) rgb[j] = rgb[j] / cz;
    }
    // one thread per row writes
    if (t < 2 && g + 8 * t < n)
      reinterpret_cast<float4*>(out)[b * P + p0 + g + 8 * r] =
          make_float4(rgb[0], rgb[1], rgb[2], r ? sg1 : sg0);
  }
}

template <int C, bool VIEWDIR, bool VOX, int SN>
int launch(const void* mats, int n_mats, const void* vecs, int n_vecs, const void* vox,
           const void* feat, const void* dirs, void* out, int B, int S, long long P, int sms,
           cudaStream_t stream) {
  using L = Layout<C, VIEWDIR, VOX>;
  if (n_mats != L::M_N || n_vecs != L::V_N || (VOX && vox == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = enerf_head_kernel<C, VIEWDIR, VOX, SN>;
  const size_t smem = L::smem(S);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARPS * 32, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((P + 15) / 16 * B + WARPS - 1) / WARPS;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(blocks < most ? blocks : most);
  kernel<<<grid, WARPS * 32, smem, stream>>>((const __nv_bfloat16*)mats, (const float*)vecs,
                                             (const float*)vox, (const float*)feat,
                                             (const float*)dirs, (float*)out, B, S, P);
  return (int)cudaGetLastError();
}

// S = 3, every path's view count (a combination of the boost recipe), at
// compile time; any other count in run-time loops
template <int C, bool VIEWDIR, bool VOX>
int launch_views(const void* mats, int n_mats, const void* vecs, int n_vecs, const void* vox,
                 const void* feat, const void* dirs, void* out, int B, int S, long long P,
                 int sms, cudaStream_t stream) {
  return S == 3 ? launch<C, VIEWDIR, VOX, 3>(mats, n_mats, vecs, n_vecs, vox, feat, dirs, out, B,
                                             S, P, sms, stream)
                : launch<C, VIEWDIR, VOX, 0>(mats, n_mats, vecs, n_vecs, vox, feat, dirs, out, B,
                                             S, P, sms, stream);
}

template <int C>
int launch_head(const void* mats, int n_mats, const void* vecs, int n_vecs, const void* vox,
                const void* feat, const void* dirs, void* out, int B, int S, long long P,
                int viewdir, int sms, cudaStream_t stream) {
#define HEAD_CALL mats, n_mats, vecs, n_vecs, vox, feat, dirs, out, B, S, P, sms, stream
  if (vox != nullptr)
    return viewdir ? launch_views<C, true, true>(HEAD_CALL)
                   : launch_views<C, false, true>(HEAD_CALL);
  return viewdir ? launch_views<C, true, false>(HEAD_CALL)
                 : launch_views<C, false, false>(HEAD_CALL);
#undef HEAD_CALL
}

}  // namespace

// The channel counts instantiated: cost volumes over the level-1 (8 + RGB)
// and level-0 (32 + RGB) feature maps (ops/cuda/enerf_head.py CHANNELS),
// each with and without view-direction conditioning (viewdir_agg) and with
// and without voxel features (vox null: use_vox_feat false), every one a
// model can call; any view count from 2 to MAX_VIEWS.
extern "C" int enerf_head_launch(const void* mats, int n_mats, const void* vecs, int n_vecs,
                                 const void* vox, const void* feat, const void* dirs, void* out,
                                 int B, int S, long long P, int C, int viewdir, int sms,
                                 void* stream) {
  if (sms < 1 || S < 2 || S > MAX_VIEWS) return (int)cudaErrorInvalidValue;
  if ((long long)B * P == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 11) return launch_head<11>(mats, n_mats, vecs, n_vecs, vox, feat, dirs, out, B, S, P,
                                      viewdir, sms, st);
  if (C == 35) return launch_head<35>(mats, n_mats, vecs, n_vecs, vox, feat, dirs, out, B, S, P,
                                      viewdir, sms, st);
  return (int)cudaErrorInvalidValue;
}
