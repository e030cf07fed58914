// The whole ENeRF IBR head per sample, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel _head_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/enerf_head.py:221), entry fused_nerf_head
// (:186): view-direction conditioning, mean/var over views, global_fc,
// softmax view pooling, fc, lr0, softplus sigma, color0/color1 and the
// softmax blend of the source-view RGB.
//
// What bounds it on an H100: f32 arithmetic. A sample costs ~25 kflop of
// small dense layers (S=3, C=11) against ~230 bytes of input and 16 of
// output, so at the f32 SIMT rate the flops take ~5x longer than the bytes.
// The design keeps every activation in registers (one thread per sample,
// nothing but the raw (rgb, sigma) written back), stages all head weights
// once per block in shared memory where every lane of a warp reads the same
// weight at once (a broadcast, no bank conflicts), and runs a grid-stride
// loop over a grid of a few blocks per SM so each block loads the ~40 KB
// of weights once. Templates on S and C unroll every layer so the per-view
// arrays stay in registers. The tensor cores are left for a later version.

#include <cuda_runtime.h>

namespace {

constexpr int HID = 64;

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// log1p(exp(-|x|)) + max(x, 0), the form jax.nn.softplus computes
__device__ __forceinline__ float softplus(float x) { return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f); }

template <int S, int C, bool VIEWDIR>
struct Layout {
  static constexpr int VW = 0;                                // view_fc (C, 4)
  static constexpr int VB = VW + (VIEWDIR ? C * 4 : 0);       // (C)
  static constexpr int GW = VB + (VIEWDIR ? C : 0);           // global_fc (32, 3C)
  static constexpr int GB = GW + 32 * 3 * C;
  static constexpr int AW = GB + 32;                          // agg_w_fc (1, 32)
  static constexpr int AB = AW + 32;
  static constexpr int FW = AB + 1;                           // fc (16, 32)
  static constexpr int FB = FW + 16 * 32;
  static constexpr int LW = FB + 16;                          // lr0 (64, 24)
  static constexpr int LB = LW + HID * 24;
  static constexpr int SW = LB + HID;                         // sigma (1, 64)
  static constexpr int SB = SW + HID;
  static constexpr int IN0 = HID + 24 + C + 4;                // color0 input width
  static constexpr int CW = SB + 1;                           // color0 (64, IN0)
  static constexpr int CB = CW + HID * IN0;
  static constexpr int C1W = CB + HID;                        // color1 (1, 64)
  static constexpr int C1B = C1W + HID;
  static constexpr int N = C1B + 1;
};

template <int S, int C, bool VIEWDIR>
__global__ void __launch_bounds__(128) enerf_head_kernel(
    const float* __restrict__ weights,  // packed, Layout<S, C, VIEWDIR>
    const float* __restrict__ vox,      // (B, P, 8)
    const float* __restrict__ feat,     // (B, S, P, C)
    const float* __restrict__ dirs,     // (B, S, P, 4)
    float* __restrict__ out,            // (B, P, 4)
    int B, long long P) {
  using L = Layout<S, C, VIEWDIR>;
  extern __shared__ float w[];
  for (int i = threadIdx.x; i < L::N; i += blockDim.x) w[i] = weights[i];
  __syncthreads();

  const long long total = (long long)B * P;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long b = t / P, p = t - b * P;
    float f0[S][C], d[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* fp = feat + ((b * S + s) * P + p) * C;
      const float* dp = dirs + ((b * S + s) * P + p) * 4;
#pragma unroll
      for (int c = 0; c < C; ++c) f0[s][c] = fp[c];
#pragma unroll
      for (int k = 0; k < 4; ++k) d[s][k] = dp[k];
    }

    // --- Agg: view conditioning, mean/var over views, softmax pooling ---
    float fs[S][C];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float a = f0[s][c];
        if (VIEWDIR) {
          float h = w[L::VB + c];
#pragma unroll
          for (int k = 0; k < 4; ++k) h += w[L::VW + c * 4 + k] * d[s][k];
          a += relu(h);
        }
        fs[s][c] = a;
      }
    }
    float avg[C], var[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float m = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) m += fs[s][c];
      m = m / S;
      float v = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) v += (fs[s][c] - m) * (fs[s][c] - m);
      avg[c] = m;
      var[c] = v / S;
    }
    float g[S][32];
#pragma unroll
    for (int o = 0; o < 32; ++o) {
      const float* row = w + L::GW + o * 3 * C;  // [img (C), var (C), avg (C)]
      float stat = w[L::GB + o];
#pragma unroll
      for (int c = 0; c < C; ++c) stat += row[C + c] * var[c] + row[2 * C + c] * avg[c];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float a = stat;
#pragma unroll
        for (int c = 0; c < C; ++c) a += row[c] * fs[s][c];
        g[s][o] = relu(a);
      }
    }
    float aw[S], mx = 0.f;  // the logits are relu outputs, so the max is >= 0
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float a = w[L::AB];
#pragma unroll
      for (int o = 0; o < 32; ++o) a += w[L::AW + o] * g[s][o];
      aw[s] = relu(a);
      mx = fmaxf(mx, aw[s]);
    }
    float z = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      aw[s] = expf(aw[s] - mx);
      z += aw[s];
    }
    float im[32];
#pragma unroll
    for (int o = 0; o < 32; ++o) {
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) a += g[s][o] * (aw[s] / z);
      im[o] = a;
    }
    float vi[24];  // [vox (8), aggregated image feature (16)]
    const float* vp = vox + t * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) vi[k] = vp[k];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float a = w[L::FB + j];
#pragma unroll
      for (int o = 0; o < 32; ++o) a += w[L::FW + j * 32 + o] * im[o];
      vi[8 + j] = relu(a);
    }

    // --- trunk and sigma ---
    float x[HID];
    float sg = w[L::SB];
#pragma unroll
    for (int h = 0; h < HID; ++h) {
      float a = w[L::LB + h];
#pragma unroll
      for (int k = 0; k < 24; ++k) a += w[L::LW + h * 24 + k] * vi[k];
      x[h] = relu(a);
      sg += w[L::SW + h] * x[h];
    }

    // --- color: per-view weights from color0/color1, softmax RGB blend ---
    float cw[S];
#pragma unroll
    for (int s = 0; s < S; ++s) cw[s] = w[L::C1B];
#pragma unroll 1
    for (int h = 0; h < HID; ++h) {
      const float* row = w + L::CW + h * L::IN0;  // [x (64), vi (24), feat (C), dir (4)]
      float base = w[L::CB + h];
#pragma unroll
      for (int k = 0; k < HID; ++k) base += row[k] * x[k];
#pragma unroll
      for (int k = 0; k < 24; ++k) base += row[HID + k] * vi[k];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float a = base;
#pragma unroll
        for (int c = 0; c < C; ++c) a += row[HID + 24 + c] * f0[s][c];
#pragma unroll
        for (int k = 0; k < 4; ++k) a += row[HID + 24 + C + k] * d[s][k];
        cw[s] += w[L::C1W + h] * relu(a);
      }
    }
    mx = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      cw[s] = relu(cw[s]);
      mx = fmaxf(mx, cw[s]);
    }
    z = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      cw[s] = expf(cw[s] - mx);
      z += cw[s];
    }
    float4 o4;
    float rgb[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int j = 0; j < 3; ++j) rgb[j] += f0[s][C - 3 + j] * (cw[s] / z);
    }
    o4.x = rgb[0];
    o4.y = rgb[1];
    o4.z = rgb[2];
    o4.w = softplus(sg);
    reinterpret_cast<float4*>(out)[t] = o4;
  }
}

template <int S, int C, bool VIEWDIR>
int launch(const void* weights, int n_weights, const void* vox, const void* feat,
           const void* dirs, void* out, int B, long long P, int grid, cudaStream_t stream) {
  using L = Layout<S, C, VIEWDIR>;
  if (n_weights != L::N) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * L::N;
  auto kernel = enerf_head_kernel<S, C, VIEWDIR>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 128, smem, stream>>>((const float*)weights, (const float*)vox,
                                      (const float*)feat, (const float*)dirs, (float*)out, B,
                                      P);
  return (int)cudaGetLastError();
}

}  // namespace

// The (S, C) pairs instantiated: 3-view cost volumes over the level-1
// (8 + RGB) and level-0 (32 + RGB) feature maps (ops/cuda/enerf_head.py
// SUPPORTED), each with and without view-direction conditioning, each with
// its own C entry point. Compiled with -DENERF_HEAD_UNIT=0..3 a translation
// unit holds one instance, and with 4 the dispatcher, so the slow unrolled
// instances build in parallel (ops/cuda/_build.py UNITS); without the
// macro one unit holds everything.
#define HEAD_ARGS                                                                          \
  const void *weights, int n_weights, const void *vox, const void *feat, const void *dirs, \
      void *out, int B, long long P, int grid, cudaStream_t st
#define HEAD_CALL weights, n_weights, vox, feat, dirs, out, B, P, grid, st
#ifndef ENERF_HEAD_UNIT
#define ENERF_HEAD_ALL 1
#define ENERF_HEAD_UNIT -1
#else
#define ENERF_HEAD_ALL 0
#endif

extern "C" {
int enerf_head_3_11_v(HEAD_ARGS);
int enerf_head_3_11(HEAD_ARGS);
int enerf_head_3_35_v(HEAD_ARGS);
int enerf_head_3_35(HEAD_ARGS);

#if ENERF_HEAD_ALL || ENERF_HEAD_UNIT == 0
int enerf_head_3_11_v(HEAD_ARGS) { return launch<3, 11, true>(HEAD_CALL); }
#endif
#if ENERF_HEAD_ALL || ENERF_HEAD_UNIT == 1
int enerf_head_3_11(HEAD_ARGS) { return launch<3, 11, false>(HEAD_CALL); }
#endif
#if ENERF_HEAD_ALL || ENERF_HEAD_UNIT == 2
int enerf_head_3_35_v(HEAD_ARGS) { return launch<3, 35, true>(HEAD_CALL); }
#endif
#if ENERF_HEAD_ALL || ENERF_HEAD_UNIT == 3
int enerf_head_3_35(HEAD_ARGS) { return launch<3, 35, false>(HEAD_CALL); }
#endif

#if ENERF_HEAD_ALL || ENERF_HEAD_UNIT == 4
int enerf_head_launch(const void* weights, int n_weights, const void* vox, const void* feat,
                      const void* dirs, void* out, int B, int S, long long P, int C, int viewdir,
                      int grid, void* stream) {
  if ((long long)B * P == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 3 && C == 11)
    return viewdir ? enerf_head_3_11_v(HEAD_CALL) : enerf_head_3_11(HEAD_CALL);
  if (S == 3 && C == 35)
    return viewdir ? enerf_head_3_35_v(HEAD_CALL) : enerf_head_3_35(HEAD_CALL);
  return (int)cudaErrorInvalidValue;
}
#endif
}  // extern "C"
