// Backward of the fused plane-sweep warp + variance cost volume, f32, for
// sm_90a.
//
// Replaces the Pallas TPU kernel _warp_bwd_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/warp_variance.py:419), entry
// _warp_variance_bwd (:371), the backward of fused_warp_variance_diff: given
// the variance cotangent g (B, D, Ht, Wt, C), it returns
//
//   d feats (B, S, Hs, Ws, C): the per-view cotangent
//       g_s = g * (2/S) * (w_s - mean)
//     scattered through the transposed bilinear interpolation (each tap
//     receives g_s times its bilinear weight);
//   d depth (B, D, Ht, Wt): the x/y derivatives of the triangle weights,
//     chained through x = sx / max(sz, 1e-6) with sx, sy, sz linear in
//     1/depth, summed over views and channels.
//
// Conventions of the Pallas kernel (trap: they differ from autodiff of a
// floor-based sampler at exact integers and clamp bounds): the derivative of
// a triangle weight max(0, 1 - |j - x|) is sign(j - x) where |j - x| < 1 and
// 0 elsewhere, so dx = 0 at an integer x; the coordinates clamped to
// [-2, size+1] carry a gradient only inside that range, bounds included; a
// clamped z (sz <= 1e-6) carries none.
//
// What bounds it on an H100: the d feats scatter. From device memory it
// needs the features, depths and cotangent once and writes d feats and d
// depth once, but the scatter adds S x 4 taps x C values per voxel into
// source pixels that neighbouring voxels share: one scalar atomic each is
// ~5e8 L2 atomics per launch on the main path, which is what the L2's
// atomic units take ~3 ms to do.
//
// Design (plane_sweep.cuh's tiling, as the forward). For each chunk (a tile
// of target pixels x a run of neighbouring planes) one thread per (voxel,
// view) projects the voxel once and stages its taps, weights, fractions and
// the two coordinate derivatives d x / d (1/depth), d y / d (1/depth) in
// shared memory; pass 1 (the mean over views) and pass 2 (the cotangents)
// both read that staging, so nothing is projected twice. One thread per
// (pixel, 4 channels) walks the run's planes view by view. Neighbouring
// planes of a pixel project a fraction of a source pixel apart, so most
// planes find their four taps at the pixel the last plane used: the thread
// keeps those four tap values, and the four taps' shares of d feats, in
// registers, and only when the taps move (or the run ends) adds each
// share to device memory with one 16-byte vector atomic per (pixel, 4
// channels). That is the Hopper form of the TPU kernel's d feats
// accumulator in VMEM (:371-377): the run of planes is where a pixel's
// taps repeat. Summing into a window of d feats in shared memory first was
// measured slower: nvcc compiles a shared-memory f32 atomicAdd for sm_90a
// to a compare-and-swap loop, and those loops cost more than they saved
// (PERF.md, section 6). The depth cotangent is summed over views in
// registers and over the pixel's channel groups with warp shuffles (a
// pixel's groups are neighbouring lanes): no atomic.

#include <cuda_runtime.h>

#include "plane_sweep.cuh"

namespace {

using namespace plane_sweep;

constexpr int kThreads = 256;
constexpr int kPlanes = 4;  // the most planes in a run (ops/cuda/warp_variance.py)

struct __align__(16) Tap {
  float4 w;        // weights of taps 00, 01, 10, 11 (0 outside the image)
  float tx, ty;    // fractions of the clamped coordinates
  float cx, cy;    // d x / d (1/depth) where x carries a gradient, else 0; y likewise
  int p00;         // tap 00's pixel index in the view, clamped into the image
  int step_x;      // pixels to the next column's tap (0 where clamped)
  int step_y;      // pixels to the next row's tap
  int pad;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// c += v * w per channel
__device__ __forceinline__ float4 fma4(float4 c, float4 v, float w) {
  return make_float4(c.x + v.x * w, c.y + v.y * w, c.z + v.z * w, c.w + v.w * w);
}

// one 16-byte vector atomic, where the share is not zero (a tap outside
// the image has weight 0 in every plane)
__device__ __forceinline__ void add4(float4* dst, float4 v) {
  if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) atomicAdd(dst, v);
}

__global__ void __launch_bounds__(kThreads, 2) warp_variance_bwd_kernel(
    const float* __restrict__ feats,  // (B, S, Hs, Ws, C)
    const float* __restrict__ proj,   // (B, S, 3, 4)
    const float* __restrict__ depth,  // (B, D, Ht, Wt)
    const float* __restrict__ g,      // (B, D, Ht, Wt, C)
    float* __restrict__ dfeats,       // (B, S, Hs, Ws, C), zeroed
    float* __restrict__ ddepth,       // (B, D, Ht, Wt), zeroed
    int S, int Hs, int Ws, int C, int D, int Ht, int Wt, Tiling tl, int shuffle) {
  extern __shared__ float4 smem[];
  const int G = C >> 2, TP = tl.TX * tl.TY, NV = TP * tl.ND;
  float* Ps = reinterpret_cast<float*>(smem);                    // (S, 12)
  Tap* taps = reinterpret_cast<Tap*>(smem + (S * 12 + 3) / 4);  // (S, ND, TP)
  const Block blk = block_of(tl, D);
  for (int i = threadIdx.x; i < S * 12; i += kThreads) Ps[i] = proj[(long long)blk.b * S * 12 + i];
  const long long HWs = (long long)Hs * Ws;
  const float* img_b = feats + (long long)blk.b * S * HWs * C;
  float4* dimg_b = reinterpret_cast<float4*>(dfeats + (long long)blk.b * S * HWs * C);
  const float inv_s = 1.f / (float)S, c2 = 2.f / (float)S;

  for (int d0 = blk.d_begin; d0 < blk.d_end; d0 += tl.ND) {
    const int nd = min(tl.ND, D - d0);
    __syncthreads();  // the matrices are in; the last chunk's taps used
    // one thread per (voxel, view): project once, stage the taps
    for (int v = threadIdx.x; v < NV; v += kThreads) {
      const Local l = local_of(tl, v);
      const int x = blk.x0 + l.x, y = blk.y0 + l.y, d = d0 + l.d;
      const bool inside = x < Wt && y < Ht && d < D;
      const float dep = inside ? depth[(((long long)blk.b * D + d) * Ht + y) * Wt + x] : 1.f;
      for (int s = 0; s < S; ++s) {
        Tap t;
        t.w = make_float4(0.f, 0.f, 0.f, 0.f);
        t.tx = t.ty = t.cx = t.cy = 0.f;
        t.p00 = t.step_x = t.step_y = t.pad = 0;
        if (inside) {
          const float* P = Ps + s * 12;
          const Proj p = project(P, (float)x, (float)y, dep);
          const Taps k = bilinear(p.xu, p.yu, Hs, Ws);
          const float pz = p.live ? P[11] : 0.f;
          t.w = k.w;
          t.tx = k.tx;
          t.ty = k.ty;
          // zero at an integer coordinate and outside the clamp range
          t.cx = k.in_x && k.tx != 0.f ? (P[3] - p.xu * pz) / p.sz : 0.f;
          t.cy = k.in_y && k.ty != 0.f ? (P[7] - p.yu * pz) / p.sz : 0.f;
          t.p00 = k.y0 * Ws + k.x0;
          t.step_x = k.dx;
          t.step_y = k.dy * Ws;
        }
        taps[s * NV + v] = t;
      }
    }
    __syncthreads();

    // one thread per (pixel, 4 channels); every lane stays for the shuffles
    for (int base = 0; base < TP * G; base += kThreads) {
      const int i = base + threadIdx.x, pix = i / G, grp = i - pix * G;
      const int x = blk.x0 + (pix & (tl.TX - 1)), y = blk.y0 + (pix >> tl.lx);
      const bool active = i < TP * G && x < Wt && y < Ht;
      const long long vox0 = (((long long)blk.b * D + d0) * Ht + y) * Wt + x;  // plane d0
      const long long plane = (long long)Ht * Wt;
      float gdep[kPlanes];
#pragma unroll
      for (int dd = 0; dd < kPlanes; ++dd) gdep[dd] = 0.f;
      if (active) {
        // pass 1: the mean over views of each plane's warped features
        float4 mean[kPlanes], gv[kPlanes];
#pragma unroll
        for (int dd = 0; dd < kPlanes; ++dd) mean[dd] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < S; ++s) {
          const float* img = img_b + s * HWs * C + 4 * grp;
          int key = -1, kx = 0, ky = 0;
          float4 q00, q01, q10, q11;
#pragma unroll
          for (int dd = 0; dd < kPlanes; ++dd) {
            if (dd >= nd) break;
            const Tap& t = taps[(s * tl.ND + dd) * TP + pix];
            if (t.p00 != key || t.step_x != kx || t.step_y != ky) {
              const float* p = img + (long long)t.p00 * C;
              q00 = load4(p);
              q01 = load4(p + t.step_x * C);
              q10 = load4(p + t.step_y * C);
              q11 = load4(p + (t.step_x + t.step_y) * C);
              key = t.p00;
              kx = t.step_x;
              ky = t.step_y;
            }
            float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
            w = axpy4(w, q00, t.w.x);
            w = axpy4(w, q01, t.w.y);
            w = axpy4(w, q10, t.w.z);
            w = axpy4(w, q11, t.w.w);
            mean[dd] = make_float4(mean[dd].x + w.x, mean[dd].y + w.y, mean[dd].z + w.z,
                                   mean[dd].w + w.w);
          }
        }
#pragma unroll
        for (int dd = 0; dd < kPlanes; ++dd) {
          if (dd >= nd) break;
          mean[dd] = make_float4(mean[dd].x * inv_s, mean[dd].y * inv_s, mean[dd].z * inv_s,
                                 mean[dd].w * inv_s);
          gv[dd] = __ldg(reinterpret_cast<const float4*>(g) + (vox0 + dd * plane) * G + grp);
        }

        // pass 2, view by view: per-view cotangent, its shares of d feats
        // summed while the taps stay put, the coordinate gradients
        for (int s = 0; s < S; ++s) {
          const float* img = img_b + s * HWs * C + 4 * grp;
          float4* dimg = dimg_b + s * HWs * G + grp;
          int key = -1, kx = 0, ky = 0;
          float4 q00, q01, q10, q11;
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 a00 = zero, a01 = zero, a10 = zero, a11 = zero;
#pragma unroll
          for (int dd = 0; dd < kPlanes; ++dd) {
            if (dd >= nd) break;
            const Tap t = taps[(s * tl.ND + dd) * TP + pix];
            if (t.p00 != key || t.step_x != kx || t.step_y != ky) {
              if (key >= 0) {
                add4(dimg + (long long)key * G, a00);
                add4(dimg + (long long)(key + kx) * G, a01);
                add4(dimg + (long long)(key + ky) * G, a10);
                add4(dimg + (long long)(key + kx + ky) * G, a11);
                a00 = a01 = a10 = a11 = zero;
              }
              const float* p = img + (long long)t.p00 * C;
              q00 = load4(p);
              q01 = load4(p + t.step_x * C);
              q10 = load4(p + t.step_y * C);
              q11 = load4(p + (t.step_x + t.step_y) * C);
              key = t.p00;
              kx = t.step_x;
              ky = t.step_y;
            }
            float4 w = zero;
            w = axpy4(w, q00, t.w.x);
            w = axpy4(w, q01, t.w.y);
            w = axpy4(w, q10, t.w.z);
            w = axpy4(w, q11, t.w.w);
            const float4 m = mean[dd], gg = gv[dd];
            const float4 gs = make_float4(gg.x * c2 * (w.x - m.x), gg.y * c2 * (w.y - m.y),
                                          gg.z * c2 * (w.z - m.z), gg.w * c2 * (w.w - m.w));
            a00 = fma4(a00, gs, t.w.x);
            a01 = fma4(a01, gs, t.w.y);
            a10 = fma4(a10, gs, t.w.z);
            a11 = fma4(a11, gs, t.w.w);
            // d w / d x: the right taps minus the left ones along each row
            // (zero at an integer x); d w / d y likewise down each column. A
            // tap outside the image reads a clamped pixel: its value is
            // masked as the plain version masks it.
            const float4 p00 = t.w.x != 0.f ? q00 : zero, p01 = t.w.y != 0.f ? q01 : zero;
            const float4 p10 = t.w.z != 0.f ? q10 : zero, p11 = t.w.w != 0.f ? q11 : zero;
            if (t.cx != 0.f) {
              const float4 r0 = sub4(p01, p00), r1 = sub4(p11, p10);
              gdep[dd] += dot4(gs, make_float4((1.f - t.ty) * r0.x + t.ty * r1.x,
                                               (1.f - t.ty) * r0.y + t.ty * r1.y,
                                               (1.f - t.ty) * r0.z + t.ty * r1.z,
                                               (1.f - t.ty) * r0.w + t.ty * r1.w)) * t.cx;
            }
            if (t.cy != 0.f) {
              const float4 c0 = sub4(p10, p00), c1 = sub4(p11, p01);
              gdep[dd] += dot4(gs, make_float4((1.f - t.tx) * c0.x + t.tx * c1.x,
                                               (1.f - t.tx) * c0.y + t.tx * c1.y,
                                               (1.f - t.tx) * c0.z + t.tx * c1.z,
                                               (1.f - t.tx) * c0.w + t.tx * c1.w)) * t.cy;
            }
          }
          if (key >= 0) {
            add4(dimg + (long long)key * G, a00);
            add4(dimg + (long long)(key + kx) * G, a01);
            add4(dimg + (long long)(key + ky) * G, a10);
            add4(dimg + (long long)(key + kx + ky) * G, a11);
          }
        }
      }
      // d depth: chain through 1/depth, sum over the pixel's channel groups
#pragma unroll
      for (int dd = 0; dd < kPlanes; ++dd) {
        if (dd >= nd) break;
        float gd = 0.f;
        if (active) {
          const float inv_d = 1.f / depth[vox0 + dd * plane];
          gd = gdep[dd] * (-inv_d * inv_d);
        }
        if (shuffle) {
          // G is a power of two <= 32: the pixel's groups are G neighbouring lanes
          for (int off = G >> 1; off > 0; off >>= 1) gd += __shfl_down_sync(0xffffffffu, gd, off, G);
          if (active && grp == 0) ddepth[vox0 + dd * plane] = gd;
        } else if (active) {
          atomicAdd(ddepth + vox0 + dd * plane, gd);
        }
      }
    }
  }
}

}  // namespace

// TX x TY x ND is the chunk (ops/cuda/warp_variance.py::sweep_tile), at most
// kPlanes planes; sms the card's SMs.
extern "C" int warp_variance_bwd_launch(const void* feats, const void* proj, const void* depth,
                                        const void* g, void* dfeats, void* ddepth, int B, int S,
                                        int Hs, int Ws, int C, int D, int Ht, int Wt, int TX,
                                        int TY, int ND, int sms, void* stream) {
  if (C % 4 != 0 || S < 1 || TX < 1 || TY < 1 || (TX & (TX - 1)) || (TY & (TY - 1)) ||
      ND < 1 || ND > kPlanes || sms < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * D * Ht * Wt == 0) return 0;
  const int G = C / 4;
  const int shuffle = G <= 32 && (G & (G - 1)) == 0;
  auto kernel = warp_variance_bwd_kernel;
  const size_t smem = 16 * (size_t)((S * 12 + 3) / 4) + sizeof(Tap) * (size_t)S * TX * TY * ND;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const Tiling tl = make_tiling(B, D, Ht, Wt, TX, TY, ND, (long long)sms * per_sm);
  const long long grid = (long long)B * tl.tiles_y * tl.tiles_x * tl.run_groups;
  kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)feats, (const float*)proj, (const float*)depth, (const float*)g,
      (float*)dfeats, (float*)ddepth, S, Hs, Ws, C, D, Ht, Wt, tl, shuffle);
  return (int)cudaGetLastError();
}
