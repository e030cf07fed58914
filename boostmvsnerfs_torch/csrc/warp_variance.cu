// Fused plane-sweep warp + variance cost volume for sm_90a, at f32
// (training, and warp_dtype float32) or with bf16 operands (eval).
//
// Replaces the Pallas TPU kernel _warp_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/warp_variance.py:211), entry
// fused_warp_variance (:150): for every (batch, depth plane, target pixel)
// project through each of S source views' 3x4 matrices at metric depth,
// sample the C-channel source features bilinearly with zeros padding, and
// write the population variance over the views. The bf16 instance keeps
// the Pallas kernel's compute_dtype contract: features and tap weights
// rounded to bf16, with f32 products (exact), sums and variance. It reads
// the f32 features and rounds each tap value as it loads it: the kernel's
// pace is not set by the bytes it loads (below), and a bf16 copy of the
// features, cast beforehand, cost a pass over them and saved nothing here
// (PERF.md, section 6).
//
// What bounds it on an H100: by its bound, memory. From device memory it
// needs the features and depths once and writes C floats of variance per
// voxel; the arithmetic is ~12 flops per channel per view. But each voxel
// gathers S views x 4 taps x C values, about ten times the device-memory
// bytes, and projects into S views (five IEEE divisions each), so in
// practice the instructions of the projections and the tap sums, and the
// L1 gather rate, set the pace.
//
// Design (plane_sweep.cuh's tiling). A block owns a tile of target pixels
// and walks runs of neighbouring depth planes over it. For each chunk (the
// tile x one run of planes) one thread per (voxel, view) projects the voxel
// once and stages its tap offset, steps and four weights in shared memory
// (taps outside the image at weight 0, their index clamped into it). Then
// one thread per (pixel, 4 channels) walks the run's planes view by view,
// keeping each plane's sum and sum of squares in registers. Neighbouring
// planes of a pixel project a fraction of a source pixel apart, so most
// planes find their four taps at the pixel the last plane used: the thread
// keeps those four values in registers and loads again only when the taps
// move. The loads it does make hit L1 mostly (a tile's pixels and a run's
// planes share their source footprint). The variance goes out with a
// streaming store (the output, 181 MB on the main path, would otherwise
// evict the features from L2). Every tap is a direct gather: exact
// everywhere, no window. The projections and tap weights are rounded as
// in the plain version (ops/cost_volume.variance_volume, at compute_dtype),
// so every tap is the plain version's; the tap sums and the sum of squares
// take one rounding per term (FMAs).

#include <cuda_runtime.h>

#include "plane_sweep.cuh"

namespace {

using namespace plane_sweep;

constexpr int kThreads = 256;
constexpr int kPlanes = 4;  // the most planes in a run (ops/cuda/warp_variance.py)

struct __align__(16) Tap {
  float4 w;        // weights of taps 00, 01, 10, 11 (0 outside the image)
  int p00;         // tap 00's pixel index in the view, clamped into the image
  int step_x;      // elements to the next column's tap (0 where clamped)
  int step_y;      // elements to the next row's tap
  int pad;
};

// four operands as the instance takes them: rounded to bf16 (round to
// nearest even, two per conversion) in the bf16 instance; a bf16 value
// widens to f32 exactly
template <bool BF16>
__device__ __forceinline__ float4 rnd4(float4 v) {
  if (!BF16) return v;
  unsigned a, b;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(a) : "f"(v.y), "f"(v.x));  // x low, y high
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(b) : "f"(v.w), "f"(v.z));
  return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}

template <bool BF16>
__device__ __forceinline__ float4 load4(const float* p) {
  return rnd4<BF16>(__ldg(reinterpret_cast<const float4*>(p)));
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 3) warp_variance_kernel(
    const float* __restrict__ feats,   // (B, S, Hs, Ws, C)
    const float* __restrict__ proj,    // (B, S, 3, 4)
    const float* __restrict__ depth,   // (B, D, Ht, Wt)
    float* __restrict__ out,           // (B, D, Ht, Wt, C)
    int S, int Hs, int Ws, int C, int D, int Ht, int Wt, Tiling tl) {
  extern __shared__ float4 smem[];
  const int G = C >> 2, TP = tl.TX * tl.TY, NV = TP * tl.ND;
  float* Ps = reinterpret_cast<float*>(smem);                    // (S, 12)
  Tap* taps = reinterpret_cast<Tap*>(smem + (S * 12 + 3) / 4);  // (S, ND, TP)
  const Block blk = block_of(tl, D);
  for (int i = threadIdx.x; i < S * 12; i += kThreads) Ps[i] = proj[(long long)blk.b * S * 12 + i];
  const long long HWs = (long long)Hs * Ws;
  const float* img_b = feats + (long long)blk.b * S * HWs * C;
  // 1/S: the plain version's division by S is a multiplication by its
  // reciprocal on the card (PyTorch divides by a scalar so)
  const float inv_s = 1.f / (float)S;

  for (int d0 = blk.d_begin; d0 < blk.d_end; d0 += tl.ND) {
    const int nd = min(tl.ND, D - d0);
    __syncthreads();  // the projection matrices are in, the last chunk's taps used
    // one thread per (voxel, view): project once, stage the taps
    for (int v = threadIdx.x; v < NV; v += kThreads) {
      const Local l = local_of(tl, v);
      const int x = blk.x0 + l.x, y = blk.y0 + l.y, d = d0 + l.d;
      const bool inside = x < Wt && y < Ht && d < D;
      const float dep = inside ? depth[(((long long)blk.b * D + d) * Ht + y) * Wt + x] : 1.f;
      for (int s = 0; s < S; ++s) {
        Tap t;
        t.w = make_float4(0.f, 0.f, 0.f, 0.f);
        t.p00 = t.step_x = t.step_y = t.pad = 0;
        if (inside) {
          const Proj p = project(Ps + s * 12, (float)x, (float)y, dep);
          const Taps k = bilinear(p.xu, p.yu, Hs, Ws);
          t.w = rnd4<BF16>(k.w);
          t.p00 = k.y0 * Ws + k.x0;
          t.step_x = k.dx * C;
          t.step_y = k.dy * Ws * C;
        }
        taps[s * NV + v] = t;
      }
    }
    __syncthreads();
    // one thread per (pixel, 4 channels) walks the run's planes, view by
    // view, keeping each plane's sum and sum of squares in registers; the
    // four tap values are reloaded only when the taps move to another pixel
    for (int i = threadIdx.x; i < TP * G; i += kThreads) {
      const int pix = i / G, grp = i - pix * G;
      const int x = blk.x0 + (pix & (tl.TX - 1)), y = blk.y0 + (pix >> tl.lx);
      if (x >= Wt || y >= Ht) continue;
      float4 sum[kPlanes], sq[kPlanes];
#pragma unroll
      for (int dd = 0; dd < kPlanes; ++dd) sum[dd] = sq[dd] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < S; ++s) {
        const float* img = img_b + s * HWs * C + 4 * grp;
        int key = -1, kx = 0, ky = 0;
        float4 q00, q01, q10, q11;
#pragma unroll
        for (int dd = 0; dd < kPlanes; ++dd) {
          if (dd >= nd) break;
          const Tap t = taps[(s * tl.ND + dd) * TP + pix];
          if (t.p00 != key || t.step_x != kx || t.step_y != ky) {
            // every tap lies in the image (clamped); one outside it has weight 0
            const float* p = img + (long long)t.p00 * C;
            q00 = load4<BF16>(p);
            q01 = load4<BF16>(p + t.step_x);
            q10 = load4<BF16>(p + t.step_y);
            q11 = load4<BF16>(p + t.step_x + t.step_y);
            key = t.p00;
            kx = t.step_x;
            ky = t.step_y;
          }
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          acc = axpy4(acc, q00, t.w.x);
          acc = axpy4(acc, q01, t.w.y);
          acc = axpy4(acc, q10, t.w.z);
          acc = axpy4(acc, q11, t.w.w);
          float4& su = sum[dd];
          float4& sq2 = sq[dd];
          su.x += acc.x; sq2.x = fmaf(acc.x, acc.x, sq2.x);
          su.y += acc.y; sq2.y = fmaf(acc.y, acc.y, sq2.y);
          su.z += acc.z; sq2.z = fmaf(acc.z, acc.z, sq2.z);
          su.w += acc.w; sq2.w = fmaf(acc.w, acc.w, sq2.w);
        }
      }
#pragma unroll
      for (int dd = 0; dd < kPlanes; ++dd) {
        if (dd >= nd) break;
        // E[w^2] - E[w]^2
        const float4 su = sum[dd], sq2 = sq[dd];
        const float4 m = make_float4(__fmul_rn(su.x, inv_s), __fmul_rn(su.y, inv_s),
                                     __fmul_rn(su.z, inv_s), __fmul_rn(su.w, inv_s));
        const float4 var = make_float4(__fsub_rn(__fmul_rn(sq2.x, inv_s), __fmul_rn(m.x, m.x)),
                                       __fsub_rn(__fmul_rn(sq2.y, inv_s), __fmul_rn(m.y, m.y)),
                                       __fsub_rn(__fmul_rn(sq2.z, inv_s), __fmul_rn(m.z, m.z)),
                                       __fsub_rn(__fmul_rn(sq2.w, inv_s), __fmul_rn(m.w, m.w)));
        const long long vox = (((long long)blk.b * D + d0 + dd) * Ht + y) * Wt + x;
        __stcs(reinterpret_cast<float4*>(out) + vox * G + grp, var);
      }
    }
  }
}

template <bool BF16>
int launch(const void* feats, const void* proj, const void* depth, void* out, int B, int S,
           int Hs, int Ws, int C, int D, int Ht, int Wt, int TX, int TY, int ND, int sms,
           cudaStream_t stream) {
  auto kernel = warp_variance_kernel<BF16>;
  const size_t smem = 16 * (size_t)((S * 12 + 3) / 4) + sizeof(Tap) * (size_t)S * TX * TY * ND;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const Tiling tl = make_tiling(B, D, Ht, Wt, TX, TY, ND, (long long)sms * per_sm);
  const long long grid = (long long)B * tl.tiles_y * tl.tiles_x * tl.run_groups;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>((const float*)feats, (const float*)proj,
                                                     (const float*)depth, (float*)out, S, Hs,
                                                     Ws, C, D, Ht, Wt, tl);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0: the bf16-operand instance (eval), else f32. TX x TY x ND is the
// chunk (ops/cuda/warp_variance.py::sweep_tile); sms the card's SMs.
extern "C" int warp_variance_launch(const void* feats, const void* proj, const void* depth,
                                    void* out, int B, int S, int Hs, int Ws, int C, int D,
                                    int Ht, int Wt, int TX, int TY, int ND, int bf16, int sms,
                                    void* stream) {
  if (C % 4 != 0 || S < 1 || TX < 1 || TY < 1 || (TX & (TX - 1)) || (TY & (TY - 1)) ||
      ND < 1 || ND > kPlanes || sms < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * D * Ht * Wt == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<true>(feats, proj, depth, out, B, S, Hs, Ws, C, D, Ht, Wt, TX, TY, ND,
                             sms, st)
              : launch<false>(feats, proj, depth, out, B, S, Hs, Ws, C, D, Ht, Wt, TX, TY, ND,
                              sms, st);
}
