// Trilinear sampling of a channels-last volume at per-sample (x, y, z),
// zeros padding, align-corners voxel units, f32 out, for sm_90a; two
// instances: float32, and bf16 operands with f32 sums (the TPU kernel's
// default).
//
// Replaces the Pallas TPU kernel _tri_kernel (pallas_call at
// boostmvsnerfs_tpu/ops/pallas/tri_sample.py:231), entry fused_tri_sample
// (:161). On the TPU the gather had to become a (z-window x y-band) slab
// DMA plus interpolation matmuls, exact only when every tap fell inside
// the windows; here it is a direct gather, exact everywhere.
//
// What bounds it on an H100: memory. Each sample reads 12 bytes of
// coordinates and writes C floats (the f32 output is two thirds of the
// bytes on the MVSNeRF path); its eight taps come from L1/L2 when the
// threads that share a voxel load it together. The MVSNeRF samples come
// ray by ray, a ray's samples spread over the volume's depth planes, so
// consecutive samples are far apart in the volume while neighbouring rays
// at one sample index are close. The design follows that locality:
//   - a block takes a tile of 1024 consecutive samples, stages their
//     coordinates in shared memory with coalesced 16-byte loads, and maps
//     each warp's lanes to 32 neighbouring rays at one sample index
//     (``tile_index``, by ``period`` = gcd(samples per ray, 32); for flat
//     samples, period 1, it is the identity). A warp's tap loads then fall
//     on one or two planes in a small (x, y) patch: a few cache lines, not
//     32. Any order and any count of samples is right: the mapping only
//     picks which thread computes which sample;
//   - a thread takes one sample: it clamps, floors and weighs once, starts
//     its eight taps' 16-byte loads together (8 channels at a time) and
//     keeps the sums in registers;
//   - the outputs go to a shared-memory copy of the tile's output rows and
//     leave in 16-byte stores in sample order, which fill whole cache
//     lines. Stored from registers, a warp's stores hit 32 rays' rows,
//     32 lines each: on the MVSNeRF path that cost more than the gather.
// The coordinates are clamped to [-2, size+1] before floor, as in the
// Pallas kernel (tri_sample.py:89-91) and the plain version: taps that far
// out carry zero weight either way, and the clamp keeps the float->int
// conversion of behind-camera samples defined. A tap outside the volume
// reads a voxel inside it with zero weight.
//
// float32 instance: the tap weights and their sum follow the plain version
// (sampling.grid_sample_3d) operation by operation, so both agree exactly.
// bf16 instance (sampling._grid_sample_3d_bf16, the Pallas kernel's
// rounding): the volume's taps and the x weights are rounded to bf16 in
// registers as they load (a bf16 copy of the volume, cast once per call,
// was slower: its pass cost more than the gather's halved bytes saved),
// the x sums are f32 (the products are exact), each (dz, dy) partial times
// wy * wz is rounded to bf16, and the partials are summed in f32, z-major.
// The roundings go two values to a conversion: the instance runs more
// instructions than the f32 one, and they show in its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // samples per block: 32 rows of 32 lanes
constexpr int kRows = kTile / 32;
constexpr int kPitch = 33;   // shared coordinate rows, conflict-free both ways

// (row, lane) of the tile -> the sample's index in the tile: row r, lane l
// is ray l of panel r / period at sample r % period.
__device__ __forceinline__ int tile_index(int row, int lane, int pshift) {
  return ((row >> pshift) << (5 + pshift)) + (lane << pshift) + (row & ((1 << pshift) - 1));
}

// and back: the shared-memory slot of the tile's sample ``local``
__device__ __forceinline__ int tile_slot(int local, int pshift) {
  const int panel = local >> (5 + pshift), rest = local & ((32 << pshift) - 1);
  const int lane = rest >> pshift, row = (panel << pshift) + (rest & ((1 << pshift) - 1));
  return row * kPitch + lane;
}

// a and b rounded to bf16 (one conversion for both), kept in float32
__device__ __forceinline__ void round_bf16x2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const unsigned u = *reinterpret_cast<const unsigned*>(&h);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}

// One axis of a sample: the two taps' indices clamped into the volume and
// their weights (0 outside it), float32 (1 - t, t) or the Pallas kernel's
// triangle weights max(0, 1 - |tap - c|).
template <bool kBf16>
__device__ __forceinline__ void axis_taps(float c, int size, int (&idx)[2], float (&w)[2]) {
  c = fminf(fmaxf(c, -2.f), size + 1.f);
  const float c0f = floorf(c);
  const int c0 = (int)c0f;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int i = c0 + d;
    float wd;
    if constexpr (kBf16) {
      wd = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn((float)i, c))));
    } else {
      const float t = __fsub_rn(c, c0f);
      wd = d ? t : __fsub_rn(1.f, t);
    }
    w[d] = i >= 0 && i <= size - 1 ? wd : 0.f;
    idx[d] = min(max(i, 0), size - 1);
  }
}

// A sample's weights and its taps' offsets (elements into its batch
// entry's volume; the wrapper keeps them under 2^31).
struct Taps {
  float wx[2], wy[2], wz[2];
  int off[8];
};

template <bool kBf16>
__device__ __forceinline__ Taps sample_taps(int D, int H, int W, int C, float x, float y,
                                            float z) {
  Taps s;
  int ix[2], iy[2], iz[2];
  axis_taps<kBf16>(x, W, ix, s.wx);
  axis_taps<kBf16>(y, H, iy, s.wy);
  axis_taps<kBf16>(z, D, iz, s.wz);
  if constexpr (kBf16) round_bf16x2(s.wx[0], s.wx[1]);
#pragma unroll
  for (int t = 0; t < 8; ++t) s.off[t] = ((iz[t >> 2] * H + iy[(t >> 1) & 1]) * W + ix[t & 1]) * C;
  return s;
}

// Channels [c, c + 4G) of a sample: the eight taps' loads together, the
// sums in registers, written to dst 16 bytes a store.
template <int G, bool kBf16>
__device__ __forceinline__ void sample_channels(const float* __restrict__ vol, const Taps& s,
                                                int c, float* dst) {
  float v[8][4 * G];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(vol + s.off[t] + c) + j);
      v[t][4 * j] = q.x;
      v[t][4 * j + 1] = q.y;
      v[t][4 * j + 2] = q.z;
      v[t][4 * j + 3] = q.w;
    }
  float acc[4 * G];
#pragma unroll
  for (int k = 0; k < 4 * G; ++k) acc[k] = 0.f;
  if constexpr (kBf16) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // (dz, dy) tap rows, z-major
      const float wy = s.wy[r & 1], wz = s.wz[r >> 1];
#pragma unroll
      for (int k = 0; k < 4 * G; k += 2) {
        round_bf16x2(v[2 * r][k], v[2 * r][k + 1]);
        round_bf16x2(v[2 * r + 1][k], v[2 * r + 1][k + 1]);
        float part[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float xs = __fmul_rn(v[2 * r][k + e], s.wx[0]);  // exact
          xs = __fmaf_rn(v[2 * r + 1][k + e], s.wx[1], xs);
          part[e] = __fmul_rn(__fmul_rn(xs, wy), wz);
        }
        round_bf16x2(part[0], part[1]);
        acc[k] = __fadd_rn(acc[k], part[0]);
        acc[k + 1] = __fadd_rn(acc[k + 1], part[1]);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float w = __fmul_rn(__fmul_rn(s.wx[t & 1], s.wy[(t >> 1) & 1]), s.wz[t >> 2]);
#pragma unroll
      for (int k = 0; k < 4 * G; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[t][k], w));
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
    reinterpret_cast<float4*>(dst)[j] =
        make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
}

// The staged outputs of one 4G-channel chunk of the tile: sample
// ``local`` at local * 4G floats, rows of 32 samples 16 bytes apart so that
// a warp's stores (32 rays, one sample index) spread over the banks.
template <int G>
__device__ __forceinline__ int staged_at(int local) {
  return local * 4 * G + (local >> 5) * 4;
}

// One block per tile of kTile samples; channels in chunks of 4G (G = 2
// when C % 8 == 0), each chunk staged whole in shared memory.
template <int G, bool kBf16>
__global__ void __launch_bounds__(kThreads, 4) tri_sample_kernel(
    const float* __restrict__ vol,  // (B, D, H, W, C)
    const float* __restrict__ xyz,  // (B, P, 3)
    float* __restrict__ out,        // (B, P, C)
    int D, int H, int W, int C, long long P, long long N, int pshift) {
  __shared__ float s_xyz[3][kRows * kPitch];
  __shared__ __align__(16) float s_out[kTile * 4 * G + kRows * 4];
  const long long base = (long long)blockIdx.x * kTile;
  const int n_tile = (int)min((long long)kTile, N - base);

  // the tile's coordinates, (sample, xyz) floats read 16 bytes a thread
  const float* src = xyz + base * 3;
  const int nf = n_tile * 3;
  for (int i = threadIdx.x * 4; i < nf; i += kThreads * 4) {
    float v[4];
    if (i + 4 <= nf) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src + i));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = i + k < nf ? src[i + k] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = i + k, local = f / 3;
      if (f < nf) s_xyz[f - 3 * local][tile_slot(local, pshift)] = v[k];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long vol_stride = (long long)D * H * W * C;
  const long long b0 = base / P;  // the tile's first batch entry
  for (int c0 = 0; c0 < C; c0 += 4 * G) {
#pragma unroll 1
    for (int row = warp; row < kRows; row += kWarps) {
      const int local = tile_index(row, lane, pshift);
      if (local >= n_tile) continue;
      const long long n = base + local;
      long long b = b0;  // a tile spans two entries at most, unless P is shorter than it
      if (n - b0 * P >= P) b = P >= kTile ? b0 + 1 : n / P;
      const int slot = row * kPitch + lane;
      const Taps s = sample_taps<kBf16>(D, H, W, C, s_xyz[0][slot], s_xyz[1][slot],
                                        s_xyz[2][slot]);
      sample_channels<G, kBf16>(vol + b * vol_stride, s, c0, s_out + staged_at<G>(local));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_tile * G; i += kThreads)
      *reinterpret_cast<float4*>(out + (base + i / G) * C + c0 + 4 * (i % G)) =
          *reinterpret_cast<const float4*>(s_out + staged_at<G>(i / G) + 4 * (i % G));
    if (c0 + 4 * G < C) __syncthreads();
  }
}

template <int G>
void launch(bool bf16, unsigned grid, cudaStream_t stream, const float* vol, const float* xyz,
            float* out, int D, int H, int W, int C, long long P, long long N, int pshift) {
  if (bf16)
    tri_sample_kernel<G, true><<<grid, kThreads, 0, stream>>>(vol, xyz, out, D, H, W, C, P, N,
                                                              pshift);
  else
    tri_sample_kernel<G, false><<<grid, kThreads, 0, stream>>>(vol, xyz, out, D, H, W, C, P, N,
                                                               pshift);
}

}  // namespace

// period_shift: log2 of gcd(samples per ray, 32); bf16: 1 for the bf16
// instance, 0 for float32.
extern "C" int tri_sample_launch(const void* vol, const void* xyz, void* out, int B, int D,
                                 int H, int W, int C, long long P, int period_shift, int bf16,
                                 void* stream) {
  if (C % 4 != 0 || period_shift < 0 || period_shift > 5) return (int)cudaErrorInvalidValue;
  const long long N = (long long)B * P;
  if (N == 0) return 0;
  const unsigned grid = (unsigned)((N + kTile - 1) / kTile);
  auto* v = (const float*)vol;
  auto* c = (const float*)xyz;
  auto* o = (float*)out;
  auto s = (cudaStream_t)stream;
  if (C % 8 == 0)
    launch<2>(bf16, grid, s, v, c, o, D, H, W, C, P, N, period_shift);
  else
    launch<1>(bf16, grid, s, v, c, o, D, H, W, C, P, N, period_shift);
  return (int)cudaGetLastError();
}
