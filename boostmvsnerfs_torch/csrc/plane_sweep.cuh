// The plane sweep's projection and bilinear taps, shared by the warp
// kernels (csrc/warp_variance.cu, csrc/warp_variance_bwd.cu), and the
// tiling both walk.
//
// Each voxel (b, d, y, x) projects through a view's 3x4 matrix P at metric
// depth dep: s_i = ((P_i0 x + P_i1 y) + P_i2) + P_i3 / dep, x' = s_0 /
// max(s_2, 1e-6), y' likewise. Every operation of the projection and the
// tap weights is rounded as the plain version rounds it
// (ops/cost_volume.projected_rows, sampling.bilinear_taps), with no
// contraction into FMAs, so the kernels and the plain version agree on
// every tap.
//
// Tiling. A block owns a tile of TX x TY target pixels of one batch entry and
// walks runs of ND neighbouring depth planes over it (a chunk = the tile x
// one run). Neighbouring planes of one pixel project onto neighbouring source
// pixels (a run's taps overlap), so a chunk's source footprint is small and
// is read from L2 once, then from L1.

#pragma once

#include <cuda_runtime.h>

namespace plane_sweep {

__device__ __forceinline__ float proj_row(const float* P, float u, float v, float dep) {
  const float base = __fadd_rn(__fadd_rn(__fmul_rn(P[0], u), __fmul_rn(P[1], v)), P[2]);
  return __fadd_rn(base, __fdiv_rn(P[3], dep));
}

// A voxel's source coordinates in one view: x' = xu, y' = yu (before any
// clamp), the clamped depth sz = max(s_2, 1e-6) and whether s_2 was above
// the clamp (live).
struct Proj {
  float xu, yu, sz;
  bool live;
};

__device__ __forceinline__ Proj project(const float* P, float u, float v, float dep) {
  Proj p;
  const float sz_raw = proj_row(P + 8, u, v, dep);
  p.live = sz_raw > 1e-6f;
  p.sz = fmaxf(sz_raw, 1e-6f);
  p.xu = __fdiv_rn(proj_row(P, u, v, dep), p.sz);
  p.yu = __fdiv_rn(proj_row(P + 4, u, v, dep), p.sz);
  return p;
}

// The four bilinear taps of (xu, yu) in an Hs x Ws image with zeros padding:
// coordinates clamped to [-2, size+1] before floor (taps that far out carry
// zero weight, and the clamp keeps the float->int conversion of
// behind-camera projections, ~1e10 px, defined); tap 00 at (x0, y0) clamped
// into the image, the next column and row dx, dy in {0, 1} pixels away (0
// where the index is clamped); weights 00, 01, 10, 11 in w, zero for a tap
// outside the image; the fractions tx, ty; and whether xu, yu lie inside
// the clamp range, bounds included.
struct Taps {
  float4 w;
  float tx, ty;
  int x0, y0, dx, dy;
  bool in_x, in_y;
};

__device__ __forceinline__ Taps bilinear(float xu, float yu, int Hs, int Ws) {
  Taps t;
  t.in_x = xu >= -2.f && xu <= Ws + 1.f;
  t.in_y = yu >= -2.f && yu <= Hs + 1.f;
  const float sx = fminf(fmaxf(xu, -2.f), Ws + 1.f);
  const float sy = fminf(fmaxf(yu, -2.f), Hs + 1.f);
  const float x0f = floorf(sx), y0f = floorf(sy);
  t.tx = __fsub_rn(sx, x0f);
  t.ty = __fsub_rn(sy, y0f);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const bool vx0 = x0 >= 0 && x0 <= Ws - 1, vx1 = x0 + 1 >= 0 && x0 + 1 <= Ws - 1;
  const bool vy0 = y0 >= 0 && y0 <= Hs - 1, vy1 = y0 + 1 >= 0 && y0 + 1 <= Hs - 1;
  const float ux = __fsub_rn(1.f, t.tx), uy = __fsub_rn(1.f, t.ty);
  t.w = make_float4(vy0 && vx0 ? __fmul_rn(uy, ux) : 0.f, vy0 && vx1 ? __fmul_rn(uy, t.tx) : 0.f,
                    vy1 && vx0 ? __fmul_rn(t.ty, ux) : 0.f,
                    vy1 && vx1 ? __fmul_rn(t.ty, t.tx) : 0.f);
  t.x0 = min(max(x0, 0), Ws - 1);
  t.y0 = min(max(y0, 0), Hs - 1);
  t.dx = min(max(x0 + 1, 0), Ws - 1) - t.x0;
  t.dy = min(max(y0 + 1, 0), Hs - 1) - t.y0;
  return t;
}

// c += v * w per channel, one rounding per tap (an FMA). With bf16
// operands the product is exact in f32, so this is the plain version's
// rounding at bf16 exactly; at f32 it rounds once where the plain version
// rounds twice.
__device__ __forceinline__ float4 axpy4(float4 c, float4 v, float w) {
  c.x = fmaf(v.x, w, c.x);
  c.y = fmaf(v.y, w, c.y);
  c.z = fmaf(v.z, w, c.z);
  c.w = fmaf(v.w, w, c.w);
  return c;
}

// The block's place in the grid: batch entry, tile origin and its runs of
// planes [d_begin, d_end). The grid walks runs fastest, then tiles along x,
// then y, then the batch, so blocks that run together read one band of the
// source images.
struct Tiling {
  int TX, TY, ND;        // tile width, height (powers of two), planes per run
  int lx, ly;            // log2 of TX and TY
  int tiles_x, tiles_y;  // tiles per row and column of the volume
  int run_groups;        // blocks per tile (each takes runs_per_block runs)
  int runs_per_block;
};

struct Block {
  int b, x0, y0, d_begin, d_end;
};

__device__ __forceinline__ Block block_of(const Tiling& t, int D) {
  long long id = blockIdx.x;
  Block k;
  const int grp = (int)(id % t.run_groups);
  id /= t.run_groups;
  k.x0 = (int)(id % t.tiles_x) * t.TX;
  id /= t.tiles_x;
  k.y0 = (int)(id % t.tiles_y) * t.TY;
  k.b = (int)(id / t.tiles_y);
  k.d_begin = grp * t.runs_per_block * t.ND;
  k.d_end = min(D, k.d_begin + t.runs_per_block * t.ND);
  return k;
}

// Voxel v of a chunk (x fastest, then y, then the plane): its offsets in
// the tile and the run.
struct Local {
  int x, y, d;
};

__device__ __forceinline__ Local local_of(const Tiling& t, int v) {
  Local l;
  l.x = v & (t.TX - 1);
  l.y = (v >> t.lx) & (t.TY - 1);
  l.d = v >> (t.lx + t.ly);
  return l;
}

// The tiling of a launch: TX, TY (powers of two), ND are the wrapper's
// (ops/cuda/warp_variance.py::sweep_tile); each tile's runs are split over
// enough blocks to give the card at least four waves of blocks_per_wave.
inline Tiling make_tiling(int B, int D, int Ht, int Wt, int TX, int TY, int ND,
                          long long blocks_per_wave) {
  Tiling t;
  t.TX = TX;
  t.TY = TY;
  t.ND = ND;
  t.lx = __builtin_ctz((unsigned)TX);
  t.ly = __builtin_ctz((unsigned)TY);
  t.tiles_x = (Wt + TX - 1) / TX;
  t.tiles_y = (Ht + TY - 1) / TY;
  const long long tiles = (long long)B * t.tiles_x * t.tiles_y;
  const int runs = (D + ND - 1) / ND;
  long long per = tiles * runs / (4 * (blocks_per_wave > 0 ? blocks_per_wave : 1));
  t.runs_per_block = (int)(per < 1 ? 1 : per > runs ? runs : per);
  t.run_groups = (runs + t.runs_per_block - 1) / t.runs_per_block;
  return t;
}

}  // namespace plane_sweep
