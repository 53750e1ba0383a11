// Guided-filter device code: the shift-form cascade of ops/guided.py
// (box_mean_shift, guided_core_shift, guided_joint_core_shift) on a 2-D
// output tile of TILE_H x TILE_W pixels, one thread per output pixel. K5
// (tiled_denoise.cu) runs it on an f32 input tile; the guided tails of K1
// and K3 are to stage their boosted (or curved) planes the same way and
// call guided_tile.
//
// The arithmetic repeats the plain versions operation for operation: each
// box pass starts from the centre and adds the taps at -t and +t, t
// ascending, then multiplies by k = float(1 / (2r + 1)); products such as
// g * p are formed where the box reads them, which gives the same floats
// as the plain version's product planes; the joint core multiplies by the
// reciprocal 1 / (var + eps), the per-channel core divides.
#pragma once

#include "fused_enhance.cuh"

namespace llie {

constexpr int MAX_GUIDED_RADIUS = 8;

struct GuidedParams {
  int radius;      // box radius r, 1..MAX_GUIDED_RADIUS
  float k;         // 1 / (2r + 1), rounded once from double on the host
  float eps;       // variance threshold
  float strength;  // blend toward the filtered image
  int joint;       // 1: one channel-mean guide for all channels; 0: each
                   // channel guides itself
};

// The cascade for radius r reads the input tile with a 2r ring,
// LH x LW = (TILE_H + 4r) x (TILE_W + 4r), and keeps its statistics and the
// a / b planes on the tile with an r ring, SH x SW = (TILE_H + 2r) x
// (TILE_W + 2r).
__host__ __device__ constexpr int guided_lh(int r) { return TILE_H + 4 * r; }
__host__ __device__ constexpr int guided_lw(int r) { return TILE_W + 4 * r; }
__host__ __device__ constexpr int guided_sh(int r) { return TILE_H + 2 * r; }
__host__ __device__ constexpr int guided_sw(int r) { return TILE_W + 2 * r; }

// Floats of scratch that guided_tile needs besides the three input planes:
// the guide (LH x LW), five stats planes (SH x SW) and the vertical-pass
// buffer (SH x LW).
__host__ __device__ constexpr int guided_scratch_floats(int r) {
  return guided_lh(r) * guided_lw(r) + 5 * guided_sh(r) * guided_sw(r) +
         guided_sh(r) * guided_lw(r);
}

// Vertical pass of a box mean: src(i, j) over (oh + 2r) rows x vw cols ->
// sV, oh x vw. Row i of the output is centred on source row i + r.
template <class Src>
__device__ void box_vertical(Src src, int oh, int vw, int r, float k,
                             float* __restrict__ sV, int tid) {
  for (int e = tid; e < oh * vw; e += NTHREADS) {
    const int i = e / vw, j = e - (e / vw) * vw;
    const int ci = i + r;
    float acc = src(ci, j);
    for (int t = 1; t <= r; ++t) acc = (acc + src(ci - t, j)) + src(ci + t, j);
    sV[e] = acc * k;
  }
}

// Horizontal pass at (i, j) of the output: columns j .. j + 2r of row i of
// sV (row stride vw), centred on j + r.
__device__ __forceinline__ float box_horizontal_at(const float* __restrict__ sV,
                                                   int vw, int i, int j, int r,
                                                   float k) {
  const float* row = sV + i * vw + j + r;
  float acc = row[0];
  for (int t = 1; t <= r; ++t) acc = (acc + row[-t]) + row[t];
  return acc * k;
}

// Box mean of src over (oh + 2r) x (ow + 2r) -> dst, oh x ow, through sV.
// Every thread of the block must call it.
template <class Src>
__device__ void box_mean_tile(Src src, int oh, int ow, int r, float k,
                              float* __restrict__ sV, float* __restrict__ dst,
                              int tid) {
  const int vw = ow + 2 * r;
  box_vertical(src, oh, vw, r, k, sV, tid);
  __syncthreads();
  for (int e = tid; e < oh * ow; e += NTHREADS) {
    const int i = e / ow, j = e - (e / ow) * ow;
    dst[e] = box_horizontal_at(sV, vw, i, j, r, k);
  }
  __syncthreads();
}

// Box mean of an SH x SW plane at the thread's pixel (ty, tx) of the tile.
// Every thread of the block must call it.
__device__ inline float box_mean_px(const float* __restrict__ plane, int r,
                                   float k, float* __restrict__ sV, int tid,
                                   int ty, int tx) {
  const int sw = guided_sw(r);
  box_vertical([&](int i, int j) { return plane[i * sw + j]; }, TILE_H, sw, r,
               k, sV, tid);
  __syncthreads();
  const float v = box_horizontal_at(sV, sw, ty, tx, r, k);
  __syncthreads();
  return v;
}

// Guided filter for the thread's pixel (ty, tx) of the tile. sX holds three
// planes of LH x LW, the input tile with a 2r ring: pixel (ty, tx) is at
// (ty + 2r, tx + 2r). scratch holds guided_scratch_floats(r) floats. Every
// thread of the block must call it. out[] gets the blended, unclipped value.
__device__ inline void guided_tile(const float* __restrict__ sX,
                                   float* __restrict__ scratch,
                                   const GuidedParams& gp, int tid, int ty,
                                   int tx, float out[3]) {
  const int r = gp.radius;
  const int LW = guided_lw(r), LN = guided_lh(r) * LW;
  const int SH = guided_sh(r), SW = guided_sw(r), SN = SH * SW;
  const float k = gp.k;
  float* sG = scratch;     // LH x LW: channel-mean guide (joint)
  float* sMg = sG + LN;    // SH x SW: box(g)
  float* sInv = sMg + SN;  // SH x SW: box(g*g), then 1 / (var + eps)
  float* sMp = sInv + SN;  // SH x SW: box(p)
  float* sA = sMp + SN;    // SH x SW: box(g*p) or box(p*p), then a
  float* sB = sA + SN;     // SH x SW: b
  float* sV = sB + SN;     // SH x LW: vertical passes
  const int ce = (ty + 2 * r) * LW + (tx + 2 * r);

  if (gp.joint) {
    for (int e = tid; e < LN; e += NTHREADS)
      sG[e] = (sX[e] + sX[LN + e] + sX[2 * LN + e]) * (1.0f / 3.0f);
    __syncthreads();
    box_mean_tile([&](int i, int j) { return sG[i * LW + j]; }, SH, SW, r, k,
                  sV, sMg, tid);
    box_mean_tile(
        [&](int i, int j) {
          const float g = sG[i * LW + j];
          return g * g;
        },
        SH, SW, r, k, sV, sInv, tid);
    for (int e = tid; e < SN; e += NTHREADS) {
      const float var = sInv[e] - sMg[e] * sMg[e];
      sInv[e] = 1.0f / (var + gp.eps);
    }
    __syncthreads();
  }
  for (int c = 0; c < 3; ++c) {
    const float* p = sX + c * LN;
    box_mean_tile([&](int i, int j) { return p[i * LW + j]; }, SH, SW, r, k,
                  sV, sMp, tid);
    if (gp.joint) {
      box_mean_tile(
          [&](int i, int j) { return sG[i * LW + j] * p[i * LW + j]; }, SH,
          SW, r, k, sV, sA, tid);
      for (int e = tid; e < SN; e += NTHREADS) {
        const float cov = sA[e] - sMg[e] * sMp[e];
        const float a = cov * sInv[e];
        sA[e] = a;
        sB[e] = sMp[e] - a * sMg[e];
      }
    } else {
      box_mean_tile(
          [&](int i, int j) {
            const float x = p[i * LW + j];
            return x * x;
          },
          SH, SW, r, k, sV, sA, tid);
      for (int e = tid; e < SN; e += NTHREADS) {
        const float m = sMp[e];
        const float var = sA[e] - m * m;
        const float a = var / (var + gp.eps);
        sA[e] = a;
        sB[e] = m - a * m;
      }
    }
    __syncthreads();
    const float qa = box_mean_px(sA, r, k, sV, tid, ty, tx);
    const float qb = box_mean_px(sB, r, k, sV, tid, ty, tx);
    const float x = p[ce];
    const float q = qa * (gp.joint ? sG[ce] : x) + qb;
    out[c] = x + gp.strength * (q - x);
  }
}

}  // namespace llie
