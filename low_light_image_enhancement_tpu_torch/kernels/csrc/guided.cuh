// Guided-filter device code: the shift-form cascade of ops/guided.py
// (box_mean_shift, guided_core_shift, guided_joint_core_shift) on a 2-D
// output tile of GT_H x GT_W pixels. K5 (tiled_denoise.cu) runs it on an
// f32 input tile; the guided tails of K1, K3 and K4 (fused_guided.cu) on
// their boosted, curved or gained tiles.
//
// The arithmetic repeats the plain versions operation for operation: each
// box pass starts from the centre and adds the taps at -t and +t, t
// ascending, then multiplies by k = float(1 / (2r + 1)); products such as
// g * p are formed where the box reads them, which gives the same floats
// as the plain version's product planes; the joint core multiplies by the
// reciprocal 1 / (var + eps), the per-channel core divides. So the tile
// equals the plain version bit for bit (under --fmad=false).
//
// The walk. Every box mean is a vertical pass then a horizontal one, and
// each pass is a loop over items of P consecutive outputs along the pass's
// axis: a thread loads the P + 2r values under them once into registers (r
// is a template parameter, so the window's indices are constants) and sums
// the P outputs from there. Shared memory is read (P + 2r) / P times a
// value and pass (twice at r = 4), not 2r + 1 times. Vertical items take
// consecutive columns in consecutive threads, horizontal items consecutive
// rows, and every plane's row stride is odd, so a warp's loads fall in
// distinct banks. The algebra between the passes runs in the horizontal
// items' registers (a and b as the box means arrive; q and the blend as
// box(a) and box(b) arrive). Item indices are divided only by
// compile-time constants. Barriers: 2 for the joint guide's statistics, 3
// a channel, 1 at the end; the caller's staging ends with one.
//
// The footprint. The caller stages the three input planes with their 2r
// ring and, for the joint guide, the channel-mean guide beside them
// (stage_guide); the blended channel is written over its own input plane's
// centre (each output position is read and written by one thread of the
// last pass, whose items do not overlap), so no output planes are kept,
// and the per-channel guide keeps neither the guide nor its statistics.
// That is what lets a tile run 3 blocks an SM up to r = 5 per channel and
// r = 2 with the joint guide (GuidedGeom::BLOCKS).
#pragma once

#include "fused_enhance.cuh"

namespace llie {

constexpr int MAX_GUIDED_RADIUS = 8;
constexpr int GT_H = 32;             // output rows of a tile
constexpr int GT_W = 32;             // output columns of a tile
constexpr int GUIDED_THREADS = 256;
constexpr int GP = 8;                // outputs of one item of a pass

struct GuidedParams {
  int radius;      // box radius r, 1..MAX_GUIDED_RADIUS
  float k;         // 1 / (2r + 1), rounded once from double on the host
  float eps;       // variance threshold
  float strength;  // blend toward the filtered image
  int joint;       // 1: one channel-mean guide for all channels; 0: each
                   // channel guides itself
};

// The planes of a tile at radius R, in floats. The input (and the joint
// guide) with a 2R ring: LH x LW, row stride LS; the statistics with an R
// ring: SH x SW, row stride SS; vertical passes over the input's columns:
// SH x LW at stride LS; over the statistics' columns: GT_H x SW at SS.
template <int R>
struct GuidedGeom {
  static constexpr int LH = GT_H + 4 * R, LW = GT_W + 4 * R, LS = LW + 1;
  static constexpr int SH = GT_H + 2 * R, SW = GT_W + 2 * R, SS = SW + 1;
  static constexpr int LN = LH * LS;  // one input plane
  static constexpr int VN = SH * LS;  // one vertical pass of the input
  static constexpr int SN = SH * SS;  // one statistics plane
  static constexpr int QN = GT_H * SS;  // one vertical pass of the stats
  // x0 x1 x2 [g] | v1 v2 | [mg inv] | a b | va vb
  __host__ __device__ static constexpr int floats(bool joint) {
    return (joint ? 4 : 3) * LN + 2 * VN + (joint ? 4 : 2) * SN + 2 * QN;
  }
  // where the planes after the inputs (and the guide) start: the staging's
  // scratch until guided_tile runs
  __host__ __device__ static constexpr int scratch(bool joint) {
    return (joint ? 4 : 3) * LN;
  }
  // the blocks an SM that guided_tile's shared memory allows (228 KB an
  // SM, 1 KB of it reserved a block), at most 3 (80 registers a thread),
  // which the kernels are built for
  __host__ __device__ static constexpr int BLOCKS(bool joint) {
    return 233472 / (4 * floats(joint) + 1024) > 3
               ? 3
               : 233472 / (4 * floats(joint) + 1024);
  }
};

// The channel-mean guide of a staged position, as the plain version forms
// it.
__device__ __forceinline__ float guide_of(float p0, float p1, float p2) {
  return (p0 + p1 + p2) * (1.0f / 3.0f);
}

// One item of a pass: P outputs from P + 2R values of a window w, out[i]
// centred on w[i + R].
template <int R>
__device__ __forceinline__ void box_run(const float (&w)[GP + 2 * R],
                                        float k, float (&out)[GP]) {
#pragma unroll
  for (int i = 0; i < GP; ++i) {
    float acc = w[i + R];
#pragma unroll
    for (int t = 1; t <= R; ++t) acc = (acc + w[i + R - t]) + w[i + R + t];
    out[i] = acc * k;
  }
}

// The first output of item `run` of a pass of n outputs: runs of GP, the
// last one moved back to end at n (it recomputes a few outputs of the one
// before it, the same values).
__device__ __forceinline__ int run_start(int run, int n) {
  return min(run * GP, n - GP);
}

// Vertical pass items: NC columns x the runs of NR outputs, columns
// fastest. fn(col, row0) handles one.
template <int NC, int NR, class Fn>
__device__ __forceinline__ void vertical_items(int tid, Fn fn) {
  constexpr int RUNS = (NR + GP - 1) / GP;
  for (int e = tid; e < NC * RUNS; e += GUIDED_THREADS)
    fn(e % NC, run_start(e / NC, NR));
}

// Horizontal pass items: NR rows x the runs of NC outputs, rows fastest.
template <int NR, int NC, class Fn>
__device__ __forceinline__ void horizontal_items(int tid, Fn fn) {
  constexpr int RUNS = (NC + GP - 1) / GP;
  for (int e = tid; e < NR * RUNS; e += GUIDED_THREADS)
    fn(e % NR, run_start(e / NR, NC));
}

// The guided filter of the tile whose input planes (with their 2R ring)
// are staged in sm[0 .. 3 * LN) at stride LS, pixel (y, x) of the tile at
// (y + 2R, x + 2R), and, JOINT, the channel-mean guide of every staged
// position in sm[3 LN .. 4 LN); sm holds GuidedGeom<R>::floats(JOINT)
// floats. Every thread of the block must call it, after the barrier that
// ends the staging; it ends with the blended, unclipped tile over the
// input planes' centres (at_out) and a __syncthreads.
template <int R, bool JOINT>
__device__ void guided_tile(float* __restrict__ sm, const GuidedParams& gp,
                            int tid) {
  using Gm = GuidedGeom<R>;
  constexpr int LS = Gm::LS, SS = Gm::SS, W = GP + 2 * R;
  static_assert(GT_W % GP == 0, "the last pass's items do not overlap");
  float* sG = sm + 3 * Gm::LN;               // LH x LW: the joint guide
  float* sV1 = sm + Gm::scratch(JOINT);      // SH x LW: vertical passes
  float* sV2 = sV1 + Gm::VN;
  float* sMg = sV2 + Gm::VN;                 // SH x SW: box(g) (JOINT)
  float* sInv = sMg + Gm::SN;                // SH x SW: 1 / (var + eps)
  float* sA = JOINT ? sInv + Gm::SN : sMg;   // SH x SW: a
  float* sB = sA + Gm::SN;                   // SH x SW: b
  float* sVa = sB + Gm::SN;                  // GT_H x SW: box(a), box(b)
  float* sVb = sVa + Gm::QN;
  const float k = gp.k;

  if constexpr (JOINT) {
    // box(g), box(g * g): vertical
    vertical_items<Gm::LW, Gm::SH>(tid, [&](int c, int r0) {
      float g[W], v[GP], vv[GP], gg[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        g[i] = sG[(r0 + i) * LS + c];
        gg[i] = g[i] * g[i];
      }
      box_run<R>(g, k, v);
      box_run<R>(gg, k, vv);
#pragma unroll
      for (int i = 0; i < GP; ++i) {
        sV1[(r0 + i) * LS + c] = v[i];
        sV2[(r0 + i) * LS + c] = vv[i];
      }
    });
    __syncthreads();
    // horizontal, then 1 / (var + eps)
    horizontal_items<Gm::SH, Gm::SW>(tid, [&](int r, int c0) {
      float w1[W], w2[W], mg[GP], sgg[GP];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        w1[i] = sV1[r * LS + c0 + i];
        w2[i] = sV2[r * LS + c0 + i];
      }
      box_run<R>(w1, k, mg);
      box_run<R>(w2, k, sgg);
#pragma unroll
      for (int i = 0; i < GP; ++i) {
        const float var = sgg[i] - mg[i] * mg[i];
        sMg[r * SS + c0 + i] = mg[i];
        sInv[r * SS + c0 + i] = 1.0f / (var + gp.eps);
      }
    });
    __syncthreads();
  }

  for (int ch = 0; ch < 3; ++ch) {
    float* p = sm + ch * Gm::LN;
    // box(p) and box(g * p) (joint) or box(p * p): vertical, over the rows
    // of the statistics
    vertical_items<Gm::LW, Gm::SH>(tid, [&](int c, int r0) {
      float w1[W], w2[W], v1[GP], v2[GP];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int at = (r0 + i) * LS + c;
        w1[i] = p[at];
        w2[i] = JOINT ? sG[at] * w1[i] : w1[i] * w1[i];
      }
      box_run<R>(w1, k, v1);
      box_run<R>(w2, k, v2);
#pragma unroll
      for (int i = 0; i < GP; ++i) {
        sV1[(r0 + i) * LS + c] = v1[i];
        sV2[(r0 + i) * LS + c] = v2[i];
      }
    });
    __syncthreads();
    // horizontal, then a and b
    horizontal_items<Gm::SH, Gm::SW>(tid, [&](int r, int c0) {
      float w1[W], w2[W], m[GP], s2[GP];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        w1[i] = sV1[r * LS + c0 + i];
        w2[i] = sV2[r * LS + c0 + i];
      }
      box_run<R>(w1, k, m);
      box_run<R>(w2, k, s2);
#pragma unroll
      for (int i = 0; i < GP; ++i) {
        const int at = r * SS + c0 + i;
        float a, b;
        if constexpr (JOINT) {
          const float mg = sMg[at];
          const float cov = s2[i] - mg * m[i];
          a = cov * sInv[at];
          b = m[i] - a * mg;
        } else {
          const float var = s2[i] - m[i] * m[i];
          a = var / (var + gp.eps);
          b = m[i] - a * m[i];
        }
        sA[at] = a;
        sB[at] = b;
      }
    });
    __syncthreads();
    // box(a), box(b): vertical over the tile's rows
    vertical_items<Gm::SW, GT_H>(tid, [&](int c, int r0) {
      float wa[W], wb[W], va[GP], vb[GP];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        wa[i] = sA[(r0 + i) * SS + c];
        wb[i] = sB[(r0 + i) * SS + c];
      }
      box_run<R>(wa, k, va);
      box_run<R>(wb, k, vb);
#pragma unroll
      for (int i = 0; i < GP; ++i) {
        sVa[(r0 + i) * SS + c] = va[i];
        sVb[(r0 + i) * SS + c] = vb[i];
      }
    });
    __syncthreads();
    // horizontal, then q = box(a) * guide + box(b) and the blend, over the
    // input's centre (its last reader)
    horizontal_items<GT_H, GT_W>(tid, [&](int r, int c0) {
      float wa[W], wb[W], qa[GP], qb[GP];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        wa[i] = sVa[r * SS + c0 + i];
        wb[i] = sVb[r * SS + c0 + i];
      }
      box_run<R>(wa, k, qa);
      box_run<R>(wb, k, qb);
#pragma unroll
      for (int i = 0; i < GP; ++i) {
        const int at = (r + 2 * R) * LS + c0 + i + 2 * R;
        const float x = p[at];
        const float q = qa[i] * (JOINT ? sG[at] : x) + qb[i];
        p[at] = x + gp.strength * (q - x);
      }
    });
  }
  __syncthreads();
}

// Output pixel (y, x) of channel ch of the tile after guided_tile.
template <int R>
__device__ __forceinline__ float at_out(const float* sm, int ch, int y,
                                        int x) {
  using Gm = GuidedGeom<R>;
  return sm[ch * Gm::LN + (y + 2 * R) * Gm::LS + x + 2 * R];
}

}  // namespace llie
