// K3 (the fused curve / hybrid tail), K1's gain form and K1's canvas form
// for Hopper (sm_90a) on the tile engine of retinex_tile.cuh, bound to
// PyTorch through ctypes (kernels/fused_enhance.py).
//
// What they replace. K3 replaces the TPU kernel fused_curve_enhance ->
// _curve_kernel (low_light_image_enhancement_tpu/kernels/fused_enhance.py),
// with maps at 1/1, 1/2 and 1/4 and the ext_gain arm; K1's gain form is the
// same kernel with the gain plane and no curve step: the TPU kernel's two
// ext_gain arms (_retinex_kernel's and _curve_kernel's) compute the same
// thing. K1's canvas form is the same kernel with K1's boost and no curve
// step: the TPU kernel fused_retinex -> _retinex_kernel on the padded
// planar canvas, as the JAX package's planar and canvas programs run it.
// These are the bilateral tails (and no tail); the guided tails are
// fused_guided.cu.
//
// What bounds them. With maps at full resolution K3 reads 3 bytes and
// n_iter * 3 float maps a pixel (96 bytes at n_iter 8) and writes 3: device
// memory bounds it. With maps at 1/4 it reads 6 map bytes a pixel (and the
// video step's gain plane, 4) and the curves' arithmetic bounds it: per
// output and map value the row blend (3 operations) and the curve step (4),
// the column blend (3) shared by the rows under it.
//
// What the design does about it. The engine's 32 x 64 tile, staging (words
// or float4 where inside and aligned, the gain or illumination plane as a
// fourth plane), blur (hybrid's boost as its epilogue) and bilateral tail,
// and a curve pass of column strips: a thread owns a ring column and VS
// rows and holds the strip's values of one channel in registers through the
// channel's n_iter steps. At 1/1 each map value is read once, from device
// memory into the registers of the thread that owns its output (a warp's
// lanes along a row), the next step's loads in flight while this step is
// worked. At 1/2 and 1/4 the maps are staged in shared memory, chunks of
// steps copied by cp.async two chunks ahead into the region the blur and
// the tail use (free between them; with no blur on the tile the first
// chunks are copied while the tile stages), and a thread blends the maps'
// columns once at each low-res row under its strip (walk_rows: at most 8
// and 5), each output row then blending the two it lies between: the
// column blend is computed once for the DS rows under it. VS is a multiple
// of 4 and y0 of TH, so every strip of a launch starts at the same phase of
// the maps' rows: the phase is a template, dispatched once a tile, and every
// low-res row and weight of the walk is a compile-time index. Built for 3
// blocks an SM (80 registers) as K1 where that does not spill
// (curve_blocks): the curve pass is latency-bound, and at 2 blocks the
// forms were 10-17% slower (PERF.md). What it does not do: stage the maps
// at 1/1 too (a barrier a step held the strips in lockstep: slower than the
// direct loads).
//
// Numerics: as fused_enhance.cuh (--fmad=false, round half to even, host
// rounded constants, intermediates off the image computed from clamped
// reads, never clamped themselves). Each map value keeps upsample_maps'
// order (the column blend at the two low-res rows, then the row blend,
// lo * (1 - f) + hi * f), each curve step apply_curves' (v + a * v * (1 -
// v)), and hybrid's margin columns take the boosted value of their nearest
// image column (replicate_margin_cols) before the curves.
#include "retinex_tile.cuh"

namespace llie {
namespace tile {

// The curves of one column strip of VS ring rows (nr of them on the ring)
// at `col` (the first row's value of channel 0): the values of one channel
// in registers through the channel's steps. A step's map values come as
// `raw`: at DS 1 the VS values; at DS 2 and 4 the two column taps (map_tap's
// columns, weights fc and gc) at each of the strip's K low-res rows, blended
// once a row and then, per output, between the two rows it lies between. S:
// the phase of the strip's first block row minus DS / 2 (0 at DS 1).
template <int DS, int S>
struct CurveStrip {
  static constexpr int H = DS / 2;
  static constexpr int K = walk_rows(DS, S);
  static constexpr int NL = DS == 1 ? VS : 2 * K;
  float v[VS];
  float* col;
  int nr, P, YP;
  float fc, gc;

  __device__ __forceinline__ void read(int ch) {
#pragma unroll
    for (int o = 0; o < VS; ++o) v[o] = o < nr ? col[ch * YP + o * P] : 0.0f;
  }
  __device__ __forceinline__ void write(int ch) {
#pragma unroll
    for (int o = 0; o < VS; ++o)
      if (o < nr) col[ch * YP + o * P] = clip01(v[o]);
  }
  __device__ __forceinline__ void apply(const float (&raw)[NL],
                                        const UpParams& up) {
    if constexpr (DS == 1) {
#pragma unroll
      for (int o = 0; o < VS; ++o)
        v[o] = v[o] + raw[o] * v[o] * (1.0f - v[o]);
    } else {
      float a[K];
#pragma unroll
      for (int k = 0; k < K; ++k) a[k] = raw[2 * k] * gc + raw[2 * k + 1] * fc;
#pragma unroll
      for (int o = 0; o < VS; ++o) {
        // block row rb + o: low-res rows k0 and k0 + 1 of the walk, phase
        // (rb + o) mod DS
        const int k0 = (S + o) / DS, ph = (S + o + H) % DS;
        const float mv = a[k0] * up.f[4 + ph] + a[k0 + 1] * up.f[ph];
        v[o] = v[o] + mv * v[o] * (1.0f - v[o]);
      }
    }
  }
};

// A thread's strip of the ring: ring column c, ring rows q VS ..
template <int DS, int S>
__device__ __forceinline__ CurveStrip<DS, S> make_strip(
    float* __restrict__ sY, const Geo& g, const UpParams& up, int WB, int x0,
    int q, int c) {
  CurveStrip<DS, S> st;
  st.col = sY + q * VS * g.P + g.cr + c;
  st.nr = min(VS, YH - q * VS);
  st.P = g.P;
  st.YP = g.YP;
  const int bc = clampi(x0 - 1 + c, 0, WB - 1);
  st.fc = phase_weight<DS>(up, bc % DS);
  st.gc = 1.0f - st.fc;
  return st;
}

// Maps at full resolution: each value read once, from device memory into
// the registers of the thread that owns its output (a warp's lanes along a
// row), the next step's loads issued before this step's arithmetic, the two
// buffers' roles swapped by unrolling the loop by 2 (no copies). Steps
// (channel, iteration), iteration inner, as apply_curves per channel.
__device__ inline void curves_direct(float* __restrict__ sY,
                                     const float* __restrict__ mp,
                                     const Geo& g, const UpParams& up,
                                     int n_iter, int HB, int WB, int r0b,
                                     int x0, int tid) {
  if (tid >= VSEG * YW) return;
  const int q = tid / YW, c = tid - q * YW;
  const int rb = r0b + q * VS;
  const int bc = clampi(x0 - 1 + c, 0, WB - 1);
  const size_t plane = (size_t)HB * WB;
  CurveStrip<1, 0> st = make_strip<1, 0>(sY, g, up, WB, x0, q, c);
  int lit = 0, lch = 0;  // the next step to load
  auto load = [&](float (&raw)[VS]) {
    if (lch < 3) {
      const float* p = mp + (size_t)(lit * 3 + lch) * plane + bc;
#pragma unroll
      for (int o = 0; o < VS; ++o)
        raw[o] = p[(size_t)min(rb + o, HB - 1) * WB];
      if (++lit == n_iter) {
        lit = 0;
        ++lch;
      }
    }
  };
  int it = 0, ch = 0;  // the step to apply
  auto step = [&](const float (&use)[VS], float (&fill)[VS]) {
    load(fill);
    st.apply(use, up);
    if (++it == n_iter) {
      st.write(ch);
      it = 0;
      if (++ch < 3) st.read(ch);
    }
  };
  float b0[VS], b1[VS];
  load(b0);
  st.read(0);
  for (int s = 0;;) {
    step(b0, b1);
    if (++s == 3 * n_iter) break;
    step(b1, b0);
    if (++s == 3 * n_iter) break;
  }
}

// Maps at 1/2 and 1/4, staged in shared memory (a low-res value serves up to
// 16 outputs): a plane (step) of the maps is FH x FW floats, the low-res rows
// from floor((r0b - DS/2) / DS) that the strips blend and the low-res
// columns from floor((x0 - 1 - DS/2) / DS) that map_tap reaches, each
// clamped into the maps. Steps go in chunks of map_chunk(R) planes into
// NBUF buffers in the region of the blur and the tail (free from the blur's
// end to the tail's start), NBUF - 1 chunks ahead of the one the strips
// work; with no blur on the tile the first chunks are copied while the
// tile stages.
constexpr int NBUF = 3;

template <int DS>
struct MapStage {
  static constexpr int FW = TW / DS + 2;
  static constexpr int FH = (VSEG - 1) * VS / DS + walk_rows(DS, DS - 1);
  static constexpr int F = FH * FW;
};

// The staged buffers: 16-byte aligned after the ring planes.
__device__ __forceinline__ float* map_buffers(float* smem, const Geo& g) {
  return smem + 3 * g.YP + (-(3 * g.YP) & 3);
}
template <int DS>
__device__ __forceinline__ int map_chunk(const Geo& g) {
  return (smem_floats(2, g.R) - 3 * g.YP - (-(3 * g.YP) & 3))
         / (NBUF * MapStage<DS>::F);
}

// Copy chunk j of C planes (every thread its share, one commit group a
// chunk, empty for a thread with nothing to copy).
template <int DS>
__device__ inline void issue_chunk(float* __restrict__ buf, int C, int j,
                                   const float* __restrict__ mp, int n_iter,
                                   int HB, int WB, int r0b, int x0, int tid) {
  using M = MapStage<DS>;
  constexpr int H = DS / 2;
  const int s0 = j * C, n = min(C, 3 * n_iter - s0);
  int it = s0 % n_iter, ch = s0 / n_iter;
  const int hl = HB / DS, wl = WB / DS;
  const size_t lplane = (size_t)hl * wl;
  const int lr0 = (r0b + DS - H) / DS - 1;
  const int lc0 = (x0 - 1 + DS - H) / DS - 1;
  float* d = buf + (j % NBUF) * C * M::F;
  for (int k = 0; k < n; ++k, d += M::F) {
    const float* q = mp + (size_t)(it * 3 + ch) * lplane;
    if (++it == n_iter) {
      it = 0;
      ++ch;
    }
    for (int e = tid; e < M::F; e += NT) {
      const int i = e / M::FW, jj = e - i * M::FW;
      __pipeline_memcpy_async(d + e,
                              q + (size_t)clampi(lr0 + i, 0, hl - 1) * wl
                                  + clampi(lc0 + jj, 0, wl - 1),
                              4);
    }
  }
  __pipeline_commit();
}

template <int DS>
__device__ inline void prime_chunks(float* __restrict__ buf, int C,
                                    const float* __restrict__ mp, int n_iter,
                                    int HB, int WB, int r0b, int x0,
                                    int tid) {
  for (int j = 0; j < NBUF - 1 && j * C < 3 * n_iter; ++j)
    issue_chunk<DS>(buf, C, j, mp, n_iter, HB, WB, r0b, x0, tid);
}

// Every thread of the block: chunk j waited for, a barrier (which also
// frees the buffer of chunk j - 1), chunk j + NBUF - 1 issued, then the
// strips' steps of chunk j. The caller has issued chunks 0 .. NBUF - 2.
template <int DS, int S>
__device__ inline void curves_staged(float* __restrict__ sY,
                                     float* __restrict__ buf, int C,
                                     const float* __restrict__ mp,
                                     const Geo& g, const UpParams& up,
                                     int n_iter, int HB, int WB, int r0b,
                                     int x0, int tid) {
  using M = MapStage<DS>;
  using St = CurveStrip<DS, S>;
  constexpr int H = DS / 2;
  const bool strip = tid < VSEG * YW;
  const int q = tid / YW, c = tid - q * YW;
  St st = make_strip<DS, S>(sY, g, up, WB, x0, q, c);
  // the thread's left column at the strip's first low-res row: map_tap's
  // floor((c - H) / DS) of its ring column unclamped, the right one the
  // next (floor((c + H) / DS) = floor((c - H) / DS) + 1); the staged
  // columns are clamped into the maps, so both read map_tap's values
  const int lc0 = (x0 - 1 + DS - H) / DS - 1;
  const int o0 = q * (VS / DS) * M::FW + (x0 - 1 + c + DS - H) / DS - 1 - lc0;
  const int steps = 3 * n_iter, nch = (steps + C - 1) / C;
  int it = 0, ch = 0;
  if (strip) st.read(0);
  for (int j = 0; j < nch; ++j) {
    if (j + NBUF - 1 <= nch)
      __pipeline_wait_prior(NBUF - 2);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
    if (j + NBUF - 1 < nch)
      issue_chunk<DS>(buf, C, j + NBUF - 1, mp, n_iter, HB, WB, r0b, x0,
                      tid);
    if (!strip) continue;
    const float* pl = buf + (j % NBUF) * C * M::F;
    const int n = min(C, steps - j * C);
    for (int k = 0; k < n; ++k, pl += M::F) {
      float raw[St::NL];
#pragma unroll
      for (int r = 0; r < St::K; ++r) {
        raw[2 * r] = pl[o0 + r * M::FW];
        raw[2 * r + 1] = pl[o0 + 1 + r * M::FW];
      }
      st.apply(raw, up);
      if (++it == n_iter) {
        st.write(ch);
        it = 0;
        if (++ch < 3) st.read(ch);
      }
    }
  }
}

// Pass 3b: the curves on the ring, every thread of the block.
template <int DS>
__device__ inline void curve_pass(float* __restrict__ sY,
                                  float* __restrict__ buf,
                                  const float* __restrict__ mp, const Geo& g,
                                  const UpParams& up, int n_iter, int HB,
                                  int WB, int r0b, int x0, int tid) {
  if constexpr (DS == 1) {
    curves_direct(sY, mp, g, up, n_iter, HB, WB, r0b, x0, tid);
  } else {
    const int C = map_chunk<DS>(g);
    // one phase for every strip of the launch: VS % DS == 0, TH % DS == 0
    switch ((r0b + DS - DS / 2) % DS) {
      case 0:
        curves_staged<DS, 0>(sY, buf, C, mp, g, up, n_iter, HB, WB, r0b, x0,
                             tid);
        break;
      case 1:
        curves_staged<DS, 1>(sY, buf, C, mp, g, up, n_iter, HB, WB, r0b, x0,
                             tid);
        break;
      case 2:
        if constexpr (DS == 4)
          curves_staged<DS, 2>(sY, buf, C, mp, g, up, n_iter, HB, WB, r0b,
                               x0, tid);
        break;
      default:
        if constexpr (DS == 4)
          curves_staged<DS, 3>(sY, buf, C, mp, g, up, n_iter, HB, WB, r0b,
                               x0, tid);
        break;
    }
  }
}

// K3: block (B, 3, HB, WB) T + maps (B, n_iter, 3, HB/DS, WB/DS) f32 ->
// (B, 3, rows, WB) T, output row r <-> block row halo + r; ring position
// (i, j) <-> block (halo + y0 - 1 + i, x0 - 1 + j). With `boost` (hybrid's,
// or K1's canvas form's) the image is boosted by the tile's blur at
// bp.radius or, LPLANE, by the blurred illumination in lp (B, HB, WB); under
// hybrid's the boosted columns outside [m, m + img_w) then take the values
// of the nearest image column. With `gain` (f32 (B, HB, WB), no boost) the
// image is clip(x * gain) first. Then n_iter curve steps (none for K1's
// gain form and canvas form), the tail and the store.
// Built for curve_blocks() blocks an SM.
// At 3 (80 registers) the forms at 1/1 with the illumination plane and at
// 1/4 without it spill (ptxas): they are built for 2.
template <class T, int DS, bool LPLANE>
constexpr int curve_blocks() {
  return (DS == 1 && LPLANE) || (DS == 4 && !LPLANE) ? 2 : 3;
}

template <class T, int DS, bool LPLANE>
__global__ void __launch_bounds__(NT, (curve_blocks<T, DS, LPLANE>()))
curve_tile_kernel(const T* __restrict__ in, const float* __restrict__ maps,
                  const float* __restrict__ gain,
                  const float* __restrict__ lp, T* __restrict__ out, int HB,
                  int WB, int halo, int rows, int n_iter, int boost, int m,
                  int img_w, const __grid_constant__ UpParams up,
                  const __grid_constant__ BoostParams bp,
                  const __grid_constant__ TailParams tp) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW, b = blockIdx.z;
  const Geo g = make_geo(boost && !LPLANE ? bp.radius : 0, x0, halo + y0);
  const size_t plane = (size_t)HB * WB;
  const T* blk = in + (size_t)b * 3 * plane;
  // the fourth plane: hybrid's blurred illumination, or the gain
  const float* fp = LPLANE ? lp : gain;
  const float* fb = fp ? fp + (size_t)b * plane : nullptr;
  float* sY = smem;                    // 3 ring planes: x, then y
  float* sA = smem + 3 * g.YP;         // the blur phase, then the tail's
  float* sL = sA;                      // LH + 2 rows: max RGB
  float* sV = sL + (g.LH + 2) * g.P;   // YH rows: the vertical blur

  // the curves' maps (computed where used, so that nothing of them is held
  // through staging): at 1/2 and 1/4 staged in the blur's and the tail's
  // region, the first chunks copied now if the tile has no blur
  auto map_base = [&] {
    return maps + (size_t)b * n_iter * 3 * (plane / (DS * DS));
  };
  auto prime = [&] {
    if constexpr (DS > 1)
      prime_chunks<DS>(map_buffers(smem, g), map_chunk<DS>(g), map_base(),
                       n_iter, HB, WB, halo + y0 - 1, x0, tid);
  };
  if (n_iter > 0 && !g.R) prime();

  // 1. staging: max RGB on the staged region (hybrid's tile blur), RGB on
  // the ring, boosted by the plane (LPLANE) or multiplied by the gain
  const bool inside = g.xa >= 0 && g.xa + 4 * g.nG <= WB;
  const bool words = inside && (WB & 3) == 0
                     && ((uintptr_t)in & (sizeof(T) == 1 ? 3 : 15)) == 0;
  const bool fwords = inside && (WB & 3) == 0 && ((uintptr_t)fp & 15) == 0;
  auto load = [&](int i, int gi, RawPlanes& a) {
    const size_t row = (size_t)clampi(g.ya + i, 0, HB - 1) * WB;
    const int x = g.xa + 4 * gi;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      load_plane(blk + c * plane + row, x, WB, words, a.r + 4 * c);
    const int yi = i - g.R;
    if (fb && yi >= 0 && yi < YH) load_plane(fb + row, x, WB, fwords, a.l);
  };
  for_groups<RawPlanes>(g, tid, load, [&](int i, int gi, const RawPlanes& a) {
    const int j = 4 * gi;
    float v[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) unpack_plane<T>(a.r + 4 * c, words, v[c]);
    if (g.R) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sL[i * g.P + j + q] = fmaxf(fmaxf(v[0][q], v[1][q]), v[2][q]);
    }
    const int yi = i - g.R;
    if (yi < 0 || yi >= YH) return;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (fb) {
        const float gn = LPLANE ? boost_gain(a.l[q], bp, true) : a.l[q];
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c][q] = clip01(v[c][q] * gn);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) sY[c * g.YP + yi * g.P + j + q] = v[c][q];
    }
  });
  __syncthreads();

  // 2-3. hybrid's blur and boost on the ring
  if (g.R) {
    blur_passes(sL, sV, g, bp, tid, [&](int r, int c, float l) {
      const float gn = boost_gain(l, bp, true);
      float* y = sY + r * g.P + g.cr + c;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) y[ch * g.YP] = clip01(y[ch * g.YP] * gn);
    });
    if (n_iter > 0) prime();
  }
  // the boosted columns outside [m, m + img_w): their nearest image
  // column's values (a column that is its own nearest is never written)
  const int c0b = x0 - 1;  // block column of ring column 0
  if (boost == BOOST_HYBRID
      && (c0b < m || c0b + YW - 1 > m + img_w - 1)) {
    for (int e = tid; e < YH * YW; e += NT) {
      const int r = e / YW, c = e - r * YW;
      const int cn =
          clampi(clampi(c0b + c, m, m + img_w - 1) - c0b, 0, YW - 1);
      if (cn == c) continue;
      float* y = sY + r * g.P + g.cr;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) y[ch * g.YP + c] = y[ch * g.YP + cn];
    }
    __syncthreads();
  }

  // 3b. the curves
  if (n_iter > 0) {
    curve_pass<DS>(sY, map_buffers(smem, g), map_base(), g, up, n_iter, HB,
                   WB, halo + y0 - 1, x0, tid);
    __syncthreads();
  }

  // 4. the tail
  Outs o;
  tail(sY, sA, g, tp, true, tid, o);

  // 5. out: output row y0 + t
  const int t = tid & 31, c0 = (tid >> 5) * K2;
  if constexpr (sizeof(T) == 1) {
    uint32_t* buf = (uint32_t*)(sA + 3 * TH * g.P);
    pack_out<false>(o, buf, tid);
    __syncthreads();
    const int n = min(TW, WB - x0);
    for (int rr = tid >> 5; rr < TH && y0 + rr < rows; rr += NT / 32) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        store_bytes(buf + rr * OP + (TW / 4) * ch,
                    (uint8_t*)out + (((size_t)b * 3 + ch) * rows + y0 + rr)
                                        * WB + x0,
                    n, tid & 31, 32);
    }
  } else if (y0 + t < rows) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float* q = (float*)out + (((size_t)b * 3 + ch) * rows + y0 + t) * WB
                 + x0 + c0;
      if (x0 + c0 + K2 <= WB && ((uintptr_t)q & 15) == 0) {
#pragma unroll
        for (int k = 0; k < K2 / 4; ++k)
          ((float4*)q)[k] =
              make_float4(clip01(o.v[4 * k][ch]), clip01(o.v[4 * k + 1][ch]),
                          clip01(o.v[4 * k + 2][ch]),
                          clip01(o.v[4 * k + 3][ch]));
      } else {
#pragma unroll
        for (int k = 0; k < K2; ++k)
          if (x0 + c0 + k < WB) q[k] = clip01(o.v[k][ch]);
      }
    }
  }
}

template <class T>
struct CurveTileForm {
  static int run(const void* in, const void* maps, const void* gain,
                 const float* lp, void* out, int B, int HB, int WB, int halo,
                 int rows, int n_iter, int boost, int m, int img_w, int ds,
                 const UpParams& up, const BoostParams& bp,
                 const TailParams& tp, cudaStream_t st) {
    const bool lplane = lp != nullptr;
    const int R = boost && !lplane ? bp.radius : 0;
    const size_t smem = sizeof(float) * smem_floats(2, R);
    const dim3 grid((WB + TW - 1) / TW, (rows + TH - 1) / TH, B);
    auto kernel = lplane ? (ds == 1   ? curve_tile_kernel<T, 1, true>
                            : ds == 2 ? curve_tile_kernel<T, 2, true>
                                      : curve_tile_kernel<T, 4, true>)
                         : (ds == 1   ? curve_tile_kernel<T, 1, false>
                            : ds == 2 ? curve_tile_kernel<T, 2, false>
                                      : curve_tile_kernel<T, 4, false>);
    if (const int e = prepare(kernel)) return e;
    kernel<<<grid, NT, smem, st>>>(
        (const T*)in, (const float*)maps, (const float*)gain, lp, (T*)out,
        HB, WB, halo, rows, n_iter, boost, m, img_w, up, bp, tp);
    return (int)cudaGetLastError();
  }
};

}  // namespace tile
}  // namespace llie

using namespace llie;

extern "C" {

// K3. `phases` is a host array of 8 floats: upsample_int's phase weights
// for ds (ops.filters._phase_consts). `gain` may be NULL; `lp` (B, HB, WB)
// carries hybrid's blurred illumination for radius > MAX_BLUR_RADIUS (NULL
// otherwise).
int llie_fused_curve(const void* in, const void* maps, const void* gain,
                     const float* lp, void* out, int f32, int B, int HB,
                     int WB, int halo, int rows, int n_iter, int boost, int m,
                     int img_w, int ds, const float* phases, int radius,
                     const float* taps, float gm1, float eps, float strength,
                     float inv2s2, float inv2s2_3, int kind, int joint,
                     int sep, void* stream) {
  if (radius < 1 || (boost && (radius > MAX_BLUR_RADIUS) != (lp != nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((ds != 1 && ds != 2 && ds != 4) || HB % ds || WB % ds || B < 1 ||
      rows < 1 || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  const BoostParams bp = boost_params(radius, taps, gm1, eps);
  const TailParams tp =
      tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  // the phase weights f and, from f[4], their 1 - f, each rounded as the
  // device rounds them
  UpParams up = {};
  for (int k = 0; k < ds; ++k) {
    up.f[k] = phases[k];
    up.f[4 + k] = 1.0f - phases[k];
  }
  return launch_io<tile::CurveTileForm>(
      f32, in, maps, gain, boost ? lp : nullptr, out, B, HB, WB, halo, rows,
      n_iter, boost, m, img_w, ds, up, bp, tp, (cudaStream_t)stream);
}

// K1's canvas form: K3's kernel with K1's boost and no curve step on a
// block (B, 3, HB, WB) whose `halo` rows above its output rows and margin
// columns are replicate-padded (the canvas of pad_planar), -> (B, 3, rows,
// WB), output row r <-> block row halo + r. `taps` is a host array of 2 *
// radius + 1 floats, read when radius <= MAX_BLUR_RADIUS; a wider blur
// comes in `lp` (B, HB, WB) from llie_blur_illumination at e 0 (NULL
// otherwise).
int llie_fused_retinex_canvas(const void* in, const float* lp, void* out,
                              int f32, int B, int HB, int WB, int halo,
                              int rows, int radius, const float* taps,
                              float gm1, float eps, float strength,
                              float inv2s2, float inv2s2_3, int kind,
                              int joint, int sep, void* stream) {
  if (radius < 1 || (radius > MAX_BLUR_RADIUS) != (lp != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || WB < 1 || rows < 1 || halo < 0 || halo + rows > HB)
    return (int)cudaErrorInvalidValue;
  const BoostParams bp = boost_params(radius, taps, gm1, eps);
  const TailParams tp =
      tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  const UpParams up = {};
  return launch_io<tile::CurveTileForm>(
      f32, in, (const void*)nullptr, (const void*)nullptr, lp, out, B, HB,
      WB, halo, rows, 0, BOOST_CANVAS, 0, 0, 1, up, bp, tp,
      (cudaStream_t)stream);
}

// K1's gain form: K3's kernel with the gain plane and no curve step.
int llie_fused_retinex_gain(const void* in, const void* gain, void* out,
                            int f32, int B, int HB, int WB, int halo,
                            int rows, float strength, float inv2s2,
                            float inv2s2_3, int kind, int joint, int sep,
                            void* stream) {
  if (B < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  const TailParams tp =
      tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  const BoostParams bp = {};
  const UpParams up = {};
  return launch_io<tile::CurveTileForm>(
      f32, in, (const void*)nullptr, gain, (const float*)nullptr, out, B, HB,
      WB, halo, rows, 0, 0, 0, 1, 1, up, bp, tp, (cudaStream_t)stream);
}

}  // extern "C"
