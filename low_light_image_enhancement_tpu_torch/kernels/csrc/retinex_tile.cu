// K1 (fused retinex, also K8's kernel) and K4 (the fused retinex video
// step) for Hopper (sm_90a) on the tile engine of retinex_tile.cuh, bound
// to PyTorch through ctypes (kernels/fused_enhance.py,
// kernels/fused_enhance_hwc.py); the engine's plan. K3 is curve_tile.cu.
//
// What they replace. K1 replaces the TPU kernel fused_retinex ->
// _retinex_kernel (low_light_image_enhancement_tpu/kernels/fused_enhance.py,
// the non-EMA branch) and K8 its HWC form (kernels/fused_enhance_hwc.py
// _retinex_hwc_kernel); K4 replaces fused_retinex_ema ->
// _retinex_kernel(ema_alpha). These are their bilateral tails (and no tail);
// the guided tails are fused_guided.cu.
//
// What bounds them. K1 moves 3 bytes in and 3 out a pixel (u8), too few for
// device memory to bind it: its float operations do, about 300 a pixel in
// the default form (the blur, exp/log of the boost, the bilateral's range
// weights, the quantize), on 67 TFLOP/s of f32 (0.029 ms at 600x400 b48).
// K4 adds the carry (4 bytes in, 4 out) and the EMA's exp and logs, which
// brings bytes and operations close.
//
// What the design does about it. Every instruction a pixel counts, so the
// engine spends few of them outside the arithmetic of the plain version: a
// 32 x 64 tile (staged positions 1.30x the outputs at R 2, against 1.63x
// for the 16 x 32 tile of one output a thread), strips of 8 to 12 outputs
// a thread whose windows sit in registers, the blur's taps in registers at
// a compile-time radius, no divisions in the inner loops, one range weight
// a neighbour pair with the range kernel a template, u8 rows copied as
// async 16-byte chunks and written as words, and the byte <-> float
// conversions as integer and float adds instead of conversion
// instructions. What it does not do: hide a tile's copy behind another
// tile's work in the same block (a tile loop cost more in registers and
// spills than it saved).
//
// Forms. u8 or f32 I/O (a template parameter); K1's stages and the tail's
// form (separable or full, joint or per channel, exp or epan, strength 0)
// are uniform run-time branches, once a tile; the radius is dispatched to
// a template once a tile. Radii past MAX_BLUR_RADIUS come as a blurred
// illumination plane (fused_enhance.cu blur_illumination), read by the
// LPLANE forms in place of the tile's blur.
//
// Numerics: as fused_enhance.cuh (--fmad=false, round half to even, host
// rounded constants, intermediates off the image computed from clamped
// reads, never clamped themselves).
#include "retinex_tile.cuh"

namespace llie {
namespace tile {

// K1's work on one tile: staging from the raw rows (u8, `cur`) or from
// global memory (f32), the blur, boost and gain, the tail and the output.
// Every thread of the block calls it.
template <class T, bool LPLANE>
__device__ __forceinline__ void retinex_tile(
    const T* __restrict__ in, T* __restrict__ out,
    const float* __restrict__ lp, int H, int W, int stages,
    const BoostParams& bp, const TailParams& tp, int b, int x0, int y0,
    const uint8_t* cur) {
  constexpr bool RAW = sizeof(T) == 1;
  const bool blur = stages & STAGE_BLUR, boost = stages & STAGE_BOOST;
  const bool gain = blur || boost;
  const bool inblur = blur && !LPLANE;  // the blur runs on the tile
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int R = inblur ? bp.radius : 0;
  const int nch = raw_chunks(R);
  const Geo g = make_geo(R, x0, y0);
  float* sY = smem;                    // 3 ring planes: x, then y
  float* sA = smem + 3 * g.YP;         // the blur phase, then the tail's
  float* sL = sA;                      // LH + 2 rows: max RGB
  float* sV = sL + (g.LH + 2) * g.P;   // YH rows: the vertical blur
  const uint8_t* in8 = (const uint8_t*)in;

  // 1. staging: max RGB on the staged region, RGB (or, without a tile
  // blur, the boosted y) on the ring
  auto stage = [&](int i, int gi, const float (&v)[3][4]) {
    const int j = 4 * gi;
    if (inblur) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sL[i * g.P + j + q] = fmaxf(fmaxf(v[0][q], v[1][q]), v[2][q]);
    }
    const int yi = i - g.R;
    if (yi < 0 || yi >= YH) return;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float y[3] = {v[0][q], v[1][q], v[2][q]};
      if (gain && !inblur) {
        float l = fmaxf(fmaxf(y[0], y[1]), y[2]);
        if constexpr (LPLANE)
          l = lp[((size_t)b * (H + 2) + clampi(y0 + yi, 0, H + 1))
                     * (W + 2) + clampi(x0 + j + q - g.cr, 0, W + 1)];
        const float gn = boost_gain(l, bp, boost);
#pragma unroll
        for (int c = 0; c < 3; ++c) y[c] = clip01(y[c] * gn);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) sY[c * g.YP + yi * g.P + j + q] = y[c];
    }
  };
  if constexpr (RAW) {
    int i = tid / g.nG, gi = tid - i * g.nG;
    const int di = NT / g.nG, dg = NT - di * g.nG;
    while (i < g.LH) {
      float v[3][4];
      decode_raw(in8, H, W, g, b, cur, nch, i, gi, v);
      stage(i, gi, v);
      gi += dg;
      i += di;
      if (gi >= g.nG) {
        gi -= g.nG;
        ++i;
      }
    }
  } else {
    // f32: groups inside the row on 16-byte boundaries as float4
    const T* img = in + (size_t)b * H * W * 3;
    const bool words = g.xa >= 0 && g.xa + 4 * g.nG <= W && (W & 3) == 0
                       && ((uintptr_t)in & 15) == 0;
    auto load = [&](int i, int gi, RawF32& a) {
      load_raw(img + (size_t)clampi(g.ya + i, 0, H - 1) * W * 3,
               g.xa + 4 * gi, W, words, a);
    };
    for_groups<RawF32>(g, tid, load, [&](int i, int gi, const RawF32& a) {
      float v[3][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c][q] = a.f[3 * q + c];
      stage(i, gi, v);
    });
  }
  __syncthreads();

  // 2-3. the blur, the boost and the gain on the ring
  if (inblur) {
    blur_passes(sL, sV, g, bp, tid, [&](int r, int c, float l) {
      const float gn = boost_gain(l, bp, boost);
      float* y = sY + r * g.P + g.cr + c;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        y[ch * g.YP] = clip01(y[ch * g.YP] * gn);
    });
  }

  // 4. the tail
  Outs o;
  tail(sY, sA, g, tp, stages & STAGE_DENOISE, tid, o);

  // 5. out
  const int tr = tid & 31, c0 = (tid >> 5) * K2;
  if constexpr (sizeof(T) == 1) {
    uint32_t* buf = (uint32_t*)(sA + 3 * TH * g.P);
    pack_out<true>(o, buf, tid);
    __syncthreads();
    const int n = 3 * min(TW, W - x0);
    for (int r = tid >> 5; r < TH && y0 + r < H; r += NT / 32)
      store_bytes(buf + r * OP,
                  (uint8_t*)out + (((size_t)b * H + y0 + r) * W + x0) * 3,
                  n, tid & 31, 32);
  } else if (y0 + tr < H) {
    // the thread's 8 pixels are 24 consecutive floats of its row
    float* q = (float*)out + (((size_t)b * H + y0 + tr) * W + x0 + c0) * 3;
    if (x0 + c0 + K2 <= W && ((uintptr_t)q & 15) == 0) {
#pragma unroll
      for (int e = 0; e < 3 * K2 / 4; ++e) {
        float f[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          f[u] = clip01(o.v[(4 * e + u) / 3][(4 * e + u) % 3]);
        ((float4*)q)[e] = make_float4(f[0], f[1], f[2], f[3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < K2; ++e)
        if (x0 + c0 + e < W)
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            q[3 * e + ch] = clip01(o.v[e][ch]);
    }
  }
}

// K1: (B, H, W, 3) T -> (B, H, W, 3) T, T uint8_t or float. `stages`:
// STAGE_* flags. LPLANE: the blurred illumination is read from lp, (B, H
// + 2, W + 2) with image pixel (y, x) at (y + 1, x + 1), instead of being
// blurred on the tile. On u8 the tile's rows are copied into shared memory
// as async copies, all of them in flight at once, before staging decodes
// them. Built for 3 blocks an SM (80 registers, no spills), which the
// shared memory allows up to radius 3; 2 above it.
template <class T, bool LPLANE>
__global__ void __launch_bounds__(NT, 3)
retinex_tile_kernel(const T* __restrict__ in, T* __restrict__ out,
                    const float* __restrict__ lp, int H, int W, int stages,
                    const __grid_constant__ BoostParams bp,
                    const __grid_constant__ TailParams tp) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int R = (stages & STAGE_BLUR) && !LPLANE ? bp.radius : 0;
  uint8_t* raw = (uint8_t*)(smem + raw_offset(smem_floats(0, R)));
  if constexpr (sizeof(T) == 1) {
    issue_raw((const uint8_t*)in, (size_t)gridDim.z * H * W * 3, H, W,
              make_geo(R, x0, y0), b, raw, raw_chunks(R), threadIdx.x);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  retinex_tile<T, LPLANE>(in, out, lp, H, W, stages, bp, tp, b, x0, y0, raw);
}

// K4: block (B, 3, HB, WB) T + carry (B, HB, WB) f32 -> (B, 3, rows, WB)
// T, output row r <-> block row halo + r, and the new carry (B, HB, WB).
// The tiles cover the band [m, HB - m): ring position (i, j) <-> block
// (m + y0 - 1 + i, x0 - 1 + j). A negative carry marks a pixel with no
// state yet: it takes l_now. LPLANE: l_now is read from lp, (B, HB, WB).
// Built for 2 blocks an SM: at 3 (80 registers) its forms without a plane
// spill.
template <class T, bool LPLANE>
__global__ void __launch_bounds__(NT, 2)
ema_tile_kernel(const T* __restrict__ in, const float* __restrict__ carry,
                const float* __restrict__ lp, T* __restrict__ out,
                float* __restrict__ ncarry, int HB, int WB, int halo,
                int rows, int m, int img_w,
                const __grid_constant__ EmaParams ep,
                const __grid_constant__ BoostParams bp,
                const __grid_constant__ TailParams tp) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW, b = blockIdx.z;
  // block coordinates: the tile's output rows start at band row m + y0
  const Geo g = make_geo(LPLANE ? 0 : bp.radius, x0, m + y0);
  const size_t plane = (size_t)HB * WB;
  const T* blk = in + (size_t)b * 3 * plane;
  const float* cp = carry + (size_t)b * plane;
  float* np = ncarry + (size_t)b * plane;
  float* sY = smem;
  float* sA = smem + 3 * g.YP;
  float* sL = sA;                              // LH + 2 rows (tile blur)
  float* sV = sL + (g.R ? g.LH + 2 : 0) * g.P; // YH rows: blur or l_now
  float* sC = sV + YH * g.P;                   // YH rows: carry, then l_mix
  float* sG = sC + YH * g.P;                   // YH rows: gain
  const int band_end = HB - m;

  // 1. staging: max RGB (tile blur), RGB, the carry and (LPLANE) l_now
  const bool inside = g.xa >= 0 && g.xa + 4 * g.nG <= WB;
  const bool words = inside && (WB & 3) == 0
                     && ((uintptr_t)in & (sizeof(T) == 1 ? 3 : 15)) == 0;
  const bool cwords = inside && (WB & 3) == 0
                      && ((uintptr_t)carry & 15) == 0
                      && (!LPLANE || ((uintptr_t)lp & 15) == 0);
  auto load = [&](int i, int gi, RawPlanes& a) {
    const size_t row = (size_t)clampi(g.ya + i, 0, HB - 1) * WB;
    const int x = g.xa + 4 * gi;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      load_plane(blk + c * plane + row, x, WB, words, a.r + 4 * c);
    const int yi = i - g.R;
    if (yi < 0 || yi >= YH) return;
    load_plane(cp + row, x, WB, cwords, a.c);
    if constexpr (LPLANE)
      load_plane(lp + (size_t)b * plane + row, x, WB, cwords, a.l);
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
#pragma unroll
      for (int c = 0; c < 3; ++c) sY[c * g.YP + yi * g.P + j + q] = v[c][q];
      sC[yi * g.P + j + q] = a.c[q];
      if constexpr (LPLANE) sV[yi * g.P + j + q] = a.l[q];
    }
  });
  __syncthreads();

  // 2-3. l_now (the blur, or the plane), the EMA and the gain; the gain is
  // applied at once where it is its own nearest image column
  const int c0b = x0 - 1;  // block column of ring column 0
  auto nearest = [&](int c) {
    return clampi(clampi(c0b + c, m, m + img_w - 1) - c0b, 0, YW - 1);
  };
  auto ema = [&](int r, int c, float l_now) {
    const int e = r * g.P + g.cr + c;
    const float cv = sC[e];
    const float l_mix = cv < 0.0f ? l_now : ep.alpha * l_now + ep.beta * cv;
    const float gn = expf(ep.gamma * logf(fminf(fmaxf(l_mix, bp.eps), 1.0f))
                          - logf(fminf(fmaxf(l_now, bp.eps), 1.0f)));
    sG[e] = gn;
    sC[e] = l_mix;
    if (nearest(c) == c) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        sY[ch * g.YP + e] = clip01(sY[ch * g.YP + e] * gn);
    }
  };
  if (g.R) {
    blur_passes(sL, sV, g, bp, tid, ema);
  } else {
    ring_rows(sV, g, tid, ema);
    __syncthreads();
  }

  // the gain of the nearest image column where that is another column
  // (_kreplicate_cols), and the new carry: the tile's own band rows, and
  // the band's first and last rows again over the m rows beyond them, each
  // row stored whole by consecutive lanes
  if (c0b < m || c0b + YW - 1 > m + img_w - 1) {
    for (int e = tid; e < YH * YW; e += NT) {
      const int r = e / YW, c = e - r * YW;
      const int cn = nearest(c);
      if (cn == c) continue;
      const float gn = sG[r * g.P + g.cr + cn];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float* y = sY + ch * g.YP + r * g.P + g.cr + c;
        *y = clip01(*y * gn);
      }
    }
  }
  {
    const int nt = max(0, min(TH, band_end - (m + y0)));  // own band rows
    const bool first = y0 == 0, last = m + y0 + nt == band_end;
    const int nd = nt + (first ? m : 0) + (last ? m : 0);
    const int ncol = min(TW, WB - x0);
    for (int d = tid >> 6; d < nd; d += NT / 64) {
      int t, dst;
      if (d < nt) {
        t = d;
        dst = m + y0 + d;
      } else if (first && d < nt + m) {
        t = 0;
        dst = d - nt;
      } else {
        t = nt - 1;
        dst = band_end + d - nt - (first ? m : 0);
      }
      const int col = tid & 63;
      if (col < ncol)
        np[(size_t)dst * WB + x0 + col] =
            sC[(t + 1) * g.P + g.cr + 1 + col];
    }
  }
  __syncthreads();

  // 4. the tail
  Outs o;
  tail(sY, sA, g, tp, true, tid, o);

  // 5. out: output row r = m + y0 + t - halo
  const int t = tid & 31, c0 = (tid >> 5) * K2;
  const int r0 = m + y0 - halo;
  if constexpr (sizeof(T) == 1) {
    uint32_t* buf = (uint32_t*)(sA + 3 * TH * g.P);
    pack_out<false>(o, buf, tid);
    __syncthreads();
    const int n = min(TW, WB - x0);
    for (int rr = tid >> 5; rr < TH; rr += NT / 32) {
      const int r = r0 + rr;
      if (r < 0 || r >= rows) continue;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        store_bytes(buf + rr * OP + (TW / 4) * ch,
                    (uint8_t*)out + (((size_t)b * 3 + ch) * rows + r) * WB
                        + x0,
                    n, tid & 31, 32);
    }
  } else if (r0 + t >= 0 && r0 + t < rows) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float* q = (float*)out + (((size_t)b * 3 + ch) * rows + r0 + t) * WB
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
struct RetinexTileForm {
  static int run(const void* in, void* out, const float* lp, int B, int H,
                 int W, int stages, const BoostParams& bp,
                 const TailParams& tp, cudaStream_t st) {
    const bool lplane = lp != nullptr;
    const int R = (stages & STAGE_BLUR) && !lplane ? bp.radius : 0;
    const size_t smem = sizeof(float) * smem_floats(0, R, sizeof(T) == 1);
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
    auto kernel = lplane ? retinex_tile_kernel<T, true>
                         : retinex_tile_kernel<T, false>;
    if (const int e = prepare(kernel)) return e;
    kernel<<<grid, NT, smem, st>>>((const T*)in, (T*)out, lp, H, W, stages,
                                   bp, tp);
    return (int)cudaGetLastError();
  }
};

template <class T>
struct EmaTileForm {
  static int run(const void* in, const void* carry, const float* lp,
                 void* out, void* ncarry, int B, int HB, int WB, int halo,
                 int rows, int m, int img_w, const EmaParams& ep,
                 const BoostParams& bp, const TailParams& tp,
                 cudaStream_t st) {
    const bool lplane = lp != nullptr;
    const int R = lplane ? 0 : bp.radius;
    const size_t smem = sizeof(float) * smem_floats(1, R);
    const dim3 grid((WB + TW - 1) / TW, (HB - 2 * m + TH - 1) / TH, B);
    auto kernel =
        lplane ? ema_tile_kernel<T, true> : ema_tile_kernel<T, false>;
    if (const int e = prepare(kernel)) return e;
    kernel<<<grid, NT, smem, st>>>((const T*)in, (const float*)carry, lp,
                                   (T*)out, (float*)ncarry, HB, WB, halo,
                                   rows, m, img_w, ep, bp, tp);
    return (int)cudaGetLastError();
  }
};

}  // namespace tile

}  // namespace llie

using namespace llie;

extern "C" {

const char* llie_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The tile plan of K1 (`family` 0), K4 (1) and K3 (2, curve_tile.cu) at a
// blur radius on the tile (0 for none: a plane past MAX_BLUR_RADIUS, K1
// without its blur stage, K3 without hybrid's boost): `what` 0 the tile's
// output rows, 1 its columns, 2 threads a block, 3 dynamic shared memory
// bytes on u8, 4 the plane pitch in floats, 5 the grid column of the ring's
// first column, 6 shared memory bytes on f32, 7 the 16-byte chunks of a raw
// row (K1 on u8), 8 the rows of K3's curve strips, 9 and 10 the low-res rows
// a strip reads at most with maps at 1/2 and 1/4 (0 where the family has
// none). -1 for an argument out of range.
int llie_retinex_tile_plan(int family, int radius, int what) {
  if (family < 0 || family > 2 || radius < 0 || radius > MAX_BLUR_RADIUS)
    return -1;
  const bool raw = family == 0, curve = family == 2;
  switch (what) {
    case 0: return tile::TH;
    case 1: return tile::TW;
    case 2: return tile::NT;
    case 3:
      return (int)sizeof(float) * tile::smem_floats(family, radius, raw);
    case 4: return tile::pitch(radius);
    case 5: return tile::grid_off(radius) + radius;
    case 6: return (int)sizeof(float) * tile::smem_floats(family, radius);
    case 7: return raw ? tile::raw_chunks(radius) : 0;
    case 8: return curve ? tile::VS : 0;
    case 9: return curve ? tile::walk_rows(2, 1) : 0;
    case 10: return curve ? tile::walk_rows(4, 3) : 0;
    default: return -1;
  }
}

// K1. `in`/`out` (B, H, W, 3), u8 or (`f32` 1) f32. `stages`: STAGE_*
// flags. `taps` is a host array of 2 * radius + 1 floats, read when radius
// <= MAX_BLUR_RADIUS; a wider blur comes in `lp` (B, H + 2, W + 2) from
// llie_blur_illumination at e 1 (NULL otherwise). Returns
// cudaGetLastError() after the launch (0 when it was accepted).
int llie_fused_retinex(const void* in, void* out, int f32, const float* lp,
                       int B, int H, int W, int stages, int radius,
                       const float* taps, float gm1, float eps,
                       float strength, float inv2s2, float inv2s2_3, int kind,
                       int joint, int sep, void* stream) {
  if (radius < 1 || stages < 0 || stages > STAGES_ALL || B < 1 || H < 1 ||
      W < 1)
    return (int)cudaErrorInvalidValue;
  if ((stages & STAGE_BLUR) && (radius > MAX_BLUR_RADIUS) != (lp != nullptr))
    return (int)cudaErrorInvalidValue;
  const BoostParams bp = boost_params(radius, taps, gm1, eps);
  const TailParams tp =
      tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  const float* lpl = (stages & STAGE_BLUR) ? lp : nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  return f32 ? tile::RetinexTileForm<float>::run(in, out, lpl, B, H, W,
                                                 stages, bp, tp, st)
             : tile::RetinexTileForm<uint8_t>::run(in, out, lpl, B, H, W,
                                                   stages, bp, tp, st);
}

// K4. `alpha` and `beta` = 1 - alpha are each rounded once from double by
// the caller; `taps` is a host array of 2 * radius + 1 floats, read when
// radius <= MAX_BLUR_RADIUS; a wider blur comes as l_now in `lp` (B, HB,
// WB) from llie_blur_illumination (NULL otherwise).
int llie_fused_retinex_ema(const void* in, const void* carry, const float* lp,
                           void* out, void* ncarry, int f32, int B, int HB,
                           int WB, int halo, int rows, int m, int img_w,
                           float alpha, float beta, float gamma, int radius,
                           const float* taps, float eps, float strength,
                           float inv2s2, float inv2s2_3, int kind, int joint,
                           int sep, void* stream) {
  if (radius < 1 || (radius > MAX_BLUR_RADIUS) != (lp != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || WB < 1 || m < 1 || HB <= 2 * m)
    return (int)cudaErrorInvalidValue;
  const BoostParams bp = boost_params(radius, taps, 0.0f, eps);
  const TailParams tp =
      tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  EmaParams ep;
  ep.alpha = alpha;
  ep.beta = beta;
  ep.gamma = gamma;
  const cudaStream_t st = (cudaStream_t)stream;
  return f32 ? tile::EmaTileForm<float>::run(in, carry, lp, out, ncarry, B,
                                             HB, WB, halo, rows, m, img_w, ep,
                                             bp, tp, st)
             : tile::EmaTileForm<uint8_t>::run(in, carry, lp, out, ncarry, B,
                                               HB, WB, halo, rows, m, img_w,
                                               ep, bp, tp, st);
}

}  // extern "C"
