// The tile engine of K1 (retinex_tile.cu retinex_tile_kernel, also K8's
// kernel), K4 (ema_tile_kernel), K3 (curve_tile.cu curve_tile_kernel, also
// K1's gain form) and K5's bilateral arm (tiled_denoise.cu
// denoise_bilateral_kernel: staging and tail, no blur): a 32 x 64 output
// tile a block of 256 threads, each thread owning a strip of several
// outputs in every pass.
//
// Passes, each followed by one __syncthreads():
//   1. staging: 4-pixel groups of the tile's rows plus halo (grid columns
//      4g .. 4g + 3) into max RGB (sL, when the blur runs on the tile) and
//      RGB on the ring (sY). K1 on u8 first copies the rows as async
//      16-byte chunks into shared memory (one wait for all of them) and
//      decodes the groups there; K4 and K3 read each plane's group as one
//      word (u8) or float4 (f32) where it is inside and aligned; elsewhere,
//      and at the image's edges, each value is read at its clamped column;
//   2. the vertical blur: a column strip of VS rows a thread, the window of
//      VS + 2R values of sL held in registers, into sV;
//   3. the horizontal blur: a row segment of HK ring columns a thread, then
//      the caller's epilogue (K1 and K3: boost and gain into sY; K4: the
//      EMA); K3 then runs its curves on the ring, a column strip of VS rows
//      a thread (curve_tile.cu);
//   4. the bilateral tail: pass 1 (vertical) a column strip of S1 rows,
//      pass 2 (horizontal) or the full 3x3 a row segment of K2 outputs,
//      each neighbour pair's range weight computed once and used at both
//      ends, the centre's weight computed once a thread;
//   5. u8 out: the thread's K2 outputs packed into words in shared memory,
//      then each output row stored as aligned 32-bit words (bytes at its
//      ends).
//
// The blur radius R (1..MAX_BLUR_RADIUS) is a template parameter of passes
// 2 and 3, dispatched at run time once a tile, so the taps sit in
// registers and every window index is a constant. Every sum keeps the plain
// version's order (ops/filters.py's separable_blur, ops/denoise.py's
// cores): vertical blur term k reads row y + R - k, k ascending, then the
// horizontal; the bilateral taps in the order of ops/denoise.py, starting
// from 0, the per-channel forms dividing and the joint ones multiplying by
// 1 / wacc. A pair's weight is one float whichever end computes it: d and
// -d square alike, and IEEE subtraction is antisymmetric.
//
// Layout. Shared memory holds planes on a grid whose column 0 is absolute
// column xa = the multiple of 4 at or below x0 - 1 - R; the staged region
// starts at grid column off, the ring (tile plus one pixel) at cr = off +
// R. Every plane has the odd pitch P = 4 nG + 1 floats, so that a warp's
// lanes reading one column of 32 rows (the row passes) or 32 columns of a
// row (the column passes) hit 32 banks.
#pragma once

#include <cuda_pipeline_primitives.h>

#include "fused_enhance.cuh"

namespace llie {
namespace tile {

constexpr int TH = 32;               // output rows a tile
constexpr int TW = 64;               // output columns a tile
constexpr int NT = 256;              // threads a block
constexpr int YH = TH + 2;           // ring rows
constexpr int YW = TW + 2;           // ring columns
constexpr int VS = 12;               // vertical blur: outputs a thread
constexpr int VSEG = (YH + VS - 1) / VS;
constexpr int HK = 11;               // ring row passes: columns a thread
constexpr int HSEG = YW / HK;
constexpr int S1 = 11;               // tail pass 1: outputs a thread
constexpr int S1SEG = (TH + S1 - 1) / S1;
constexpr int K2 = 8;                // pass 2, full 3x3: outputs a thread
constexpr int OUTW = 3 * TW / 4;     // u8 output words a tile row
constexpr int OP = OUTW + 1;         // their pitch (odd)
static_assert(YW % HK == 0, "the row passes split the ring evenly");
static_assert(TW == K2 * (NT / 32) && TH == 32,
              "pass 2: a warp a column segment, a lane a row");
static_assert(VSEG * YW <= NT && HSEG * YH <= NT && S1SEG * YW <= NT,
              "one item a thread in the strip passes");
static_assert(VS % 4 == 0,
              "K3's curve strips start at one phase of the maps' rows");

// ---------------------------------------------------------- the plan -- //
// x0 is a multiple of 4, so the grid's offset and pitch depend on R alone.
__host__ __device__ constexpr int grid_off(int R) {
  return (1 + R + 3) / 4 * 4 - 1 - R;
}
__host__ __device__ constexpr int groups(int R) {
  return (grid_off(R) + YW + 2 * R + 3) / 4;
}
__host__ __device__ constexpr int pitch(int R) {
  return 4 * groups(R) + 1;
}
// Floats of one plane of the ring: YH rows and a spare one (pass 1 reads a
// row past the ring for an output it drops).
__host__ __device__ constexpr int ring_plane(int R) {
  return (YH + 1) * pitch(R);
}

// K1 on u8 copies the tile's staged rows into shared memory before staging
// decodes them: 16-byte chunks from the one holding a row's first byte, at
// most raw_chunks(R) of them a row.
__host__ __device__ constexpr int raw_chunks(int R) {
  return (12 * groups(R) + 30) / 16;
}
__host__ __device__ constexpr int raw_floats(int R) {
  return (YH + 2 * R) * raw_chunks(R) * 4;
}
// The raw buffers start on a 16-byte boundary after `planes` floats.
__host__ __device__ constexpr int raw_offset(int planes) {
  return (planes + 3) / 4 * 4;
}

// Shared memory of a block in floats, for K1 (`family` 0), K4 (1) and K3
// (2): three ring planes of RGB (sY), then the blur phase (sL: LH + 2 rows,
// sV: YH rows; K4 also sC and sG, YH rows each; K4 without a tile blur:
// l_now in sV's place) or, aliasing it, the tail phase (sP: 3 x TH rows;
// the u8 output words: TH x OP); then K1's raw rows on u8 (`raw`). K3 reads
// its curve maps through the cache and needs nothing beyond K1's planes.
__host__ __device__ constexpr int smem_floats(int family, int R,
                                              bool raw = false) {
  const int P = pitch(R);
  const int lrows = R ? YH + 2 * R + 2 : 0;
  const int blur = (lrows + (family == 1 ? 3 : 1) * YH) * P;
  const int tail = 3 * TH * P + TH * OP;
  const int planes = 3 * ring_plane(R) + (blur > tail ? blur : tail);
  return raw ? raw_offset(planes) + raw_floats(R) : planes;
}

// K3's curve pass (curve_tile.cu): a column strip of VS ring rows a
// thread. With maps at 1/ds (2 or 4) a strip whose first block row r has
// phase s = (r - ds/2) mod ds blends the maps' columns at walk_rows(ds, s)
// consecutive low-res rows from floor((r - ds/2) / ds), each clamped into
// the maps; at ds 1 it reads the VS rows themselves.
__host__ __device__ constexpr int walk_rows(int ds, int s) {
  return ds == 1 ? VS : (s + VS - 1) / ds + 2;
}

struct Geo {
  int R;    // the blur radius on the tile, 0 for none
  int off;  // grid column of the staged region's first column
  int cr;   // grid column of the ring's first column
  int LH;   // staged rows: YH + 2R
  int LW;   // staged columns: YW + 2R
  int nG;   // 4-pixel groups a staged row
  int P;    // plane pitch
  int YP;   // ring plane stride
  int xa;   // absolute column of grid column 0
  int ya;   // absolute row of staged row 0
};

__device__ __forceinline__ Geo make_geo(int R, int x0, int y0) {
  Geo g;
  g.R = R;
  g.off = grid_off(R);
  g.cr = g.off + R;
  g.LH = YH + 2 * R;
  g.LW = YW + 2 * R;
  g.nG = groups(R);
  g.P = pitch(R);
  g.YP = ring_plane(R);
  g.xa = x0 - 1 - R - g.off;
  g.ya = y0 - 1 - R;
  return g;
}

// ------------------------------------------------------------ the I/O -- //
// u8 -> f32 as (float)(int)v * (1/255): the integer from the float whose
// mantissa holds it (exact), so that no conversion instruction is needed.
__device__ __forceinline__ float u8_at(uint32_t w, int k) {
  return (__int_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | k))
          - 8388608.0f) * U8_SCALE;
}

// quantize() as the low byte of a word: clip, * 255, round half to even by
// the add of 2^23 (exact below 2^22; the clip keeps the value in [0, 255],
// so the last clip of quantize() has nothing to do).
__device__ __forceinline__ uint32_t q8(float v) {
  return __float_as_uint(clip01(v) * 255.0f + 8388608.0f);
}

// Four quantized values (bytes 0 of a..d) packed into one word, a lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u),
                     0x5410u);
}

// A staged group of f32 HWC (K1), loaded a group ahead of its use so that
// the loads of the next group are in flight while this one is worked (a
// warp issues in order: the first use of a loaded register waits for it).
struct RawF32 {
  float f[12];
};

// `words`: the group is inside the row and 16-byte aligned, read as three
// float4; otherwise each value at its clamped column.
__device__ __forceinline__ void load_raw(const float* __restrict__ row,
                                         int x, int W, bool words,
                                         RawF32& a) {
  if (words) {
    const float4* p = (const float4*)(row + 3 * x);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 f = p[k];
      a.f[4 * k] = f.x;
      a.f[4 * k + 1] = f.y;
      a.f[4 * k + 2] = f.z;
      a.f[4 * k + 3] = f.w;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      a.f[3 * q + c] = row[3 * clampi(x + q, 0, W - 1) + c];
}

// Planar blocks (K4, K3): a group of 4 columns of one plane row. u8: one
// aligned word where `words` says the group is inside the row and
// aligned, else each byte at its clamped column; f32: a float4, or each
// value at its clamped column.
struct RawPlanes {
  uint32_t r[12];  // u8: a word a plane (or 4 bytes); f32: the bits
  float c[4];      // the carry (K4)
  float l[4];      // l_now (K4 LPLANE); K3's gain or illumination plane
};

__device__ __forceinline__ void load_plane(const uint8_t* __restrict__ row,
                                           int x, int W, bool words,
                                           uint32_t* r) {
  if (words) {
    r[0] = *(const uint32_t*)(row + x);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) r[q] = row[clampi(x + q, 0, W - 1)];
}
__device__ __forceinline__ void load_plane(const float* __restrict__ row,
                                           int x, int W, bool words,
                                           float* v) {
  if (words) {
    const float4 f = *(const float4*)(row + x);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = row[clampi(x + q, 0, W - 1)];
}

__device__ __forceinline__ void load_plane(const float* __restrict__ row,
                                           int x, int W, bool words,
                                           uint32_t* r) {
  float f[4];
  load_plane(row, x, W, words, f);
#pragma unroll
  for (int q = 0; q < 4; ++q) r[q] = __float_as_uint(f[q]);
}
// The 4 values of one plane's group from load_plane.
template <class T>
__device__ __forceinline__ void unpack_plane(const uint32_t* r, bool words,
                                             float v[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(T) == 1)
      v[q] = words ? u8_at(r[0], q) : u8_at(r[q], 0);
    else
      v[q] = __uint_as_float(r[q]);
  }
}

// Staged row i and group gi of every item a thread owns: items are (row,
// group) pairs in row-major order, NT apart. load(i, gi, raw) issues the
// loads of an item, body(i, gi, raw) uses them; the next item's loads are
// issued before the body of this one.
template <class R, class Load, class Body>
__device__ __forceinline__ void for_groups(const Geo& g, int tid, Load load,
                                           Body body) {
  int i = tid / g.nG, gi = tid - i * g.nG;
  const int di = NT / g.nG, dg = NT - di * g.nG;
  R cur;
  if (i < g.LH) load(i, gi, cur);
  while (i < g.LH) {
    int ni = i + di, ngi = gi + dg;
    if (ngi >= g.nG) {
      ngi -= g.nG;
      ++ni;
    }
    R nxt;
    if (ni < g.LH) load(ni, ngi, nxt);
    body(i, gi, cur);
    cur = nxt;
    i = ni;
    gi = ngi;
  }
}

// ------------------------------------------------ K1's raw rows (u8) -- //
// Byte address of row gy of image b, and of the 16-byte chunk holding the
// first byte the tile reads in it (column max(xa, 0)).
__device__ __forceinline__ uintptr_t row_at(const uint8_t* base, int b,
                                            int gy, int H, int W) {
  return (uintptr_t)base + ((size_t)b * H + gy) * W * 3;
}
__device__ __forceinline__ uintptr_t chunk_of(uintptr_t row, const Geo& g) {
  return (row + 3 * max(g.xa, 0)) & ~(uintptr_t)15;
}

// The tile's staged rows, clamped to the image (rows clamped, columns
// [max(xa, 0), min(xa + 4 nG, W))), into buf: row i's chunks at buf + 16 (i
// nch + j). Chunks wholly inside the tensor's bytes [base, base + nbytes)
// go as async copies (committed by the caller); the first and last chunks
// of the tensor byte by byte.
__device__ inline void issue_raw(const uint8_t* __restrict__ base,
                                 size_t nbytes, int H, int W, const Geo& g,
                                 int b, uint8_t* buf, int nch, int tid) {
  const uintptr_t lo = (uintptr_t)base, hi = lo + nbytes;
  const int c1 = min(g.xa + 4 * g.nG, W);
  int i = tid / nch, j = tid - i * nch;
  const int di = NT / nch, dj = NT - di * nch;
  while (i < g.LH) {
    const uintptr_t row = row_at(base, b, clampi(g.ya + i, 0, H - 1), H, W);
    const uintptr_t src = chunk_of(row, g) + 16 * j;
    if (src < row + 3 * c1) {
      uint8_t* dst = buf + 16 * (i * nch + j);
      const uint8_t* sp = base + (ptrdiff_t)(src - lo);
      if (src >= lo && src + 16 <= hi) {
        __pipeline_memcpy_async(dst, sp, 16);
      } else {
        for (int k = 0; k < 16; ++k)
          if (src + k >= lo && src + k < hi) dst[k] = sp[k];
      }
    }
    j += dj;
    i += di;
    if (j >= nch) {
      j -= nch;
      ++i;
    }
  }
}

// Group gi of staged row i from the raw rows: v[channel][pixel]. A group
// inside the image is 12 consecutive bytes, read as words and shifted into
// place; a group with columns off the image reads each pixel at its
// clamped column.
__device__ __forceinline__ void decode_raw(const uint8_t* __restrict__ base,
                                           int H, int W, const Geo& g,
                                           int b, const uint8_t* buf,
                                           int nch, int i, int gi,
                                           float v[3][4]) {
  const uintptr_t row = row_at(base, b, clampi(g.ya + i, 0, H - 1), H, W);
  const uintptr_t c0 = chunk_of(row, g);
  const uint8_t* rb = buf + 16 * i * nch;
  const int x = g.xa + 4 * gi;
  if (x >= 0 && x + 3 < W) {
    const int o = (int)(row + 3 * x - c0);
    const uint32_t* rw = (const uint32_t*)rb + (o >> 2);
    const uint32_t sh = 8 * (o & 3);
    const uint32_t w3 = (o & 3) ? rw[3] : 0u;
    const uint32_t u[3] = {__funnelshift_r(rw[0], rw[1], sh),
                           __funnelshift_r(rw[1], rw[2], sh),
                           __funnelshift_r(rw[2], w3, sh)};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        v[c][q] = u8_at(u[(3 * q + c) >> 2], (3 * q + c) & 3);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = (int)(row + 3 * clampi(x + q, 0, W - 1) - c0);
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c][q] = u8_at(rb[o + c], 0);
  }
}

// One output row's bytes from the word buffer `buf` to dst[0, n): the
// aligned words wholly inside [dst, dst + n) as words, the bytes of the
// first and last words that straddle its ends one by one (a neighbouring
// tile owns the rest of those words). Lanes `lane` of `nl`.
__device__ __forceinline__ void store_bytes(const uint32_t* __restrict__ buf,
                                            uint8_t* dst, int n, int lane,
                                            int nl) {
  const uintptr_t a = (uintptr_t)dst;
  const int s = (int)(a & 3u);
  uint32_t* wp = (uint32_t*)(a - s);
  const int nw = (s + n + 3) >> 2;
  for (int k = lane; k < nw; k += nl) {
    const int lo = 4 * k - s;
    if (lo >= 0 && lo + 4 <= n) {
      wp[k] = s ? __funnelshift_r(buf[k - 1], buf[k], 8 * (4 - s)) : buf[k];
    } else {
      const uint8_t* b8 = (const uint8_t*)buf;
      for (int e = lo < 0 ? 0 : lo; e < lo + 4 && e < n; ++e) dst[e] = b8[e];
    }
  }
}

// ----------------------------------------------------------- the blur -- //
// Pass 2: the vertical blur of sL (staged rows) on the ring's rows and the
// staged columns, into sV (ring row r at sV row r). Term k of ring row r
// reads staged row r + 2R - k.
template <int R>
__device__ inline void v_blur(const float* __restrict__ sL,
                              float* __restrict__ sV, const Geo& g,
                              const BoostParams& bp, int tid) {
  constexpr int NW = VS + 2 * R;
  if (tid >= VSEG * g.LW) return;
  float tp[2 * R + 1];
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) tp[k] = bp.taps[k];
  const int q = tid / g.LW;
  const int j = g.off + tid - q * g.LW;
  const int r0 = q * VS;
  const float* src = sL + r0 * g.P + j;
  float u[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) u[k] = src[k * g.P];
  float* dst = sV + r0 * g.P + j;
#pragma unroll
  for (int o = 0; o < VS; ++o) {
    float acc = tp[0] * u[o + 2 * R];
#pragma unroll
    for (int k = 1; k <= 2 * R; ++k) acc = acc + tp[k] * u[o + 2 * R - k];
    if (r0 + o < YH) dst[o * g.P] = acc;
  }
}

// Pass 3: the horizontal blur of sV on the ring, a row segment of HK
// columns a thread (a lane a row), each value handed to epi(r, c, l) with
// (r, c) its ring position. Term k of ring column c reads staged column
// c + 2R - k.
template <int R, class Epi>
__device__ inline void h_blur(const float* __restrict__ sV, const Geo& g,
                              const BoostParams& bp, int tid, Epi epi) {
  constexpr int NW = HK + 2 * R;
  if (tid >= HSEG * YH) return;
  float tp[2 * R + 1];
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) tp[k] = bp.taps[k];
  const int r = tid % YH, c0 = tid / YH * HK;
  const float* src = sV + r * g.P + g.off + c0;
  float u[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) u[k] = src[k];
#pragma unroll
  for (int o = 0; o < HK; ++o) {
    float l = tp[0] * u[o + 2 * R];
#pragma unroll
    for (int k = 1; k <= 2 * R; ++k) l = l + tp[k] * u[o + 2 * R - k];
    epi(r, c0 + o, l);
  }
}

// The ring positions of pass 3 without a blur: epi(r, c, sL0[r, c]) with
// the value read from a ring plane (K4's l_now from its plane).
template <class Epi>
__device__ inline void ring_rows(const float* __restrict__ s, const Geo& g,
                                 int tid, Epi epi) {
  if (tid >= HSEG * YH) return;
  const int r = tid % YH, c0 = tid / YH * HK;
  const float* src = s + r * g.P + g.cr + c0;
#pragma unroll
  for (int o = 0; o < HK; ++o) epi(r, c0 + o, src[o]);
}

// Both blur passes at the radius of the launch (1..MAX_BLUR_RADIUS), with a
// barrier between and after them.
template <class Epi>
__device__ inline void blur_passes(const float* __restrict__ sL,
                                   float* __restrict__ sV, const Geo& g,
                                   const BoostParams& bp, int tid, Epi epi) {
  switch (g.R) {
#define LLIE_TILE_BLUR(RR)        \
  case RR:                        \
    v_blur<RR>(sL, sV, g, bp, tid); \
    __syncthreads();              \
    h_blur<RR>(sV, g, bp, tid, epi); \
    break;
    LLIE_TILE_BLUR(1)
    LLIE_TILE_BLUR(2)
    LLIE_TILE_BLUR(3)
    LLIE_TILE_BLUR(4)
    LLIE_TILE_BLUR(5)
    LLIE_TILE_BLUR(6)
    LLIE_TILE_BLUR(7)
    LLIE_TILE_BLUR(8)
#undef LLIE_TILE_BLUR
    default:
      break;
  }
  __syncthreads();
}

// ----------------------------------------------------------- the tail -- //
// The centre tap's weight: its spatial weight times the range weight of a
// zero difference, as the plain version computes it (1, unless inv2s2 is
// not finite).
template <bool EPAN>
__device__ __forceinline__ float range_w(float d2, const TailParams& p) {
  if constexpr (EPAN) {
    const float u = fmaxf(1.0f - d2 * p.inv2s2_3, 0.0f);
    return u * u;
  }
  return expf(-d2 * p.inv2s2);
}

template <bool EPAN>
__device__ __forceinline__ float centre_weight(float sp, const TailParams& p) {
  return sp * range_w<EPAN>(0.0f * 0.0f, p);
}

// The weight of a neighbour pair at spatial weight sp: d is either end's
// difference, d * d the same float for both.
template <bool EPAN>
__device__ __forceinline__ float pair_weight(float sp, float d,
                                             const TailParams& p) {
  return sp * range_w<EPAN>(d * d, p);
}

__device__ __forceinline__ float luma3(float r, float g, float b) {
  return (r + g + b) * (1.0f / 3.0f);
}

// Separable pass 1 (vertical) on the ring's columns: a column strip of S1
// output rows a thread; output row t (ring row t + 1) into sP row t. Taps
// t' = -1, 0, 1 read ring rows t + 2, t + 1, t.
template <bool JOINT, bool EPAN>
__device__ inline void sep_pass1(const float* __restrict__ sY,
                                 float* __restrict__ sP, const Geo& g,
                                 const TailParams& p, int tid) {
  constexpr int NW = S1 + 2;
  if (tid >= S1SEG * YW) return;
  const int q = tid / YW, c = tid - q * YW;
  const int t0 = q * S1;
  const float* src = sY + t0 * g.P + g.cr + c;
  float* dst = sP + t0 * g.P + g.cr + c;
  const int PP = TH * g.P;
  const float wc = centre_weight<EPAN>(0.5f, p);
  float v[3][NW];
#pragma unroll
  for (int k = 0; k < NW; ++k)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) v[ch][k] = src[ch * g.YP + k * g.P];
  if constexpr (JOINT) {
    float lu[NW], w[NW - 1];
#pragma unroll
    for (int k = 0; k < NW; ++k) lu[k] = luma3(v[0][k], v[1][k], v[2][k]);
#pragma unroll
    for (int k = 0; k < NW - 1; ++k)
      w[k] = pair_weight<EPAN>(0.25f, lu[k + 1] - lu[k], p);
#pragma unroll
    for (int o = 0; o < S1; ++o) {
      const int m = o + 1;
      const float wacc = ((0.0f + w[m]) + wc) + w[m - 1];
      const float winv = 1.0f / wacc;
      if (t0 + o < TH) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float a = ((0.0f + w[m] * v[ch][m + 1]) + wc * v[ch][m])
                          + w[m - 1] * v[ch][m - 1];
          dst[ch * PP + o * g.P] = a * winv;
        }
      }
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float w[NW - 1];
#pragma unroll
      for (int k = 0; k < NW - 1; ++k)
        w[k] = pair_weight<EPAN>(0.25f, v[ch][k + 1] - v[ch][k], p);
#pragma unroll
      for (int o = 0; o < S1; ++o) {
        const int m = o + 1;
        const float acc = ((0.0f + w[m] * v[ch][m + 1]) + wc * v[ch][m])
                          + w[m - 1] * v[ch][m - 1];
        const float wacc = ((0.0f + w[m]) + wc) + w[m - 1];
        if (t0 + o < TH) dst[ch * PP + o * g.P] = acc / wacc;
      }
    }
  }
}

// The thread's outputs of the row passes: tile row t = lane, tile columns
// c0 .. c0 + K2 - 1 with c0 = K2 * warp.
struct Outs {
  float v[K2][3];
};

// Separable pass 2 (horizontal) on sP, blended with x (sY) by strength:
// taps t' = -1, 0, 1 read ring columns c + 1, c, c - 1 of ring column c.
template <bool JOINT, bool EPAN>
__device__ inline void sep_pass2(const float* __restrict__ sP,
                                 const float* __restrict__ sY, const Geo& g,
                                 const TailParams& p, int tid, Outs& out) {
  constexpr int NW = K2 + 2;
  const int t = tid & 31, c0 = (tid >> 5) * K2;
  const float* src = sP + t * g.P + g.cr + c0;
  const float* xs = sY + (t + 1) * g.P + g.cr + c0 + 1;
  const int PP = TH * g.P;
  const float wc = centre_weight<EPAN>(0.5f, p);
  float v[3][NW];
#pragma unroll
  for (int k = 0; k < NW; ++k)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) v[ch][k] = src[ch * PP + k];
  if constexpr (JOINT) {
    float lu[NW], w[NW - 1];
#pragma unroll
    for (int k = 0; k < NW; ++k) lu[k] = luma3(v[0][k], v[1][k], v[2][k]);
#pragma unroll
    for (int k = 0; k < NW - 1; ++k)
      w[k] = pair_weight<EPAN>(0.25f, lu[k + 1] - lu[k], p);
#pragma unroll
    for (int o = 0; o < K2; ++o) {
      const int m = o + 1;
      const float wacc = ((0.0f + w[m]) + wc) + w[m - 1];
      const float winv = 1.0f / wacc;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float a = ((0.0f + w[m] * v[ch][m + 1]) + wc * v[ch][m])
                        + w[m - 1] * v[ch][m - 1];
        const float x = xs[ch * g.YP + o];
        out.v[o][ch] = x + p.strength * (a * winv - x);
      }
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float w[NW - 1];
#pragma unroll
      for (int k = 0; k < NW - 1; ++k)
        w[k] = pair_weight<EPAN>(0.25f, v[ch][k + 1] - v[ch][k], p);
#pragma unroll
      for (int o = 0; o < K2; ++o) {
        const int m = o + 1;
        const float acc = ((0.0f + w[m] * v[ch][m + 1]) + wc * v[ch][m])
                          + w[m - 1] * v[ch][m - 1];
        const float wacc = ((0.0f + w[m]) + wc) + w[m - 1];
        const float x = xs[ch * g.YP + o];
        out.v[o][ch] = x + p.strength * (acc / wacc - x);
      }
    }
  }
}

// The full 3x3's pairs across rows. up[dj + 1][k] is the pair of window
// (0, k - dj) and (1, k) on the guide gv(row, k) (window rows: 0 the ring
// row above the lane's output row, 1 that row, 2 the row below), at the
// spatial weight of the tap (1, dj): the lane's own tap (1, dj) at column
// k, and the lane above's tap (-1, -dj) at column k - dj (spatial weights
// are symmetric). Only the columns one of the two uses are computed.
template <bool EPAN, class G>
__device__ __forceinline__ void up_pairs(G gv, const TailParams& p,
                                         float (&up)[3][K2 + 2]) {
#pragma unroll
  for (int dj = -1; dj <= 1; ++dj)
#pragma unroll
    for (int k = 0; k < K2 + 2; ++k) {
      const bool own = k >= 1 && k <= K2, above = k - dj >= 1 && k - dj <= K2;
      up[dj + 1][k] =
          own || above ? pair_weight<EPAN>(spatial(2) * spatial(dj + 1),
                                           gv(0, k - dj) - gv(1, k), p)
                       : 0.0f;
    }
}

// Lane 31's pairs with the row below (ring rows 32 and 33), which no lane
// owns: one a lane, item 3 o + dj + 1 for output column o + 1 and tap (-1,
// dj), on the guide gr(ring row, window column). Lanes past the 3 K2 items
// repeat the last.
template <bool EPAN, class G>
__device__ __forceinline__ float last_pair(G gr, const TailParams& p,
                                           int lane) {
  const int item = min(lane, 3 * K2 - 1);
  const int m = item / 3 + 1, dj = item % 3 - 1;
  return pair_weight<EPAN>(spatial(0) * spatial(dj + 1),
                           gr(TH + 1, m - dj) - gr(TH, m), p);
}

// The weight of output column m's tap (-1, dj): the lane below's up pair
// (-dj, m - dj), or, on lane 31, item 3 (m - 1) + dj + 1 of last_pair.
__device__ __forceinline__ float below_pair(const float (&up)[3][K2 + 2],
                                            float last, int lane, int m,
                                            int dj) {
  const float below = __shfl_down_sync(0xffffffffu, up[1 - dj][m - dj], 1);
  const float own = __shfl_sync(0xffffffffu, last, 3 * (m - 1) + dj + 1);
  return lane == 31 ? own : below;
}

// The full 3x3 on sY: taps (di, dj), di outer, read ring (t + 1 - di,
// c - dj) of ring position (t + 1, c). Each pair's weight is computed once:
// the centre row's along the segment; the row above's by the lane (up); the
// row below's are the lane below's up pairs, handed over by a shuffle.
template <bool JOINT, bool EPAN>
__device__ inline void full_tail(const float* __restrict__ sY, const Geo& g,
                                 const TailParams& p, int tid, Outs& out) {
  static_assert(3 * K2 <= 32, "lane 31's pairs below: one a lane");
  constexpr int NW = K2 + 2;
  const int t = tid & 31, c0 = (tid >> 5) * K2;
  const float* src = sY + t * g.P + g.cr + c0;  // window row 0, column 0
  const float* ring = sY + g.cr + c0;           // ring row 0, column c0
  const float wc = centre_weight<EPAN>(0.25f, p);
  // window (row, column): rows t .. t + 2, ring columns c0 .. c0 + K2 + 1
  auto at = [&](int ch, int row, int col) {
    return src[ch * g.YP + row * g.P + col];
  };
  if constexpr (JOINT) {
    float lu[3][NW];
#pragma unroll
    for (int row = 0; row < 3; ++row)
#pragma unroll
      for (int k = 0; k < NW; ++k)
        lu[row][k] = luma3(at(0, row, k), at(1, row, k), at(2, row, k));
    float wh[NW - 1], up[3][NW];
#pragma unroll
    for (int k = 0; k < NW - 1; ++k)
      wh[k] = pair_weight<EPAN>(0.125f, lu[1][k + 1] - lu[1][k], p);
    up_pairs<EPAN>([&](int row, int k) { return lu[row][k]; }, p, up);
    const float last = last_pair<EPAN>(
        [&](int r, int k) {
          const float* q = ring + r * g.P + k;
          return luma3(q[0], q[g.YP], q[2 * g.YP]);
        },
        p, t);
#pragma unroll
    for (int o = 0; o < K2; ++o) {
      const int m = o + 1;
      float w[9];
#pragma unroll
      for (int dj = -1; dj <= 1; ++dj) {
        w[dj + 1] = below_pair(up, last, t, m, dj);
        w[7 + dj] = up[dj + 1][m];
      }
      w[3] = wh[m];
      w[4] = wc;
      w[5] = wh[m - 1];
      float wacc = 0.0f, a[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int di = -1; di <= 1; ++di)
#pragma unroll
        for (int dj = -1; dj <= 1; ++dj) {
          const float wn = w[(di + 1) * 3 + dj + 1];
          wacc = wacc + wn;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            a[ch] = a[ch] + wn * at(ch, 1 - di, m - dj);
        }
      const float winv = 1.0f / wacc;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float x = at(ch, 1, m);
        out.v[o][ch] = x + p.strength * (a[ch] * winv - x);
      }
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float wh[NW - 1], up[3][NW];
#pragma unroll
      for (int k = 0; k < NW - 1; ++k)
        wh[k] = pair_weight<EPAN>(0.125f, at(ch, 1, k + 1) - at(ch, 1, k), p);
      up_pairs<EPAN>([&](int row, int k) { return at(ch, row, k); }, p, up);
      const float last = last_pair<EPAN>(
          [&](int r, int k) { return ring[ch * g.YP + r * g.P + k]; }, p, t);
#pragma unroll
      for (int o = 0; o < K2; ++o) {
        const int m = o + 1;
        const float x = at(ch, 1, m);
        float w[9];
#pragma unroll
        for (int dj = -1; dj <= 1; ++dj) {
          w[dj + 1] = below_pair(up, last, t, m, dj);
          w[7 + dj] = up[dj + 1][m];
        }
        w[3] = wh[m];
        w[4] = wc;
        w[5] = wh[m - 1];
        float acc = 0.0f, wacc = 0.0f;
#pragma unroll
        for (int di = -1; di <= 1; ++di)
#pragma unroll
          for (int dj = -1; dj <= 1; ++dj) {
            const float wn = w[(di + 1) * 3 + dj + 1];
            acc = acc + wn * at(ch, 1 - di, m - dj);
            wacc = wacc + wn;
          }
        out.v[o][ch] = x + p.strength * (acc / wacc - x);
      }
    }
  }
}

// The tail's form at a range kernel, dispatched once a tile.
template <bool EPAN>
__device__ inline void tail_form(const float* __restrict__ sY,
                                 float* __restrict__ sP, const Geo& g,
                                 const TailParams& p, int tid, Outs& out) {
  if (p.sep) {
    if (p.joint)
      sep_pass1<true, EPAN>(sY, sP, g, p, tid);
    else
      sep_pass1<false, EPAN>(sY, sP, g, p, tid);
    __syncthreads();
    if (p.joint)
      sep_pass2<true, EPAN>(sP, sY, g, p, tid, out);
    else
      sep_pass2<false, EPAN>(sP, sY, g, p, tid, out);
    return;
  }
  if (p.joint)
    full_tail<true, EPAN>(sY, g, p, tid, out);
  else
    full_tail<false, EPAN>(sY, g, p, tid, out);
}

// The tail of the launch's TailParams on sY (sP its pass-1 buffer), or, with
// `denoise` false or strength <= 0, the ring values themselves. Pass 1 of
// the separable forms ends with a barrier: every thread calls it.
__device__ inline void tail(const float* __restrict__ sY,
                            float* __restrict__ sP, const Geo& g,
                            const TailParams& p, bool denoise, int tid,
                            Outs& out) {
  if (!denoise || p.strength <= 0.0f) {
    const int t = tid & 31, c0 = (tid >> 5) * K2;
    const float* xs = sY + (t + 1) * g.P + g.cr + c0 + 1;
#pragma unroll
    for (int o = 0; o < K2; ++o)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) out.v[o][ch] = xs[ch * g.YP + o];
    return;
  }
  if (p.kind)
    tail_form<true>(sY, sP, g, p, tid, out);
  else
    tail_form<false>(sY, sP, g, p, tid, out);
}

// ------------------------------------------------------ out, launch -- //
// The u8 output words of the thread's K2 pixels, into its row of the word
// buffer: HWC (bytes r g b r g b ...; 6 words at 6 * warp) or planar (2
// words a channel at 16 * ch + 2 * warp).
template <bool HWC>
__device__ inline void pack_out(const Outs& o, uint32_t* __restrict__ buf,
                                int tid) {
  const int t = tid & 31, wq = tid >> 5;
  uint32_t* row = buf + t * OP;
  if constexpr (HWC) {
    uint32_t q[3 * K2];
#pragma unroll
    for (int k = 0; k < K2; ++k)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) q[3 * k + ch] = q8(o.v[k][ch]);
#pragma unroll
    for (int w = 0; w < 3 * K2 / 4; ++w)
      row[(3 * K2 / 4) * wq + w] =
          pack4(q[4 * w], q[4 * w + 1], q[4 * w + 2], q[4 * w + 3]);
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int w = 0; w < K2 / 4; ++w)
        row[(TW / 4) * ch + (K2 / 4) * wq + w] =
            pack4(q8(o.v[4 * w][ch]), q8(o.v[4 * w + 1][ch]),
                  q8(o.v[4 * w + 2][ch]), q8(o.v[4 * w + 3][ch]));
  }
}

// The largest block any form asks for: K1 on u8 or K4 at MAX_BLUR_RADIUS
// (K3's planes are K1's without the raw rows).
constexpr int MAX_SMEM_BYTES =
    (int)sizeof(float) * (smem_floats(0, MAX_BLUR_RADIUS, true)
                          > smem_floats(1, MAX_BLUR_RADIUS)
                              ? smem_floats(0, MAX_BLUR_RADIUS, true)
                              : smem_floats(1, MAX_BLUR_RADIUS));
static_assert(MAX_SMEM_BYTES <= 227 * 1024, "a block's shared memory");
static_assert(smem_floats(2, MAX_BLUR_RADIUS) <= smem_floats(0,
                                                             MAX_BLUR_RADIUS,
                                                             true),
              "K3's block within the opt-in");

// Every form asks for more than the default 48 KB of shared memory. The
// attribute holds for the device current when it is set, so it is set
// before every launch (the caller has made the tensors' device current).
template <class K>
int prepare(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM_BYTES);
}

}  // namespace tile
}  // namespace llie
