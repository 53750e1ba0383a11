// The guided tails of K1 (retinex), K3 (curve / hybrid, and K1's gain form)
// and K4 (the retinex video step) for Hopper (sm_90a): one kernel template,
// instantiated a family at a time in fused_guided.cu (K1), guided_curve.cu
// (K3 and the gain form) and guided_ema.cu (K4), which nvcc compiles in
// parallel; bound to PyTorch through ctypes (kernels/fused_enhance.py).
//
// What they replace. The denoise_taps="guided" arms of the TPU kernels
// _retinex_kernel (stateless, ext_gain and ema_alpha) and _curve_kernel
// (low_light_image_enhancement_tpu/kernels/fused_enhance.py): the same
// boost, gain, EMA and curves as the bilateral forms, then plane_cores'
// guided cores (the self-guided filter per channel, or one channel-mean
// guide for all three), blended by strength, clipped and stored as u8 or
// f32.
//
// What bounds them. The guided cascade does 14 box means of 4r + 2 adds and
// a multiply per pixel, and the a / b algebra: about 236 operations a pixel
// at r = 2 and 348 at r = 4 with the luma guide, on 3 bytes in and 3 out
// (u8), so the f32 rate bounds them, as it bounds K1.
//
// What the design does about it. A 32 x 32 output tile of 256 threads
// (guided.cuh's, K5's), in three phases with a barrier after each step:
//   1. staging: the family's y on the tile and its 2r ring, written into
//      the three planes guided_tile reads (and the joint guide beside them)
//      by row-major walks of the region, consecutive threads on
//      consecutive columns, with the device-memory loads of several
//      positions in flight a thread (the ring's walks as strided loops
//      whose trip count the compiler sees; the blur's wider ring, whose
//      width is the run-time blur radius's, in groups of 4 pixels loaded as
//      words or float4 where inside and aligned): the loads and max RGB on
//      the blur's ring, the vertical blur (in column strips at the default
//      radius), the horizontal blur with the boost or the EMA as its
//      epilogue, which multiplies the planes in place; K3's margin columns
//      copied from their nearest image column in place, then its curves in
//      column strips of 4 or 8 rows a thread (the three channels' values in
//      registers through their steps, a step's map loads in flight
//      together, maps at 1/2 and 1/4 blended by columns once a low-res
//      row);
//   2. guided_tile, which leaves the blended tile over the planes' centres;
//   3. the store, row-major over the tile.
// The family, the radius and the guide are template parameters (3 x 8 x 2
// kernels), so each family has its own register budget: the kernels are
// built for the blocks an SM that guided_tile's shared memory allows
// (GuidedGeom::BLOCKS: 3 where it fits 75 KB, else 2 or 1). The I/O type,
// K1's stages, the blur radius and K3's form and map factor are uniform
// run-time branches. The TPU kernels' wrap shifts on a stripe canvas become
// clamped reads of the image (K1) or of the replicate-padded block (K3,
// K4), as in the bilateral forms; the canvas margin covers the tail's reach
// 2r plus the blur's, so no kept pixel reads a clamped position.
//
// Numerics. As fused_enhance.cuh: --fmad=false, the plain versions' tap
// order, rintf; guided_tile is bit-equal to ops/guided.py's shift cores.
#pragma once

#include "fused_enhance.cuh"
#include "guided.cuh"
#include "retinex_tile.cuh"

namespace llie {

enum GuidedFamily { FG_RETINEX = 0, FG_GAIN = 1, FG_CURVE = 2, FG_EMA = 3 };
// The parts of a launch that run after the staging (tools/profile_torch.py
// stages_guided times the kernel with fewer of them).
constexpr int PART_TAIL = 1, PART_STORE = 2;

// One launch's arguments (kernels/fused_enhance.py _GuidedArgs mirrors
// it). K1: `in` / `out` (B, H, W, 3). The others: the block (B, 3, H, W)
// (H, W = HB, WB) in, (B, 3, rows, W) out, output row r <-> block row halo
// + r; K4's tiles cover the band [m, H - m).
struct FusedGuidedArgs {
  const void* in;
  void* out;
  const float* maps;   // K3: (B, n_iter, 3, H/ds, W/ds)
  const float* gain;   // K1's gain form, K3's video form: (B, H, W)
  const float* lp;     // blur radius past MAX_BLUR_RADIUS: the blurred
                       // illumination, K1 (B, H + 2 lpe, W + 2 lpe),
                       // K3 / K4 (B, H, W); else NULL
  const float* carry;  // K4: (B, H, W), negative = not set
  float* ncarry;       // K4: the new carry
  int family, f32;
  int B, H, W;
  int halo, rows, m, img_w;
  int n_iter, ds, boost;
  int stages;          // K1: STAGE_BLUR | STAGE_BOOST (the tail runs)
  int lpe;
  int parts;           // PART_TAIL | PART_STORE: both in every call of the
                       // wrappers; fewer to time the staging alone
  BoostParams bp;
  UpParams up;
  EmaParams ep;
  GuidedParams gp;
};

// The kernel family of a launch: K1's gain form runs K3's.
__host__ __device__ constexpr int kernel_family(int family) {
  return family == FG_GAIN ? FG_CURVE : family;
}

// The blur radius the staging runs on the tile (0: none, or a plane).
inline int tile_blur(const FusedGuidedArgs& a) {
  if (a.lp) return 0;
  if (a.family == FG_RETINEX) return (a.stages & STAGE_BLUR) ? a.bp.radius : 0;
  if (a.family == FG_EMA) return a.bp.radius;
  return a.family == FG_CURVE && a.boost ? a.bp.radius : 0;
}

// Floats a launch's shared memory holds: guided_tile's planes, or the
// staging's (the planes and guide, then K4's gain plane LH x LS, the
// vertical blur LH x EW and max RGB EH x EW) where that is more.
template <int R>
__host__ __device__ constexpr int staging_floats(int family, bool joint,
                                                 int rb) {
  using Gm = GuidedGeom<R>;
  const int EW = Gm::LW + 2 * rb, EH = Gm::LH + 2 * rb;
  return Gm::scratch(joint) + (family == FG_EMA ? Gm::LN : 0)
         + (rb > 0 ? Gm::LH * EW + EH * EW : 0);
}
template <int R>
__host__ __device__ constexpr int launch_floats(int family, bool joint,
                                                int rb) {
  return staging_floats<R>(family, joint, rb) > GuidedGeom<R>::floats(joint)
             ? staging_floats<R>(family, joint, rb)
             : GuidedGeom<R>::floats(joint);
}

// Every (i, j) of an nr x nc region (nc <= GUIDED_THREADS), row-major,
// GUIDED_THREADS apart: consecutive threads on consecutive columns.
template <class Fn>
__device__ __forceinline__ void for_region(int nr, int nc, int tid, Fn fn) {
  int i = tid / nc, j = tid - i * nc;
  const int di = GUIDED_THREADS / nc, dj = GUIDED_THREADS - di * nc;
  while (i < nr) {
    fn(i, j);
    i += di;
    j += dj;
    if (j >= nc) {
      j -= nc;
      ++i;
    }
  }
}

// A position's loads from device memory: three channels, a plane value (a
// gain or a blurred illumination) and K4's carry.
struct Px {
  float v[5];
};

// Every (i, j) of an NR x NC region whose size is known at compile time
// (the staged ring without a blur, the blur's last pass), row-major,
// GUIDED_THREADS apart: a strided loop whose trip count and divisions the
// compiler sees, which it unrolls with the loads of several positions
// issued ahead (faster, measured, than a chunked walk written out).
template <int NR, int NC, class Fn>
__device__ __forceinline__ void for_ring(int tid, Fn fn) {
  for (int e = tid; e < NR * NC; e += GUIDED_THREADS) fn(e / NC, e % NC);
}

// y at staged position `at` into the planes, and its joint guide.
template <int R, bool JOINT>
__device__ __forceinline__ void put_y(float* __restrict__ sm, int at,
                                      const float (&y)[3]) {
  using Gm = GuidedGeom<R>;
#pragma unroll
  for (int c = 0; c < 3; ++c) sm[c * Gm::LN + at] = y[c];
  if constexpr (JOINT) sm[3 * Gm::LN + at] = guide_of(y[0], y[1], y[2]);
}

// The illumination blur of max RGB (sL0: EH x EW at stride EW) on the
// staged region, at the launch's radius rb: the vertical pass into sV (LH x
// EW), then the horizontal one, whose value at staged position (i, j) goes
// to epi(i, j, l, px) with px what pre(i, j, px) loaded there (K4's
// carry). The order of ops/filters.py's separable_blur: term k of the
// vertical pass reads row i + 2rb - k, of the horizontal column j + 2rb -
// k, k ascending. Each pass ends with a barrier. RB > 0: the radius is RB,
// its taps in registers and the vertical pass in column strips (the
// default radius 2); RB 0: a run-time radius.
template <int R, int RB, class Pre, class Epi>
__device__ __forceinline__ void blur_ring(const float* __restrict__ sL0,
                                          float* __restrict__ sV,
                                          const BoostParams& bp, int tid,
                                          Pre pre, Epi epi) {
  using Gm = GuidedGeom<R>;
  constexpr int NTAP = 2 * (RB > 0 ? RB : MAX_BLUR_RADIUS) + 1;
  const int rb = RB > 0 ? RB : bp.radius, EW = Gm::LW + 2 * rb;
  float tp[NTAP];
  if constexpr (RB > 0) {
#pragma unroll
    for (int k = 0; k < NTAP; ++k) tp[k] = bp.taps[k];
  }
  auto tap = [&](int k) { return RB > 0 ? tp[k] : bp.taps[k]; };
  if constexpr (RB > 0) {
    // column strips of VR rows a thread, the window in registers
    constexpr int VR = 4, NW = VR + 2 * RB;
    static_assert(Gm::LH % VR == 0, "the strips cover the staged rows");
    for_region(Gm::LH / VR, EW, tid, [&](int q, int j) {
      const float* s = sL0 + q * VR * EW + j;
      float u[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) u[k] = s[k * EW];
#pragma unroll
      for (int o = 0; o < VR; ++o) {
        float acc = tp[0] * u[o + 2 * RB];
#pragma unroll
        for (int k = 1; k < NTAP; ++k) acc = acc + tp[k] * u[o + 2 * RB - k];
        sV[(q * VR + o) * EW + j] = acc;
      }
    });
  } else {
    for_region(Gm::LH, EW, tid, [&](int i, int j) {
      const float* s = sL0 + (i + 2 * rb) * EW + j;
      float acc = bp.taps[0] * s[0];
      for (int k = 1; k <= 2 * rb; ++k) acc = acc + bp.taps[k] * s[-k * EW];
      sV[i * EW + j] = acc;
    });
  }
  __syncthreads();
  for_ring<Gm::LH, Gm::LW>(tid, [&](int i, int j) {
    Px px;
    pre(i, j, px);
    const float* s = sV + i * EW + j + 2 * rb;
    float l = tap(0) * s[0];
    if constexpr (RB > 0) {
#pragma unroll
      for (int k = 1; k < NTAP; ++k) l = l + tp[k] * s[-k];
    } else {
      for (int k = 1; k <= 2 * rb; ++k) l = l + bp.taps[k] * s[-k];
    }
    epi(i, j, l, px);
  });
  __syncthreads();
}

// blur_ring at the launch's radius: the default radius with its taps in
// registers, the others at a run-time radius.
template <int R, class Pre, class Epi>
__device__ __forceinline__ void blur_ring_at(const float* __restrict__ sL0,
                                             float* __restrict__ sV,
                                             const BoostParams& bp, int tid,
                                             Pre pre, Epi epi) {
  if (bp.radius == 2) blur_ring<R, 2>(sL0, sV, bp, tid, pre, epi);
  else blur_ring<R, 0>(sL0, sV, bp, tid, pre, epi);
}

// ------------------------------------------------------------------ K1 -- //
// Pixels x .. x + 3 of an HWC image row, v[3 q + c]: 12 consecutive
// values, as 3 words (u8) or 3 float4 (f32) where `words` says the group is
// inside the row and aligned, else each pixel at its clamped column.
__device__ __forceinline__ void load_group(const uint8_t* __restrict__ row,
                                           int x, int W, bool words,
                                           float (&v)[12]) {
  if (words) {
    const uint32_t* p = (const uint32_t*)(row + 3 * x);
    const uint32_t w[3] = {p[0], p[1], p[2]};
#pragma unroll
    for (int k = 0; k < 12; ++k) v[k] = tile::u8_at(w[k >> 2], k & 3);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[3 * q + c] = load_px(row + 3 * clampi(x + q, 0, W - 1) + c);
}
__device__ __forceinline__ void load_group(const float* __restrict__ row,
                                           int x, int W, bool words,
                                           float (&v)[12]) {
  tile::RawF32 r;
  tile::load_raw(row, x, W, words, r);
#pragma unroll
  for (int k = 0; k < 12; ++k) v[k] = r.f[k];
}

// The blur's ring of a planar block (rows clamped from ya, EH x EW staged
// positions from block column gx0) in groups of 4 columns from the
// multiple of 4 at or below gx0, each plane's group one word (u8) or float4
// (f32) where it is inside the block and aligned (the tile engine's
// load_plane), else each value at its clamped column; use(i, j, px) gets
// each staged position's three values.
template <class T, class Use>
__device__ __forceinline__ void for_planar_groups(const T* __restrict__ blk,
                                                  size_t plane, int H, int W,
                                                  int ya, int gx0, int EH,
                                                  int EW, int tid, Use use) {
  const int off = gx0 & 3, NG = (EW + off + 3) >> 2;
  const bool al = (W & 3) == 0
                  && ((uintptr_t)blk & (sizeof(T) == 1 ? 3 : 15)) == 0;
  for_region(EH, NG, tid, [&](int i, int q) {
    const int x = gx0 - off + 4 * q;
    const bool words = al && x >= 0 && x + 3 < W;
    const size_t row = (size_t)clampi(ya + i, 0, H - 1) * W;
    uint32_t raw[12];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      tile::load_plane(blk + c * plane + row, x, W, words, raw + 4 * c);
    float v[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      tile::unpack_plane<T>(raw + 4 * c, words, v[c]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q - off + u;
      if (j < 0 || j >= EW) continue;
      Px px;
#pragma unroll
      for (int c = 0; c < 3; ++c) px.v[c] = v[c][u];
      use(i, j, px);
    }
  });
}

// ring position (i, j) <-> image pixel (r0 + i, c0 + j), reads clamped
template <class T, int R, bool JOINT>
__device__ __forceinline__ void stage_retinex(const FusedGuidedArgs& a,
                                              float* __restrict__ sm, int r0,
                                              int c0, int tid) {
  using Gm = GuidedGeom<R>;
  constexpr int LH = Gm::LH, LW = Gm::LW, LS = Gm::LS, LN = Gm::LN;
  const BoostParams& bp = a.bp;
  const int H = a.H, W = a.W, b = blockIdx.z;
  const bool blur = a.stages & STAGE_BLUR, boost = a.stages & STAGE_BOOST;
  const bool gained = blur || boost;
  const int rb = blur && !a.lp ? bp.radius : 0;
  const int EW = LW + 2 * rb, EH = LH + 2 * rb;
  float* sV = sm + Gm::scratch(JOINT);  // LH x EW: the vertical blur
  float* sL0 = sV + LH * EW;            // EH x EW: max RGB
  const T* img = (const T*)a.in + (size_t)b * H * W * 3;
  // without a blur on the tile, the illumination from the blurred plane
  const bool plane = blur && rb == 0;
  const int pe = a.lpe, hw = W + 2 * pe;
  auto load = [&](int i, int j, Px& px) {
        const int gy = clampi(r0 - rb + i, 0, H - 1);
        const int gx = clampi(c0 - rb + j, 0, W - 1);
        const T* p = img + ((size_t)gy * W + gx) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) px.v[c] = load_px(p + c);
        if (plane)
          px.v[3] = a.lp[((size_t)b * (H + 2 * pe)
                          + clampi(r0 + i + pe, 0, H + 2 * pe - 1)) * hw
                         + clampi(c0 + j + pe, 0, hw - 1)];
  };
  auto use = [&](int i, int j, const Px& px) {
        float x[3] = {px.v[0], px.v[1], px.v[2]};
        if (rb > 0) {
          sL0[i * EW + j] = fmaxf(fmaxf(x[0], x[1]), x[2]);
          const int yi = i - rb, yj = j - rb;
          if (yi >= 0 && yi < LH && yj >= 0 && yj < LW) {
#pragma unroll
            for (int c = 0; c < 3; ++c) sm[c * LN + yi * LS + yj] = x[c];
          }
          return;
        }
        // no blur on the tile: y = x, or x times the gain of max RGB or of
        // the blurred plane
        if (gained) {
          const float l = plane ? px.v[3] : fmaxf(fmaxf(x[0], x[1]), x[2]);
          const float g = boost_gain(l, bp, boost);
#pragma unroll
          for (int c = 0; c < 3; ++c) x[c] = clip01(x[c] * g);
        }
        put_y<R, JOINT>(sm, i * LS + j, x);
  };
  if (rb > 0) {
    // the blur's ring in groups of 4 image columns from the multiple of 4
    // at or below its first column gx0
    const int gx0 = c0 - rb, off = gx0 & 3, NG = (EW + off + 3) >> 2;
    const bool al = (W & 3) == 0
                    && ((uintptr_t)a.in & (sizeof(T) == 1 ? 3 : 15)) == 0;
    for_region(EH, NG, tid, [&](int i, int q) {
      const int x = gx0 - off + 4 * q;
      float v[12];
      load_group(img + (size_t)clampi(r0 - rb + i, 0, H - 1) * W * 3, x, W,
                 al && x >= 0 && x + 3 < W, v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * q - off + u;
        if (j < 0 || j >= EW) continue;
        Px px;
#pragma unroll
        for (int c = 0; c < 3; ++c) px.v[c] = v[3 * u + c];
        use(i, j, px);
      }
    });
  } else {
    for_ring<LH, LW>(tid, [&](int i, int j) {
      Px px;
      load(i, j, px);
      use(i, j, px);
    });
  }
  __syncthreads();
  if (rb == 0) return;
  blur_ring_at<R>(sL0, sV, bp, tid, [](int, int, Px&) {},
                  [&](int i, int j, float l, const Px&) {
                    const float g = boost_gain(l, bp, boost);
                    const int at = i * LS + j;
                    float y[3];
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                      y[c] = clip01(sm[c * LN + at] * g);
                    put_y<R, JOINT>(sm, at, y);
                  });
}

// ------------------------------------------------------------------ K4 -- //
// ring position (i, j) <-> block (r0 + i, c0 + j); the gain on the ring
// (and the new carry of the tile's own pixels), then applied from the
// nearest image column
template <class T, int R, bool JOINT>
__device__ __forceinline__ void stage_ema(const FusedGuidedArgs& a,
                                          float* __restrict__ sm, int r0,
                                          int c0, int tid) {
  using Gm = GuidedGeom<R>;
  constexpr int LH = Gm::LH, LW = Gm::LW, LS = Gm::LS, LN = Gm::LN;
  const BoostParams& bp = a.bp;
  const EmaParams& ep = a.ep;
  const int H = a.H, W = a.W, b = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const int rb = a.lp ? 0 : bp.radius;
  const int EW = LW + 2 * rb, EH = LH + 2 * rb;
  float* sG = sm + Gm::scratch(JOINT);  // LH x LS: the gain
  float* sV = sG + LN;                  // LH x EW: the vertical blur
  float* sL0 = sV + LH * EW;            // EH x EW: max RGB
  const T* blk = (const T*)a.in + (size_t)b * 3 * plane;
  const float* cp = a.carry + (size_t)b * plane;
  float* np = a.ncarry + (size_t)b * plane;
  const int band_end = H - a.m;
  // the carry of ring position (i, j), loaded with the position's other
  // values
  auto carry_at = [&](int i, int j) {
    return cp[(size_t)clampi(r0 + i, 0, H - 1) * W + clampi(c0 + j, 0, W - 1)];
  };
  auto gain_at = [&](int i, int j, float l, float c) {
    const int row = r0 + i, col = c0 + j;
    const float l_mix = c < 0.0f ? l : ep.alpha * l + ep.beta * c;
    sG[i * LS + j] = expf(ep.gamma * logf(fminf(fmaxf(l_mix, bp.eps), 1.0f))
                          - logf(fminf(fmaxf(l, bp.eps), 1.0f)));
    if (i >= 2 * R && i < 2 * R + GT_H && j >= 2 * R && j < 2 * R + GT_W
        && row < band_end && col < W) {
      np[(size_t)row * W + col] = l_mix;
      if (row == a.m)
        for (int k = 0; k < a.m; ++k) np[(size_t)k * W + col] = l_mix;
      if (row == band_end - 1)
        for (int k = band_end; k < H; ++k) np[(size_t)k * W + col] = l_mix;
    }
  };
  auto load = [&](int i, int j, Px& px) {
        const size_t at = (size_t)clampi(r0 - rb + i, 0, H - 1) * W
                          + clampi(c0 - rb + j, 0, W - 1);
#pragma unroll
        for (int c = 0; c < 3; ++c) px.v[c] = load_px(blk + c * plane + at);
        if (rb == 0) {  // l_now from the plane, and the carry
          px.v[3] = a.lp[(size_t)b * plane + at];
          px.v[4] = carry_at(i, j);
        }
  };
  auto use = [&](int i, int j, const Px& px) {
        if (rb > 0)
          sL0[i * EW + j] = fmaxf(fmaxf(px.v[0], px.v[1]), px.v[2]);
        const int yi = i - rb, yj = j - rb;
        if (yi < 0 || yi >= LH || yj < 0 || yj >= LW) return;
#pragma unroll
        for (int c = 0; c < 3; ++c) sm[c * LN + yi * LS + yj] = px.v[c];
        if (rb == 0) gain_at(i, j, px.v[3], px.v[4]);
  };
  if (rb > 0)
    for_planar_groups(blk, plane, H, W, r0 - rb, c0 - rb, EH, EW, tid, use);
  else for_ring<LH, LW>(tid, [&](int i, int j) {
    Px px;
    load(i, j, px);
    use(i, j, px);
  });
  __syncthreads();
  if (rb > 0)
    blur_ring_at<R>(sL0, sV, bp, tid,
                    [&](int i, int j, Px& px) { px.v[0] = carry_at(i, j); },
                    [&](int i, int j, float l, const Px& px) {
                      gain_at(i, j, l, px.v[0]);
                    });
  for_ring<LH, LW>(tid, [&](int i, int j) {
    // the gain of the nearest image column
    const int jr = clampi(clampi(c0 + j, a.m, a.m + a.img_w - 1) - c0, 0,
                          LW - 1);
    const float g = sG[i * LS + jr];
    const int at = i * LS + j;
    float y[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c] = clip01(sm[c * LN + at] * g);
    put_y<R, JOINT>(sm, at, y);
  });
  __syncthreads();
}

// ------------------------------------------------------------------ K3 -- //
// K3's curve strips: staged rows a thread, with maps at 1/DS, in a kernel
// built for `blocks` an SM (at 3, 80 registers, a shorter strip at 1/1).
template <int DS>
__host__ __device__ constexpr int strip_rows(int blocks) {
  return DS == 1 && blocks < 3 ? 8 : 4;
}

// The curves at 1/DS on the ring, in place: column strips of strip_rows()
// staged rows, the strip's values in registers through its steps, the
// three channels' steps (iteration it of channel c reads map it * 3 + c)
// side by side, so that a step's map loads are in flight together: at 1/1
// the strip's 3 x 4 or 3 x 8 values; at 1/2 and 1/4 the two column taps at
// each of the at most K low-res rows under the strip's 4 rows, blended once
// a row (map_tap's column blend) and shared by the rows between them (a
// channel at a time at 1/2 in the kernels built for 3 blocks an SM, whose
// 80 registers do not hold three). Then the joint guide of the strip.
// Every map value keeps map_tap's order (the column blend at the two
// low-res rows, then the row blend), every step apply_curves' (v + a * v *
// (1 - v)).
template <int DS, int R, bool JOINT>
__device__ __forceinline__ void curve_strips(const FusedGuidedArgs& a,
                                             float* __restrict__ sm,
                                             int r0, int c0, int tid) {
  using Gm = GuidedGeom<R>;
  constexpr int LH = Gm::LH, LW = Gm::LW, LS = Gm::LS, LN = Gm::LN;
  constexpr int S = strip_rows<DS>(Gm::BLOCKS(JOINT)), NS = (LH + S - 1) / S;
  const int H = a.H, W = a.W, b = blockIdx.z, n_iter = a.n_iter;
  const int hl = H / DS, wl = W / DS;
  const size_t lplane = (size_t)hl * wl;
  const float* mp = a.maps + (size_t)b * n_iter * 3 * lplane;
  for_region(NS, LW, tid, [&](int q, int j) {
    const int i0 = q * S;
    const int bc = clampi(c0 + j, 0, W - 1);
    const int nr = min(S, LH - i0);
    float* col = sm + i0 * LS + j;
    if constexpr (DS == 1) {
      int o0[S];
#pragma unroll
      for (int o = 0; o < S; ++o)
        o0[o] = clampi(r0 + i0 + o, 0, H - 1) * W + bc;
      float v[3][S];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int o = 0; o < S; ++o)
          v[c][o] = o < nr ? col[c * LN + o * LS] : 0.0f;
      for (int it = 0; it < n_iter; ++it) {
        const float* mq = mp + (size_t)it * 3 * lplane;
        float m[3][S];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int o = 0; o < S; ++o) m[c][o] = mq[c * lplane + o0[o]];
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int o = 0; o < S; ++o)
            v[c][o] = v[c][o] + m[c][o] * v[c][o] * (1.0f - v[c][o]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int o = 0; o < S; ++o)
          if (o < nr) col[c * LN + o * LS] = clip01(v[c][o]);
    } else {
      // the strip's low-res rows: map_tap's rows of its rows, at d0 and d1
      // from the first row's r0 (they rise with the row, so they span at
      // most K rows); the column taps and weights of its column
      constexpr int K = (S - 1 + DS) / DS + 2;
      const MapTap tc = map_tap<DS>(0, bc, hl, wl, a.up);
      const int kb = map_tap<DS>(clampi(r0 + i0, 0, H - 1), bc, hl, wl,
                                 a.up).r0;
      // d: d0 | d1 << 8; the row weight f (map_tap's 1 - f is formed
      // where it is used, the same float)
      int d[S];
      float fr[S];
#pragma unroll
      for (int o = 0; o < S; ++o) {
        const MapTap t =
            map_tap<DS>(clampi(r0 + i0 + o, 0, H - 1), bc, hl, wl, a.up);
        d[o] = (t.r0 - kb) | (t.r1 - kb) << 8;
        fr[o] = t.fr;
      }
      int rw[K];
#pragma unroll
      for (int k = 0; k < K; ++k) rw[k] = min(kb + k, hl - 1) * wl;
      const int lp = hl * wl;  // a map plane's floats
      // the column blend of row d, selected in registers
      auto pick = [](const float (&cb)[K], int d) {
        float v = cb[0];
#pragma unroll
        for (int k = 1; k < K; ++k) v = d == k ? cb[k] : v;
        return v;
      };
      // the channels side by side (CG of them), but one at a time at 1/2 in
      // the kernels built for 3 blocks an SM (80 registers)
      constexpr int CG = DS == 2 && Gm::BLOCKS(JOINT) >= 3 ? 1 : 3;
#pragma unroll 1
      for (int cg = 0; cg < 3; cg += CG) {
        float v[CG][S];
#pragma unroll
        for (int c = 0; c < CG; ++c)
#pragma unroll
          for (int o = 0; o < S; ++o)
            v[c][o] = o < nr ? col[(cg + c) * LN + o * LS] : 0.0f;
        for (int it = 0; it < n_iter; ++it) {
          const float* mq = mp + ((size_t)it * 3 + cg) * lplane;
          float cb[CG][K];
#pragma unroll
          for (int c = 0; c < CG; ++c)
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const int q = c * lp + rw[k];
              cb[c][k] = mq[q + tc.c0] * tc.gc + mq[q + tc.c1] * tc.fc;
            }
#pragma unroll
          for (int c = 0; c < CG; ++c)
#pragma unroll
            for (int o = 0; o < S; ++o) {
              const float m = pick(cb[c], d[o] & 255) * (1.0f - fr[o])
                              + pick(cb[c], d[o] >> 8) * fr[o];
              v[c][o] = v[c][o] + m * v[c][o] * (1.0f - v[c][o]);
            }
        }
#pragma unroll
        for (int c = 0; c < CG; ++c)
#pragma unroll
          for (int o = 0; o < S; ++o)
            if (o < nr) col[(cg + c) * LN + o * LS] = clip01(v[c][o]);
      }
    }
    if constexpr (JOINT) {
#pragma unroll
      for (int o = 0; o < S; ++o)
        if (o < nr) {
          const int at = o * LS;
          col[3 * LN + at] = guide_of(col[at], col[LN + at], col[2 * LN + at]);
        }
    }
  });
}

// ring position (i, j) <-> block (r0 + i, c0 + j). With the gain plane:
// y = clip(x * gain); with `boost` (hybrid's, or K1's canvas form's): x
// boosted by the blurred illumination, under hybrid's the boosted columns
// outside [m, m + img_w) replaced by their nearest image column; then
// n_iter curve steps (none for K1's gain form and canvas form)
template <class T, int R, bool JOINT>
__device__ __forceinline__ void stage_curve(const FusedGuidedArgs& a,
                                            float* __restrict__ sm, int r0,
                                            int c0, int tid) {
  using Gm = GuidedGeom<R>;
  constexpr int LH = Gm::LH, LW = Gm::LW, LS = Gm::LS, LN = Gm::LN;
  const BoostParams& bp = a.bp;
  const int H = a.H, W = a.W, b = blockIdx.z;
  const size_t plane = (size_t)H * W;
  const T* blk = (const T*)a.in + (size_t)b * 3 * plane;
  const bool curves = a.n_iter > 0;
  // the guide is written with y where no curve step follows
  const bool guide_now = JOINT && !curves;
  if (!a.boost) {
    // the ring's rows in groups of 4 columns from the multiple of 4 at or
    // below c0 (x0 is a multiple of 32: c0 mod 4 is 2 at an odd R), each
    // plane's group one word (u8) or float4 (f32, and the gain) where it is
    // inside the block and aligned, else each value at its clamped column
    // (the tile engine's load_plane)
    constexpr int OFF = R % 2 ? 2 : 0, NG = (LW + OFF + 3) / 4;
    const float* gq = a.gain ? a.gain + (size_t)b * plane : nullptr;
    const bool in_al = (W & 3) == 0
                       && ((uintptr_t)a.in & (sizeof(T) == 1 ? 3 : 15)) == 0;
    const bool g_al = (W & 3) == 0 && ((uintptr_t)a.gain & 15) == 0;
    for_ring<LH, NG>(tid, [&](int i, int q) {
      const int x = c0 - OFF + 4 * q;
      const size_t row = (size_t)clampi(r0 + i, 0, H - 1) * W;
      const bool inside = x >= 0 && x + 3 < W;
      uint32_t raw[12];
      float gv[4];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        tile::load_plane(blk + c * plane + row, x, W, inside && in_al,
                         raw + 4 * c);
      if (gq) tile::load_plane(gq + row, x, W, inside && g_al, gv);
      float v[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        tile::unpack_plane<T>(raw + 4 * c, inside && in_al, v[c]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * q - OFF + u;
        if (j < 0 || j >= LW) continue;
        float y[3] = {v[0][u], v[1][u], v[2][u]};
        if (gq) {
#pragma unroll
          for (int c = 0; c < 3; ++c) y[c] = clip01(y[c] * gv[u]);
        }
        if (guide_now) {
          put_y<R, true>(sm, i * LS + j, y);
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) sm[c * LN + i * LS + j] = y[c];
        }
      }
    });
    __syncthreads();
  } else {
    const int rb = a.lp ? 0 : bp.radius;
    const int EW = LW + 2 * rb, EH = LH + 2 * rb;
    float* sV = sm + Gm::scratch(JOINT);  // LH x EW: the vertical blur
    float* sL0 = sV + LH * EW;            // EH x EW: max RGB
    auto load = [&](int i, int j, Px& px) {
          const size_t at = (size_t)clampi(r0 - rb + i, 0, H - 1) * W
                            + clampi(c0 - rb + j, 0, W - 1);
#pragma unroll
          for (int c = 0; c < 3; ++c) px.v[c] = load_px(blk + c * plane + at);
          if (rb == 0) px.v[3] = a.lp[(size_t)b * plane + at];
    };
    auto use = [&](int i, int j, const Px& px) {
          float x[3] = {px.v[0], px.v[1], px.v[2]};
          if (rb > 0) sL0[i * EW + j] = fmaxf(fmaxf(x[0], x[1]), x[2]);
          const int yi = i - rb, yj = j - rb;
          if (yi < 0 || yi >= LH || yj < 0 || yj >= LW) return;
          if (rb == 0) {
            const float g = boost_gain(px.v[3], bp, true);
#pragma unroll
            for (int c = 0; c < 3; ++c) x[c] = clip01(x[c] * g);
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) sm[c * LN + yi * LS + yj] = x[c];
    };
    if (rb > 0)
      for_planar_groups(blk, plane, H, W, r0 - rb, c0 - rb, EH, EW, tid,
                        use);
    else for_ring<LH, LW>(tid, [&](int i, int j) {
    Px px;
    load(i, j, px);
    use(i, j, px);
  });
    __syncthreads();
    if (rb > 0)
      blur_ring_at<R>(sL0, sV, bp, tid, [](int, int, Px&) {},
                      [&](int i, int j, float l, const Px&) {
                        const float g = boost_gain(l, bp, true);
                        const int at = i * LS + j;
#pragma unroll
                        for (int c = 0; c < 3; ++c)
                          sm[c * LN + at] = clip01(sm[c * LN + at] * g);
                      });
    // the boosted columns outside [m, m + img_w): their nearest image
    // column's values (a column that is its own nearest is never written;
    // a nearest column inside the image is never a target)
    if (a.boost == BOOST_HYBRID
        && (c0 < a.m || c0 + LW - 1 > a.m + a.img_w - 1)) {
      for_ring<LH, LW>(tid, [&](int i, int j) {
        const int jr = clampi(clampi(c0 + j, a.m, a.m + a.img_w - 1) - c0, 0,
                              LW - 1);
        if (jr == j) return;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          sm[c * LN + i * LS + j] = sm[c * LN + i * LS + jr];
      });
      __syncthreads();
    }
  }
  if (!curves) {
    if (JOINT && a.boost) {  // hybrid without curve steps: the guide now
      for_ring<LH, LW>(tid, [&](int i, int j) {
        const int at = i * LS + j;
        sm[3 * LN + at] = guide_of(sm[at], sm[LN + at], sm[2 * LN + at]);
      });
      __syncthreads();
    }
    return;
  }
  if (a.ds == 1) curve_strips<1, R, JOINT>(a, sm, r0, c0, tid);
  else if (a.ds == 2) curve_strips<2, R, JOINT>(a, sm, r0, c0, tid);
  else curve_strips<4, R, JOINT>(a, sm, r0, c0, tid);
  __syncthreads();
}

// --------------------------------------------------------------- store -- //
template <class T, int FAM, int R>
__device__ __forceinline__ void store_tile(const FusedGuidedArgs& a,
                                           const float* __restrict__ sm,
                                           int y0, int x0, int tid) {
  T* out = (T*)a.out;
  const int b = blockIdx.z, H = a.H, W = a.W;
  for_ring<GT_H, GT_W>(tid, [&](int i, int j) {
    const int c = x0 + j;
    if (c >= W) return;
    if constexpr (FAM == FG_RETINEX) {
      const int gy = y0 + i;
      if (gy >= H) return;
      T* q = out + (((size_t)b * H + gy) * W + c) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) store_px(q + ch, at_out<R>(sm, ch, i, j));
    } else {
      const int r = FAM == FG_EMA ? a.m + y0 + i - a.halo : y0 + i;
      if (r < 0 || r >= a.rows) return;
      T* q = out + (size_t)b * 3 * a.rows * W + (size_t)r * W + c;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        store_px(q + (size_t)ch * a.rows * W, at_out<R>(sm, ch, i, j));
    }
  });
}

template <class T, int FAM, int R, bool JOINT>
__device__ __forceinline__ void stage(const FusedGuidedArgs& a,
                                      float* __restrict__ sm, int r0, int c0,
                                      int tid) {
  if constexpr (FAM == FG_RETINEX)
    stage_retinex<T, R, JOINT>(a, sm, r0, c0, tid);
  else if constexpr (FAM == FG_EMA)
    stage_ema<T, R, JOINT>(a, sm, r0, c0, tid);
  else
    stage_curve<T, R, JOINT>(a, sm, r0, c0, tid);
}

template <int FAM, int R, bool JOINT>
__global__ void __launch_bounds__(GUIDED_THREADS,
                                  (GuidedGeom<R>::BLOCKS(JOINT)))
fused_guided_kernel(const __grid_constant__ FusedGuidedArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * GT_H, x0 = blockIdx.x * GT_W;
  // ring position (i, j) <-> pixel (r0 + i, c0 + j)
  const int r0 = (FAM == FG_RETINEX ? 0 : FAM == FG_EMA ? a.m : a.halo) + y0
                 - 2 * R;
  const int c0 = x0 - 2 * R;
  if (a.f32) stage<float, FAM, R, JOINT>(a, smem, r0, c0, tid);
  else stage<uint8_t, FAM, R, JOINT>(a, smem, r0, c0, tid);
  if (a.parts & PART_TAIL) guided_tile<R, JOINT>(smem, a.gp, tid);
  if (!(a.parts & PART_STORE)) return;
  if (a.f32) store_tile<float, FAM, R>(a, smem, y0, x0, tid);
  else store_tile<uint8_t, FAM, R>(a, smem, y0, x0, tid);
}

template <int FAM, int R, bool JOINT>
int launch_guided_form(const FusedGuidedArgs& a, cudaStream_t stream) {
  const int bytes = (int)sizeof(float)
                    * launch_floats<R>(FAM, JOINT, tile_blur(a));
  const void* kern = (const void*)fused_guided_kernel<FAM, R, JOINT>;
  // the opt-in holds for the device current when it is set: before every
  // launch (the caller has made the tensors' device current)
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int out_rows = FAM == FG_RETINEX ? a.H
                       : FAM == FG_EMA   ? a.H - 2 * a.m
                                         : a.rows;
  const dim3 grid((a.W + GT_W - 1) / GT_W, (out_rows + GT_H - 1) / GT_H, a.B);
  fused_guided_kernel<FAM, R, JOINT><<<grid, GUIDED_THREADS, bytes, stream>>>(
      a);
  return (int)cudaGetLastError();
}

// The radius and guide of a launch dispatched to one family's kernels; and
// the kernel itself, for the plan (NULL past the radii).
#define LLIE_GUIDED_FAMILY(FAM, NAME)                                         \
  int launch_guided_##NAME(const FusedGuidedArgs& a, cudaStream_t st) {      \
    switch (a.gp.radius) {                                                    \
      case 1: return a.gp.joint ? launch_guided_form<FAM, 1, true>(a, st)     \
                                : launch_guided_form<FAM, 1, false>(a, st);   \
      case 2: return a.gp.joint ? launch_guided_form<FAM, 2, true>(a, st)     \
                                : launch_guided_form<FAM, 2, false>(a, st);   \
      case 3: return a.gp.joint ? launch_guided_form<FAM, 3, true>(a, st)     \
                                : launch_guided_form<FAM, 3, false>(a, st);   \
      case 4: return a.gp.joint ? launch_guided_form<FAM, 4, true>(a, st)     \
                                : launch_guided_form<FAM, 4, false>(a, st);   \
      case 5: return a.gp.joint ? launch_guided_form<FAM, 5, true>(a, st)     \
                                : launch_guided_form<FAM, 5, false>(a, st);   \
      case 6: return a.gp.joint ? launch_guided_form<FAM, 6, true>(a, st)     \
                                : launch_guided_form<FAM, 6, false>(a, st);   \
      case 7: return a.gp.joint ? launch_guided_form<FAM, 7, true>(a, st)     \
                                : launch_guided_form<FAM, 7, false>(a, st);   \
      case 8: return a.gp.joint ? launch_guided_form<FAM, 8, true>(a, st)     \
                                : launch_guided_form<FAM, 8, false>(a, st);   \
      default: return (int)cudaErrorInvalidValue;                             \
    }                                                                         \
  }                                                                           \
  const void* guided_kernel_##NAME(int radius, bool joint) {                 \
    switch (radius) {                                                         \
      case 1: return joint ? (const void*)fused_guided_kernel<FAM, 1, true>   \
                           : (const void*)fused_guided_kernel<FAM, 1, false>; \
      case 2: return joint ? (const void*)fused_guided_kernel<FAM, 2, true>   \
                           : (const void*)fused_guided_kernel<FAM, 2, false>; \
      case 3: return joint ? (const void*)fused_guided_kernel<FAM, 3, true>   \
                           : (const void*)fused_guided_kernel<FAM, 3, false>; \
      case 4: return joint ? (const void*)fused_guided_kernel<FAM, 4, true>   \
                           : (const void*)fused_guided_kernel<FAM, 4, false>; \
      case 5: return joint ? (const void*)fused_guided_kernel<FAM, 5, true>   \
                           : (const void*)fused_guided_kernel<FAM, 5, false>; \
      case 6: return joint ? (const void*)fused_guided_kernel<FAM, 6, true>   \
                           : (const void*)fused_guided_kernel<FAM, 6, false>; \
      case 7: return joint ? (const void*)fused_guided_kernel<FAM, 7, true>   \
                           : (const void*)fused_guided_kernel<FAM, 7, false>; \
      case 8: return joint ? (const void*)fused_guided_kernel<FAM, 8, true>   \
                           : (const void*)fused_guided_kernel<FAM, 8, false>; \
      default: return nullptr;                                                \
    }                                                                         \
  }

int launch_guided_retinex(const FusedGuidedArgs& a, cudaStream_t st);
int launch_guided_curve(const FusedGuidedArgs& a, cudaStream_t st);
int launch_guided_ema(const FusedGuidedArgs& a, cudaStream_t st);
const void* guided_kernel_retinex(int radius, bool joint);
const void* guided_kernel_curve(int radius, bool joint);
const void* guided_kernel_ema(int radius, bool joint);

}  // namespace llie
