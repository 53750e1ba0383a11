// The guided tails of K1 (retinex, and its gain form), K3 (curve / hybrid)
// and K4 (the retinex video step) for Hopper (sm_90a), bound to PyTorch
// through ctypes (kernels/fused_enhance.py).
//
// What they replace. The denoise_taps="guided" arms of the TPU kernels
// _retinex_kernel (stateless, ext_gain and ema_alpha) and _curve_kernel
// (low_light_image_enhancement_tpu/kernels/fused_enhance.py): the same
// boost, gain, EMA and curves as the bilateral forms (fused_enhance.cu),
// then plane_cores' guided cores (the self-guided filter per channel, or
// one channel-mean guide for all three), blended by strength, clipped and
// stored as u8 or f32.
//
// What bounds them. The guided cascade does 14 box means of 4r + 2 adds and
// a multiply per pixel, and the a / b algebra: about 236 operations a pixel
// at r = 2 and 348 at r = 4 with the luma guide, on 3 bytes in and 3 out
// (u8), so the f32 rate bounds them, as it bounds K1.
//
// What the design does about it. One tile and guide shape for all three,
// guided.cuh's (K5's redesigned arm): 32 x 32 outputs, 256 threads. Each
// kernel stages its boosted, gained or curved tile with the guided
// cascade's 2r ring into the planes guided_tile reads, computing the
// intermediates there (max RGB with the blur's ring, the vertical blur,
// the gain, the EMA, the curves), then runs guided_tile<R, JOINT>, which
// leaves the blended tile in shared memory, and stores it. The TPU
// kernels' wrap shifts on a stripe canvas become clamped reads of the
// image (K1) or of the replicate-padded block (K3, K4), as in the
// bilateral forms; the canvas margin covers the tail's reach 2r plus the
// blur's, so no kept pixel reads a clamped position. The radius and the
// guide are template parameters (8 x 2 kernels); the family (K1, K1's gain
// form, K3, K4), the I/O type, K1's stages and K3's map factor are
// uniform run-time branches in the staging, which runs once a tile.
//
// Numerics. As fused_enhance.cu: --fmad=false, the plain versions' tap
// order, rintf; guided_tile is bit-equal to ops/guided.py's shift cores.
#include "fused_enhance.cuh"
#include "guided.cuh"

namespace llie {

enum GuidedFamily { FG_RETINEX = 0, FG_GAIN = 1, FG_CURVE = 2, FG_EMA = 3 };

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
  BoostParams bp;
  UpParams up;
  EmaParams ep;
  GuidedParams gp;
};

// The floats a family's staging needs past the three input planes:
// [gain: LN][hybrid's x: 3 LN][vertical blur: LH x EW][max RGB: EH x EW].
template <int R>
constexpr int staging_floats(int family, int boost, int rb) {
  using Gm = GuidedGeom<R>;
  const int EW = Gm::LW + 2 * rb, EH = Gm::LH + 2 * rb;
  const int blur = rb > 0 ? Gm::LH * EW + EH * EW : 0;
  if (family == FG_GAIN || (family == FG_CURVE && !boost)) return 0;
  return (family == FG_CURVE ? 4 : 1) * Gm::LN + blur;
}

// The curves at 1/DS of one staged position (block (br, bc)), y in
// place.
template <int DS>
__device__ __forceinline__ void curves(float (&y)[3], const float* mp,
                                       int n_iter, int br, int bc, int HB,
                                       int WB, const UpParams& up) {
  const int hl = HB / DS, wl = WB / DS;
  const size_t lplane = (size_t)hl * wl;
  if constexpr (DS == 1) {
    const size_t at = (size_t)br * WB + bc;
    for (int c = 0; c < 3; ++c) {
      float v = y[c];
      for (int it = 0; it < n_iter; ++it) {
        const float a = mp[((size_t)it * 3 + c) * lplane + at];
        v = v + a * v * (1.0f - v);
      }
      y[c] = clip01(v);
    }
  } else {
    const MapTap t = map_tap<DS>(br, bc, hl, wl, up);
    for (int c = 0; c < 3; ++c) {
      float v = y[c];
      for (int it = 0; it < n_iter; ++it) {
        const float a = t.at(mp + ((size_t)it * 3 + c) * lplane, wl);
        v = v + a * v * (1.0f - v);
      }
      y[c] = clip01(v);
    }
  }
}

// Stages the tile's y planes at sm[c * LN + i * LS + j], ring position (i,
// j) <-> pixel (r0 + i, c0 + j) of the image or block; every thread calls
// it, and it ends with a __syncthreads.
template <class T, int R>
__device__ void stage_tile(const FusedGuidedArgs& a, float* __restrict__ sm,
                           int r0, int c0, int tid) {
  using Gm = GuidedGeom<R>;
  constexpr int LH = Gm::LH, LW = Gm::LW, LS = Gm::LS, LN = Gm::LN;
  constexpr int NT = GUIDED_THREADS;
  const BoostParams& bp = a.bp;
  const int H = a.H, W = a.W, b = blockIdx.z;
  const size_t plane = (size_t)H * W;
  float* sG = sm + 3 * LN;   // LH x LW at LS: the gain
  float* sX = sG + LN;       // 3 planes: hybrid's x

  if (a.family == FG_GAIN) {
    const T* blk = (const T*)a.in + (size_t)b * 3 * plane;
    const float* gq = a.gain + (size_t)b * plane;
    for (int e = tid; e < LH * LW; e += NT) {
      const int i = e / LW, j = e % LW;
      const size_t at = (size_t)clampi(r0 + i, 0, H - 1) * W
                        + clampi(c0 + j, 0, W - 1);
      const float g = gq[at];
      for (int c = 0; c < 3; ++c)
        sm[c * LN + i * LS + j] = clip01(load_px(blk + c * plane + at) * g);
    }
    __syncthreads();
    return;
  }

  if (a.family == FG_CURVE && !a.boost) {
    const T* blk = (const T*)a.in + (size_t)b * 3 * plane;
    const float* gq = a.gain ? a.gain + (size_t)b * plane : nullptr;
    const float* mp = a.maps ? a.maps + (size_t)b * a.n_iter * 3 * plane
                                       / (a.ds * a.ds)
                             : nullptr;
    for (int e = tid; e < LH * LW; e += NT) {
      const int i = e / LW, j = e % LW;
      const int br = clampi(r0 + i, 0, H - 1), bc = clampi(c0 + j, 0, W - 1);
      const size_t at = (size_t)br * W + bc;
      float y[3];
      for (int c = 0; c < 3; ++c) y[c] = load_px(blk + c * plane + at);
      if (gq) {
        const float g = gq[at];
        for (int c = 0; c < 3; ++c) y[c] = clip01(y[c] * g);
      }
      if (a.ds == 1) curves<1>(y, mp, a.n_iter, br, bc, H, W, a.up);
      else if (a.ds == 2) curves<2>(y, mp, a.n_iter, br, bc, H, W, a.up);
      else curves<4>(y, mp, a.n_iter, br, bc, H, W, a.up);
      for (int c = 0; c < 3; ++c) sm[c * LN + i * LS + j] = y[c];
    }
    __syncthreads();
    return;
  }

  // K1, K4 and hybrid K3: an illumination on the ring, from max RGB
  // blurred on the tile (rb its blur radius), read from lp, or (K1 without
  // STAGE_BLUR) max RGB itself
  const bool retinex = a.family == FG_RETINEX;
  const bool blur = !retinex || (a.stages & STAGE_BLUR);
  const bool boostg = !retinex || (a.stages & STAGE_BOOST);
  const bool gained = blur || boostg;
  const int rb = blur && !a.lp ? bp.radius : 0;
  const int EW = LW + 2 * rb, EH = LH + 2 * rb;
  float* sV = a.family == FG_CURVE ? sX + 3 * LN : sX;  // LH x EW
  float* sL0 = sV + LH * EW; // EH x EW
  // the x planes: K3 keeps x apart (its boost is read at other columns)
  float* xp = a.family == FG_CURVE ? sX : sm;
  const T* src = (const T*)a.in;
  for (int e = tid; e < EH * EW; e += NT) {
    const int i = e / EW, j = e % EW;
    const int gy = clampi(r0 - rb + i, 0, H - 1);
    const int gx = clampi(c0 - rb + j, 0, W - 1);
    float x[3];
    if (retinex) {
      const T* px = src + (((size_t)b * H + gy) * W + gx) * 3;
      for (int c = 0; c < 3; ++c) x[c] = load_px(px + c);
    } else {
      const T* px = src + (size_t)b * 3 * plane + (size_t)gy * W + gx;
      for (int c = 0; c < 3; ++c) x[c] = load_px(px + c * plane);
    }
    const float l0 = fmaxf(fmaxf(x[0], x[1]), x[2]);
    if (rb > 0) sL0[e] = l0;
    const int yi = i - rb, yj = j - rb;
    if (yi >= 0 && yi < LH && yj >= 0 && yj < LW) {
      const int at = yi * LS + yj;
      for (int c = 0; c < 3; ++c) xp[c * LN + at] = x[c];
      if (rb == 0 && gained) {
        float l = l0;
        if (blur) {  // from the plane
          if (retinex) {
            const int pe = a.lpe, hw = W + 2 * pe;
            l = a.lp[((size_t)b * (H + 2 * pe)
                      + clampi(r0 + yi + pe, 0, H + 2 * pe - 1)) * hw
                     + clampi(c0 + yj + pe, 0, hw - 1)];
          } else {
            l = a.lp[(size_t)b * plane + (size_t)gy * W + gx];
          }
        }
        sG[at] = l;
      }
    }
  }
  __syncthreads();
  // the gain on the ring (K4: the EMA, and the new carry of its own pixels)
  const EmaParams& ep = a.ep;
  const int band_end = H - a.m;
  auto gain_at = [&](int i, int j, float l) {
    const int at = i * LS + j;
    if (a.family != FG_EMA) {
      sG[at] = boost_gain(l, bp, boostg);
      return;
    }
    const int row = r0 + i, col = c0 + j;
    const float c = a.carry[(size_t)b * plane
                            + (size_t)clampi(row, 0, H - 1) * W
                            + clampi(col, 0, W - 1)];
    const float l_mix = c < 0.0f ? l : ep.alpha * l + ep.beta * c;
    sG[at] = expf(ep.gamma * logf(fminf(fmaxf(l_mix, bp.eps), 1.0f))
                  - logf(fminf(fmaxf(l, bp.eps), 1.0f)));
    if (i >= 2 * R && i < 2 * R + GT_H && j >= 2 * R && j < 2 * R + GT_W
        && row < band_end && col < W) {
      float* np = a.ncarry + (size_t)b * plane;
      np[(size_t)row * W + col] = l_mix;
      if (row == a.m)
        for (int k = 0; k < a.m; ++k) np[(size_t)k * W + col] = l_mix;
      if (row == band_end - 1)
        for (int k = band_end; k < H; ++k) np[(size_t)k * W + col] = l_mix;
    }
  };
  if (rb > 0) {
    blur_region(sL0, sV, bp, LH, LW, tid, NT, gain_at);
  } else if (gained) {
    for (int e = tid; e < LH * LW; e += NT) {
      const int i = e / LW, j = e % LW;
      gain_at(i, j, sG[i * LS + j]);
    }
    __syncthreads();
  }
  if (!gained) return;  // K1 with neither blur nor boost: y = x
  const float* mp = a.family == FG_CURVE
      ? a.maps + (size_t)b * a.n_iter * 3 * plane / (a.ds * a.ds)
      : nullptr;
  for (int e = tid; e < LH * LW; e += NT) {
    const int i = e / LW, j = e % LW;
    const int at = i * LS + j;
    if (a.family == FG_RETINEX) {
      const float g = sG[at];
      for (int c = 0; c < 3; ++c) sm[c * LN + at] = clip01(sm[c * LN + at] * g);
      continue;
    }
    // the gain (K4) or the boosted value (K3) of the nearest image column
    const int jr = clampi(clampi(c0 + j, a.m, a.m + a.img_w - 1) - c0, 0,
                          LW - 1);
    const int re = i * LS + jr;
    if (a.family == FG_EMA) {
      const float g = sG[re];
      for (int c = 0; c < 3; ++c) sm[c * LN + at] = clip01(sm[c * LN + at] * g);
      continue;
    }
    float y[3];
    for (int c = 0; c < 3; ++c) y[c] = clip01(sX[c * LN + re] * sG[re]);
    const int br = clampi(r0 + i, 0, H - 1), bc = clampi(c0 + j, 0, W - 1);
    if (a.ds == 1) curves<1>(y, mp, a.n_iter, br, bc, H, W, a.up);
    else if (a.ds == 2) curves<2>(y, mp, a.n_iter, br, bc, H, W, a.up);
    else curves<4>(y, mp, a.n_iter, br, bc, H, W, a.up);
    for (int c = 0; c < 3; ++c) sm[c * LN + at] = y[c];
  }
  __syncthreads();
}

template <class T, int R>
__device__ void store_tile(const FusedGuidedArgs& a, const float* o, int y0,
                           int x0, int tid) {
  using Gm = GuidedGeom<R>;
  T* out = (T*)a.out;
  const int b = blockIdx.z;
  for (int e = tid; e < GT_H * GT_W; e += GUIDED_THREADS) {
    const int i = e / GT_W, j = e % GT_W;
    const int c = x0 + j;
    const float* v = o + i * (GT_W + 1) + j;
    if (a.family == FG_RETINEX) {
      const int gy = y0 + i;
      if (gy < a.H && c < a.W) {
        T* q = out + (((size_t)b * a.H + gy) * a.W + c) * 3;
        for (int ch = 0; ch < 3; ++ch) store_px(q + ch, v[ch * Gm::ON]);
      }
      continue;
    }
    const int r = a.family == FG_EMA ? a.m + y0 + i - a.halo : y0 + i;
    if (r >= 0 && r < a.rows && c < a.W) {
      T* q = out + (size_t)b * 3 * a.rows * a.W + (size_t)r * a.W + c;
      for (int ch = 0; ch < 3; ++ch)
        store_px(q + (size_t)ch * a.rows * a.W, v[ch * Gm::ON]);
    }
  }
}

template <int R, bool JOINT>
__global__ void __launch_bounds__(GUIDED_THREADS)
fused_guided_kernel(const __grid_constant__ FusedGuidedArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * GT_H, x0 = blockIdx.x * GT_W;
  // ring position (i, j) <-> pixel (r0 + i, c0 + j)
  const int r0 = (a.family == FG_RETINEX ? 0
                  : a.family == FG_EMA ? a.m : a.halo) + y0 - 2 * R;
  const int c0 = x0 - 2 * R;
  if (a.f32) stage_tile<float, R>(a, smem, r0, c0, tid);
  else stage_tile<uint8_t, R>(a, smem, r0, c0, tid);
  guided_tile<R, JOINT>(smem, a.gp, tid);
  const float* o = out_planes<R>(smem);
  if (a.f32) store_tile<float, R>(a, o, y0, x0, tid);
  else store_tile<uint8_t, R>(a, o, y0, x0, tid);
}

template <int R, bool JOINT>
int launch_fused_guided(const FusedGuidedArgs& a, cudaStream_t stream) {
  const int rb = a.lp ? 0 : a.bp.radius;
  const int floats = 3 * GuidedGeom<R>::LN
                     + staging_floats<R>(a.family, a.boost, rb);
  const int smem = (int)sizeof(float)
                   * (floats > GuidedGeom<R>::FLOATS ? floats
                                                     : GuidedGeom<R>::FLOATS);
  const void* kern = (const void*)fused_guided_kernel<R, JOINT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int out_rows = a.family == FG_RETINEX ? a.H
                       : a.family == FG_EMA ? a.H - 2 * a.m : a.rows;
  const dim3 grid((a.W + GT_W - 1) / GT_W, (out_rows + GT_H - 1) / GT_H,
                  a.B);
  fused_guided_kernel<R, JOINT><<<grid, GUIDED_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int R>
int launch_fused_guided_r(const FusedGuidedArgs& a, cudaStream_t stream) {
  return a.gp.joint ? launch_fused_guided<R, true>(a, stream)
                    : launch_fused_guided<R, false>(a, stream);
}

}  // namespace llie

using namespace llie;

extern "C" {

// The guided tail of K1, K1's gain form, K3 or K4 (a->family), as
// FusedGuidedArgs describes it. Returns cudaGetLastError() after the
// launch (0 when it was accepted).
int llie_fused_guided(const FusedGuidedArgs* a, void* stream) {
  if (a->B < 1 || a->H < 1 || a->W < 1 || a->family < FG_RETINEX ||
      a->family > FG_EMA)
    return (int)cudaErrorInvalidValue;
  if (a->family != FG_RETINEX && (a->rows < 1 || a->halo < a->m))
    return (int)cudaErrorInvalidValue;
  if (a->family == FG_EMA && (a->m < 1 || a->H <= 2 * a->m))
    return (int)cudaErrorInvalidValue;
  if (a->family == FG_CURVE &&
      ((a->ds != 1 && a->ds != 2 && a->ds != 4) || a->H % a->ds ||
       a->W % a->ds))
    return (int)cudaErrorInvalidValue;
  if (a->bp.radius > MAX_BLUR_RADIUS) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (a->gp.radius) {
#define LLIE_GUIDED_CASE(R) \
  case R:                   \
    return launch_fused_guided_r<R>(*a, st);
    LLIE_GUIDED_CASE(1)
    LLIE_GUIDED_CASE(2)
    LLIE_GUIDED_CASE(3)
    LLIE_GUIDED_CASE(4)
    LLIE_GUIDED_CASE(5)
    LLIE_GUIDED_CASE(6)
    LLIE_GUIDED_CASE(7)
    LLIE_GUIDED_CASE(8)
#undef LLIE_GUIDED_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// sizeof(FusedGuidedArgs), for the binding's check of its mirror.
int llie_fused_guided_args_size() { return (int)sizeof(FusedGuidedArgs); }

}  // extern "C"
