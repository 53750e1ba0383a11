// Fused enhance kernels for Hopper (sm_90a): K1 (retinex), K3 (curve /
// hybrid tail) and K4 (the retinex video step), bound to PyTorch through
// ctypes (kernels/fused_enhance.py).
//
// What they replace. K1 replaces the TPU kernel fused_retinex ->
// _retinex_kernel (low_light_image_enhancement_tpu/kernels/fused_enhance.py,
// the non-EMA branch), and its ext_gain arm; K3 replaces fused_curve_enhance
// -> _curve_kernel in the same file, with maps at 1/1, 1/2 and 1/4 and the
// ext_gain arm; K4 replaces fused_retinex_ema -> _retinex_kernel(ema_alpha).
// K1's gain form is K3's kernel with the gain and no curve iteration: the
// TPU kernel's two ext_gain arms compute the same thing.
//
// What bounds them. All are stencils of a few hundred float operations per
// pixel on data that is read once. K1 moves 3 bytes in and 3 bytes out per
// pixel, too few for device memory to be its limit: the exp/log of the
// boost and the range weights' exps (6 of them in the default separable
// joint bilateral, 27 in the full per-channel one) bound it. K3 reads 3
// bytes plus n_iter * 3 float maps (96 bytes at n_iter 8) and writes 3 bytes
// per pixel, so device memory bounds it; with maps at 1/4 it reads 6 map
// bytes a pixel and the exp/log-free curve arithmetic (plus the upsample's
// 4 taps and 6 operations per map value) bounds it. K4 moves 7 bytes in
// (u8 RGB, the f32 carry) and 7 out (u8 RGB, the new carry) per pixel and
// adds one exp and two logs to K1's work: with the carry, device memory
// bounds it, by a small margin over its operations.
//
// What the design does about it. One thread per output pixel on a 16 x 32
// tile. The tile's input and its halo are staged once in shared memory (a
// halo of 1 + R for K1, 1 for the curve tail and 1 + R for hybrid, R the
// blur radius), and every intermediate (max RGB, the vertical blur, the
// gain, the boosted and curved planes, the first pass of the separable
// bilateral) stays there, so device memory sees each input byte once per
// tile plus the halo's overlap. K1 reads u8 HWC and writes u8 HWC directly:
// the transpose, pad, crop and transpose around the TPU kernel fold into
// its clamped reads. K3 reads each map value where the curve step needs it;
// at 1/ds it reads the four low-res taps of the upsample through the cache
// instead of a full-resolution map. K4 tiles the carry's band [m, HB - m)
// rather than the output rows, computes l_mix on the ring tile from the
// carry read there, writes it for its own pixels (and the band's edge rows
// over the m rows beyond them), and its output rows. Speed (tensor-memory
// loads, more pixels per thread) is later work; this version is held to its
// plain PyTorch version.
//
// Numerics. --fmad=false and no --use_fast_math (see _build.py), rintf for
// round-half-even, u8 -> f32 as (float)(int)v * (1/255). The intermediates
// at positions outside the image are computed from clamped input reads,
// never clamped themselves: that is the replicate-padded canvas of the
// reference.
#include "fused_enhance.cuh"

namespace llie {

// K1: (B, H, W, 3) u8 -> (B, H, W, 3) u8.
__global__ void __launch_bounds__(NTHREADS)
retinex_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               int H, int W, BoostParams bp, TailParams tp) {
  extern __shared__ float smem[];
  const int R = bp.radius;
  const int LH = YH + 2 * R, LW = YW + 2 * R;
  float* sL0 = smem;            // LH x LW: max RGB
  float* sV = sL0 + LH * LW;    // YH x LW: vertical blur
  float* sG = sV + YH * LW;     // YH x YW: gain
  float* sY = sG + YN;          // 3 x YH x YW: x, then the boosted y
  float* sP = sY + 3 * YN;      // 3 x TILE_H x YW: separable pass 1

  const int tid = threadIdx.x;
  const int ty = tid / TILE_W, tx = tid - (tid / TILE_W) * TILE_W;
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const uint8_t* img = in + (size_t)blockIdx.z * H * W * 3;

  for (int e = tid; e < LH * LW; e += NTHREADS) {
    const int i = e / LW, j = e - (e / LW) * LW;
    const int gy = clampi(y0 - 1 - R + i, 0, H - 1);
    const int gx = clampi(x0 - 1 - R + j, 0, W - 1);
    const uint8_t* px = img + ((size_t)gy * W + gx) * 3;
    const float r = (float)(int)px[0] * U8_SCALE;
    const float g = (float)(int)px[1] * U8_SCALE;
    const float b = (float)(int)px[2] * U8_SCALE;
    sL0[e] = fmaxf(fmaxf(r, g), b);
    const int yi = i - R, yj = j - R;
    if (yi >= 0 && yi < YH && yj >= 0 && yj < YW) {
      const int ye = yi * YW + yj;
      sY[ye] = r;
      sY[YN + ye] = g;
      sY[2 * YN + ye] = b;
    }
  }
  __syncthreads();
  gain_tile(sL0, sV, sG, bp, tid);
  for (int e = tid; e < YN; e += NTHREADS) {
    const float gain = sG[e];
    for (int c = 0; c < 3; ++c) sY[c * YN + e] = clip01(sY[c * YN + e] * gain);
  }
  __syncthreads();

  float o[3];
  denoise_tile(sY, sP, tp, tid, ty, tx, o);
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy < H && gx < W) {
    uint8_t* q = out + (((size_t)blockIdx.z * H + gy) * W + gx) * 3;
    for (int c = 0; c < 3; ++c) q[c] = quantize(o[c]);
  }
}

// The four low-res taps and two weights of one full-resolution map
// position under upsample_int (ops/filters.py): columns first at the two
// low-res rows, then rows, each lo * (1 - f) + hi * f with
// lo = x[clamp((i - DS/2) / DS)], hi = x[clamp((i + DS/2) / DS)] and f the
// phase weight of i mod DS. The clamps at the block's edges are the
// reference's edge-replicating shifts.
struct MapTap {
  int r0, r1, c0, c1;
  float fr, gr, fc, gc;  // f and 1 - f of the rows and the columns

  __device__ __forceinline__ float at(const float* __restrict__ q,
                                      int wl) const {
    const float a0 = q[r0 * wl + c0] * gc + q[r0 * wl + c1] * fc;
    const float a1 = q[r1 * wl + c0] * gc + q[r1 * wl + c1] * fc;
    return a0 * gr + a1 * fr;
  }
};

// The host-rounded weight of phase p, selected in registers (an indexed
// read of the parameter array would copy it to local memory).
template <int DS>
__device__ __forceinline__ float phase_weight(const UpParams& up, int p) {
  float f = up.f[0];
#pragma unroll
  for (int k = 1; k < DS; ++k) f = p == k ? up.f[k] : f;
  return f;
}

template <int DS>
__device__ __forceinline__ MapTap map_tap(int br, int bc, int hl, int wl,
                                          const UpParams& up) {
  // br, bc >= 0 and i - DS/2 > -DS, so truncating division clamps like
  // the floor
  constexpr int h = DS / 2;
  MapTap t;
  t.r0 = clampi((br - h) / DS, 0, hl - 1);
  t.r1 = clampi((br + h) / DS, 0, hl - 1);
  t.c0 = clampi((bc - h) / DS, 0, wl - 1);
  t.c1 = clampi((bc + h) / DS, 0, wl - 1);
  t.fr = phase_weight<DS>(up, br % DS);
  t.fc = phase_weight<DS>(up, bc % DS);
  t.gr = 1.0f - t.fr;
  t.gc = 1.0f - t.fc;
  return t;
}

// K3: block (B, 3, HB, WB) u8 + maps (B, n_iter, 3, HB/DS, WB/DS) f32 ->
// (B, 3, rows, WB) u8, output row r <-> block row halo + r. With `boost`
// (hybrid) the boosted image's columns outside [m, m + img_w) are replaced
// by its columns m and m + img_w - 1 before the curves. With `gain` (and
// no boost) the image is clip(x * gain) before the curves.
template <int DS>
__global__ void __launch_bounds__(NTHREADS)
curve_kernel(const uint8_t* __restrict__ in, const float* __restrict__ maps,
             const float* __restrict__ gain, uint8_t* __restrict__ out,
             int HB, int WB, int halo, int rows, int n_iter, int boost, int m,
             int img_w, UpParams up, BoostParams bp, TailParams tp) {
  extern __shared__ float smem[];
  const int R = boost ? bp.radius : 0;
  const int LH = YH + 2 * R, LW = YW + 2 * R;
  float* sY = smem;             // 3 x YH x YW: curved y
  float* sP = sY + 3 * YN;      // 3 x TILE_H x YW: separable pass 1
  float* sX = sP + 3 * PN;      // 3 x YH x YW: x (hybrid)
  float* sG = sX + 3 * YN;      // YH x YW: gain (hybrid)
  float* sV = sG + YN;          // YH x LW: vertical blur (hybrid)
  float* sL0 = sV + YH * LW;    // LH x LW: max RGB (hybrid)

  const int tid = threadIdx.x;
  const int ty = tid / TILE_W, tx = tid - (tid / TILE_W) * TILE_W;
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t plane = (size_t)HB * WB;
  const int hl = HB / DS, wl = WB / DS;
  const size_t lplane = (size_t)hl * wl;
  const uint8_t* blk = in + (size_t)blockIdx.z * 3 * plane;
  const float* mp = n_iter ? maps + (size_t)blockIdx.z * n_iter * 3 * lplane
                           : nullptr;
  const float* gp = gain ? gain + (size_t)blockIdx.z * plane : nullptr;
  // ring-tile position (i, j) <-> block (halo + y0 - 1 + i, x0 - 1 + j)
  const int r0 = halo + y0 - 1, c0 = x0 - 1;

  if (boost) {
    for (int e = tid; e < LH * LW; e += NTHREADS) {
      const int i = e / LW, j = e - (e / LW) * LW;
      const size_t at = (size_t)clampi(r0 - R + i, 0, HB - 1) * WB
                        + clampi(c0 - R + j, 0, WB - 1);
      const float r = (float)(int)blk[at] * U8_SCALE;
      const float g = (float)(int)blk[plane + at] * U8_SCALE;
      const float b = (float)(int)blk[2 * plane + at] * U8_SCALE;
      sL0[e] = fmaxf(fmaxf(r, g), b);
      const int yi = i - R, yj = j - R;
      if (yi >= 0 && yi < YH && yj >= 0 && yj < YW) {
        const int ye = yi * YW + yj;
        sX[ye] = r;
        sX[YN + ye] = g;
        sX[2 * YN + ye] = b;
      }
    }
    __syncthreads();
    gain_tile(sL0, sV, sG, bp, tid);
  }
  for (int e = tid; e < YN; e += NTHREADS) {
    const int i = e / YW, j = e - (e / YW) * YW;
    const int br = clampi(r0 + i, 0, HB - 1), bc = clampi(c0 + j, 0, WB - 1);
    const size_t at = (size_t)br * WB + bc;
    float y[3];
    if (boost) {
      // the boosted value of the nearest image column (replicate_margin_cols)
      const int jr = clampi(clampi(c0 + j, m, m + img_w - 1) - c0, 0, YW - 1);
      const int re = i * YW + jr;
      for (int c = 0; c < 3; ++c) y[c] = clip01(sX[c * YN + re] * sG[re]);
    } else {
      for (int c = 0; c < 3; ++c)
        y[c] = (float)(int)blk[c * plane + at] * U8_SCALE;
      if (gp) {
        const float g = gp[at];
        for (int c = 0; c < 3; ++c) y[c] = clip01(y[c] * g);
      }
    }
    if constexpr (DS == 1) {
      for (int c = 0; c < 3; ++c) {
        float v = y[c];
        for (int it = 0; it < n_iter; ++it) {
          const float a = mp[((size_t)it * 3 + c) * plane + at];
          v = v + a * v * (1.0f - v);
        }
        sY[c * YN + e] = clip01(v);
      }
    } else {
      const MapTap t = map_tap<DS>(br, bc, hl, wl, up);
      for (int c = 0; c < 3; ++c) {
        float v = y[c];
        for (int it = 0; it < n_iter; ++it) {
          const float a = t.at(mp + ((size_t)it * 3 + c) * lplane, wl);
          v = v + a * v * (1.0f - v);
        }
        sY[c * YN + e] = clip01(v);
      }
    }
  }
  __syncthreads();

  float o[3];
  denoise_tile(sY, sP, tp, tid, ty, tx, o);
  const int r = y0 + ty, c = x0 + tx;
  if (r < rows && c < WB) {
    uint8_t* q = out + (size_t)blockIdx.z * 3 * rows * WB + (size_t)r * WB + c;
    for (int ch = 0; ch < 3; ++ch) q[(size_t)ch * rows * WB] = quantize(o[ch]);
  }
}

// K4: block (B, 3, HB, WB) u8 + carry (B, HB, WB) f32 -> (B, 3, rows, WB)
// u8, output row r <-> block row halo + r, and the new carry (B, HB, WB).
// The tiles cover the band [m, HB - m): ring-tile position (i, j) <-> block
// (m + y0 - 1 + i, x0 - 1 + j). A negative carry marks a pixel with no
// state yet: it takes l_now.
__global__ void __launch_bounds__(NTHREADS)
ema_kernel(const uint8_t* __restrict__ in, const float* __restrict__ carry,
           uint8_t* __restrict__ out, float* __restrict__ ncarry, int HB,
           int WB, int halo, int rows, int m, int img_w, EmaParams ep,
           BoostParams bp, TailParams tp) {
  extern __shared__ float smem[];
  const int R = bp.radius;
  const int LH = YH + 2 * R, LW = YW + 2 * R;
  float* sL0 = smem;            // LH x LW: max RGB
  float* sV = sL0 + LH * LW;    // YH x LW: vertical blur
  float* sG = sV + YH * LW;     // YH x YW: gain
  float* sY = sG + YN;          // 3 x YH x YW: x, then y = clip(x * gain)
  float* sP = sY + 3 * YN;      // 3 x TILE_H x YW: separable pass 1

  const int tid = threadIdx.x;
  const int ty = tid / TILE_W, tx = tid - (tid / TILE_W) * TILE_W;
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t plane = (size_t)HB * WB;
  const uint8_t* blk = in + (size_t)blockIdx.z * 3 * plane;
  const float* cp = carry + (size_t)blockIdx.z * plane;
  float* np = ncarry + (size_t)blockIdx.z * plane;
  const int r0 = m + y0 - 1, c0 = x0 - 1;
  const int band_end = HB - m;

  for (int e = tid; e < LH * LW; e += NTHREADS) {
    const int i = e / LW, j = e - (e / LW) * LW;
    const size_t at = (size_t)clampi(r0 - R + i, 0, HB - 1) * WB
                      + clampi(c0 - R + j, 0, WB - 1);
    const float r = (float)(int)blk[at] * U8_SCALE;
    const float g = (float)(int)blk[plane + at] * U8_SCALE;
    const float b = (float)(int)blk[2 * plane + at] * U8_SCALE;
    sL0[e] = fmaxf(fmaxf(r, g), b);
    const int yi = i - R, yj = j - R;
    if (yi >= 0 && yi < YH && yj >= 0 && yj < YW) {
      const int ye = yi * YW + yj;
      sY[ye] = r;
      sY[YN + ye] = g;
      sY[2 * YN + ye] = b;
    }
  }
  __syncthreads();
  blur_tile(sL0, sV, bp, tid, [&](int e, float l_now) {
    const int i = e / YW, j = e - (e / YW) * YW;
    const int row = r0 + i, col = c0 + j;
    const float c = cp[(size_t)clampi(row, 0, HB - 1) * WB
                       + clampi(col, 0, WB - 1)];
    const float l_mix = c < 0.0f ? l_now : ep.alpha * l_now + ep.beta * c;
    sG[e] = expf(ep.gamma * logf(fminf(fmaxf(l_mix, bp.eps), 1.0f))
                 - logf(fminf(fmaxf(l_now, bp.eps), 1.0f)));
    // the tile's own pixels on the band write the new carry; the band's
    // first and last rows also fill the m rows beyond them
    if (i >= 1 && i <= TILE_H && j >= 1 && j <= TILE_W && row < band_end
        && col < WB) {
      np[(size_t)row * WB + col] = l_mix;
      if (row == m)
        for (int k = 0; k < m; ++k) np[(size_t)k * WB + col] = l_mix;
      if (row == band_end - 1)
        for (int k = band_end; k < HB; ++k) np[(size_t)k * WB + col] = l_mix;
    }
  });
  for (int e = tid; e < YN; e += NTHREADS) {
    const int i = e / YW, j = e - (e / YW) * YW;
    // the gain of the nearest image column (_kreplicate_cols)
    const int jr = clampi(clampi(c0 + j, m, m + img_w - 1) - c0, 0, YW - 1);
    const float gain = sG[i * YW + jr];
    for (int c = 0; c < 3; ++c) sY[c * YN + e] = clip01(sY[c * YN + e] * gain);
  }
  __syncthreads();

  float o[3];
  denoise_tile(sY, sP, tp, tid, ty, tx, o);
  const int r = m + y0 + ty - halo, c = x0 + tx;
  if (r >= 0 && r < rows && c < WB) {
    uint8_t* q = out + (size_t)blockIdx.z * 3 * rows * WB + (size_t)r * WB + c;
    for (int ch = 0; ch < 3; ++ch) q[(size_t)ch * rows * WB] = quantize(o[ch]);
  }
}

static BoostParams boost_params(int radius, const float* taps, float gm1,
                                float eps) {
  BoostParams bp;
  bp.radius = radius;
  for (int k = 0; k < 2 * MAX_BLUR_RADIUS + 1; ++k)
    bp.taps[k] = k <= 2 * radius ? taps[k] : 0.0f;
  bp.gm1 = gm1;
  bp.eps = eps;
  return bp;
}

static TailParams tail_params(float strength, float inv2s2, float inv2s2_3,
                              int kind, int joint, int sep) {
  TailParams tp;
  tp.strength = strength;
  tp.inv2s2 = inv2s2;
  tp.inv2s2_3 = inv2s2_3;
  tp.kind = kind;
  tp.joint = joint;
  tp.sep = sep;
  return tp;
}

}  // namespace llie

using namespace llie;

extern "C" {

const char* llie_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int llie_max_blur_radius() { return MAX_BLUR_RADIUS; }

// `taps` is a host array of 2 * radius + 1 floats. Returns
// cudaGetLastError() after the launch (0 when it was accepted).
int llie_fused_retinex_u8(const void* in, void* out, int B, int H, int W,
                          int radius, const float* taps, float gm1, float eps,
                          float strength, float inv2s2, float inv2s2_3,
                          int kind, int joint, int sep, void* stream) {
  if (radius < 1 || radius > MAX_BLUR_RADIUS) return (int)cudaErrorInvalidValue;
  const BoostParams bp = boost_params(radius, taps, gm1, eps);
  const TailParams tp = tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  const int LH = YH + 2 * radius, LW = YW + 2 * radius;
  const size_t smem = sizeof(float) * (LH * LW + YH * LW + YN + 3 * YN + 3 * PN);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  retinex_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, H, W, bp, tp);
  return (int)cudaGetLastError();
}

// `phases` is a host array of 8 floats: upsample_int's phase weights for
// ds (ops.filters._phase_consts). `gain` may be NULL.
int llie_fused_curve_u8(const void* in, const void* maps, const void* gain,
                        void* out, int B, int HB, int WB, int halo, int rows,
                        int n_iter, int boost, int m, int img_w, int ds,
                        const float* phases, int radius, const float* taps,
                        float gm1, float eps, float strength, float inv2s2,
                        float inv2s2_3, int kind, int joint, int sep,
                        void* stream) {
  if (radius < 1 || radius > MAX_BLUR_RADIUS) return (int)cudaErrorInvalidValue;
  if ((ds != 1 && ds != 2 && ds != 4) || HB % ds || WB % ds)
    return (int)cudaErrorInvalidValue;
  const BoostParams bp = boost_params(radius, taps, gm1, eps);
  const TailParams tp = tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  UpParams up;
  for (int k = 0; k < 8; ++k) up.f[k] = k < ds ? phases[k] : 0.0f;
  const int R = boost ? radius : 0;
  const int LH = YH + 2 * R, LW = YW + 2 * R;
  size_t floats = 3 * YN + 3 * PN;
  if (boost) floats += 3 * YN + YN + YH * LW + LH * LW;
  const dim3 grid((WB + TILE_W - 1) / TILE_W, (rows + TILE_H - 1) / TILE_H, B);
  const size_t smem = sizeof(float) * floats;
  auto kernel = ds == 1 ? curve_kernel<1> : ds == 2 ? curve_kernel<2>
                                                    : curve_kernel<4>;
  kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const float*)maps, (const float*)gain,
      (uint8_t*)out, HB, WB, halo, rows, n_iter, boost, m, img_w, up, bp, tp);
  return (int)cudaGetLastError();
}

// K1's gain form: curve_kernel<1> with the gain plane and no curve
// iteration.
int llie_fused_retinex_gain_u8(const void* in, const void* gain, void* out,
                               int B, int HB, int WB, int halo, int rows,
                               float strength, float inv2s2, float inv2s2_3,
                               int kind, int joint, int sep, void* stream) {
  const TailParams tp = tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  BoostParams bp = {};
  const UpParams up = {};
  const size_t smem = sizeof(float) * (3 * YN + 3 * PN);
  const dim3 grid((WB + TILE_W - 1) / TILE_W, (rows + TILE_H - 1) / TILE_H, B);
  curve_kernel<1><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, nullptr, (const float*)gain, (uint8_t*)out, HB, WB,
      halo, rows, 0, 0, 0, 1, up, bp, tp);
  return (int)cudaGetLastError();
}

// `alpha` and `beta` = 1 - alpha are each rounded once from double by the
// caller; `taps` is a host array of 2 * radius + 1 floats.
int llie_fused_retinex_ema_u8(const void* in, const void* carry, void* out,
                              void* ncarry, int B, int HB, int WB, int halo,
                              int rows, int m, int img_w, float alpha,
                              float beta, float gamma, int radius,
                              const float* taps, float eps, float strength,
                              float inv2s2, float inv2s2_3, int kind,
                              int joint, int sep, void* stream) {
  if (radius < 1 || radius > MAX_BLUR_RADIUS) return (int)cudaErrorInvalidValue;
  if (m < 1 || HB <= 2 * m) return (int)cudaErrorInvalidValue;
  const BoostParams bp = boost_params(radius, taps, 0.0f, eps);
  const TailParams tp = tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  EmaParams ep;
  ep.alpha = alpha;
  ep.beta = beta;
  ep.gamma = gamma;
  const int LH = YH + 2 * radius, LW = YW + 2 * radius;
  const size_t smem = sizeof(float) * (LH * LW + YH * LW + YN + 3 * YN + 3 * PN);
  const dim3 grid((WB + TILE_W - 1) / TILE_W,
                  (HB - 2 * m + TILE_H - 1) / TILE_H, B);
  ema_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const float*)carry, (uint8_t*)out, (float*)ncarry,
      HB, WB, halo, rows, m, img_w, ep, bp, tp);
  return (int)cudaGetLastError();
}

}  // extern "C"
