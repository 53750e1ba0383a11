// Fused enhance kernels for Hopper (sm_90a): K1 (retinex) and K3 (curve /
// hybrid tail), bound to PyTorch through ctypes (kernels/fused_enhance.py).
//
// What they replace. K1 replaces the TPU kernel fused_retinex ->
// _retinex_kernel (low_light_image_enhancement_tpu/kernels/fused_enhance.py,
// the non-EMA branch); K3 replaces fused_curve_enhance -> _curve_kernel in
// the same file, at curve_downsample 1.
//
// What bounds them. Both are stencils of a few hundred float operations per
// pixel on data that is read once. K1 moves 3 bytes in and 3 bytes out per
// pixel, too few for device memory to be its limit: the exp/log of the
// boost and the range weights' exps (6 of them in the default separable
// joint bilateral, 27 in the full per-channel one) bound it. K3 reads 3
// bytes plus n_iter * 3 float maps (96 bytes at n_iter 8) and writes 3 bytes
// per pixel, so device memory bounds it.
//
// What the design does about it. One thread per output pixel on a 16 x 32
// tile. The tile's input and its halo are staged once in shared memory (a
// halo of 1 + R for K1, 1 for the curve tail and 1 + R for hybrid, R the
// blur radius), and every intermediate (max RGB, the vertical blur, the
// gain, the boosted and curved planes, the first pass of the separable
// bilateral) stays there, so device memory sees each input byte once per
// tile plus the halo's overlap. K1 reads u8 HWC and writes u8 HWC directly:
// the transpose, pad, crop and transpose around the TPU kernel fold into
// its clamped reads. K3 reads each map value once, where the curve step
// needs it. Speed (tensor-memory loads, more pixels per thread) is later
// work; this version is held to its plain PyTorch version.
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

// K3: block (B, 3, HB, WB) u8 + maps (B, n_iter, 3, HB, WB) f32 ->
// (B, 3, rows, WB) u8, output row r <-> block row halo + r. With `boost`
// (hybrid) the boosted image's columns outside [m, m + img_w) are replaced
// by its columns m and m + img_w - 1 before the curves.
__global__ void __launch_bounds__(NTHREADS)
curve_kernel(const uint8_t* __restrict__ in, const float* __restrict__ maps,
             uint8_t* __restrict__ out, int HB, int WB, int halo, int rows,
             int n_iter, int boost, int m, int img_w, BoostParams bp,
             TailParams tp) {
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
  const uint8_t* blk = in + (size_t)blockIdx.z * 3 * plane;
  const float* mp = maps + (size_t)blockIdx.z * n_iter * 3 * plane;
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
    const size_t at = (size_t)clampi(r0 + i, 0, HB - 1) * WB
                      + clampi(c0 + j, 0, WB - 1);
    float y[3];
    if (boost) {
      // the boosted value of the nearest image column (replicate_margin_cols)
      const int jr = clampi(clampi(c0 + j, m, m + img_w - 1) - c0, 0, YW - 1);
      const int re = i * YW + jr;
      for (int c = 0; c < 3; ++c) y[c] = clip01(sX[c * YN + re] * sG[re]);
    } else {
      for (int c = 0; c < 3; ++c)
        y[c] = (float)(int)blk[c * plane + at] * U8_SCALE;
    }
    for (int c = 0; c < 3; ++c) {
      float v = y[c];
      for (int it = 0; it < n_iter; ++it) {
        const float a = mp[((size_t)it * 3 + c) * plane + at];
        v = v + a * v * (1.0f - v);
      }
      sY[c * YN + e] = clip01(v);
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

int llie_fused_curve_u8(const void* in, const void* maps, void* out, int B,
                        int HB, int WB, int halo, int rows, int n_iter,
                        int boost, int m, int img_w, int radius,
                        const float* taps, float gm1, float eps,
                        float strength, float inv2s2, float inv2s2_3, int kind,
                        int joint, int sep, void* stream) {
  if (radius < 1 || radius > MAX_BLUR_RADIUS) return (int)cudaErrorInvalidValue;
  const BoostParams bp = boost_params(radius, taps, gm1, eps);
  const TailParams tp = tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  const int R = boost ? radius : 0;
  const int LH = YH + 2 * R, LW = YW + 2 * R;
  size_t floats = 3 * YN + 3 * PN;
  if (boost) floats += 3 * YN + YN + YH * LW + LH * LW;
  const dim3 grid((WB + TILE_W - 1) / TILE_W, (rows + TILE_H - 1) / TILE_H, B);
  curve_kernel<<<grid, NTHREADS, sizeof(float) * floats, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const float*)maps, (uint8_t*)out, HB, WB, halo, rows,
      n_iter, boost, m, img_w, bp, tp);
  return (int)cudaGetLastError();
}

}  // extern "C"
