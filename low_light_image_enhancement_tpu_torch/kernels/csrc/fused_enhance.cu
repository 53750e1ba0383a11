// Fused enhance kernels for Hopper (sm_90a): K3 (curve / hybrid tail), K1's
// gain form and the blur of radii past the tiles, bound to PyTorch through
// ctypes (kernels/fused_enhance.py). K1 and K4 are retinex_tile.cu.
//
// What they replace. K3 replaces the TPU kernel fused_curve_enhance ->
// _curve_kernel (low_light_image_enhancement_tpu/kernels/fused_enhance.py),
// with maps at 1/1, 1/2 and 1/4 and the ext_gain arm; K1's gain form is
// K3's kernel with the gain and no curve iteration: the TPU kernel's two
// ext_gain arms (_retinex_kernel's and _curve_kernel's) compute the same
// thing. This file holds the bilateral tails (and no tail); the guided
// tails are fused_guided.cu.
//
// Forms. Every kernel reads and writes u8 or f32 (a template parameter on
// the loads and the store: f32 in [0, 1] in, clipped and not quantized
// out). Blur radii up to MAX_BLUR_RADIUS run on the tile, the taps in the
// launch's parameters; a wider blur runs first as blur_vertical_kernel and
// blur_horizontal_kernel into an f32 illumination plane (the taps in a
// device buffer), which the kernels' LPLANE forms (here and in
// retinex_tile.cu) read in place of their own blur: the same sums in the
// same order, so the result is the same.
//
// What bounds them. K3 reads 3 bytes plus n_iter * 3 float maps (96 bytes
// at n_iter 8) and writes 3 bytes per pixel, so device memory bounds it;
// with maps at 1/4 it reads 6 map bytes a pixel and the exp/log-free curve
// arithmetic (plus the upsample's 4 taps and 6 operations per map value)
// bounds it.
//
// What the design does about it. One thread per output pixel on a 16 x 32
// tile. The tile's input and its halo are staged once in shared memory (a
// halo of 1 for the curve tail and 1 + R for hybrid, R the blur radius),
// and every intermediate (max RGB, the vertical blur, the gain, the boosted
// and curved planes, the first pass of the separable bilateral) stays
// there, so device memory sees each input byte once per tile plus the
// halo's overlap. K3 reads each map value where the curve step needs it; at
// 1/ds it reads the four low-res taps of the upsample through the cache
// instead of a full-resolution map. More pixels per thread, as
// retinex_tile.cuh does for K1 and K4, is later work here.
//
// Numerics. --fmad=false and no --use_fast_math (see _build.py), rintf for
// round-half-even, u8 -> f32 as (float)(int)v * (1/255). The intermediates
// at positions outside the image are computed from clamped input reads,
// never clamped themselves: that is the replicate-padded canvas of the
// reference.
#include "fused_enhance.cuh"

namespace llie {

// K3: block (B, 3, HB, WB) T + maps (B, n_iter, 3, HB/DS, WB/DS) f32 ->
// (B, 3, rows, WB) T, output row r <-> block row halo + r. With `boost`
// (hybrid) the boosted image's columns outside [m, m + img_w) are replaced
// by its columns m and m + img_w - 1 before the curves. With `gain` (and
// no boost) the image is clip(x * gain) before the curves. LPLANE: the
// hybrid boost's blurred illumination is read from lp, (B, HB, WB).
template <int DS, class T, bool LPLANE>
__global__ void __launch_bounds__(NTHREADS)
curve_kernel(const T* __restrict__ in, const float* __restrict__ maps,
             const float* __restrict__ gain, const float* __restrict__ lp,
             T* __restrict__ out, int HB, int WB, int halo, int rows,
             int n_iter, int boost, int m, int img_w, UpParams up,
             BoostParams bp, TailParams tp) {
  extern __shared__ float smem[];
  const int R = boost && !LPLANE ? bp.radius : 0;
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
  const T* blk = in + (size_t)blockIdx.z * 3 * plane;
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
      const float r = load_px(blk + at);
      const float g = load_px(blk + plane + at);
      const float b = load_px(blk + 2 * plane + at);
      if constexpr (!LPLANE) sL0[e] = fmaxf(fmaxf(r, g), b);
      const int yi = i - R, yj = j - R;
      if (yi >= 0 && yi < YH && yj >= 0 && yj < YW) {
        const int ye = yi * YW + yj;
        sX[ye] = r;
        sX[YN + ye] = g;
        sX[2 * YN + ye] = b;
        if constexpr (LPLANE)
          sG[ye] = boost_gain(lp[(size_t)blockIdx.z * plane + at], bp, true);
      }
    }
    __syncthreads();
    if constexpr (!LPLANE) gain_tile(sL0, sV, sG, bp, tid);
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
      for (int c = 0; c < 3; ++c) y[c] = load_px(blk + c * plane + at);
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
    T* q = out + (size_t)blockIdx.z * 3 * rows * WB + (size_t)r * WB + c;
    for (int ch = 0; ch < 3; ++ch) store_px(q + (size_t)ch * rows * WB, o[ch]);
  }
}

// The illumination of blur radii past MAX_BLUR_RADIUS, for the LPLANE
// forms (and the guided tails'): L = blur(max RGB) on an (H + 2e) x (W +
// 2e) grid, grid (Y, X) <-> pixel (Y - e, X - e) of the (B, H, W, 3) image
// (HWC, K1) or of the (B, 3, H, W) block (K3, K4: e 0), from reads clamped
// into it, in blur_tile's order: this vertical pass into v, (B, H + 2e,
// W), then the horizontal one. Positions off the image blur the clamped
// reads, as the tile does; v's columns off the image would equal its edge
// columns, so v holds the image's columns only. taps: 2R + 1 floats on
// the device.
template <class T, bool HWC>
__device__ __forceinline__ float max_rgb(const T* in, int b, int y, int x,
                                         int H, int W) {
  if constexpr (HWC) {
    const T* p = in + (((size_t)b * H + y) * W + x) * 3;
    return fmaxf(fmaxf(load_px(p), load_px(p + 1)), load_px(p + 2));
  } else {
    const size_t plane = (size_t)H * W;
    const T* p = in + (size_t)b * 3 * plane + (size_t)y * W + x;
    return fmaxf(fmaxf(load_px(p), load_px(p + plane)),
                 load_px(p + 2 * plane));
  }
}

template <class T, bool HWC>
__global__ void __launch_bounds__(256)
blur_vertical_kernel(const T* __restrict__ in, float* __restrict__ v, int B,
                     int H, int W, int e, int R,
                     const float* __restrict__ taps) {
  const int HE = H + 2 * e;
  const long long n = (long long)B * HE * W;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int x = (int)(idx % W);
    const long long t = idx / W;
    const int y = (int)(t % HE) - e, b = (int)(t / HE);
    float acc = taps[0] * max_rgb<T, HWC>(in, b, clampi(y + R, 0, H - 1), x,
                                          H, W);
    for (int k = 1; k <= 2 * R; ++k)
      acc = acc + taps[k] * max_rgb<T, HWC>(in, b,
                                            clampi(y + R - k, 0, H - 1), x,
                                            H, W);
    v[idx] = acc;
  }
}

__global__ void __launch_bounds__(256)
blur_horizontal_kernel(const float* __restrict__ v, float* __restrict__ l,
                       int B, int H, int W, int e, int R,
                       const float* __restrict__ taps) {
  const int HE = H + 2 * e, WE = W + 2 * e;
  const long long n = (long long)B * HE * WE;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int x = (int)(idx % WE) - e;
    const float* row = v + (idx / WE) * W;
    float acc = taps[0] * row[clampi(x + R, 0, W - 1)];
    for (int k = 1; k <= 2 * R; ++k)
      acc = acc + taps[k] * row[clampi(x + R - k, 0, W - 1)];
    l[idx] = acc;
  }
}

// The kernel of one form: instantiated for both I/O types.
template <template <class> class Form, class... Args>
int launch_io(int f32, Args... args) {
  return f32 ? Form<float>::run(args...) : Form<uint8_t>::run(args...);
}

template <class T>
struct CurveForm {
  static int run(const void* in, const void* maps, const void* gain,
                 const float* lp, void* out, int B, int HB, int WB, int halo,
                 int rows, int n_iter, int boost, int m, int img_w, int ds,
                 const UpParams& up, const BoostParams& bp,
                 const TailParams& tp, cudaStream_t st) {
    const int R = boost && !lp ? bp.radius : 0;
    const int LH = YH + 2 * R, LW = YW + 2 * R;
    size_t floats = 3 * YN + 3 * PN;
    if (boost) floats += 3 * YN + YN + YH * LW + LH * LW;
    const dim3 grid((WB + TILE_W - 1) / TILE_W, (rows + TILE_H - 1) / TILE_H,
                    B);
    const size_t smem = sizeof(float) * floats;
    auto kernel = lp ? (ds == 1 ? curve_kernel<1, T, true>
                        : ds == 2 ? curve_kernel<2, T, true>
                                  : curve_kernel<4, T, true>)
                     : (ds == 1 ? curve_kernel<1, T, false>
                        : ds == 2 ? curve_kernel<2, T, false>
                                  : curve_kernel<4, T, false>);
    kernel<<<grid, NTHREADS, smem, st>>>(
        (const T*)in, (const float*)maps, (const float*)gain, lp, (T*)out,
        HB, WB, halo, rows, n_iter, boost, m, img_w, up, bp, tp);
    return (int)cudaGetLastError();
  }
};

template <class T>
struct BlurForm {
  static int run(int hwc, const void* in, float* v, float* l, int B, int H,
                 int W, int e, int R, const float* taps, cudaStream_t st) {
    const int threads = 256;
    auto blocks = [&](long long n) {
      const long long g = (n + threads - 1) / threads;
      return (unsigned)(g < 65535LL * 16 ? g : 65535LL * 16);
    };
    const long long nv = (long long)B * (H + 2 * e) * W;
    if (hwc)
      blur_vertical_kernel<T, true><<<blocks(nv), threads, 0, st>>>(
          (const T*)in, v, B, H, W, e, R, taps);
    else
      blur_vertical_kernel<T, false><<<blocks(nv), threads, 0, st>>>(
          (const T*)in, v, B, H, W, e, R, taps);
    const long long nl = (long long)B * (H + 2 * e) * (W + 2 * e);
    blur_horizontal_kernel<<<blocks(nl), threads, 0, st>>>(v, l, B, H, W, e,
                                                           R, taps);
    return (int)cudaGetLastError();
  }
};

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
  if ((ds != 1 && ds != 2 && ds != 4) || HB % ds || WB % ds)
    return (int)cudaErrorInvalidValue;
  const BoostParams bp = boost_params(radius, taps, gm1, eps);
  const TailParams tp = tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  UpParams up;
  for (int k = 0; k < 8; ++k) up.f[k] = k < ds ? phases[k] : 0.0f;
  return launch_io<CurveForm>(f32, in, maps, gain, boost ? lp : nullptr, out,
                              B, HB, WB, halo, rows, n_iter, boost, m, img_w,
                              ds, up, bp, tp, (cudaStream_t)stream);
}

// K1's gain form: curve_kernel<1> with the gain plane and no curve
// iteration.
int llie_fused_retinex_gain(const void* in, const void* gain, void* out,
                            int f32, int B, int HB, int WB, int halo,
                            int rows, float strength, float inv2s2,
                            float inv2s2_3, int kind, int joint, int sep,
                            void* stream) {
  const TailParams tp = tail_params(strength, inv2s2, inv2s2_3, kind, joint, sep);
  const BoostParams bp = {};
  const UpParams up = {};
  return launch_io<CurveForm>(f32, in, (const void*)nullptr, gain,
                              (const float*)nullptr, out, B, HB, WB, halo,
                              rows, 0, 0, 0, 1, 1, up, bp, tp,
                              (cudaStream_t)stream);
}

// The blurred illumination of a radius past MAX_BLUR_RADIUS: `in` the
// (B, H, W, 3) image (`hwc` 1) or the (B, 3, H, W) block, u8 or (`f32` 1)
// f32; v scratch of B * (H + 2e) * W floats; l the (B, H + 2e, W + 2e)
// plane; `taps` 2 * radius + 1 floats on the device.
int llie_blur_illumination(const void* in, int f32, int hwc, float* v,
                           float* l, int B, int H, int W, int e, int radius,
                           const float* taps, void* stream) {
  if (B < 1 || H < 1 || W < 1 || e < 0 || radius < 1)
    return (int)cudaErrorInvalidValue;
  return launch_io<BlurForm>(f32, hwc, in, v, l, B, H, W, e, radius, taps,
                             (cudaStream_t)stream);
}

}  // extern "C"
