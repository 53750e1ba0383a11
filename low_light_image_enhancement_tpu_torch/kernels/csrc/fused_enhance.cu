// The blur of radii past the tiles for Hopper (sm_90a), bound to PyTorch
// through ctypes (kernels/fused_enhance.py): blur_illumination, the
// illumination plane that the LPLANE forms of K1, K3 and K4
// (retinex_tile.cu, curve_tile.cu) and the guided tails (fused_guided.cu)
// read in place of their own blur.
//
// What it replaces. The separable blur that the TPU kernels run inside
// fused_retinex, fused_curve_enhance and fused_retinex_ema
// (low_light_image_enhancement_tpu/kernels/fused_enhance.py) at any radius;
// the kernels here run it at radii past MAX_BLUR_RADIUS, where the taps no
// longer fit the tiles' registers and halos.
//
// What bounds it. It reads the image (3 bytes a pixel on u8) and writes the
// f32 plane (4): device memory, but its 2 (2R + 1) multiply-adds a position
// come close at large radii.
//
// What the design does about it. Two grid-stride passes, one output a
// thread: the vertical one of max RGB into a scratch plane of the image's
// columns (columns off the image would equal its edge columns), then the
// horizontal one into the plane, the taps in a device buffer. A tiled form
// is later work.
//
// Numerics: as fused_enhance.cuh (--fmad=false; the tiles' tap order, so
// that the LPLANE forms' results equal their tile-blur forms').
#include "fused_enhance.cuh"

namespace llie {

// The illumination of blur radii past MAX_BLUR_RADIUS, for the LPLANE
// forms (and the guided tails'): L = blur(max RGB) on an (H + 2e) x (W +
// 2e) grid, grid (Y, X) <-> pixel (Y - e, X - e) of the (B, H, W, 3) image
// (HWC, K1) or of the (B, 3, H, W) block (K3, K4: e 0), from reads clamped
// into it, in the tiles' order: this vertical pass into v, (B, H + 2e,
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
