// Device code shared by the tile engine (retinex_tile.cuh: K1, K3, K4 and
// K5's bilateral arm), the guided tails (fused_guided.cuh) and the blur
// past the tiles (fused_enhance.cu): the parameter structs, the boost, the
// curve maps' upsample taps, the bilateral's spatial weights, and the u8
// and f32 loads and stores.
//
// The arithmetic repeats the plain PyTorch versions (ops/filters.py,
// ops/denoise.py, core.py) operation for operation: the same tap order,
// the same accumulator starts, divides where they divide and reciprocals
// where they multiply by one, exp(g * log L) for the power, and every
// constant rounded once from double on the host. The library is built with
// --fmad=false so that a*b+c stays a multiply and an add, as in PyTorch's
// eager ops. Functions defined here are inline: every .cu that includes the
// header is compiled on its own and linked into one library.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace llie {

constexpr int MAX_BLUR_RADIUS = 8;

constexpr float U8_SCALE = 1.0f / 255.0f;

// K1's stages (the JAX kernel's `stages`; retinex_tile.cu, fused_guided.cuh):
// without BLUR the illumination is max RGB itself, without BOOST the gain
// is the clipped illumination (no exp/log), without either y = x; without
// DENOISE no tail runs.
constexpr int STAGE_BLUR = 1;
constexpr int STAGE_BOOST = 2;
constexpr int STAGE_DENOISE = 4;
constexpr int STAGES_ALL = 7;

// The boost of K3's kernels (curve_tile.cu, fused_guided.cuh's FG_CURVE):
// none (curve, K1's gain form); hybrid's, whose boosted margin columns
// then take the values of their nearest image column
// (replicate_margin_cols); or K1's canvas form's, whose margin columns keep
// the values boosted from the canvas as staged (the plain K1 graph).
constexpr int BOOST_NONE = 0;
constexpr int BOOST_HYBRID = 1;
constexpr int BOOST_CANVAS = 2;

struct BoostParams {
  int radius;                              // blur radius R
  float taps[2 * MAX_BLUR_RADIUS + 1];     // gaussian_kernel_1d, as float
  float gm1;                               // gamma - 1
  float eps;                               // illumination floor
};

// Curve maps at 1/ds (K3; ds is the kernel's template argument):
// upsample_int's phase weights by index mod ds, each rounded once from
// double on the host; K3 (curve_tile.cu) also carries each weight's 1 - f
// at f[4 + p] (ds <= 4), the guided tails read f[p] alone.
struct UpParams {
  float f[8];
};

// The EMA of the video step (K4): l_mix = alpha * l_now + beta * carry
// with beta = 1 - alpha, and the gain's exponent gamma.
struct EmaParams {
  float alpha;
  float beta;
  float gamma;
};

struct TailParams {
  float strength;  // blend toward the filtered image; <= 0 skips the tail
  float inv2s2;    // 1 / (2 sigma^2)
  float inv2s2_3;  // inv2s2 * (1/3), the epan weight's scale
  int kind;        // 0: exp, 1: epan
  int joint;       // 1: luma-guided joint bilateral, 0: per channel
  int sep;         // 1: separable 3+3 taps, 0: full 3x3
};

// The launch parameters from the C interfaces' arguments (host code).
inline BoostParams boost_params(int radius, const float* taps, float gm1,
                                float eps) {
  BoostParams bp = {};
  // a radius past MAX_BLUR_RADIUS is blurred into a plane first
  bp.radius = radius <= MAX_BLUR_RADIUS ? radius : 0;
  for (int k = 0; k <= 2 * bp.radius; ++k) bp.taps[k] = taps[k];
  bp.gm1 = gm1;
  bp.eps = eps;
  return bp;
}

inline TailParams tail_params(float strength, float inv2s2, float inv2s2_3,
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

// The launch of one form's kernel (Form<T>::run), for both I/O types.
template <template <class> class Form, class... Args>
int launch_io(int f32, Args... args) {
  return f32 ? Form<float>::run(args...) : Form<uint8_t>::run(args...);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ uint8_t quantize(float v) {
  // clip, round half to even, clip: ops.colorspace.quantize_u8
  float q = rintf(clip01(v) * 255.0f);
  return (uint8_t)(int)fminf(fmaxf(q, 0.0f), 255.0f);
}

// The I/O types: u8 in [0, 255] or f32 in [0, 1]. A u8 value is
// (float)(int)v * (1/255) and leaves quantized; an f32 value is itself and
// leaves clipped to [0, 1] (the JAX kernels' _finalize_plane, u8_io False).
__device__ __forceinline__ float load_px(const uint8_t* p) {
  return (float)(int)*p * U8_SCALE;
}
__device__ __forceinline__ float load_px(const float* p) { return *p; }
__device__ __forceinline__ void store_px(uint8_t* p, float v) {
  *p = quantize(v);
}
__device__ __forceinline__ void store_px(float* p, float v) { *p = clip01(v); }

// The binomial spatial weights (0.25, 0.5, 0.25) at tap index t + 1.
__device__ __forceinline__ float spatial(int k) {
  return k == 1 ? 0.5f : 0.25f;
}

// The retinex gain of a blurred (or, without STAGE_BLUR, raw) illumination
// value: clipped to [eps, 1], then exp((gamma-1) * log L), or without
// STAGE_BOOST the clipped value itself.
__device__ __forceinline__ float boost_gain(float l, const BoostParams& bp,
                                            bool boost) {
  l = fminf(fmaxf(l, bp.eps), 1.0f);
  return boost ? expf(bp.gm1 * logf(l)) : l;
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

}  // namespace llie
