// The direct 3x3 conv layer shared by K6 (mxu_conv.cu, one layer a launch)
// and K7 (fcn_cascade.cu, the fcn stack in one launch).
//
// One layer: NHWC activations of 1 or 2 input tensors (a channel concat
// read in place), a 3x3 kernel at dilation d with conv-SAME zeros beyond the
// tensor, an f32 accumulator, + bias in f32, the activation in f32, one
// cast to the activation type (bf16 or f32). Each thread owns CONV_PPT
// output pixels of a tile of CONV_TILE consecutive pixels (b, y, x
// flattened) and, chunk by chunk, NC output channels at a time (the layer's
// Cout padded to a multiple of NC with zero weights, the padding never
// stored); the blocks walk the tiles with a grid stride, so a persistent
// grid loads the layer's weights into shared memory once (or reads them
// through the L1 where they do not fit). The weights are the wrapper's
// packed f32 (9, Cin, Coutp) (values rounded to the activation type first),
// read four output channels at a time as broadcasts; the input is read per
// tap as 8-channel vectors (16 bytes of bf16) straight from device memory,
// each pixel's 9 taps shared between neighbouring threads through the L1
// cache (K6) or the L2 (K7, whose inputs were written by other blocks
// during the launch). Each output channel sums its taps in the same order
// whatever the chunk width, so K7 and K6 agree bit for bit.
//
// Every product is accumulated with __fmaf_rn, which stays a fused
// multiply-add under --fmad=false: the plain version sums in another
// order anyway, and a separate multiply and add would halve the rate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace llie {
namespace conv {

constexpr int CONV_THREADS = 128;
constexpr int CONV_PPT = 2;
constexpr int CONV_TILE = CONV_THREADS * CONV_PPT;
constexpr int CIN_STEP = 8;  // channels per vector read; groups are multiples

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_TANH = 3 };

inline __device__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(x, 0.0f);
    case ACT_LEAKY:  // jax.nn.leaky_relu(x, 0.2) in f32
      return x >= 0.0f ? x : 0.2f * x;
    case ACT_TANH:
      return tanhf(x);
    default:
      return x;
  }
}

// 8 consecutive channels as f32. L2ONLY reads through the L2 alone
// (ld.global.cg): the L1 of one SM is not kept coherent with the writes of
// another, and K7 reads what other blocks wrote in the same launch.
template <bool L2ONLY>
inline __device__ void load8(const float* p, float v[8]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = L2ONLY ? __ldcg(q) : q[0];
  const float4 b = L2ONLY ? __ldcg(q + 1) : q[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <bool L2ONLY>
inline __device__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 u = L2ONLY ? __ldcg(q) : q[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

template <int COUT>
inline __device__ void store_pixel(float* p, const float v[COUT]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int k = 0; k < COUT / 4; ++k)
    q[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

template <int COUT>
inline __device__ void store_pixel(__nv_bfloat16* p, const float v[COUT]) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int k = 0; k < COUT / 8; ++k) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[8 * k + 2 * j], v[8 * k + 2 * j + 1]);
    q[k] = u;
  }
}

inline __device__ void store_one(float* p, float v) { *p = v; }
inline __device__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Shared memory of one layer: the packed weights and the bias, in floats.
inline __host__ __device__ int layer_smem_floats(int cin, int coutp) {
  return 9 * cin * coutp + coutp;
}

// The most weights and bias a layer keeps in shared memory (floats); a
// wider layer reads them from device memory through the L1.
constexpr int MAX_SMEM_FLOATS = 48 * 1024;

// One layer over every tile, with the block's share of the grid stride.
// xa holds channels [0, ca), xb (if cb > 0) channels [ca, ca + cb) of the
// concat; out is (B, H, W, cout), w the packed (9, ca + cb, coutp), bias
// (coutp), coutp a multiple of NC. With `sw` the weights and bias are
// loaded into it first (and the function ends with a __syncthreads, so a
// caller may reload `sw`); with nullptr they are read where they lie.
template <typename T, int NC, bool L2ONLY>
inline __device__ void conv3x3_layer(const T* xa, int ca, const T* xb, int cb,
                                     const float* w, const float* bias, T* out,
                                     int cout, int coutp, int B, int H, int W,
                                     int dil, int act, float* sw) {
  const int cin = ca + cb;
  const int nw = 9 * cin * coutp;
  const float* wsrc = w;
  const float* sb = bias;
  if (sw != nullptr) {
    for (int i = threadIdx.x; i < nw; i += blockDim.x) sw[i] = w[i];
    for (int i = threadIdx.x; i < coutp; i += blockDim.x)
      sw[nw + i] = bias[i];
    __syncthreads();
    wsrc = sw;
    sb = sw + nw;
  }
  const long long P = (long long)B * H * W;
  const long long ntiles = (P + CONV_TILE - 1) / CONV_TILE;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int pb[CONV_PPT], py[CONV_PPT], px[CONV_PPT];
    bool live[CONV_PPT];
#pragma unroll
    for (int k = 0; k < CONV_PPT; ++k) {
      long long p = tile * CONV_TILE + k * CONV_THREADS + threadIdx.x;
      live[k] = p < P;
      if (!live[k]) p = 0;
      px[k] = (int)(p % W);
      const long long t = p / W;
      py[k] = (int)(t % H);
      pb[k] = (int)(t / H);
    }
#pragma unroll 1
    for (int co0 = 0; co0 < coutp; co0 += NC) {
      float acc[CONV_PPT][NC];
#pragma unroll
      for (int k = 0; k < CONV_PPT; ++k)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[k][c] = 0.0f;

#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = (tap / 3 - 1) * dil, dx = (tap % 3 - 1) * dil;
        long long pix[CONV_PPT];
        bool ok[CONV_PPT];
#pragma unroll
        for (int k = 0; k < CONV_PPT; ++k) {
          const int yy = py[k] + dy, xx = px[k] + dx;
          ok[k] = live[k] && yy >= 0 && yy < H && xx >= 0 && xx < W;
          pix[k] = ((long long)pb[k] * H + yy) * W + xx;
        }
        const float* wt = wsrc + tap * cin * coutp + co0;
#pragma unroll 1
        for (int c0 = 0; c0 < cin; c0 += CIN_STEP) {
          const bool in_a = c0 < ca;
          const T* src = in_a ? xa : xb;
          const int cs = in_a ? ca : cb;
          const int off = in_a ? c0 : c0 - ca;
          float v[CONV_PPT][CIN_STEP];
#pragma unroll
          for (int k = 0; k < CONV_PPT; ++k) {
            if (ok[k]) {
              load8<L2ONLY>(src + pix[k] * cs + off, v[k]);
            } else {
#pragma unroll
              for (int j = 0; j < CIN_STEP; ++j) v[k][j] = 0.0f;
            }
          }
#pragma unroll
          for (int j = 0; j < CIN_STEP; ++j) {
            const float4* wr =
                reinterpret_cast<const float4*>(wt + (c0 + j) * coutp);
#pragma unroll
            for (int q = 0; q < NC / 4; ++q) {
              const float4 ww = wr[q];
#pragma unroll
              for (int k = 0; k < CONV_PPT; ++k) {
                acc[k][4 * q] = __fmaf_rn(v[k][j], ww.x, acc[k][4 * q]);
                acc[k][4 * q + 1] =
                    __fmaf_rn(v[k][j], ww.y, acc[k][4 * q + 1]);
                acc[k][4 * q + 2] =
                    __fmaf_rn(v[k][j], ww.z, acc[k][4 * q + 2]);
                acc[k][4 * q + 3] =
                    __fmaf_rn(v[k][j], ww.w, acc[k][4 * q + 3]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < CONV_PPT; ++k) {
        if (!live[k]) continue;
        float r[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          r[c] = activate(acc[k][c] + sb[co0 + c], act);
        const long long p = tile * CONV_TILE + k * CONV_THREADS + threadIdx.x;
        T* o = out + p * cout + co0;
        if (cout == coutp) {
          store_pixel<NC>(o, r);
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (co0 + c < cout) store_one(o + c, r[c]);
        }
      }
    }
  }
  if (sw != nullptr) __syncthreads();
}

// The grid of a persistent launch: as many blocks as fit on the card at
// once (at least one), and no more than there are tiles.
inline int persistent_grid(const void* kernel, int smem_bytes, long long P,
                           int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      CONV_THREADS, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = (P + CONV_TILE - 1) / CONV_TILE;
  long long g = (long long)per_sm * sms;
  if (g > ntiles) g = ntiles;
  *grid = (int)(g < 1 ? 1 : g);
  return 0;
}

}  // namespace conv
}  // namespace llie
