// K7, the fcn stack's dilated layers in one launch, for Hopper (sm_90a),
// bound to PyTorch through ctypes (kernels/fcn_cascade.py).
//
// What it replaces. The TPU kernel fcn_cascade_mxu -> _cascade_kernel
// (low_light_image_enhancement_tpu/kernels/fcn_cascade.py): fcn layers 2-7,
// six 3x3 convs at 24 channels and dilations 2, 4, 8, 16, 32, 1, each with
// bias and leaky 0.2 in f32 and conv-SAME zeros beyond the block, in one
// kernel. The TPU walks row bands in order and keeps each layer's last rows
// in rolling VMEM line buffers (10 MB), so activations never leave the chip.
//
// What bounds it. The six layers do 6 * 10,368 operations a pixel on 48
// bytes of bf16 in and out (if activations stayed on chip): about 1,300
// operations a byte, so the tensor cores' 989 TFLOP/s bound the stack, not
// memory. Hopper's blocks run in no order with at most 227 KB of shared
// memory each, and the stack's receptive halo is 63 pixels a side: the
// rows of that halo at 640 columns (~4 MB) do not fit a block.
//
// What the design does about it. bf16, the compute dtype: one persistent
// cooperative launch (one block an SM) of K6's tensor-core layer
// (conv3x3_wgmma.cuh: the producer warp's TMA loads of halo rows into a
// ring, two consumer warpgroups of wgmma), the layers in turn with a
// grid-wide barrier between them, two blocks an SM as K6b runs: a block
// copies each layer's packed weights (18 KB at 24 channels) into shared
// memory as the layer starts, beside a ring sized so that two blocks fit;
// each layer reads its input through its own tensor map (its box is 64 +
// 2d pixels wide), the ring and its mbarrier phases carry on from layer to
// layer. The epilogue stores with generic stores and the next layer reads
// with TMA (the async proxy), so every thread fences the proxies around
// the barrier (fence.proxy.async.global). The activations ping-pong
// through the output and a scratch tensor of the batch's size. (Walking
// the batch in image groups whose two buffers fit the 50 MB L2, all
// layers a group, kept the activations out of device memory between
// layers but cost a grid barrier per layer and group and a ragged last
// wave of strips each time: on the H100 at fcn's 528 x 640 b48 block,
// one-image groups took 10.5-11.5 ms against 5.6-6.0 ms for the whole
// batch, so the kernel walks the whole batch.) The layers sum as K6b
// does, so bf16 K7 equals bf16 K6b layer by layer, bit for bit.
//
// f32, the parity dtype, runs K6's CUDA-core layer (conv3x3.cuh) in the
// same cooperative launch, reads through the L2 (ld.global.cg, since other
// SMs wrote them during the launch), and so equals f32 K6b layer by layer.
#include <cooperative_groups.h>

#include "conv3x3.cuh"
#include "conv3x3_wgmma.cuh"

namespace cg = cooperative_groups;
namespace wc = llie::wgmma_conv;
using namespace llie::conv;

namespace {

constexpr int MAX_LAYERS = 8;
constexpr long long SM_SMEM = 233472;     // shared memory of an SM
constexpr long long BLOCK_RESERVED = 1024;  // of it, the system's a block

// ------------------------------------------------ f32: the CUDA cores --- //

struct CascadeArgs {
  const void* x;      // (B, H, W, C) layer input
  void* scratch;      // (B, H, W, C)
  void* out;          // (B, H, W, C) the last layer's output
  const float* w;     // (nl, 9, C, C) packed
  const float* bias;  // (nl, C)
  int dil[MAX_LAYERS];
  int nl, B, H, W;
};

template <int C>
__global__ void __launch_bounds__(CONV_THREADS)
fcn_cascade_kernel(CascadeArgs a) {
  extern __shared__ float sw[];
  cg::grid_group grid = cg::this_grid();
  const float* src = (const float*)a.x;
  for (int l = 0; l < a.nl; ++l) {
    // the last layer writes the output; the ones before alternate
    float* dst = (float*)(((a.nl - 1 - l) % 2 == 0) ? a.out : a.scratch);
    conv3x3_layer<float, C, true>(src, C, nullptr, 0, a.w + l * 9 * C * C,
                                  a.bias + l * C, dst, C, C, a.B, a.H, a.W,
                                  a.dil[l], ACT_LEAKY, sw);
    grid.sync();
    src = dst;
  }
}

int coop_supported() {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  return coop ? 0 : (int)cudaErrorNotSupported;
}

template <int C>
int launch_f32(const CascadeArgs& a, cudaStream_t stream) {
  const void* kern = (const void*)fcn_cascade_kernel<C>;
  int rc = coop_supported();
  if (rc != 0) return rc;
  const int smem = (int)sizeof(float) * layer_smem_floats(C, C);
  int grid = 0;
  rc = persistent_grid(kern, smem, (long long)a.B * a.H * a.W, &grid);
  if (rc != 0) return rc;
  CascadeArgs args = a;
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kern, dim3(grid), dim3(CONV_THREADS), params, (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ----------------------------------------------- bf16: the tensor cores --- //

using LayerGeom = wc::GeomT<1>;  // one piece: C <= 64

struct WgmmaArgs {
  LayerGeom g[MAX_LAYERS];       // each layer's strips, boxes, the ring
  __nv_bfloat16* dst[MAX_LAYERS];
  const __nv_bfloat16* w;   // nl layers of w_layer bytes
  const float* bias;        // (nl, C)
  uint32_t w_layer;
  int nl;
};

struct LayerMaps {
  CUtensorMap m[MAX_LAYERS];  // layer l's input, its box 64 + 2 d_l wide
};

// Two blocks an SM: at most 65536 / (2 * THREADS) registers a thread. Each
// layer's geometry is copied out of the parameters into registers (read at
// a run-time index in place, it cost 6% of the launch's time).
template <int N, int SP>
__global__ void __launch_bounds__(wc::THREADS, 2)
cascade_wgmma_kernel(const __grid_constant__ LayerMaps maps,
                     const __grid_constant__ WgmmaArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wc::smem_u32(smem_raw);
  const wc::Smem sm = wc::smem_layout(
      a.g[0], raw + ((wc::ALIGN - (raw & (wc::ALIGN - 1))) & (wc::ALIGN - 1)));
  // [one layer's weights][ring][full][empty][one layer's bias]
  float* sb = reinterpret_cast<float*>(__cvta_shared_to_generic(sm.bias));
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.g[0].slots; ++s) {
      wc::mbar_init(sm.full0 + 8 * s, 1);
      wc::mbar_init(sm.empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cg::grid_group grid = cg::this_grid();
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  uint32_t rc = 0;  // halo rows so far: the ring and its phases carry on
  int qc = 0;
#pragma unroll 1
  for (int l = 0; l < a.nl; ++l) {
    // the layer's weights and bias (the block's wgmma of the layer before
    // are done: every thread passed the last barrier), visible to wgmma
    wc::copy16(sm.sw, reinterpret_cast<const unsigned char*>(a.w) +
                          (size_t)l * a.w_layer, a.w_layer);
    for (int i = threadIdx.x; i < N; i += wc::THREADS)
      sb[i] = a.bias[l * N + i];
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const LayerGeom g = a.g[l];
    if (wg == wc::CONSUMERS) {
      if (threadIdx.x % 128 == 0)
        wc::produce<false>(g, &maps.m[l], &maps.m[l], sm, blockIdx.x,
                           gridDim.x, rc);
    } else {
      wc::consume<N, SP, 1>(g, sm, a.dst[l], 0, wg, blockIdx.x, gridDim.x,
                            rc, qc);
    }
    // the layer's generic stores before the next layer's TMA reads
    asm volatile("fence.proxy.async.global;" ::: "memory");
    grid.sync();
    asm volatile("fence.proxy.async.global;" ::: "memory");
  }
}

template <int N, int SP>
int launch_bf16(const void* x, void* scratch, void* out, const void* w,
                const float* bias, const int* dils, int nl, int B, int H,
                int W, cudaStream_t stream) {
  WgmmaArgs a = {};
  LayerMaps maps = {};
  uint32_t row = 0;
  for (int l = 0; l < nl; ++l) {
    LayerGeom& g = a.g[l];
    g.B = B;
    g.H = H;
    g.W = W;
    g.dil = dils[l];
    g.act = ACT_LEAKY;
    if (!wc::plan_layer(&g, N, 0, N, N) || g.pc[0].sp != SP)
      return (int)cudaErrorInvalidValue;
    row = row > g.row ? row : g.row;
  }
  // one ring for all layers, its slots as wide as the widest halo row, as
  // deep as lets two blocks share an SM (its 228 KB less 1 KB a block)
  a.w_layer = a.g[0].wchunk;
  const long long fixed = wc::ALIGN + (long long)a.w_layer + 4LL * N;
  const long long fit =
      (SM_SMEM / 2 - BLOCK_RESERVED - fixed) / ((long long)row + 16);
  if (fit < wc::ROWS + 2) return (int)cudaErrorInvalidValue;
  const int slots = (int)(fit < wc::MAX_SLOTS ? fit : wc::MAX_SLOTS);
  const int smem = (int)(fixed + ((long long)row + 16) * slots);
  for (int l = 0; l < nl; ++l) {
    LayerGeom& g = a.g[l];
    g.row = row;
    g.slots = slots;
    g.npass = 1;
    g.nsplit = 1;
    g.w_bytes = a.w_layer;
    g.smem = smem;
    // the last layer writes the output; the ones before alternate
    a.dst[l] = (__nv_bfloat16*)((nl - 1 - l) % 2 == 0 ? out : scratch);
    const void* src = l == 0 ? x : a.dst[l - 1];
    const int rc = wc::make_map(&maps.m[l], src, N, W, H, B, g.box_x);
    if (rc != 0) return rc;
  }
  a.w = (const __nv_bfloat16*)w;
  a.bias = bias;
  a.nl = nl;

  const void* kern = (const void*)cascade_wgmma_kernel<N, SP>;
  int rc = coop_supported();
  if (rc != 0) return rc;
  int sms = 0, per_sm = 0;
  rc = wc::card_fit(kern, smem, &sms, &per_sm);
  if (rc != 0) return rc;
  void* params[] = {&maps, &a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kern, dim3(per_sm * sms), dim3(wc::THREADS), params, (size_t)smem,
      stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// NHWC (B, H, W, c) -> (B, H, W, c) through nl layers (1..8) of 3x3 convs
// at dilations dils[0..nl) (a host array), bias and leaky 0.2, c one of 8,
// 16, 24, 32. bf16 (`bf16` 1): w the layers' packed bf16 of
// pack_conv_weights_wgmma one after the other, bias f32 (nl, c). f32: w the
// packed f32 (nl, 9, c, c), bias f32 (nl, c). scratch (B, H, W, c) of x's
// type. Returns the launch's error code (0 when it was accepted).
int llie_fcn_cascade(const void* x, void* scratch, void* out, const void* w,
                     const void* bias, const int* dils, int nl, int c, int B,
                     int H, int W, int bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1 || nl < 1 || nl > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < nl; ++l)
    if (dils[l] < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* bs = (const float*)bias;
  if (bf16) {
    switch (c) {
      case 8:
        return launch_bf16<8, 32>(x, scratch, out, w, bs, dils, nl, B, H, W,
                                  s);
      case 16:
        return launch_bf16<16, 32>(x, scratch, out, w, bs, dils, nl, B, H,
                                   W, s);
      case 24:
        return launch_bf16<24, 64>(x, scratch, out, w, bs, dils, nl, B, H,
                                   W, s);
      case 32:
        return launch_bf16<32, 64>(x, scratch, out, w, bs, dils, nl, B, H,
                                   W, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  CascadeArgs a;
  a.x = x;
  a.scratch = scratch;
  a.out = out;
  a.w = (const float*)w;
  a.bias = bs;
  for (int l = 0; l < MAX_LAYERS; ++l) a.dil[l] = l < nl ? dils[l] : 1;
  a.nl = nl;
  a.B = B;
  a.H = H;
  a.W = W;
  switch (c) {
    case 8:
      return launch_f32<8>(a, s);
    case 16:
      return launch_f32<16>(a, s);
    case 24:
      return launch_f32<24>(a, s);
    case 32:
      return launch_f32<32>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
