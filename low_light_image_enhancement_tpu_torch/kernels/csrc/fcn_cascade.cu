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
// memory each, and the stack's receptive halo is 63 pixels a side: a tile
// that recomputes all six layers from its input would stage some 1.1 MB of
// activations for a 32 x 32 output.
//
// What the design does about it. Right and simple first: one persistent
// cooperative launch (as many blocks as fit on the card), which runs the
// layers in turn with a grid-wide barrier (cooperative_groups grid.sync)
// between them. Each layer is K6's conv (conv3x3.cuh) over the whole
// batch; activations ping-pong between the output tensor and one scratch
// tensor the wrapper allocates (the last layer lands in the output), and
// reads go through the L2 (ld.global.cg), since other SMs wrote them
// during the launch. So activations do cross device memory between layers,
// as they do between K6 launches, but one launch replaces six. Keeping
// them on chip (line buffers down a column strip, or a cluster's
// distributed shared memory) is the redesign for a later PR.
#include <cooperative_groups.h>

#include "conv3x3.cuh"

namespace cg = cooperative_groups;
using namespace llie::conv;

namespace {

constexpr int MAX_LAYERS = 8;

struct CascadeArgs {
  const void* x;      // (B, H, W, C) layer input
  void* scratch;      // (B, H, W, C)
  void* out;          // (B, H, W, C) the last layer's output
  const float* w;     // (nl, 9, C, C) packed
  const float* bias;  // (nl, C)
  int dil[MAX_LAYERS];
  int nl, B, H, W;
};

template <typename T, int C>
__global__ void __launch_bounds__(CONV_THREADS)
fcn_cascade_kernel(CascadeArgs a) {
  extern __shared__ float sw[];
  cg::grid_group grid = cg::this_grid();
  const T* src = (const T*)a.x;
  for (int l = 0; l < a.nl; ++l) {
    // the last layer writes the output; the ones before alternate
    T* dst = (T*)(((a.nl - 1 - l) % 2 == 0) ? a.out : a.scratch);
    conv3x3_layer<T, C, true>(src, C, nullptr, 0, a.w + l * 9 * C * C,
                              a.bias + l * C, dst, a.B, a.H, a.W, a.dil[l],
                              ACT_LEAKY, sw);
    grid.sync();
    src = dst;
  }
}

template <typename T, int C>
int launch(const CascadeArgs& a, cudaStream_t stream) {
  const void* kern = (const void*)fcn_cascade_kernel<T, C>;
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const int smem = (int)sizeof(float) * layer_smem_floats(C, C);
  int grid = 0;
  const int rc =
      persistent_grid(kern, smem, (long long)a.B * a.H * a.W, &grid);
  if (rc != 0) return rc;
  CascadeArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(CONV_THREADS),
                                    params, (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_c(int c, const CascadeArgs& a, cudaStream_t stream) {
  switch (c) {
    case 8:
      return launch<T, 8>(a, stream);
    case 16:
      return launch<T, 16>(a, stream);
    case 24:
      return launch<T, 24>(a, stream);
    case 32:
      return launch<T, 32>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// NHWC (B, H, W, c) -> (B, H, W, c) through nl layers (1..8) of 3x3 convs
// at dilations dils[0..nl) (a host array), bias and leaky 0.2; bf16 (`bf16`
// 1) or f32 activations, w the packed f32 (nl, 9, c, c), bias f32 (nl, c);
// scratch a (B, H, W, c) tensor of the activation type, c one of 8, 16,
// 24, 32. Returns the launch's error code (0 when it was accepted).
int llie_fcn_cascade(const void* x, void* scratch, void* out, const void* w,
                     const void* bias, const int* dils, int nl, int c, int B,
                     int H, int W, int bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1 || nl < 1 || nl > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  CascadeArgs a;
  a.x = x;
  a.scratch = scratch;
  a.out = out;
  a.w = (const float*)w;
  a.bias = (const float*)bias;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    a.dil[l] = l < nl ? dils[l] : 1;
    if (a.dil[l] < 1) return (int)cudaErrorInvalidValue;
  }
  a.nl = nl;
  a.B = B;
  a.H = H;
  a.W = W;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_c<__nv_bfloat16>(c, a, s) : launch_c<float>(c, a, s);
}

}  // extern "C"
