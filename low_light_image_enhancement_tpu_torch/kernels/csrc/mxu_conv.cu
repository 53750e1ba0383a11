// K6, one 3x3 conv layer of the learned nets for Hopper (sm_90a), bound to
// PyTorch through ctypes (kernels/mxu_conv.py).
//
// What it replaces. Two TPU kernels of
// low_light_image_enhancement_tpu/kernels/mxu_conv.py: conv2d_patch_mxu ->
// _patch_kernel (K6a: dilation 1, 1-2 concatenated input groups, relu or
// tanh; the curve CNN's c2-c7 and the decom net's c2-c4) and
// conv2d_dense9_mxu -> _conv_kernel (K6b: dilation 1 or even, leaky 0.2;
// the fcn stack's c2-c7). Both compute the same function: a SAME-padded 3x3
// conv with bias and activation in f32 on bf16 (or f32) activations, cast
// once to the input type. Their space-to-depth packing fills the TPU's
// 128-lane matrix unit at 24-32 channels; it has no use here, and these
// kernels take unpacked NHWC.
//
// What bounds it. At the nets' widths a layer does 2 * 9 * Cin * Cout
// operations a pixel (36,864 at 64 -> 32, 18,432 at 32 -> 32, 10,368 at
// 24 -> 24) on 2 * (Cin + Cout) bytes of bf16 in and out: 108 to 192
// operations a byte, below the ~295 at which the bf16 tensor cores (989
// TFLOP/s) rather than device memory (3.35 TB/s) would set the pace, so a
// layer's bound is its bytes.
//
// What the design does about it. bf16, the compute dtype of every learned
// path, runs on the tensor cores (conv3x3_wgmma.cuh): an implicit GEMM of
// wgmma fed by TMA, the halo rows of a tile staged once in shared memory
// and each tap a shifted descriptor into them, so a layer moves its bytes
// about once from device memory. f32, the parity dtype, stays on the CUDA
// cores (conv3x3.cuh: f32 multiply-adds, one thread per 2 pixels and a
// chunk of output channels at a time, weights in shared memory for a
// persistent grid); TF32 would not hold the f32 bar of 1e-5. The concat of
// skip connections is never built: the second input tensor is read in
// place.
//
// Widths. Both forms take every width the nets' configs reach
// (curve_features and curve_iters): input groups of a multiple of 8
// channels (the wrapper pads other widths once, since TMA needs 16-byte
// strides), any Cout, padded to a multiple of the chunk width nc with zero
// weights and bias and stored unpadded. The bf16 form holds one chunk's
// weights in shared memory beside a ring of at least ROWS + 2 slots, each
// slot the halo rows of a group of input pieces where whole rows do not
// fit (conv3x3_wgmma.cuh, piece groups), and past 16 pieces of 64
// channels (Cin 1024: curve_features 512), or 14 at dilation 64 and more,
// it streams one piece group's weights at a time beside the ring
// (conv3x3_stream_kernel), so it takes any Cin in one launch.
#include "conv3x3.cuh"
#include "conv3x3_wgmma.cuh"

using namespace llie::conv;

namespace {

// wsm: the weights and bias fit shared memory (else they are read in
// place)
template <int NC>
__global__ void __launch_bounds__(CONV_THREADS)
conv3x3_kernel(const float* xa, int ca, const float* xb, int cb,
               const float* w, const float* bias, float* out, int cout,
               int coutp, int B, int H, int W, int dil, int act, int wsm) {
  extern __shared__ float sw[];
  conv3x3_layer<float, NC, false>(xa, ca, xb, cb, w, bias, out, cout, coutp,
                                  B, H, W, dil, act, wsm ? sw : nullptr);
}

template <int NC>
int launch_direct(const void* xa, int ca, const void* xb, int cb,
                  const float* w, const float* bias, void* out, int cout,
                  int B, int H, int W, int dil, int act,
                  cudaStream_t stream) {
  const void* kern = (const void*)conv3x3_kernel<NC>;
  const int coutp = (cout + NC - 1) / NC * NC;
  const int floats = layer_smem_floats(ca + cb, coutp);
  const int wsm = floats <= MAX_SMEM_FLOATS;
  const int smem = wsm ? (int)sizeof(float) * floats : 0;
  int grid = 0;
  const int rc = persistent_grid(kern, smem, (long long)B * H * W, &grid);
  if (rc != 0) return rc;
  conv3x3_kernel<NC><<<grid, CONV_THREADS, smem, stream>>>(
      (const float*)xa, ca, (const float*)xb, cb, w, bias, (float*)out, cout,
      coutp, B, H, W, dil, act, wsm);
  return (int)cudaGetLastError();
}

// One layer in chunks of NC output channels: bf16 on the tensor cores, f32
// on the CUDA cores.
template <int NC>
int launch(int bf16, const void* xa, int ca, const void* xb, int cb,
           const void* w, const float* bias, void* out, int cout, int B,
           int H, int W, int dil, int act, cudaStream_t stream) {
  if (bf16)
    return llie::wgmma_conv::launch<NC>(xa, ca, xb, cb, w, bias, out, cout,
                                        B, H, W, dil, act, stream);
  return launch_direct<NC>(xa, ca, xb, cb, (const float*)w, bias, out, cout,
                           B, H, W, dil, act, stream);
}

}  // namespace

extern "C" {

// The chunk width nc at which llie_conv3x3 runs a bf16 layer of input
// groups of ca and cb channels (multiples of 8; cb may be 0) -> cout at
// dilation dil (conv3x3_wgmma.cuh chunk_width), or 0 where the layer does
// not fit the kernel's shared memory.
int llie_conv_plan(int ca, int cb, int cout, int dil) {
  if (ca < CIN_STEP || ca % CIN_STEP || cb < 0 || cb % CIN_STEP ||
      cout < 1 || dil < 1)
    return 0;
  return llie::wgmma_conv::chunk_width(ca, cb, cout, dil);
}

// NHWC (B, H, W, ca) [+ (B, H, W, cb)] -> (B, H, W, cout), all bf16 (`bf16`
// 1) or all f32, in chunks of nc output channels (a multiple of 8 up to 64
// that divides cout rounded up to 8: llie_conv_plan's for bf16,
// mxu_conv.py chunk_channels for f32); w is the packed bf16 of mxu_conv.py
// pack_conv_weights_wgmma (bf16: per chunk, tap and piece a swizzled nc x
// CP matrix) or the packed f32
// (9, ca + cb, coutp) of pack_conv_weights (f32), bias f32 (coutp), coutp
// = cout rounded up to nc. ca, cb multiples of 8 (cb may be 0, xb then
// unused), dil >= 1, act an Act. Returns cudaGetLastError() after the
// launch (0 when it was accepted), or the error that kept it from
// launching (cudaErrorInvalidValue for a bf16 layer too wide for shared
// memory).
int llie_conv3x3(const void* xa, int ca, const void* xb, int cb,
                 const void* w, const void* bias, void* out, int cout,
                 int nc, int B, int H, int W, int dil, int act, int bf16,
                 void* stream) {
  if (B < 1 || H < 1 || W < 1 || dil < 1 || ca < CIN_STEP ||
      ca % CIN_STEP || cb < 0 || cb % CIN_STEP || act < ACT_NONE ||
      act > ACT_TANH || cout < 1 || nc % 8 || (cout + 7) / 8 * 8 % nc)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* bs = (const float*)bias;
#define LLIE_CONV_CASE(NC)                                                  \
  case NC:                                                                  \
    return launch<NC>(bf16, xa, ca, xb, cb, w, bs, out, cout, B, H, W, dil, \
                      act, s);
  switch (nc) {
    LLIE_CONV_CASE(8)
    LLIE_CONV_CASE(16)
    LLIE_CONV_CASE(24)
    LLIE_CONV_CASE(32)
    LLIE_CONV_CASE(40)
    LLIE_CONV_CASE(48)
    LLIE_CONV_CASE(56)
    LLIE_CONV_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LLIE_CONV_CASE
}

}  // extern "C"
