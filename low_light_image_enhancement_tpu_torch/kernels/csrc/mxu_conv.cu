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
// 128-lane matrix unit at 24-32 channels; it has no use here, and this
// kernel takes unpacked NHWC.
//
// What bounds it. At the nets' widths a layer does 2 * 9 * Cin * Cout
// operations a pixel (36,864 at 64 -> 32, 18,432 at 32 -> 32, 10,368 at
// 24 -> 24) on 2 * (Cin + Cout) bytes of bf16 in and out: 108 to 192
// operations a byte, below the ~295 at which the bf16 tensor cores (989
// TFLOP/s) rather than device memory (3.35 TB/s) would set the pace, so a
// layer's bound is its bytes. This kernel multiplies and adds on the CUDA
// cores in f32 (67 TFLOP/s), where the operations alone need 5-10x that
// bound even at the peak rate.
//
// What the design does about it (conv3x3.cuh). Right and simple first: one
// thread per 2 pixels and all output channels, so each weight read from
// shared memory (a float4 broadcast) feeds 8 fused multiply-adds and each
// input value 24-32; weights stay in shared memory for the whole
// persistent grid. The concat of skip connections is never built: the
// second input tensor is read in place. The tensor cores (wgmma on bf16
// tiles) are the redesign for a later PR.
#include "conv3x3.cuh"

using namespace llie::conv;

namespace {

template <typename T, int COUT>
__global__ void __launch_bounds__(CONV_THREADS)
conv3x3_kernel(const T* xa, int ca, const T* xb, int cb, const float* w,
               const float* bias, T* out, int B, int H, int W, int dil,
               int act) {
  extern __shared__ float sw[];
  conv3x3_layer<T, COUT, false>(xa, ca, xb, cb, w, bias, out, B, H, W, dil,
                                act, sw);
}

template <typename T, int COUT>
int launch(const void* xa, int ca, const void* xb, int cb, const float* w,
           const float* bias, void* out, int B, int H, int W, int dil,
           int act, cudaStream_t stream) {
  const void* kern = (const void*)conv3x3_kernel<T, COUT>;
  const int smem = (int)sizeof(float) * layer_smem_floats(ca + cb, COUT);
  int grid = 0;
  const int rc = persistent_grid(kern, smem, (long long)B * H * W, &grid);
  if (rc != 0) return rc;
  conv3x3_kernel<T, COUT><<<grid, CONV_THREADS, smem, stream>>>(
      (const T*)xa, ca, (const T*)xb, cb, w, bias, (T*)out, B, H, W, dil,
      act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cout(int cout, const void* xa, int ca, const void* xb, int cb,
                const float* w, const float* bias, void* out, int B, int H,
                int W, int dil, int act, cudaStream_t stream) {
  switch (cout) {
    case 8:
      return launch<T, 8>(xa, ca, xb, cb, w, bias, out, B, H, W, dil, act,
                          stream);
    case 16:
      return launch<T, 16>(xa, ca, xb, cb, w, bias, out, B, H, W, dil, act,
                           stream);
    case 24:
      return launch<T, 24>(xa, ca, xb, cb, w, bias, out, B, H, W, dil, act,
                           stream);
    case 32:
      return launch<T, 32>(xa, ca, xb, cb, w, bias, out, B, H, W, dil, act,
                           stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// NHWC (B, H, W, ca) [+ (B, H, W, cb)] -> (B, H, W, cout), all bf16 (`bf16`
// 1) or all f32; w is the packed f32 (9, ca + cb, cout), bias f32 (cout).
// ca, cb multiples of 8 (cb may be 0, xb then unused), cout one of 8, 16,
// 24, 32, dil >= 1, act an Act. Returns cudaGetLastError() after the
// launch (0 when it was accepted).
int llie_conv3x3(const void* xa, int ca, const void* xb, int cb,
                 const void* w, const void* bias, void* out, int cout, int B,
                 int H, int W, int dil, int act, int bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1 || dil < 1 || ca < CIN_STEP ||
      ca % CIN_STEP || cb < 0 || cb % CIN_STEP || act < ACT_NONE ||
      act > ACT_TANH)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_cout<__nv_bfloat16>(cout, xa, ca, xb, cb, (const float*)w,
                                      (const float*)bias, out, B, H, W, dil,
                                      act, s);
  return launch_cout<float>(cout, xa, ca, xb, cb, (const float*)w,
                            (const float*)bias, out, B, H, W, dil, act, s);
}

}  // extern "C"
