// The guided tails of K1, K3 and K4 (fused_guided.cuh): K1's kernels, and
// the C entry points of all three families, bound to PyTorch through ctypes
// (kernels/fused_enhance.py). K3's kernels (with K1's gain form) are
// guided_curve.cu's, K4's guided_ema.cu's.
#include "fused_guided.cuh"

namespace llie {

LLIE_GUIDED_FAMILY(FG_RETINEX, retinex)

// The kernel of a family (K1's gain form: K3's), radius and guide.
const void* guided_kernel(int family, int radius, bool joint) {
  switch (kernel_family(family)) {
    case FG_RETINEX: return guided_kernel_retinex(radius, joint);
    case FG_CURVE: return guided_kernel_curve(radius, joint);
    case FG_EMA: return guided_kernel_ema(radius, joint);
    default: return nullptr;
  }
}

// The floats of a launch of a family at a radius and guide, with the blur
// on the tile at radius rb (0 for none).
int guided_floats(int family, int radius, bool joint, int rb) {
  const int f = kernel_family(family);
  switch (radius) {
#define LLIE_GUIDED_CASE(R) \
  case R:                   \
    return launch_floats<R>(f, joint, rb);
    LLIE_GUIDED_CASE(1)
    LLIE_GUIDED_CASE(2)
    LLIE_GUIDED_CASE(3)
    LLIE_GUIDED_CASE(4)
    LLIE_GUIDED_CASE(5)
    LLIE_GUIDED_CASE(6)
    LLIE_GUIDED_CASE(7)
    LLIE_GUIDED_CASE(8)
#undef LLIE_GUIDED_CASE
    default:
      return -1;
  }
}

}  // namespace llie

using namespace llie;

extern "C" {

// The guided tail of K1, K1's gain form, K3 or K4 (a->family), as
// FusedGuidedArgs describes it. Returns cudaGetLastError() after the
// launch (0 when it was accepted); a form no kernel takes is refused.
int llie_fused_guided(const FusedGuidedArgs* a, void* stream) {
  if (a->B < 1 || a->H < 1 || a->W < 1 || a->family < FG_RETINEX ||
      a->family > FG_EMA)
    return (int)cudaErrorInvalidValue;
  if (a->family != FG_RETINEX && (a->rows < 1 || a->halo < a->m))
    return (int)cudaErrorInvalidValue;
  if (a->family == FG_EMA && (a->m < 1 || a->H <= 2 * a->m || !a->carry ||
                              !a->ncarry))
    return (int)cudaErrorInvalidValue;
  if (a->boost < BOOST_NONE || a->boost > BOOST_CANVAS ||
      (a->boost && a->family != FG_CURVE))
    return (int)cudaErrorInvalidValue;
  if (a->family == FG_GAIN && (!a->gain || a->n_iter != 0 || a->boost))
    return (int)cudaErrorInvalidValue;
  if (a->family == FG_CURVE &&
      ((a->ds != 1 && a->ds != 2 && a->ds != 4) || a->H % a->ds ||
       a->W % a->ds || a->n_iter < 0 || (a->n_iter > 0 && !a->maps) ||
       (a->boost && a->gain)))
    return (int)cudaErrorInvalidValue;
  if (a->bp.radius > MAX_BLUR_RADIUS || a->gp.radius < 1 ||
      a->gp.radius > MAX_GUIDED_RADIUS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kernel_family(a->family)) {
    case FG_RETINEX: return launch_guided_retinex(*a, st);
    case FG_CURVE: return launch_guided_curve(*a, st);
    default: return launch_guided_ema(*a, st);
  }
}

// sizeof(FusedGuidedArgs), for the binding's check of its mirror.
int llie_fused_guided_args_size() { return (int)sizeof(FusedGuidedArgs); }

// The guided kernel of a family (FG_*), radius and guide (`joint`) on the
// device current now, at the blur radius 2 on the tile (hybrid's boost for
// K3): `what` 0 its registers a thread, 1 its local memory a thread in
// bytes (stack and spills), 2 its dynamic shared memory in bytes, 3 the
// blocks an SM at that shared memory (the occupancy API), 4 the blocks an
// SM it is built for (GuidedGeom::BLOCKS), 5 the floats of guided_tile's
// planes, 6 the floats before the staging's scratch. -1 for an argument out
// of range.
int llie_fused_guided_plan(int family, int radius, int joint, int what) {
  if (family < FG_RETINEX || family > FG_EMA || radius < 1 ||
      radius > MAX_GUIDED_RADIUS)
    return -1;
  const void* kern = guided_kernel(family, radius, joint != 0);
  const int smem = (int)sizeof(float)
                   * guided_floats(family, radius, joint != 0,
                                   family == FG_GAIN ? 0 : 2);
  switch (what) {
    case 0:
    case 1: {
      cudaFuncAttributes fa;
      if (cudaFuncGetAttributes(&fa, kern) != cudaSuccess) return -1;
      return what == 0 ? fa.numRegs : (int)fa.localSizeBytes;
    }
    case 2: return smem;
    case 3: {
      if (cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem) != cudaSuccess)
        return -1;
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, kern, GUIDED_THREADS, smem) != cudaSuccess)
        return -1;
      return n;
    }
    case 4:
    case 5:
    case 6:
      switch (radius) {
#define LLIE_GUIDED_CASE(R)                                          \
  case R:                                                            \
    return what == 4 ? GuidedGeom<R>::BLOCKS(joint != 0)             \
           : what == 5 ? GuidedGeom<R>::floats(joint != 0)           \
                       : GuidedGeom<R>::scratch(joint != 0);
        LLIE_GUIDED_CASE(1)
        LLIE_GUIDED_CASE(2)
        LLIE_GUIDED_CASE(3)
        LLIE_GUIDED_CASE(4)
        LLIE_GUIDED_CASE(5)
        LLIE_GUIDED_CASE(6)
        LLIE_GUIDED_CASE(7)
        LLIE_GUIDED_CASE(8)
#undef LLIE_GUIDED_CASE
      }
      return -1;
    default:
      return -1;
  }
}

}  // extern "C"
