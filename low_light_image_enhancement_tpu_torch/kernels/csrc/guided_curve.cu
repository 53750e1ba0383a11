// The guided tails of K3 (curve / hybrid, maps at 1/1, 1/2 and 1/4, with or
// without the gain plane) and of K1's gain form (K3's kernel with the gain
// plane and no curve step): fused_guided.cuh's kernel, family FG_CURVE.
#include "fused_guided.cuh"

namespace llie {

LLIE_GUIDED_FAMILY(FG_CURVE, curve)

}  // namespace llie
