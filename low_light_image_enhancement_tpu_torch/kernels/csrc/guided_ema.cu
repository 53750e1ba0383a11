// The guided tail of K4 (the retinex video step): fused_guided.cuh's
// kernel, family FG_EMA.
#include "fused_guided.cuh"

namespace llie {

LLIE_GUIDED_FAMILY(FG_EMA, ema)

}  // namespace llie
