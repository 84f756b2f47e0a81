// The batch-tiled fused train step with bf16 operands (K6 bf16): the
// __nv_bfloat16 instantiation of train_step.cuh, whose products run on the
// tensor cores (mma.sync m16n8k16, fp32 accumulation).
#include "train_step.cuh"

namespace mmnm_ts {
int run_bf16(void* const* ptrs, const Dims& d, cudaStream_t stream) {
  return run<__nv_bfloat16>(ptrs, d, stream);
}
}  // namespace mmnm_ts
