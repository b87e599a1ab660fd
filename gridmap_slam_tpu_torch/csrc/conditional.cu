// The kernel before a CUDA graph's conditional IF node: it sets the node's
// handle from a bool on the card, so that the body runs where the bool
// holds at that point of the replay (models/captured.cond, the
// counterpart of the JAX package's lax.cond).
#include <cuda_runtime.h>

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int gs_set_conditional(unsigned long long handle,
                                  const void* pred, cudaStream_t stream) {
  set_conditional_kernel<<<1, 1, 0, stream>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const bool*>(pred));
  return static_cast<int>(cudaGetLastError());
}
