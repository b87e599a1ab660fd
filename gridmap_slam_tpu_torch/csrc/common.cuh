// Helpers shared by the kernels in this directory.
#pragma once

#include <cuda_runtime.h>

namespace gs {

// float32 rounding of pi, as the JAX package's `jnp.pi` enters f32 maths.
constexpr float kPi = 3.14159265358979323846f;

// (-pi, pi] wrap in the atan2(sin, cos) form of ops/geometry.wrap_angle.
__device__ __forceinline__ float wrap_angle(float a) {
  return atan2f(sinf(a), cosf(a));
}

}  // namespace gs
