// Log-likelihood field build (kernel K3).
//
// Replaces gridmap_slam_tpu/ops/pallas/likelihood.py::
// log_likelihood_field_pallas (kernel _ll_kernel).  Per particle map:
// threshold the log-odds to {0, 1/2, 1} plus an evidence mask, blur both
// with the separable Gaussian (zero boundary), mark cells with no blurred
// evidence as unknown, and write log(z_hit * v + (1 - z_hit) / max_range)
// with v replaced by v_eq on unknown cells.  Same result as
// ops/grid.likelihood_field followed by ops/matcher.log_likelihood_field.
//
// Bound on the H100: device memory.  The map is read once and the field
// written once (8 bytes a cell); the two blurs are 4 * (2r + 1) flops a
// cell.  Design: one block per (particle, 32-row tile, 32-column tile).
// The block stages the tile plus its r-cell halo, thresholded, in shared
// memory, runs the horizontal pass over the halo rows into shared memory,
// then the vertical pass and the log epilogue straight to the output.  The
// column tiling keeps shared memory at 29 KB for any map width (the TPU
// kernel needed H % 8 == 0 and W % 128 == 0; this one takes any H x W).
// Taps are summed in tap order with no atomics, so runs are bit-stable.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kMaxRadius = 7;
constexpr int kSpan = kTile + 2 * kMaxRadius;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ll_field_kernel(const float* __restrict__ lo, float* __restrict__ out,
                const float* __restrict__ taps, int radius, int H, int W,
                float z_hit, float c_rand, float v_eq) {
  __shared__ float s_p[kSpan][kSpan];   // thresholded map, tile + halo
  __shared__ float s_e[kSpan][kSpan];   // evidence indicator
  __shared__ float h_p[kSpan][kTile];   // horizontal pass of s_p
  __shared__ float h_e[kSpan][kTile];
  __shared__ float s_taps[2 * kMaxRadius + 1];

  const int p = blockIdx.x;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.z * kTile;
  const int n_taps = 2 * radius + 1;
  const int span = kTile + 2 * radius;
  const float* map = lo + static_cast<size_t>(p) * H * W;
  float* dst = out + static_cast<size_t>(p) * H * W;

  if (threadIdx.x < n_taps) s_taps[threadIdx.x] = taps[threadIdx.x];
  // Cells outside the map read 0 in both images: the zero boundary of
  // ops/grid.blur_separable, for both passes.
  for (int i = threadIdx.x; i < span * span; i += blockDim.x) {
    const int ry = i / span, rx = i % span;
    const int y = y0 - radius + ry, x = x0 - radius + rx;
    float pv = 0.f, ev = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float l = map[static_cast<size_t>(y) * W + x];
      pv = l > 0.f ? 1.f : (l < 0.f ? 0.f : 0.5f);
      ev = fabsf(pv - 0.5f) > 0.25f ? 1.f : 0.f;
    }
    s_p[ry][rx] = pv;
    s_e[ry][rx] = ev;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < span * kTile; i += blockDim.x) {
    const int ry = i / kTile, cx = i % kTile;
    float ap = 0.f, ae = 0.f;
    for (int k = 0; k < n_taps; ++k) {
      ap += s_taps[k] * s_p[ry][cx + k];
      ae += s_taps[k] * s_e[ry][cx + k];
    }
    h_p[ry][cx] = ap;
    h_e[ry][cx] = ae;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int cy = i / kTile, cx = i % kTile;
    const int y = y0 + cy, x = x0 + cx;
    if (y >= H || x >= W) continue;
    float f = 0.f, e = 0.f;
    for (int k = 0; k < n_taps; ++k) {
      f += s_taps[k] * h_p[cy + k][cx];
      e += s_taps[k] * h_e[cy + k][cx];
    }
    const float v = e <= 0.f ? v_eq : f;
    dst[static_cast<size_t>(y) * W + x] = logf(z_hit * v + c_rand);
  }
}

}  // namespace

// lo, out: (P, H, W) float32; taps: (2 * radius + 1,) float32 on the card.
// c_rand = (1 - z_hit) / max_range; v_eq = the effective field value of an
// unknown cell (ops/matcher.effective_field).
extern "C" int gs_ll_field(const float* lo, float* out, const float* taps,
                           int radius, int P, int H, int W, float z_hit,
                           float c_rand, float v_eq, void* stream) {
  if (radius < 0 || radius > kMaxRadius) return cudaErrorInvalidValue;
  if (P == 0 || H == 0 || W == 0) return cudaSuccess;
  const dim3 grid(P, (H + kTile - 1) / kTile, (W + kTile - 1) / kTile);
  ll_field_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, out, taps, radius, H, W, z_hit, c_rand, v_eq);
  return static_cast<int>(cudaGetLastError());
}
