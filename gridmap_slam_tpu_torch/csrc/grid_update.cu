// Dense occupancy-grid update (kernel K2).
//
// Replaces gridmap_slam_tpu/ops/pallas/grid_update.py::integrate_scan_pallas
// (kernel _update_kernel).  For each particle and cell: range and bearing of
// the cell center from the pose; the nearest beam for that bearing from a
// per-scan table of n_bins (dist, angle, code) entries, one table for each
// of G groups of particles (one scan for all, or one a robot or a closure
// candidate); the ray-footprint test
// |r sin dphi| <= 0.5005 (|cos| + |sin|)(theta + alpha) res with cos dphi > 0,
// or with cone_fill only cos dphi > 0 (the beam's whole wedge);
// l_free before the return and l_occ within +-tol of it; and
// out = logodds + keep * delta.  Same result as ops/raycast.integrate_scan.
//
// Bound on the H100: the special functions (one atan2f and four sin/cos
// pairs a cell) more than memory, which moves 8 bytes a cell.  Design: one
// thread per (particle, cell), the 24 KB of tables read through the
// read-only cache; the grid's z index is the table group, so a thread
// finds its table without an integer division.  atan2f and the atan2(sin, cos) wrap are those of the
// plain version; the TPU kernel's polynomial atan2 and floor-based wrap
// existed only because Mosaic has no atan2.  Any H x W: no tile padding.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
grid_update_kernel(const float* __restrict__ lo, float* __restrict__ out,
                   const float* __restrict__ poses,
                   const float* __restrict__ keep_ptr,
                   const float* __restrict__ bin_dist,
                   const float* __restrict__ bin_alpha,
                   const float* __restrict__ bin_code, int n_bins, int per_g,
                   int H, int W, float res, float origin_x, float origin_y,
                   float l_free, float l_occ, float tol_m, float bin_scale,
                   int cone_fill) {
  const int g = blockIdx.z, p = g * per_g + blockIdx.x;
  const int cell = blockIdx.y * blockDim.x + threadIdx.x;
  if (cell >= H * W) return;
  const int iy = cell / W, ix = cell % W;
  const float pose_x = poses[3 * p], pose_y = poses[3 * p + 1];
  const float theta = poses[3 * p + 2];

  const float cx = origin_x + (static_cast<float>(ix) + 0.5f) * res;
  const float cy = origin_y + (static_cast<float>(iy) + 0.5f) * res;
  const float dx = cx - pose_x, dy = cy - pose_y;
  const float r = sqrtf(dx * dx + dy * dy);
  const float phi = atan2f(dy, dx) - theta;   // bearing in the robot frame

  int b = static_cast<int>(floorf((gs::wrap_angle(phi) + gs::kPi) * bin_scale));
  b = min(max(b, 0), n_bins - 1);
  const size_t t = static_cast<size_t>(g) * n_bins + b;
  const float m = __ldg(bin_dist + t);
  const float alpha = __ldg(bin_alpha + t);
  const float code = __ldg(bin_code + t);   // 0 invalid, 1 hit, 2 miss

  const float dphi = gs::wrap_angle(phi - alpha);
  const float wba = theta + alpha;
  const float halfw = 0.5005f * (fabsf(cosf(wba)) + fabsf(sinf(wba))) * res;
  const float perp = r * sinf(dphi);
  const bool on_ray = (fabsf(perp) <= halfw || cone_fill) &&
                      cosf(dphi) > 0.f && code > 0.5f;

  float delta = 0.f;
  if (on_ray) {
    if (code < 1.5f) {                        // hit beam
      if (r < m - tol_m) {
        delta = l_free;
      } else if (r >= m - tol_m && r <= m + tol_m) {
        delta = l_occ;
      }
    } else if (r < m) {                       // no-return beam
      delta = l_free;
    }
  }
  const size_t idx = static_cast<size_t>(p) * H * W + cell;
  out[idx] = lo[idx] + *keep_ptr * delta;
}

}  // namespace

// lo, out: (P, H, W) float32; poses: (P, 3); keep: one float32 on the card
// (0 skips the update: the large-rotation rule); bin_*: (G, n_bins) tables
// of ops/cuda/grid_update.scan_bin_tables, G dividing P, G <= 65535;
// bin_scale = n_bins / (2 pi); cone_fill 0 or 1.
extern "C" int gs_grid_update(const float* lo, float* out, const float* poses,
                              const float* keep, const float* bin_dist,
                              const float* bin_alpha, const float* bin_code,
                              int n_bins, int G, int P, int H, int W,
                              float res, float origin_x, float origin_y,
                              float l_free, float l_occ, float tol_m,
                              float bin_scale, int cone_fill, void* stream) {
  if (P == 0 || H == 0 || W == 0) return cudaSuccess;
  if (G <= 0 || G > 65535 || P % G) return cudaErrorInvalidValue;
  const dim3 grid(P / G, (H * W + kThreads - 1) / kThreads, G);
  grid_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, out, poses, keep, bin_dist, bin_alpha, bin_code, n_bins, P / G, H, W,
      res, origin_x, origin_y, l_free, l_occ, tol_m, bin_scale, cone_fill);
  return static_cast<int>(cudaGetLastError());
}
