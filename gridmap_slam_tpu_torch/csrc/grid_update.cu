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
// Bound on the H100: instruction throughput, then memory (8 bytes a cell).  The
// plain version's formulas cost three atan2f and eight sinf/cosf a cell;
// here only two things need an angle, and the rest is a rotation:
//
//   - cos and sin of the particle's heading are taken once a block (a block
//     works one particle), and the cell's offset is turned into the robot
//     frame, xr = dx c + dy s, yr = dy c - dx s.  One atan2f(yr, xr) gives
//     the bearing already inside (-pi, pi], so no wrap is needed for the
//     bin;
//   - dphi = bearing - alpha enters only as sin and cos, which are the
//     components of (xr, yr) along and across the beam: with (ca, sa) =
//     sincosf(alpha) of the bin's beam, r cos dphi = xr ca + yr sa and
//     r sin dphi = yr ca - xr sa, and cos(theta + alpha), sin(theta + alpha)
//     of the footprint width are two FMAs each from c, s, ca, sa;
//   - the range r = sqrtf(dx dx + dy dy) stays on the unrotated offsets, so
//     the tests against the return see the plain version's bits, and they
//     come first: a cell at or past its beam's return (or whose bin has no
//     beam) takes no update whatever its footprint, so its sincosf and
//     footprint test are skipped.
//
// That is one sqrtf, one atan2f, at most one sincosf and about 25 FMAs a
// cell.  A cell whose center is the pose itself (r = 0) has no bearing; the
// plain version's atan2(0, 0) = 0 gives it the bearing -theta and a
// perpendicular distance of 0, and the kernel does the same (it takes
// (c, -s) for the direction and 0 for the distance there).
//
// Layout: a thread takes four cells of one row and moves them as one
// 128-bit word where the width and the base addresses divide by four
// (kVec) and the call has cells enough to fill the card that way, else one
// cell; the row comes from one integer division a thread.
// The 24 KB of tables are read through the read-only cache; the grid's z
// index is the table group, so a thread finds its table without a
// division.  Every cell is written by one thread from its own inputs: no
// atomics, results repeat bit for bit.  Rounding differs from the plain
// version's only where a cell sits within an ulp of a bin's or a ray's
// edge.  Any H x W: no tile padding.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Four cells a thread only while that leaves an SM this many blocks: one
// map of 412 x 412 is 166 such blocks, and ran in 0.0051 ms against 0.0031
// ms at one cell a thread (663 blocks).
constexpr int kMinBlocksPerSm = 4;

struct Params {
  int n_bins, per_g, H, W;
  float res, origin_x, origin_y, l_free, l_occ, tol_m, bin_scale;
  int cone_fill;
};

// The update of the cell at offset (dx, dy) from a pose of heading
// (c, s) = (cos, sin), read from the tables of the particle's group.
__device__ __forceinline__ float cell_delta(
    float dx, float dy, float c, float s, const float* __restrict__ bin_dist,
    const float* __restrict__ bin_alpha, const float* __restrict__ bin_code,
    const Params& k) {
  const float r = sqrtf(dx * dx + dy * dy);
  const bool at_pose = r == 0.f;
  const float xr = at_pose ? c : dx * c + dy * s;
  const float yr = at_pose ? -s : dy * c - dx * s;
  int b = static_cast<int>(floorf((atan2f(yr, xr) + gs::kPi) * k.bin_scale));
  b = min(max(b, 0), k.n_bins - 1);
  const float code = __ldg(bin_code + b);       // 0 invalid, 1 hit, 2 miss
  const float m = __ldg(bin_dist + b);

  float delta = 0.f;
  if (code > 0.5f) {
    if (code < 1.5f) {                          // hit beam
      if (r < m - k.tol_m) {
        delta = k.l_free;
      } else if (r >= m - k.tol_m && r <= m + k.tol_m) {
        delta = k.l_occ;
      }
    } else if (r < m) {                         // no-return beam
      delta = k.l_free;
    }
  }
  if (delta != 0.f) {
    float sa, ca;
    sincosf(__ldg(bin_alpha + b), &sa, &ca);
    const float along = xr * ca + yr * sa;              // r cos dphi
    const float perp = at_pose ? 0.f : yr * ca - xr * sa;   // r sin dphi
    const float halfw =
        0.5005f * (fabsf(c * ca - s * sa) + fabsf(s * ca + c * sa)) * k.res;
    const bool on_ray = (fabsf(perp) <= halfw || k.cone_fill) && along > 0.f;
    if (!on_ray) delta = 0.f;
  }
  return delta;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
grid_update_kernel(const float* __restrict__ lo, float* __restrict__ out,
                   const float* __restrict__ poses,
                   const float* __restrict__ keep_ptr,
                   const float* __restrict__ bin_dist,
                   const float* __restrict__ bin_alpha,
                   const float* __restrict__ bin_code, Params k) {
  constexpr int kCells = kVec ? 4 : 1;
  __shared__ float s_pose[4];                   // x, y, cos, sin
  const int g = blockIdx.z, p = g * k.per_g + blockIdx.x;
  if (threadIdx.x == 0) {
    s_pose[0] = poses[3 * p];
    s_pose[1] = poses[3 * p + 1];
    sincosf(poses[3 * p + 2], &s_pose[3], &s_pose[2]);
  }
  __syncthreads();
  const int per_row = k.W / kCells;
  const int item = blockIdx.y * kThreads + threadIdx.x;
  if (item >= k.H * per_row) return;
  const int iy = item / per_row, ix = (item - iy * per_row) * kCells;
  const float c = s_pose[2], s = s_pose[3];
  const float keep = *keep_ptr;
  const size_t t = static_cast<size_t>(g) * k.n_bins;   // the group's tables
  bin_dist += t;
  bin_alpha += t;
  bin_code += t;
  const size_t idx =
      (static_cast<size_t>(p) * k.H + iy) * k.W + ix;

  const float cy = k.origin_y + (static_cast<float>(iy) + 0.5f) * k.res;
  const float dy = cy - s_pose[1];
  if constexpr (kVec) {
    const float4 q = *reinterpret_cast<const float4*>(lo + idx);
    float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cx =
          k.origin_x + (static_cast<float>(ix + i) + 0.5f) * k.res;
      v[i] += keep * cell_delta(cx - s_pose[0], dy, c, s, bin_dist, bin_alpha,
                                bin_code, k);
    }
    *reinterpret_cast<float4*>(out + idx) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const float cx = k.origin_x + (static_cast<float>(ix) + 0.5f) * k.res;
    out[idx] = lo[idx] + keep * cell_delta(cx - s_pose[0], dy, c, s, bin_dist,
                                           bin_alpha, bin_code, k);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 1;
  }
  return n;
}

}  // namespace

// lo, out: (P, H, W) float32; poses: (P, 3); keep: one float32 on the card
// (0 skips the update: the large-rotation rule); bin_*: (G, n_bins) tables
// of ops/cuda/grid_update.scan_bin_tables, G dividing P, G <= 65535;
// bin_scale = n_bins / (2 pi); cone_fill 0 or 1.  Four cells a thread where
// W and both base addresses divide by four (16 bytes) and the grid still
// fills the card, else one.
extern "C" int gs_grid_update(const float* lo, float* out, const float* poses,
                              const float* keep, const float* bin_dist,
                              const float* bin_alpha, const float* bin_code,
                              int n_bins, int G, int P, int H, int W,
                              float res, float origin_x, float origin_y,
                              float l_free, float l_occ, float tol_m,
                              float bin_scale, int cone_fill, void* stream) {
  if (P == 0 || H == 0 || W == 0) return cudaSuccess;
  if (G <= 0 || G > 65535 || P % G) return cudaErrorInvalidValue;
  const Params k{n_bins, P / G, H, W, res, origin_x, origin_y, l_free,
                 l_occ, tol_m, bin_scale, cone_fill};
  const auto blocks_of = [&](int cells) {
    return (static_cast<long long>(H) * (W / cells) + kThreads - 1) / kThreads;
  };
  const bool vec = W % 4 == 0 &&
                   reinterpret_cast<size_t>(lo) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0 &&
                   blocks_of(4) * P >= kMinBlocksPerSm * sm_count();
  const long long blocks = blocks_of(vec ? 4 : 1);
  if (blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(P / G, static_cast<unsigned>(blocks), G);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    grid_update_kernel<true><<<grid, kThreads, 0, st>>>(
        lo, out, poses, keep, bin_dist, bin_alpha, bin_code, k);
  } else {
    grid_update_kernel<false><<<grid, kThreads, 0, st>>>(
        lo, out, poses, keep, bin_dist, bin_alpha, bin_code, k);
  }
  return static_cast<int>(cudaGetLastError());
}
