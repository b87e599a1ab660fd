// Correlative scan-match stage scores (kernel K1).
//
// Replaces gridmap_slam_tpu/ops/pallas/matcher.py::stage_scores_pallas_batch
// (kernel _stage_kernel).  For each particle p and candidate (t, iy, ix):
// the sum over hit-and-valid beams of the bilinear (or nearest) sample of
// p's log-likelihood field at the beam endpoint rotated by
// pose0[p].theta + dts[p, t] and shifted by pose0[p].xy + (dxs[p, ix],
// dys[p, iy]).  Fields and scans are grouped: particle p reads field
// p / (P / G_f) of G_f and scan row p / (P / G_b) of G_b, so one shared map
// (G_f = 1), one map a particle (G_f = P, the RBPF) and one scan a robot or
// a closure candidate (G_b > 1) are the same kernel.  A tap outside the map
// reads v_outside = log(1 / max_range), corner by corner, as in
// ops/matcher._bilinear and _nearest (the gather path's semantics, not the
// TPU kernel's clipped 2-cell band).
//
// Bound on the H100: latency of the dependent field reads (4 a beam
// bilinear), not bandwidth: the field of one particle (58 KB at 120 x 120)
// stays in L1/L2 while its candidates are scored, and a field shared by
// every particle stays there for the whole launch.  Design: one block per
// (particle, theta candidate); the block rotates the scan once into shared
// memory, and each thread scores one (dy, dx) candidate, reading the field
// through the read-only cache.  Each thread sums its beams in beam order,
// with no atomics, so a fixed-seed run is bit-stable.  The TPU kernel's
// bucket sort, slot planes, lane rotates and 124-cell width limit worked
// around Mosaic's gathers and are not carried over.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float tap(const float* __restrict__ f, int x, int y,
                                     int H, int W, float v_outside) {
  return (x >= 0 && x < W && y >= 0 && y < H)
             ? __ldg(f + static_cast<size_t>(y) * W + x)
             : v_outside;
}

__global__ void stage_scores_kernel(
    const float* __restrict__ field, const float* __restrict__ px,
    const float* __restrict__ py, const unsigned char* __restrict__ use,
    const float* __restrict__ pose0, const float* __restrict__ dxs,
    const float* __restrict__ dys, const float* __restrict__ dts,
    float* __restrict__ out, int per_f, int per_b, int H, int W, int B, int nt,
    int ny, int nx, float res, float origin_x, float origin_y,
    float v_outside, int nearest) {
  extern __shared__ float smem[];
  float* s_rx = smem;            // (B,) rotated endpoints
  float* s_ry = smem + B;
  int* s_use = reinterpret_cast<int*>(smem + 2 * B);

  const int p = blockIdx.x, t = blockIdx.y;
  const float theta = pose0[3 * p + 2] + dts[p * nt + t];
  const float c = cosf(theta), s = sinf(theta);
  // this particle's scan row; the staging loop is then the one-scan loop
  const size_t row = static_cast<size_t>(p / per_b) * B;
  px += row;
  py += row;
  use += row;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    s_rx[b] = px[b] * c - py[b] * s;
    s_ry[b] = px[b] * s + py[b] * c;
    s_use[b] = use[b];
  }
  __syncthreads();

  const int cand = threadIdx.x;
  if (cand >= ny * nx) return;
  const int iy = cand / nx, ix = cand % nx;
  const float x0 = pose0[3 * p] + dxs[p * nx + ix];
  const float y0 = pose0[3 * p + 1] + dys[p * ny + iy];
  const float* f = field + static_cast<size_t>(p / per_f) * H * W;

  float acc = 0.f;
  // unrolled for more loads in flight; the adds stay in beam order
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    if (!s_use[b]) continue;
    const float fx = (s_rx[b] + x0 - origin_x) / res - 0.5f;
    const float fy = (s_ry[b] + y0 - origin_y) / res - 0.5f;
    float v;
    if (nearest) {
      v = tap(f, static_cast<int>(rintf(fx)), static_cast<int>(rintf(fy)), H,
              W, v_outside);
    } else {
      const float fx0 = floorf(fx), fy0 = floorf(fy);
      const float tx = fx - fx0, ty = fy - fy0;
      const int xi = static_cast<int>(fx0), yi = static_cast<int>(fy0);
      const float v00 = tap(f, xi, yi, H, W, v_outside);
      const float v10 = tap(f, xi + 1, yi, H, W, v_outside);
      const float v01 = tap(f, xi, yi + 1, H, W, v_outside);
      const float v11 = tap(f, xi + 1, yi + 1, H, W, v_outside);
      v = (1.f - tx) * (1.f - ty) * v00 + tx * (1.f - ty) * v10 +
          (1.f - tx) * ty * v01 + tx * ty * v11;
    }
    acc += v;
  }
  out[((static_cast<size_t>(p) * nt + t) * ny + iy) * nx + ix] = acc;
}

}  // namespace

// field: (G_f, H, W) float32; px, py: (G_b, B) float32 endpoints in the
// robot frame; use: (G_b, B) bool (hit & valid); pose0: (P, 3);
// dxs: (P, nx); dys: (P, ny); dts: (P, nt); out: (P, nt, ny, nx).
// G_f and G_b divide P; ny * nx <= 1024; P * max(nt, ny, nx) < 2^31 (the
// offsets are indexed in int, as the per-beam loop's registers allow).
extern "C" int gs_stage_scores(const float* field, const float* px,
                               const float* py, const unsigned char* use,
                               const float* pose0, const float* dxs,
                               const float* dys, const float* dts, float* out,
                               int P, int G_f, int G_b, int H, int W, int B,
                               int nt, int ny, int nx, float res,
                               float origin_x, float origin_y,
                               float v_outside, int nearest, void* stream) {
  if (ny * nx > 1024 || nt > 65535) return cudaErrorInvalidValue;
  if (P == 0 || nt == 0 || ny == 0 || nx == 0) return cudaSuccess;
  if (G_f <= 0 || G_b <= 0 || P % G_f || P % G_b) return cudaErrorInvalidValue;
  const long long n_max = nt > ny ? (nt > nx ? nt : nx) : (ny > nx ? ny : nx);
  if (static_cast<long long>(P) * n_max > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int threads = (ny * nx + 31) / 32 * 32;
  const size_t smem = 3 * static_cast<size_t>(B) * sizeof(float);
  stage_scores_kernel<<<dim3(P, nt), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      field, px, py, use, pose0, dxs, dys, dts, out, P / G_f, P / G_b, H, W, B,
      nt, ny, nx, res, origin_x, origin_y, v_outside, nearest);
  return static_cast<int>(cudaGetLastError());
}
