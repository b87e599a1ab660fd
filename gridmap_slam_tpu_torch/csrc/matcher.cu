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
// Bound on the H100: operations.  A bilinear sample is 16 float operations
// (an FMA counted as two) and four taps; at 1M particles a scan takes
// ~3e10 samples against ~2 GB of output, so the FP32 rate bounds the call;
// at the RBPF's 500 particles the fields' bytes do (PERF.md gives the bound
// at every recorded shape).  The first design ran at 6-7 % of that bound:
// two IEEE divisions, four bounds tests, four read-only-cache gathers and
// four float-to-int conversions (a quarter-rate pipe) a sample, in blocks of
// one (particle, heading) with one thread a (dy, dx), which left fine-stage
// blocks of 25 live lanes.  This design:
//
// - The field lives in shared memory (variant kShared), staged with
//   cp.async and surrounded by a ring 2 cells wide of v_outside.  A corner
//   index is clamped into the ring (below -1 to -2, above W - 1 to W; a
//   corner left of the ring wraps to its right side, which reads the same
//   v_outside), so a tap needs no bounds test.  The row pitch is padded to
//   8 mod 16 floats, so the rows a warp's candidates touch fall on
//   different banks.  A field too large for one block (280 x 280 is
//   322 KB), or too small a share of the work to pay for staging, takes
//   the global variant: taps through the read-only cache behind one
//   unsigned compare an axis; everything else as below.
// - No division and no conversion in the beam loop: 1/res is folded into
//   the staged rotated endpoints (sx = rx / res) and into one constant a
//   candidate (cx = (pose0.x + dxs[ix] - origin_x) / res - 1, the cell
//   coordinate less one half), so a sample is fx = sx + cx; adding
//   1.5 * 2^23 rounds it to the nearest integer, which is the floor of the
//   cell coordinate, and the float's bits less the magic's bits are that
//   integer.
// - Whole warps of candidates: threads run over the units of a tile of `k`
//   (particle, heading) pairs; a unit is a run of up to kCw dx candidates
//   of one (pair, dy), which share the endpoint load and the y-axis work.
//   Each pair's rotated endpoints are staged once a tile, compacted to the
//   used beams by a warp ballot (beam order kept).  Work items are the
//   tiles of a field group (G_f groups in the shared variant, one in the
//   global one); `splits` blocks share a group's tiles in contiguous runs
//   and stage its field once each: at G_f = 1 a persistent grid of a few
//   blocks an SM, at G_f = P a block covers all headings of a particle.
//
// ops/cuda/matcher.launch_plan chooses the variant, k, kCw, splits, pitch
// and threads from the shapes alone.  Each candidate sums its beams in beam
// order in one thread with no atomics, so a fixed-seed run is bit-stable.
// CUDA C++ rather than Triton: the work is a data-dependent gather from a
// field held in shared memory, and Triton has no indexed 2-D gather from a
// tile in shared memory.
// The TPU kernel's bucket sort, slot planes, lane rotates and 124-cell
// width limit worked around Mosaic's gathers and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxRun = 5;             // dx candidates a thread, at most
constexpr int kRing = 2;
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23: x + kMagic rounds x
constexpr int kMagicBits = 0x4B400000;

struct Plan {
  int pitch;     // floats a staged field row (shared variant)
  int k;         // (particle, heading) pairs a tile
  int splits;    // blocks sharing one field group's tiles
  int ppg;       // pairs a field group
  int stride;    // float2 slots a staged pair (odd: no bank conflicts)
};

// Bytes of dynamic shared memory: the ringed field (shared variant), the
// staged endpoints of k pairs, and their used-beam counts.
size_t smem_bytes(bool shared, int H, int pitch, int k, int stride) {
  const size_t field =
      shared ? (static_cast<size_t>(H + 2 * kRing) * pitch * 4 + 15) / 16 * 16
             : 0;
  return field + static_cast<size_t>(k) * stride * 8 +
         static_cast<size_t>(k) * 4;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// The ring index (0 .. n + 2) of the cell holding the rounded coordinate r
// (= x + kMagic): the cell's index plus kRing, clamped so that a cell off
// either side lands on the ring's last cell.
__device__ __forceinline__ int ring_index(float r, int n) {
  return static_cast<int>(
      min(static_cast<unsigned>(__float_as_int(r)) -
              static_cast<unsigned>(kMagicBits - kRing),
          static_cast<unsigned>(n + kRing)));
}

// A tap of the global variant at ring indices (xr, yr): v_outside off the
// map.
__device__ __forceinline__ float tap(const float* __restrict__ f, int xr,
                                     int yr, int H, int W, float v_outside) {
  const int x = xr - kRing, y = yr - kRing;
  return static_cast<unsigned>(x) < static_cast<unsigned>(W) &&
                 static_cast<unsigned>(y) < static_cast<unsigned>(H)
             ? __ldg(f + static_cast<size_t>(y) * W + x)
             : v_outside;
}

// Runs of 1 to 3 are held to 64 registers a thread (four blocks of 256 an
// SM), which measured faster; runs of 4 and 5 keep their accumulators in
// more registers, which measured faster for them.
template <bool kShared, bool kNearest, int kCw>
__global__ void __launch_bounds__(kMaxThreads, kCw <= 3 ? 4 : 1)
    stage_scores_kernel(
    const float* __restrict__ field, const float* __restrict__ px,
    const float* __restrict__ py, const unsigned char* __restrict__ use,
    const float* __restrict__ pose0, const float* __restrict__ dxs,
    const float* __restrict__ dys, const float* __restrict__ dts,
    float* __restrict__ out, int per_f, int per_b, int H, int W, int B,
    int nt, int ny, int nx, float inv_res, float origin_x, float origin_y,
    float v_outside, Plan plan) {
  extern __shared__ float4 smem4[];
  float* s_field = reinterpret_cast<float*>(smem4);
  const size_t field_floats =
      kShared ? (static_cast<size_t>(H + 2 * kRing) * plan.pitch + 3) / 4 * 4
              : 0;
  float2* s_xy = reinterpret_cast<float2*>(s_field + field_floats);
  int* s_n = reinterpret_cast<int*>(s_xy + static_cast<size_t>(plan.k) *
                                               plan.stride);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int runs = (nx + kCw - 1) / kCw;     // dx runs a row
  const int units = ny * runs;               // units a pair
  const int pitch = plan.pitch;
  const int g = blockIdx.x / plan.splits;
  const int part = blockIdx.x - g * plan.splits;
  const long long tiles = (plan.ppg + plan.k - 1) / plan.k;
  const long long t_begin = part * tiles / plan.splits;
  const long long t_end = (part + 1) * tiles / plan.splits;
  // cell coordinate less one half (bilinear: its rounding is the floor)
  const float c_off = kNearest ? 0.5f : 1.0f;

  if (kShared) {  // group g's field and its ring, once a block
    const float* f = field + static_cast<size_t>(g) * H * W;
    for (int r = warp; r < H + 2 * kRing; r += n_warps) {
      const int y = r - kRing;
      float* row = s_field + static_cast<size_t>(r) * pitch;
      for (int c = lane; c < W + 2 * kRing; c += 32) {
        const int x = c - kRing;
        if (y >= 0 && y < H && x >= 0 && x < W) {
          cp_async4(row + c, f + static_cast<size_t>(y) * W + x);
        } else {
          row[c] = v_outside;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }

  for (long long t = t_begin; t < t_end; ++t) {
    const int q0 = g * plan.ppg + static_cast<int>(t) * plan.k;
    const int n = min(plan.k, g * plan.ppg + plan.ppg - q0);

    // each pair's rotated endpoints in cells, used beams only, in order
    for (int s = warp; s < n; s += n_warps) {
      const int q = q0 + s, p = q / nt;
      float sn, cs;
      sincosf(pose0[3 * p + 2] + dts[q], &sn, &cs);
      const size_t row = static_cast<size_t>(p / per_b) * B;
      float2* dst = s_xy + static_cast<size_t>(s) * plan.stride;
      int used = 0;
      for (int b0 = 0; b0 < B; b0 += 32) {
        const int b = b0 + lane;
        const bool u = b < B && use[row + b];
        const unsigned m = __ballot_sync(0xffffffffu, u);
        if (u) {
          const float x = px[row + b], y = py[row + b];
          dst[used + __popc(m & ((1u << lane) - 1u))] = make_float2(
              (x * cs - y * sn) * inv_res, (x * sn + y * cs) * inv_res);
        }
        used += __popc(m);
      }
      if (lane == 0) s_n[s] = used;
    }
    __syncthreads();

    for (int j = threadIdx.x; j < n * units; j += blockDim.x) {
      const int s = j / units, unit = j - s * units;
      const int iy = unit / runs, ix0 = (unit - iy * runs) * kCw;
      const int q = q0 + s, p = q / nt;
      const float cy =
          (pose0[3 * p + 1] + dys[static_cast<size_t>(p) * ny + iy] -
           origin_y) * inv_res - c_off;
      float cx[kCw], acc[kCw];
#pragma unroll
      for (int i = 0; i < kCw; ++i) {   // a short last run repeats its end
        cx[i] = (pose0[3 * p] +
                 dxs[static_cast<size_t>(p) * nx + min(ix0 + i, nx - 1)] -
                 origin_x) * inv_res - c_off;
        acc[i] = 0.f;
      }
      const float* f =
          kShared ? s_field : field + static_cast<size_t>(p / per_f) * H * W;
      const float2* xy = s_xy + static_cast<size_t>(s) * plan.stride;
      const int used = s_n[s];
      // the adds stay in beam order, one sum a candidate
#pragma unroll 2
      for (int b = 0; b < used; ++b) {
        const float2 e = xy[b];
        const float fy = e.y + cy;
        const float ry = fy + kMagic;
        const int yr = ring_index(ry, H);
        const float ty = fy - (ry - kMagic) + 0.5f;
        const float* row = f + yr * pitch;
#pragma unroll
        for (int i = 0; i < kCw; ++i) {
          const float fx = e.x + cx[i];
          const float rx = fx + kMagic;
          const int xr = ring_index(rx, W);
          float v;
          if (kNearest) {
            v = kShared ? row[xr] : tap(f, xr, yr, H, W, v_outside);
          } else {
            const float tx = fx - (rx - kMagic) + 0.5f;
            float v00, v10, v01, v11;
            if (kShared) {
              v00 = row[xr];
              v10 = row[xr + 1];
              v01 = row[xr + pitch];
              v11 = row[xr + pitch + 1];
            } else {
              v00 = tap(f, xr, yr, H, W, v_outside);
              v10 = tap(f, xr + 1, yr, H, W, v_outside);
              v01 = tap(f, xr, yr + 1, H, W, v_outside);
              v11 = tap(f, xr + 1, yr + 1, H, W, v_outside);
            }
            const float a = v00 + tx * (v10 - v00);
            const float c = v01 + tx * (v11 - v01);
            v = a + ty * (c - a);
          }
          acc[i] += v;
        }
      }
      float* o = out + (static_cast<size_t>(q) * ny + iy) * nx + ix0;
#pragma unroll
      for (int i = 0; i < kCw; ++i)
        if (ix0 + i < nx) o[i] = acc[i];
    }
    __syncthreads();
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const unsigned char*, const float*, const float*,
                        const float*, const float*, float*, int, int, int, int,
                        int, int, int, int, float, float, float, float, Plan);

template <bool kShared, bool kNearest>
Kernel kernel_for_run(int run) {
  switch (run) {
    case 1: return stage_scores_kernel<kShared, kNearest, 1>;
    case 2: return stage_scores_kernel<kShared, kNearest, 2>;
    case 3: return stage_scores_kernel<kShared, kNearest, 3>;
    case 4: return stage_scores_kernel<kShared, kNearest, 4>;
    default: return stage_scores_kernel<kShared, kNearest, 5>;
  }
}

Kernel kernel_for(bool shared, bool nearest, int run) {
  if (shared)
    return nearest ? kernel_for_run<true, true>(run)
                   : kernel_for_run<true, false>(run);
  return nearest ? kernel_for_run<false, true>(run)
                 : kernel_for_run<false, false>(run);
}

}  // namespace

// field: (G_f, H, W) float32; px, py: (G_b, B) float32 endpoints in the
// robot frame; use: (G_b, B) bool (hit & valid); pose0: (P, 3);
// dxs: (P, nx); dys: (P, ny); dts: (P, nt); out: (P, nt, ny, nx).
// G_f and G_b divide P; P * max(nt, ny, nx) < 2^31; H, W < 2^22.  The
// launch plan (ops/cuda/matcher.launch_plan): shared (the variant),
// pitch, k pairs a tile, run (dx candidates a thread, 1 to 5), splits
// blocks a field group, threads a block, and smem, the dynamic shared
// memory it needs; a plan that does not fit the shapes is refused with
// cudaErrorInvalidValue.
extern "C" int gs_stage_scores(const float* field, const float* px,
                               const float* py, const unsigned char* use,
                               const float* pose0, const float* dxs,
                               const float* dys, const float* dts, float* out,
                               int P, int G_f, int G_b, int H, int W, int B,
                               int nt, int ny, int nx, float res,
                               float origin_x, float origin_y,
                               float v_outside, int nearest, int shared,
                               int pitch, int k, int run, int splits,
                               int threads, int smem, void* stream) {
  if (P == 0 || nt == 0 || ny == 0 || nx == 0) return cudaSuccess;
  if (G_f <= 0 || G_b <= 0 || P % G_f || P % G_b || B < 0 || H <= 0 ||
      W <= 0 || H >= (1 << 22) || W >= (1 << 22))
    return cudaErrorInvalidValue;
  const long long n_max = nt > ny ? (nt > nx ? nt : nx) : (ny > nx ? ny : nx);
  if (static_cast<long long>(P) * n_max > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int groups = shared ? G_f : 1;
  Plan plan{shared ? pitch : 0, k, splits, P / groups * nt, B | 1};
  if (k < 1 || run < 1 || run > kMaxRun || splits < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 ||
      (shared && pitch < W + 2 * kRing) ||
      static_cast<long long>(groups) * splits > 0x7fffffffLL ||
      splits > (plan.ppg + k - 1) / k ||
      static_cast<size_t>(smem) < smem_bytes(shared, H, pitch, k, plan.stride))
    return cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(shared, nearest, run);
  // the opt-in above 48 KB, raised only when a launch needs more than was
  // set on this device before
  constexpr int kDevices = 64;
  static int opted_in[kDevices][2][2][kMaxRun];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kDevices)
    return cudaErrorInvalidDevice;
  int& limit = opted_in[dev][shared ? 1 : 0][nearest ? 1 : 0][run - 1];
  if (smem > kDefaultSmem && smem > limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit = smem;
  }
  kernel<<<groups * splits, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      field, px, py, use, pose0, dxs, dys, dts, out, P / G_f, P / G_b, H, W,
      B, nt, ny, nx, 1.0f / res, origin_x, origin_y, v_outside, plan);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, the shared memory one block may opt in
// to, and the shared memory of one SM (what launch_plan sizes a grid by).
extern "C" int gs_device_limits(int* sm_count, int* smem_block,
                                int* smem_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  return static_cast<int>(err);
}
