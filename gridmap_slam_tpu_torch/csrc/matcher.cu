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
// - The nearest branch (kNearest) does not fold: a tap within an ulp of a
//   half cell would round to either neighbour depending on the float order,
//   and with the coarse stage's cell-aligned offsets one such tap moves a
//   whole block of candidates.  It computes the coordinate in the order XLA
//   compiles the JAX package's _stage_scores into (gridmap_slam_tpu/ops/
//   matcher.py:117-128), which the plain version (ops/cuda/matcher.
//   cell_coords) computes on either device: the staged endpoint is
//   (rx, ry) = (fma(x, c, -(y s)), fma(x, s, y c)) in metres, a candidate
//   holds h = pose0.x + dxs[ix], and a sample is fx = fma((rx + h) -
//   origin_x, 1/res, -0.5), each operation an intrinsic rounded as written
//   so that ptxas contracts nothing else; then the same magic rounding,
//   which rounds half to even as jnp.round does.  That is two operations an
//   axis more than the fold.
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
//
// The tile variant scores one column tile of a map that is split over
// several ranks: the field is the tile extended by `ext` columns each side
// (the world-edge columns hold v_outside), and the partial scores of the
// tiles sum to the whole map's.  Its arithmetic is the JAX package's XLA
// function gridmap_slam_tpu/parallel/tiled.py::_stage_scores_tiled.  A
// beam's base column x0 is the same magic-number rounding of the GLOBAL
// cell coordinate as above, so every tile computes the same x0 for a beam;
// the beam adds to the sum only on the tile that owns x0 (clip(x0 / w_loc,
// 0, n_m - 1) == j: two integer compares, out-of-world beams owned by the
// edge tiles), and its taps are read at x0 less the tile's first extended
// column.  A tile small enough to stage takes the shared variant above
// (kTiled, the sharded RBPF's per-particle tiles); the untiled
// instantiations do not change.
//
// A tile too large to stage (the city map's 4000 x 4002 cells, 64 MB) takes
// stage_scores_tile_kernel (gs_stage_scores_tile_staged).  Bound on the
// H100: operations.  A call reads only the cells its taps land on
// (chip_smoke.k1t_bound counts them: on the synthetic log's 6 x 6 m room
// 2-13 thousand cells, 8-50 KB, not the tile's 64 MB); its samples (coarse
// 45 used beams x 500 x 891 candidates, fine and refine 180 x 500 x 125)
// at 16 operations take 4.8 / 2.7 / 2.7 us at the FP32 peak.  The earlier
// design, stage_scores_kernel's global-field instantiation run on the tile,
// reached 0.03-0.06 of that: at 500 particles the fine stage is 179 blocks
// of candidates, each walking 180 beams with four bounds-tested gathers
// through the cache a beam, so the card has few warps and the load pipe is
// full of scattered gathers.  This design:
//
// - One block an SM, 24 warps, over a contiguous run of the (particle,
//   heading) pairs; a warp a pair (more where its units exceed 32), a lane
//   a unit of kCw dx candidates of one dy.
// - A pass over the block's pairs finds the box their taps reach.  The
//   magic-number rounding is monotone, and so is the nearest branch's
//   coordinate in a candidate's part (each of its roundings is), so a
//   beam's candidates have their base cells between those of the endpoint
//   at the warp's smallest and largest cx (and cy); the box runs from the
//   smallest of those to the largest plus one cell, sized on the card from
//   the offsets the call holds, so the launch needs no bound on their
//   spread.
// - Where the box fits the block's shared memory (~190 KB, 200 x 200 cells
//   and more; the synthetic room's is some 130 x 130) the block stages it
//   once with cp.async, rows padded to 9 mod 32 floats so that a warp's
//   taps fall on distinct banks, and every candidate reads its taps there.
//   Else (far-apart particles in one block, or scans of 10 m reach, some
//   400 x 400 cells) its warps read the taps from the field through the
//   cache, as the earlier design did, with the block's warps and staged
//   endpoints.  `paths`, where given, counts the blocks of each kind.
// - The pass's endpoints of a warp's last pair stay staged; the second
//   pass takes the pairs in the other order and starts with it.
// - Each candidate still sums its beams in beam order in one thread, with
//   the arithmetic of stage_scores_kernel (the endpoint loop written as
//   there: ptxas then fuses the same products), so its score has the bits
//   of the earlier design's and, on one tile, of the untiled K1's.
// The launch (ops/cuda/matcher.tile_launch_plan) depends on the shapes
// alone, so it is the same in every replay of a CUDA graph.

#include <cuda_runtime.h>

#include <climits>

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

// A column tile of the map (tile variant only): local column = global
// column - shift; a beam whose base column x0 has lo <= x0 < hi is this
// tile's.
struct Tile {
  int shift, lo, hi;
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

// The heading's sine and cosine, as torch.sin and torch.cos give them on the
// card (gs_k1_rotation lets a check compare the bits).
__device__ __forceinline__ void rotation(float theta, float* sn, float* cs) {
  sincosf(theta, sn, cs);
}

// The nearest branch's staged endpoint: the beam rotated by the heading, in
// metres, in the JAX package's compiled order (see the note at the top).
__device__ __forceinline__ float2 nearest_endpoint(float x, float y, float cs,
                                                   float sn) {
  return make_float2(__fmaf_rn(x, cs, -__fmul_rn(y, sn)),
                     __fmaf_rn(x, sn, __fmul_rn(y, cs)));
}

// A sample's coordinate on one axis from its staged endpoint part e and its
// candidate's part c: the bilinear branch's sum, or the nearest branch's
// cell coordinate fma((e + c) - origin, inv_res, -0.5).
template <bool kNearest>
__device__ __forceinline__ float sample_coord(float e, float c, float origin,
                                              float inv_res) {
  if constexpr (kNearest)
    return __fmaf_rn(__fsub_rn(__fadd_rn(e, c), origin), inv_res, -0.5f);
  else
    return e + c;
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
template <bool kShared, bool kNearest, int kCw, bool kTiled>
__global__ void __launch_bounds__(kMaxThreads, kCw <= 3 ? 4 : 1)
    stage_scores_kernel(
    const float* __restrict__ field, const float* __restrict__ px,
    const float* __restrict__ py, const unsigned char* __restrict__ use,
    const float* __restrict__ pose0, const float* __restrict__ dxs,
    const float* __restrict__ dys, const float* __restrict__ dts,
    float* __restrict__ out, int per_f, int per_b, int H, int W, int B,
    int nt, int ny, int nx, float inv_res, float origin_x, float origin_y,
    float v_outside, Plan plan, Tile tile) {
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
      rotation(pose0[3 * p + 2] + dts[q], &sn, &cs);
      const size_t row = static_cast<size_t>(p / per_b) * B;
      float2* dst = s_xy + static_cast<size_t>(s) * plan.stride;
      int used = 0;
      for (int b0 = 0; b0 < B; b0 += 32) {
        const int b = b0 + lane;
        const bool u = b < B && use[row + b];
        const unsigned m = __ballot_sync(0xffffffffu, u);
        if (u) {
          const float x = px[row + b], y = py[row + b];
          float2& slot = dst[used + __popc(m & ((1u << lane) - 1u))];
          if constexpr (kNearest)
            slot = nearest_endpoint(x, y, cs, sn);
          else
            slot = make_float2((x * cs - y * sn) * inv_res,
                               (x * sn + y * cs) * inv_res);
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
      // the candidates' parts of their coordinates: nearest, the pose plus
      // the offset; bilinear, that less the origin in cells, less one cell
      const float dy = dys[static_cast<size_t>(p) * ny + iy];
      const float cy = kNearest ? __fadd_rn(pose0[3 * p + 1], dy)
                                : (pose0[3 * p + 1] + dy - origin_y) *
                                          inv_res - 1.0f;
      float cx[kCw], acc[kCw];
#pragma unroll
      for (int i = 0; i < kCw; ++i) {   // a short last run repeats its end
        const float dx =
            dxs[static_cast<size_t>(p) * nx + min(ix0 + i, nx - 1)];
        cx[i] = kNearest ? __fadd_rn(pose0[3 * p], dx)
                         : (pose0[3 * p] + dx - origin_x) * inv_res - 1.0f;
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
        const float fy = sample_coord<kNearest>(e.y, cy, origin_y, inv_res);
        const float ry = fy + kMagic;
        const int yr = ring_index(ry, H);
        const float ty = fy - (ry - kMagic) + 0.5f;
        const float* row = f + yr * pitch;
#pragma unroll
        for (int i = 0; i < kCw; ++i) {
          const float fx = sample_coord<kNearest>(e.x, cx[i], origin_x,
                                                  inv_res);
          const float rx = fx + kMagic;
          int xr;
          bool own = true;
          if constexpr (kTiled) {
            const int x0 = __float_as_int(rx) - kMagicBits;  // global
            own = x0 >= tile.lo && x0 < tile.hi;
            xr = static_cast<int>(
                min(static_cast<unsigned>(x0 - tile.shift + kRing),
                    static_cast<unsigned>(W + kRing)));
          } else {
            xr = ring_index(rx, W);
          }
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
          if constexpr (kTiled) {
            acc[i] += own ? v : 0.f;
          } else {
            acc[i] += v;
          }
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
                        int, int, int, int, float, float, float, float, Plan,
                        Tile);

template <bool kShared, bool kNearest, bool kTiled>
Kernel kernel_for_run(int run) {
  switch (run) {
    case 1: return stage_scores_kernel<kShared, kNearest, 1, kTiled>;
    case 2: return stage_scores_kernel<kShared, kNearest, 2, kTiled>;
    case 3: return stage_scores_kernel<kShared, kNearest, 3, kTiled>;
    case 4: return stage_scores_kernel<kShared, kNearest, 4, kTiled>;
    default: return stage_scores_kernel<kShared, kNearest, 5, kTiled>;
  }
}

template <bool kTiled>
Kernel kernel_for(bool shared, bool nearest, int run) {
  if (shared)
    return nearest ? kernel_for_run<true, true, kTiled>(run)
                   : kernel_for_run<true, false, kTiled>(run);
  // a tile too large to stage runs stage_scores_tile_kernel instead
  if constexpr (kTiled)
    return nullptr;
  else
    return nearest ? kernel_for_run<false, true, kTiled>(run)
                   : kernel_for_run<false, false, kTiled>(run);
}

// Checks the shapes and the plan, opts in to the plan's shared memory and
// launches; `tiled` picks the tile variant.
int launch(const float* field, const float* px, const float* py,
           const unsigned char* use, const float* pose0, const float* dxs,
           const float* dys, const float* dts, float* out, int P, int G_f,
           int G_b, int H, int W, int B, int nt, int ny, int nx, float res,
           float origin_x, float origin_y, float v_outside, int nearest,
           int shared, int pitch, int k, int run, int splits, int threads,
           int smem, bool tiled, Tile tile, void* stream) {
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
  const Kernel kernel = tiled ? kernel_for<true>(shared, nearest, run)
                              : kernel_for<false>(shared, nearest, run);
  if (!kernel) return cudaErrorInvalidValue;
  // the opt-in above 48 KB, raised only when a launch needs more than was
  // set on this device before
  constexpr int kDevices = 64;
  static int opted_in[kDevices][2][2][2][kMaxRun];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kDevices)
    return cudaErrorInvalidDevice;
  int& limit = opted_in[dev][tiled ? 1 : 0][shared ? 1 : 0][nearest ? 1 : 0]
                       [run - 1];
  if (smem > kDefaultSmem && smem > limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit = smem;
  }
  kernel<<<groups * splits, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      field, px, py, use, pose0, dxs, dys, dts, out, P / G_f, P / G_b, H, W,
      B, nt, ny, nx, 1.0f / res, origin_x, origin_y, v_outside, plan, tile);
  return static_cast<int>(cudaGetLastError());
}


// The tile variant's kernel for tiles too large to stage (see the note at
// the top): a block stages the box its pairs' taps reach where that fits,
// else its warps read the taps from the field.
// Threads a block and blocks an SM (the registers are held to that): one
// box an SM, and 24 warps for the fine stage's 2500 pairs
constexpr int kStagedThreads = 768;
constexpr int kStagedBlocks = 1;

struct Staged {
  int units;        // units a pair: ny rows of ceil(nx / kCw) runs
  int unit_warps;   // warps a pair
  int ep_stride;    // float2 slots of a warp's staged endpoints (B | 1)
  int region;       // floats the block's box may take
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The base cell of cell coordinate v: the magic-number rounding above,
// monotone in v.
__device__ __forceinline__ int base_cell(float v) {
  return __float_as_int(v + kMagic) - kMagicBits;
}

// A field cell at local column x, row y: v_outside off the field.
__device__ __forceinline__ float field_cell(const float* __restrict__ f,
                                            int x, int y, int H, int W,
                                            float v_outside) {
  return static_cast<unsigned>(x) < static_cast<unsigned>(W) &&
                 static_cast<unsigned>(y) < static_cast<unsigned>(H)
             ? __ldg(f + static_cast<size_t>(y) * W + x)
             : v_outside;
}

// One warp's work item: a pair's units and lane `lane`'s candidates' cell
// coordinates.
template <bool kNearest, int kCw>
struct Item {
  int q, p, iy, ix0;
  bool active;
  float cy, cx[kCw];
  float origin_x, origin_y, inv_res;   // sample_coord's (nearest)

  __device__ __forceinline__ Item(long long item, int lane, const Staged& sg,
                                  const float* __restrict__ pose0,
                                  const float* __restrict__ dxs,
                                  const float* __restrict__ dys, int nt,
                                  int ny, int nx, float inv_res,
                                  float origin_x, float origin_y)
      : origin_x(origin_x), origin_y(origin_y), inv_res(inv_res) {
    q = static_cast<int>(item / sg.unit_warps);
    const int unit =
        static_cast<int>(item - static_cast<long long>(q) * sg.unit_warps) *
            32 + lane;
    p = q / nt;
    const int runs = (nx + kCw - 1) / kCw;
    active = unit < sg.units;
    const int u = active ? unit : sg.units - 1;  // an idle lane shadows one
    iy = u / runs;
    ix0 = (u - iy * runs) * kCw;
    // the candidates' parts of their coordinates, as stage_scores_kernel's
    const float dy = dys[static_cast<size_t>(p) * ny + iy];
    cy = kNearest ? __fadd_rn(pose0[3 * p + 1], dy)
                  : (pose0[3 * p + 1] + dy - origin_y) * inv_res - 1.0f;
#pragma unroll
    for (int i = 0; i < kCw; ++i) {
      const float dx = dxs[static_cast<size_t>(p) * nx + min(ix0 + i, nx - 1)];
      cx[i] = kNearest ? __fadd_rn(pose0[3 * p], dx)
                       : (pose0[3 * p] + dx - origin_x) * inv_res - 1.0f;
    }
  }
};

// The pair's rotated endpoints into s_xy (bilinear: in cells; nearest: in
// metres, nearest_endpoint), used beams only, in order; returns their
// count.
template <bool kNearest>
__device__ __forceinline__ int stage_endpoints(
    float2* s_xy, int lane, int p, int q, int per_b, int B,
    const float* __restrict__ px, const float* __restrict__ py,
    const unsigned char* __restrict__ use, const float* __restrict__ pose0,
    const float* __restrict__ dts, float inv_res) {
  float sn, cs;
  rotation(pose0[3 * p + 2] + dts[q], &sn, &cs);
  const size_t row = static_cast<size_t>(p / per_b) * B;
  int used = 0;
  // written as stage_scores_kernel writes it: ptxas then fuses the same
  // products into FMAs, and the endpoints (so the scores) keep its bits
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    const bool on = b < B && use[row + b];
    const unsigned m = __ballot_sync(0xffffffffu, on);
    if (on) {
      const float x = px[row + b], y = py[row + b];
      float2& slot = s_xy[used + __popc(m & ((1u << lane) - 1u))];
      if constexpr (kNearest)
        slot = nearest_endpoint(x, y, cs, sn);
      else
        slot = make_float2((x * cs - y * sn) * inv_res,
                           (x * sn + y * cs) * inv_res);
    }
    used += __popc(m);
  }
  __syncwarp();
  return used;
}

// One beam's samples into acc from the staged box `cells` (row pitch
// `pitch`), which starts at global column ax, row ay and holds every tap of
// the candidates; `last_x`, `last_y` are its largest base offsets (the
// clamp only keeps a NaN coordinate inside it).  The arithmetic is
// stage_scores_kernel's; kAllOwned where the tile owns every beam (n_m = 1).
template <bool kNearest, int kCw, bool kAllOwned>
__device__ __forceinline__ void add_beam(float* acc, const Item<kNearest, kCw>& it,
                                         float2 e, const float* cells,
                                         int pitch, int ax, int ay,
                                         unsigned last_x, unsigned last_y,
                                         const Tile& tile) {
  const float fy =
      sample_coord<kNearest>(e.y, it.cy, it.origin_y, it.inv_res);
  const float ry = fy + kMagic;
  const float ty = fy - (ry - kMagic) + 0.5f;
  const float* prow =
      cells +
      min(static_cast<unsigned>(__float_as_int(ry) - kMagicBits - ay),
          last_y) * pitch;
#pragma unroll
  for (int j = 0; j < kCw; ++j) {
    const float fx =
        sample_coord<kNearest>(e.x, it.cx[j], it.origin_x, it.inv_res);
    const float rx = fx + kMagic;
    const int x0 = __float_as_int(rx) - kMagicBits;  // global
    // one tile owns every beam: v + 0 is v, so the test can go
    const bool own = kAllOwned || (x0 >= tile.lo && x0 < tile.hi);
    const int dx = min(static_cast<unsigned>(x0 - ax), last_x);
    float v;
    if (kNearest) {
      v = prow[dx];
    } else {
      const float tx = fx - (rx - kMagic) + 0.5f;
      const float v00 = prow[dx], v10 = prow[dx + 1];
      const float v01 = prow[dx + pitch], v11 = prow[dx + pitch + 1];
      const float a0 = v00 + tx * (v10 - v00);
      const float a1 = v01 + tx * (v11 - v01);
      v = a0 + ty * (a1 - a0);
    }
    acc[j] += own ? v : 0.f;
  }
}

// add_beam with the taps read from the tile's field f (local column =
// global less tile.shift), v_outside off it.
template <bool kNearest, int kCw>
__device__ __forceinline__ void add_beam_field(
    float* acc, const Item<kNearest, kCw>& it, float2 e,
    const float* __restrict__ f, int H, int W, float v_outside,
    const Tile& tile) {
  const float fy =
      sample_coord<kNearest>(e.y, it.cy, it.origin_y, it.inv_res);
  const float ry = fy + kMagic;
  const float ty = fy - (ry - kMagic) + 0.5f;
  const int y0 = __float_as_int(ry) - kMagicBits;
#pragma unroll
  for (int j = 0; j < kCw; ++j) {
    const float fx =
        sample_coord<kNearest>(e.x, it.cx[j], it.origin_x, it.inv_res);
    const float rx = fx + kMagic;
    const int x0 = __float_as_int(rx) - kMagicBits;  // global
    const bool own = x0 >= tile.lo && x0 < tile.hi;
    const int x = x0 - tile.shift;
    float v;
    if (kNearest) {
      v = field_cell(f, x, y0, H, W, v_outside);
    } else {
      const float tx = fx - (rx - kMagic) + 0.5f;
      const float v00 = field_cell(f, x, y0, H, W, v_outside);
      const float v10 = field_cell(f, x + 1, y0, H, W, v_outside);
      const float v01 = field_cell(f, x, y0 + 1, H, W, v_outside);
      const float v11 = field_cell(f, x + 1, y0 + 1, H, W, v_outside);
      const float a0 = v00 + tx * (v10 - v00);
      const float a1 = v01 + tx * (v11 - v01);
      v = a0 + ty * (a1 - a0);
    }
    acc[j] += own ? v : 0.f;
  }
}

template <bool kNearest, int kCw>
__global__ void __launch_bounds__(kStagedThreads, kStagedBlocks)
    stage_scores_tile_kernel(
    const float* __restrict__ field, const float* __restrict__ px,
    const float* __restrict__ py, const unsigned char* __restrict__ use,
    const float* __restrict__ pose0, const float* __restrict__ dxs,
    const float* __restrict__ dys, const float* __restrict__ dts,
    float* __restrict__ out, int per_f, int per_b, int H, int W, int B,
    int nt, int ny, int nx, long long items, float inv_res, float origin_x,
    float origin_y, float v_outside, Staged sg, Tile tile, int* paths) {
  extern __shared__ float4 smem4[];
  // the block's base cells: x smallest, largest; y smallest, largest
  __shared__ int s_box[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* const region = reinterpret_cast<float*>(smem4);
  float2* const s_xy =
      reinterpret_cast<float2*>(region + sg.region) + warp * sg.ep_stride;
  // a contiguous run of the items, a warp every `warps`
  const long long i0 = blockIdx.x * items / gridDim.x;
  const long long i1 = (blockIdx.x + 1) * items / gridDim.x;

  if (threadIdx.x == 0) {
    s_box[0] = s_box[2] = INT_MAX;
    s_box[1] = s_box[3] = INT_MIN;
  }
  __syncthreads();
  // pass 1, the box: every candidate's base cell of each beam lies between
  // those at the warp's smallest and largest coordinates.  The endpoints
  // of the warp's last item stay staged for pass 2, which takes the items
  // in the other order.
  int kept = -1;
  for (long long item = i0 + warp; item < i1; item += warps) {
    const Item<kNearest, kCw> it(item, lane, sg, pose0, dxs, dys, nt, ny, nx,
                                 inv_res, origin_x, origin_y);
    const int used = stage_endpoints<kNearest>(
        s_xy, lane, it.p, it.q, per_b, B, px, py, use, pose0, dts, inv_res);
    kept = used;
    // the warp's smallest and largest candidate coordinates
    float lo = it.cx[0], hi = it.cx[0];
#pragma unroll
    for (int i = 1; i < kCw; ++i) {
      lo = fminf(lo, it.cx[i]);
      hi = fmaxf(hi, it.cx[i]);
    }
    const float xlo = warp_min(lo), xhi = warp_max(hi);
    const float ylo = warp_min(it.cy), yhi = warp_max(it.cy);
    int lo_x = INT_MAX, hi_x = INT_MIN, lo_y = INT_MAX, hi_y = INT_MIN;
    for (int b = lane; b < used; b += 32) {
      const float2 e = s_xy[b];
      lo_x = min(lo_x, base_cell(sample_coord<kNearest>(e.x, xlo, origin_x,
                                                        inv_res)));
      hi_x = max(hi_x, base_cell(sample_coord<kNearest>(e.x, xhi, origin_x,
                                                        inv_res)));
      lo_y = min(lo_y, base_cell(sample_coord<kNearest>(e.y, ylo, origin_y,
                                                        inv_res)));
      hi_y = max(hi_y, base_cell(sample_coord<kNearest>(e.y, yhi, origin_y,
                                                        inv_res)));
    }
    lo_x = __reduce_min_sync(0xffffffffu, lo_x);
    hi_x = __reduce_max_sync(0xffffffffu, hi_x);
    lo_y = __reduce_min_sync(0xffffffffu, lo_y);
    hi_y = __reduce_max_sync(0xffffffffu, hi_y);
    if (lane == 0 && used > 0) {
      atomicMin(&s_box[0], lo_x);
      atomicMax(&s_box[1], hi_x);
      atomicMin(&s_box[2], lo_y);
      atomicMax(&s_box[3], hi_y);
    }
  }
  __syncthreads();
  // the box: those base cells and the next column and row (bilinear)
  const bool any_used = s_box[0] <= s_box[1];
  const int bx = s_box[0], by = s_box[2];
  const long long bw = static_cast<long long>(s_box[1]) - bx + 2;
  const long long bh = static_cast<long long>(s_box[3]) - by + 2;
  // a row pitch of 9 mod 32 floats: the coarse stage's 27 lanes (9 rows
  // of 3 runs 3 cells apart) and the fine stage's read 27 and 9 banks
  const long long pitch = bw + (41 - bw % 32) % 32;
  // staged from one field only (G_f = 1)
  const bool one_field =
      static_cast<long long>(per_f) * nt * sg.unit_warps == items;
  const bool boxed = one_field && any_used && bw <= sg.region &&
                     bh <= sg.region && bh * pitch <= sg.region;
  if (boxed) {
    const int wb = static_cast<int>(bw), p_ = static_cast<int>(pitch);
    const int x_first = bx - tile.shift;
    const bool cols_in = x_first >= 0 && x_first + wb <= W;
    for (int r = warp; r < bh; r += warps) {
      float* dst = region + static_cast<size_t>(r) * p_;
      const int y = by + r;
      const float* src = field + static_cast<size_t>(y) * W + x_first;
      if (cols_in && static_cast<unsigned>(y) < static_cast<unsigned>(H)) {
        for (int c = lane; c < wb; c += 32) cp_async4(dst + c, src + c);
      } else {
        for (int c = lane; c < wb; c += 32) {
          const int x = x_first + c;
          if (static_cast<unsigned>(x) < static_cast<unsigned>(W) &&
              static_cast<unsigned>(y) < static_cast<unsigned>(H))
            cp_async4(dst + c, src + c);
          else
            dst[c] = v_outside;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
  }
  if (paths && threadIdx.x == 0 && any_used)
    atomicAdd(&paths[boxed ? 0 : 1], 1);
  __syncthreads();

  const bool all_owned = tile.lo == INT_MIN && tile.hi == INT_MAX;
  const long long first = i0 + warp;
  const long long n_mine = first < i1 ? (i1 - 1 - first) / warps + 1 : 0;
  for (long long k = n_mine - 1; k >= 0; --k) {
    const long long item = first + k * warps;
    const Item<kNearest, kCw> it(item, lane, sg, pose0, dxs, dys, nt, ny, nx,
                                 inv_res, origin_x, origin_y);
    // the first is pass 1's last: its endpoints are staged
    const int used = k == n_mine - 1 && kept >= 0
                         ? kept
                         : stage_endpoints<kNearest>(s_xy, lane, it.p, it.q,
                                                     per_b, B, px, py, use,
                                                     pose0, dts, inv_res);
    float acc[kCw];
#pragma unroll
    for (int j = 0; j < kCw; ++j) acc[j] = 0.f;
    // the adds stay in beam order, one sum a candidate
    if (boxed) {
      const int p_ = static_cast<int>(pitch);
      const unsigned lx = static_cast<unsigned>(bw - 2),
                     ly = static_cast<unsigned>(bh - 2);
      if (all_owned) {
#pragma unroll 2
        for (int b = 0; b < used; ++b)
          add_beam<kNearest, kCw, true>(acc, it, s_xy[b], region, p_, bx, by,
                                        lx, ly, tile);
      } else {
#pragma unroll 2
        for (int b = 0; b < used; ++b)
          add_beam<kNearest, kCw, false>(acc, it, s_xy[b], region, p_, bx,
                                         by, lx, ly, tile);
      }
    } else {
      const float* f = field + static_cast<size_t>(it.p / per_f) * H * W;
#pragma unroll 2
      for (int b = 0; b < used; ++b)
        add_beam_field<kNearest, kCw>(acc, it, s_xy[b], f, H, W, v_outside,
                                      tile);
    }
    if (it.active) {
      float* o = out + (static_cast<size_t>(it.q) * ny + it.iy) * nx + it.ix0;
#pragma unroll
      for (int i = 0; i < kCw; ++i)
        if (it.ix0 + i < nx) o[i] = acc[i];
    }
    __syncwarp();
  }
}

using StagedKernel = void (*)(const float*, const float*, const float*,
                              const unsigned char*, const float*,
                              const float*, const float*, const float*,
                              float*, int, int, int, int, int, int, int, int,
                              long long, float, float, float, float, Staged,
                              Tile, int*);

template <bool kNearest>
StagedKernel staged_kernel_for_run(int run) {
  switch (run) {
    case 1: return stage_scores_tile_kernel<kNearest, 1>;
    case 2: return stage_scores_tile_kernel<kNearest, 2>;
    case 3: return stage_scores_tile_kernel<kNearest, 3>;
    case 4: return stage_scores_tile_kernel<kNearest, 4>;
    default: return stage_scores_tile_kernel<kNearest, 5>;
  }
}

// sin and cos of n headings as the stage kernels take them (`rotation`).
__global__ void rotation_kernel(const float* __restrict__ theta,
                                float* __restrict__ sn,
                                float* __restrict__ cs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) rotation(theta[i], sn + i, cs + i);
}

}  // namespace

// The sines and cosines (sn, cs: n floats each) of n headings theta, from
// the stage kernels' own `rotation`: a check holds their bits against
// torch.sin and torch.cos on the card, the plain version's.
extern "C" int gs_k1_rotation(const float* theta, float* sn, float* cs,
                              int n, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  rotation_kernel<<<(n + 255) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(theta, sn, cs, n);
  return static_cast<int>(cudaGetLastError());
}

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
  return launch(field, px, py, use, pose0, dxs, dys, dts, out, P, G_f, G_b, H,
                W, B, nt, ny, nx, res, origin_x, origin_y, v_outside, nearest,
                shared, pitch, k, run, splits, threads, smem, false,
                Tile{0, 0, 0}, stream);
}

// The tile variant on a tile small enough to stage (the shared variant):
// field is (G_f, H, W) with W = w_loc + 2 ext, the column tile [c0, c0 +
// w_loc) of a map n_m * w_loc cells wide extended by ext columns each side;
// everything else as gs_stage_scores with shared = 1.  Returns the tile's
// partial scores: beams whose base column the tile owns.  A larger tile is
// gs_stage_scores_tile_staged's.
extern "C" int gs_stage_scores_tile(
    const float* field, const float* px, const float* py,
    const unsigned char* use, const float* pose0, const float* dxs,
    const float* dys, const float* dts, float* out, int P, int G_f, int G_b,
    int H, int W, int B, int nt, int ny, int nx, float res, float origin_x,
    float origin_y, float v_outside, int nearest, int c0, int w_loc, int n_m,
    int ext, int pitch, int k, int run, int splits, int threads, int smem,
    void* stream) {
  if (w_loc <= 0 || n_m <= 0 || ext < 1 || c0 < 0 || c0 % w_loc ||
      c0 / w_loc >= n_m || W != w_loc + 2 * ext)
    return cudaErrorInvalidValue;
  const int j = c0 / w_loc;
  const Tile tile{c0 - ext, j == 0 ? INT_MIN : c0,
                  j == n_m - 1 ? INT_MAX : c0 + w_loc};
  return launch(field, px, py, use, pose0, dxs, dys, dts, out, P, G_f, G_b, H,
                W, B, nt, ny, nx, res, origin_x, origin_y, v_outside, nearest,
                1, pitch, k, run, splits, threads, smem, true, tile, stream);
}

// The tile variant on a tile too large to stage: arguments as
// gs_stage_scores_tile up to `ext`, then the launch plan (ops/cuda/matcher.
// tile_launch_plan): run (dx candidates a lane, 1 to 5), warps a block,
// grid (blocks, each a contiguous run of the work items), smem; and paths,
// null or two ints to which each block with used beams adds one: [blocks
// that staged their box, blocks that read the field].  A plan that does not
// fit the shapes is refused with cudaErrorInvalidValue.
extern "C" int gs_stage_scores_tile_staged(
    const float* field, const float* px, const float* py,
    const unsigned char* use, const float* pose0, const float* dxs,
    const float* dys, const float* dts, float* out, int P, int G_f, int G_b,
    int H, int W, int B, int nt, int ny, int nx, float res, float origin_x,
    float origin_y, float v_outside, int nearest, int c0, int w_loc, int n_m,
    int ext, int run, int warps, int grid, int smem, int* paths,
    void* stream) {
  if (w_loc <= 0 || n_m <= 0 || ext < 1 || c0 < 0 || c0 % w_loc ||
      c0 / w_loc >= n_m || W != w_loc + 2 * ext)
    return cudaErrorInvalidValue;
  if (P == 0 || nt == 0 || ny == 0 || nx == 0) return cudaSuccess;
  if (G_f <= 0 || G_b <= 0 || P % G_f || P % G_b || B < 0 || H <= 0 ||
      W <= 0 || H >= (1 << 22) || W >= (1 << 22))
    return cudaErrorInvalidValue;
  const long long n_max = nt > ny ? (nt > nx ? nt : nx) : (ny > nx ? ny : nx);
  if (static_cast<long long>(P) * n_max > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (run < 1 || run > kMaxRun || warps < 1 || warps * 32 > kStagedThreads ||
      grid < 1 || smem < 0)
    return cudaErrorInvalidValue;
  const int units = ny * ((nx + run - 1) / run);
  const int unit_warps = (units + 31) / 32;
  const long long items = static_cast<long long>(P) * nt * unit_warps;
  const long long region =
      (smem / 4 - static_cast<long long>(warps) * (B | 1) * 2) / 4 * 4;
  if (grid > items || region < 0) return cudaErrorInvalidValue;
  const Staged sg{units, unit_warps, B | 1, static_cast<int>(region)};
  const int j = c0 / w_loc;
  const Tile tile{c0 - ext, j == 0 ? INT_MIN : c0,
                  j == n_m - 1 ? INT_MAX : c0 + w_loc};
  const StagedKernel kernel = nearest ? staged_kernel_for_run<true>(run)
                                      : staged_kernel_for_run<false>(run);
  constexpr int kDevices = 64;
  static int opted_in[kDevices][2][kMaxRun];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kDevices)
    return cudaErrorInvalidDevice;
  int& limit = opted_in[dev][nearest ? 1 : 0][run - 1];
  if (smem > kDefaultSmem && smem > limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit = smem;
  }
  kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      field, px, py, use, pose0, dxs, dys, dts, out, P / G_f, P / G_b, H, W,
      B, nt, ny, nx, items, 1.0f / res, origin_x, origin_y, v_outside, sg,
      tile, paths);
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
