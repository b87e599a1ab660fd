// Eight of XLA's fusions as kernels: F1 the motion model, F2 the coarse
// stage's pool, F3 a matcher stage's pick, F4 the surface's trilinear sample
// and hill-climb with the weights' temperature, F5 the endpoint splat's tap
// weights, F6 the scan's preparation (deskew, the bearing-bin tables, and
// what every step takes of the scan once a scan: the endpoints, the used
// beams, every coarse-stride-th beam, their count and the map update's
// gate), F7 the weights' tail (max, first argmax, Neff, the weighted mean
// pose and the shared map's scalar epilogue, with the windows it places on
// the map) and F8 the systematic walk of the resample.
//
// They replace no Pallas kernel.  In the JAX package XLA fuses each of these
// runs of elementwise and reduce operations into one loop or reduce fusion:
// RBPF.step vmaps sample_motion and apply_odometry
// (gridmap_slam_tpu/models/rbpf.py:180-182) and the matcher's prior, argmax
// and pick (gridmap_slam_tpu/ops/matcher.py:302-321, with _prior_grid
// :137-153 and _argmax3 :156-162) inside its lax.map, and pools the coarse
// field once (:246-252); the surface step samples its volume
// (gridmap_slam_tpu/ops/surface.py:231-318) and splats its endpoints
// (:60-99); every step deskews its scan and builds its bin tables
// (gridmap_slam_tpu/ops/geometry.py:67, ops/raycast.py build_beam_lut,
// ops/pallas/grid_update.py:58), and ends in the weights' reductions and,
// under the resample gate, the systematic walk (gridmap_slam_tpu/ops/
// resample.py:21-35, :112-137 in models/rbpf.py:254-278, models/
// shared.py:386-461 and models/multi.py:110-142); the matcher's endpoints,
// used and coarse beams are the same in every chunk of a scan, and XLA
// hoists them out of the lax.map body (gridmap_slam_tpu/ops/matcher.py:
// 213-214, :285-286), and the surface step's crop, bins and temperature are
// scalar fusions (gridmap_slam_tpu/ops/surface.py:43, :56, models/shared.py:
// 145-166, :183).  In PyTorch each tensor operation of them
// is a kernel of its own, and the prior and the total of a coarse stage are
// two more tensors of the stage's scores' size, the surface sample's packed
// neighbourhoods eight copies of the volume.  Each kernel here does the
// whole run in one pass.
//
// The bar is the bits of that op sequence on the card (the plain versions in
// ops/cuda/fusions.py, which stay the CPU path): every product, sum and
// quotient is written __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which
// ptxas never contracts into an FMA, as PyTorch's separate kernels round
// each one; sinf, cosf and atan2f are the CUDA math library's, without fast
// math, as PyTorch's elementwise kernels call them; torch.pow(x, 2) is
// x * x; a sum keeps Python's left-to-right order, (2 sd) sd; the argmax
// takes the first maximum and counts a NaN as the maximum (torch.argmax).
// A division by a Python float is PyTorch's multiplication by its float
// reciprocal, computed in float on the host (the wrappers pass it in); a
// division by a tensor is an IEEE division.
//
// Bound on the H100: bytes.  F3 reads a stage's (P, nt, ny, nx) scores once
// (1.78 GB a coarse stage of a 500 000-particle block) and writes a few
// floats a particle; a candidate costs two IEEE divisions and ten other
// operations, well under the bytes' time at 67 TFLOP/s.  F1 reads a pose and
// two normals and writes one or two poses; F2 reads the field once and writes
// a quarter of it.  F4 reads a pose and writes its score (and pose), its
// taps from a volume that stays in L2 (1.4 MB at mega, 26 MB at city); F5
// writes two (nt, B, K) factor tensors; F6 reads a scan and writes it and
// its tables (a few KB: a launch's time).  F7 reads the log-weights three
// times and the poses once (16 MB at 1M weights, in L2 between passes) and
// writes a few floats (one read of each where P <= 1024); F8 reads the
// log-weights twice and writes the scan (4 MB, in L2), then each slot's
// ~20 probes of it and its gathers.
//
// Layout.  F1 and F2: a thread a particle or an output cell.  F3: teams
// of max(lanes, 32) threads (ops/cuda/fusions.pick_plan: 256 or 128 lanes a
// particle at 250-500 particles, to give every SM a block; a warp a
// particle at a coarse stage of a 500 000 block, eight particles a warp at
// its 125-candidate stages), each team working its slabs of consecutive
// particles in turn with its own shared memory and barrier (a warp's, or a
// named barrier).  What held a warp-a-particle design back on the H100 was
// latency, not bytes: 250 or 500 particles filled 32 or 63 of 132 SMs, a
// lane's loop was a load and then a dependent compare (one 128-byte load a
// warp in flight: 1.15 TB/s at a 500 000 block), and a chain of
// block-wide barriers cost a slab the same whatever its size.  So a team
// copies its next slab's scores, offsets and poses into shared memory with
// cp.async (16 bytes a copy where aligned) while it works the current one,
// with no barrier across teams.  A particle's noise scales, bias and
// coarse scale are taken by a thread each for the team's next `team`
// particles at once (the used-beam counts of every scan row once a block,
// a warp a row by ballots: integers, so exact as the float sums they
// replace).  A lane
// owns the (dy, dx) cells lane, lane + lanes, ... of its particle (or one
// cell and every H-th heading where the lanes outnumber the cells; past
// kPickCells of them, 2048 cells a stage, in groups of kPickCells, each
// group walked in turn and its first maximum combined with the others' in
// the total order below), their
// quotients q = d2 / (2 sd_c sd_c) in registers, and walks the headings,
// each heading's quotient -(dt^2) / (2 sd_t sd_t) from a table (ny nx + nt
// divisions a particle, not two a candidate: a first design that divided
// a candidate took 7.8 ms a scan of mega_blocked's 6 calls); a heading's
// cells are read from shared memory first and then taken by selects, with
// no branch, so a lane visits its candidates in index order and keeps the
// first maximum (a lane whose candidates all are -inf takes its first).
// Shuffles within the particle's lanes, then shared memory across its
// warps, combine them in one total order (NaN first, then the larger
// value, then the smaller index), so any split of the candidates gives the
// first argmax; the team writes its particles' outputs in one coalesced
// pass.  Each candidate's prior keeps its op sequence.
// F4: a thread a pose; its eight taps are read from the (nt, hc, wc)
// volume in place at the cells the packed neighbourhood array
// (ops/surface.pack_neighborhoods) would hold, so that array is never
// built; the hill-climb keeps the pose and its score in registers for all
// its steps, and tempers the score as it writes it (a product by the fixed
// temperature or by rsqrtf of F6's used-beam count, as torch.rsqrt computes
// it).  F5: a warp a (bin, beam) row of K taps, its lanes on
// neighbouring taps.  F6: a block a scan, its beams in shared memory,
// ranked by counting (B^2 comparisons: B is a few hundred), then a thread
// a bearing bin; a thread a beam writes its endpoint, used flag and its
// coarse copy, the block counts the used beams (an integer sum: exact) and
// one thread writes the gate.  F7 and F8: the sums take ops/resample.py's
// fixed order, which its plain functions spell out with elementwise ops so
// that no PyTorch reduction order (chosen by PyTorch from the size and the
// card) is left to match: a block of 128 threads takes a row of 1024
// weights, a thread a segment of 8 added left to right, the row's segments
// by a halving tree (shuffles below 32) or a Hillis-Steele scan in shared
// memory, and the rows' partials by the same tree or scan.  F7 where P <=
// 1024 is one launch, a block a robot doing the whole call.  Above it is
// three launches, which its three dependent reductions need without a
// grid-wide barrier: the rows' first argmax; the max (every block takes it
// from the rows' argmaxes: a ticket would need a zeroed counter, which a
// replay does not have before the first launch) and each row's sum of exp,
// the last block, by a ticket the first launch resets, summing the rows
// once and writing the max and the total; each row's sums of w w and w
// pose, its poses copied into shared memory by cp.async, the four row
// trees at once, then the last block summing the rows' four partials at
// once (a thread holding eight of a tree's values, so that its top levels
// add in registers) and writing the outputs and the epilogue; 14 KB of
// shared memory a block, so that 1024 rows run in one wave.  (An earlier design whose
// every block of the third launch summed the rows' partials again, and
// whose last block summed the four in turn, took 0.043 ms at 1M weights,
// 8x its byte bound.)  F8 is two (each row's scan of the normalized
// weights; a thread a slot: the rows' carry, the binary search and the
// gathers).  The max is the value at the first argmax (order-free), the
// exp the CUDA math library's expf, as torch.exp's.  The thread that writes
// F7's outputs also places a window where asked: the surface volume's crop
// around the weighted mean propagated by the odometry (F1's arithmetic),
// its extended window and the theta bins, or the map update's crop around
// the integration pose (ops/surface.crop_center_cells: a product by the
// resolution's float reciprocal, rounded half to even).
//
// The distributed engines' tail (gridmap_slam_tpu/parallel/shmap.py:136-157,
// the surface center :94-103, the resample body :178-207) puts a pmax, two
// psums and an all_gather between F7's reductions, so F7's mesh form is its
// passes a launch each over one rank's rows, the last block of each
// reducing the rows once into the value the next collective takes, and an
// epilogue of one thread on the reduced values and the ranks' gathered
// candidates; latency-bound at a mesh step's sizes (four launches and a
// memset a call, where the single-device F7 takes one or three).  F8's
// mesh form walks the gathered rows: F7's passes A and B over all of them
// (the fixed order's max and total of the global weights, which a psum of
// the ranks' totals would associate otherwise), the scan over all, and the
// search of this rank's slots alone.

#include <cuda_runtime.h>

#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

struct Motion {
  float base_c, rel_c, base_t, rel_t;   // base_t in radians
};

// ops/geometry.wrap_angle: atan2(sin a, cos a).
__device__ __forceinline__ float wrap(float a) {
  return atan2f(sinf(a), cosf(a));
}

// ops/cuda/fusions.noise_scales: (base_c + |d_center| rel_c) / 2 and
// radians(base_theta) + |d_theta| rel_t.
__device__ __forceinline__ float2 noise(float dc, float dt, const Motion& m) {
  return make_float2(
      __fdiv_rn(__fadd_rn(__fmul_rn(fabsf(dc), m.rel_c), m.base_c), 2.0f),
      __fadd_rn(__fmul_rn(fabsf(dt), m.rel_t), m.base_t));
}

// F1.  pose: (n, 3); normals: (n, 2) or null; d_center, d_theta: one a
// group of per_g particles.  out_s (n, 3), where normals are given:
// sample_motion; out_det (n, 3), where given: apply_odometry.
__global__ void __launch_bounds__(kThreads) fusion_motion_kernel(
    const float* __restrict__ pose, const float* __restrict__ normals,
    const float* __restrict__ d_center, const float* __restrict__ d_theta,
    float* __restrict__ out_s, float* __restrict__ out_det, int n, int per_g,
    Motion m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int g = i / per_g;
  const float dc = d_center[g], dt = d_theta[g];
  const float x = pose[3 * i], y = pose[3 * i + 1], t = pose[3 * i + 2];
  if (out_s != nullptr) {
    const float2 sd = noise(dc, dt, m);
    const float d = __fadd_rn(dc, __fmul_rn(sd.x, normals[2 * i]));
    const float th = __fadd_rn(dt, __fmul_rn(sd.y, normals[2 * i + 1]));
    const float theta = wrap(__fadd_rn(t, th));
    out_s[3 * i] = __fadd_rn(x, __fmul_rn(cosf(theta), d));
    out_s[3 * i + 1] = __fadd_rn(y, __fmul_rn(sinf(theta), d));
    out_s[3 * i + 2] = theta;
  }
  if (out_det != nullptr) {
    const float theta = wrap(__fadd_rn(t, dt));
    out_det[3 * i] = __fadd_rn(x, __fmul_rn(cosf(theta), dc));
    out_det[3 * i + 1] = __fadd_rn(y, __fmul_rn(sinf(theta), dc));
    out_det[3 * i + 2] = theta;
  }
}

// F2.  field: G fields of H x W cells, field g's row r at
// field + g sg + r sh, its cells contiguous; out: (G, Ho, Wo), the mean of
// each 2 x 2 block, cells past an odd edge reading `fill`, summed
// ((a + c) + (b + d)) * 0.25 (a, b the block's top row, c, d its bottom):
// the order of PyTorch's mean over the two pooled axes on the card, which
// adds each column's two rows first (chip_smoke.pool_order finds it among
// three on random fields, where ((a + b) + (c + d)) differs in 24-38 %
// of the cells).
__global__ void __launch_bounds__(kThreads) fusion_pool_kernel(
    const float* __restrict__ field, float* __restrict__ out, int H, int W,
    long long sg, long long sh, int Ho, int Wo, long long n, float fill) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const long long cells = static_cast<long long>(Ho) * Wo;
  const long long g = i / cells;
  const int r = static_cast<int>(i - g * cells);
  const int y = 2 * (r / Wo), x = 2 * (r % Wo);
  const float* row = field + g * sg + y * sh;
  const bool right = x + 1 < W, down = y + 1 < H;
  const float a = row[x];
  const float b = right ? row[x + 1] : fill;
  const float c = down ? row[sh + x] : fill;
  const float d = right && down ? row[sh + x + 1] : fill;
  out[i] = __fmul_rn(__fadd_rn(__fadd_rn(a, c), __fadd_rn(b, d)), 0.25f);
}

struct Pick {
  int P, nt, ny, nx;
  int per_o;             // particles an odometry row
  int per_b, B, stride;  // the coarse stage's scan rows, beam slots, stride
  int n_xy, n_t;         // the next stage's offsets (0 after the last)
  int lanes, per_slab;   // the launch plan: threads a particle, particles
  int staged;            // a slab; scores staged in shared memory
  float weight;
  Motion m;
};

// Whether (v, i) comes before (w, j) in the argmax's order: a NaN first,
// then the larger value, then the smaller index; j < 0 is no candidate.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  const bool vn = isnan(v), wn = isnan(w);
  const bool first = (vn & !wn) | ((vn == wn) & (v > w)) |
                     ((vn == wn) & !(v != w) & (i < j)) |
                     (vn & wn & (i < j));
  return j < 0 ? i >= 0 : (i >= 0) & first;
}

// cp.async: a copy from global to shared memory that holds no register
// and is waited for by cp_async_wait; 16 bytes (cached in L2 only: the
// scores are read once) or 4.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Closes this thread's group of cp.async copies issued since the last.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for this thread's closed groups but the newest one where `ahead`
// (the next slab's, in flight), else for all of them.
__device__ __forceinline__ void cp_async_wait_prior(bool ahead) {
  if (ahead)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The copy of n floats from src into dst (shared, 16-byte aligned) at
// dst[head + j], head = src's offset past a 16-byte boundary in floats, by
// the `threads` threads of a team (this one the team's thread tt), so that
// every 16-byte aligned run of src is one 16-byte copy; the ragged ends go
// 4 bytes at a time.  The caller waits (cp_async_wait) and synchronizes.
__device__ void stage_async(float* dst, const float* src, int n, int tt,
                            int threads) {
  const int head =
      static_cast<int>((reinterpret_cast<size_t>(src) >> 2) & 3u);
  const int j0 = min((4 - head) & 3, n);
  const int vecs = (n - j0) >> 2;
  const int tail = j0 + 4 * vecs;
  for (int v = tt; v < vecs; v += threads)
    cp_async16(dst + head + j0 + 4 * v, src + j0 + 4 * v);
  for (int j = tt; j < j0; j += threads)
    cp_async4(dst + head + j, src + j);
  for (int j = tail + tt; j < n; j += threads)
    cp_async4(dst + head + j, src + j);
}

// src's offset past a 16-byte boundary, in floats: where stage_async puts
// src[0].
__device__ __forceinline__ int stage_head(const float* src) {
  return static_cast<int>((reinterpret_cast<size_t>(src) >> 2) & 3u);
}

// The block's copy of n floats from src to dst[0 .. n) (shared, 16-byte
// aligned) by cp.async: 16 bytes a copy where src is 16-byte aligned (the
// ragged end 4 bytes a copy), else 4.  The caller waits and synchronizes.
__device__ void stage_async_in_place(float* dst, const float* src, int n) {
  const bool aligned = (reinterpret_cast<size_t>(src) & 15u) == 0;
  const int vecs = aligned ? n >> 2 : 0;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x)
    cp_async16(dst + 4 * v, src + 4 * v);
  for (int j = 4 * vecs + threadIdx.x; j < n; j += blockDim.x)
    cp_async4(dst + j, src + j);
}

// F3 works in teams: max(lanes, 32) threads of a block (a warp, a few
// warps or the block) take slabs of team / lanes particles in turn, each
// team with its own shared memory and barrier.  A team's shared memory, in
// floats: two buffers, each a
// slab's staged scores (q n, + 3 to align, rounded to 4) and its
// particles' offsets (q (nx + ny + nt)) and pose0 (3 q), rounded to 4; the
// heading quotients (q nt), the picks (3 q: it, iy, ix), the scalars of
// the team's next `team` particles (kPickScalars a particle) and the
// argmax across the team's warps (2 a warp).
constexpr int kPickThreads = 256;
constexpr int kPickScalars = 8;
constexpr int kPickCells = 8;     // (dy, dx) cells a lane, at most
constexpr int kPickRows = 256;    // scan rows whose counts a block keeps
__host__ __device__ inline size_t pick_slab_floats(int q, int n, int staged) {
  return staged ? ((static_cast<size_t>(q) * n + 3 + 3) & ~size_t{3}) : 0;
}
__host__ __device__ inline size_t pick_buffer_floats(int q, int nt, int ny,
                                                     int nx, int staged) {
  return (pick_slab_floats(q, nt * ny * nx, staged) +
          static_cast<size_t>(q) * (nx + ny + nt + 3) + 3) &
         ~size_t{3};
}
__host__ __device__ inline size_t pick_team_floats(int q, int team, int nt,
                                                   int ny, int nx,
                                                   int staged) {
  return (2 * pick_buffer_floats(q, nt, ny, nx, staged) +
          static_cast<size_t>(q) * (nt + 3) +
          static_cast<size_t>(team) * kPickScalars + 2 * (team / kWarp) +
          3) &
         ~size_t{3};
}

// A team's barrier: the warp's, or named barrier `id` of `threads`.
__device__ __forceinline__ void team_sync(int id, int threads) {
  if (threads == kWarp)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A slab's inputs in one of F3's buffers.
struct PickSlab {
  float *scores, *ox, *oy, *ot, *ps;
};

__device__ __forceinline__ PickSlab pick_slab(float* buf, int q,
                                              const Pick& k) {
  PickSlab b;
  b.scores = buf;
  b.ox = buf + pick_slab_floats(q, k.nt * k.ny * k.nx, k.staged);
  b.oy = b.ox + q * k.nx;
  b.ot = b.oy + q * k.ny;
  b.ps = b.ot + q * k.nt;
  return b;
}

// A team's copies (cp.async, not waited for) of slab p0's inputs: its
// scores where staged, its particles' offsets and pose0; tt the team's
// thread, of `threads`.
__device__ void pick_stage(const PickSlab& b, int p0, int qn, const Pick& k,
                           const float* scores, const float* dxs,
                           const float* dys, const float* dts,
                           const float* pose0, int tt, int threads) {
  const int n = k.nt * k.ny * k.nx;
  if (k.staged)
    stage_async(b.scores, scores + static_cast<size_t>(p0) * n, qn * n, tt,
                threads);
  for (int e = tt; e < qn * k.nx; e += threads)
    cp_async4(b.ox + e, dxs + static_cast<size_t>(p0) * k.nx + e);
  for (int e = tt; e < qn * k.ny; e += threads)
    cp_async4(b.oy + e, dys + static_cast<size_t>(p0) * k.ny + e);
  for (int e = tt; e < qn * k.nt; e += threads)
    cp_async4(b.ot + e, dts + static_cast<size_t>(p0) * k.nt + e);
  for (int e = tt; e < 3 * qn; e += threads)
    cp_async4(b.ps + e, pose0 + 3 * static_cast<size_t>(p0) + e);
}

// One particle's scalars into c: 2 sd_c sd_c, 2 sd_t sd_t, the bias
// (pose0 - center, its heading wrapped; 0 without a center) and at the
// coarse stage n_c / n_all and n_all / n_c of its scan row: from the
// block's counts (n_all, n_c a row) where given, else counted here (a byte
// a beam).
__device__ void pick_scalars(int p, const Pick& k, const float* pose0,
                             const float* center, const float* d_center,
                             const float* d_theta, const bool* use,
                             const int* counts, float* c) {
  const float2 sd = noise(d_center[p / k.per_o], d_theta[p / k.per_o], k.m);
  c[0] = __fmul_rn(__fmul_rn(2.0f, sd.x), sd.x);
  c[1] = __fmul_rn(__fmul_rn(2.0f, sd.y), sd.y);
  c[2] = c[3] = c[4] = 0.0f;
  if (center != nullptr) {
    const size_t o = 3 * static_cast<size_t>(p);
    c[2] = __fsub_rn(pose0[o], center[o]);
    c[3] = __fsub_rn(pose0[o + 1], center[o + 1]);
    c[4] = wrap(__fsub_rn(pose0[o + 2], center[o + 2]));
  }
  c[5] = c[6] = 1.0f;
  if (use != nullptr) {
    const int g = p / k.per_b;
    int n_all = 0, n_c = 0;
    if (counts != nullptr) {
      n_all = counts[2 * g];
      n_c = counts[2 * g + 1];
    } else {
      const bool* row = use + static_cast<size_t>(g) * k.B;
      for (int e = 0, m = 0; e < k.B; ++e) {
        const int u = row[e];
        n_all += u;
        n_c += m == 0 ? u : 0;
        m = m + 1 == k.stride ? 0 : m + 1;
      }
    }
    const float fa = fmaxf(static_cast<float>(n_all), 1.0f);
    const float fc = fmaxf(static_cast<float>(n_c), 1.0f);
    c[5] = __fdiv_rn(fc, fa);
    c[6] = __fdiv_rn(fa, fc);
  }
}

// The prior's quotients q[a] = d2 / (2 sd_c sd_c) of a lane's cells of
// particle g of slab b, c its scalars: the same floats the candidates'
// separate tensor ops give.  cell[a]: iy << 16 | ix where kPacked (at most
// kPickCells a lane: ny nx <= 2048), else the flat iy nx + ix.
template <int kCells, bool kPacked>
__device__ __forceinline__ void pick_quotients(const PickSlab& b, int g,
                                               const Pick& k, const float* c,
                                               const int (&cell)[kCells],
                                               float (&q)[kCells]) {
#pragma unroll
  for (int a = 0; a < kCells; ++a) {
    const int iy = kPacked ? cell[a] >> 16 : cell[a] / k.nx;
    const int ix = kPacked ? cell[a] & 0xffff : cell[a] - iy * k.nx;
    const float ay = __fadd_rn(b.oy[g * k.ny + iy], c[3]);
    const float ax = __fadd_rn(b.ox[g * k.nx + ix], c[2]);
    q[a] = __fdiv_rn(__fadd_rn(__fmul_rn(ay, ay), __fmul_rn(ax, ax)), c[0]);
  }
}

// F3.  scores: (P, nt, ny, nx), K1's scores of one stage at the candidates
// pose0 + (dxs[ix], dys[iy], dts[it]) (dxs (P, nx), dys (P, ny), dts
// (P, nt)).  For each particle: the motion prior of ops/cuda/fusions.
// _prior_grid (centered at `center` where given: the bias
// pose0 - center, its heading wrapped), scaled at the coarse stage (`use`
// given: the scan's (G_b, B) mask) by n_c / n_all; the first argmax of
// scores + prior; then either the next stage's offsets (off_xy given:
// out_dxs = fx + off_xy, out_dys = fy + off_xy, out_dts = ft + off_t) or,
// after the last stage, best = pose0 + (fx, fy, ft) and meas_best = the
// picked score (times n_all / n_c at the coarse stage).
//
// A team of max(lanes, 32) threads takes slabs of team / lanes consecutive
// particles, `lanes` threads a particle (the plan): the team's slabs are
// its index over all blocks, + all the teams, ...  A slab's scores (one
// contiguous run, where staged), offsets and poses are copied into the
// team's shared memory by cp.async, the next slab's into the other buffer
// while the team works the current one.  Each particle's noise scales,
// bias and coarse scale (the used beams of its scan row, counted) are
// taken by a thread of its own for the team's next `team` particles at
// once.  A lane owns the (dy, dx) cells r = lane, lane + lanes, ... (or,
// where the lanes outnumber the cells, one cell and every H-th heading),
// their quotients q[r] in registers, and walks the headings, each
// heading's quotient from a table the particle's lanes build; so a lane
// visits its candidates in index order and keeps the first maximum of
// them; shuffles (and across the team's warps, shared memory) combine the
// lanes' in before()'s order; the team writes the slab's outputs in one
// coalesced pass.  kGroups: a lane's cells pass kCells (ny nx > kCells
// lanes), so it walks them kCells at a time, each group's quotients
// computed as the group starts, and keeps the group's first maximum where
// before() puts it ahead of the groups' before it.
template <bool kStaged, int kCells, bool kGroups>
__global__ void __launch_bounds__(kPickThreads, kCells > 3 ? 2 : 3)
    fusion_pick_kernel(
    const float* __restrict__ scores, const float* __restrict__ dxs,
    const float* __restrict__ dys, const float* __restrict__ dts,
    const float* __restrict__ pose0, const float* __restrict__ center,
    const float* __restrict__ d_center, const float* __restrict__ d_theta,
    const bool* __restrict__ use, const float* __restrict__ off_xy,
    const float* __restrict__ off_t, float* __restrict__ out_dxs,
    float* __restrict__ out_dys, float* __restrict__ out_dts,
    float* __restrict__ best, float* __restrict__ meas_best, Pick k) {
  extern __shared__ __align__(16) float sm[];
  const int L = k.lanes, Q = k.per_slab;
  const int T = L * Q, teams = blockDim.x / T;   // a team's threads
  const int nyx = k.ny * k.nx, n = k.nt * nyx;
  const int slabs = (k.P + Q - 1) / Q;
  const int team = threadIdx.x / T, tt = threadIdx.x - team * T;
  const int g = tt / L, l = tt - g * L;
  const int warp = tt / kWarp, lane = tt % kWarp;   // within the team
  const int bar = 1 + team;
  const bool coarse = use != nullptr;
  float* own = sm + team * pick_team_floats(Q, T, k.nt, k.ny, k.nx, k.staged);
  const size_t buf_floats = pick_buffer_floats(Q, k.nt, k.ny, k.nx, k.staged);
  float* q_t = own + 2 * buf_floats;         // (q, nt)
  int* pick = reinterpret_cast<int*>(q_t + Q * k.nt);  // (q, 3)
  float* par = reinterpret_cast<float*>(pick + 3 * Q);  // (team, scalars)
  float* red_v = par + T * kPickScalars;
  int* red_i = reinterpret_cast<int*>(red_v + T / kWarp);
  float* qt = q_t + g * k.nt;
  const int first = blockIdx.x * teams + team, stride = gridDim.x * teams;
  // this lane's cells: r0 + a L for a < cells, its headings h, h + H, ...;
  // each cell's flat offset in a heading and its (iy, ix)
  const int H = max(1, min(k.nt, L / nyx));
  const int h = H > 1 ? l / nyx : 0, r0 = l - h * nyx;
  const int cells = H > 1 ? (l < H * nyx ? 1 : 0)
                          : max(0, (nyx - l + L - 1) / L);
  int cell_r[kCells], cell_yx[kCells];         // r; iy << 16 | ix
#pragma unroll
  for (int a = 0; a < kCells; ++a) {
    cell_r[a] = a < cells ? r0 + a * L : r0;
    const int iy = cell_r[a] / k.nx;
    cell_yx[a] = kGroups ? 0 : iy << 16 | (cell_r[a] - iy * k.nx);
  }
  // the coarse stage's used-beam counts of every scan row, a warp a row by
  // ballots (integers, so exact as the float sums they replace), once a
  // block where they fit (kPickRows rows)
  const int rows = coarse ? k.P / k.per_b : 0;
  int* counts = nullptr;
  if (coarse && rows <= kPickRows) {
    counts = reinterpret_cast<int*>(sm) + (blockDim.x / T) *
             pick_team_floats(Q, T, k.nt, k.ny, k.nx, k.staged);
    for (int rr = threadIdx.x / kWarp; rr < rows;
         rr += blockDim.x / kWarp) {
      const bool* row = use + static_cast<size_t>(rr) * k.B;
      int n_all = 0, n_c = 0;
      for (int j0 = 0; j0 < k.B; j0 += 8 * kWarp) {
        bool u[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int b = j0 + e * kWarp + threadIdx.x % kWarp;
          u[e] = b < k.B && row[b];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int b = j0 + e * kWarp + threadIdx.x % kWarp;
          n_all += __popc(__ballot_sync(0xffffffffu, u[e]));
          n_c += __popc(__ballot_sync(0xffffffffu, u[e] && b % k.stride == 0));
        }
      }
      if (threadIdx.x % kWarp == 0) {
        counts[2 * rr] = n_all;
        counts[2 * rr + 1] = n_c;
      }
    }
    __syncthreads();
  }

  if (first < slabs) {
    const int p0 = first * Q;
    pick_stage(pick_slab(own, Q, k), p0, min(Q, k.P - p0), k, scores, dxs,
               dys, dts, pose0, tt, T);
  }
  int j = 0;
  for (int slab = first; slab < slabs; slab += stride, ++j) {
    const int p0 = slab * Q, qn = min(Q, k.P - p0);
    const bool ahead = slab + stride < slabs;
    const PickSlab b = pick_slab(own + (j & 1) * buf_floats, Q, k);
    cp_async_commit();
    if (ahead) {
      const int p1 = p0 + stride * Q;
      pick_stage(pick_slab(own + ((j + 1) & 1) * buf_floats, Q, k), p1,
                 min(Q, k.P - p1), k, scores, dxs, dys, dts, pose0, tt, T);
    }
    cp_async_commit();
    // the scalars of this and the team's next slabs' particles, a thread
    // each, every T / Q slabs
    const int batch = j % L;                 // T / Q = L slabs a batch
    if (batch == 0) {
      const int bs = slab + (tt / Q) * stride, bp = bs * Q + tt % Q;
      if (bs < slabs && bp < k.P)
        pick_scalars(bp, k, pose0, center, d_center, d_theta, use, counts,
                     par + kPickScalars * tt);
    }
    cp_async_wait_prior(ahead);
    team_sync(bar, T);
    const float* c = par + kPickScalars * (batch * Q + g);
    // the prior's quotients: qt[it] = -(dt^2) / (2 sd_t sd_t) in a table
    // the particle's lanes build, q[r] = d2 / (2 sd_c sd_c) for r = iy nx +
    // ix in this lane's registers, the same floats the candidates'
    // separate tensor ops give
    const bool mine = g < qn;
    float q[kCells];
    if (mine) {
      for (int it = l; it < k.nt; it += L) {
        const float at = __fadd_rn(b.ot[g * k.nt + it], c[4]);
        qt[it] = __fdiv_rn(-__fmul_rn(at, at), c[1]);
      }
      if (!kGroups) pick_quotients<kCells, true>(b, g, k, c, cell_yx, q);
    }
    team_sync(bar, T);
    const float* src = scores + static_cast<size_t>(p0) * n;
    // the staged slab through a pointer into shared memory alone, so that
    // its reads are shared-memory loads
    const float* sl =
        kStaged ? own + (j & 1) * buf_floats + stage_head(src) : src;
    float bv = -INFINITY;
    int bi = -1;
    if (mine && cells > 0) {
      const float* s = sl + g * n;
      const float scale = c[5];
      // more cells than registers (kGroups): the lane's cells r0 + a L in
      // groups of kCells, each group's quotients in registers and its
      // first maximum kept where before() puts it first, so that the
      // groups' order does not matter
      const int groups = kGroups ? (cells + kCells - 1) / kCells : 1;
      for (int grp = 0; grp < groups; ++grp) {
        int gcells = cells;
        if (kGroups) {
          gcells = min(kCells, cells - grp * kCells);
#pragma unroll
          for (int a = 0; a < kCells; ++a)
            cell_r[a] = r0 + (grp * kCells + (a < gcells ? a : 0)) * L;
          pick_quotients<kCells, false>(b, g, k, c, cell_r, q);
        }
        // a heading's cells read first, then taken in turn where before()
        // puts them first (a larger index than any taken: a NaN over a
        // number, a larger number); a lane whose candidates all are -inf
        // takes its first
        float gv = -INFINITY;
        int gi = -1;
        for (int it = h; it < k.nt; it += H) {
          const float pt = qt[it];
          const float* row = s + it * nyx;
          float sv[kCells];
#pragma unroll
          for (int a = 0; a < kCells; ++a) sv[a] = row[cell_r[a]];
#pragma unroll
          for (int a = 0; a < kCells; ++a) {
            const float prior = __fmul_rn(__fsub_rn(pt, q[a]), k.weight);
            const float v =
                __fadd_rn(sv[a], coarse ? __fmul_rn(scale, prior) : prior);
            const bool take = (a < gcells) & !isnan(gv) & !(v <= gv);
            gv = take ? v : gv;
            gi = take ? it * nyx + cell_r[a] : gi;
          }
        }
        if (!kGroups || before(gv, gi, bv, bi)) {
          bv = gv;
          bi = gi;
        }
      }
      if (bi < 0) bi = h * nyx + r0;
    }
    // a particle's lanes are one aligned run of a warp (lanes <= 32) or
    // whole warps: shuffles within the run, then its warps' picks in
    // shared memory
    for (int off = min(L, kWarp) / 2; off > 0; off /= 2) {
      const float w = __shfl_xor_sync(0xffffffffu, bv, off);
      const int i = __shfl_xor_sync(0xffffffffu, bi, off);
      if (before(w, i, bv, bi)) {
        bv = w;
        bi = i;
      }
    }
    if (L > kWarp) {                         // a particle a team: warp 0's
      if (lane == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
      }
      team_sync(bar, T);
      if (warp == 0) {
        const int nw = L / kWarp;
        bv = lane < nw ? red_v[lane] : 0.0f;
        bi = lane < nw ? red_i[lane] : -1;
        for (int off = nw / 2; off > 0; off /= 2) {
          const float w = __shfl_xor_sync(0xffffffffu, bv, off);
          const int i = __shfl_xor_sync(0xffffffffu, bi, off);
          if (before(w, i, bv, bi)) {
            bv = w;
            bi = i;
          }
        }
      }
    }
    if (mine && l == 0) {
      const int it = bi / nyx, r = bi - it * nyx, iy = r / k.nx;
      pick[3 * g] = it;
      pick[3 * g + 1] = iy;
      pick[3 * g + 2] = r - iy * k.nx;
      if (off_xy == nullptr) {
        const float sv = sl[g * n + bi];
        meas_best[p0 + g] = coarse ? __fmul_rn(c[6], sv) : sv;
      }
    }
    team_sync(bar, T);
    if (off_xy != nullptr) {
      for (int e = tt; e < qn * k.n_xy; e += T) {
        const int u = e / k.n_xy, a = e - u * k.n_xy;
        const size_t o = static_cast<size_t>(p0) * k.n_xy + e;
        out_dxs[o] = __fadd_rn(b.ox[u * k.nx + pick[3 * u + 2]], off_xy[a]);
        out_dys[o] = __fadd_rn(b.oy[u * k.ny + pick[3 * u + 1]], off_xy[a]);
      }
      for (int e = tt; e < qn * k.n_t; e += T) {
        const int u = e / k.n_t, a = e - u * k.n_t;
        out_dts[static_cast<size_t>(p0) * k.n_t + e] =
            __fadd_rn(b.ot[u * k.nt + pick[3 * u]], off_t[a]);
      }
    } else {
      for (int e = tt; e < 3 * qn; e += T) {
        const int u = e / 3, a = e - 3 * u;
        const float f = a == 0 ? b.ox[u * k.nx + pick[3 * u + 2]]
                               : (a == 1 ? b.oy[u * k.ny + pick[3 * u + 1]]
                                         : b.ot[u * k.nt + pick[3 * u]]);
        best[3 * static_cast<size_t>(p0) + e] = __fadd_rn(b.ps[e], f);
      }
    }
    team_sync(bar, T);
  }
}

// ------------------------------------------------------------------- F4
// float32 roundings of pi and 2 pi, as Python's math.pi and 2 * math.pi
// enter float maths
constexpr float kPiF = 3.14159265358979323846f;
constexpr float kTwoPiF = 6.28318530717958647692f;

struct Surface {
  int nt, hc, wc, wrap;
  long long st, sy;          // the volume's strides along theta and y
  float ox, oy;              // the map origin
  float inv_res, inv_dt;     // 1 / resolution and 1 / dtheta, in float
  float step_xy, step_t;     // the hill-climb's moves: resolution, dtheta
  int temper;                // the score's temperature: 0 none, 1 `temp`,
  float temp;                // 2 rsqrt of the used beams (n_used)
};

// models/shared.surface_temper on a score as F4 writes it: times the fixed
// temperature, or times rsqrt(n_used) as torch.rsqrt computes it on the
// card (the CUDA math library's rsqrtf), n_used F6's used-beam count.
__device__ __forceinline__ float temper(float score, const Surface& s,
                                        const float* n_used) {
  if (s.temper == 1) return __fmul_rn(score, s.temp);
  if (s.temper == 2) return __fmul_rn(score, rsqrtf(*n_used));
  return score;
}

// torch.remainder(a, b) of floats on the card: fmod (exact), then b added
// where the remainder's sign is not b's.
__device__ __forceinline__ float remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, b);
  return m;
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo,
                                              long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.sum over a last axis of 8 on the card: PyTorch's reduction gives
// each of 8 lanes one term (added to its 0) and adds them by shuffles down
// by 4, 2 and 1: ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)), the
// order that makes F2's pooled mean ((a + c) + (b + d))
// (chip_smoke.sample_order checks it on the card among five others).
__device__ __forceinline__ float sum8(const float (&p)[8]) {
  float l[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) l[k] = __fadd_rn(0.0f, p[k]);
  return __fadd_rn(__fadd_rn(__fadd_rn(l[0], l[4]), __fadd_rn(l[2], l[6])),
                   __fadd_rn(__fadd_rn(l[1], l[5]), __fadd_rn(l[3], l[7])));
}

// ops/surface.sample_surface's packed branch at one pose: the trilinear
// sample of the volume, its taps at the cells the packed array holds (the
// base cell clamped to [-1, n - 1] + 1, each tap's cell wrapped modulo nt or
// clamped along theta, clamped to the crop along y and x).
__device__ float surface_sample(const float* __restrict__ vol, float x,
                                float y, float th, float theta0, float iy0,
                                float ix0, const Surface& s) {
  const float fx = __fsub_rn(
      __fsub_rn(__fmul_rn(__fsub_rn(x, s.ox), s.inv_res), 0.5f), ix0);
  const float fy = __fsub_rn(
      __fsub_rn(__fmul_rn(__fsub_rn(y, s.oy), s.inv_res), 0.5f), iy0);
  const float d = __fsub_rn(th, theta0);
  const float dt =
      s.wrap ? remainder(d, kTwoPiF)
             : __fsub_rn(remainder(__fadd_rn(d, kPiF), kTwoPiF), kPiF);
  const float ft = __fmul_rn(dt, s.inv_dt);
  const float x0 = floorf(fx), y0 = floorf(fy), t0 = floorf(ft);
  const float tx = __fsub_rn(fx, x0), ty = __fsub_rn(fy, y0),
              tt = __fsub_rn(ft, t0);
  const long long tb =
      clamp_ll(static_cast<long long>(t0), s.wrap ? 0 : -1, s.nt - 1) + 1;
  const long long yb = clamp_ll(static_cast<long long>(y0), -1, s.hc - 1) + 1;
  const long long xb = clamp_ll(static_cast<long long>(x0), -1, s.wc - 1) + 1;
  long long ts[2], ys[2], xs[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const long long t = tb + o - 1;
    ts[o] = s.wrap ? (t == s.nt ? 0 : t) : clamp_ll(t, 0, s.nt - 1);
    ys[o] = clamp_ll(yb + o - 1, 0, s.hc - 1);
    xs[o] = clamp_ll(xb + o - 1, 0, s.wc - 1);
  }
  const float wt[2] = {__fsub_rn(1.0f, tt), tt};
  const float wy[2] = {__fsub_rn(1.0f, ty), ty};
  const float wx[2] = {__fsub_rn(1.0f, tx), tx};
  float p[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int a = k >> 2, b = (k >> 1) & 1, c = k & 1;
    const float w = __fmul_rn(__fmul_rn(wt[a], wy[b]), wx[c]);
    p[k] = __fmul_rn(vol[ts[a] * s.st + ys[b] * s.sy + xs[c]], w);
  }
  return sum8(p);
}

// F4.  vol: (nt, hc, wc), cell (t, y, x) at t st + y sy + x; poses (n, 3);
// theta0, iy0, ix0: one value each on the card.  scores_out = the sample at
// each pose, then `steps` steps of refine_on_surface's hill-climb from it
// -- the six candidates pose + (+-r, 0, 0), (0, +-r, 0), (0, 0, +-dtheta),
// the first argmax of their samples (a NaN first), taken where strictly
// above the score -- the poses into poses_out (steps > 0).
__global__ void __launch_bounds__(kThreads) fusion_sample_kernel(
    const float* __restrict__ vol, const float* __restrict__ poses,
    const float* __restrict__ theta0, const long long* __restrict__ iy0,
    const long long* __restrict__ ix0, const float* __restrict__ n_used,
    float* __restrict__ poses_out, float* __restrict__ scores_out, int n,
    int steps, Surface s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t0 = *theta0;
  const float fy0 = static_cast<float>(*iy0), fx0 = static_cast<float>(*ix0);
  float x = poses[3 * i], y = poses[3 * i + 1], th = poses[3 * i + 2];
  float score = surface_sample(vol, x, y, th, t0, fy0, fx0, s);
  if (steps == 0) {
    scores_out[i] = temper(score, s, n_used);
    return;
  }
  for (int step = 0; step < steps; ++step) {
    float bv = 0.0f, bx = x, by = y, bt = th;
    int bj = -1;
#pragma unroll 1
    for (int j = 0; j < 6; ++j) {
      const int axis = j >> 1;
      const float m = (axis == 2 ? s.step_t : s.step_xy) * ((j & 1) ? -1.0f
                                                                    : 1.0f);
      const float cx = __fadd_rn(x, axis == 0 ? m : 0.0f);
      const float cy = __fadd_rn(y, axis == 1 ? m : 0.0f);
      const float ct = __fadd_rn(th, axis == 2 ? m : 0.0f);
      const float v = surface_sample(vol, cx, cy, ct, t0, fy0, fx0, s);
      if (before(v, j, bv, bj)) {
        bv = v;
        bj = j;
        bx = cx;
        by = cy;
        bt = ct;
      }
    }
    if (bv > score) {
      x = bx;
      y = by;
      th = bt;
      score = bv;
    }
  }
  poses_out[3 * i] = x;
  poses_out[3 * i + 1] = y;
  poses_out[3 * i + 2] = th;
  scores_out[i] = temper(score, s, n_used);
}

// ------------------------------------------------------------------- F5
// F5.  px, py, wgt: (B,); thetas (nt,).  ops/surface.splat_factors: each
// endpoint rotated by each bin's heading into the (K, K) kernel frame, K =
// 2 kc + 1, its base cell clamped to [0, K - 2]; a_yw (nt, B, K) = the two
// row taps' weights (zero elsewhere) times the beam's weight, a_x (nt, B,
// K) the two column taps' weights.
__global__ void __launch_bounds__(kThreads) fusion_splat_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ wgt, const float* __restrict__ thetas,
    float* __restrict__ a_yw, float* __restrict__ a_x, int nt, int B, int kc,
    float inv_res) {
  const int lane = threadIdx.x % kWarp;
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x / kWarp)
                        + threadIdx.x / kWarp;
  if (row >= static_cast<long long>(nt) * B) return;
  const int t = static_cast<int>(row / B), b = static_cast<int>(row % B);
  const int K = 2 * kc + 1;
  const float c = cosf(thetas[t]), sn = sinf(thetas[t]);
  const float X = px[b], Y = py[b], kcf = static_cast<float>(kc);
  const float ex = __fadd_rn(
      __fmul_rn(__fsub_rn(__fmul_rn(X, c), __fmul_rn(Y, sn)), inv_res), kcf);
  const float ey = __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(X, sn), __fmul_rn(Y, c)), inv_res), kcf);
  const float hi = static_cast<float>(K - 2);
  // torch.clamp keeps a NaN
  const float fx = floorf(ex), fy = floorf(ey);
  const float x0 = isnan(fx) ? fx : fminf(fmaxf(fx, 0.0f), hi);
  const float y0 = isnan(fy) ? fy : fminf(fmaxf(fy, 0.0f), hi);
  const float tx = __fsub_rn(ex, x0), ty = __fsub_rn(ey, y0);
  const long long x0i = static_cast<long long>(x0);
  const long long y0i = static_cast<long long>(y0);
  const float omx = __fsub_rn(1.0f, tx), omy = __fsub_rn(1.0f, ty);
  const float w = wgt[b];
  float* oy = a_yw + row * K;
  float* ox = a_x + row * K;
  for (int j = lane; j < K; j += kWarp) {
    const float ay = __fadd_rn(j == y0i ? omy : 0.0f, j == y0i + 1 ? ty : 0.0f);
    const float ax = __fadd_rn(j == x0i ? omx : 0.0f, j == x0i + 1 ? tx : 0.0f);
    oy[j] = __fmul_rn(ay, w);
    ox[j] = ax;
  }
}

// ------------------------------------------------------------------- F6
constexpr int kScanThreads = 256;

// The order PyTorch's stable argsort of a row of B floats gives on the
// card: by `<` (a NaN last; -0.0 and +0.0 equal, at 96, 192 and 360 beam
// slots alike: chip_smoke.scan_ties), equal keys in index order.
__device__ __forceinline__ bool sorts_before(float v, int i, float w, int j) {
  const bool lt = (isnan(w) && !isnan(v)) || v < w;
  const bool gt = (isnan(v) && !isnan(w)) || w < v;
  return lt || (!gt && i < j);
}

// int64 % of PyTorch (Python's): the remainder takes the divisor's sign.
__device__ __forceinline__ int py_mod(int a, int n) {
  const int r = a % n;
  return (r != 0 && ((r < 0) != (n < 0))) ? r + n : r;
}

// F6's outputs of the (deskewed) scan beside the deskew and the tables
// (each null where not asked for): the endpoints px = dist cos(angle),
// py = dist sin(angle) (ops/geometry.scan_points), the used beams use =
// valid & hit and wgt, their float32; every stride-th beam of px, py and use
// (B_c = ceil(B / stride) a scan); n_used = max(sum(wgt), 1); and, with
// the odometry, the map update's gate keep = |d_theta| <= keep_below as a
// float32 (0 where freeze).
struct ScanOut {
  float *px, *py, *wgt, *px_c, *py_c, *n_used, *keep;
  bool *use, *use_c;
  int stride, B_c, freeze;
  float keep_below;
};

// F6.  angle, dist (G, B) float32, hit, valid (G, B) bool; d_center,
// d_theta (G,) or null.  With odometry: ops/geometry.deskew_scan into
// out_angle, out_dist.  With n_bins > 0: ops/cuda/grid_update.
// scan_bin_tables of the (deskewed) scan into t_dist, t_alpha, t_code
// (G, n_bins): the valid beams' wrapped angles (+inf for the others)
// argsorted, each bin center's searchsorted position (side left), the
// nearer of the two beams around it (left on a tie) and that beam's data.
// Then, kPoints, the outputs of `o` asked for (ScanOut), from the same
// beams: the used-beam count is an integer sum (exact, as the float sum of
// 0 and 1 it replaces); without them (the tables or the deskew alone) the
// kernel is the one it was before them.
template <bool kPoints>
__global__ void __launch_bounds__(kScanThreads) fusion_scan_kernel(
    const float* __restrict__ angle, const float* __restrict__ dist,
    const bool* __restrict__ hit, const bool* __restrict__ valid,
    const float* __restrict__ d_center, const float* __restrict__ d_theta,
    float* __restrict__ out_angle, float* __restrict__ out_dist,
    float* __restrict__ t_dist, float* __restrict__ t_alpha,
    float* __restrict__ t_code, int B, int n_bins, float bin_step,
    ScanOut o) {
  extern __shared__ float sm[];
  float* a_use = sm;              // the (deskewed) angles
  float* d_use = a_use + B;       // and distances
  float* key = d_use + B;         // the sort's keys
  float* sorted = key + B;
  int* order = reinterpret_cast<int*>(sorted + B);
  __shared__ int count, used;
  const int g = blockIdx.x;
  const size_t row = static_cast<size_t>(g) * B;
  if (threadIdx.x == 0) count = used = 0;
  __syncthreads();
  int mine = 0;
  for (int i = threadIdx.x; i < B; i += blockDim.x) mine += valid[row + i];
  atomicAdd(&count, mine);        // an integer count: exact in any order
  __syncthreads();
  const int n_valid = max(count, 1);
  const float nf = static_cast<float>(n_valid);
  int mine_used = 0;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    float a = angle[row + i], d = dist[row + i];
    if (d_center != nullptr) {
      const float di = __fdiv_rn(-__fsub_rn(nf, static_cast<float>(i)), nf);
      const float ang = __fadd_rn(a, __fmul_rn(d_theta[g], di));
      const float xa = __fadd_rn(__fmul_rn(d, cosf(ang)),
                                 __fmul_rn(d_center[g], di));
      const float ya = __fmul_rn(d, sinf(ang));
      a = atan2f(ya, xa);
      d = __fsqrt_rn(__fadd_rn(__fmul_rn(xa, xa), __fmul_rn(ya, ya)));
      out_angle[row + i] = a;
      out_dist[row + i] = d;
    }
    a_use[i] = a;
    d_use[i] = d;
    key[i] = valid[row + i] ? wrap(a) : INFINITY;
    if (kPoints) {
      const bool u = valid[row + i] & hit[row + i];
      const float ex = __fmul_rn(d, cosf(a)), ey = __fmul_rn(d, sinf(a));
      o.px[row + i] = ex;
      o.py[row + i] = ey;
      o.use[row + i] = u;
      o.wgt[row + i] = u ? 1.0f : 0.0f;
      if (o.px_c != nullptr && i % o.stride == 0) {
        const size_t c = static_cast<size_t>(g) * o.B_c + i / o.stride;
        o.px_c[c] = ex;
        o.py_c[c] = ey;
        o.use_c[c] = u;
      }
      mine_used += u;
    }
  }
  if (kPoints) {
    if (o.keep != nullptr && threadIdx.x == 0)
      o.keep[g] = (fabsf(d_theta[g]) <= o.keep_below && !o.freeze) ? 1.0f
                                                                   : 0.0f;
    atomicAdd(&used, mine_used);
    __syncthreads();
    if (threadIdx.x == 0) o.n_used[g] = fmaxf(static_cast<float>(used), 1.0f);
  }
  if (n_bins <= 0) return;
  if (!kPoints) __syncthreads();
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const float v = key[i];
    int rank = 0;
    for (int j = 0; j < B; ++j) rank += sorts_before(key[j], j, v, i);
    sorted[rank] = v;
    order[rank] = i;
  }
  __syncthreads();
  const size_t out = static_cast<size_t>(g) * n_bins;
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
    const float c = __fadd_rn(
        __fmul_rn(__fadd_rn(static_cast<float>(j), 0.5f), bin_step), -kPiF);
    int lo = 0, hi = B;             // torch.searchsorted's binary search
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(sorted[mid] >= c)) lo = mid + 1;
      else hi = mid;
    }
    const int left = py_mod(lo - 1, n_valid), right = py_mod(lo, n_valid);
    const float dl = fabsf(wrap(__fsub_rn(c, sorted[left])));
    const float dr = fabsf(wrap(__fsub_rn(c, sorted[right])));
    const int beam = order[dl <= dr ? left : right];
    t_dist[out + j] = d_use[beam];
    t_alpha[out + j] = a_use[beam];
    t_code[out + j] = valid[row + beam] ? (hit[row + beam] ? 1.0f : 2.0f)
                                        : 0.0f;
  }
}

// ------------------------------------------------------------ F7 and F8
// The weights' fixed orders of ops/resample.py: rows of kRow values padded
// with +0.0, a thread a segment of kSeg of them.
constexpr int kRow = 1024;                  // ops/resample.ROW
constexpr int kSeg = 8;                     // ops/resample.SEG
constexpr int kRowThreads = kRow / kSeg;    // 128: a thread a segment
constexpr int kSearchThreads = kRow;        // F8's search: a thread a slot

// torch.exp of a float32 on the card: the CUDA math library's expf (no fast
// math), as PyTorch's exp kernel calls it; chip_smoke.py's exp probe holds
// it to torch.exp bit for bit over 1M values.
__device__ __forceinline__ float weight_exp(float x) { return expf(x); }

// A row's total from its kRowThreads threads' segment sums v: the halving
// tree s[i] + s[i + h] for h = 64, 32, ... 1 (ops/resample._halve), the
// steps below 32 by shuffles (lane i adds lane i + h).  The total is
// thread 0's; s holds kRowThreads floats.
__device__ float row_total(float v, float* s) {
  const int t = threadIdx.x;
  s[t] = v;
  __syncthreads();
  if (t < 64) s[t] = __fadd_rn(s[t], s[t + 64]);
  __syncthreads();
  if (t < kWarp) {
    v = __fadd_rn(s[t], s[t + kWarp]);
    for (int h = kWarp / 2; h >= 1; h >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, h));
  }
  __syncthreads();
  return v;
}

// The halving trees of C rows of q values x[c][i] (q a power of two, at
// most kRow; +0.0 past the given) over a block of kRowThreads threads:
// s[i] + s[i + h] for h = q / 2, ... 1, the C rows at once.  Thread t
// holds x[c][t + kRowThreads k] in v[c][k]; the levels h >= kRowThreads
// add within a thread (x[i] and x[i + h] are the same thread's), the
// levels 64 and 32 go through shared memory s (C kRowThreads floats), the
// rest by shuffles (lane i adds lane i + h).  The totals land in v[c][0]
// of thread 0.
template <int C>
__device__ void halve_block(float (&v)[C][kRow / kRowThreads], int q,
                            float* s) {
  const int t = threadIdx.x;
  int m = q > kRowThreads ? q / kRowThreads : 1;   // values a thread
#pragma unroll
  for (int half = kRow / kRowThreads / 2; half >= 1; half >>= 1)
    if (m > half) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < half; ++k)
          v[c][k] = __fadd_rn(v[c][k], v[c][k + half]);
      m = half;
    }
  int count = min(q, kRowThreads);
  for (; count > kWarp; count >>= 1) {
    const int h = count >> 1;
#pragma unroll
    for (int c = 0; c < C; ++c) s[c * kRowThreads + t] = v[c][0];
    __syncthreads();
    if (t < h)
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[c][0] = __fadd_rn(v[c][0], s[c * kRowThreads + t + h]);
    __syncthreads();
  }
  if (t < kWarp) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float x = t < count ? v[c][0] : 0.0f;
      for (int h = count >> 1; h >= 1; h >>= 1)
        x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, h));
      v[c][0] = x;
    }
  }
}

// The total of nb row totals (read through L2: other blocks of the same
// launch may have written them), padded with +0.0 to the power of two q at
// or above nb and halved from q / 2 (halve_block); every thread gets it.
// s holds kRowThreads floats.
__device__ float rows_total(const float* part, int nb, float* s) {
  int q = 1;
  while (q < nb) q <<= 1;
  float v[1][kRow / kRowThreads];
#pragma unroll
  for (int k = 0; k < kRow / kRowThreads; ++k) {
    const int i = threadIdx.x + k * kRowThreads;
    v[0][k] = i < nb ? __ldcg(part + i) : 0.0f;
  }
  halve_block<1>(v, q, s);
  __shared__ float total;
  if (threadIdx.x == 0) total = v[0][0];
  __syncthreads();
  return total;
}

// The first maximum (a NaN first, torch.argmax's) of every thread's (v, i)
// of the block, in before()'s total order, so that any pairing gives it;
// every thread gets it.  s_v, s_i hold kWarp entries.
__device__ void block_argmax(float& v, int& i, float* s_v, int* s_i) {
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float w = __shfl_xor_sync(0xffffffffu, v, off);
    const int j = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
  }
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x / kWarp) ? s_v[lane] : 0.0f;
  i = lane < static_cast<int>(blockDim.x / kWarp) ? s_i[lane] : -1;
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float w = __shfl_xor_sync(0xffffffffu, v, off);
    const int j = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
  __syncthreads();
}

// The first maximum over nb rows' (value, index) pairs.
__device__ void rows_argmax(const float* pv, const int* pi, int nb, float& v,
                            int& i, float* s_v, int* s_i) {
  v = 0.0f;
  i = -1;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const float w = __ldcg(pv + b);
    const int j = __ldcg(pi + b);
    if (before(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
  block_argmax(v, i, s_v, s_i);
}

// The row totals of four values a thread, row_total's tree for the four
// at once (three barriers, not twelve); thread 0 gets them in a.  s holds
// 4 kRowThreads floats.
__device__ void row_totals4(float (&a)[4], float* s) {
  const int t = threadIdx.x;
  for (int c = 0; c < 4; ++c) s[c * kRowThreads + t] = a[c];
  __syncthreads();
  if (t < 64)
    for (int c = 0; c < 4; ++c)
      s[c * kRowThreads + t] =
          __fadd_rn(s[c * kRowThreads + t], s[c * kRowThreads + t + 64]);
  __syncthreads();
  if (t < kWarp) {
    for (int c = 0; c < 4; ++c) {
      float v = __fadd_rn(s[c * kRowThreads + t],
                          s[c * kRowThreads + t + kWarp]);
      for (int h = kWarp / 2; h >= 1; h >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, h));
      a[c] = v;
    }
  }
  __syncthreads();
}

// The totals of four rows of nb > 1 partials (part + c nb), each
// rows_total's tree (padded to the power of two q at or above nb, halved
// from q / 2; halve_block), the four at once; thread 0 gets them.  s holds
// 4 kRowThreads floats.
__device__ void rows_totals4(const float* part, int nb, float* s,
                             float (&out)[4]) {
  int q = 1;
  while (q < nb) q <<= 1;
  float v[4][kRow / kRowThreads];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < kRow / kRowThreads; ++k) {
      const int i = threadIdx.x + k * kRowThreads;
      v[c][k] = i < nb ? __ldcg(part + c * nb + i) : 0.0f;
    }
  halve_block<4>(v, q, s);
  for (int c = 0; c < 4; ++c) out[c] = v[c][0];
}

// A window F7's epilogue places (ops/cuda/fusions.WindowSpec): mode 1,
// the surface volume's, around the odometry-propagated weighted mean
// (apply_odometry by (dc, dt)): the center (3,), the crop's corner, the
// extended window's (hce x wce, the crop plus the blur radius r, clamped
// to the map) and the crop's offset in it, into cells (6,) int64, and
// theta0 with the nt bins theta0 + t dtheta into thetas (1 + nt,); mode 2,
// the map update's, the crop's corner around the integration pose into
// cells (2,).  ops/surface.crop_center_cells' float order: (x - origin) /
// resolution as a product by the float reciprocal, rounded half to even.
struct Window {
  int mode;                         // 0 none, 1 the volume's, 2 the map's
  int hc, wc, h, w, r, hce, wce, nt;
  float ox, oy, inv_res, t_off, dtheta;
  const float *dc, *dt;             // the odometry (mode 1)
  float *center, *thetas;
  long long* cells;
};

// ops/surface.crop_center_cells: the (iy0, ix0) of an hc x wc crop of an
// h x w map centered at (x, y), clamped inside.
__device__ __forceinline__ void crop_corner(float x, float y, int hc, int wc,
                                            const Window& k, long long* out) {
  const float cx = __fmul_rn(__fsub_rn(x, k.ox), k.inv_res);
  const float cy = __fmul_rn(__fsub_rn(y, k.oy), k.inv_res);
  out[0] = clamp_ll(static_cast<long long>(rintf(cy)) - hc / 2, 0, k.h - hc);
  out[1] = clamp_ll(static_cast<long long>(rintf(cx)) - wc / 2, 0, k.w - wc);
}

// The window of mode 1 from the weighted mean pose (x, y, t), one thread.
__device__ void volume_window(const Window& k, float x, float y, float t) {
  const float dc = *k.dc, th = wrap(__fadd_rn(t, *k.dt));
  const float cx = __fadd_rn(x, __fmul_rn(cosf(th), dc));
  const float cy = __fadd_rn(y, __fmul_rn(sinf(th), dc));
  k.center[0] = cx;
  k.center[1] = cy;
  k.center[2] = th;
  long long* c = k.cells;
  crop_corner(cx, cy, k.hc, k.wc, k, c);
  c[2] = clamp_ll(c[0] - k.r, 0, k.h - k.hce);
  c[3] = clamp_ll(c[1] - k.r, 0, k.w - k.wce);
  c[4] = c[0] - c[2];
  c[5] = c[1] - c[3];
  const float theta0 = __fadd_rn(th, k.t_off);
  k.thetas[0] = theta0;
  for (int i = 0; i < k.nt; ++i)
    k.thetas[1 + i] =
        __fadd_rn(theta0, __fmul_rn(static_cast<float>(i), k.dtheta));
}

struct WeightsOut {
  const float* poses;               // (R, P, 3)
  const float* recov;               // (2,) or null: the recovery EMAs
  const int* step;                  // the scan counter, with recov
  float *max, *total, *best, *neff, *weighted;   // (R,), (R,), (R, 3) ...
  long long* index;                 // (R,)
  float *integ, *recov_out, *p_inject;           // R = 1 only, or null
  bool* gate;                       // (R,), or null: no epilogue
  float thr_integ, thr_gate;        // 0.95 P and P resample_fraction
  float a_slow, a_fast, thr_inject, hi_inject;   // the recovery's floats
  Window win;                       // R = 1 only
};

// A thread's segment of kSeg log-weights x[base ..] (k < P; +0.0 past P),
// two 16-byte loads where the segment is whole and x 16-byte aligned.
__device__ __forceinline__ void load_segment(const float* x, int base, int P,
                                             float (&xv)[kSeg]) {
  if (base + kSeg <= P && (reinterpret_cast<size_t>(x) & 15u) == 0) {
    const float4 u = *reinterpret_cast<const float4*>(x + base);
    const float4 w = *reinterpret_cast<const float4*>(x + base + 4);
    xv[0] = u.x, xv[1] = u.y, xv[2] = u.z, xv[3] = u.w;
    xv[4] = w.x, xv[5] = w.y, xv[6] = w.z, xv[7] = w.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j) xv[j] = base + j < P ? x[base + j] : 0.0f;
}

// A segment's sums of w w, x w, y w and wrap(theta) w, in turn, w =
// exp(x - m) / total (+0.0 past P); the segment's poses (kSeg, 3) at
// `pose` in shared memory, 16-byte aligned, read by six 16-byte loads.
__device__ __forceinline__ void segment_moments(const float (&xv)[kSeg],
                                                int base, int P, float m,
                                                float total,
                                                const float* pose,
                                                float (&a)[4]) {
  float pv[3 * kSeg];
#pragma unroll
  for (int u = 0; u < 3 * kSeg / 4; ++u) {
    const float4 f = reinterpret_cast<const float4*>(pose)[u];
    pv[4 * u] = f.x, pv[4 * u + 1] = f.y, pv[4 * u + 2] = f.z,
    pv[4 * u + 3] = f.w;
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (base + j < P) {
      const float w = __fdiv_rn(weight_exp(__fsub_rn(xv[j], m)), total);
      q[0] = __fmul_rn(w, w);
      q[1] = __fmul_rn(pv[3 * j], w);
      q[2] = __fmul_rn(pv[3 * j + 1], w);
      q[3] = __fmul_rn(wrap(pv[3 * j + 2]), w);
    }
    for (int c = 0; c < 4; ++c) a[c] = j == 0 ? q[c] : __fadd_rn(a[c], q[c]);
  }
}

// Robot r's epilogue from its max m, Neff, best pose bp and weighted mean
// pose `mean` (3): the volume's window (mode 1) and, where o.gate is given,
// the resample gate Neff < P fraction, the integration pose (the weighted
// mean where Neff >= 0.95 P, else the best pose) with the map update's
// window (mode 2), and with recov the recovery EMAs of the max (both set to
// it at step 0), p_inject = clamp(1 - exp(l_fast - l_slow), 0, 0.3) and the
// gate forced where p_inject > 0.05.  One thread.
__device__ void weights_epilogue(const WeightsOut& o, int r,
                                 const float (&bp)[3], float m, float neff,
                                 const float* mean) {
  if (o.win.mode == 1) volume_window(o.win, mean[0], mean[1], mean[2]);
  if (o.gate == nullptr) return;
  bool gate = neff < o.thr_gate;
  if (o.integ != nullptr) {
    const bool use_mean = neff >= o.thr_integ;
    for (int c = 0; c < 3; ++c) o.integ[c] = use_mean ? mean[c] : bp[c];
    if (o.win.mode == 2)
      crop_corner(use_mean ? mean[0] : bp[0], use_mean ? mean[1] : bp[1],
                  o.win.hc, o.win.wc, o.win, o.win.cells);
  }
  if (o.recov != nullptr) {
    const float r0 = o.recov[0], r1 = o.recov[1];
    float slow = __fadd_rn(r0, __fmul_rn(__fsub_rn(m, r0), o.a_slow));
    float fast = __fadd_rn(r1, __fmul_rn(__fsub_rn(m, r1), o.a_fast));
    if (*o.step == 0) slow = fast = m;
    float p = __fsub_rn(1.0f, weight_exp(__fsub_rn(fast, slow)));
    if (!isnan(p)) p = fminf(fmaxf(p, 0.0f), o.hi_inject);
    o.recov_out[0] = slow;
    o.recov_out[1] = fast;
    o.p_inject[0] = p;
    gate = gate || p > o.thr_inject;
  }
  o.gate[r] = gate;
}

// One robot's outputs from its max m (the value at its first argmax mi),
// total and the sums of w w, x w, y w and wrap(theta) w: the best pose,
// Neff = 1 / sum(w w), the weighted mean pose and the epilogue
// (weights_epilogue).  One thread.
__device__ void weights_outputs(const WeightsOut& o, int r, const float* ps,
                                float m, int mi, float total,
                                const float (&sums)[4]) {
  const float bp[3] = {ps[3 * mi], ps[3 * mi + 1], ps[3 * mi + 2]};
  const float neff = __fdiv_rn(1.0f, sums[0]);
  o.max[r] = m;
  o.total[r] = total;
  o.index[r] = mi;
  o.neff[r] = neff;
  for (int c = 0; c < 3; ++c) {
    o.best[3 * r + c] = bp[c];
    o.weighted[3 * r + c] = sums[1 + c];
  }
  weights_epilogue(o, r, bp, m, neff, sums + 1);
}

// F7 where P <= kRow (one row a robot): a block a robot does the whole
// call.  Its poses are copied into shared memory (cp.async) while the
// block takes the row's first argmax, m, the sum of exp(lw - m) (the row's
// total is the robot's: one row's tree adds nothing) and the four
// moments' row trees at once.
__global__ void __launch_bounds__(kRowThreads) fusion_weights_row_kernel(
    const float* __restrict__ lw, int P, WeightsOut o) {
  __shared__ __align__(16) float sp[3 * kRow];
  __shared__ float s[4 * kRowThreads];
  __shared__ float s_v[kWarp];
  __shared__ int s_i[kWarp];
  __shared__ float s_total;
  const int r = blockIdx.x, base = threadIdx.x * kSeg;
  const float* x = lw + static_cast<size_t>(r) * P;
  const float* ps = o.poses + static_cast<size_t>(r) * P * 3;
  stage_async_in_place(sp, ps, 3 * P);
  float xv[kSeg];
  load_segment(x, base, P, xv);
  float v = 0.0f;
  int i = -1;
  for (int j = 0; j < kSeg; ++j)
    if (base + j < P && before(xv[j], base + j, v, i)) {
      v = xv[j];
      i = base + j;
    }
  block_argmax(v, i, s_v, s_i);
  const float m = v;
  float acc = 0.0f;
  for (int j = 0; j < kSeg; ++j) {
    const float e = base + j < P ? weight_exp(__fsub_rn(xv[j], m)) : 0.0f;
    acc = j == 0 ? e : __fadd_rn(acc, e);
  }
  const float tot = row_total(acc, s);
  if (threadIdx.x == 0) s_total = tot;
  cp_async_wait();
  __syncthreads();
  const float total = s_total;
  float a[4];
  segment_moments(xv, base, P, m, total, sp + 3 * base, a);
  row_totals4(a, s);
  if (threadIdx.x == 0) weights_outputs(o, r, ps, m, i, total, a);
}

// F7 over nb > 1 rows, pass 1: each row's first argmax of the log-weights
// lw (R, P) into pv, pi (R, nb); block (0, r) sets robot r's tickets of
// passes 2 and 3 to 0.
__global__ void __launch_bounds__(kRowThreads) fusion_weights_max_kernel(
    const float* __restrict__ lw, float* __restrict__ pv,
    int* __restrict__ pi, unsigned* __restrict__ ticket, int P, int nb) {
  __shared__ float s_v[kWarp];
  __shared__ int s_i[kWarp];
  const int r = blockIdx.y, b = blockIdx.x;
  const int base = b * kRow + threadIdx.x * kSeg;
  float xv[kSeg];
  load_segment(lw + static_cast<size_t>(r) * P, base, P, xv);
  float v = 0.0f;
  int i = -1;
  for (int j = 0; j < kSeg; ++j)
    if (base + j < P && before(xv[j], base + j, v, i)) {
      v = xv[j];
      i = base + j;
    }
  block_argmax(v, i, s_v, s_i);
  if (threadIdx.x == 0) {
    pv[static_cast<size_t>(r) * nb + b] = v;
    pi[static_cast<size_t>(r) * nb + b] = i;
    if (b == 0) ticket[2 * r] = ticket[2 * r + 1] = 0u;
  }
}

// Pass 2: the max m (the value at the first argmax of the rows'), then
// each row's sum of exp(lw - m), its segments in turn and the row by
// row_total, into pe (R, nb); the last block of a robot (its ticket) sums
// the rows once (rows_total) and writes the max, its index and the total,
// which pass 3 and F8 read.
__global__ void __launch_bounds__(kRowThreads) fusion_weights_sum_kernel(
    const float* __restrict__ lw, const float* __restrict__ pv,
    const int* __restrict__ pi, float* __restrict__ pe,
    unsigned* __restrict__ ticket, int P, int nb, WeightsOut o) {
  __shared__ float s[kRow];
  __shared__ float s_v[kWarp];
  __shared__ int s_i[kWarp];
  __shared__ bool last;
  const int r = blockIdx.y, b = blockIdx.x;
  const int base = b * kRow + threadIdx.x * kSeg;
  float xv[kSeg];
  load_segment(lw + static_cast<size_t>(r) * P, base, P, xv);
  float m;
  int mi;
  rows_argmax(pv + static_cast<size_t>(r) * nb, pi + static_cast<size_t>(r) * nb,
              nb, m, mi, s_v, s_i);
  float acc = 0.0f;
  for (int j = 0; j < kSeg; ++j) {
    const float e = base + j < P ? weight_exp(__fsub_rn(xv[j], m)) : 0.0f;
    acc = j == 0 ? e : __fadd_rn(acc, e);
  }
  const float tot = row_total(acc, s);
  if (threadIdx.x == 0) pe[static_cast<size_t>(r) * nb + b] = tot;
  __threadfence();
  if (threadIdx.x == 0) last = atomicAdd(ticket + 2 * r, 1u) == nb - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float total = rows_total(pe + static_cast<size_t>(r) * nb, nb, s);
  if (threadIdx.x == 0) {
    o.max[r] = m;
    o.index[r] = mi;
    o.total[r] = total;
  }
}

// Pass 3: m and the total as pass 2 wrote them; the block's poses copied
// into shared memory (cp.async) as it starts; each weight w = exp(lw - m)
// / total and the row's four sums at once into p4 (R, 4, nb); then the
// last block of a robot (its ticket) sums the rows' four partials at once
// (rows_totals4) and writes the outputs (weights_outputs).
__global__ void __launch_bounds__(kRowThreads) fusion_weights_finish_kernel(
    const float* __restrict__ lw, float* __restrict__ p4,
    unsigned* __restrict__ ticket, int P, int nb, WeightsOut o) {
  __shared__ __align__(16) float sp[3 * kRow];
  __shared__ float s[4 * kRowThreads];
  __shared__ bool last;
  const int r = blockIdx.y, b = blockIdx.x;
  const int base = b * kRow + threadIdx.x * kSeg;
  const float* ps = o.poses + static_cast<size_t>(r) * P * 3;
  stage_async_in_place(sp, ps + static_cast<size_t>(b) * kRow * 3,
                       3 * min(kRow, P - b * kRow));
  float xv[kSeg];
  load_segment(lw + static_cast<size_t>(r) * P, base, P, xv);
  const float m = __ldcg(o.max + r), total = __ldcg(o.total + r);
  cp_async_wait();
  __syncthreads();
  float a[4];
  segment_moments(xv, base, P, m, total, sp + 3 * threadIdx.x * kSeg, a);
  row_totals4(a, s);
  float* row = p4 + static_cast<size_t>(r) * 4 * nb;
  if (threadIdx.x == 0)
    for (int c = 0; c < 4; ++c) row[static_cast<size_t>(c) * nb + b] = a[c];
  __threadfence();
  if (threadIdx.x == 0) last = atomicAdd(ticket + 2 * r + 1, 1u) == nb - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float sums[4];
  rows_totals4(row, nb, s, sums);
  if (threadIdx.x == 0)
    weights_outputs(o, r, ps, m, static_cast<int>(__ldcg(o.index + r)),
                    total, sums);
}

// F7's mesh form (parallel/shmap.finish_step and its center call): the
// same sums over one rank's P rows of weights, as three passes a launch
// each, so that a collective over the ranks can take each pass's result
// before the next pass reads it from the card: A the first argmax, [pmax],
// B the sum of exp(lw - m) at the ranks' max, [psum], C the four moments
// at the ranks' total, [psum, all_gather of A's candidate], then one
// block's epilogue.  A pass's rows' partials are summed once, by its last
// block (a ticket of its own, zeroed with the others before pass A by one
// memset: a pass cannot zero its own ticket as it starts, and a CUDA graph
// replays with whatever the last replay left).  The trees are F7's, so a
// rank's partials are ops/resample's fixed order over its rows, and on one
// rank the collectives give back F7's max, total and sums bit for bit.
// F8's mesh form runs passes A and B (and F8's two passes) over the
// gathered rows through kernels of its own names, fusion_walk_mesh_*, on
// the same bodies.

// A segment of kSeg weights of x with element stride ld (1: the weights
// (P,); 4: the gathered rows (lw, x, y, theta) of F8's mesh form), +0.0
// past P.
__device__ __forceinline__ void load_segment_ld(const float* x, int ld,
                                                int base, int P,
                                                float (&xv)[kSeg]) {
  if (ld == 1) {
    load_segment(x, base, P, xv);
    return;
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j)
    xv[j] = base + j < P ? x[static_cast<size_t>(base + j) * ld] : 0.0f;
}

// Pass A: each row's first argmax of lw (element stride ld) into pv, pi
// (nb); the last block (ticket[0]) takes the rows' first argmax (m, mi)
// and writes the candidate cand = (m, the pose at mi, mi as a float), or m
// alone where poses (P, 3) is null.
__device__ __forceinline__ void mesh_max(const float* lw, int ld,
                                         const float* poses, float* pv,
                                         int* pi, unsigned* ticket, int P,
                                         int nb, float* cand) {
  __shared__ float s_v[kWarp];
  __shared__ int s_i[kWarp];
  __shared__ bool last;
  const int b = blockIdx.x, base = b * kRow + threadIdx.x * kSeg;
  float xv[kSeg];
  load_segment_ld(lw, ld, base, P, xv);
  float v = 0.0f;
  int i = -1;
  for (int j = 0; j < kSeg; ++j)
    if (base + j < P && before(xv[j], base + j, v, i)) {
      v = xv[j];
      i = base + j;
    }
  block_argmax(v, i, s_v, s_i);
  if (threadIdx.x == 0) {
    pv[b] = v;
    pi[b] = i;
  }
  __threadfence();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == nb - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  rows_argmax(pv, pi, nb, v, i, s_v, s_i);
  if (threadIdx.x == 0) {
    cand[0] = v;
    if (poses != nullptr) {
      for (int c = 0; c < 3; ++c) cand[1 + c] = poses[3 * i + c];
      cand[4] = static_cast<float>(i);
    }
  }
}

// Pass B: each row's sum of exp(lw - m) at the ranks' max *m_ptr (its
// segments in turn, the row by row_total) into pe (nb); the last block
// (ticket[1]) sums the rows once (rows_total) into *total.
__device__ __forceinline__ void mesh_sum(const float* lw, int ld,
                                         const float* m_ptr, float* pe,
                                         unsigned* ticket, int P, int nb,
                                         float* total) {
  __shared__ float s[kRowThreads];
  __shared__ bool last;
  const int b = blockIdx.x, base = b * kRow + threadIdx.x * kSeg;
  float xv[kSeg];
  load_segment_ld(lw, ld, base, P, xv);
  const float m = *m_ptr;
  float acc = 0.0f;
  for (int j = 0; j < kSeg; ++j) {
    const float e = base + j < P ? weight_exp(__fsub_rn(xv[j], m)) : 0.0f;
    acc = j == 0 ? e : __fadd_rn(acc, e);
  }
  const float tot = row_total(acc, s);
  if (threadIdx.x == 0) pe[b] = tot;
  __threadfence();
  if (threadIdx.x == 0) last = atomicAdd(ticket + 1, 1u) == nb - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float z = rows_total(pe, nb, s);
  if (threadIdx.x == 0) *total = z;
}

// F7's mesh pass A over the rank's weights (P,) and poses (P, 3).
__global__ void __launch_bounds__(kRowThreads) fusion_mesh_max_kernel(
    const float* __restrict__ lw, const float* __restrict__ poses,
    float* __restrict__ pv, int* __restrict__ pi,
    unsigned* __restrict__ ticket, int P, int nb, float* __restrict__ cand) {
  mesh_max(lw, 1, poses, pv, pi, ticket, P, nb, cand);
}

// F7's mesh pass B over the rank's weights (P,).
__global__ void __launch_bounds__(kRowThreads) fusion_mesh_sum_kernel(
    const float* __restrict__ lw, const float* __restrict__ m_ptr,
    float* __restrict__ pe, unsigned* __restrict__ ticket, int P, int nb,
    float* __restrict__ total) {
  mesh_sum(lw, 1, m_ptr, pe, ticket, P, nb, total);
}

// F8's mesh form, pass A over the gathered rows (P, 4): their max into
// stats[0].
__global__ void __launch_bounds__(kRowThreads) fusion_walk_mesh_max_kernel(
    const float* __restrict__ rows, float* __restrict__ pv,
    int* __restrict__ pi, unsigned* __restrict__ ticket, int P, int nb,
    float* __restrict__ stats) {
  mesh_max(rows, 4, nullptr, pv, pi, ticket, P, nb, stats);
}

// F8's mesh form, pass B over the gathered rows (P, 4) at stats[0]: their
// total into stats[1].
__global__ void __launch_bounds__(kRowThreads) fusion_walk_mesh_sum_kernel(
    const float* __restrict__ rows, float* __restrict__ pe,
    unsigned* __restrict__ ticket, int P, int nb,
    float* __restrict__ stats) {
  mesh_sum(rows, 4, stats, pe, ticket, P, nb, stats + 1);
}

// Pass C: w = exp(lw - m) / total at the ranks' *m_ptr and *total_ptr, each
// row's sums of w w, x w, y w and wrap(theta) w at once (the block's poses
// copied into shared memory by cp.async as it starts) into p4 (4, nb);
// the last block (ticket[2]) sums the rows' four partials at once
// (rows_totals4) into sums (4,).
__global__ void __launch_bounds__(kRowThreads) fusion_mesh_moments_kernel(
    const float* __restrict__ lw, const float* __restrict__ poses,
    const float* __restrict__ m_ptr, const float* __restrict__ total_ptr,
    float* __restrict__ p4, unsigned* __restrict__ ticket, int P, int nb,
    float* __restrict__ sums) {
  __shared__ __align__(16) float sp[3 * kRow];
  __shared__ float s[4 * kRowThreads];
  __shared__ bool last;
  const int b = blockIdx.x, base = b * kRow + threadIdx.x * kSeg;
  stage_async_in_place(sp, poses + static_cast<size_t>(b) * kRow * 3,
                       3 * min(kRow, P - b * kRow));
  float xv[kSeg];
  load_segment(lw, base, P, xv);
  const float m = *m_ptr, total = *total_ptr;
  cp_async_wait();
  __syncthreads();
  float a[4];
  segment_moments(xv, base, P, m, total, sp + 3 * threadIdx.x * kSeg, a);
  row_totals4(a, s);
  if (threadIdx.x == 0)
    for (int c = 0; c < 4; ++c) p4[static_cast<size_t>(c) * nb + b] = a[c];
  __threadfence();
  if (threadIdx.x == 0) last = atomicAdd(ticket + 2, 1u) == nb - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float out[4];
  rows_totals4(p4, nb, s, out);
  if (threadIdx.x == 0)
    for (int c = 0; c < 4; ++c) sums[c] = out[c];
}

// The mesh form's epilogue, one thread, from the ranks' max *m_ptr and
// sums.  The tail (cands given: the n ranks' candidates (n, 5) in rank
// order, sums = w w, x w, y w, wrap(theta) w): the strongest particle, the
// first argmax of the candidates' values in before()'s order (torch.argmax
// of the gathered rows), its pose and its index g p_loc + its local index,
// Neff = 1 / sum(w w), then weights_epilogue.  The center (cands null,
// sums = x w, y w, wrap(theta) w): the volume's window alone.
__global__ void __launch_bounds__(kWarp) fusion_mesh_finish_kernel(
    const float* __restrict__ m_ptr, const float* __restrict__ sums,
    const float* __restrict__ cands, int n, int p_loc, WeightsOut o) {
  if (threadIdx.x != 0) return;
  if (cands == nullptr) {
    if (o.win.mode == 1) volume_window(o.win, sums[0], sums[1], sums[2]);
    return;
  }
  float v = 0.0f;
  int g = -1;
  for (int k = 0; k < n; ++k)
    if (before(cands[5 * k], k, v, g)) {
      v = cands[5 * k];
      g = k;
    }
  const float* row = cands + 5 * g;
  const float bp[3] = {row[1], row[2], row[3]};
  const float neff = __fdiv_rn(1.0f, sums[0]);
  o.neff[0] = neff;
  o.index[0] = static_cast<long long>(g) * p_loc +
               static_cast<long long>(row[4]);
  for (int c = 0; c < 3; ++c) o.best[c] = bp[c];
  weights_epilogue(o, 0, bp, *m_ptr, neff, sums + 1);
}

// F8, pass 1: the normalized weights exp(lw - m) / total of one robot (m,
// total: F7's, one float each on the card; lw with element stride ld) and
// each row's inclusive scan in the fixed order into part (nb kRow): a
// thread's segment in turn, the row's segment totals by a Hillis-Steele
// scan (s[i] + s[i - k], k = 1, 2, ... 64), each segment after the first
// plus the scan before it.
__device__ __forceinline__ void walk_scan(const float* lw, int ld,
                                          const float* m_ptr,
                                          const float* total_ptr,
                                          float* part, int P) {
  __shared__ float s[kRowThreads];
  const float m = *m_ptr, total = *total_ptr;
  const int t = threadIdx.x, base = blockIdx.x * kRow + t * kSeg;
  float c[kSeg];
  for (int j = 0; j < kSeg; ++j) {
    const int k = base + j;
    const float w =
        k < P ? __fdiv_rn(weight_exp(__fsub_rn(lw[static_cast<size_t>(k) * ld],
                                               m)),
                          total)
              : 0.0f;
    c[j] = j == 0 ? w : __fadd_rn(c[j - 1], w);
  }
  s[t] = c[kSeg - 1];
  __syncthreads();
  for (int k = 1; k < kRowThreads; k <<= 1) {
    float v = s[t];
    if (t >= k) v = __fadd_rn(v, s[t - k]);
    __syncthreads();
    s[t] = v;
    __syncthreads();
  }
  const float carry = t > 0 ? s[t - 1] : 0.0f;
  for (int j = 0; j < kSeg; ++j)
    part[base + j] = t > 0 ? __fadd_rn(c[j], carry) : c[j];
}

// F8, pass 2: a thread a slot j of the window [base, base + count) of the
// P slots.  u = u0 + j (1 / P) (PyTorch divides by a Python int on the
// card as a product by its float reciprocal, inv_p); the first index whose
// cumulative weight is >= u, by torch.searchsorted's binary search (side
// left), clamped to P - 1; the cumulative weight at i is part[i], past the
// first row plus the Hillis-Steele scan of the rows' totals (each row's
// last) before its row (every block scans the nb <= kRow totals).  Writes
// idx[j - base] and the poses and log-weights (lw_out where given) at
// idx[j - base]; weight i at lw[i ld], its pose at poses[i pld ..].
__device__ __forceinline__ void walk_search(
    const float* lw, int ld, const float* poses, int pld, const float* u0_ptr,
    const float* part, long long* idx_out, float* poses_out, float* lw_out,
    int P, int nb, int base, int count, float inv_p) {
  __shared__ float carry[kRow];
  const int t = threadIdx.x;
  carry[t] = t < nb ? part[static_cast<size_t>(t) * kRow + kRow - 1] : 0.0f;
  __syncthreads();
  for (int k = 1; k < nb; k <<= 1) {
    float v = carry[t];
    if (t >= k) v = __fadd_rn(v, carry[t - k]);
    __syncthreads();
    carry[t] = v;
    __syncthreads();
  }
  const int slot = blockIdx.x * kSearchThreads + t;
  if (slot >= count) return;
  const int j = base + slot;
  const float u = __fadd_rn(*u0_ptr, __fmul_rn(static_cast<float>(j), inv_p));
  int lo = 0, hi = P;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int row = mid / kRow;
    const float v = row == 0 ? part[mid] : __fadd_rn(part[mid], carry[row - 1]);
    if (!(v >= u))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int i = min(max(lo, 0), P - 1);
  idx_out[slot] = i;
  for (int c = 0; c < 3; ++c)
    poses_out[3 * slot + c] = poses[static_cast<size_t>(i) * pld + c];
  if (lw_out != nullptr) lw_out[slot] = lw[static_cast<size_t>(i) * ld];
}

// F8's pass 1 over one robot's weights (P,).
__global__ void __launch_bounds__(kRowThreads) fusion_walk_scan_kernel(
    const float* __restrict__ lw, const float* __restrict__ m_ptr,
    const float* __restrict__ total_ptr, float* __restrict__ part, int P) {
  walk_scan(lw, 1, m_ptr, total_ptr, part, P);
}

// F8's pass 2 over one robot's weights (P,) and poses (P, 3), every slot.
__global__ void __launch_bounds__(kSearchThreads) fusion_walk_search_kernel(
    const float* __restrict__ lw, const float* __restrict__ poses,
    const float* __restrict__ u0_ptr, const float* __restrict__ part,
    long long* __restrict__ idx_out, float* __restrict__ poses_out,
    float* __restrict__ lw_out, int P, int nb, float inv_p) {
  walk_search(lw, 1, poses, 3, u0_ptr, part, idx_out, poses_out, lw_out, P,
              nb, 0, P, inv_p);
}

// F8's mesh form, pass 1 over the gathered rows (P, 4) at their max and
// total stats (2,).
__global__ void __launch_bounds__(kRowThreads) fusion_walk_mesh_scan_kernel(
    const float* __restrict__ rows, const float* __restrict__ stats,
    float* __restrict__ part, int P) {
  walk_scan(rows, 4, stats, stats + 1, part, P);
}

// F8's mesh form, pass 2 over the gathered rows (P, 4): the slots [base,
// base + count).
__global__ void __launch_bounds__(kSearchThreads)
    fusion_walk_mesh_search_kernel(
        const float* __restrict__ rows, const float* __restrict__ u0_ptr,
        const float* __restrict__ part, long long* __restrict__ idx_out,
        float* __restrict__ poses_out, float* __restrict__ lw_out, int P,
        int nb, int base, int count, float inv_p) {
  walk_search(rows, 4, rows + 1, 4, u0_ptr, part, idx_out, poses_out, lw_out,
              P, nb, base, count, inv_p);
}

// weight_exp elementwise, for the exp probe, and F4's rsqrtf, for the
// rsqrt probe (no path calls them).
__global__ void __launch_bounds__(kThreads) fusion_exp_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n, int rsqrt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rsqrt ? rsqrtf(x[i]) : weight_exp(x[i]);
}

}  // namespace

// F1: pose (n, 3); normals (n, 2) or null; d_center, d_theta (G,), G
// dividing n; out_s (n, 3) (with normals) and out_det (n, 3), either null;
// the motion config (base_theta in radians); stream.
extern "C" int gs_fusion_motion(const float* pose, const float* normals,
                                const float* d_center, const float* d_theta,
                                float* out_s, float* out_det, int n, int G,
                                float base_c, float rel_c, float base_t,
                                float rel_t, void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || G <= 0 || n % G || (out_s != nullptr) != (normals != nullptr))
    return cudaErrorInvalidValue;
  fusion_motion_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pose, normals, d_center, d_theta, out_s, out_det, n, n / G,
      Motion{base_c, rel_c, base_t, rel_t});
  return static_cast<int>(cudaGetLastError());
}

// F2: field (G, H, W) with strides sg, sh (cells contiguous); out
// (G, (H + 1) / 2, (W + 1) / 2); fill, the value past an odd edge; stream.
extern "C" int gs_fusion_pool(const float* field, float* out, int G, int H,
                              int W, long long sg, long long sh, float fill,
                              void* stream) {
  if (G < 0 || H < 0 || W < 0) return cudaErrorInvalidValue;
  const int ho = (H + 1) / 2, wo = (W + 1) / 2;
  const long long n = static_cast<long long>(G) * ho * wo;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fusion_pool_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      field, out, H, W, sg, sh, ho, wo, n, fill);
  return static_cast<int>(cudaGetLastError());
}

// F3: scores (P, nt, ny, nx); dxs (P, nx), dys (P, ny), dts (P, nt);
// pose0 (P, 3); center (P, 3) or null; d_center, d_theta (G_o,); use
// (G_b, B) bool, or null past the coarse stage; off_xy (n_xy,) and off_t
// (n_t,) with out_dxs, out_dys (P, n_xy) and out_dts (P, n_t), or null
// after the last stage, which writes best (P, 3) and meas_best (P,); then
// the shapes, the coarse stride, the launch plan (ops/cuda/fusions.
// pick_plan: lanes a particle, a power of two up to kPickThreads;
// particles a slab, lanes times them a team of max(lanes, 32) threads; the
// scores staged), prior_weight, the motion config (base_t in radians);
// stream.  As many blocks of kPickThreads as are resident at once, and no
// more than the slabs need, their teams taking the slabs in turn.  G_o and
// G_b divide P; P nt ny nx < 2^31.
extern "C" int gs_fusion_pick(
    const float* scores, const float* dxs, const float* dys,
    const float* dts, const float* pose0, const float* center,
    const float* d_center, const float* d_theta, const bool* use,
    const float* off_xy, const float* off_t, float* out_dxs, float* out_dys,
    float* out_dts, float* best, float* meas_best, int P, int nt, int ny,
    int nx, int G_o, int G_b, int B, int stride, int n_xy, int n_t,
    int lanes, int per_slab, int staged, float weight, float base_c,
    float rel_c, float base_t, float rel_t, void* stream) {
  if (P == 0) return cudaSuccess;
  if (P < 0 || nt <= 0 || ny <= 0 || nx <= 0 || G_o <= 0 || P % G_o ||
      static_cast<long long>(P) * nt * ny * nx >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (use != nullptr && (G_b <= 0 || P % G_b || B < 0 || stride <= 0))
    return cudaErrorInvalidValue;
  if (off_xy != nullptr ? (off_t == nullptr || out_dxs == nullptr ||
                           out_dys == nullptr || out_dts == nullptr ||
                           n_xy <= 0 || n_t <= 0)
                        : (best == nullptr || meas_best == nullptr))
    return cudaErrorInvalidValue;
  const int team = lanes * per_slab;
  if (lanes <= 0 || (lanes & (lanes - 1)) || per_slab <= 0 ||
      team != std::max(lanes, kWarp) || kPickThreads % team)
    return cudaErrorInvalidValue;
  const int rows = use != nullptr ? G_b : 0;
  const size_t smem =
      (kPickThreads / team *
           pick_team_floats(per_slab, team, nt, ny, nx, staged != 0) +
       (rows <= kPickRows ? 2 * rows : 0)) *
      sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // the instantiation: staged or not, and registers for the most (dy, dx)
  // cells a lane holds (one where the lanes outnumber the cells); past
  // kPickCells a lane walks its cells in groups of kPickCells
  const int nyx = ny * nx;
  const int cells = lanes >= nyx ? 1 : (nyx + lanes - 1) / lanes;
  using Kernel = decltype(&fusion_pick_kernel<true, 1, false>);
  Kernel kernels[2][6] = {
      {fusion_pick_kernel<false, 1, false>, fusion_pick_kernel<false, 2, false>,
       fusion_pick_kernel<false, 3, false>, fusion_pick_kernel<false, 4, false>,
       fusion_pick_kernel<false, kPickCells, false>,
       fusion_pick_kernel<false, kPickCells, true>},
      {fusion_pick_kernel<true, 1, false>, fusion_pick_kernel<true, 2, false>,
       fusion_pick_kernel<true, 3, false>, fusion_pick_kernel<true, 4, false>,
       fusion_pick_kernel<true, kPickCells, false>,
       fusion_pick_kernel<true, kPickCells, true>}};
  const Kernel kernel = kernels[staged != 0][
      cells <= 4 ? cells - 1 : (cells <= kPickCells ? 4 : 5)];
  // all of an SM's shared memory for the blocks (not L1), and no more
  // blocks than are resident at once: a block works its slabs in turn, so
  // a block not resident would start only once others had finished theirs
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(std::max<size_t>(smem, 48 * 1024)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int per_sm = 0, device = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kPickThreads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Pick k{P, nt, ny, nx, P / G_o, use != nullptr ? P / G_b : 1, B,
               stride, n_xy, n_t, lanes, per_slab, staged != 0, weight,
               Motion{base_c, rel_c, base_t, rel_t}};
  const int slabs = (P + per_slab - 1) / per_slab;
  const int teams = kPickThreads / team;
  const int grid = std::min(std::max(per_sm, 1) * sms,
                            (slabs + teams - 1) / teams);
  kernel<<<grid, kPickThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scores, dxs, dys, dts, pose0, center, d_center, d_theta, use, off_xy,
      off_t, out_dxs, out_dys, out_dts, best, meas_best, k);
  return static_cast<int>(cudaGetLastError());
}

// F4: vol (nt, hc, wc) with strides st, sy (cells contiguous in a row);
// poses (n, 3); theta0 (float), iy0, ix0 (int64) one each on the card;
// n_used (one float on the card; with temper 2, else null); poses_out
// (n, 3) (steps > 0, else null), scores_out (n,); the crop's shape,
// wrap_theta, the climb's steps (0: the sample alone), origin, 1 /
// resolution and 1 / dtheta in float, the moves (resolution, dtheta), the
// temperature (0 none, 1 times temp, 2 times rsqrt(n_used)); stream.
extern "C" int gs_fusion_sample(
    const float* vol, const float* poses, const float* theta0,
    const long long* iy0, const long long* ix0, const float* n_used,
    float* poses_out, float* scores_out, int n, int nt, int hc, int wc,
    long long st, long long sy, int wrap_theta, int steps, float ox,
    float oy, float inv_res, float inv_dt, float step_xy, float step_t,
    int temper, float temp, void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || nt <= 0 || hc <= 0 || wc <= 0 || steps < 0 ||
      (poses_out == nullptr) != (steps == 0) || temper < 0 || temper > 2 ||
      (temper == 2) != (n_used != nullptr))
    return cudaErrorInvalidValue;
  fusion_sample_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      vol, poses, theta0, iy0, ix0, n_used, poses_out, scores_out, n, steps,
      Surface{nt, hc, wc, wrap_theta != 0, st, sy, ox, oy, inv_res, inv_dt,
              step_xy, step_t, temper, temp});
  return static_cast<int>(cudaGetLastError());
}

// F5: px, py, wgt (B,); thetas (nt,); a_yw, a_x (nt, B, 2 kc + 1); kc;
// 1 / resolution in float; stream.
extern "C" int gs_fusion_splat(const float* px, const float* py,
                               const float* wgt, const float* thetas,
                               float* a_yw, float* a_x, int nt, int B, int kc,
                               float inv_res, void* stream) {
  if (nt < 0 || B < 0 || kc < 1) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(nt) * B;
  if (rows == 0) return cudaSuccess;
  const int warps = kThreads / kWarp;
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fusion_splat_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      px, py, wgt, thetas, a_yw, a_x, nt, B, kc, inv_res);
  return static_cast<int>(cudaGetLastError());
}

// F6: angle, dist (G, B) float32; hit, valid (G, B) bool; d_center,
// d_theta (G,), or null for no deskew; out_angle, out_dist (G, B) (with
// the odometry); t_dist, t_alpha, t_code (G, n_bins), or n_bins 0 for no
// tables; bin_step = 2 pi / n_bins in float; px, py, wgt (G, B) float32
// and use (G, B) bool, or all null for no endpoints; px_c, py_c (G, B_c)
// and use_c, B_c = ceil(B / stride), or null (stride 1: px itself);
// n_used (G,) or null; keep (G,) (with the odometry) or null, keep_below
// the gate's bound in float, freeze; stream.
extern "C" int gs_fusion_scan(const float* angle, const float* dist,
                              const bool* hit, const bool* valid,
                              const float* d_center, const float* d_theta,
                              float* out_angle, float* out_dist, float* t_dist,
                              float* t_alpha, float* t_code, float* px,
                              float* py, bool* use, float* wgt, float* px_c,
                              float* py_c, bool* use_c, float* n_used,
                              float* keep, int G, int B, int n_bins,
                              float bin_step, int stride, float keep_below,
                              int freeze, void* stream) {
  if (G == 0) return cudaSuccess;
  const bool points = px != nullptr;
  if (G < 0 || B <= 0 || n_bins < 0 || stride <= 0 ||
      (d_center != nullptr) != (d_theta != nullptr) ||
      (d_center != nullptr && (out_angle == nullptr || out_dist == nullptr)) ||
      (n_bins > 0 && (t_dist == nullptr || t_alpha == nullptr ||
                      t_code == nullptr)) ||
      points != (py != nullptr && use != nullptr && wgt != nullptr) ||
      (px_c != nullptr) != (py_c != nullptr && use_c != nullptr) ||
      (points && n_used == nullptr) || (!points && (px_c != nullptr ||
                                                    n_used != nullptr ||
                                                    keep != nullptr)) ||
      (keep != nullptr && d_theta == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(B) * 5 * sizeof(float);
  const auto kernel =
      points ? fusion_scan_kernel<true> : fusion_scan_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const ScanOut o{px, py, wgt, px_c, py_c, n_used, keep, use, use_c,
                  stride, (B + stride - 1) / stride, freeze != 0,
                  keep_below};
  kernel<<<G, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      angle, dist, hit, valid, d_center, d_theta, out_angle, out_dist, t_dist,
      t_alpha, t_code, B, n_bins, bin_step, o);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The epilogue's arguments both F7 entries take, checked (R = 1 for the
// integration pose, the recovery EMAs and a window), and the window.
cudaError_t epilogue_args(int R, const float* recov, const int* step,
                          const bool* out_gate, const float* out_integ,
                          const float* out_recov, const float* out_pinj,
                          int win_mode, const int* win_ints,
                          const float* win_floats, const float* d_center,
                          const float* d_theta, float* out_center,
                          float* out_thetas, long long* out_cells,
                          Window* win) {
  if ((recov != nullptr || out_integ != nullptr) &&
      (R != 1 || out_gate == nullptr))
    return cudaErrorInvalidValue;
  if (recov != nullptr &&
      (step == nullptr || out_recov == nullptr || out_pinj == nullptr))
    return cudaErrorInvalidValue;
  if (win_mode < 0 || win_mode > 2 ||
      (win_mode != 0 && (R != 1 || out_cells == nullptr)) ||
      (win_mode == 1 && (d_center == nullptr || d_theta == nullptr ||
                         out_center == nullptr || out_thetas == nullptr)) ||
      (win_mode == 2 && out_integ == nullptr))
    return cudaErrorInvalidValue;
  *win = Window{win_mode};
  if (win_mode != 0) {
    const int* i = win_ints;
    const float* f = win_floats;
    *win = Window{win_mode, i[0], i[1], i[2], i[3], i[4], i[5], i[6], i[7],
                  f[0], f[1], f[2], f[3], f[4], d_center, d_theta,
                  out_center, out_thetas, out_cells};
  }
  return cudaSuccess;
}

}  // namespace

// F7: lw (R, P); poses (R, P, 3); recov (2,) and step (one int) or null;
// out_max, out_total, out_neff (R,), out_index (R,) int64, out_best,
// out_weighted (R, 3); out_gate (R,) bool or null (no epilogue), out_integ
// (3,) or null, out_recov (2,) and out_pinj (1,) with recov (R = 1 for the
// last three); scratch_f (6 R nb floats), scratch_i (R nb + 2 R ints), nb =
// ceil(P / 1024); the epilogue's floats; the window (R = 1): win_mode (0
// none; 1 the volume's, without the epilogue, with the odometry d_center,
// d_theta one float each and out_center (3,), out_thetas (1 + nt,); 2 the
// map update's, with the integration pose), win_ints (hc, wc, h, w, r, hce,
// wce, nt) and win_floats (origin x, y, 1 / resolution in float, t_off,
// dtheta) on the host, out_cells (6,) or (2,) int64; stream; &launched
// (kernels: one where nb = 1, else three).
extern "C" int gs_fusion_weights(
    const float* lw, const float* poses, const float* recov, const int* step,
    float* out_max, float* out_total, long long* out_index, float* out_best,
    float* out_neff, float* out_weighted, bool* out_gate, float* out_integ,
    float* out_recov, float* out_pinj, float* scratch_f, int* scratch_i,
    int R, int P, float thr_integ, float thr_gate, float a_slow,
    float a_fast, float thr_inject, float hi_inject, int win_mode,
    const int* win_ints, const float* win_floats, const float* d_center,
    const float* d_theta, float* out_center, float* out_thetas,
    long long* out_cells, void* stream, int* launched) {
  *launched = 0;
  if (R <= 0 || P <= 0 || P > kRow * kRow || R > 65535)
    return cudaErrorInvalidValue;
  Window win;
  cudaError_t e = epilogue_args(
      R, recov, step, out_gate, out_integ, out_recov, out_pinj, win_mode,
      win_ints, win_floats, d_center, d_theta, out_center, out_thetas,
      out_cells, &win);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nb = (P + kRow - 1) / kRow;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WeightsOut o{poses, recov, step, out_max, out_total, out_best,
                     out_neff, out_weighted, out_index, out_integ, out_recov,
                     out_pinj, out_gate, thr_integ, thr_gate, a_slow, a_fast,
                     thr_inject, hi_inject, win};
  if (nb == 1) {
    fusion_weights_row_kernel<<<R, kRowThreads, 0, st>>>(lw, P, o);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    *launched = 1;
    return cudaSuccess;
  }
  const size_t rn = static_cast<size_t>(R) * nb;
  float* pv = scratch_f;
  float* pe = pv + rn;
  float* p4 = pe + rn;
  int* pi = scratch_i;
  unsigned* ticket = reinterpret_cast<unsigned*>(pi + rn);
  const dim3 grid(nb, R);
  fusion_weights_max_kernel<<<grid, kRowThreads, 0, st>>>(lw, pv, pi, ticket,
                                                          P, nb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 1;
  fusion_weights_sum_kernel<<<grid, kRowThreads, 0, st>>>(lw, pv, pi, pe,
                                                          ticket, P, nb, o);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 2;
  fusion_weights_finish_kernel<<<grid, kRowThreads, 0, st>>>(lw, p4, ticket,
                                                             P, nb, o);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 3;
  return cudaSuccess;
}

// F7's mesh form over one rank's P weights lw (P,) and poses (P, 3), a
// pass a call (one launch; pass 1 also zeroes the tickets first), the
// passes sharing scratch_f (6 nb floats: the rows' argmax values, sums and
// four moments, nb = ceil(P / 1024)) and scratch_i (nb + 3 ints: the rows'
// argmax indices and a ticket a pass): 1, pass A: out = the candidate (5,);
// 2, pass B at the max m: out = the total (1,); 3, pass C at m and total:
// out = the four moments (4,); 4, the epilogue at m: with cands (ranks, 5)
// the tail from sums (4,) (out_index, out_best, out_neff and, with
// out_gate, the epilogue's outputs and the window as gs_fusion_weights
// takes them, R = 1; P the rank's count), else the center's window
// (win_mode 1) from sums (3,).  stream; &launched.
extern "C" int gs_fusion_weights_mesh(
    int pass, const float* lw, const float* poses, const float* m,
    const float* total, const float* sums, const float* cands, int ranks,
    float* out, float* scratch_f, int* scratch_i, int P, const float* recov,
    const int* step, long long* out_index, float* out_best, float* out_neff,
    bool* out_gate, float* out_integ, float* out_recov, float* out_pinj,
    float thr_integ, float thr_gate, float a_slow, float a_fast,
    float thr_inject, float hi_inject, int win_mode, const int* win_ints,
    const float* win_floats, const float* d_center, const float* d_theta,
    float* out_center, float* out_thetas, long long* out_cells, void* stream,
    int* launched) {
  *launched = 0;
  if (P <= 0 || P > kRow * kRow || pass < 1 || pass > 4)
    return cudaErrorInvalidValue;
  const int nb = (P + kRow - 1) / kRow;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = scratch_f;
  float* pe = pv + nb;
  float* p4 = pe + nb;
  int* pi = scratch_i;
  unsigned* ticket = reinterpret_cast<unsigned*>(pi + nb);
  cudaError_t e;
  switch (pass) {
    case 1:
      if (poses == nullptr || out == nullptr) return cudaErrorInvalidValue;
      e = cudaMemsetAsync(ticket, 0, 3 * sizeof(unsigned), st);
      if (e != cudaSuccess) return static_cast<int>(e);
      fusion_mesh_max_kernel<<<nb, kRowThreads, 0, st>>>(lw, poses, pv, pi,
                                                         ticket, P, nb, out);
      break;
    case 2:
      if (m == nullptr || out == nullptr) return cudaErrorInvalidValue;
      fusion_mesh_sum_kernel<<<nb, kRowThreads, 0, st>>>(lw, m, pe, ticket,
                                                         P, nb, out);
      break;
    case 3:
      if (poses == nullptr || m == nullptr || total == nullptr ||
          out == nullptr)
        return cudaErrorInvalidValue;
      fusion_mesh_moments_kernel<<<nb, kRowThreads, 0, st>>>(
          lw, poses, m, total, p4, ticket, P, nb, out);
      break;
    default: {
      Window win;
      e = epilogue_args(1, recov, step, out_gate, out_integ, out_recov,
                        out_pinj, win_mode, win_ints, win_floats, d_center,
                        d_theta, out_center, out_thetas, out_cells, &win);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (m == nullptr || sums == nullptr ||
          (cands != nullptr &&
           (ranks <= 0 || out_index == nullptr || out_best == nullptr ||
            out_neff == nullptr)) ||
          (cands == nullptr && (out_gate != nullptr || win_mode != 1)))
        return cudaErrorInvalidValue;
      const WeightsOut o{poses, recov, step, nullptr, nullptr, out_best,
                         out_neff, nullptr, out_index, out_integ, out_recov,
                         out_pinj, out_gate, thr_integ, thr_gate, a_slow,
                         a_fast, thr_inject, hi_inject, win};
      fusion_mesh_finish_kernel<<<1, kWarp, 0, st>>>(m, sums, cands, ranks,
                                                     P, o);
    }
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 1;
  return cudaSuccess;
}

// F8: lw (P,), poses (P, 3); u0, m, total one float each on the card (m,
// total F7's); idx_out (P,) int64, poses_out (P, 3), lw_out (P,) or null;
// scratch (nb 1024 floats, nb = ceil(P / 1024)); 1 / P in float; stream;
// &launched (kernels).
extern "C" int gs_fusion_walk(const float* lw, const float* poses,
                              const float* u0, const float* m,
                              const float* total, long long* idx_out,
                              float* poses_out, float* lw_out, float* scratch,
                              int P, float inv_p, void* stream,
                              int* launched) {
  *launched = 0;
  if (P <= 0 || P > kRow * kRow) return cudaErrorInvalidValue;
  const int nb = (P + kRow - 1) / kRow;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  fusion_walk_scan_kernel<<<nb, kRowThreads, 0, st>>>(lw, m, total, scratch,
                                                      P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 1;
  fusion_walk_search_kernel<<<(P + kSearchThreads - 1) / kSearchThreads,
                              kSearchThreads, 0, st>>>(
      lw, poses, u0, scratch, idx_out, poses_out, lw_out, P, nb, inv_p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 2;
  return cudaSuccess;
}

// F8's mesh form: the gathered rows (P, 4) of (lw, x, y, theta); u0 one
// float on the card; F7's mesh passes A and B over the rows' lw (their
// fixed-order max and total), then F8's scan over all P and its search of
// the slots [base, base + count): idx_out (count,) int64, poses_out
// (count, 3), lw_out (count,) or null; scratch (nb 1024 + 2 nb + 2
// floats, nb = ceil(P / 1024)), scratch_i (nb + 3 ints); 1 / P in float;
// stream; &launched (kernels: four).
extern "C" int gs_fusion_walk_mesh(const float* rows, const float* u0,
                                   long long* idx_out, float* poses_out,
                                   float* lw_out, float* scratch,
                                   int* scratch_i, int P, int base, int count,
                                   float inv_p, void* stream, int* launched) {
  *launched = 0;
  if (P <= 0 || P > kRow * kRow || base < 0 || count <= 0 ||
      base + count > P)
    return cudaErrorInvalidValue;
  const int nb = (P + kRow - 1) / kRow;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = scratch + static_cast<size_t>(nb) * kRow;
  float* pe = pv + nb;
  float* stats = pe + nb;              // the max, the total
  int* pi = scratch_i;
  unsigned* ticket = reinterpret_cast<unsigned*>(pi + nb);
  cudaError_t e = cudaMemsetAsync(ticket, 0, 3 * sizeof(unsigned), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  fusion_walk_mesh_max_kernel<<<nb, kRowThreads, 0, st>>>(rows, pv, pi,
                                                          ticket, P, nb,
                                                          stats);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 1;
  fusion_walk_mesh_sum_kernel<<<nb, kRowThreads, 0, st>>>(rows, pe, ticket, P,
                                                          nb, stats);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 2;
  fusion_walk_mesh_scan_kernel<<<nb, kRowThreads, 0, st>>>(rows, stats,
                                                           scratch, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 3;
  fusion_walk_mesh_search_kernel<<<(count + kSearchThreads - 1) /
                                       kSearchThreads,
                                   kSearchThreads, 0, st>>>(
      rows, u0, scratch, idx_out, poses_out, lw_out, P, nb, base, count,
      inv_p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 4;
  return cudaSuccess;
}

// F7's exp (weight_exp), or with rsqrt F4's rsqrtf, over x (n,) into out
// (n,): the exp and rsqrt probes; stream.
extern "C" int gs_fusion_exp(const float* x, float* out, int n, int rsqrt,
                             void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  fusion_exp_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, out, n, rsqrt);
  return static_cast<int>(cudaGetLastError());
}
