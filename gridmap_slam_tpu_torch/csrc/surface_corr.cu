// Surface correlation in bf16 on the tensor cores (kernel K4).
//
// Replaces the bf16 branch of gridmap_slam_tpu/ops/surface.py::scan_surface
// (:170-179): an XLA conv_general_dilated of bf16 inputs into a float32
// volume, the TPU's MXU-native form.  It is not a Pallas kernel there; no
// PyTorch call computes it either (a bf16 conv2d on CUDA returns a bf16
// volume, which rounds off the float32 scores the branch exists to keep).
// For nt theta bins, K = 2 kc + 1 taps and an (Hc + 2 kc, Wc + 2 kc) padded
// field fpad:
//
//   out[t, y, x] = sum_{dy,dx} bf16(fpad[y+dy, x+dx] + shift)
//                                 * bf16(E[t, dy, dx])  -  shift * mass[t]
//
// with round-to-nearest-even casts, every product exact in float32 (two
// 8-bit significands) and the sums in float32.  mass[t] is the float32 sum
// of E[t], computed by the caller from the unrounded E as the JAX branch
// does.  Same result as ops/cuda/surface_corr.surface_corr_bf16_plain up to
// the order of the sums.
//
// What bounds it on the H100: the endpoint images are a bilinear splat of
// one scan, a few hundred nonzero taps a bin out of K^2 (0.4 % at the mega
// preset: 25 bins, K = 405, a 120 x 120 crop).  The products of those taps
// are 4.5e8 operations, under a microsecond at the bf16 tensor-core peak,
// while reading the dense float32 E once is 16.4 MB: the bound is the
// bytes.  So the design reads E once, keeps only the work of its nonzero
// taps, and runs that on the tensor cores:
//
//   - An implicit GEMM with mma.sync.m16n8k16 (bf16 in, float32 out).  For
//     one output row y and one tap row dy: M = 16 consecutive x, N = 8
//     theta bins (a bin tile), K = 16 consecutive dx (a k step; the tap row
//     padded to a multiple of 16 with zero weights, the bins to a multiple
//     of 8 with zero images).  A "group" is one (tap row, k step) of one bin
//     tile: 128 taps, one B fragment.  At the mega preset 3.4 % of the
//     groups hold a nonzero tap; the others are skipped, their products
//     being exact zeros.
//   - A prologue kernel (surface_corr_prep) reads E once, rounds it to bf16
//     once and, for each bin tile and tap row, lists the live groups in
//     ascending k step (a ballot a k step, a popcount prefix over the
//     flags: no atomic decides an order) and packs their B fragments next
//     to each other, 8 bytes a lane, so that a lane loads a group's
//     fragment in one vector load.  The same launch rounds the shifted
//     field to bf16 pair words once for the whole call: word j of a row
//     holds (bf16 F[j], bf16 F[j + 1]).  Buffers are sized for the worst
//     case (every group live); the group counts stay on the card.
//   - A is Toeplitz: A[m][k] = F[y + dy][x0 + m + k], which neither
//     ldmatrix nor a wgmma shared-memory descriptor can address (rows would
//     start 2 bytes apart), so the kernel keeps mma.sync with the pair
//     words: the pair a thread needs is one aligned 32-bit load wherever it
//     starts.  Thread (g, t) of the warp needs, for M tile j at k step s,
//     P[16 (j + s) + g + 2t + {0, 8, 16}]: a1 and a2 of the fragment are the
//     same word, and tile j + 1 starts where tile j ends, so a window of 17
//     words in registers serves all 8 tiles of a k step, and the next k step
//     of the same tap row shifts it by two words (two loads).
//   - The field's pair words (1.1 MB at mega, 3.4 MB at the city crop) stay
//     in L2, and each warp reads its windows from there through L1 (a
//     block's 8 warps read 8 neighbouring field rows).  What limits the
//     loop is the load/store unit and instruction throughput, not latency:
//     the 17 loads of a window (and the register moves that lay it out as
//     MMA fragments) per 8 MMAs.  Reading L1-resident windows only, or staging
//     each group's rows in shared memory (cp.async or the copy engine, 4
//     groups ahead), or prefetching the next windows into L1, measured no
//     faster on the H100.
//   - The main kernel (surface_corr_kernel): a block is 8 warps, 8
//     consecutive output rows of one 128-column tile and one bin tile, and
//     walks one run of its bin tile's live groups (the tile's list split
//     into `runs` balanced runs by count, on the card: each block scans the
//     tile's per-row counts and lists its run's groups in shared memory).
//     The runs of one output tile form a thread-block cluster: each block
//     leaves its partial sums in its shared memory, and after a cluster
//     barrier each block adds one slice of the tile over the runs in run
//     order through distributed shared memory, subtracts the shift mass and
//     writes the volume.  No partial volume in device memory, no second
//     kernel, no atomics: the same bits on every run.  The plan takes as
//     many runs as keep every cluster resident (an H100 holds 30 clusters
//     of 8 blocks, not the 33 its block slots suggest; a second wave
//     doubles the time).
//   - The MMA's own accumulation truncates (its float32 adder does not
//     round to nearest), which over the 10^4 MMAs of an output would bias
//     the sum by up to a few 1e-3.  So each tap row's MMAs start from zero,
//     and the row's partial is added to the block's running sum with an
//     ordinary float32 add: the truncation then acts on one row's partial,
//     not on the whole score.
//
// The launch (runs, pitch, shared memory) is planned in Python
// (ops/cuda/surface_corr.launch_plan) from the shapes alone; the entry
// point refuses a plan that does not fit them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kDefaultSmem = 48 * 1024;
constexpr int kTileX = 128;        // output columns a warp: 8 M tiles of 16
constexpr int kMTiles = kTileX / 16;
constexpr int kWindow = 2 * kMTiles + 1;
constexpr int kBins = 8;           // theta bins a bin tile: one N tile
constexpr int kRows = 8;           // warps (output rows) a block
constexpr int kThreads = kRows * 32;
constexpr int kMaxRuns = 8;        // blocks a cluster (the portable limit)
constexpr int kMaxKsteps = 256;    // k steps a tap row (K <= 4096)
constexpr int kPrepThreads = 128;
// A block's partial sums: bin n, row w, column x at n * kRedPitch + w *
// kTileX + x; the pitch is 4 modulo 32 so that a warp's stores of one
// fragment element hit 32 banks.
constexpr int kRedPitch = kRows * kTileX + 4;
constexpr int kTileElems = kBins * kRows * kTileX;
// The run's list in the main kernel: two chunks of kList entries of two
// words, in the words of the partial sums (written after the last group).
constexpr int kList = kThreads;
static_assert(4 * kList <= kBins * kRedPitch,
              "the group list must fit in the partial sums");

struct CorrArgs {
  const float* fpad;         // (Hp, Wp)
  const float* e;            // (nt, K, K)
  const float* mass;         // (nt,)
  float* out;                // (nt, Hc, Wc)
  uint2* frags;              // (tiles, K, ksteps, 32): live groups a row
  uint32_t* field;           // (Hp, pitch_w) bf16 pair words
  int* ks;                   // (tiles, K, ksteps): k step of each live group
  int* counts;               // (tiles, K): live groups a tap row
  int Hp, Wp, K, nt, Hc, Wc;
  float shift;
  int runs, ksteps, pitch_w;
};

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Lane (g, t)'s B fragment of k step s of one tap row (`row`: that row of
// bin t0 + g, nullptr past nt): taps 16 s + 2 t, + 1 and 16 s + 2 t + 8,
// + 9, zero past K.
__device__ __forceinline__ uint2 fragment(const float* row, int s, int tq,
                                          int K) {
  if (row == nullptr) return make_uint2(0u, 0u);
  const int k = 16 * s + 2 * tq;
  const float v0 = k < K ? row[k] : 0.0f;
  const float v1 = k + 1 < K ? row[k + 1] : 0.0f;
  const float v8 = k + 8 < K ? row[k + 8] : 0.0f;
  const float v9 = k + 9 < K ? row[k + 9] : 0.0f;
  return make_uint2(bf16_pair(v0, v1), bf16_pair(v8, v9));
}

// Row r of the shifted field as bf16 pair words, zero past Wp.
__device__ void prep_field_row(const CorrArgs& a, int r) {
  const float* src = a.fpad + static_cast<size_t>(r) * a.Wp;
  uint32_t* dst = a.field + static_cast<size_t>(r) * a.pitch_w;
  const int lane = threadIdx.x & 31;
  for (int j0 = threadIdx.x - lane; j0 < a.pitch_w; j0 += blockDim.x) {
    const int j = j0 + lane;
    const uint32_t lo = j < a.Wp ? bf16_bits(src[j] + a.shift) : 0u;
    uint32_t hi = __shfl_down_sync(0xffffffffu, lo, 1);
    if (lane == 31) hi = j + 1 < a.Wp ? bf16_bits(src[j + 1] + a.shift) : 0u;
    if (j < a.pitch_w) dst[j] = lo | (hi << 16);
  }
}

// Blocks [0, tiles * K): bin tile b / K, tap row b % K -- its live groups
// listed and their fragments packed; blocks [tiles * K, + Hp): one field
// row each.  Four warps; k steps in chunks of 32, warp w taking k steps
// w, w + 4, ... of a chunk, held in registers between the flags and the
// stores, so that E is read once.
__global__ void __launch_bounds__(kPrepThreads) surface_corr_prep(CorrArgs a) {
  const int n_tiles = (a.nt + kBins - 1) / kBins;
  const int tap_blocks = n_tiles * a.K;
  if (static_cast<int>(blockIdx.x) >= tap_blocks) {
    prep_field_row(a, blockIdx.x - tap_blocks);
    return;
  }
  __shared__ uint32_t live;        // the chunk's live k steps, a bit each
  const int tile = blockIdx.x / a.K;
  const int dy = blockIdx.x - tile * a.K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int t = tile * kBins + (lane >> 2);
  const float* row = t < a.nt
                         ? a.e + (static_cast<size_t>(t) * a.K + dy) * a.K
                         : nullptr;
  const size_t slot = (static_cast<size_t>(tile) * a.K + dy) * a.ksteps;
  int before = 0;                  // live groups of the earlier chunks
  for (int c0 = 0; c0 < a.ksteps; c0 += 32) {
    if (threadIdx.x == 0) live = 0u;
    __syncthreads();
    uint2 w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = c0 + warp + 4 * j;
      w[j] = s < a.ksteps ? fragment(row, s, tq, a.K) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // a group is live where any of its 128 rounded taps is not +-0
      const bool any = __any_sync(0xffffffffu,
                                  ((w[j].x | w[j].y) & 0x7fff7fffu) != 0u);
      if (any && lane == 0) atomicOr(&live, 1u << (warp + 4 * j));
    }
    __syncthreads();
    const uint32_t m = live;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int bit = warp + 4 * j;
      if ((m >> bit) & 1u) {
        const size_t pos = slot + before + __popc(m & ((1u << bit) - 1u));
        a.frags[pos * 32 + lane] = w[j];
        if (lane == 0) a.ks[pos] = c0 + bit;
      }
    }
    before += __popc(m);
    __syncthreads();
  }
  if (threadIdx.x == 0) a.counts[static_cast<size_t>(tile) * a.K + dy] = before;
}

// offs[dy] = live groups of tap rows before dy (dy = 0 .. K; offs[K] is
// the tile's total), an exclusive scan of `counts` by the block.
__device__ void scan_counts(const int* counts, int K, int* offs) {
  __shared__ int warp_sums[kRows];
  const int per = (K + kThreads - 1) / kThreads;
  const int lo = min(K, static_cast<int>(threadIdx.x) * per);
  const int hi = min(K, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  const int lane = threadIdx.x & 31;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[threadIdx.x >> 5] = incl;
  __syncthreads();
  int run = incl - sum, total = 0;
  for (int w = 0; w < kRows; ++w) {
    if (w < static_cast<int>(threadIdx.x >> 5)) run += warp_sums[w];
    total += warp_sums[w];
  }
  for (int i = lo; i < hi; ++i) {
    offs[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == 0) offs[K] = total;
  __syncthreads();
}

// The run's list of groups, in chunks of kList (two buffers: the chunk
// being worked and the next), each entry the group's slot (dy * ksteps +
// its place in the row) and (dy << 8) | its k step.
struct Run {
  const int* offs;
  int* at;            // (2, kList)
  int* dys;           // (2, kList)
  int g0, n;          // first group, groups
};

// Entries [kList c, kList (c + 1)) of the run into buffer c & 1, one a
// thread: the row by a binary search of the offsets, the k step from the
// prologue's list.
__device__ void fill_list(const CorrArgs& a, const Run& run, const int* ks,
                          int c) {
  const int i = kList * c + static_cast<int>(threadIdx.x);
  if (i >= run.n) return;
  const int gi = run.g0 + i;
  int lo = 0, hi = a.K - 1;
  while (lo < hi) {                // the last dy with offs[dy] <= gi
    const int mid = (lo + hi + 1) >> 1;
    if (run.offs[mid] <= gi) lo = mid; else hi = mid - 1;
  }
  const int at = lo * a.ksteps + (gi - run.offs[lo]);
  run.at[(c & 1) * kList + threadIdx.x] = at;
  run.dys[(c & 1) * kList + threadIdx.x] = (lo << 8) | ks[at];
}

// Grid: (column tiles of 128, row groups x bin tiles, runs), clusters of
// (1, 1, runs); block: 8 warps.  Warp w computes output row y0 + w,
// columns x0 .. x0 + 127, bins t0 .. t0 + 7, over run blockIdx.z of the
// bin tile's live groups.  The run's list is in shared memory, so a
// group's addresses are known without a load; each warp reads its A
// windows (through L1) and B fragments (one group ahead) from L2.
__global__ void __launch_bounds__(kThreads, 2)
    surface_corr_kernel(CorrArgs a) {
  extern __shared__ float smem[];
  // the partial sums once the groups are done; till then the run's list
  // in the same words
  float* red = smem;
  int* offs = reinterpret_cast<int*>(smem + kBins * kRedPitch);  // K + 1
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_tiles = (a.nt + kBins - 1) / kBins;
  const int x0 = blockIdx.x * kTileX;
  const int group = blockIdx.y / n_tiles;
  const int tile = blockIdx.y - group * n_tiles;
  const int t0 = tile * kBins;
  const int y0 = group * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int y = y0 + warp;

  scan_counts(a.counts + static_cast<size_t>(tile) * a.K, a.K, offs);
  const int n = offs[a.K];
  const int g0 = static_cast<int>(static_cast<long long>(n) * rank / a.runs);
  const int g1 =
      static_cast<int>(static_cast<long long>(n) * (rank + 1) / a.runs);
  int* list = reinterpret_cast<int*>(smem);
  const Run run{offs, list, list + 2 * kList, g0, g1 - g0};
  const int* ks = a.ks + static_cast<size_t>(tile) * a.K * a.ksteps;
  const uint2* frags =
      a.frags + static_cast<size_t>(tile) * a.K * a.ksteps * 32 + lane;
  // this warp's field row at tap row 0, from the lane's first window word
  const uint32_t* field = a.field + static_cast<size_t>(min(y, a.Hp - 1)) *
                                        a.pitch_w + x0;

  float total[kMTiles][4], part[kMTiles][4];
#pragma unroll
  for (int j = 0; j < kMTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) total[j][c] = part[j][c] = 0.0f;

  fill_list(a, run, ks, 0);
  __syncthreads();
  int row = -1, s_prev = -2;         // the tap row of `part`, the last k step
  uint32_t q[kWindow];
  uint2 b_next = make_uint2(0u, 0u);
  if (run.n > 0 && y < a.Hc)
    b_next = frags[static_cast<size_t>(run.at[0]) * 32];
  for (int i = 0; i < run.n; ++i) {
    if (i % kList == 0 && i + kList < run.n) {
      __syncthreads();               // every warp is done with chunk c - 1
      fill_list(a, run, ks, i / kList + 1);
      __syncthreads();
    }
    if (y >= a.Hc) continue;
    const int e = (i / kList & 1) * kList + i % kList;
    const int dys = run.dys[e];
    const int dy = dys >> 8;
    const int s = dys & 255;
    const uint2 b = b_next;
    if (i + 1 < run.n) {
      const int e1 = ((i + 1) / kList & 1) * kList + (i + 1) % kList;
      b_next = frags[static_cast<size_t>(run.at[e1]) * 32];
    }
    const uint32_t* win = field + static_cast<size_t>(dy) * a.pitch_w +
                          16 * s + g + 2 * tq;
    if (dy != row) {                 // a new tap row: its partial from zero
#pragma unroll
      for (int j = 0; j < kMTiles; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          total[j][c] = __fadd_rn(total[j][c], part[j][c]);
          part[j][c] = 0.0f;
        }
      row = dy;
#pragma unroll
      for (int k = 0; k < kWindow; ++k) q[k] = __ldg(win + 8 * k);
    } else if (s == s_prev + 1) {    // the next k step: slide two words
#pragma unroll
      for (int k = 0; k + 2 < kWindow; ++k) q[k] = q[k + 2];
      q[kWindow - 2] = __ldg(win + 8 * (kWindow - 2));
      q[kWindow - 1] = __ldg(win + 8 * (kWindow - 1));
    } else {
#pragma unroll
      for (int k = 0; k < kWindow; ++k) q[k] = __ldg(win + 8 * k);
    }
    s_prev = s;
#pragma unroll
    for (int j = 0; j < kMTiles; ++j)
      mma_bf16(part[j], q[2 * j], q[2 * j + 1], q[2 * j + 1], q[2 * j + 2],
               b.x, b.y);
  }
#pragma unroll
  for (int j = 0; j < kMTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      total[j][c] = __fadd_rn(total[j][c], part[j][c]);
  __syncthreads();                   // the list's words become `red`

  // fragment (j, c): column 16 j + g (+ 8 for c >= 2), bin 2 tq (+ 1 for
  // odd c) of the tile
#pragma unroll
  for (int j = 0; j < kMTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(2 * tq + (c & 1)) * kRedPitch + warp * kTileX + 16 * j + g +
          (c >= 2 ? 8 : 0)] = total[j][c];
  cluster.sync();
  // this block's slice of the tile: the runs' sums added in run order
  const float* parts[kMaxRuns];
#pragma unroll
  for (int r = 0; r < kMaxRuns; ++r)
    parts[r] = cluster.map_shared_rank(red, r < a.runs ? r : 0);
  const int e0 = kTileElems * rank / a.runs;
  const int e1 = kTileElems * (rank + 1) / a.runs;
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const int nb = e / (kRows * kTileX);
    const int w = (e / kTileX) % kRows;
    const int xx = e % kTileX;
    const int t = t0 + nb, yy = y0 + w, x = x0 + xx;
    if (t >= a.nt || yy >= a.Hc || x >= a.Wc) continue;
    const int idx = nb * kRedPitch + w * kTileX + xx;
    float v[kMaxRuns];
#pragma unroll
    for (int r = 0; r < kMaxRuns; ++r) v[r] = r < a.runs ? parts[r][idx] : 0.0f;
    float sum = v[0];
#pragma unroll
    for (int r = 1; r < kMaxRuns; ++r)
      if (r < a.runs) sum = __fadd_rn(sum, v[r]);
    a.out[(static_cast<size_t>(t) * a.Hc + yy) * a.Wc + x] =
        __fsub_rn(sum, __fmul_rn(a.shift, a.mass[t]));
  }
  cluster.sync();                    // keep the shared memory until read
}

int max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return kDefaultSmem;
  }
  return bytes;
}

// The scratch layout, in 32-bit words: fragments (tiles, K, ksteps, 32, 2),
// field (Hp, pitch_w), k steps (tiles, K, ksteps), counts (tiles, K).
// Returns the words needed, or -1 where the shapes or the plan's k steps
// and pitch do not fit.
long long layout(CorrArgs& a, uint32_t* scratch) {
  if (a.K <= 0 || a.nt <= 0 || a.Hp < a.K || a.Wp < a.K ||
      a.ksteps != (a.K + 15) / 16 || a.ksteps > kMaxKsteps) {
    return -1;
  }
  a.Hc = a.Hp - a.K + 1;
  a.Wc = a.Wp - a.K + 1;
  const long long col_tiles = (a.Wc + kTileX - 1) / kTileX;
  if (a.pitch_w % 4 != 0 || a.pitch_w < kTileX * col_tiles + 16 * a.ksteps) {
    return -1;
  }
  const long long tiles = (a.nt + kBins - 1) / kBins;
  const long long groups = tiles * a.K * a.ksteps;
  const long long frag_words = groups * 64;
  const long long field_words = static_cast<long long>(a.Hp) * a.pitch_w;
  a.frags = reinterpret_cast<uint2*>(scratch);
  a.field = scratch + frag_words;
  a.ks = reinterpret_cast<int*>(a.field + field_words);
  a.counts = a.ks + groups;
  return frag_words + field_words + groups + tiles * a.K;
}

cudaError_t launch_prep(const CorrArgs& a, cudaStream_t st) {
  const long long blocks =
      static_cast<long long>((a.nt + kBins - 1) / kBins) * a.K + a.Hp;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  surface_corr_prep<<<static_cast<unsigned>(blocks), kPrepThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// out[r - 1] = the clusters of r main-kernel blocks (r = 1 .. 8) with
// `smem_bytes` of dynamic shared memory each that the card holds at once
// (launch_plan takes as many runs as keep the grid's clusters resident:
// an H100 holds 30 clusters of 8 at K4's 34 KB, fewer than 8 x its 264
// block slots would suggest).
extern "C" int gs_surface_corr_clusters(int smem_bytes, int* out) {
  if (out == nullptr || smem_bytes < 0 || smem_bytes > max_smem_optin()) {
    return cudaErrorInvalidValue;
  }
  if (smem_bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        surface_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return err;
  }
  for (int r = 1; r <= kMaxRuns; ++r) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, static_cast<unsigned>(r));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = static_cast<unsigned>(r);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&out[r - 1], surface_corr_kernel, &cfg);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The prologue alone: fpad (Hp, Wp) and e (nt, K, K) into `scratch`
// (scratch_words 32-bit words, the layout above).  *launched = the kernels
// launched (0 or 1).
extern "C" int gs_surface_corr_prep(const float* fpad, const float* e,
                                    void* scratch, int Hp, int Wp, int K,
                                    int nt, float shift, int ksteps,
                                    int pitch_w, long long scratch_words,
                                    void* stream, int* launched) {
  if (launched == nullptr) return cudaErrorInvalidValue;
  *launched = 0;
  CorrArgs a{fpad, e, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             Hp, Wp, K, nt, 0, 0, shift, 1, ksteps, pitch_w};
  if (scratch == nullptr ||
      layout(a, static_cast<uint32_t*>(scratch)) != scratch_words) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = launch_prep(a, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) *launched = 1;
  return err;
}

// fpad (Hp, Wp), e (nt, K, K), mass (nt,) -> out (nt, Hc, Wc), Hc = Hp - K
// + 1, Wc = Wp - K + 1, through the prologue and the main kernel.  The
// plan: runs (blocks a cluster, 1 to 8), ksteps = ceil(K / 16), the
// prepared field's pitch in words, the main kernel's shared memory and the
// scratch's size in words.  *launched = the kernels launched (0 to 2).
extern "C" int gs_surface_corr(const float* fpad, const float* e,
                               const float* mass, float* out, void* scratch,
                               int Hp, int Wp, int K, int nt, float shift,
                               int runs, int ksteps, int pitch_w,
                               int smem_bytes, long long scratch_words,
                               void* stream, int* launched) {
  if (launched == nullptr) return cudaErrorInvalidValue;
  *launched = 0;
  CorrArgs a{fpad, e, mass, out, nullptr, nullptr, nullptr, nullptr,
             Hp, Wp, K, nt, 0, 0, shift, runs, ksteps, pitch_w};
  if (scratch == nullptr || out == nullptr || mass == nullptr ||
      layout(a, static_cast<uint32_t*>(scratch)) != scratch_words) {
    return cudaErrorInvalidValue;
  }
  const long long n_tiles = (nt + kBins - 1) / kBins;
  const long long groups = (a.Hc + kRows - 1) / kRows;
  const long long col_tiles = (a.Wc + kTileX - 1) / kTileX;
  const size_t need =
      (static_cast<size_t>(kBins) * kRedPitch + K + 1) * sizeof(float);
  if (runs < 1 || runs > kMaxRuns || smem_bytes < 0 ||
      need > static_cast<size_t>(smem_bytes) ||
      smem_bytes > max_smem_optin() || groups * n_tiles > 65535 ||
      col_tiles > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  if (smem_bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        surface_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_prep(a, st);
  if (err != cudaSuccess) return err;
  *launched = 1;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(col_tiles),
                     static_cast<unsigned>(groups * n_tiles),
                     static_cast<unsigned>(runs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(runs);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, surface_corr_kernel, a);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return err;
}
