// Log-likelihood field build (kernel K3).
//
// Replaces gridmap_slam_tpu/ops/pallas/likelihood.py::
// log_likelihood_field_pallas (kernel _ll_kernel).  Per particle map:
// threshold the log-odds to p in {0, 1/2, 1} plus an evidence mask (p != 1/2),
// blur both with the separable Gaussian (zero boundary), mark cells with no
// blurred evidence as unknown, and write log(z_hit * v + (1 - z_hit) /
// max_range) with v replaced by v_eq on unknown cells.  Same result as
// ops/grid.likelihood_field followed by ops/matcher.log_likelihood_field.
//
// Bound on the H100: instruction throughput at small radii (the map is read and
// the field written once, 8 bytes a cell, which the card moves faster than
// it runs the blur's 2 (2r + 1) FMAs with their loads), the FMAs themselves
// at large ones.  So the design spends as few instructions an output as it
// can, and sizes its block to the map instead of a fixed square:
//
//   - One blurred plane, not two.  The evidence plane is only ever tested
//     as e <= 0, and with positive taps e > 0 exactly when some cell of the
//     (2r + 1)^2 window, clipped to the map, has evidence: a sum of
//     non-negative floats is 0 only if every term is, and a term
//     tap * (tap * 1) is positive as long as the smallest tap squared does
//     not underflow.  The kernels keep the evidence as one bit a cell (a warp
//     ballot while staging), widen it along the row and OR it down the
//     column on whole 32-cell words.  They test the taps themselves
//     (smallest tap > 0 and its square > 0); if that fails, each output
//     cell sums its evidence window directly, in the plain version's order
//     (slow, exact, and off every path the package's own taps take).
//   - Zero boundary by clipping.  A tap outside the map adds +0 to a
//     non-negative sum, which changes no bit, so it is skipped: at radius 180
//     on a 120 x 120 map a row has 120 taps inside the map, not 361.
//   - Two kernels, chosen with the block's tile by the pure-Python planner
//     ops/cuda/likelihood.launch_plan; the entry point refuses a plan that
//     does not fit.
//
// ll_field_small<R>, R = 1..4 (every path of the package runs radius 3): a
// block works a band of tile_h rows by tile_w columns, one thread a column.
// It stages 2p as floats with a 4-cell apron (zero outside the map) in
// shared memory, by 128-bit loads and stores where rows of W % 4 == 0 floats
// start on a 16-byte boundary (a warp starts the loads of four rows before
// it uses the first: staged row by row, the block waited out one trip to
// device memory a row, a tenth to a fifth of its time) and one cell a lane
// otherwise, then each thread walks down its column: the row's horizontal sum from 2R + 1
// shared-memory floats and the half taps in registers (half-tap * 2p is the
// float product tap * p: scaling by 1/2 is exact), and the vertical pass as
// 2R + 1 partial sums in registers, each row's value loaded once and fed to
// the 2R + 1 outputs it belongs to.  There is no horizontal-pass plane.  It
// is pinned to 64 registers a thread, eight blocks of 128 threads an SM.
//
// ll_field_generic, any radius: a band of tile_h rows by tile_w columns
// (the whole map a block where it fits).  Staged: 2p as 2-bit codes, 16 to
// a word (so that radius 236 still fits one block on a large map), only
// the rows and columns inside the map.  Horizontal pass: a thread produces
// 8 neighbouring outputs of a row, decoding each code once and sliding the
// taps through registers, into a shared-memory plane; vertical pass: a
// thread produces 8 outputs of a column the same way, then the epilogue.
// Its staging loads are started four at a time, so that a block does not
// wait for them one by one.
//
// Both sum the taps in tap order (ascending column, then ascending row), as
// ops/grid.blur_separable does, in one thread an output and with no
// atomics: results repeat bit for bit.  The epilogue's log is __logf (a
// hardware log2 times ln 2: within 3 ulp here, about 1e-6 of the value,
// against atol 1e-5; the same bits every run).  Any H x W.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmallRadius = 4;
constexpr int kMaxRadius = 236;
constexpr int kSmallThreads = 256;      // most columns a small-kernel block
// Blocks of kSmallThreads an SM must hold: 64 registers a thread.  Left to
// itself ptxas picks 32 to 48 and spills a few bytes; with more registers
// (80, 105) the kernel measured 10 to 30 % slower, for the warps it loses.
constexpr int kSmallMinBlocks = 4;
constexpr int kGenericThreads = 512;    // most threads a generic block
constexpr int kBx = 8;                  // outputs a thread, horizontal pass
constexpr int kBy = 8;                  // outputs a thread, vertical pass
constexpr int kPad = 7;                 // zero taps either side: kBx, kBy - 1
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 4;               // staging loads in flight a lane

struct Args {
  const float* lo;
  float* out;
  const float* taps;
  int radius, P, H, W;
  float z_hit, c_rand, v_eq;
  int tile_h, tile_w;
};

__device__ __forceinline__ float code_of(float l) {      // 2p
  return l > 0.f ? 2.f : (l < 0.f ? 0.f : 1.f);
}

__device__ __forceinline__ bool evidence_of(float l) {   // p != 1/2
  return l > 0.f || l < 0.f;
}

// The blurred evidence of cell (y, x), summed as the plain version sums it,
// from the staged evidence bits: `raw` holds `words` words a row, its row 0
// is map row ys and its bit 0 map column xs; rows [ys, ye) and columns
// [xs, xe) are staged (cells outside the map as 0).
__device__ __forceinline__ bool exact_evidence(
    const unsigned* raw, int words, int ys, int ye, int xs, int xe,
    const float* __restrict__ taps, int r, int y, int x) {
  float e = 0.f;
  for (int yy = max(y - r, ys); yy <= min(y + r, ye - 1); ++yy) {
    const unsigned* row = raw + (yy - ys) * words;
    float he = 0.f;
    for (int xx = max(x - r, xs); xx <= min(x + r, xe - 1); ++xx) {
      const int i = xx - xs;
      he = fmaf(__ldg(taps + (xx - x + r)),
                static_cast<float>((row[i >> 5] >> (i & 31)) & 1u), he);
    }
    e = fmaf(__ldg(taps + (yy - y + r)), he, e);
  }
  return e > 0.f;
}

// ------------------------------------------------------------ small radii

constexpr int kApron = 4;      // staged columns either side of the tile

// Shared memory of a small-kernel block: the staged floats with their
// apron, the evidence words (one spare either side) and the row-widened
// evidence words.
size_t small_smem(int R, int tile_h, int tile_w) {
  const size_t rows = tile_h + 2 * R;
  return rows * (tile_w + 2 * kApron + tile_w / 32 + 2 + tile_w / 32) * 4;
}

__device__ __forceinline__ unsigned evidence4(float4 q) {
  return (evidence_of(q.x) ? 1u : 0u) | (evidence_of(q.y) ? 2u : 0u) |
         (evidence_of(q.z) ? 4u : 0u) | (evidence_of(q.w) ? 8u : 0u);
}

__device__ __forceinline__ float4 code4(float4 q) {
  return make_float4(code_of(q.x), code_of(q.y), code_of(q.z), code_of(q.w));
}

template <int R, bool kVec>
__global__ void __launch_bounds__(kSmallThreads, kSmallMinBlocks)
ll_field_small(Args a) {
  extern __shared__ __align__(16) float smem[];
  static_assert(R <= kApron, "the apron holds the radius");
  constexpr int kTaps = 2 * R + 1;
  const int H = a.H, W = a.W, TH = a.tile_h, TC = a.tile_w;
  const int rows = TH + 2 * R, pitch = TC + 2 * kApron;
  const int dw = TC / 32, rw = dw + 2;
  // column c of s_val is map column x0 - kApron + c; bit i of a row of
  // s_raw is map column x0 - 32 + i (its first word holds the left apron
  // in its top bits, its last the right apron in its low bits)
  float* s_val = smem;                                        // (rows, pitch)
  unsigned* s_raw = reinterpret_cast<unsigned*>(s_val + rows * pitch);
  unsigned* s_dil = s_raw + rows * rw;                        // (rows, dw)

  const int p = blockIdx.x, y0 = blockIdx.y * TH, x0 = blockIdx.z * TC;
  const float* map = a.lo + static_cast<size_t>(p) * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  if constexpr (kVec) {
    // 128-bit loads: a lane takes four cells, a warp a row of the tile; the
    // lanes' evidence nibbles are ORed to words over groups of 8 lanes
    // (a warp's loads of kBatch rows are started before the first is used)
    const int quads = TC / 4;
    for (int q0 = 0; q0 < quads; q0 += 32) {
      const int q = q0 + lane, x = x0 + 4 * q;
      const bool col_in = q < quads && x < W;
      for (int j0 = warp; j0 < rows; j0 += kBatch * n_warps) {
        float4 l[kBatch];
        bool in[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int j = j0 + b * n_warps, y = y0 - R + j;
          in[b] = col_in && j < rows && y >= 0 && y < H;
          l[b] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in[b]) {
            l[b] = *reinterpret_cast<const float4*>(
                map + static_cast<size_t>(y) * W + x);
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int j = j0 + b * n_warps;
          if (j >= rows) break;
          if (q < quads) {
            *reinterpret_cast<float4*>(s_val + j * pitch + kApron + 4 * q) =
                in[b] ? code4(l[b]) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          unsigned ev = evidence4(l[b]) << (4 * (lane & 7));
          ev |= __shfl_xor_sync(kFull, ev, 1);
          ev |= __shfl_xor_sync(kFull, ev, 2);
          ev |= __shfl_xor_sync(kFull, ev, 4);
          if ((lane & 7) == 0 && q < quads) s_raw[j * rw + 1 + (q >> 3)] = ev;
        }
      }
    }
    for (int item = threadIdx.x; item < 2 * rows; item += blockDim.x) {
      const int j = item >> 1, right = item & 1;
      const int y = y0 - R + j, x = right ? x0 + TC : x0 - kApron;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      unsigned ev = 0u;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const float4 l = *reinterpret_cast<const float4*>(
            map + static_cast<size_t>(y) * W + x);
        v = code4(l);
        ev = evidence4(l);
      }
      *reinterpret_cast<float4*>(s_val + j * pitch +
                                 (right ? kApron + TC : 0)) = v;
      s_raw[j * rw + (right ? rw - 1 : 0)] = right ? ev : ev << 28;
    }
  } else {
    // any width or address: a warp takes 32 neighbouring cells of a row,
    // so its ballot is the row's evidence word
    for (int j = warp; j < rows; j += n_warps) {
      const int y = y0 - R + j;
      const bool row_in = y >= 0 && y < H;
      for (int w = 0; w < rw; ++w) {
        const int i = w * 32 + lane, x = x0 - 32 + i, c = i - (32 - kApron);
        const bool staged = c >= 0 && c < pitch;
        const bool in = staged && row_in && x >= 0 && x < W;
        const float l = in ? map[static_cast<size_t>(y) * W + x] : 0.f;
        if (staged) s_val[j * pitch + c] = in ? code_of(l) : 0.f;
        const unsigned word = __ballot_sync(kFull, evidence_of(l));
        if (lane == 0) s_raw[j * rw + w] = word;
      }
    }
  }
  __syncthreads();

  // widen the evidence along the row: bit b of word w of s_dil is column
  // x0 + 32 w + b, the OR of the evidence of the columns within R of it
  for (int item = threadIdx.x; item < rows * dw; item += blockDim.x) {
    const int j = item / dw, w = item - j * dw;
    const unsigned* row = s_raw + j * rw + w;
    const unsigned left = row[0], mid = row[1], right = row[2];
    unsigned acc = mid;
#pragma unroll
    for (int d = 1; d <= R; ++d) {
      acc |= __funnelshift_r(left, mid, 32 - d);    // the columns d to the left
      acc |= __funnelshift_r(mid, right, d);        // and d to the right
    }
    s_dil[item] = acc;
  }
  __syncthreads();

  const int t = threadIdx.x, x = x0 + t;
  if (x >= W) return;
  float tp[kTaps], hf[kTaps];
  float t_min = a.taps[0];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    tp[k] = __ldg(a.taps + k);
    hf[k] = 0.5f * tp[k];
    t_min = fminf(t_min, tp[k]);
  }
  const bool or_exact = t_min > 0.f && t_min * t_min > 0.f;
  const int n_out = min(TH, H - y0);
  const unsigned* dil = s_dil + (t >> 5);
  const int sh = t & 31;
  float* dst = a.out + (static_cast<size_t>(p) * H + y0) * W + x;
  unsigned known_sum = 0u;      // bit o: output row o, by the exact sum
  if (!or_exact) {
    for (int o = 0; o < n_out; ++o) {
      if (exact_evidence(s_raw, rw, y0 - R, y0 - R + rows, x0 - 32,
                         x0 + TC + 32, a.taps, R, y0 + o, x)) {
        known_sum |= 1u << o;
      }
    }
  }
  float acc[kTaps];       // acc[k]: the sum of the output row k rows up
#pragma unroll
  for (int k = 0; k < kTaps; ++k) acc[k] = 0.f;
  unsigned hist = 0u;     // bit i: widened evidence of the row i rows up
#pragma unroll kTaps
  for (int j = 0; j < n_out + 2 * R; ++j) {
    const float* row = s_val + j * pitch + t + (kApron - R);
    float h = 0.f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) h = fmaf(hf[k], row[k], h);
    hist = (hist << 1) | ((dil[j * dw] >> sh) & 1u);
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc[k] = fmaf(tp[k], h, acc[k]);
    if (j >= 2 * R) {
      const int o = j - 2 * R;
      const bool known = or_exact ? (hist & ((1u << kTaps) - 1u)) != 0u
                                  : ((known_sum >> o) & 1u) != 0u;
      const float v = known ? acc[kTaps - 1] : a.v_eq;
      dst[static_cast<size_t>(o) * W] = __logf(a.z_hit * v + a.c_rand);
    }
#pragma unroll
    for (int k = kTaps - 1; k > 0; --k) acc[k] = acc[k - 1];
    acc[0] = 0.f;
  }
}

// ------------------------------------------------------------ any radius

struct GenericLayout {
  int rows, cols;      // most staged rows and columns of a block
  int rw;              // evidence and prefix words a row (one spare, zero)
  int cw;              // code words a row (16 cells a word)
  int dw;              // widened-evidence words a row
  int taps;            // floats of each padded tap array
  size_t bytes;
};

GenericLayout generic_layout(int radius, int H, int W, int tile_h,
                             int tile_w) {
  GenericLayout g;
  g.rows = min(H, tile_h + 2 * radius);
  g.cols = min(W, tile_w + 2 * radius);
  g.rw = (g.cols + 31) / 32 + 1;
  g.cw = 2 * (g.rw - 1);
  g.dw = tile_w / 32;
  g.taps = (2 * radius + 1 + 2 * kPad + 3) / 4 * 4;
  g.bytes = 4 * (2 * static_cast<size_t>(g.taps) + 4 +
                 static_cast<size_t>(g.rows) *
                     (tile_w + 2 * g.rw + g.cw + g.dw));
  return g;
}

__global__ void __launch_bounds__(kGenericThreads)
ll_field_generic(Args a, GenericLayout g) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, W = a.W, TH = a.tile_h, TC = a.tile_w, r = a.radius;
  const int n_taps = 2 * r + 1;
  float* s_tap = smem;                              // zeros, taps, zeros
  float* s_half = s_tap + g.taps;                   // the same, halved
  int* s_flag = reinterpret_cast<int*>(s_half + g.taps);      // (4,)
  float* s_h = reinterpret_cast<float*>(s_flag + 4);          // (rows, TC)
  unsigned* s_raw = reinterpret_cast<unsigned*>(s_h + g.rows * TC);
  unsigned* s_pre = s_raw + g.rows * g.rw;          // evidence before a word
  unsigned* s_code = s_pre + g.rows * g.rw;         // (rows, cw)
  unsigned* s_dil = s_code + g.rows * g.cw;         // (rows, dw)

  const int p = blockIdx.x, y0 = blockIdx.y * TH, x0 = blockIdx.z * TC;
  const int ys = max(0, y0 - r), ye = min(H, y0 + TH + r);
  const int xs = max(0, x0 - r), xe = min(W, x0 + TC + r);
  const int sr = ye - ys, sc = xe - xs, words = (sc + 31) / 32;
  const float* map = a.lo + static_cast<size_t>(p) * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  // stage the cells inside the map: evidence bits by ballot, 2p as 2-bit
  // codes, 16 cells a word (an OR over each half of the warp)
  // (kBatch loads are started before the first is used)
  for (int j = warp; j < sr; j += n_warps) {
    const float* src = map + static_cast<size_t>(ys + j) * W + xs;
    for (int w0 = 0; w0 < words; w0 += kBatch) {
      float l[kBatch];
      bool in[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = (w0 + b) * 32 + lane;
        in[b] = i < sc;
        l[b] = in[b] ? src[i] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int wi = w0 + b;
        if (wi >= words) break;
        const unsigned ev = __ballot_sync(kFull, evidence_of(l[b]));
        const unsigned code =
            in[b] ? (l[b] > 0.f ? 2u : (l[b] < 0.f ? 0u : 1u)) : 0u;
        const unsigned at = code << ((lane & 15) * 2);
        const unsigned lo16 = __reduce_or_sync(kFull, lane < 16 ? at : 0u);
        const unsigned hi16 = __reduce_or_sync(kFull, lane < 16 ? 0u : at);
        if (lane == 0) {
          s_raw[j * g.rw + wi] = ev;
          s_code[j * g.cw + 2 * wi] = lo16;
          s_code[j * g.cw + 2 * wi + 1] = hi16;
        }
      }
    }
  }
  for (int j = threadIdx.x; j < sr; j += blockDim.x) {
    for (int w = words; w < g.rw; ++w) s_raw[j * g.rw + w] = 0u;
  }
  for (int k = threadIdx.x; k < g.taps; k += blockDim.x) {
    const float t =
        k >= kPad && k < kPad + n_taps ? __ldg(a.taps + k - kPad) : 0.f;
    s_tap[k] = t;
    s_half[k] = 0.5f * t;
  }
  if (warp == 0) {
    float t_min = __ldg(a.taps);
    for (int k = lane; k < n_taps; k += 32) {
      t_min = fminf(t_min, __ldg(a.taps + k));
    }
    for (int d = 16; d > 0; d >>= 1) {
      t_min = fminf(t_min, __shfl_xor_sync(kFull, t_min, d));
    }
    if (lane == 0) s_flag[0] = t_min > 0.f && t_min * t_min > 0.f;
  }
  __syncthreads();

  // evidence cells before each word of a row
  for (int j = threadIdx.x; j < sr; j += blockDim.x) {
    unsigned run = 0u;
    for (int w = 0; w <= words; ++w) {
      s_pre[j * g.rw + w] = run;
      run += __popc(s_raw[j * g.rw + w]);
    }
  }
  __syncthreads();
  const bool or_exact = s_flag[0] != 0;

  // widen the evidence along the row: a cell's bit is set if any staged
  // cell within r columns has evidence (a difference of two prefix counts)
  for (int item = warp; item < sr * g.dw; item += n_warps) {
    const int j = item / g.dw, w = item - j * g.dw, x = x0 + w * 32 + lane;
    const int i0 = max(x - r, xs) - xs, i1 = min(x + r, xe - 1) - xs + 1;
    const unsigned* raw = s_raw + j * g.rw;
    const unsigned* pre = s_pre + j * g.rw;
    bool any = false;
    if (i1 > i0) {
      const unsigned n0 =
          pre[i0 >> 5] + __popc(raw[i0 >> 5] & ((1u << (i0 & 31)) - 1u));
      const unsigned n1 =
          pre[i1 >> 5] + __popc(raw[i1 >> 5] & ((1u << (i1 & 31)) - 1u));
      any = n1 != n0;
    }
    const unsigned word = __ballot_sync(kFull, any);
    if (lane == 0) s_dil[item] = word;
  }

  // horizontal pass: kBx outputs a thread; input column c meets output i
  // at tap c - (X0 + i) + r, zero outside the taps.  Each lane walks only
  // the staged columns its outputs reach (a walk over the warp's common tap
  // positions, which would make the tap one word for all lanes, measured
  // slower: at radius 180 it is twice the steps).
  const int per_row = TC / kBx;
  for (int item = threadIdx.x; item < sr * per_row; item += blockDim.x) {
    const int j = item / per_row, X0 = x0 + (item - j * per_row) * kBx;
    if (X0 >= W) continue;
    const int c_lo = max(xs, X0 - r), c_hi = min(xe - 1, X0 + kBx - 1 + r);
    const unsigned* codes = s_code + j * g.cw;
    const int tb = kPad + r - X0;         // s_half[tb + c - i] meets output i
    float t[kBx], acc[kBx];
#pragma unroll
    for (int i = 0; i < kBx; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 1; i < kBx; ++i) t[i] = s_half[tb + c_lo - i];
#pragma unroll kBx
    for (int c = c_lo; c <= c_hi; ++c) {
      const int i_c = c - xs;
      const float v = static_cast<float>(
          (codes[i_c >> 4] >> ((i_c & 15) * 2)) & 3u);
      t[0] = s_half[tb + c];
#pragma unroll
      for (int i = 0; i < kBx; ++i) acc[i] = fmaf(t[i], v, acc[i]);
#pragma unroll
      for (int i = kBx - 1; i > 0; --i) t[i] = t[i - 1];
    }
    float4* dst = reinterpret_cast<float4*>(s_h + j * TC + (X0 - x0));
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();

  // vertical pass and epilogue: kBy outputs of a column a thread; a warp's
  // lanes share the output rows and the evidence word
  const int n_out = min(TH, H - y0);
  const int groups = (n_out + kBy - 1) / kBy;
  for (int item = threadIdx.x; item < groups * TC; item += blockDim.x) {
    const int og = item / TC, xl = item - og * TC, x = x0 + xl;
    const int Y0 = y0 + og * kBy;
    const bool active = x < W;
    float acc[kBy];
#pragma unroll
    for (int i = 0; i < kBy; ++i) acc[i] = 0.f;
    if (active) {
      const int j_lo = max(ys, Y0 - r), j_hi = min(ye - 1, Y0 + kBy - 1 + r);
      const int tb = kPad + r - Y0;       // s_tap[tb + row - i]: output i
      float t[kBy];
#pragma unroll
      for (int i = 1; i < kBy; ++i) t[i] = s_tap[tb + j_lo - i];
#pragma unroll kBy
      for (int jr = j_lo; jr <= j_hi; ++jr) {
        const float v = s_h[(jr - ys) * TC + xl];
        t[0] = s_tap[tb + jr];
#pragma unroll
        for (int i = 0; i < kBy; ++i) acc[i] = fmaf(t[i], v, acc[i]);
#pragma unroll
        for (int i = kBy - 1; i > 0; --i) t[i] = t[i - 1];
      }
    }
#pragma unroll
    for (int i = 0; i < kBy; ++i) {
      const int y = Y0 + i;
      unsigned m = 0u;      // the lanes share the rows of the window
      for (int jr = max(ys, y - r) + lane; jr <= min(ye - 1, y + r);
           jr += 32) {
        m |= s_dil[(jr - ys) * g.dw + (xl >> 5)];
      }
      m = __reduce_or_sync(kFull, m);
      if (active && y < y0 + n_out) {
        const bool known =
            or_exact ? ((m >> (xl & 31)) & 1u) != 0u
                     : exact_evidence(s_raw, g.rw, ys, ye, xs, xe, a.taps, r,
                                      y, x);
        const float v = known ? acc[i] : a.v_eq;
        a.out[(static_cast<size_t>(p) * H + y) * W + x] =
            __logf(a.z_hit * v + a.c_rand);
      }
    }
  }
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

template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int R, bool kVec>
int launch_small(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  const int err = opt_in(ll_field_small<R, kVec>, smem);
  if (err != cudaSuccess) return err;
  ll_field_small<R, kVec><<<grid, a.tile_w, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// 128-bit staging where rows of W % 4 == 0 floats start on a 16-byte
// boundary, else one cell a lane.
template <int R>
int launch_small(const Args& a, dim3 grid, size_t smem, cudaStream_t stream) {
  const bool vec = a.W % 4 == 0 && reinterpret_cast<size_t>(a.lo) % 16 == 0;
  return vec ? launch_small<R, true>(a, grid, smem, stream)
             : launch_small<R, false>(a, grid, smem, stream);
}

}  // namespace

// lo, out: (P, H, W) float32; taps: (2 * radius + 1,) float32 on the card.
// c_rand = (1 - z_hit) / max_range; v_eq = the effective field value of an
// unknown cell (ops/matcher.effective_field).  The rest is the plan of
// ops/cuda/likelihood.launch_plan: `small` picks ll_field_small<radius>
// (radius 1..4, one thread a column: threads == tile_w <= 256), else
// ll_field_generic; a block works tile_h rows by tile_w columns (a multiple
// of 32) and is given smem_bytes of shared memory.  A plan that does not
// fit the shapes, the kernel or the card is refused.
extern "C" int gs_ll_field(const float* lo, float* out, const float* taps,
                           int radius, int P, int H, int W, float z_hit,
                           float c_rand, float v_eq, int small, int tile_h,
                           int tile_w, int threads, int smem_bytes,
                           void* stream) {
  if (radius < 0 || radius > kMaxRadius || P < 0 || H < 0 || W < 0) {
    return cudaErrorInvalidValue;
  }
  if (P == 0 || H == 0 || W == 0) return cudaSuccess;
  if (tile_h <= 0 || tile_w <= 0 || tile_w % 32 || threads % 32 ||
      smem_bytes < 0 || smem_bytes > max_smem_optin()) {
    return cudaErrorInvalidValue;
  }
  const long long bands = (H + tile_h - 1) / tile_h;
  const long long tiles = (W + tile_w - 1) / tile_w;
  if (bands > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(P, static_cast<unsigned>(bands),
                  static_cast<unsigned>(tiles));
  const Args a{lo, out, taps, radius, P, H, W, z_hit, c_rand, v_eq, tile_h,
               tile_w};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (small) {
    if (radius < 1 || radius > kMaxSmallRadius || threads != tile_w ||
        tile_w > kSmallThreads || tile_h > 32 ||
        small_smem(radius, tile_h, tile_w) > static_cast<size_t>(smem_bytes)) {
      return cudaErrorInvalidValue;
    }
    switch (radius) {
      case 1: return launch_small<1>(a, grid, smem_bytes, st);
      case 2: return launch_small<2>(a, grid, smem_bytes, st);
      case 3: return launch_small<3>(a, grid, smem_bytes, st);
      default: return launch_small<4>(a, grid, smem_bytes, st);
    }
  }
  const GenericLayout g = generic_layout(radius, H, W, tile_h, tile_w);
  if (threads <= 0 || threads > kGenericThreads ||
      g.bytes > static_cast<size_t>(smem_bytes)) {
    return cudaErrorInvalidValue;
  }
  const int err = opt_in(ll_field_generic, smem_bytes);
  if (err != cudaSuccess) return err;
  ll_field_generic<<<grid, threads, smem_bytes, st>>>(a, g);
  return static_cast<int>(cudaGetLastError());
}
