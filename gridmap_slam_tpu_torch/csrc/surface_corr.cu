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
// Bound on the H100: the multiply-adds, nt K^2 Hc Wc of them (5.9e10 at
// the mega preset: 25 bins, K = 405, a 120 x 120 crop), against the bf16
// tensor-core peak; the 19 MB of float32 in and out take a twentieth of
// that time.  So the design keeps the tensor cores fed and reads each
// operand from shared memory as few times as it can:
//
//   - An implicit GEMM with mma.sync.m16n8k16 (bf16 in, float32 out).  For
//     one output row y and one tap row dy: M = 16 consecutive x, N = 8
//     theta bins, K = 16 consecutive dx (the tap row padded to a multiple
//     of 16 with zero weights, the bins to a multiple of 8 with zero
//     images).  A warp owns one output row, 128 columns (8 M tiles) and 8
//     bins (one N tile).
//   - A is Toeplitz: A[m][k] = F[y + dy][x0 + m + k], and ldmatrix has no
//     layout for it.  Shared memory holds each staged field row as pair
//     words P[j] = (bf16 F[j], bf16 F[j + 1]) (the field shifted and
//     rounded once, when staged), so the pair a thread needs is one aligned
//     32-bit load wherever it starts.  Thread (g, t) of the warp needs, for
//     M tile j at k step s, P[16 (j + s) + g + 2t + {0, 8, 16}]: a1 and a2
//     of the fragment are the same word, and tile j + 1 starts where tile j
//     ends, so a window of 17 words in registers serves all 8 tiles of a k
//     step, and the next k step shifts it by two words (two loads).  A
//     warp then makes 8 MMAs for 4 shared-memory loads.
//   - B (E[t0 + n][dy][k0 + k]) is staged a tap row at a time for the
//     block's 8 bins, as pair words along k, each bin's row padded to a
//     pitch that is an odd multiple of 4 words modulo 32, so that a warp's
//     fragment loads hit 32 banks.
//   - The MMA's own accumulation truncates (its float32 adder does not
//     round to nearest), which over the 10^4 MMAs of an output would bias
//     the sum by up to a few 1e-3.  So each tap row's MMAs start from zero,
//     and the row's partial is added to the output's running sum with an
//     ordinary float32 add: the truncation then acts on one row's partial,
//     a few units, not on the whole score.
//   - A block is R warps (R consecutive output rows) over one chunk of the
//     tap rows.  The R rows share each staged tap row of E, and a ring of
//     R + 1 staged field rows, one new row a tap row, serves them all.
//     The chunks split the K tap rows so that the grid fills the card;
//     with more than one chunk each writes its partial volume and a second
//     kernel sums the chunks in a fixed order and subtracts the shift mass.
//     No atomics: results repeat bit for bit on one card.
//
// The launch (rows R, chunks, pitches, shared memory) is planned in Python
// (ops/cuda/surface_corr.launch_plan); the entry point refuses a plan that
// does not fit the shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kDefaultSmem = 48 * 1024;
constexpr int kTileX = 128;        // output columns a warp: 8 M tiles of 16
constexpr int kMTiles = kTileX / 16;
constexpr int kWindow = 2 * kMTiles + 1;
constexpr int kBins = 8;           // theta bins a block: one N tile
constexpr int kMaxRows = 8;        // warps (output rows) a block

struct CorrArgs {
  const float* fpad;     // (Hp, Wp)
  const float* e;        // (nt, K, K)
  const float* mass;     // (nt,)
  float* out;            // (nt, Hc, Wc)
  float* part;           // (chunks, nt, Hc, Wc) where chunks > 1
  int Hp, Wp, K, nt, Hc, Wc;
  float shift;
  int rows, chunk, chunks, ksteps, pitch_f, pitch_e;
};

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
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

// Field row r (shifted, rounded) as pair words from column x0: word j holds
// columns x0 + j and x0 + j + 1, zero outside the padded field.
__device__ void stage_field_row(const CorrArgs& a, int r, int x0,
                                uint32_t* dst) {
  const bool in_rows = r >= 0 && r < a.Hp;
  const float* src = a.fpad + static_cast<size_t>(in_rows ? r : 0) * a.Wp;
  for (int j = threadIdx.x; j < a.pitch_f; j += blockDim.x) {
    const int c = x0 + j;
    const float lo = in_rows && c < a.Wp ? src[c] + a.shift : 0.0f;
    const float hi = in_rows && c + 1 < a.Wp ? src[c + 1] + a.shift : 0.0f;
    dst[j] = bf16_pair(lo, hi);
  }
}

// Tap row dy of the block's bins t0 .. t0 + 7 as pair words along k, zero
// past K and past nt.  The bins' loop is unrolled, so a thread's loads of
// all eight are in flight together.
__device__ void stage_taps(const CorrArgs& a, int dy, int t0, uint32_t* dst) {
  const int words = 8 * a.ksteps;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int k = 2 * w;
#pragma unroll
    for (int n = 0; n < kBins; ++n) {
      const int t = t0 + n;
      float lo = 0.0f, hi = 0.0f;
      if (t < a.nt) {
        const float* src = a.e + (static_cast<size_t>(t) * a.K + dy) * a.K;
        if (k < a.K) lo = src[k];
        if (k + 1 < a.K) hi = src[k + 1];
      }
      dst[n * a.pitch_e + w] = bf16_pair(lo, hi);
    }
  }
}

// Grid: (column tiles of 128, row groups x bin tiles, chunks); block: R
// warps.  Warp w computes output row y0 + w, columns x0 .. x0 + 127, bins
// t0 .. t0 + 7, over the tap rows [d0, d1) of its chunk.
__global__ void __launch_bounds__(kMaxRows * 32, 2)
    surface_corr_kernel(CorrArgs a) {
  extern __shared__ uint32_t smem[];
  uint32_t* ring = smem;                                  // (R + 1) field rows
  uint32_t* taps = smem + (a.rows + 1) * a.pitch_f;       // 2 x 8 bin rows
  const int n_tiles = (a.nt + kBins - 1) / kBins;
  const int x0 = blockIdx.x * kTileX;
  const int group = blockIdx.y / n_tiles;
  const int t0 = (blockIdx.y - group * n_tiles) * kBins;
  const int y0 = group * a.rows;
  const int d0 = blockIdx.z * a.chunk;
  const int d1 = min(a.K, d0 + a.chunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int y = y0 + warp;
  const int ring_n = a.rows + 1;

  for (int i = 0; i < a.rows; ++i) {
    const int r = y0 + d0 + i;
    stage_field_row(a, r, x0, ring + (r % ring_n) * a.pitch_f);
  }
  stage_taps(a, d0, t0, taps);
  __syncthreads();

  float total[kMTiles][4];
#pragma unroll
  for (int j = 0; j < kMTiles; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) total[j][c] = 0.0f;

  for (int dy = d0; dy < d1; ++dy) {
    // stage the next tap row and the field row the ring needs next into
    // the buffers this step does not read
    if (dy + 1 < d1) {
      const int r = y0 + dy + a.rows;
      stage_field_row(a, r, x0, ring + (r % ring_n) * a.pitch_f);
      stage_taps(a, dy + 1, t0, taps + ((dy + 1 - d0) & 1) * kBins * a.pitch_e);
    }
    if (y < a.Hc) {
      const uint32_t* prow = ring + ((y + dy) % ring_n) * a.pitch_f + g + 2 * tq;
      const uint32_t* brow =
          taps + ((dy - d0) & 1) * kBins * a.pitch_e + g * a.pitch_e + tq;
      uint32_t q[kWindow];
#pragma unroll
      for (int i = 0; i < kWindow; ++i) q[i] = prow[8 * i];
      float part[kMTiles][4];
#pragma unroll
      for (int j = 0; j < kMTiles; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[j][c] = 0.0f;
      for (int s = 0; s < a.ksteps; ++s) {
        const uint32_t b0 = brow[8 * s];
        const uint32_t b1 = brow[8 * s + 4];
#pragma unroll
        for (int j = 0; j < kMTiles; ++j)
          mma_bf16(part[j], q[2 * j], q[2 * j + 1], q[2 * j + 1], q[2 * j + 2],
                   b0, b1);
#pragma unroll
        for (int i = 0; i + 2 < kWindow; ++i) q[i] = q[i + 2];
        q[kWindow - 2] = prow[8 * (2 * s + kWindow)];
        q[kWindow - 1] = prow[8 * (2 * s + kWindow + 1)];
      }
#pragma unroll
      for (int j = 0; j < kMTiles; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) total[j][c] = __fadd_rn(total[j][c], part[j][c]);
    }
    __syncthreads();
  }
  if (y >= a.Hc) return;

  // fragment (j, c): column x0 + 16 j + g (+ 8 for c >= 2), bin t0 + 2 tq
  // (+ 1 for odd c)
  const size_t plane = static_cast<size_t>(a.Hc) * a.Wc;
  float* dst = a.chunks > 1 ? a.part + blockIdx.z * a.nt * plane : a.out;
#pragma unroll
  for (int j = 0; j < kMTiles; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int x = x0 + 16 * j + g + (c >= 2 ? 8 : 0);
      const int t = t0 + 2 * tq + (c & 1);
      if (x >= a.Wc || t >= a.nt) continue;
      float v = total[j][c];
      if (a.chunks == 1) v = __fsub_rn(v, __fmul_rn(a.shift, a.mass[t]));
      dst[t * plane + static_cast<size_t>(y) * a.Wc + x] = v;
    }
  }
}

// out = the chunks' partial volumes summed in chunk order, minus the shift
// mass.
__global__ void surface_corr_sum(CorrArgs a) {
  const size_t plane = static_cast<size_t>(a.Hc) * a.Wc;
  const size_t n = a.nt * plane;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = a.part[i];
    for (int c = 1; c < a.chunks; ++c) v = __fadd_rn(v, a.part[c * n + i]);
    const int t = static_cast<int>(i / plane);
    a.out[i] = __fsub_rn(v, __fmul_rn(a.shift, a.mass[t]));
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

}  // namespace

// fpad (Hp, Wp), e (nt, K, K), mass (nt,) -> out (nt, Hc, Wc), Hc = Hp - K
// + 1, Wc = Wp - K + 1; part: (chunks, nt, Hc, Wc) scratch where chunks > 1.
// The plan: rows R (warps a block), chunk (tap rows a chunk), chunks,
// ksteps = ceil(K / 16), the pitches in words and the shared memory.
extern "C" int gs_surface_corr(const float* fpad, const float* e,
                               const float* mass, float* out, float* part,
                               int Hp, int Wp, int K, int nt, float shift,
                               int rows, int chunk, int chunks, int ksteps,
                               int pitch_f, int pitch_e, int smem_bytes,
                               void* stream) {
  if (K <= 0 || nt <= 0 || Hp < K || Wp < K) {
    return cudaErrorInvalidValue;
  }
  const int hc = Hp - K + 1;
  const int wc = Wp - K + 1;
  const int n_tiles = (nt + kBins - 1) / kBins;
  const long long groups = (hc + rows - 1) / static_cast<long long>(rows);
  const long long col_tiles = (wc + kTileX - 1) / kTileX;
  const size_t need =
      (static_cast<size_t>(rows + 1) * pitch_f + 2 * kBins * pitch_e) * 4;
  if (rows < 1 || rows > kMaxRows || chunk < 1 || chunks < 1 ||
      static_cast<long long>(chunk) * chunks < K ||
      static_cast<long long>(chunk) * (chunks - 1) >= K ||
      ksteps != (K + 15) / 16 || pitch_f < 16 * ksteps + 8 * kWindow + 16 ||
      pitch_e < 8 * ksteps || (pitch_e % 32 != 4 && pitch_e % 32 != 12 &&
                               pitch_e % 32 != 20 && pitch_e % 32 != 28) ||
      (chunks > 1 && part == nullptr) || smem_bytes < 0 ||
      need > static_cast<size_t>(smem_bytes) ||
      smem_bytes > max_smem_optin() || groups * n_tiles > 65535 ||
      chunks > 65535 || col_tiles > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  if (smem_bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        surface_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const CorrArgs a{fpad, e, mass, out, part, Hp, Wp, K, nt, hc, wc, shift,
                   rows, chunk, chunks, ksteps, pitch_f, pitch_e};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(groups * n_tiles),
                  static_cast<unsigned>(chunks));
  surface_corr_kernel<<<grid, rows * 32, smem_bytes, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const size_t n = static_cast<size_t>(nt) * hc * wc;
  const unsigned blocks =
      static_cast<unsigned>(std::min<size_t>((n + 255) / 256, 132 * 8));
  surface_corr_sum<<<blocks, 256, 0, st>>>(a);
  return cudaGetLastError();
}
