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
// cell.  Design: one block per (particle, tile row, tile column) of a
// T x T output tile.  The block stages the tile plus its r-cell halo in
// shared memory as one byte a cell, runs the horizontal pass over the halo
// rows into shared memory, then the vertical pass and the log epilogue
// straight to the output.  A staged byte holds 2p (p = 0, 1/2, 1) in bits
// 0-1 and the evidence flag (p != 1/2) in bit 2, so a tap decodes both
// exactly with two integer ops and two conversions; a cell outside the map
// is 0 (p = 0, no evidence).  T is a template parameter, so the passes
// index their planes with constant strides.  Shared memory is sized from
// the radius at launch, as dynamic shared memory (opted in above 48 KB): T
// is the largest of 32, 16, ..., 1 whose (T + 2r)^2 bytes of codes,
// 2 (T + 2r) T floats of the horizontal pass and 2 (2r + 1) floats of taps
// fit the card's per-block limit, so any radius up to 236 cells (227 KB at
// T = 1) runs.  The column tiling keeps shared memory independent of the
// map width (the TPU kernel needed H % 8 == 0 and W % 128 == 0; this one
// takes any H x W).  Taps are summed in tap order with no atomics, so runs
// are bit-stable.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxTile = 32;
constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

// Staged codes: 2p in bits 0-1, evidence in bit 2.
constexpr unsigned char kOutside = 0;    // p = 0, no evidence (zero boundary)
constexpr unsigned char kUnknown = 1;    // p = 1/2, no evidence
constexpr unsigned char kFree = 4;       // p = 0
constexpr unsigned char kOccupied = 6;   // p = 1

// Bytes of dynamic shared memory for a tile x tile output tile: the taps
// and the halved taps, the two horizontal-pass planes, then the codes.
size_t smem_bytes(int tile, int radius) {
  const size_t span = tile + 2 * static_cast<size_t>(radius);
  const size_t taps = 2 * static_cast<size_t>(radius) + 1;
  return (2 * taps + 2 * span * tile) * sizeof(float) + span * span;
}

template <int kTile>
__global__ void __launch_bounds__(kThreads)
ll_field_kernel(const float* __restrict__ lo, float* __restrict__ out,
                const float* __restrict__ taps, int radius, int H, int W,
                float z_hit, float c_rand, float v_eq) {
  extern __shared__ float smem[];
  const int n_taps = 2 * radius + 1;
  const int span = kTile + 2 * radius;
  float* s_taps = smem;                              // (n_taps,)
  float* s_half = s_taps + n_taps;                   // (n_taps,) taps / 2
  float* h_p = s_half + n_taps;                      // (span, kTile)
  float* h_e = h_p + span * kTile;                   // (span, kTile)
  unsigned char* s_code =                            // (span, span)
      reinterpret_cast<unsigned char*>(h_e + span * kTile);

  const int p = blockIdx.x;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.z * kTile;
  const float* map = lo + static_cast<size_t>(p) * H * W;
  float* dst = out + static_cast<size_t>(p) * H * W;

  for (int k = threadIdx.x; k < n_taps; k += kThreads) {
    s_taps[k] = taps[k];
    s_half[k] = 0.5f * taps[k];
  }
  for (int i = threadIdx.x; i < span * span; i += kThreads) {
    const int ry = i / span, rx = i % span;
    const int y = y0 - radius + ry, x = x0 - radius + rx;
    unsigned char c = kOutside;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float l = map[static_cast<size_t>(y) * W + x];
      c = l > 0.f ? kOccupied : (l < 0.f ? kFree : kUnknown);
    }
    s_code[i] = c;
  }
  __syncthreads();

  // half-tap * 2p is the same float product as tap * p (scaling by 1/2 is
  // exact), and tap * e is tap or 0
  for (int i = threadIdx.x; i < span * kTile; i += kThreads) {
    const int ry = i / kTile, cx = i % kTile;
    const unsigned char* row = s_code + ry * span + cx;
    float ap = 0.f, ae = 0.f;
    for (int k = 0; k < n_taps; ++k) {
      const unsigned c = row[k];
      ap += s_half[k] * static_cast<float>(c & 3u);
      ae += s_taps[k] * static_cast<float>(c >> 2);
    }
    h_p[i] = ap;
    h_e[i] = ae;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int cy = i / kTile, cx = i % kTile;
    const int y = y0 + cy, x = x0 + cx;
    if (y >= H || x >= W) continue;
    const float* col_p = h_p + cy * kTile + cx;
    const float* col_e = h_e + cy * kTile + cx;
    float f = 0.f, e = 0.f;
    for (int k = 0; k < n_taps; ++k) {
      f += s_taps[k] * col_p[k * kTile];
      e += s_taps[k] * col_e[k * kTile];
    }
    const float v = e <= 0.f ? v_eq : f;
    dst[static_cast<size_t>(y) * W + x] = logf(z_hit * v + c_rand);
  }
}

template <int kTile>
int launch(const float* lo, float* out, const float* taps, int radius, int P,
           int H, int W, float z_hit, float c_rand, float v_eq,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(kTile, radius);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ll_field_kernel<kTile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(P, (H + kTile - 1) / kTile, (W + kTile - 1) / kTile);
  ll_field_kernel<kTile><<<grid, kThreads, smem, stream>>>(
      lo, out, taps, radius, H, W, z_hit, c_rand, v_eq);
  return static_cast<int>(cudaGetLastError());
}

// launch<T> for T = 1, 2, 4, ..., 32, indexed by log2(T).
using Launch = int (*)(const float*, float*, const float*, int, int, int, int,
                       float, float, float, cudaStream_t);
constexpr Launch kLaunch[] = {launch<1>, launch<2>, launch<4>,
                              launch<8>, launch<16>, launch<32>};

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

// Output tile edge K3 uses at this blur radius on the current device: the
// largest power of two <= 32 whose staged window fits; 0 if none does.
extern "C" int gs_ll_field_tile(int radius) {
  if (radius < 0) return 0;
  const size_t limit = static_cast<size_t>(max_smem_optin());
  for (int tile = kMaxTile; tile >= 1; tile /= 2) {
    if (smem_bytes(tile, radius) <= limit) return tile;
  }
  return 0;
}

// lo, out: (P, H, W) float32; taps: (2 * radius + 1,) float32 on the card.
// c_rand = (1 - z_hit) / max_range; v_eq = the effective field value of an
// unknown cell (ops/matcher.effective_field).
extern "C" int gs_ll_field(const float* lo, float* out, const float* taps,
                           int radius, int P, int H, int W, float z_hit,
                           float c_rand, float v_eq, void* stream) {
  const int tile = gs_ll_field_tile(radius);
  if (tile == 0) return cudaErrorInvalidValue;
  if (P == 0 || H == 0 || W == 0) return cudaSuccess;
  return kLaunch[__builtin_ctz(tile)](lo, out, taps, radius, P, H, W, z_hit,
                                      c_rand, v_eq,
                                      static_cast<cudaStream_t>(stream));
}
