// Three of XLA's fusions as kernels: F1 the motion model, F2 the coarse
// stage's pool and F3 a matcher stage's pick.
//
// They replace no Pallas kernel.  In the JAX package XLA fuses each of these
// runs of elementwise and reduce operations into one loop or reduce fusion:
// RBPF.step vmaps sample_motion and apply_odometry
// (gridmap_slam_tpu/models/rbpf.py:180-182) and the matcher's prior, argmax
// and pick (gridmap_slam_tpu/ops/matcher.py:302-321, with _prior_grid
// :137-153 and _argmax3 :156-162) inside its lax.map, and pools the coarse
// field once (:246-252).  In PyTorch each tensor operation of them is a
// kernel of its own, and the prior and the total of a coarse stage are two
// more tensors of the stage's scores' size.  Each kernel here does the whole
// run in one pass.
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
// reciprocal: only / 2.0 occurs, exact either way.
//
// Bound on the H100: bytes.  F3 reads a stage's (P, nt, ny, nx) scores once
// (1.78 GB a coarse stage of a 500 000-particle block) and writes a few
// floats a particle; a candidate costs two IEEE divisions and ten other
// operations, well under the bytes' time at 67 TFLOP/s.  F1 reads a pose and
// two normals and writes one or two poses; F2 reads the field once and writes
// a quarter of it.
//
// Layout.  F1 and F2: a thread a particle or an output cell.  F3: a warp a
// particle.  Its prior's quotients are tables in shared memory, one a
// (dy, dx) and one a heading (ny nx + nt divisions a particle, not two a
// candidate: a first design that divided a candidate took 7.8 ms a scan of
// mega_blocked's 6 calls on an H100).  The lanes stride over a heading's (dy, dx)
// candidates in flat order (coalesced reads of the scores), each keeping
// the first maximum of its own; a butterfly of shuffles combines them in
// one total order (NaN first, then the larger value, then the smaller
// index), so every lane ends with the first argmax.  The coarse stage's used-beam counts come from the scan's
// mask by ballots (integers, so exact as the float sums they replace).

#include <cuda_runtime.h>

#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr size_t kTableBytes = 48 * 1024;   // F3's prior tables a block

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
  float weight;
  Motion m;
};

// Whether (v, i) comes before (w, j) in the argmax's order: a NaN first,
// then the larger value, then the smaller index; j < 0 is no candidate.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  if (j < 0) return i >= 0;
  if (i < 0) return false;
  const bool vn = isnan(v), wn = isnan(w);
  if (vn != wn) return vn;
  if (!vn && v != w) return v > w;
  return i < j;
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
__global__ void __launch_bounds__(kThreads) fusion_pick_kernel(
    const float* __restrict__ scores, const float* __restrict__ dxs,
    const float* __restrict__ dys, const float* __restrict__ dts,
    const float* __restrict__ pose0, const float* __restrict__ center,
    const float* __restrict__ d_center, const float* __restrict__ d_theta,
    const bool* __restrict__ use, const float* __restrict__ off_xy,
    const float* __restrict__ off_t, float* __restrict__ out_dxs,
    float* __restrict__ out_dys, float* __restrict__ out_dts,
    float* __restrict__ best, float* __restrict__ meas_best, Pick k) {
  const int lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (p >= k.P) return;                    // the whole warp leaves
  const int o = p / k.per_o;
  const float2 sd = noise(d_center[o], d_theta[o], k.m);
  const float den_c = __fmul_rn(__fmul_rn(2.0f, sd.x), sd.x);
  const float den_t = __fmul_rn(__fmul_rn(2.0f, sd.y), sd.y);
  float bx = 0.0f, by = 0.0f, bt = 0.0f;
  if (center != nullptr) {
    bx = __fsub_rn(pose0[3 * p], center[3 * p]);
    by = __fsub_rn(pose0[3 * p + 1], center[3 * p + 1]);
    bt = wrap(__fsub_rn(pose0[3 * p + 2], center[3 * p + 2]));
  }
  const bool coarse = use != nullptr;
  float scale = 1.0f, unscale = 1.0f;
  if (coarse) {
    const bool* row = use + static_cast<size_t>(p / k.per_b) * k.B;
    int n_all = 0, n_c = 0;
    for (int j0 = 0; j0 < k.B; j0 += kWarp) {
      const int j = j0 + lane;
      const bool u = j < k.B && row[j];
      n_all += __popc(__ballot_sync(0xffffffffu, u));
      n_c += __popc(__ballot_sync(0xffffffffu, u && j % k.stride == 0));
    }
    const float fa = fmaxf(static_cast<float>(n_all), 1.0f);
    const float fc = fmaxf(static_cast<float>(n_c), 1.0f);
    scale = __fdiv_rn(fc, fa);
    unscale = __fdiv_rn(fa, fc);
  }
  const float* px = dxs + static_cast<size_t>(p) * k.nx;
  const float* py = dys + static_cast<size_t>(p) * k.ny;
  const float* pt = dts + static_cast<size_t>(p) * k.nt;
  const int nyx = k.ny * k.nx, n = k.nt * nyx;
  const float* s = scores + static_cast<size_t>(p) * n;
  // The prior's two quotients depend on (iy, ix) and on it alone: each is
  // taken once a particle into the warp's slice of shared memory, q[r] =
  // d2 / (2 sd_c sd_c) for r = iy nx + ix and qt[it] = -(dt^2) / (2 sd_t
  // sd_t), the same floats the candidates' separate tensor ops give.
  extern __shared__ float table[];
  float* q = table + (threadIdx.x / kWarp) * (nyx + k.nt);
  float* qt = q + nyx;
  for (int r = lane; r < nyx; r += kWarp) {
    const int iy = r / k.nx, ix = r - iy * k.nx;
    const float ay = __fadd_rn(py[iy], by), ax = __fadd_rn(px[ix], bx);
    q[r] = __fdiv_rn(__fadd_rn(__fmul_rn(ay, ay), __fmul_rn(ax, ax)), den_c);
  }
  for (int it = lane; it < k.nt; it += kWarp) {
    const float at = __fadd_rn(pt[it], bt);
    qt[it] = __fdiv_rn(-__fmul_rn(at, at), den_t);
  }
  __syncwarp();
  float bv = 0.0f;
  int bi = -1;
  for (int it = 0; it < k.nt; ++it) {
    const float prior_t = qt[it];
    for (int r = lane; r < nyx; r += kWarp) {
      const int i = it * nyx + r;
      const float prior = __fmul_rn(__fsub_rn(prior_t, q[r]), k.weight);
      const float v =
          __fadd_rn(s[i], coarse ? __fmul_rn(scale, prior) : prior);
      if (before(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float w = __shfl_xor_sync(0xffffffffu, bv, off);
    const int j = __shfl_xor_sync(0xffffffffu, bi, off);
    if (before(w, j, bv, bi)) {
      bv = w;
      bi = j;
    }
  }
  const int it = bi / nyx, r = bi - it * nyx;
  const int iy = r / k.nx, ix = r - iy * k.nx;
  const float fx = px[ix], fy = py[iy], ft = pt[it];
  if (off_xy != nullptr) {
    for (int j = lane; j < k.n_xy; j += kWarp) {
      out_dxs[static_cast<size_t>(p) * k.n_xy + j] = __fadd_rn(fx, off_xy[j]);
      out_dys[static_cast<size_t>(p) * k.n_xy + j] = __fadd_rn(fy, off_xy[j]);
    }
    for (int j = lane; j < k.n_t; j += kWarp)
      out_dts[static_cast<size_t>(p) * k.n_t + j] = __fadd_rn(ft, off_t[j]);
  } else if (lane == 0) {
    best[3 * p] = __fadd_rn(pose0[3 * p], fx);
    best[3 * p + 1] = __fadd_rn(pose0[3 * p + 1], fy);
    best[3 * p + 2] = __fadd_rn(pose0[3 * p + 2], ft);
    meas_best[p] = coarse ? __fmul_rn(unscale, s[bi]) : s[bi];
  }
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
// the shapes, the coarse stride, prior_weight, the motion config (base_t in
// radians); stream.  G_o and G_b divide P; P nt ny nx < 2^31.
extern "C" int gs_fusion_pick(
    const float* scores, const float* dxs, const float* dys,
    const float* dts, const float* pose0, const float* center,
    const float* d_center, const float* d_theta, const bool* use,
    const float* off_xy, const float* off_t, float* out_dxs, float* out_dys,
    float* out_dts, float* best, float* meas_best, int P, int nt, int ny,
    int nx, int G_o, int G_b, int B, int stride, int n_xy, int n_t,
    float weight, float base_c, float rel_c, float base_t, float rel_t,
    void* stream) {
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
  const Pick k{P, nt, ny, nx, P / G_o, use != nullptr ? P / G_b : 1, B,
               stride, n_xy, n_t, weight,
               Motion{base_c, rel_c, base_t, rel_t}};
  // a warp's prior tables, (ny nx + nt) floats, in at most 48 KB a block
  const size_t table = (static_cast<size_t>(ny) * nx + nt) * sizeof(float);
  if (table > kTableBytes) return cudaErrorInvalidValue;
  const int warps = static_cast<int>(
      std::min<size_t>(kThreads / kWarp, kTableBytes / table));
  fusion_pick_kernel<<<(P + warps - 1) / warps, warps * kWarp,
                       warps * table, static_cast<cudaStream_t>(stream)>>>(
      scores, dxs, dys, dts, pose0, center, d_center, d_theta, use, off_xy,
      off_t, out_dxs, out_dys, out_dts, best, meas_best, k);
  return static_cast<int>(cudaGetLastError());
}
