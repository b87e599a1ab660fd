// Eight of XLA's fusions as kernels: F1 the motion model, F2 the coarse
// stage's pool, F3 a matcher stage's pick, F4 the surface's trilinear sample
// and hill-climb, F5 the endpoint splat's tap weights, F6 the scan's
// preparation (deskew and the bearing-bin tables), F7 the weights' tail
// (max, first argmax, Neff, the weighted mean pose and the shared map's
// scalar epilogue) and F8 the systematic walk of the resample.
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
// shared.py:386-461 and models/multi.py:110-142).  In PyTorch each tensor operation of them
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
// writes a few floats; F8 reads the log-weights twice and writes the
// scan (4 MB, in L2), then each slot's ~20 probes of it and its gathers.
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
// F4: a thread a pose; its eight taps are read from the (nt, hc, wc)
// volume in place at the cells the packed neighbourhood array
// (ops/surface.pack_neighborhoods) would hold, so that array is never
// built; the hill-climb keeps the pose and its score in registers for all
// its steps.  F5: a warp a (bin, beam) row of K taps, its lanes on
// neighbouring taps.  F6: a block a scan, its beams in shared memory,
// ranked by counting (B^2 comparisons: B is a few hundred), then a thread
// a bearing bin.  F7 and F8: the sums take ops/resample.py's fixed order,
// which its plain functions spell out with elementwise ops so that no
// PyTorch reduction order (chosen by PyTorch from the size and the card)
// is left to match: a block of 128 threads takes a row of 1024 weights, a
// thread a segment of 8 added left to right, the row's segments by a
// halving tree (shuffles below 32) or a Hillis-Steele scan in shared
// memory, and the rows' partials by the same tree or scan in every block
// that needs them (at most 1024 of them).  F7 is three launches (the rows'
// first argmax; the max and each row's sum of exp; each row's sums of w w
// and w pose, then the last block, by a ticket pass 1 resets, sums the
// rows and writes the outputs and the epilogue); F8 two (each row's scan
// of the normalized weights; a thread a slot: the rows' carry, the binary
// search and the gathers).  The max is the value at the first argmax
// (order-free), the exp the CUDA math library's expf, as torch.exp's.

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
};

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
    const long long* __restrict__ ix0, float* __restrict__ poses_out,
    float* __restrict__ scores_out, int n, int steps, Surface s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t0 = *theta0;
  const float fy0 = static_cast<float>(*iy0), fx0 = static_cast<float>(*ix0);
  float x = poses[3 * i], y = poses[3 * i + 1], th = poses[3 * i + 2];
  float score = surface_sample(vol, x, y, th, t0, fy0, fx0, s);
  if (steps == 0) {
    scores_out[i] = score;
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
  scores_out[i] = score;
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

// F6.  angle, dist (G, B) float32, hit, valid (G, B) bool; d_center,
// d_theta (G,) or null.  With odometry: ops/geometry.deskew_scan into
// out_angle, out_dist.  With n_bins > 0: ops/cuda/grid_update.
// scan_bin_tables of the (deskewed) scan into t_dist, t_alpha, t_code
// (G, n_bins): the valid beams' wrapped angles (+inf for the others)
// argsorted, each bin center's searchsorted position (side left), the
// nearer of the two beams around it (left on a tie) and that beam's data.
__global__ void __launch_bounds__(kScanThreads) fusion_scan_kernel(
    const float* __restrict__ angle, const float* __restrict__ dist,
    const bool* __restrict__ hit, const bool* __restrict__ valid,
    const float* __restrict__ d_center, const float* __restrict__ d_theta,
    float* __restrict__ out_angle, float* __restrict__ out_dist,
    float* __restrict__ t_dist, float* __restrict__ t_alpha,
    float* __restrict__ t_code, int B, int n_bins, float bin_step) {
  extern __shared__ float sm[];
  float* a_use = sm;              // the (deskewed) angles
  float* d_use = a_use + B;       // and distances
  float* key = d_use + B;         // the sort's keys
  float* sorted = key + B;
  int* order = reinterpret_cast<int*>(sorted + B);
  __shared__ int count;
  const int g = blockIdx.x;
  const size_t row = static_cast<size_t>(g) * B;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  int mine = 0;
  for (int i = threadIdx.x; i < B; i += blockDim.x) mine += valid[row + i];
  atomicAdd(&count, mine);        // an integer count: exact in any order
  __syncthreads();
  const int n_valid = max(count, 1);
  const float nf = static_cast<float>(n_valid);
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
  }
  if (n_bins <= 0) return;
  __syncthreads();
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

// The total of nb row totals (read through L2: other blocks of the same
// launch may have written them), padded with +0.0 to the power of two q at
// or above nb and halved from q / 2; every thread gets it.  s holds kRow
// floats.
__device__ float rows_total(const float* part, int nb, float* s) {
  int q = 1;
  while (q < nb) q <<= 1;
  for (int i = threadIdx.x; i < q; i += blockDim.x)
    s[i] = i < nb ? __ldcg(part + i) : 0.0f;
  __syncthreads();
  for (int h = q >> 1; h >= 1; h >>= 1) {
    for (int i = threadIdx.x; i < h; i += blockDim.x)
      s[i] = __fadd_rn(s[i], s[i + h]);
    __syncthreads();
  }
  const float v = s[0];
  __syncthreads();
  return v;
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

// F7, pass 1: each row's first argmax of the log-weights lw (R, P) into pv,
// pi (R, nb); block (0, r) sets robot r's ticket of pass 3 to 0.
__global__ void __launch_bounds__(kRowThreads) fusion_weights_max_kernel(
    const float* __restrict__ lw, float* __restrict__ pv,
    int* __restrict__ pi, unsigned* __restrict__ ticket, int P, int nb) {
  __shared__ float s_v[kWarp];
  __shared__ int s_i[kWarp];
  const int r = blockIdx.y, b = blockIdx.x;
  const float* x = lw + static_cast<size_t>(r) * P;
  const int base = b * kRow + threadIdx.x * kSeg;
  float v = 0.0f;
  int i = -1;
  for (int j = 0; j < kSeg; ++j) {
    const int k = base + j;
    if (k < P && before(x[k], k, v, i)) {
      v = x[k];
      i = k;
    }
  }
  block_argmax(v, i, s_v, s_i);
  if (threadIdx.x == 0) {
    pv[static_cast<size_t>(r) * nb + b] = v;
    pi[static_cast<size_t>(r) * nb + b] = i;
    if (b == 0) ticket[r] = 0u;
  }
}

// F7, pass 2: the max m (the value at the first argmax), then each row's
// sum of exp(lw - m), its segments in turn and the row by row_total, into
// pe (R, nb).
__global__ void __launch_bounds__(kRowThreads) fusion_weights_sum_kernel(
    const float* __restrict__ lw, const float* __restrict__ pv,
    const int* __restrict__ pi, float* __restrict__ pe, int P, int nb) {
  __shared__ float s[kRowThreads];
  __shared__ float s_v[kWarp];
  __shared__ int s_i[kWarp];
  const int r = blockIdx.y, b = blockIdx.x;
  float m;
  int mi;
  rows_argmax(pv + static_cast<size_t>(r) * nb, pi + static_cast<size_t>(r) * nb,
              nb, m, mi, s_v, s_i);
  const float* x = lw + static_cast<size_t>(r) * P;
  const int base = b * kRow + threadIdx.x * kSeg;
  float acc = 0.0f;
  for (int j = 0; j < kSeg; ++j) {
    const int k = base + j;
    const float e = k < P ? weight_exp(__fsub_rn(x[k], m)) : 0.0f;
    acc = j == 0 ? e : __fadd_rn(acc, e);
  }
  const float tot = row_total(acc, s);
  if (threadIdx.x == 0) pe[static_cast<size_t>(r) * nb + b] = tot;
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
};

// F7, pass 3: m and the total again; each weight w = exp(lw - m) / total
// and the rows' sums of w w, x w, y w and wrap(theta) w (segments in turn,
// rows by row_total) into p4 (R, 4, nb); then the last block of a robot (its
// ticket) sums the rows (rows_total) and writes the max, the total, the
// first argmax and its pose, Neff = 1 / sum(w w), the weighted mean pose
// and, where out.gate is given, the epilogue: the resample gate Neff <
// P fraction, the integration pose (the weighted mean where Neff >= 0.95 P,
// else the best pose), and with recov the recovery EMAs of the max (both
// set to it at step 0), p_inject = clamp(1 - exp(l_fast - l_slow), 0,
// 0.3) and the gate forced where p_inject > 0.05.
__global__ void __launch_bounds__(kRowThreads) fusion_weights_finish_kernel(
    const float* __restrict__ lw, const float* __restrict__ pv,
    const int* __restrict__ pi, const float* __restrict__ pe,
    float* __restrict__ p4, unsigned* __restrict__ ticket, int P, int nb,
    WeightsOut o) {
  __shared__ float s[kRow];
  __shared__ float s_v[kWarp];
  __shared__ int s_i[kWarp];
  __shared__ bool last;
  const int r = blockIdx.y, b = blockIdx.x;
  float m;
  int mi;
  rows_argmax(pv + static_cast<size_t>(r) * nb, pi + static_cast<size_t>(r) * nb,
              nb, m, mi, s_v, s_i);
  const float total = rows_total(pe + static_cast<size_t>(r) * nb, nb, s);
  const float* x = lw + static_cast<size_t>(r) * P;
  const float* ps = o.poses + static_cast<size_t>(r) * P * 3;
  const int base = b * kRow + threadIdx.x * kSeg;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < kSeg; ++j) {
    const int k = base + j;
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (k < P) {
      const float w = __fdiv_rn(weight_exp(__fsub_rn(x[k], m)), total);
      q[0] = __fmul_rn(w, w);
      q[1] = __fmul_rn(ps[3 * k], w);
      q[2] = __fmul_rn(ps[3 * k + 1], w);
      q[3] = __fmul_rn(wrap(ps[3 * k + 2]), w);
    }
    for (int c = 0; c < 4; ++c) a[c] = j == 0 ? q[c] : __fadd_rn(a[c], q[c]);
  }
  float* row = p4 + static_cast<size_t>(r) * 4 * nb;
  for (int c = 0; c < 4; ++c) {
    const float t = row_total(a[c], s);
    if (threadIdx.x == 0) row[static_cast<size_t>(c) * nb + b] = t;
  }
  __threadfence();
  if (threadIdx.x == 0) last = atomicAdd(ticket + r, 1u) == nb - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float sums[4];
  for (int c = 0; c < 4; ++c)
    sums[c] = rows_total(row + static_cast<size_t>(c) * nb, nb, s);
  if (threadIdx.x != 0) return;
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
  if (o.gate == nullptr) return;
  bool gate = neff < o.thr_gate;
  if (o.integ != nullptr) {
    const bool mean = neff >= o.thr_integ;
    for (int c = 0; c < 3; ++c) o.integ[c] = mean ? sums[1 + c] : bp[c];
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

// F8, pass 1: the normalized weights exp(lw - m) / total of one robot (m,
// total: F7's, one float each on the card) and each row's inclusive scan in
// the fixed order into part (nb kRow): a thread's segment in turn, the
// row's segment totals by a Hillis-Steele scan (s[i] + s[i - k], k = 1, 2,
// ... 64), each segment after the first plus the scan before it.
__global__ void __launch_bounds__(kRowThreads) fusion_walk_scan_kernel(
    const float* __restrict__ lw, const float* __restrict__ m_ptr,
    const float* __restrict__ total_ptr, float* __restrict__ part, int P) {
  __shared__ float s[kRowThreads];
  const float m = *m_ptr, total = *total_ptr;
  const int t = threadIdx.x, base = blockIdx.x * kRow + t * kSeg;
  float c[kSeg];
  for (int j = 0; j < kSeg; ++j) {
    const int k = base + j;
    const float w =
        k < P ? __fdiv_rn(weight_exp(__fsub_rn(lw[k], m)), total) : 0.0f;
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

// F8, pass 2: a thread a slot j < P.  u = u0 + j (1 / P) (PyTorch divides
// by a Python int on the card as a product by its float reciprocal, inv_p);
// the first index whose cumulative weight is >= u, by torch.searchsorted's
// binary search (side left), clamped to P - 1; the cumulative weight at i
// is part[i], past the first row plus the Hillis-Steele scan of the rows'
// totals (each row's last) before its row (every block scans the nb <= kRow
// totals).  Writes idx[j] and the poses and log-weights (lw_out where
// given) at idx[j].
__global__ void __launch_bounds__(kSearchThreads) fusion_walk_search_kernel(
    const float* __restrict__ lw, const float* __restrict__ poses,
    const float* __restrict__ u0_ptr, const float* __restrict__ part,
    long long* __restrict__ idx_out, float* __restrict__ poses_out,
    float* __restrict__ lw_out, int P, int nb, float inv_p) {
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
  const int j = blockIdx.x * kSearchThreads + t;
  if (j >= P) return;
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
  idx_out[j] = i;
  for (int c = 0; c < 3; ++c) poses_out[3 * j + c] = poses[3 * i + c];
  if (lw_out != nullptr) lw_out[j] = lw[i];
}

// weight_exp elementwise, for the exp probe (no path calls it).
__global__ void __launch_bounds__(kThreads) fusion_exp_kernel(
    const float* __restrict__ x, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = weight_exp(x[i]);
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

// F4: vol (nt, hc, wc) with strides st, sy (cells contiguous in a row);
// poses (n, 3); theta0 (float), iy0, ix0 (int64) one each on the card;
// poses_out (n, 3) (steps > 0, else null), scores_out (n,); the crop's
// shape, wrap_theta, the climb's steps (0: the sample alone), origin,
// 1 / resolution and 1 / dtheta in float, the moves (resolution, dtheta);
// stream.
extern "C" int gs_fusion_sample(
    const float* vol, const float* poses, const float* theta0,
    const long long* iy0, const long long* ix0, float* poses_out,
    float* scores_out, int n, int nt, int hc, int wc, long long st,
    long long sy, int wrap_theta, int steps, float ox, float oy,
    float inv_res, float inv_dt, float step_xy, float step_t, void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || nt <= 0 || hc <= 0 || wc <= 0 || steps < 0 ||
      (poses_out == nullptr) != (steps == 0))
    return cudaErrorInvalidValue;
  fusion_sample_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      vol, poses, theta0, iy0, ix0, poses_out, scores_out, n, steps,
      Surface{nt, hc, wc, wrap_theta != 0, st, sy, ox, oy, inv_res, inv_dt,
              step_xy, step_t});
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
// tables; bin_step = 2 pi / n_bins in float; stream.
extern "C" int gs_fusion_scan(const float* angle, const float* dist,
                              const bool* hit, const bool* valid,
                              const float* d_center, const float* d_theta,
                              float* out_angle, float* out_dist, float* t_dist,
                              float* t_alpha, float* t_code, int G, int B,
                              int n_bins, float bin_step, void* stream) {
  if (G == 0) return cudaSuccess;
  if (G < 0 || B <= 0 || n_bins < 0 ||
      (d_center != nullptr) != (d_theta != nullptr) ||
      (d_center != nullptr && (out_angle == nullptr || out_dist == nullptr)) ||
      (n_bins > 0 && (t_dist == nullptr || t_alpha == nullptr ||
                      t_code == nullptr)))
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(B) * 5 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fusion_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fusion_scan_kernel<<<G, kScanThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      angle, dist, hit, valid, d_center, d_theta, out_angle, out_dist, t_dist,
      t_alpha, t_code, B, n_bins, bin_step);
  return static_cast<int>(cudaGetLastError());
}

// F7: lw (R, P); poses (R, P, 3); recov (2,) and step (one int) or null;
// out_max, out_total, out_neff (R,), out_index (R,) int64, out_best,
// out_weighted (R, 3); out_gate (R,) bool or null (no epilogue), out_integ
// (3,) or null, out_recov (2,) and out_pinj (1,) with recov (R = 1 for the
// last three); scratch_f (6 R nb floats), scratch_i (R nb + R ints), nb =
// ceil(P / 1024); the epilogue's floats; stream; &launched (kernels).
extern "C" int gs_fusion_weights(
    const float* lw, const float* poses, const float* recov, const int* step,
    float* out_max, float* out_total, long long* out_index, float* out_best,
    float* out_neff, float* out_weighted, bool* out_gate, float* out_integ,
    float* out_recov, float* out_pinj, float* scratch_f, int* scratch_i,
    int R, int P, float thr_integ, float thr_gate, float a_slow,
    float a_fast, float thr_inject, float hi_inject, void* stream,
    int* launched) {
  *launched = 0;
  if (R <= 0 || P <= 0 || P > kRow * kRow || R > 65535)
    return cudaErrorInvalidValue;
  if ((recov != nullptr || out_integ != nullptr) &&
      (R != 1 || out_gate == nullptr))
    return cudaErrorInvalidValue;
  if (recov != nullptr &&
      (step == nullptr || out_recov == nullptr || out_pinj == nullptr))
    return cudaErrorInvalidValue;
  const int nb = (P + kRow - 1) / kRow;
  const size_t rn = static_cast<size_t>(R) * nb;
  float* pv = scratch_f;
  float* pe = pv + rn;
  float* p4 = pe + rn;
  int* pi = scratch_i;
  unsigned* ticket = reinterpret_cast<unsigned*>(pi + rn);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nb, R);
  fusion_weights_max_kernel<<<grid, kRowThreads, 0, st>>>(lw, pv, pi, ticket,
                                                          P, nb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 1;
  fusion_weights_sum_kernel<<<grid, kRowThreads, 0, st>>>(lw, pv, pi, pe, P,
                                                          nb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 2;
  const WeightsOut o{poses, recov, step, out_max, out_total, out_best,
                     out_neff, out_weighted, out_index, out_integ, out_recov,
                     out_pinj, out_gate, thr_integ, thr_gate, a_slow, a_fast,
                     thr_inject, hi_inject};
  fusion_weights_finish_kernel<<<grid, kRowThreads, 0, st>>>(
      lw, pv, pi, pe, p4, ticket, P, nb, o);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launched = 3;
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

// F7's exp (weight_exp) over x (n,) into out (n,): the exp probe; stream.
extern "C" int gs_fusion_exp(const float* x, float* out, int n,
                             void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  fusion_exp_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}
