// One pass of the coarse tracker's level loops in one launch (sm_90a):
// coarse_pass, the linearization of a level template at a pose (DSO's
// calcRes and calcGSSSE, ops/coarse_tracker.calc_res and calc_gs) with the
// loop's scalar tail in the grid's last block.
//
// The JAX package leaves calcRes / calcGS to XLA, which fuses them on a TPU
// (slam_eds_tpu/ops/coarse_tracker.py); there is no TPU kernel. The port's
// plain version (ops/coarse_tracker.track_level_plain) is about 280
// element-wise torch launches a level LM pass and about 100 a cutoff
// doubling; captured, each is a node of the loop's WHILE body, run one
// after another. Here a pass is this kernel and the loop's pass_tail
// (graph_cond.cu), two launches; a straight-line call is one.
//
// Modes (the wrapper, ops/kernels/coarse_pass.py, names them):
//   SAT0    residuals at the start pose and the configured cutoff: the
//           doubling loop's first carry (cutoff, saturated share, 0, stop);
//   DOUBLE  one cutoff doubling: the saturated share at twice the carried
//           cutoff, the carry taken where the loop still grows;
//   INIT    the linearization at the start pose: the LM's first carry,
//           with the first step already solved;
//   LM      one LM pass: the linearization at the carried candidate, the
//           accept test, the carry's selects, the damping, done, and the
//           next candidate (the step solved, SE3.exp, composed);
//   FINAL   residuals at the accepted pose: (rms, saturated share) and
//           whether enough residuals are visible.
// The LM carry is kState floats (the layout below), its pass count (int32)
// and its done flag; the candidate of the next pass rides in it, so a pass
// evaluates a pose the previous pass (or INIT) solved for, and a pass after
// done is the identity on the carry (the candidate is solved again from
// the same state, to the same bits).
//
// Linearization: one thread per template slot, ceil(slots / 256) blocks
// (at most kMaxBlocks). Each thread computes what _warp, utils.interp.
// bilinear (the coordinate cleaning, per-tap clamps and the non-finite
// rule), the residual, huber_weight, the saturation test, the energy terms
// and calc_gs's eight Jacobian columns compute, operation by operation in
// the plain version's order (a division by a Python constant is torch's
// multiplication by its float reciprocal). Each slot adds 46 float sums
// (36 of H's upper triangle, 8 of b, the energy inside and outside the
// cutoff) and 3 counts (valid, saturated, template mask); masked slots add
// zero as in the plain version (their Jacobian times a zero weight). The
// sums reduce in a fixed order: warp shuffles, the block's warps in
// order, then the last block to finish (a __threadfence and an atomic
// ticket it resets) adds the blocks' partials in block order. No float
// atomics: two launches give the same bits. The order of these sums, and
// of the 3-term products the plain version leaves to cuBLAS, are the only
// departures from it.
//
// The step: the damped, scaled system plus 1e-12 I, 8x8 (6x6 when both
// affine parameters are fixed), solved by one warp with small_solve_warp
// (small_solve.cuh: lu_solve.cu's small_solve arithmetic, the division
// route of 6 and 8 unknowns), then the extrapolation factor, the
// non-finite mask and SE3.exp (utils/lie.py, its small-angle branches)
// composed with the pose.
//
// What bounds it: a slot reads 17 B of template and four [I, gx, gy] taps
// (48 B), 65 B; 8,192 slots are 0.53 MB, 0.16 us at 3.35 TB/s, and about
// 120 float operations a slot (GS), 1 MFLOP, far less. Its time is the
// launch, the slots' dependent chain (the warp and block reductions of 49
// sums) and the tail's serial step (an 8-pivot warp solve and the exp):
// latency, a few microseconds (PERF.md).
#include <cuda_runtime.h>
#include <float.h>

#include "small_solve.cuh"

// the launch's arguments (ops/kernels/coarse_pass._Args mirrors it)
struct CoarseArgs {
  const float* u;  // the template [slots]
  const float* v;
  const float* idepth;
  const float* color;
  const unsigned char* mask;
  const float* img;  // [height, width, 3]: I, gx, gy
  const float* R;    // the pose evaluated: R [3, 3], t [3], affine [2]
  const float* t;
  const float* aff;
  const float* exp_ref;
  const float* exp_new;
  const float* aff_ref;
  const float* cutoff;  // device scalar (not read in SAT0 and DOUBLE)
  const float* f_in;    // the loop's carry in
  const int* i_in;
  const unsigned char* b_in;
  float* f_out;  // the carry (or the results) out
  int* i_out;
  unsigned char* b_out;
  float* partials;  // [kMaxBlocks, kSums] scratch
  unsigned int* ticket;
  int slots, height, width, mode;
  float fx, fy, cx, cy, inv_fx, inv_fy;
  float huber, two_huber, huber_sq, cutoff_th, cutoff_cap;
  float lambda_init, extrap_limit;
  float S[8];
  int fix_a, fix_b;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 64;
constexpr unsigned kFull = 0xffffffffu;

// the sums: the energies in and outside the cutoff, b, H's upper triangle,
// then the counts (stored as int bits)
constexpr int kEgn = 0, kEsat = 1, kSb = 2, kSh = 10;
constexpr int kF = 46;                // float sums
constexpr int kCValid = kF, kCSat = kF + 1, kCTpl = kF + 2;
constexpr int kSums = kF + 3;

// the LM carry's floats
enum {
  S_R = 0, S_T = 9, S_AFF = 12, S_H = 14, S_B = 78, S_E = 86, S_N = 87,
  S_LAM = 88, S_CR = 89, S_CT = 98, S_CAFF = 101, S_CNORM = 103,
  kState = 104
};

enum { SAT0 = 0, DOUBLE = 1, INIT = 2, LM = 3, FINAL = 4 };

// torch.clamp(torch.nan_to_num(x, nan=-4.0), -4.0, hi + 4.0)
__device__ __forceinline__ float clean_coord(float x, float hi4) {
  if (x != x) x = -4.0f;
  else if (isinf(x)) x = x > 0.0f ? FLT_MAX : -FLT_MAX;
  return fminf(fmaxf(x, -4.0f), hi4);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// one slot's terms at the evaluated pose: f[kEgn..] and the counts
template <bool GS>
__device__ __forceinline__ void slot_terms(const CoarseArgs& a, int i,
                                           const float (&R)[9],
                                           const float (&t)[3], float a_rel,
                                           float b_rel, float b0_ref,
                                           float cutoff, float max_energy,
                                           float (&f)[kF], int (&c)[3]) {
  const float u = a.u[i], v = a.v[i], id = a.idepth[i], col = a.color[i];
  const bool m = a.mask[i] != 0;
  // _warp: Ki_p @ R.T + t * idepth
  const float kx = (u - a.cx) * a.inv_fx;
  const float ky = (v - a.cy) * a.inv_fy;
  float p[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    p[r] = (kx * R[3 * r] + ky * R[3 * r + 1] + R[3 * r + 2]) + t[r] * id;
  const float un = p[0] / p[2], vn = p[1] / p[2];
  const float Ku = a.fx * un + a.cx, Kv = a.fy * vn + a.cy;
  const float nid = id / p[2];
  const float W = (float)a.width, H = (float)a.height;
  bool valid = m && Ku > 2.0f && Kv > 2.0f && Ku < W - 3.0f &&
               Kv < H - 3.0f && nid > 0.0f;
  // bilinear_3 on [I, gx, gy]
  float hit[3];
  {
    const float xc = clean_coord(Ku, W + 4.0f);
    const float yc = clean_coord(Kv, H + 4.0f);
    const float x0 = floorf(xc), y0 = floorf(yc);
    const float dx = xc - x0, dy = yc - y0;
    const int ix0 = (int)x0, iy0 = (int)y0;
    const int xa = clampi(ix0, 0, a.width - 1);
    const int xb = clampi(ix0 + 1, 0, a.width - 1);
    const int ya = clampi(iy0, 0, a.height - 1);
    const int yb = clampi(iy0 + 1, 0, a.height - 1);
    const float* p00 = a.img + 3 * ((long long)ya * a.width + xa);
    const float* p01 = a.img + 3 * ((long long)ya * a.width + xb);
    const float* p10 = a.img + 3 * ((long long)yb * a.width + xa);
    const float* p11 = a.img + 3 * ((long long)yb * a.width + xb);
    const bool bad = !(isfinite(Ku) && isfinite(Kv));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float row0 = p00[ch] * (1.0f - dx) + p01[ch] * dx;
      const float row1 = p10[ch] * (1.0f - dx) + p11[ch] * dx;
      const float val = row0 * (1.0f - dy) + row1 * dy;
      hit[ch] = bad ? __int_as_float(0x7fc00000) : val;
    }
  }
  const float res = hit[0] - (a_rel * col + b_rel);
  valid = valid && isfinite(hit[0]);
  const float ar = fabsf(res);
  const float hw = ar < a.huber
                       ? 1.0f
                       : a.huber / (ar < 1e-12f ? 1e-12f : ar);
  const bool sat = ar > cutoff;
  const bool in_gn = valid && !sat;
  f[kEgn] = in_gn ? hw * res * res * (2.0f - hw) : 0.0f;
  f[kEsat] = (valid && sat) ? max_energy : 0.0f;
  c[0] = valid;
  c[1] = valid && sat;
  c[2] = m;
  if (GS) {
    const float dxg = hit[1] * a.fx, dyg = hit[2] * a.fy;
    float J[8];
    J[0] = nid * dxg;
    J[1] = nid * dyg;
    J[2] = -nid * (un * dxg + vn * dyg);
    J[3] = -(un * vn * dxg + (1.0f + vn * vn) * dyg);
    J[4] = (1.0f + un * un) * dxg + un * vn * dyg;
    J[5] = un * dyg - vn * dxg;
    J[6] = a_rel * (b0_ref - col);
    J[7] = -1.0f;
    const float w = in_gn ? hw : 0.0f;
    int k = kSh;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float jw = J[r] * w;
      f[kSb + r] = jw * res;
#pragma unroll
      for (int q = r; q < 8; ++q) f[k++] = jw * J[q];
    }
  }
}

// SE3.exp(inc[:6]).compose((R, t)) as utils/lie.py computes it
__device__ void exp_compose(const float* inc, const float* R, const float* t,
                            float* Rn, float* tn) {
  const float w0 = inc[3], w1 = inc[4], w2 = inc[5];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float s = sinf(theta), co = cosf(theta);
  const float A = small ? 1.0f - theta2 * (1.0f / 6.0f) : s / theta;
  const float B = small ? 0.5f - theta2 * (1.0f / 24.0f)
                        : (1.0f - co) / (theta2 + 1e-16f);
  const float C = small ? (float)(1.0 / 6.0) - theta2 * (1.0f / 120.0f)
                        : (theta - s) / (theta2 * theta + 1e-16f);
  const float Wm[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float WW[9], Re[9], V[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      WW[3 * r + q] = Wm[3 * r] * Wm[q] + Wm[3 * r + 1] * Wm[3 + q] +
                      Wm[3 * r + 2] * Wm[6 + q];
      const float I = r == q ? 1.0f : 0.0f;
      Re[3 * r + q] = I + A * Wm[3 * r + q] + B * WW[3 * r + q];
      V[3 * r + q] = I + B * Wm[3 * r + q] + C * WW[3 * r + q];
    }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float te = V[3 * r] * inc[0] + V[3 * r + 1] * inc[1] +
                     V[3 * r + 2] * inc[2];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      Rn[3 * r + q] = Re[3 * r] * R[q] + Re[3 * r + 1] * R[3 + q] +
                      Re[3 * r + 2] * R[6 + q];
    tn[r] = (Re[3 * r] * t[0] + Re[3 * r + 1] * t[1] + Re[3 * r + 2] * t[2]) +
            te;
  }
}

// the next candidate from the state st (shared), by warp 0: the LM step
// (track_level_plain's solve_inc, extrapolation and non-finite mask),
// SE3.exp composed with the pose, the affine added, and the step's norm
template <int N>
__device__ __forceinline__ void solve_step(const CoarseArgs& a, float* st,
                                           float* inc) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < N;
  const float lam = st[S_LAM];
  float r[N + 1];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float h = 0.0f;
    if (live) {
      const float hl = st[S_H + 8 * lane + j] +
                       lam * (lane == j ? st[S_H + 9 * lane] : 0.0f);
      h = hl * a.S[j] * a.S[lane] + 1e-12f * (lane == j ? 1.0f : 0.0f);
    }
    r[j] = h;
  }
  r[N] = live ? -(st[S_B + lane] * a.S[lane]) : 0.0f;
  int row;
  const float y = small_solve_warp<float, N, true>(r, N, live, 0, row);
  if (live) inc[row] = y;
}

__device__ void step(const CoarseArgs& a, float* st, float* inc) {
  const int lane = threadIdx.x & 31;
  if (a.fix_a && a.fix_b)
    solve_step<6>(a, st, inc);
  else
    solve_step<8>(a, st, inc);
  __syncwarp();
  if (lane == 0) {
    const float lam = st[S_LAM];
    float d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = inc[k];
    // a fixed parameter's step is 0 (the 6x6 solve leaves both unset)
    if (a.fix_a) d[6] = 0.0f;
    if (a.fix_b) d[7] = 0.0f;
    const float extrap =
        lam < a.extrap_limit ? sqrtf(sqrtf(a.extrap_limit / lam)) : 1.0f;
    float nrm = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float x = d[k] * a.S[k] * extrap;
      if (!isfinite(x)) x = 0.0f;
      d[k] = x;
      nrm = nrm + x * x;
    }
    exp_compose(d, st + S_R, st + S_T, st + S_CR, st + S_CT);
    st[S_CAFF] = st[S_AFF] + d[6];
    st[S_CAFF + 1] = st[S_AFF + 1] + d[7];
    st[S_CNORM] = sqrtf(nrm);
  }
  __syncwarp();
}

__device__ __forceinline__ float mean_energy(float E, int n, int n_floor) {
  return n >= n_floor ? E / (float)(n < 1 ? 1 : n)
                      : __int_as_float(0x7f800000);
}

// the scalar tail, warp 0 of the last block; tot the grid's sums
__device__ void tail(const CoarseArgs& a, const float* tot, float* st,
                     float* inc) {
  const int lane = threadIdx.x & 31;
  const int n_valid = __float_as_int(tot[kCValid]);
  const int n_sat = __float_as_int(tot[kCSat]);
  const int n_tpl = __float_as_int(tot[kCTpl]);
  const float E = tot[kEgn] + tot[kEsat];
  const float sat = (float)n_sat / fmaxf((float)n_valid, 1.0f);
  const int n_floor = (int)fmaxf(0.2f * (float)n_tpl, 10.0f);
  if (a.mode == SAT0 || a.mode == DOUBLE || a.mode == FINAL) {
    if (lane) return;
    if (a.mode == FINAL) {
      a.f_out[0] = sqrtf(a.f_in[S_E] / fmaxf(a.f_in[S_N], 1.0f));
      a.f_out[1] = sat;
      a.b_out[0] = n_valid >= n_floor;
      return;
    }
    float cut = a.cutoff_th, s = sat;
    int n = 0;
    if (a.mode == DOUBLE) {
      const bool grow = !a.b_in[0];
      cut = grow ? a.f_in[0] * 2.0f : a.f_in[0];
      s = grow ? sat : a.f_in[1];
      n = a.i_in[0] + (grow ? 1 : 0);
    }
    a.f_out[0] = cut;
    a.f_out[1] = s;
    a.i_out[0] = n;
    a.b_out[0] = !((s > 0.6f) && (cut < a.cutoff_cap));
    return;
  }
  // INIT and LM: the new state into st (the carry's copy and the new
  // system spread over the warp, the decisions on lane 0), then the next
  // candidate
  const bool active = a.mode == INIT || !a.b_in[0];
  bool accept = true;
  if (a.mode == LM) {
    accept = mean_energy(E, n_valid, n_floor) <
             mean_energy(a.f_in[S_E], (int)a.f_in[S_N], n_floor);
    for (int k = lane; k < kState; k += 32) st[k] = a.f_in[k];
  }
  const bool take = active && accept;
  __syncwarp();
  if (lane == 0) {
    if (a.mode == LM) {
      if (take) {
        for (int k = 0; k < 9; ++k) st[S_R + k] = a.f_in[S_CR + k];
        for (int k = 0; k < 3; ++k) st[S_T + k] = a.f_in[S_CT + k];
        for (int k = 0; k < 2; ++k) st[S_AFF + k] = a.f_in[S_CAFF + k];
      }
      const float lam = a.f_in[S_LAM];
      if (active)
        st[S_LAM] = accept ? lam * 0.5f : fmaxf(lam * 4.0f, a.extrap_limit);
      a.i_out[0] = a.i_in[0] + (active ? 1 : 0);
      a.b_out[0] = a.b_in[0] || (a.f_in[S_CNORM] <= 1e-3f);
    } else {
      for (int k = 0; k < 9; ++k) st[S_R + k] = a.R[k];
      for (int k = 0; k < 3; ++k) st[S_T + k] = a.t[k];
      for (int k = 0; k < 2; ++k) st[S_AFF + k] = a.aff[k];
      st[S_LAM] = a.lambda_init;
      a.i_out[0] = 0;
      a.b_out[0] = 0;
    }
    if (take) {
      st[S_E] = E;
      st[S_N] = (float)n_valid;
    }
  }
  if (take) {
    const float ngn = fmaxf((float)(n_valid - n_sat), 1.0f);
    if (lane < 8) st[S_B + lane] = tot[kSb + lane] / ngn;
    int k = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = r; q < 8; ++q, ++k)
        if ((k & 31) == lane) {
          const float h = tot[kSh + k] / ngn;
          st[S_H + 8 * r + q] = h;
          st[S_H + 8 * q + r] = h;
        }
  }
  __syncwarp();
  step(a, st, inc);
  for (int k = lane; k < kState; k += 32) a.f_out[k] = st[k];
}

template <bool GS>
__global__ void __launch_bounds__(kThreads)
    coarse_pass_kernel(const CoarseArgs a) {
  __shared__ float warp_sums[kWarps][kSums];
  __shared__ float tot[kSums];
  __shared__ float grid_sums[kMaxBlocks * kSums];
  __shared__ float st[kState];
  __shared__ float inc[8];
  __shared__ unsigned int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kThreads + tid;
  constexpr int nf = GS ? kF : 2;  // the float sums this mode adds

  // the evaluated pose, affine and cutoff, the same in every thread
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = a.R[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = a.t[k];
  const float a_rel =
      expf(a.aff[0] - a.aff_ref[0]) * (a.exp_new[0] / a.exp_ref[0]);
  const float b_rel = a.aff[1] - a_rel * a.aff_ref[1];
  const float cutoff = a.mode == SAT0     ? a.cutoff_th
                       : a.mode == DOUBLE ? a.f_in[0] * 2.0f
                                          : a.cutoff[0];
  const float max_energy = a.two_huber * cutoff - a.huber_sq;

  float f[kF];
  int c[3] = {0, 0, 0};
#pragma unroll
  for (int k = 0; k < kF; ++k) f[k] = 0.0f;
  if (i < a.slots)
    slot_terms<GS>(a, i, R, t, a_rel, b_rel, a.aff_ref[1], cutoff,
                   max_energy, f, c);

  // warp, then block, in a fixed order; each shuffle round over every sum,
  // so the sums' chains interleave
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < nf; ++k) f[k] += __shfl_down_sync(kFull, f[k], off);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] += __shfl_down_sync(kFull, c[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < nf; ++k) warp_sums[warp][k] = f[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) warp_sums[warp][kF + k] = __int_as_float(c[k]);
  }
  __syncthreads();
  const bool col = tid < nf || (tid >= kF && tid < kSums);
  if (col) {
    float s = warp_sums[0][tid];
    int n = __float_as_int(warp_sums[0][tid]);
    for (int w = 1; w < kWarps; ++w) {
      s += warp_sums[w][tid];
      n += __float_as_int(warp_sums[w][tid]);
    }
    a.partials[blockIdx.x * kSums + tid] = tid < kF ? s : __int_as_float(n);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // every block's partials in flight at once, then each sum in block order
  for (int k = tid; k < (int)gridDim.x * kSums; k += kThreads)
    grid_sums[k] = __ldcg(a.partials + k);
  __syncthreads();
  if (col) {
    float s = grid_sums[tid];
    int n = __float_as_int(s);
    for (unsigned b = 1; b < gridDim.x; ++b) {
      const float x = grid_sums[b * kSums + tid];
      s += x;
      n += __float_as_int(x);
    }
    tot[tid] = tid < kF ? s : __int_as_float(n);
  }
  if (tid == 0) *a.ticket = 0;  // every block has taken its ticket
  __syncthreads();
  if (warp == 0) tail(a, tot, st, inc);
}

}  // namespace

extern "C" int coarse_pass_launch(const CoarseArgs* args, void* stream) {
  const CoarseArgs& a = *args;
  if (a.slots <= 0 || a.slots > kMaxBlocks * kThreads || a.mode < SAT0 ||
      a.mode > FINAL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((a.slots + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.mode == INIT || a.mode == LM)
    coarse_pass_kernel<true><<<blocks, kThreads, 0, st>>>(a);
  else
    coarse_pass_kernel<false><<<blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int coarse_pass_max_slots() { return kMaxBlocks * kThreads; }

extern "C" int coarse_pass_state_floats() { return kState; }

extern "C" int coarse_pass_sums() { return kSums; }

extern "C" const char* coarse_pass_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
