// One pass of the event tracker's LM in one launch (sm_90a): event_pass,
// the pass of ops/event_tracker._lm_solve's WHILE loop (lm_pass: the
// linearization, the damped 12x12 step, the candidate's energy and the LM
// control) with its level's start energy and final residuals as two more
// modes.
//
// The JAX package leaves the pass to XLA, which fuses it on a TPU
// (slam_eds_tpu/ops/event_tracker.py); there is no TPU kernel. The port's
// plain version (ops/event_tracker._lm_solve_plain) is about 790 torch
// launches a pass at 2,048 slots (event_residuals_and_jac's 407 ATen
// operations, event_residuals' 344 at the candidate, bicubic_with_grad's
// 16 gathers and their products in each); captured, each is a node of the
// loop's WHILE body, run one after another. Here a pass is this kernel and
// the loop's pass_tail (graph_cond.cu), two launches.
//
// Modes (the wrapper, ops/kernels/event_pass.py, names them):
//   INIT   the energy at the start state: the loop's first carry
//          (state, lambda 1e-4, energy; pass count 0; not done);
//   LM     one pass of that carry: at the carried state the model norm's
//          sums (m.m and m^T A over all slots), then the residuals and
//          the 12-column Jacobian (event_residuals_and_jac), H's 78
//          upper-triangle sums and g's 12, the damped system H + lam
//          diag(H) + 1e-10 I solved, the non-finite rule, _apply_local
//          (translation added, quaternion exp, product and normalize,
//          velocity renormalized), then the candidate's energy
//          (event_residuals: the model norm at the new velocity, bicubic
//          at the new pose), accept, lambda (halved or x4, clamped to
//          [1e-7, 1e5]), the relative tolerance, done and the pass count.
//          A pass whose carry is done returns it as it was given;
//   FINAL  the residuals [slots] at the carry's state (the MAD stays in
//          torch).
// The robust weight (Huber, Cauchy or none) and the normalized-event (NC)
// cost are template flags.
//
// Threads: one cluster of 8 blocks of 256 threads, a slot a thread at the
// configuration's 2,048 slots (more slots: each thread strides over them
// by 2,048). A pass has four dependent reductions (the model norm's 7
// sums, 14 with NC's event norm; H, g's 90; the candidate's model norm,
// with NC's event norm; its energy); each reduces in a fixed order: warp
// shuffles, the block's warps in order, a cluster barrier, then every
// block adds the 8 blocks' partials in rank order through distributed
// shared memory, so every block holds the same totals, solves the same
// system in its warp 0 (small_solve_warp, small_solve.cuh: lu_solve.cu's
// arithmetic, the reciprocal route torch takes at 12 unknowns) and steps
// to the same candidate without another launch or a grid-wide sync. Block
// 0 writes the carry. No float atomics: two launches give the same bits.
// Each slot's arithmetic follows the plain version's torch operations in
// their order (a division by a Python constant is torch's multiplication by
// its float reciprocal; the bicubic's coordinate cleaning, per-tap clamps
// and non-finite rule are utils/interp.bicubic_with_grad's; the
// projection's and the pose block's 3-term products and m = A v as the
// card's library forms them, measured); the sums' order and the 6-term
// products of Jv (I - v v^T), whose order no simple candidate matched, are
// the departures from it.
//
// What bounds it: a slot reads 25 B (coordinates, gradient, inverse depth,
// weight, mask) and 2 x 16 bicubic taps of 4 B, about 150 B; 2,048 slots
// are 0.31 MB, 0.09 us at 3.35 TB/s, and about 700 float operations a slot
// with the Jacobian and H, 1.4 MFLOP, less still. Its time is latency: the
// launch, the four reductions' barriers, the 90 sums' shuffles and the
// serial step (a 12-pivot warp solve and the exp): 21.3 us a pass at 2,048
// slots on an H100, against 1.05 ms for the plain pass (PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>

#include "small_solve.cuh"

namespace cg = cooperative_groups;

// the launch's arguments (ops/kernels/event_pass._Args mirrors it)
struct EventArgs {
  const float* nc;             // [slots, 2] normalized keyframe coordinates
  const float* grad;           // [slots, 2] the keyframe's gradients
  const float* idp;            // [slots] inverse depths
  const float* weights;        // [slots]
  const unsigned char* mask;   // [slots] bool
  const float* frame;          // [height, width] the level's event frame
  const float* loss_scale;     // device scalar
  const float* px;             // INIT: the start state
  const float* qx;
  const float* vx;
  const float* f_in;           // LM, FINAL: the loop's carry in
  const int* i_in;
  const unsigned char* b_in;
  float* f_out;                // INIT, LM: the carry out; FINAL: residuals
  int* i_out;
  unsigned char* b_out;
  float* sys_out;              // LM, optional: H's upper triangle, g, the
                               // candidate's energy and the step
  int slots, height, width, mode;
  float fx, fy, cx, cy, tol;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kStride = kThreads * kCluster;
constexpr int kMaxSlots = 32 * kStride;
constexpr unsigned kFull = 0xffffffffu;

// the carry's floats: px, qx [w, x, y, z], vx, lambda, energy
enum { S_PX = 0, S_QX = 3, S_VX = 7, S_LAM = 13, S_E = 14, kState = 15 };
enum { INIT = 0, LM = 1, FINAL = 2 };
enum { HUBER = 0, CAUCHY = 1, NONE = 2 };

// the sums of each reduction: the model norm's (m.m, m^T A; NC: e.e, e^T D),
// H's upper triangle and g, the candidate's norms, its energy
constexpr int kSumsA = 14;
constexpr int kH = 78;
constexpr int kSumsB = kH + 12;

// torch.clamp(torch.nan_to_num(x, nan=-4.0), -4.0, hi + 4.0)
__device__ __forceinline__ float clean_coord(float x, float hi4) {
  if (x != x) x = -4.0f;
  else if (isinf(x)) x = x > 0.0f ? FLT_MAX : -FLT_MAX;
  return fminf(fmaxf(x, -4.0f), hi4);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// the Keys (Catmull-Rom) weights of the taps at offsets -1, 0, 1, 2 and
// their derivatives (utils/interp._cubic_weights, _cubic_weights_d)
__device__ __forceinline__ void keys(float s, float (&w)[4], float (&d)[4]) {
  const float s2 = s * s, s3 = s2 * s;
  w[0] = ((-0.5f * s3) + s2) - 0.5f * s;
  w[1] = ((1.5f * s3) - 2.5f * s2) + 1.0f;
  w[2] = ((-1.5f * s3) + 2.0f * s2) + 0.5f * s;
  w[3] = 0.5f * s3 - 0.5f * s2;
  d[0] = ((-1.5f * s2) + 2.0f * s) - 0.5f;
  d[1] = 4.5f * s2 - 5.0f * s;
  d[2] = ((-4.5f * s2) + 4.0f * s) + 0.5f;
  d[3] = 1.5f * s2 - s;
}

// utils/interp.bicubic_with_grad at (x, y): the value and, with GRAD, its
// analytic gradient; NaN in all three where a coordinate is not finite
template <bool GRAD>
__device__ __forceinline__ void bicubic(const float* __restrict__ img, int H,
                                        int W, float x, float y, float& f,
                                        float& fdx, float& fdy) {
  const float xc = clean_coord(x, (float)W + 4.0f);
  const float yc = clean_coord(y, (float)H + 4.0f);
  const float x0 = floorf(xc), y0 = floorf(yc);
  float wx[4], dwx[4], wy[4], dwy[4];
  keys(xc - x0, wx, dwx);
  keys(yc - y0, wy, dwy);
  const int ix = (int)x0 - 1, iy = (int)y0 - 1;
  int cols[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) cols[c] = clampi(ix + c, 0, W - 1);
  float p[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* row = img + (long long)clampi(iy + r, 0, H - 1) * W;
#pragma unroll
    for (int c = 0; c < 4; ++c) p[r][c] = __ldg(row + cols[c]);
  }
  // Python's sum(): from 0, term by term
  float v = 0.0f, vx = 0.0f, vy = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float rv = 0.0f, rdx = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      rv = rv + wx[c] * p[r][c];
      if (GRAD) rdx = rdx + dwx[c] * p[r][c];
    }
    v = v + wy[r] * rv;
    if (GRAD) {
      vx = vx + wy[r] * rdx;
      vy = vy + dwy[r] * rv;
    }
  }
  const bool bad = !(isfinite(x) && isfinite(y));
  const float nan = __int_as_float(0x7fc00000);
  f = bad ? nan : v;
  fdx = bad ? nan : vx;
  fdy = bad ? nan : vy;
}

// one keyframe point
struct Slot {
  float x, y, g0, g1, id, w;
  bool m;
};

__device__ __forceinline__ Slot load_slot(const EventArgs& a, int i) {
  Slot s;
  s.x = a.nc[2 * i];
  s.y = a.nc[2 * i + 1];
  s.g0 = a.grad[2 * i];
  s.g1 = a.grad[2 * i + 1];
  s.id = a.idp[i];
  s.w = a.weights[i];
  s.m = a.mask[i] != 0;
  return s;
}

// event_residuals' model: -(g . flow) with compute_flow's interaction
// matrix at the velocity v, 0 on masked slots
__device__ __forceinline__ float model_of(const Slot& s, const float* v) {
  const float x = s.x, y = s.y, id = s.id;
  const float fx = ((((-id) * v[0] + (x * id) * v[2]) + (x * y) * v[3]) -
                    (1.0f + x * x) * v[4]) + y * v[5];
  const float fy = ((((-id) * v[1] + (y * id) * v[2]) +
                     (1.0f + y * y) * v[3]) - (x * y) * v[4]) - x * v[5];
  return s.m ? -(s.g0 * fx + s.g1 * fy) : 0.0f;
}

// event_residuals_and_jac's A = -(L^T g) * mask and m = A v, the latter as
// the card's matrix-vector product forms it: a multiply-add chain over
// each half of the six terms, the halves added (measured bitwise on an
// H100, torch 2.11 / CUDA 12.8)
__device__ __forceinline__ float model_rows(const Slot& s, const float* v,
                                            float (&A)[6]) {
  const float x = s.x, y = s.y, id = s.id;
  const float maskf = s.m ? 1.0f : 0.0f;
  const float Lx[6] = {-id, 0.0f, x * id, x * y, -(1.0f + x * x), y};
  const float Ly[6] = {0.0f, -id, y * id, 1.0f + y * y, (-x) * y, -x};
#pragma unroll
  for (int k = 0; k < 6; ++k)
    A[k] = (-(Lx[k] * s.g0 + Ly[k] * s.g1)) * maskf;
  return fmaf(A[2], v[2], fmaf(A[1], v[1], A[0] * v[0])) +
         fmaf(A[5], v[5], fmaf(A[4], v[4], A[3] * v[3]));
}

// _project: R X + t with X the point at depth 1 / (idp + 1e-5); the
// product X R^T as the card's matmul forms it, a multiply-add chain over
// the three terms (measured bitwise on an H100, torch 2.11 / CUDA 12.8)
__device__ __forceinline__ void project(const Slot& s, const float* R,
                                        const float* t, float (&RX)[3],
                                        float (&p)[3]) {
  const float z = 1.0f / (s.id + 1e-5f);
  const float X[3] = {s.x * z, s.y * z, z};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    RX[r] = fmaf(X[2], R[3 * r + 2],
                 fmaf(X[1], R[3 * r + 1], X[0] * R[3 * r]));
    p[r] = RX[r] + t[r];
  }
}

// the pose block at the pose (R, t): the sampled event frame ev and
// D = [gE, -(gE^T hat(RX))] * mask (event_residuals_and_jac)
__device__ __forceinline__ float pose_rows(const EventArgs& a, const Slot& s,
                                           const float* R, const float* t,
                                           float (&D)[6]) {
  float RX[3], p[3];
  project(s, R, t, RX, p);
  const float inv_z = 1.0f / p[2];
  const float xp = a.fx * (p[0] * inv_z) + a.cx;
  const float yp = a.fy * (p[1] * inv_z) + a.cy;
  float ev, dx, dy;
  bicubic<true>(a.frame, a.height, a.width, xp, yp, ev, dx, dy);
  const float du0 = a.fx * inv_z, du2 = (((-a.fx) * p[0]) * inv_z) * inv_z;
  const float dv1 = a.fy * inv_z, dv2 = (((-a.fy) * p[1]) * inv_z) * inv_z;
  const float gE[3] = {dx * du0 + dy * 0.0f, dx * 0.0f + dy * dv1,
                       dx * du2 + dy * dv2};
  // hat(RX) = [[0, -c, b], [c, 0, -a], [-b, a, 0]]; gE^T hat(RX) as the
  // card's batched product forms each column (measured bitwise: a
  // multiply-add chain for the second, products then sums for the others)
  const float hx = RX[0], hy = RX[1], hz = RX[2];
  const float rot[3] = {(gE[0] * 0.0f + gE[1] * hz) + gE[2] * (-hy),
                        fmaf(gE[2], hx, fmaf(gE[1], 0.0f, gE[0] * (-hz))),
                        (gE[0] * hy + gE[1] * (-hx)) + gE[2] * 0.0f};
  const float maskf = s.m ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    D[k] = gE[k] * maskf;
    D[3 + k] = (-rot[k]) * maskf;
  }
  return ev;
}

// event_residuals' sampled event frame at the pose (R, t)
__device__ __forceinline__ float event_at(const EventArgs& a, const Slot& s,
                                          const float* R, const float* t) {
  float RX[3], p[3];
  project(s, R, t, RX, p);
  const float xp = a.fx * (p[0] / p[2]) + a.cx;
  const float yp = a.fy * (p[1] / p[2]) + a.cy;
  float ev, dx, dy;
  bicubic<false>(a.frame, a.height, a.width, xp, yp, ev, dx, dy);
  return ev;
}

template <int LOSS>
__device__ __forceinline__ float robust_weight(float r, float k) {
  if (LOSS == HUBER) {
    const float ar = fabsf(r);
    return ar < k ? 1.0f : k / (ar < 1e-12f ? 1e-12f : ar);
  }
  if (LOSS == CAUCHY) {
    const float q = r / (k < 1e-12f ? 1e-12f : k);
    return 1.0f / (1.0f + q * q);
  }
  return 1.0f;
}

// the sum of each of v's N entries over the cluster's threads, in a fixed
// order (warp shuffles, the block's warps, the blocks in rank order), into
// tot in every block; part is this reduction's own partials buffer
template <int N>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            float (&v)[N],
                                            float (*wp)[kSumsB], float* part,
                                            float* tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_down_sync(kFull, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) wp[warp][k] = v[k];
  __syncthreads();
  if (tid < N) {
    float s = wp[0][tid];
    for (int w = 1; w < kWarps; ++w) s += wp[w][tid];
    part[tid] = s;
  }
  cluster.sync();
  if (tid < N) {
    float s = *cluster.map_shared_rank(part + tid, 0);
    for (unsigned r = 1; r < kCluster; ++r)
      s += *cluster.map_shared_rank(part + tid, r);
    tot[tid] = s;
  }
  __syncthreads();
}

// utils/lie.quat_to_mat
__device__ __forceinline__ void quat_to_mat(const float* q, float* R) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz);
  R[1] = 2.0f * (xy - wz);
  R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz);
  R[4] = 1.0f - 2.0f * (xx + zz);
  R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy);
  R[7] = 2.0f * (yz + wx);
  R[8] = 1.0f - 2.0f * (xx + yy);
}

// _apply_local(st, d) into out (px, qx, vx)
__device__ void apply_local(const float* st, const float* d, float* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[S_PX + k] = st[S_PX + k] + d[k];
  // quat_exp(d[3:6])
  const float w0 = d[3], w1 = d[4], w2 = d[5];
  const float theta2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float half = 0.5f * theta;
  const float k = small ? 0.5f - theta2 * (1.0f / 48.0f) : sinf(half) / theta;
  const float a0 = cosf(half), a1 = k * w0, a2 = k * w1, a3 = k * w2;
  // quat_mul(exp, qx), then quat_normalize
  const float* b = st + S_QX;
  float q[4];
  q[0] = ((a0 * b[0] - a1 * b[1]) - a2 * b[2]) - a3 * b[3];
  q[1] = ((a0 * b[1] + a1 * b[0]) + a2 * b[3]) - a3 * b[2];
  q[2] = ((a0 * b[2] - a1 * b[3]) + a2 * b[0]) + a3 * b[1];
  q[3] = ((a0 * b[3] + a1 * b[2]) - a2 * b[1]) + a3 * b[0];
  const float qn =
      sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]) + 1e-8f;
#pragma unroll
  for (int j = 0; j < 4; ++j) out[S_QX + j] = q[j] / qn;
  float v[6], vn = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    v[j] = st[S_VX + j] + d[6 + j];
    vn = vn + v[j] * v[j];
  }
  vn = sqrtf(vn);
  const float den = vn < 1e-12f ? 1e-12f : vn;
#pragma unroll
  for (int j = 0; j < 6; ++j) out[S_VX + j] = v[j] / den;
}

template <int LOSS, bool NC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    event_pass_kernel(const EventArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int first = (int)rank * kThreads + tid;

  __shared__ float wp[kWarps][kSumsB];
  __shared__ float part_a[kSumsA], part_b[kSumsB], part_c[2], part_d[1];
  __shared__ float tot_a[kSumsA], tot_b[kSumsB], tot_c[2], tot_d[1];
  __shared__ float st[kState];   // the carry's state, lambda and energy
  __shared__ float ev_st[13];    // the state evaluated: px, qx, vx
  __shared__ float R[9];         // and its rotation
  __shared__ float proj[36];     // I - v v^T
  __shared__ float coef[14];     // 1 / norms, m^T A / norm, NC's s / en^2
  __shared__ float delta[12];

  if (a.mode == LM && a.b_in[0]) {  // done: the carry as it was given
    if (rank == 0) {
      if (tid < kState) a.f_out[tid] = a.f_in[tid];
      if (tid == 0) {
        a.i_out[0] = a.i_in[0];
        a.b_out[0] = a.b_in[0];
      }
    }
    return;
  }

  if (tid < kState) {
    float x;
    if (a.mode == INIT)
      x = tid < S_QX ? a.px[tid]
        : tid < S_VX ? a.qx[tid - S_QX]
        : tid < S_LAM ? a.vx[tid - S_VX]
        : tid == S_LAM ? 1e-4f : 0.0f;
    else
      x = a.f_in[tid];
    st[tid] = x;
    if (tid < 13) ev_st[tid] = x;
  }
  __syncthreads();
  const float k_loss = a.loss_scale[0];

  if (a.mode == LM) {
    if (tid == 0) quat_to_mat(st + S_QX, R);
    if (tid < 36) {
      const int j = tid / 6, k = tid % 6;
      proj[tid] = (j == k ? 1.0f : 0.0f) - st[S_VX + j] * st[S_VX + k];
    }
    __syncthreads();
    const float* v = st + S_VX;
    const float* t = st + S_PX;
    // ---- the model norm's sums (and NC's event norm's)
    {
      constexpr int n = NC ? kSumsA : 7;
      float acc[n];
#pragma unroll
      for (int k = 0; k < n; ++k) acc[k] = 0.0f;
      for (int i = first; i < a.slots; i += kStride) {
        const Slot s = load_slot(a, i);
        float A[6];
        const float m = model_rows(s, v, A);
        acc[0] += m * m;
#pragma unroll
        for (int k = 0; k < 6; ++k) acc[1 + k] += m * A[k];
        if constexpr (NC) {
          float D[6];
          const float e = pose_rows(a, s, R, t, D) * (s.m ? 1.0f : 0.0f);
          acc[7] += e * e;
#pragma unroll
          for (int k = 0; k < 6; ++k) acc[8 + k] += e * D[k];
        }
      }
      cluster_sum<n>(cluster, acc, wp, part_a, tot_a);
    }
    if (tid == 0) {
      const float norm = sqrtf(1e-3f + tot_a[0]);
      coef[0] = norm;
#pragma unroll
      for (int k = 0; k < 6; ++k) coef[1 + k] = tot_a[1 + k] / norm;
      if constexpr (NC) {
        const float en = sqrtf(1e-3f + tot_a[7]);
        coef[7] = en;
#pragma unroll
        for (int k = 0; k < 6; ++k) coef[8 + k] = tot_a[8 + k] / (en * en);
      }
    }
    __syncthreads();
    // ---- residuals, Jacobian, H and g
    {
      float acc[kSumsB];
#pragma unroll
      for (int k = 0; k < kSumsB; ++k) acc[k] = 0.0f;
      const float norm = coef[0];
      for (int i = first; i < a.slots; i += kStride) {
        const Slot s = load_slot(a, i);
        const float maskf = s.m ? 1.0f : 0.0f;
        float A[6];
        const float m = model_rows(s, v, A);
        const float mh = m / norm;
        float J0[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) J0[k] = (A[k] - mh * coef[1 + k]) / norm;
        float D[6];
        const float e = pose_rows(a, s, R, t, D);
        float Jp[6], et;
        if constexpr (NC) {
          const float en = coef[7];
          const float eh = (e * maskf) / en;
#pragma unroll
          for (int k = 0; k < 6; ++k) Jp[k] = -(D[k] / en - eh * coef[8 + k]);
          et = eh;
        } else {
#pragma unroll
          for (int k = 0; k < 6; ++k) Jp[k] = -D[k];
          et = e;
        }
        const float w = s.w * maskf;
        float r = w * (mh - et);
        float J[12];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          J[k] = w * Jp[k];
          float jv = 0.0f;
#pragma unroll
          for (int j = 0; j < 6; ++j)
            jv = j ? jv + J0[j] * proj[6 * j + k] : J0[j] * proj[6 * j + k];
          J[6 + k] = w * jv;
        }
        if (!s.m) {
          r = 0.0f;
#pragma unroll
          for (int k = 0; k < 12; ++k) J[k] = 0.0f;
        }
        const float c = robust_weight<LOSS>(r, k_loss) * maskf;
        int h = 0;
#pragma unroll
        for (int p = 0; p < 12; ++p) {
          const float jw = J[p] * c;
          acc[kH + p] += jw * r;
#pragma unroll
          for (int q = p; q < 12; ++q) acc[h++] += jw * J[q];
        }
      }
      cluster_sum<kSumsB>(cluster, acc, wp, part_b, tot_b);
      if (a.sys_out && rank == 0 && tid < kSumsB) a.sys_out[tid] = tot_b[tid];
    }
    // ---- the step: warp 0 of every block solves the same system
    if (warp == 0) {
      const bool live = lane < 12;
      const float lam = st[S_LAM];
      float rr[13];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        float x = 0.0f;
        if (live) {
          const int lo = lane < j ? lane : j, hi = lane < j ? j : lane;
          const float hij = tot_b[lo * (23 - lo) / 2 + hi];
          const float hii = tot_b[lane * (23 - lane) / 2 + lane];
          x = (hij + lam * (lane == j ? hii : 0.0f)) +
              (lane == j ? 1e-10f : 0.0f);
        }
        rr[j] = x;
      }
      rr[12] = live ? tot_b[kH + lane] : 0.0f;
      int row;
      const float y = small_solve_warp<float, 12, true>(rr, 12, live, 1, row);
      if (live) {
        const float d = -y;
        delta[row] = isfinite(d) ? d : 0.0f;
      }
      __syncwarp();
      if (a.sys_out && rank == 0 && live)
        a.sys_out[kSumsB + 1 + lane] = delta[lane];
      if (lane == 0) {
        apply_local(st, delta, ev_st);
        quat_to_mat(ev_st + S_QX, R);
      }
    }
    __syncthreads();
  } else {
    if (tid == 0) quat_to_mat(ev_st + S_QX, R);
    __syncthreads();
  }

  // ---- event_residuals at ev_st (the candidate, or the state for INIT
  // and FINAL): the model norm's sum (and NC's event norm's)
  const float* v = ev_st + S_VX;
  const float* t = ev_st + S_PX;
  {
    constexpr int n = NC ? 2 : 1;
    float acc[n];
#pragma unroll
    for (int k = 0; k < n; ++k) acc[k] = 0.0f;
    for (int i = first; i < a.slots; i += kStride) {
      const Slot s = load_slot(a, i);
      const float m = model_of(s, v);
      acc[0] += m * m;
      if constexpr (NC) {
        const float e = s.m ? event_at(a, s, R, t) : 0.0f;
        acc[1] += e * e;
      }
    }
    cluster_sum<n>(cluster, acc, wp, part_c, tot_c);
  }
  const float mnorm = sqrtf(1e-3f + tot_c[0]);
  const float enorm = NC ? sqrtf(1e-3f + tot_c[1]) : 1.0f;
  float energy[1] = {0.0f};
  for (int i = first; i < a.slots; i += kStride) {
    const Slot s = load_slot(a, i);
    const float m = model_of(s, v);
    float e = event_at(a, s, R, t);
    if (NC) e = (s.m ? e : 0.0f) / enorm;
    float r = s.w * (m / mnorm - e);
    if (!s.m) r = 0.0f;
    if (a.mode == FINAL)
      a.f_out[i] = r;
    else
      energy[0] += (robust_weight<LOSS>(r, k_loss) * r) * r;
  }
  if (a.mode == FINAL) {
    cluster.sync();  // no block leaves while another reads its partials
    return;
  }
  cluster_sum<1>(cluster, energy, wp, part_d, tot_d);

  if (rank == 0 && tid == 0) {
    const float e_new = tot_d[0];
    if (a.sys_out) a.sys_out[kSumsB] = e_new;
    if (a.mode == INIT) {
      for (int k = 0; k < S_E; ++k) a.f_out[k] = st[k];
      a.f_out[S_E] = e_new;
      a.i_out[0] = 0;
      a.b_out[0] = 0;
    } else {
      // lm_pass's control; the carry is active (not done)
      const float energy0 = st[S_E], lam = st[S_LAM];
      const bool accept = e_new < energy0;
      for (int k = 0; k < S_LAM; ++k) a.f_out[k] = accept ? ev_st[k] : st[k];
      const float l = accept ? lam * 0.5f : lam * 4.0f;
      a.f_out[S_LAM] = l < 1e-7f ? 1e-7f : (l > 1e5f ? 1e5f : l);
      const float e_next = accept ? e_new : energy0;
      const float rel =
          fabsf(energy0 - e_next) / (energy0 < 1e-12f ? 1e-12f : energy0);
      a.f_out[S_E] = e_next;
      a.i_out[0] = a.i_in[0] + 1;
      a.b_out[0] = accept && rel < a.tol;
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <int LOSS, bool NC>
void launch(const EventArgs& a, cudaStream_t st) {
  event_pass_kernel<LOSS, NC><<<kCluster, kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" int event_pass_launch(const EventArgs* args, int loss,
                                 int norm_event, void* stream) {
  const EventArgs& a = *args;
  if (a.slots <= 0 || a.slots > kMaxSlots || a.mode < INIT ||
      a.mode > FINAL || loss < HUBER || loss > NONE || a.height <= 0 ||
      a.width <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (loss * 2 + (norm_event ? 1 : 0)) {
    case 0: launch<HUBER, false>(a, st); break;
    case 1: launch<HUBER, true>(a, st); break;
    case 2: launch<CAUCHY, false>(a, st); break;
    case 3: launch<CAUCHY, true>(a, st); break;
    case 4: launch<NONE, false>(a, st); break;
    default: launch<NONE, true>(a, st); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int event_pass_max_slots() { return kMaxSlots; }

extern "C" int event_pass_state_floats() { return kState; }

extern "C" int event_pass_system_floats() { return kSumsB + 13; }

extern "C" const char* event_pass_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
