// The small solve's warp routine, A x = b by LU with partial pivoting in one
// warp, lane i holding row i of [A | b] in registers: the arithmetic of
// lu_solve.cu's small_solve kernel (its order and why: lu_solve.cu), shared
// with coarse_pass.cu's in-kernel step so that both give the same bits for
// the same system.
#pragma once

#include <cuda_runtime.h>

namespace small_solve_detail {

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float div_(float y, float u) {
  return __fdiv_rn(y, u);
}
__device__ __forceinline__ double div_(double y, double u) {
  return __ddiv_rn(y, u);
}

__device__ __forceinline__ float mul_(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float rcp_(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }
__device__ __forceinline__ float inf_(float) {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double inf_(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

constexpr unsigned kFullMask = 0xffffffffu;

}  // namespace small_solve_detail

// Solves the system whose row `lane` the calling lane holds in r (r[j] for
// column j < n, r[N] for b; zeros where the lane is not `live`, lane >= n).
// N is the register width: the exact size where FIXED (n == N), a bound on
// n otherwise. Every lane of the warp calls it; the predicates on k < n and
// j < n are uniform over the warp. Returns x_row, `row` set to the unknown
// it belongs to (meaningful where live); recip divides by the pivots
// through their reciprocal.
template <typename T, int N, bool FIXED>
__device__ __forceinline__ T small_solve_warp(T (&r)[N + 1], int n_arg,
                                              bool live, int recip,
                                              int& row) {
  using namespace small_solve_detail;
  const int n = FIXED ? N : n_arg;
  row = threadIdx.x & 31;  // the row of the current order this lane holds

#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < n) {
      // the pivot: the largest |a_ik| over the rows i >= k, ties to the
      // lowest row (isamax); a NaN ranks as infinite, so that every lane
      // agrees on the pivot whatever the values
      const bool cand = live && row >= k;
      T best = cand ? abs_(r[k]) : T(-1);
      if (best != best) best = inf_(best);
      int arg = cand ? row : 64;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T ob = __shfl_xor_sync(kFullMask, best, off);
        const int oa = __shfl_xor_sync(kFullMask, arg, off);
        if (ob > best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      const int src = __ffs(__ballot_sync(kFullMask, row == arg)) - 1;
      if (row == k)
        row = arg;
      else if (row == arg)
        row = k;
      const T piv = __shfl_sync(kFullMask, r[k], src);
      const bool below = live && row > k;
      T l = r[k];
      if (below && piv != T(0)) l = mul_(r[k], rcp_(piv));
      if (below) r[k] = l;
#pragma unroll
      for (int j = k + 1; j <= N; ++j) {
        if (j < n || j == N) {  // the trailing columns and b
          const T u = __shfl_sync(kFullMask, r[j], src);
          if (below) r[j] = fma_(-l, u, r[j]);
        }
      }
    }
  }

  // back substitution: r[N] holds y_row after the forward substitution
  T y = r[N];
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    if (j < n) {
      const int src = __ffs(__ballot_sync(kFullMask, row == j)) - 1;
      T yj = y;
      if (row == j) yj = recip ? mul_(y, rcp_(r[j])) : div_(y, r[j]);
      yj = __shfl_sync(kFullMask, yj, src);
      if (row == j) y = yj;
      if (live && row < j) y = fma_(-r[j], yj, y);
    }
  }
  return y;
}
