// The loops' small dense solves, A x = b by LU with partial pivoting
// (sm_90a), float32 or float64, 1 to 32 unknowns: small_solve, the whole
// solve of each system in one warp, every system of a call in one launch
// (the one route of utils/linalg.py up to 32 unknowns: one system, a
// leading batch axis, or the lanes of torch.vmap, gathered by the
// operator's vmap rule in ops/kernels/lu_solve.py).
//
// The port's LM and GN loops solve a small system on every pass (the event
// LM's 12x12, the coarse LM's 8x8 or 6x6, the window BA's 7x7 gauge
// projector). The JAX package leaves them to XLA (jnp.linalg.solve at
// slam_eds_tpu/ops/event_tracker.py:273, ops/coarse_tracker.py:329 and
// :333, ops/energy.py:522; cho_solve at :439), batched by jax.vmap; there
// is no TPU kernel. When captured, each pass is the body of a conditional
// node of a CUDA graph (graphs.py), which holds no copy to the host, so
// torch.linalg.solve_ex (whose single-system getrs reads its info on the
// host) cannot be used.
//
// Each system rounds as torch.linalg.solve_ex does on that system alone on
// an H100 with torch 2.11 and CUDA 12.8, operation by operation, so the
// loops keep the bits they had before they could skip a pass.
//
// The factorization, the order of cuSOLVER's getrf for one system (its
// getrf_pivot kernel): right-looking and unblocked; at step k the pivot is
// the largest |a_ik| over the rows i >= k of the current order, ties to
// the lowest (isamax); rows k and p swap whole; the column below the pivot
// is scaled by the pivot's reciprocal, l_ik = a_ik * (1 / a_kk) (left as
// it is where the pivot is 0); every trailing element takes a_ij =
// fma(-l_ik, a_kj, a_ij), k by k. tools/lu_order_probe.py compared this
// order and 14 others (division, unfused or summed updates, left-looking,
// LAPACK's recursive getrf2, blocked panels of 2 to 16) with lu_factor_ex
// on 10,000 seeded systems at every n of 1..32, in float32 and float64, as
// the loops build them (J^T J + lam diag + 1e-10 I) and general (N(0, 1) +
// 0.05 I): this order alone agrees in every factor and pivot, at every n
// (0 of 1,280,000 systems differ); every other differs in 10% to 100% of
// the systems at every n where it is not this order (above 1; above the
// panel width for the blocked forms). The probe also runs small_solve
// itself on the same systems: its x is bitwise torch.linalg.solve_ex's on
// each system alone on all 1,280,000.
//
// The substitution, with ipiv the factorization's 1-based LAPACK pivots:
//   for i = 0 .. n-1: swap y_i, y_{ipiv_i - 1}
//   for i = 0 .. n-1: for j = 0 .. i-1: y_i = fma(-L_ij, y_j, y_i)
//   for i = n-1 .. 0: for j = n-1 .. i+1: y_i = fma(-U_ij, y_j, y_i);
//                     y_i = y_i * (1 / U_ii) (recip) or y_i / U_ii
// the order of torch's own solve of one system after the factorization,
// measured (chip_smoke.py, phase "conditional"): the reciprocal where
// torch takes cuBLAS's batched getrs (9 to 32 unknowns), the division
// where it takes two triangular solves (up to 8 unknowns); the wrapper
// passes the choice (ops/kernels/lu_solve.reciprocal_route).
//
// The design: lane i of the warp holds row i of [A | b] in registers
// (every index a compile-time one: loops unrolled over the instance's
// width N, predicated on the runtime n where the instance is generic). A
// row swap swaps the two lanes' row numbers, not their data. Per pivot
// step: the arg-max over the lanes in five __shfl_xor_sync rounds, a
// ballot to find the pivot's lane, one shuffle per column of the pivot row
// (the b column included), one scale and the row's updates per lane.
// Carrying b as column n does the forward substitution inside the
// factorization in the order above (row i takes fma(-l_ik, y_k, y_i), k by
// k). Back substitution: a ballot and one shuffle a step. Only x is
// written; factors and pivots never leave the registers. One warp per
// system, up to 4 warps a block, the last block's surplus warps idle; a
// warp reads and writes only its own system, so nothing past the last
// system is touched. Systems are indexed in 64 bits; a call takes at most
// 4 (2^31 - 1) systems, the grid's limit in x.
//
// What bounds it: n^2 + n values in, n out (672 B at n = 12, float32):
// under 0.001 us of memory time at 3.35 TB/s, and 2n^3/3 + 2n^2
// operations, less still. Its time is its dependent chain: n pivot steps
// of five shuffle rounds, a ballot and the pivot row's shuffles, then n
// back-substitution steps of a ballot and a shuffle; about 1-2 us at
// n = 12 by that count, 5.5 us measured with the launch (PERF.md). A
// singular system gives non-finite entries, as an LU solve does; nothing
// is checked.
#include <cuda_runtime.h>

#include "small_solve.cuh"

namespace {

constexpr int kMaxN = 32;
constexpr int kWarpsPerBlock = 4;
constexpr long long kMaxBlocks = 2147483647LL;  // the grid's limit in x

// One system per warp, solved by small_solve_warp (small_solve.cuh). N is
// the instance's register width: the exact size where FIXED (n == N, no
// predicate survives compilation), a bound on n otherwise. No
// __launch_bounds__: with one of 128 threads ptxas spilled 4 and 16 bytes
// of the float64 instances at n = 7 and 12 to local memory; without it no
// instance spills (nvcc -Xptxas -v, CUDA 12.8).
template <typename T, int N, bool FIXED>
__global__ void small_solve_kernel(const T* __restrict__ A,
                                   const T* __restrict__ b, T* __restrict__ x,
                                   int n_arg, long long systems, int recip) {
  const int n = FIXED ? N : n_arg;
  const long long s =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (s >= systems) return;  // the whole warp
  const bool live = lane < n;
  const T* a = A + s * n * n;
  T r[N + 1];  // row `row` of [A | b]: r[j] for column j, r[N] for b
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = (live && j < n) ? a[lane * n + j] : T(0);
  r[N] = live ? b[s * n + lane] : T(0);
  int row;
  const T y = small_solve_warp<T, N, FIXED>(r, n, live, recip, row);
  if (live) x[s * n + row] = y;
}

template <typename T, int N, bool FIXED>
void small_solve_launch(const T* A, const T* b, T* x, int n,
                        long long systems, int recip, cudaStream_t st) {
  const long long warps =
      systems < kWarpsPerBlock ? systems : (long long)kWarpsPerBlock;
  const unsigned blocks =
      (unsigned)((systems + kWarpsPerBlock - 1) / kWarpsPerBlock);
  small_solve_kernel<T, N, FIXED><<<blocks, (unsigned)(32 * warps), 0, st>>>(
      A, b, x, n, systems, recip);
}

// The instances: the loops' sizes exactly (the coarse LM's 6 and 8, the BA
// gauge's 7, the event LM's 12), every other n by the next width of 8, 16
// or 32. The exact ones are about 0.7 to 3 us a launch faster than the
// width that would take their n, the most at n = 12 (an H100, PERF.md;
// tools/lu_order_probe.py times both, the widths at those n built from
// tools/small_solve_instances.cu).
template <typename T>
int small_solve(const T* A, const T* b, T* x, int n, long long systems,
                int recip, void* stream) {
  if (systems == 0 || n == 0) return 0;
  if (n < 0 || n > kMaxN || systems < 0 ||
      systems > kMaxBlocks * kWarpsPerBlock)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 6: small_solve_launch<T, 6, true>(A, b, x, n, systems, recip, st);
      break;
    case 7: small_solve_launch<T, 7, true>(A, b, x, n, systems, recip, st);
      break;
    case 8: small_solve_launch<T, 8, true>(A, b, x, n, systems, recip, st);
      break;
    case 12: small_solve_launch<T, 12, true>(A, b, x, n, systems, recip, st);
      break;
    default:
      if (n <= 8)
        small_solve_launch<T, 8, false>(A, b, x, n, systems, recip, st);
      else if (n <= 16)
        small_solve_launch<T, 16, false>(A, b, x, n, systems, recip, st);
      else
        small_solve_launch<T, 32, false>(A, b, x, n, systems, recip, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int small_solve_f32(const float* A, const float* b, float* x,
                               int n, long long systems, int recip,
                               void* stream) {
  return small_solve<float>(A, b, x, n, systems, recip, stream);
}

extern "C" int small_solve_f64(const double* A, const double* b, double* x,
                               int n, long long systems, int recip,
                               void* stream) {
  return small_solve<double>(A, b, x, n, systems, recip, stream);
}

extern "C" const char* lu_solve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
