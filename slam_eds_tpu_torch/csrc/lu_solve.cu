// The substitution half of a small dense LU solve, A x = b from
// P A = L U: the row interchanges, forward substitution with the unit
// lower factor, back substitution with the upper one (sm_90a). One thread
// per system; float32 or float64.
//
// The port's LM and GN loops solve a small system on every pass (the event
// LM's 12x12, the coarse LM's 8x8 or 6x6, the window BA's 7x7 gauge
// projector). The JAX package leaves them to XLA (jnp.linalg.solve at
// slam_eds_tpu/ops/event_tracker.py:273, ops/coarse_tracker.py:329 and
// :333, ops/energy.py:522; cho_solve at :439); there is no TPU kernel. When
// captured, each pass is the body of a conditional node of a CUDA graph
// (graphs.py), and torch.linalg.solve_ex cannot be held there for a single
// system of 9 to 32 unknowns: its solve is cuBLAS's batched getrs, whose
// info is a host pointer, and a conditional body holds no copy to the host.
// The factorization (torch.linalg.lu_factor_ex: cuSOLVER's getrf, or
// cuBLAS's batched getrf for several systems) is held, so the port factors
// with torch and substitutes here (utils/linalg.py).
//
// Per system, with ipiv the factorization's 1-based LAPACK pivots:
//   for i = 0 .. n-1: swap y_i, y_{ipiv_i - 1}
//   for i = 0 .. n-1: for j = 0 .. i-1: y_i = fma(-L_ij, y_j, y_i)
//   for i = n-1 .. 0: for j = n-1 .. i+1: y_i = fma(-U_ij, y_j, y_i);
//                     y_i = y_i * (1 / U_ii) (recip) or y_i / U_ii
// Every operation rounds once, in this order: the order of torch's own
// solve on an H100 with torch 2.11 and CUDA 12.8, measured
// (chip_smoke.py, phase "conditional"): the reciprocal where torch takes
// cuBLAS's batched getrs (9 to 32 unknowns, at most 2 systems), the
// division where it takes two triangular solves (up to 8 unknowns, or 3
// systems and more up to 17). So the solve is bitwise torch.linalg.solve_ex
// at the path's sizes, and a captured loop bitwise its eager run.
//
// What bounds it: n^2 + 2n values in, n out (1 KB at n = 12): far below a
// microsecond of memory time at 3.35 TB/s; n^2 FMAs in one dependent chain
// per system, so its time is latency, a few microseconds. A singular system
// gives non-finite entries, as an LU solve does; nothing is checked.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 32;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float recip_mul(float y, float u) {
  return __fmul_rn(y, __frcp_rn(u));
}
__device__ __forceinline__ double recip_mul(double y, double u) {
  return __dmul_rn(y, __drcp_rn(u));
}
__device__ __forceinline__ float div_(float y, float u) {
  return __fdiv_rn(y, u);
}
__device__ __forceinline__ double div_(double y, double u) {
  return __ddiv_rn(y, u);
}

template <typename T, bool RECIP>
__global__ void lu_substitute(const T* __restrict__ LU,
                              const int* __restrict__ ipiv,
                              const T* __restrict__ b, T* __restrict__ x,
                              int n, long long systems) {
  long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= systems) return;
  const T* A = LU + s * n * n;  // row-major, as torch stores the factors
  const int* p = ipiv + s * n;
  T y[kMaxN];
  for (int i = 0; i < n; ++i) y[i] = b[s * n + i];
  for (int i = 0; i < n; ++i) {
    int j = p[i] - 1;
    T t = y[i];
    y[i] = y[j];
    y[j] = t;
  }
  for (int i = 0; i < n; ++i) {
    T acc = y[i];
    for (int j = 0; j < i; ++j) acc = fma_(-A[i * n + j], y[j], acc);
    y[i] = acc;
  }
  for (int i = n - 1; i >= 0; --i) {
    T acc = y[i];
    for (int j = n - 1; j > i; --j) acc = fma_(-A[i * n + j], y[j], acc);
    y[i] = RECIP ? recip_mul(acc, A[i * n + i]) : div_(acc, A[i * n + i]);
  }
  for (int i = 0; i < n; ++i) x[s * n + i] = y[i];
}

template <typename T>
int launch(const T* LU, const int* ipiv, const T* b, T* x, int n,
           long long systems, int recip, void* stream) {
  if (systems == 0 || n == 0) return 0;
  if (n < 0 || n > kMaxN || systems < 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  unsigned blocks = (unsigned)((systems + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (recip)
    lu_substitute<T, true><<<blocks, threads, 0, st>>>(LU, ipiv, b, x, n,
                                                       systems);
  else
    lu_substitute<T, false><<<blocks, threads, 0, st>>>(LU, ipiv, b, x, n,
                                                        systems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lu_solve_f32(const float* LU, const int* ipiv, const float* b,
                            float* x, int n, long long systems, int recip,
                            void* stream) {
  return launch<float>(LU, ipiv, b, x, n, systems, recip, stream);
}

extern "C" int lu_solve_f64(const double* LU, const int* ipiv,
                            const double* b, double* x, int n,
                            long long systems, int recip, void* stream) {
  return launch<double>(LU, ipiv, b, x, n, systems, recip, stream);
}

extern "C" const char* lu_solve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
