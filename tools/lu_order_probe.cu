// Candidate rounding orders of a small dense LU factorization with partial
// pivoting (P A = L U), for tools/lu_order_probe.py: which order does
// torch.linalg.lu_factor_ex (cuSOLVER's getrf for one system) round in?
// One thread per system, the system factored in place in global memory
// (row-major, n x n), its 0-based pivots written beside it. Every
// operation is an explicit intrinsic, so nvcc contracts nothing of its
// own. Not on any path of the port; speed is of no concern here.
//
// Variants (the update of element (i, j) by step k is l_ik u_kj; "chain"
// folds each product in with fma(-l, u, a) in k order, "unfused" rounds
// the product first, "sum" adds the products apart, fma(l, u, acc) from
// 0 in k order, and subtracts the sum once; "rcp" scales the column below
// the pivot by the pivot's reciprocal, "div" divides by the pivot):
//    0 right-looking, chain, rcp       1 right-looking, chain, div
//    2 left-looking, sum, rcp          3 left-looking, sum, div
//    4 right-looking, unfused, rcp     5 right-looking, unfused, div
//    6 recursive (LAPACK getrf2, n1 = n/2), trsm chain, gemm sum, rcp
//    7 recursive, trsm sum, gemm sum, rcp
//    8 recursive, trsm chain, gemm sum, div
//    9 left-looking, sum of rounded products, rcp
//   10-13 blocked right-looking, panel 2, 4, 8, 16 (panel chain, trsm
//         chain, trailing gemm sum), rcp
//   14 recursive with n1 = (n + 1) / 2, trsm chain, gemm sum, rcp
// Pivot ties go to the lowest row of the current order, as isamax.
#include <cuda_runtime.h>

namespace {

constexpr int kVariants = 15;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float mul_(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float rcp_(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float div_(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }

enum Update { CHAIN = 0, UNFUSED = 1 };

template <typename T>
__device__ int argmax_col(const T* a, int ld, int r0, int r1, int c) {
  int p = r0;
  T best = abs_(a[r0 * ld + c]);
  for (int i = r0 + 1; i < r1; ++i) {
    T v = abs_(a[i * ld + c]);
    if (v > best) {
      best = v;
      p = i;
    }
  }
  return p;
}

template <typename T>
__device__ void swap_rows(T* a, int ld, int r, int p, int c0, int c1) {
  if (r == p) return;
  for (int j = c0; j < c1; ++j) {
    T t = a[r * ld + j];
    a[r * ld + j] = a[p * ld + j];
    a[p * ld + j] = t;
  }
}

template <typename T>
__device__ void scale_below(T* a, int ld, int k, int r1, bool recip) {
  T p = a[k * ld + k];
  T r = rcp_(p);
  for (int i = k + 1; i < r1; ++i)
    a[i * ld + k] = recip ? mul_(a[i * ld + k], r) : div_(a[i * ld + k], p);
}

template <typename T>
__device__ T update(T a, T l, T u, int how) {
  return how == CHAIN ? fma_(-l, u, a) : sub_(a, mul_(l, u));
}

// right-looking, unblocked (variants 0, 1, 4, 5)
template <typename T>
__device__ void right_looking(T* a, int n, int* piv, int how, bool recip) {
  for (int k = 0; k < n; ++k) {
    int p = argmax_col(a, n, k, n, k);
    piv[k] = p;
    swap_rows(a, n, k, p, 0, n);
    scale_below(a, n, k, n, recip);
    for (int i = k + 1; i < n; ++i)
      for (int j = k + 1; j < n; ++j)
        a[i * n + j] = update(a[i * n + j], a[i * n + k], a[k * n + j], how);
  }
}

// left-looking: each column updated by the sum of its products when its
// turn comes (variants 2, 3, 9)
template <typename T>
__device__ void left_looking(T* a, int n, int* piv, bool fused_sum,
                             bool recip) {
  for (int k = 0; k < n; ++k) {
    for (int i = 0; i < n; ++i) {
      int m = i < k ? i : k;
      if (m == 0) continue;
      T acc = 0;
      for (int t = 0; t < m; ++t)
        acc = fused_sum ? fma_(a[i * n + t], a[t * n + k], acc)
                        : add_(acc, mul_(a[i * n + t], a[t * n + k]));
      a[i * n + k] = sub_(a[i * n + k], acc);
    }
    int p = argmax_col(a, n, k, n, k);
    piv[k] = p;
    swap_rows(a, n, k, p, 0, n);
    scale_below(a, n, k, n, recip);
  }
}

// LAPACK's recursive getrf2 on the m x w panel at (r0, r0) of the n x n
// matrix a; pivots are global row indices (variants 6, 7, 8, 14)
template <typename T>
__device__ void getrf2(T* a, int n, int r0, int m, int w, int* piv,
                      bool trsm_sum, bool recip, bool ceil_split) {
  if (w == 1) {
    int p = argmax_col(a, n, r0, r0 + m, r0);
    piv[r0] = p;
    swap_rows(a, n, r0, p, r0, r0 + 1);
    scale_below(a, n, r0, r0 + m, recip);
    return;
  }
  int mn = m < w ? m : w;
  int n1 = ceil_split ? (mn + 1) / 2 : mn / 2;
  int c1 = r0 + n1, c2 = r0 + w;
  getrf2(a, n, r0, m, n1, piv, trsm_sum, recip, ceil_split);
  for (int k = r0; k < c1; ++k) swap_rows(a, n, k, piv[k], c1, c2);
  // A12 = L11^-1 A12
  for (int j = c1; j < c2; ++j)
    for (int i = r0 + 1; i < c1; ++i) {
      if (trsm_sum) {
        T acc = 0;
        for (int t = r0; t < i; ++t)
          acc = fma_(a[i * n + t], a[t * n + j], acc);
        a[i * n + j] = sub_(a[i * n + j], acc);
      } else {
        for (int t = r0; t < i; ++t)
          a[i * n + j] = fma_(-a[i * n + t], a[t * n + j], a[i * n + j]);
      }
    }
  // A22 -= A21 A12
  for (int i = c1; i < r0 + m; ++i)
    for (int j = c1; j < c2; ++j) {
      T acc = 0;
      for (int t = r0; t < c1; ++t)
        acc = fma_(a[i * n + t], a[t * n + j], acc);
      a[i * n + j] = sub_(a[i * n + j], acc);
    }
  getrf2(a, n, c1, m - n1, w - n1, piv, trsm_sum, recip, ceil_split);
  for (int k = c1; k < r0 + mn; ++k) swap_rows(a, n, k, piv[k], r0, c1);
}

// blocked right-looking with panels of nb columns (variants 10-13)
template <typename T>
__device__ void blocked(T* a, int n, int* piv, int nb) {
  for (int kb = 0; kb < n; kb += nb) {
    int ke = kb + nb < n ? kb + nb : n;
    for (int k = kb; k < ke; ++k) {
      int p = argmax_col(a, n, k, n, k);
      piv[k] = p;
      swap_rows(a, n, k, p, 0, n);
      scale_below(a, n, k, n, true);
      for (int i = k + 1; i < n; ++i)
        for (int j = k + 1; j < ke; ++j)
          a[i * n + j] = fma_(-a[i * n + k], a[k * n + j], a[i * n + j]);
    }
    for (int j = ke; j < n; ++j)
      for (int i = kb + 1; i < ke; ++i)
        for (int t = kb; t < i; ++t)
          a[i * n + j] = fma_(-a[i * n + t], a[t * n + j], a[i * n + j]);
    for (int i = ke; i < n; ++i)
      for (int j = ke; j < n; ++j) {
        T acc = 0;
        for (int t = kb; t < ke; ++t)
          acc = fma_(a[i * n + t], a[t * n + j], acc);
        a[i * n + j] = sub_(a[i * n + j], acc);
      }
  }
}

template <typename T>
__global__ void probe_getrf(T* A, int* ipiv, int n, long long systems,
                            int variant) {
  long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= systems) return;
  T* a = A + s * n * n;
  int* piv = ipiv + s * n;
  switch (variant) {
    case 0: right_looking(a, n, piv, CHAIN, true); break;
    case 1: right_looking(a, n, piv, CHAIN, false); break;
    case 2: left_looking(a, n, piv, true, true); break;
    case 3: left_looking(a, n, piv, true, false); break;
    case 4: right_looking(a, n, piv, UNFUSED, true); break;
    case 5: right_looking(a, n, piv, UNFUSED, false); break;
    case 6: getrf2(a, n, 0, n, n, piv, false, true, false); break;
    case 7: getrf2(a, n, 0, n, n, piv, true, true, false); break;
    case 8: getrf2(a, n, 0, n, n, piv, false, false, false); break;
    case 9: left_looking(a, n, piv, false, true); break;
    case 10: blocked(a, n, piv, 2); break;
    case 11: blocked(a, n, piv, 4); break;
    case 12: blocked(a, n, piv, 8); break;
    case 13: blocked(a, n, piv, 16); break;
    case 14: getrf2(a, n, 0, n, n, piv, false, true, true); break;
  }
}

template <typename T>
int launch(T* A, int* ipiv, int n, long long systems, int variant,
           void* stream) {
  if (systems == 0 || n == 0) return 0;
  if (variant < 0 || variant >= kVariants || n < 0 || n > 64)
    return (int)cudaErrorInvalidValue;
  const int threads = 64;
  unsigned blocks = (unsigned)((systems + threads - 1) / threads);
  probe_getrf<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, ipiv, n, systems, variant);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_variants() { return kVariants; }

extern "C" int probe_getrf_f32(float* A, int* ipiv, int n, long long systems,
                               int variant, void* stream) {
  return launch<float>(A, ipiv, n, systems, variant, stream);
}

extern "C" int probe_getrf_f64(double* A, int* ipiv, int n,
                               long long systems, int variant, void* stream) {
  return launch<double>(A, ipiv, n, systems, variant, stream);
}

extern "C" int probe_set_stack(size_t bytes) {
  return (int)cudaDeviceSetLimit(cudaLimitStackSize, bytes);
}

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
