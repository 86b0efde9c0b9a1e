// The small solve of slam_eds_tpu_torch/csrc/lu_solve.cu at the generic
// width that would take n if the kernel had no exact-size instance at n
// (8 for n <= 8, 16 for n <= 16), for tools/lu_order_probe.py to time
// against the exact-size instances that ship (n = 6, 7, 8, 12). Same body,
// its loops unrolled over the width and each step predicated on the runtime
// n: the same arithmetic in the same order, so the two give the same bits.
#include "../slam_eds_tpu_torch/csrc/lu_solve.cu"

namespace {

template <typename T>
int generic(const T* A, const T* b, T* x, int n, long long systems,
            int recip, void* stream) {
  if (systems <= 0 || n < 1 || n > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 8)
    small_solve_launch<T, 8, false>(A, b, x, n, systems, recip, st);
  else
    small_solve_launch<T, 16, false>(A, b, x, n, systems, recip, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int generic_small_solve_f32(const float* A, const float* b,
                                       float* x, int n, long long systems,
                                       int recip, void* stream) {
  return generic<float>(A, b, x, n, systems, recip, stream);
}

extern "C" int generic_small_solve_f64(const double* A, const double* b,
                                       double* x, int n, long long systems,
                                       int recip, void* stream) {
  return generic<double>(A, b, x, n, systems, recip, stream);
}
