// Bilinear event rasterization: scatter-add of E weighted events into an
// [H, W] frame (sm_90a).
//
// Replaces the Pallas TPU kernel slam_eds_tpu/ops/pallas/raster.py
// (rasterize_bilinear, kernel body _raster_kernel), which wrote the splat as
// a one-hot [N, H] x [N, W] outer-product matmul per 512-event chunk into a
// VMEM-resident padded frame, because scatters serialize on a TPU. On Hopper
// a scatter is a global atomic, so this kernel computes what that kernel
// computes, not how: one thread per event, for finite (x, y):
//
//   x0 = floor(x), fx = x - x0 (likewise y), and the four taps
//   (x0, y0)   += (1-fx)(1-fy) v      (x0, y0+1) += (1-fx) fy v
//   (x0+1, y0) += fx (1-fy) v         (x0+1, y0+1) += fx fy v
//
// where a tap is added only if 0 <= x < W and 0 <= y < H. The bounds are
// tested on the float floor before any integer cast, so coordinates such as
// +-1e10 or the -1e6 pad are dropped without an out-of-range conversion. An
// event with a non-finite coordinate is dropped.
//
// Determinism: each tap is quantized to a 64-bit fixed-point integer,
// llrint(w * v * 2^32), and added with an integer atomicAdd into an int64
// [H, W] buffer; integer addition is associative, so the frame is bitwise
// the same whatever the order of the atomics. A second kernel writes
// float(acc * 2^-32): the exactly rounded sum of the quantized taps. The
// range holds while E * max|v| < 2^30 (event frames: |v| <= 1, E = 65,536).
//
// What bounds it on the card: at the operating point (E = 65,536, 640x480)
// 262,144 tap atomics land on a 2.4 MB int64 buffer that lives in the 50 MB
// L2, the input is 786 KB and the output 1.2 MB; there is no arithmetic to
// speak of. Atomic throughput in L2 and launch latency bound it. Taps with a
// zero quantized value (integer coordinates, zero-value pad events) issue no
// atomic. Built with --fmad=false, the tap products round as the plain
// version's do.
#include <cuda_runtime.h>

namespace {

constexpr double kScale = 4294967296.0;  // 2^32
constexpr double kInvScale = 1.0 / 4294967296.0;

__device__ __forceinline__ void add_tap(unsigned long long* __restrict__ acc,
                                        float x, float y, int H, int W,
                                        float tap) {
  if (x < 0.0f || x >= (float)W || y < 0.0f || y >= (float)H) return;
  const long long q = llrint((double)tap * kScale);
  if (q == 0) return;
  atomicAdd(acc + (long long)(int)y * W + (int)x, (unsigned long long)q);
}

__global__ void raster_scatter_kernel(const float* __restrict__ xs,
                                      const float* __restrict__ ys,
                                      const float* __restrict__ vals,
                                      long long E, int H, int W,
                                      unsigned long long* __restrict__ acc) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const float x = xs[e];
  const float y = ys[e];
  const float v = vals[e];
  if (!(isfinite(x) && isfinite(y)) || v == 0.0f) return;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  // every tap lies outside: skip before forming x0 + 1 on huge values
  if (x0 < -1.0f || x0 >= (float)W || y0 < -1.0f || y0 >= (float)H) return;
  const float fx = x - x0;
  const float fy = y - y0;
  const float x1 = x0 + 1.0f;
  const float y1 = y0 + 1.0f;
  add_tap(acc, x0, y0, H, W, (1.0f - fx) * (1.0f - fy) * v);
  add_tap(acc, x0, y1, H, W, (1.0f - fx) * fy * v);
  add_tap(acc, x1, y0, H, W, fx * (1.0f - fy) * v);
  add_tap(acc, x1, y1, H, W, fx * fy * v);
}

__global__ void raster_finish_kernel(const unsigned long long* __restrict__ acc,
                                     long long N, float* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  out[n] = (float)((double)(long long)acc[n] * kInvScale);
}

}  // namespace

// acc: [H * W] scratch (zeroed here); out: [H * W] float frame.
extern "C" int rasterize_launch(const float* xs, const float* ys,
                                const float* vals, long long E, int H, int W,
                                unsigned long long* acc, float* out,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long N = (long long)H * W;
  if (N == 0) return 0;
  cudaError_t err = cudaMemsetAsync(acc, 0, N * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  if (E > 0) {
    const long long blocks = (E + threads - 1) / threads;
    raster_scatter_kernel<<<(unsigned)blocks, threads, 0, s>>>(xs, ys, vals, E,
                                                               H, W, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  raster_finish_kernel<<<(unsigned)((N + threads - 1) / threads), threads, 0,
                         s>>>(acc, N, out);
  return (int)cudaGetLastError();
}

extern "C" const char* rasterize_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
