// Bilinear event rasterization: scatter-add of E weighted events into an
// [H, W] frame held in a thread-block cluster's distributed shared memory
// (sm_90a).
//
// Replaces the Pallas TPU kernel slam_eds_tpu/ops/pallas/raster.py
// (rasterize_bilinear, kernel body _raster_kernel), which kept the whole
// padded frame resident in VMEM for the call and wrote the splat as a
// one-hot [N, H] x [N, W] outer-product matmul per 512-event chunk. The
// Hopper counterpart of a VMEM-resident frame is a cluster's distributed
// shared memory: a cluster of 16 blocks (or the portable 8) on neighbouring
// SMs, each owning a slice of the frame (or of a band of its rows) as 64-bit
// integers, at most 232,448 B each. The kernel computes, for finite (x, y):
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
// One launch, in order: each block zeroes its slice; cluster barrier; every
// thread of the cluster strides over the events and adds each tap, quantized
// to a 64-bit fixed-point integer llrint(w * v * 2^32), to the owner block's
// slice with an integer atomicAdd through cluster.map_shared_rank (no atomic
// for a zero quantized tap); cluster barrier; each block writes its slice as
// float(acc * 2^-32) with 16-byte stores. Integer addition is associative,
// so the frame is bitwise the same whatever the order of the atomics: the
// exactly rounded sum of the quantized taps. The range holds while
// E * max|v| < 2^30 (event frames: |v| <= 1, E = 65,536).
//
// The frame's rows are cut into bands, one cluster per band, as many as the
// card holds clusters at once (and more where a band would not fit a
// cluster's shared memory); every cluster reads every event and keeps the
// taps in its band. The geometry (cluster size, bands, rows per band,
// slice) is computed by the caller (ops/kernels/rasterize.py,
// launch_geometry) from cudaOccupancyMaxActiveClusters at first use.
//
// What bounds it on the card: the bytes it must move are E * 12 B of events
// in and H * W * 4 B of frame out (2.0 MB at the operating point, 0.60 us
// at 3.35 TB/s), but it runs far from that (PERF.md; an H100 at 640x480,
// the largest packet): 5.4 us with 7 bands of 16 blocks of 512 threads, where
// 4.2 us is the cost of the launch itself (64 events), the event loads
// add 0.2 us and the 57,500 remote shared-memory atomics the rest. One
// cluster alone took 12-15 us: its atomics go through 16 SMs. The earlier
// three-pass form (memset, global atomics, convert) took 5.2 us. There is no
// scratch in device memory and no second pass. Built with --fmad=false, the
// tap products round as the plain version's do.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr double kScale = 4294967296.0;  // 2^32
constexpr double kInvScale = 1.0 / 4294967296.0;
constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;  // events per thread per pass

struct Band {
  float y_lo, y_hi;  // rows [y_lo, y_hi) of this cluster's band
  long long px_lo;   // first pixel of the band
  long long slice;   // pixels per block
};

__device__ __forceinline__ void add_tap(unsigned long long* acc,
                                        const Band& b, float x, float y,
                                        int W, float tap) {
  if (x < 0.0f || x >= (float)W || y < b.y_lo || y >= b.y_hi) return;
  const long long q = llrint((double)tap * kScale);
  if (q == 0) return;
  const long long n = ((long long)(int)y - (long long)b.y_lo) * W + (int)x;
  const unsigned owner = (unsigned)(n / b.slice);
  unsigned long long* dst = cg::cluster_group::map_shared_rank(acc, owner);
  atomicAdd(dst + (n - (long long)owner * b.slice), (unsigned long long)q);
}

__device__ __forceinline__ void add_event(unsigned long long* acc,
                                          const Band& b, int W, float x,
                                          float y, float v) {
  if (!(isfinite(x) && isfinite(y)) || v == 0.0f) return;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  // every tap lies outside: skip before forming x0 + 1 on huge values
  if (x0 < -1.0f || x0 >= (float)W || y0 < b.y_lo - 1.0f || y0 >= b.y_hi)
    return;
  const float fx = x - x0;
  const float fy = y - y0;
  const float x1 = x0 + 1.0f;
  const float y1 = y0 + 1.0f;
  add_tap(acc, b, x0, y0, W, (1.0f - fx) * (1.0f - fy) * v);
  add_tap(acc, b, x0, y1, W, (1.0f - fx) * fy * v);
  add_tap(acc, b, x1, y0, W, fx * (1.0f - fy) * v);
  add_tap(acc, b, x1, y1, W, fx * fy * v);
}

__global__ void __launch_bounds__(kMaxThreads)
    raster_cluster_kernel(const float* __restrict__ xs,
                          const float* __restrict__ ys,
                          const float* __restrict__ vals, long long E, int H,
                          int W, int rows_per_band, long long slice,
                          float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned long long acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned csize = cluster.num_blocks();
  const int band = (int)(blockIdx.x / csize);
  const int y_lo = band * rows_per_band;
  const int y_hi = min(H, y_lo + rows_per_band);
  const Band b = {(float)y_lo, (float)y_hi, (long long)y_lo * W, slice};

  // zero this block's slice (slice is a multiple of 4), then arrive at the
  // cluster barrier; its wait comes after the first events' loads, so the
  // barrier's latency hides behind theirs
  ulonglong2* acc2 = reinterpret_cast<ulonglong2*>(acc);
  for (long long i = threadIdx.x; i < slice / 2; i += blockDim.x)
    acc2[i] = make_ulonglong2(0ull, 0ull);
  cluster.barrier_arrive();

  // scatter: every thread of the cluster strides over the events, kUnroll
  // events' loads in flight at once
  const long long stride = (long long)csize * blockDim.x;
  bool waited = false;
  for (long long e0 = (long long)rank * blockDim.x + threadIdx.x;
       e0 < E || !waited; e0 += stride * kUnroll) {
    float x[kUnroll], y[kUnroll], v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long e = e0 + j * stride;
      const bool live = e < E;
      x[j] = live ? xs[e] : 0.0f;
      y[j] = live ? ys[e] : 0.0f;
      v[j] = live ? vals[e] : 0.0f;
    }
    if (!waited) {
      cluster.barrier_wait();
      waited = true;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) add_event(acc, b, W, x[j], y[j], v[j]);
  }
  cluster.sync();

  // write this block's slice of the band
  const long long band_px = (long long)(y_hi - y_lo) * W;
  const long long first = (long long)rank * slice;
  const long long count = max(0LL, min(slice, band_px - first));
  float* dst = out + b.px_lo + first;
  if ((reinterpret_cast<size_t>(dst) & 15) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (long long i = threadIdx.x; i < count / 4; i += blockDim.x) {
      const ulonglong2 a = acc2[2 * i];
      const ulonglong2 c = acc2[2 * i + 1];
      dst4[i] = make_float4((float)((double)(long long)a.x * kInvScale),
                            (float)((double)(long long)a.y * kInvScale),
                            (float)((double)(long long)c.x * kInvScale),
                            (float)((double)(long long)c.y * kInvScale));
    }
    for (long long i = count / 4 * 4 + threadIdx.x; i < count;
         i += blockDim.x)
      dst[i] = (float)((double)(long long)acc[i] * kInvScale);
  } else {
    for (long long i = threadIdx.x; i < count; i += blockDim.x)
      dst[i] = (float)((double)(long long)acc[i] * kInvScale);
  }
}

cudaLaunchConfig_t make_config(cudaLaunchAttribute* attr, int cluster,
                               int bands, int threads, long long smem_bytes,
                               cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * bands), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_attributes(long long smem_bytes) {
  static long long set_bytes = -1;
  if (smem_bytes <= set_bytes) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      raster_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(raster_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes);
  if (err == cudaSuccess) set_bytes = smem_bytes;
  return err;
}

}  // namespace

// How many clusters of this geometry the card can hold at once (0: none).
extern "C" int rasterize_max_active_clusters(int cluster, int bands,
                                             int threads,
                                             long long smem_bytes,
                                             int* out) {
  if (threads < 32 || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes(smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = make_config(attr, cluster, bands, threads,
                                       smem_bytes, 0);
  return (int)cudaOccupancyMaxActiveClusters(out, raster_cluster_kernel, &cfg);
}

// out: [H * W] float frame, fully written. slice: pixels per block (a
// multiple of 4); smem_bytes = slice * 8.
extern "C" int rasterize_launch(const float* xs, const float* ys,
                                const float* vals, long long E, int H, int W,
                                int cluster, int bands, int rows_per_band,
                                long long slice, int threads, float* out,
                                void* stream) {
  if ((long long)H * W == 0) return 0;
  if (threads < 32 || threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const long long smem_bytes = slice * 8;
  cudaError_t err = set_attributes(smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = make_config(attr, cluster, bands, threads,
                                       smem_bytes, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, raster_cluster_kernel, xs, ys, vals, E, H,
                           W, rows_per_band, slice, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* rasterize_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
