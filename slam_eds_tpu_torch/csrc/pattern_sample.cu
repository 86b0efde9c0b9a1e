// Bilinear pattern sampler for the photometric BA linearization (sm_90a).
//
// Replaces the Pallas TPU kernel slam_eds_tpu/ops/pallas/sample.py
// (pattern_pallas_sample, kernel body _sample_kernel), which expressed the
// per-tap bilinear stencil as one-hot "hat" matrices contracted on the MXU
// to avoid TPU element gathers. On Hopper a gather is cheap, so this kernel
// computes what that kernel computes, not how: one thread per tap
// (p, f, k) reads the 12 texels of the 4x4 neighbourhood without its
// corners and writes
//
//   I  = bilinear value at (u, v)
//   gx = 0.5 * (I(u+1, v) - I(u-1, v)),  gy likewise along v
//   ok = 1 <= u < W-2  &&  1 <= v < H-2
//
// after cleaning the coordinate (NaN -> -8, then clip to [-8, W+8] /
// [-8, H+8]). A texel outside [0, W) x [0, H) reads as 0, so every output is
// finite for finite planes, including taps where ok is false: the caller
// multiplies gx^2 + gy^2 by the 0/1 mask, and a NaN there would poison the
// outlier gate.
//
// What bounds it on the card: the bytes it must move. At the operating point
// (P*F*K = 131,072 path taps) that is 1.05 MB of (u, v) in, 1.70 MB of
// (I, gx, gy, ok) out and the 550,943 distinct channel-0 texels the taps
// need (2.2 MB): 1.48 us at 3.35 TB/s; ~40 FLOPs per tap are nothing beside
// it. The design keeps it a pure L2-resident gather: texels go through the
// read-only path (__ldg), and each run of K consecutive threads takes the K
// pattern taps of one (point, frame), which lie in a 5x5 window of one
// plane, so a warp's texel reads share cache lines. The planes may be
// strided (channel 0 of an [F, H, W, 3] stack is read in place); the window
// hands the kernel its planar, contiguous [F, H, W] intensity, where a
// sector holds eight texels of a row instead of two or three. A design that
// staged each (point, frame)'s texel box in shared memory, one warp per four
// pairs, was slower on the card (PERF.md). The arithmetic follows
// pattern_sample_reference term by term; built with --fmad=false it rounds
// as that version does.
//
// Lane axis (the batched BA windows, eval.batched_ba_windows): taps
// [B, P, F, K] of lane b read plane f of lane b, at planes + b * sB + f * sF
// (a [B * F, H, W] stack when sB = F * sF); lane_taps = P * F * K. The lane
// is blockIdx.y, so a thread finds its lane without a division, and the
// tap's frame comes from its index within the lane in 32 bits: a single
// problem (B = 1) does no more index work than before the lane axis.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float texel(const float* __restrict__ plane,
                                       long long sH, long long sW, int H,
                                       int W, int y, int x) {
  return (x >= 0 && x < W && y >= 0 && y < H)
             ? __ldg(plane + (long long)y * sH + (long long)x * sW)
             : 0.0f;
}

__global__ void pattern_sample_kernel(
    const float* __restrict__ planes, long long sB, long long sF,
    long long sH, long long sW, int F, int H, int W, int K,
    long long lane_taps,
    const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ out_I, float* __restrict__ out_gx,
    float* __restrict__ out_gy, bool* __restrict__ out_ok) {
  // t: the tap within lane b = blockIdx.y (lane_taps < 2^31, so its index
  // arithmetic is 32-bit); n: the tap's index in [B, P, F, K]
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (unsigned)lane_taps) return;
  const long long b = blockIdx.y;
  const long long n = b * lane_taps + t;
  const int f = (int)((t / (unsigned)K) % (unsigned)F);
  const float* plane = planes + b * sB + (long long)f * sF;

  float uc = u[n];
  float vc = v[n];
  if (isnan(uc)) uc = -8.0f;
  if (isnan(vc)) vc = -8.0f;
  uc = fminf(fmaxf(uc, -8.0f), (float)W + 8.0f);
  vc = fminf(fmaxf(vc, -8.0f), (float)H + 8.0f);
  const bool ok = (uc >= 1.0f) && (uc < (float)W - 2.0f) && (vc >= 1.0f) &&
                  (vc < (float)H - 2.0f);

  const float x0f = floorf(uc);
  const float y0f = floorf(vc);
  const float fx = uc - x0f;
  const float fy = vc - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;

  // p<r><c>: row y0-1+r, column x0-1+c (corners of the 4x4 are not needed)
  const float p01 = texel(plane, sH, sW, H, W, y0 - 1, x0);
  const float p02 = texel(plane, sH, sW, H, W, y0 - 1, x0 + 1);
  const float p10 = texel(plane, sH, sW, H, W, y0, x0 - 1);
  const float p11 = texel(plane, sH, sW, H, W, y0, x0);
  const float p12 = texel(plane, sH, sW, H, W, y0, x0 + 1);
  const float p13 = texel(plane, sH, sW, H, W, y0, x0 + 2);
  const float p20 = texel(plane, sH, sW, H, W, y0 + 1, x0 - 1);
  const float p21 = texel(plane, sH, sW, H, W, y0 + 1, x0);
  const float p22 = texel(plane, sH, sW, H, W, y0 + 1, x0 + 1);
  const float p23 = texel(plane, sH, sW, H, W, y0 + 1, x0 + 2);
  const float p31 = texel(plane, sH, sW, H, W, y0 + 2, x0);
  const float p32 = texel(plane, sH, sW, H, W, y0 + 2, x0 + 1);

  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w01 = fx * (1.0f - fy);
  const float w10 = (1.0f - fx) * fy;
  const float w11 = fx * fy;

  out_I[n] = w00 * p11 + w01 * p12 + w10 * p21 + w11 * p22;
  out_gx[n] = 0.5f * (w00 * (p12 - p10) + w01 * (p13 - p11) +
                      w10 * (p22 - p20) + w11 * (p23 - p21));
  out_gy[n] = 0.5f * (w00 * (p21 - p01) + w01 * (p22 - p02) +
                      w10 * (p31 - p11) + w11 * (p32 - p12));
  out_ok[n] = ok;
}

}  // namespace

extern "C" int pattern_sample_launch(const float* planes, long long sB,
                                     long long sF, long long sH, long long sW,
                                     int F, int H, int W, int K, int lanes,
                                     long long lane_taps, const float* u,
                                     const float* v, float* out_I,
                                     float* out_gx, float* out_gy,
                                     bool* out_ok, void* stream) {
  if (lanes == 0 || lane_taps == 0) return 0;
  if (lanes < 0 || lanes > 65535 || lane_taps < 0 || lane_taps > 2147483647)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (lane_taps + threads - 1) / threads;
  const dim3 grid((unsigned)blocks, (unsigned)lanes);
  pattern_sample_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      planes, sB, sF, sH, sW, F, H, W, K, lane_taps, u, v, out_I, out_gx,
      out_gy, out_ok);
  return (int)cudaGetLastError();
}

extern "C" const char* pattern_sample_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
