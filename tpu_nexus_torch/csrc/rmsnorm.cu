// RMSNorm over the last dim for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes; see tpu_nexus_torch/ops/_build.py).
//
// Replaces: tpu_nexus/ops/rmsnorm.py::_rms_kernel (launched by
// rms_norm_pallas).  Same function: x [rows, H] and weight [H], each in
// bf16 or f32;
//     y = x * rsqrt(mean(x^2) + eps) * w
// with every sum and product in f32 and y rounded once to x's dtype.
//
// What bounds it on this card: it reads x and w and writes y once, at ~4
// FLOP per element, so it is bound by memory bandwidth.  Design: one CTA
// per row; each thread keeps its share of the row in registers between the
// sum of squares and the scaled write (the row is read from device memory
// once), neighbouring threads on neighbouring elements; a warp-shuffle
// then shared-memory reduction gives the row's f32 sum.  A simple first
// kernel: no vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 32;  // H <= kThreads * kMaxPerThread = 8192

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) rms_kernel(const T* __restrict__ x, const W* __restrict__ w,
                                                       T* __restrict__ y, int H, float eps) {
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * H;
  T* yr = y + (size_t)row * H;
  float vals[kMaxPerThread];
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    vals[i] = c < H ? to_float(xr[c]) : 0.f;
    sq = fmaf(vals[i], vals[i], sq);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffff, sq, o);
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    inv_rms = rsqrtf(total / (float)H + eps);
  }
  __syncthreads();
  const float r = inv_rms;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < H) store(yr + c, vals[i] * r * to_float(w[c]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int H, int w_dtype, float eps, cudaStream_t st) {
  if (w_dtype == 1)
    rms_kernel<T, __nv_bfloat16><<<rows, kThreads, 0, st>>>(static_cast<const T*>(x),
                                                            static_cast<const __nv_bfloat16*>(w),
                                                            static_cast<T*>(y), H, eps);
  else
    rms_kernel<T, float><<<rows, kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<const float*>(w),
                                                    static_cast<T*>(y), H, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, H] and y [rows, H] contiguous in `dtype` (0 = float32, 1 =
// bfloat16); w [H] contiguous in `w_dtype` (same codes).  H <= 8192.
// Returns the launch's cudaGetLastError().
int nexus_rms_norm(const void* x, const void* w, void* y, int rows, int H, int dtype, int w_dtype, float eps,
                   void* stream) {
  if (rows <= 0 || H <= 0 || H > kThreads * kMaxPerThread || (dtype != 0 && dtype != 1) ||
      (w_dtype != 0 && w_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch<__nv_bfloat16>(x, w, y, rows, H, w_dtype, eps, st)
                          : launch<float>(x, w, y, rows, H, w_dtype, eps, st));
}

}  // extern "C"
