// RMSNorm over the last dim for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes; see tpu_nexus_torch/ops/_build.py).
//
// Replaces: tpu_nexus/ops/rmsnorm.py::_rms_kernel (launched by
// rms_norm_pallas).  Same function: x [rows, H] and weight [H], each in
// bf16 or f32, H <= 8192;
//     y = x * rsqrt(mean(x^2) + eps) * w
// with every sum and product in f32 and y rounded once to x's dtype.
//
// What bounds it on this card: it reads x once and writes y once at ~4 FLOP
// an element, so the bytes over the HBM rate bound it; the kernel's job is
// to keep enough bytes in flight and move them in wide accesses.  Design:
//  * vector streams: a lane moves 16 bytes an access (8 bf16 or 4 f32),
//    neighbouring lanes on neighbouring 16-byte chunks, so a warp moves
//    512 contiguous bytes an instruction.  A row whose pitch is not a
//    multiple of 16 bytes (or an unaligned tensor) takes the same layout
//    with element loads, masked at H.
//  * a row belongs to kW warps (1 up to H 1024, 2, 4, 8 up to H 8192), each
//    lane holding 32 elements of it in registers between the sum of squares
//    and the scaled write.  The sum is reduced by shuffles inside a warp;
//    with kW > 1 the kW warps of the row add their sums in a fixed order
//    through shared memory, behind a named barrier of just those warps (two
//    slots by row parity, so one barrier a row).  No __syncthreads and no
//    serial sum by one thread on the row's path; the order is fixed, so a
//    result is bit-identical run to run.
//  * persistent CTAs (the SMs times the CTAs an SM holds): each group of kW
//    warps walks rows with a stride of the grid, and loads its NEXT row
//    into registers before it reduces and stores the current one, so every
//    warp keeps a row's loads in flight under its own arithmetic and
//    stores.  (Through registers, not a cp.async.bulk ring: the row is
//    needed in registers anyway, and 16 resident warps an SM each keep a
//    2-8 KB row in flight.)
//  * the weight is read once a CTA, into the registers of the lanes whose
//    columns it scales (every row of a group uses the same columns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 32;  // elements a lane holds: H <= kWarps * 32 * kPerLane = 8192

// A 16-byte vector of x or y as four 32-bit words: 8 bf16 (element i in half i % 2 of word i / 2)
// or 4 f32.  bf16 -> f32 is exact (the bits shifted up); f32 -> bf16 rounds to nearest even.
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kE = 8;
  using Bits = unsigned short;
  __device__ static float get(const uint32_t (&w)[4], int i) {
    return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
  }
  __device__ static uint32_t bits(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
  __device__ static void put(uint32_t (&w)[4], int i, uint32_t b) { w[i / 2] |= b << (16 * (i % 2)); }
  __device__ static Bits take(const uint32_t (&w)[4], int i) { return static_cast<Bits>(w[i / 2] >> (16 * (i % 2))); }
};
template <>
struct Vec<float> {
  static constexpr int kE = 4;
  using Bits = uint32_t;
  __device__ static float get(const uint32_t (&w)[4], int i) { return __uint_as_float(w[i]); }
  __device__ static uint32_t bits(float v) { return __float_as_uint(v); }
  __device__ static void put(uint32_t (&w)[4], int i, uint32_t b) { w[i] |= b; }
  __device__ static Bits take(const uint32_t (&w)[4], int i) { return w[i]; }
};

// kW warps a row; a lane's 32 elements are kV vectors of kE, vector v of lane l of the row's warp
// wr starting at element ((v * kW + wr) * 32 + l) * kE.  kAligned: 16-byte accesses (H a
// multiple of kE, x and y 16-byte aligned); else element accesses masked at H.
template <typename T, int kW, bool kAligned>
__global__ void __launch_bounds__(kThreads) rms_kernel(const T* __restrict__ x, const void* __restrict__ w,
                                                       int w_bf16, T* __restrict__ y, int rows, int H, float eps) {
  using V = Vec<T>;
  using Bits = typename V::Bits;
  constexpr int kE = V::kE;
  constexpr int kV = kPerLane / kE;
  constexpr int kGroups = kWarps / kW;  // rows a CTA has in flight
  __shared__ float red[2][kWarps];      // [row parity][warp]: the warps' sums of squares

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp / kW, wr = warp % kW;
  int col[kV];
  float wt[kV][kE];  // this lane's columns of the weight, read once
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    col[v] = ((v * kW + wr) * 32 + lane) * kE;
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int c = col[v] + i;
      wt[v][i] = c >= H ? 0.f
                 : w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(w)[c])
                          : static_cast<const float*>(w)[c];
    }
  }

  auto load = [&](uint32_t (&dst)[kV][4], int row) {
    const T* xr = x + (size_t)row * H;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      if (kAligned) {
        const uint4 t = col[v] < H ? __ldg(reinterpret_cast<const uint4*>(xr + col[v])) : make_uint4(0u, 0u, 0u, 0u);
        dst[v][0] = t.x, dst[v][1] = t.y, dst[v][2] = t.z, dst[v][3] = t.w;
      } else {
        dst[v][0] = dst[v][1] = dst[v][2] = dst[v][3] = 0u;
#pragma unroll
        for (int i = 0; i < kE; ++i)
          if (col[v] + i < H) V::put(dst[v], i, reinterpret_cast<const Bits*>(xr)[col[v] + i]);
      }
    }
  };

  const int stride = gridDim.x * kGroups;
  int row = blockIdx.x * kGroups + group, parity = 0;
  uint32_t cur[kV][4], nxt[kV][4];
  if (row < rows) load(cur, row);
  for (; row < rows; row += stride) {
    if (row + stride < rows) load(nxt, row + stride);  // in flight under this row's work
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v)
#pragma unroll
      for (int i = 0; i < kE; ++i) {
        const float f = V::get(cur[v], i);
        sq = fmaf(f, f, sq);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (kW > 1) {
      if (lane == 0) red[parity][warp] = sq;
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kW * 32) : "memory");
      sq = 0.f;
#pragma unroll
      for (int i = 0; i < kW; ++i) sq += red[parity][group * kW + i];
      parity ^= 1;
    }
    const float r = rsqrtf(sq / (float)H + eps);
    T* yr = y + (size_t)row * H;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < kE; ++i) V::put(out, i, V::bits(V::get(cur[v], i) * r * wt[v][i]));
      if (kAligned) {
        if (col[v] < H) *reinterpret_cast<uint4*>(yr + col[v]) = make_uint4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int i = 0; i < kE; ++i)
          if (col[v] + i < H) reinterpret_cast<Bits*>(yr)[col[v] + i] = V::take(out, i);
      }
    }
#pragma unroll
    for (int v = 0; v < kV; ++v)
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[v][j] = nxt[v][j];
  }
}

// The SMs of the current device times the CTAs of `kernel` an SM holds, cached per device.
template <typename Kernel>
int resident_ctas(Kernel kernel, std::atomic<int> (&cache)[64]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  const int slot = dev < 64 ? dev : 63;
  int n = cache[slot].load(std::memory_order_relaxed);
  if (n > 0) return n;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess || per_sm <= 0)
    return -1;
  n = sms * per_sm;
  cache[slot].store(n, std::memory_order_relaxed);
  return n;
}

template <typename T, int kW, bool kAligned>
cudaError_t launch(const void* x, const void* w, int w_bf16, void* y, int rows, int H, float eps, cudaStream_t st) {
  static std::atomic<int> cache[64];
  const int resident = resident_ctas(rms_kernel<T, kW, kAligned>, cache);
  if (resident <= 0) return cudaErrorInvalidValue;
  const int needed = (rows + kWarps / kW - 1) / (kWarps / kW);
  rms_kernel<T, kW, kAligned><<<needed < resident ? needed : resident, kThreads, 0, st>>>(
      static_cast<const T*>(x), w, w_bf16, static_cast<T*>(y), rows, H, eps);
  return cudaGetLastError();
}

template <typename T, bool kAligned>
cudaError_t launch_w(const void* x, const void* w, int w_bf16, void* y, int rows, int H, float eps,
                     cudaStream_t st) {
  constexpr int kRow = 32 * kPerLane;  // elements one warp of a row holds
  if (H <= kRow) return launch<T, 1, kAligned>(x, w, w_bf16, y, rows, H, eps, st);
  if (H <= 2 * kRow) return launch<T, 2, kAligned>(x, w, w_bf16, y, rows, H, eps, st);
  if (H <= 4 * kRow) return launch<T, 4, kAligned>(x, w, w_bf16, y, rows, H, eps, st);
  return launch<T, 8, kAligned>(x, w, w_bf16, y, rows, H, eps, st);
}

template <typename T>
cudaError_t launch_t(const void* x, const void* w, int w_bf16, void* y, int rows, int H, float eps,
                     cudaStream_t st) {
  const auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (H % (16 / (int)sizeof(T)) == 0 && at16(x) && at16(y))
    return launch_w<T, true>(x, w, w_bf16, y, rows, H, eps, st);
  return launch_w<T, false>(x, w, w_bf16, y, rows, H, eps, st);
}

}  // namespace

extern "C" {

// x [rows, H] and y [rows, H] contiguous in `dtype` (0 = float32, 1 =
// bfloat16); w [H] contiguous in `w_dtype` (same codes).  H <= 8192.
// Returns the launch's cudaGetLastError().
int nexus_rms_norm(const void* x, const void* w, void* y, int rows, int H, int dtype, int w_dtype, float eps,
                   void* stream) {
  if (rows <= 0 || H <= 0 || H > kWarps * 32 * kPerLane || (dtype != 0 && dtype != 1) ||
      (w_dtype != 0 && w_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_t<__nv_bfloat16>(x, w, w_dtype, y, rows, H, eps, st)
                          : launch_t<float>(x, w, w_dtype, y, rows, H, eps, st));
}

}  // extern "C"
