// Split-KV decode attention (flash-decoding) for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes; see
// tpu_nexus_torch/ops/_build.py).
//
// Replaces: tpu_nexus/ops/decode_attention.py::_decode_kernel (launched by
// decode_attention), in its contiguous-cache modes: the cache in the model
// dtype, or int8 with per-slot scales.  Same function: a short query block
// q [B,q_len<=8,Hq,D] against the cache k/v [B,max_len,Hkv,D]; slot s is
// live for batch row b and query row j iff
//     s < lens[b]  OR  (width <= s <= last_pos - (q_len-1) + j)
// (lens = 0, width = 0 without a ragged batch); scores are scaled into the
// exp2 domain in f32, p is rounded to q's dtype before the P.V product,
// and the softmax carry is f32.
// int8-KV mode (template flag kQuant): k/v are int8 and k_scale/v_scale
// [B,max_len,Hkv,1] f32 are read in that stored layout.  The dequantization
// is deferred past the dots, which is exact because a slot's scale is
// constant along head_dim: k_scale[b,s,h] multiplies the f32 score before
// the scale*log2(e) multiply, v_scale[b,s,h] multiplies p before p is
// rounded to q's dtype (the softmax sum l takes the unscaled p), and dead
// slots stay 0.  The int8 bytes are what crosses device memory: a 16-byte
// load holds 16 elements.
//
// What bounds it on this card: every K/V byte of the live prefix is read
// once for ~4 FLOP per byte (q_len*G rows share it), far below the H100's
// ~295 FLOP/byte ridge, so it is bound by memory bandwidth.  Design:
//  * partial pass: one CTA per (b, kv head, KV split).  It holds all
//    q_len*G query rows of that KV head, so each K/V row of its split is
//    read from device memory once (16-byte loads) and shared by every query
//    head of the GQA group; dot products run on the CUDA cores, which is
//    enough for a bandwidth-bound kernel.  It keeps an f32 (m, l, acc)
//    carry and writes it to a small workspace.
//  * the grid is sized from the live length (last_pos + 1), and a split
//    wholly past last_pos does no work, so cache traffic follows kv_len,
//    not max_len; the split count is chosen so that B*Hkv*splits fills the
//    card's 132 SMs at small batch.
//  * combine pass: a second small kernel merges the splits by their (m, l).
// A simple first kernel: no cp.async pipelining, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;     // KV slots per shared-memory tile (one per lane)
constexpr int kMaxRows = 64;  // q_len * group

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
}
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffff, x, o);
  return x;
}

// Shared-memory K/V rows are padded by 4 bytes so that lane c reading row c
// hits bank (c + d) % 32: conflict-free dot products across lanes.
// KV is the cache's element type: T, or int8_t in int8-KV mode.
template <typename KV, int D>
struct Layout {
  static constexpr int kRowElems = D + 4 / (int)sizeof(KV);
  static constexpr size_t bytes(int rows) {
    return (size_t)rows * D * sizeof(float)             // q rows (f32)
           + 2 * (size_t)kTile * kRowElems * sizeof(KV)  // K, V tiles
           + (size_t)rows * kTile * sizeof(float)        // p
           + 3 * (size_t)rows * sizeof(float)            // m, l, alpha
           + 2 * (size_t)kTile * sizeof(float);          // k, v scales (int8-KV mode)
  }
};

template <typename T, int D, bool kQuant>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const T* __restrict__ q, const void* __restrict__ k_raw, const void* __restrict__ v_raw,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const int* __restrict__ lens,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int sq, int Hq, int Hkv, int max_len, int width,
    int last_pos, int split_len, float qk_scale) {
  using KV = typename std::conditional<kQuant, int8_t, T>::type;
  using L = Layout<KV, D>;
  const KV* __restrict__ k = static_cast<const KV*>(k_raw);
  const KV* __restrict__ v = static_cast<const KV*>(v_raw);
  constexpr int kRow = L::kRowElems;
  constexpr int kPairs = D / 2;             // output column pairs
  constexpr int kRowGroups = kThreads / kPairs;
  constexpr int kRowsPerThread = kMaxRows / kRowGroups;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = Hq / Hkv, R = sq * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [R][D]
  KV* k_s = reinterpret_cast<KV*>(q_s + R * D);     // [kTile][kRow]
  KV* v_s = k_s + kTile * kRow;                     // [kTile][kRow]
  float* p_s = reinterpret_cast<float*>(v_s + kTile * kRow);  // [R][kTile]
  float* m_s = p_s + R * kTile;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  float* ks_s = a_s + R;       // [kTile] this tile's k scales (int8-KV mode)
  float* vs_s = ks_s + kTile;  // [kTile]

  // query rows r = j*G + gi <- q[b, j, kvh*G + gi, :]
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D, j = r / G, gi = r % G;
    q_s[i] = to_float(q[((size_t)(b * sq + j) * Hq + kvh * G + gi) * D + d]);
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int lens_b = lens ? lens[b] : 0;
  const int row_start = last_pos - (sq - 1);
  const int s_begin = split * split_len;
  const int s_end = min(min(s_begin + split_len, last_pos + 1), max_len);

  const int pair = threadIdx.x % kPairs, rg = threadIdx.x / kPairs;
  float acc[kRowsPerThread][2];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i][0] = acc[i][1] = 0.f;

  constexpr int kChunk = 16 / (int)sizeof(KV);  // elements per 16-byte load
  constexpr int kChunksPerRow = D / kChunk;
  for (int ts = s_begin; ts < s_end; ts += kTile) {
    __syncthreads();  // previous tile's K/V/p fully consumed (and q_s/m_s ready)
    for (int i = threadIdx.x; i < kTile * kChunksPerRow; i += kThreads) {
      const int c = i / kChunksPerRow, ch = i % kChunksPerRow, s = ts + c;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (s < s_end) {
        const size_t off = ((size_t)(b * max_len + s) * Hkv + kvh) * D + ch * kChunk;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      // padded rows are only 4-byte aligned: store as four words
      uint32_t* dk = reinterpret_cast<uint32_t*>(k_s + c * kRow + ch * kChunk);
      uint32_t* dv = reinterpret_cast<uint32_t*>(v_s + c * kRow + ch * kChunk);
      dk[0] = kv.x; dk[1] = kv.y; dk[2] = kv.z; dk[3] = kv.w;
      dv[0] = vv.x; dv[1] = vv.y; dv[2] = vv.z; dv[3] = vv.w;
    }
    if (kQuant && threadIdx.x < kTile) {
      const int s = ts + threadIdx.x;
      const size_t off = (size_t)(b * max_len + s) * Hkv + kvh;
      ks_s[threadIdx.x] = s < s_end ? k_scale[off] : 0.f;
      vs_s[threadIdx.x] = s < s_end ? v_scale[off] : 0.f;
    }
    __syncthreads();

    // scores + online softmax: warp w owns rows w, w+4, ...; lane = slot
    const int s = ts + lane;
    for (int r = warp; r < R; r += kThreads / 32) {
      const float* qr = q_s + r * D;
      const KV* kr = k_s + lane * kRow;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 2) {
        const float2 kk = load2(kr + d);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
      }
      const int j = r / G;
      const bool live = s < s_end && (s < lens_b || (s >= width && s <= row_start + j));
      if (kQuant) dot *= ks_s[lane];  // deferred dequant of K: exact, the scale is constant along D
      const float sc = live ? dot * qk_scale : -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float alpha = (m_old == -INFINITY) ? 0.f : exp2f(m_old - m_new);
      const float p = live ? exp2f(sc - m_new) : 0.f;
      const float psum = warp_sum(p);
      // p in q's dtype for P.V; int8-KV folds the slot's v scale in first (dead slots stay 0)
      p_s[r * kTile + lane] = round_to(kQuant ? p * vs_s[lane] : p, q);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc*alpha + P.V; thread owns column pair `pair` of rows rg + i*kRowGroups
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + i * kRowGroups;
      if (r < R) {
        const float alpha = a_s[r];
        float a0 = acc[i][0] * alpha, a1 = acc[i][1] * alpha;
        const float* pr = p_s + r * kTile;
#pragma unroll 8
        for (int c = 0; c < kTile; ++c) {
          const float2 vv = load2(v_s + c * kRow + 2 * pair);
          a0 = fmaf(pr[c], vv.x, a0);
          a1 = fmaf(pr[c], vv.y, a1);
        }
        acc[i][0] = a0;
        acc[i][1] = a1;
      }
    }
  }
  __syncthreads();

  const size_t base = ((size_t)(b * Hkv + kvh) * n_splits + split) * R;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg + i * kRowGroups;
    if (r < R) {
      float2* dst = reinterpret_cast<float2*>(part_acc + (base + r) * D + 2 * pair);
      *dst = make_float2(acc[i][0], acc[i][1]);
    }
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    part_ml[(base + r) * 2] = m_s[r];
    part_ml[(base + r) * 2 + 1] = l_s[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml, T* __restrict__ out, int sq, int Hq,
    int Hkv, int D, int n_splits) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv, R = sq * G;
  const size_t base = (size_t)(b * Hkv + kvh) * n_splits * R;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float m = -INFINITY;
    for (int sp = 0; sp < n_splits; ++sp) m = fmaxf(m, part_ml[(base + (size_t)sp * R + r) * 2]);
    float l = 0.f, o = 0.f;
    if (m != -INFINITY) {
      for (int sp = 0; sp < n_splits; ++sp) {
        const size_t row = base + (size_t)sp * R + r;
        const float ms = part_ml[row * 2];
        if (ms == -INFINITY) continue;
        const float w = exp2f(ms - m);
        l = fmaf(part_ml[row * 2 + 1], w, l);
        o = fmaf(part_acc[row * D + d], w, o);
      }
    }
    const int j = r / G, gi = r % G;
    store_out(out + ((size_t)(b * sq + j) * Hq + kvh * G + gi) * D + d, o / fmaxf(l, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;  // both null: the cache is in q's dtype; both set: int8-KV
  const int* lens;
  void* out;
  float *part_acc, *part_ml;
  int B, sq, Hq, Hkv, D, max_len, width, last_pos, split_len, n_splits;
  float qk_scale;
  cudaStream_t st;
};

template <typename T, int D, bool kQuant>
cudaError_t launch_partial(const Args& a) {
  using KV = typename std::conditional<kQuant, int8_t, T>::type;
  const int R = a.sq * (a.Hq / a.Hkv);
  const size_t smem = Layout<KV, D>::bytes(R);
  cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel<T, D, kQuant>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_partial_kernel<T, D, kQuant><<<dim3(a.n_splits, a.Hkv, a.B), kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), a.k, a.v, a.k_scale, a.v_scale, a.lens, a.part_acc, a.part_ml, a.sq, a.Hq, a.Hkv,
      a.max_len, a.width, a.last_pos, a.split_len, a.qk_scale);
  return cudaGetLastError();
}

template <typename T, bool kQuant>
cudaError_t launch_partial_d(const Args& a) {
  return a.D == 128 ? launch_partial<T, 128, kQuant>(a) : launch_partial<T, 64, kQuant>(a);
}

template <typename T>
cudaError_t launch_all(const Args& a) {
  const cudaError_t err = a.k_scale ? launch_partial_d<T, true>(a) : launch_partial_d<T, false>(a);
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(a.Hkv, a.B), kThreads, 0, a.st>>>(a.part_acc, a.part_ml, static_cast<T*>(a.out),
                                                                    a.sq, a.Hq, a.Hkv, a.D, a.n_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and out).  q [B,sq,Hq,D], k/v
// [B,max_len,Hkv,D] and out [B,sq,Hq,D], all contiguous; lens [B] int32 or
// null.  k_scale/v_scale both null: k/v are in q's dtype; both set: k/v are
// int8 and the scales are [B,max_len,Hkv,1] f32 (int8-KV mode).  part_acc
// [B,Hkv,n_splits,sq*G,D] and part_ml [B,Hkv,n_splits,sq*G,2] f32
// workspace.  Split i covers slots [i*split_len, (i+1)*split_len);
// split_len must be a multiple of 32.  qk_scale = softmax scale * log2(e).
// Returns the launches' cudaGetLastError().
int nexus_decode_attention(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
                           const void* lens, void* out, void* part_acc, void* part_ml, int B, int sq, int Hq,
                           int Hkv, int D, int max_len, int width, int last_pos, int split_len, int n_splits,
                           int dtype, float qk_scale, void* stream) {
  if (B <= 0 || sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || sq * (Hq / Hkv) > kMaxRows || (D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1) || split_len <= 0 || split_len % kTile != 0 || n_splits <= 0 || last_pos < 0 ||
      last_pos >= max_len || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.lens = static_cast<const int*>(lens);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B; a.sq = sq; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.max_len = max_len; a.width = width;
  a.last_pos = last_pos; a.split_len = split_len; a.n_splits = n_splits;
  a.qk_scale = qk_scale;
  a.st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_all<__nv_bfloat16>(a) : launch_all<float>(a));
}

}  // extern "C"
