// Split-KV decode attention (flash-decoding) for Hopper (sm_90a), bound to
// PyTorch through a plain C interface (ctypes; see
// tpu_nexus_torch/ops/_build.py).
//
// Replaces: tpu_nexus/ops/decode_attention.py::_decode_kernel (launched by
// decode_attention), in all its modes: the cache contiguous or paged, in the
// model dtype or int8 with per-slot scales, the query block at the end of
// the live prefix or at a per-row start (q_starts).  Same function: a short
// query block q [B,q_len<=8,Hq,D] against the cache; slot s is live for
// batch row b and query row j iff
//     s < lens[b]  OR  (width <= s <= row_start[b] + j)
// where row_start[b] = q_starts[b] in ragged-q mode, else the shared
// kv_len - q_len (lens = 0, width = 0 without a ragged batch); scores are
// scaled into the exp2 domain in f32, p is rounded to q's dtype before the
// P.V product, and the softmax carry is f32.
// Cache layouts (template flag kPaged, set when the table pointer is not null):
//  * contiguous: k/v [B,max_len,Hkv,D], slot s of row b at row b*max_len+s;
//  * paged: k/v are the block pool [NB,page,Hkv,D] and slot s of row b lives
//    at row block_tables[b, s/page]*page + s%page.  Every position stays
//    logical.  The tile is staged into shared memory one slot at a time
//    through the table, so a tile may straddle pages of any size (the TPU
//    kernel needed page % 32 for its tiling; this one takes any page).
// Ragged-q mode (q_starts [B] int32, speculative verify): each row reads its
// own start into the mask; kv_len only bounds the KV loop.
// int8-KV mode (template flag kQuant): k/v are int8 and k_scale/v_scale
// ([..,Hkv,1] f32 in the cache's layout) are read at the same rows.  The
// dequantization is deferred past the dots, which is exact because a slot's
// scale is constant along head_dim: k_scale multiplies the f32 score before
// the scale*log2(e) multiply, v_scale multiplies p before p is rounded to
// q's dtype (the softmax sum l takes the unscaled p), and dead slots stay 0.
// The int8 bytes are what crosses device memory: a 16-byte load holds 16
// elements.  The three flags combine freely.
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
//  * the grid is sized from the live length (last_pos + 1), and each CTA
//    stops at its own row's last live slot (per-slot cursors and q_starts
//    differ by row), so cache traffic follows each row's live length, not
//    max_len; a dead slot (and a dead logical block, whose table entry
//    points at the scratch block) is neither addressed nor loaded.  The
//    split count is chosen so that B*Hkv*splits fills the card's 132 SMs at
//    small batch.
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
           + 2 * (size_t)kTile * sizeof(float)           // k, v scales (int8-KV mode)
           + (size_t)kTile * sizeof(int);                // cache row of each slot of the tile
  }
};

// At most 168 registers a thread (three CTAs an SM): past that the
// compiler's choice for some instantiations drops to two resident CTAs,
// which measured ~1.65x slower on the int8-KV mode at kv_len 4096.
constexpr int kMinCtasPerSm = 3;

template <typename T, int D, bool kQuant, bool kPaged>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm) decode_partial_kernel(
    const T* __restrict__ q, const void* __restrict__ k_raw, const void* __restrict__ v_raw,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const int* __restrict__ lens,
    const int* __restrict__ block_tables, const int* __restrict__ q_starts, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int sq, int Hq, int Hkv, int max_len, int n_log, int page, int width,
    int uniform_start, int last_pos, int split_len, float qk_scale) {
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
  // [kTile] pool row of each slot of the tile (paged mode); -1 = not loaded
  int* row_s = reinterpret_cast<int*>(vs_s + kTile);

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
  const int row_start = q_starts ? q_starts[b] : uniform_start;
  // this row's live slots end at max(lens_b, row_start + sq) (the tail
  // window [width, row_start + j] may be empty): later slots are skipped
  const int tail_end = row_start + sq - 1 >= width ? row_start + sq : 0;
  const int row_end = max(lens_b, tail_end);
  const int s_begin = split * split_len;
  const int s_end = min(min(s_begin + split_len, last_pos + 1), row_end);

  const int pair = threadIdx.x % kPairs, rg = threadIdx.x / kPairs;
  float acc[kRowsPerThread][2];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i][0] = acc[i][1] = 0.f;

  constexpr int kChunk = 16 / (int)sizeof(KV);  // elements per 16-byte load
  constexpr int kChunksPerRow = D / kChunk;
  for (int ts = s_begin; ts < s_end; ts += kTile) {
    __syncthreads();  // previous tile's K/V/p fully consumed (and q_s/m_s ready)
    if (kPaged) {
      // look each slot's physical row up once; dead slots (past this
      // row's live end) are not addressed, their table entries unread
      if (threadIdx.x < kTile) {
        const int s = ts + threadIdx.x;
        row_s[threadIdx.x] = s < s_end ? block_tables[(size_t)b * n_log + s / page] * page + s % page : -1;
      }
      __syncthreads();
    }
    // the cache row of tile slot c: through the table, or b*max_len + s
    auto cache_row = [&](int c) {
      const int s = ts + c;
      return kPaged ? row_s[c] : (s < s_end ? b * max_len + s : -1);
    };
    for (int i = threadIdx.x; i < kTile * kChunksPerRow; i += kThreads) {
      const int c = i / kChunksPerRow, ch = i % kChunksPerRow;
      const int row = cache_row(c);
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (row >= 0) {
        const size_t off = ((size_t)row * Hkv + kvh) * D + ch * kChunk;
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
      const int row = cache_row(threadIdx.x);
      ks_s[threadIdx.x] = row >= 0 ? k_scale[(size_t)row * Hkv + kvh] : 0.f;
      vs_s[threadIdx.x] = row >= 0 ? v_scale[(size_t)row * Hkv + kvh] : 0.f;
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
  const int* block_tables;  // null: contiguous cache; set: paged pool
  const int* q_starts;      // null: the uniform query start; set: per row
  void* out;
  float *part_acc, *part_ml;
  int B, sq, Hq, Hkv, D, max_len, n_log, page, width, uniform_start, last_pos, split_len, n_splits;
  float qk_scale;
  cudaStream_t st;
};

template <typename T, int D, bool kQuant, bool kPaged>
cudaError_t launch_partial(const Args& a) {
  using KV = typename std::conditional<kQuant, int8_t, T>::type;
  const int R = a.sq * (a.Hq / a.Hkv);
  const size_t smem = Layout<KV, D>::bytes(R);
  cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel<T, D, kQuant, kPaged>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_partial_kernel<T, D, kQuant, kPaged><<<dim3(a.n_splits, a.Hkv, a.B), kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), a.k, a.v, a.k_scale, a.v_scale, a.lens, a.block_tables, a.q_starts, a.part_acc,
      a.part_ml, a.sq, a.Hq, a.Hkv, a.max_len, a.n_log, a.page, a.width, a.uniform_start, a.last_pos, a.split_len,
      a.qk_scale);
  return cudaGetLastError();
}

template <typename T, bool kQuant, bool kPaged>
cudaError_t launch_partial_d(const Args& a) {
  return a.D == 128 ? launch_partial<T, 128, kQuant, kPaged>(a) : launch_partial<T, 64, kQuant, kPaged>(a);
}

template <typename T, bool kQuant>
cudaError_t launch_partial_paged(const Args& a) {
  return a.block_tables ? launch_partial_d<T, kQuant, true>(a) : launch_partial_d<T, kQuant, false>(a);
}

template <typename T>
cudaError_t launch_all(const Args& a) {
  const cudaError_t err = a.k_scale ? launch_partial_paged<T, true>(a) : launch_partial_paged<T, false>(a);
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(a.Hkv, a.B), kThreads, 0, a.st>>>(a.part_acc, a.part_ml, static_cast<T*>(a.out),
                                                                    a.sq, a.Hq, a.Hkv, a.D, a.n_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and out).  q [B,sq,Hq,D] and out
// [B,sq,Hq,D], contiguous; lens [B] int32 or null.
// Contiguous cache (block_tables null): k/v [B,max_len,Hkv,D].  Paged
// (block_tables [B,n_log] int32 set): k/v are the pool [NB,page,Hkv,D] and
// max_len is the logical length n_log*page; every entry must name a block
// of the pool.  k_scale/v_scale both null: k/v are in q's dtype; both set:
// k/v are int8 and the scales are f32 in the cache's layout with a last dim
// of 1 (int8-KV mode).  q_starts [B] int32 or null: row b's query j sits
// at q_starts[b] + j, else at uniform_start + j.  The loop covers slots
// [0, last_pos].  part_acc [B,Hkv,n_splits,sq*G,D] and part_ml
// [B,Hkv,n_splits,sq*G,2] f32 workspace.  Split i covers slots
// [i*split_len, (i+1)*split_len); split_len must be a multiple of 32.
// qk_scale = softmax scale * log2(e).  Returns the launches'
// cudaGetLastError().
int nexus_decode_attention(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
                           const void* lens, const void* block_tables, const void* q_starts, void* out,
                           void* part_acc, void* part_ml, int B, int sq, int Hq, int Hkv, int D, int max_len,
                           int n_log, int page, int width, int uniform_start, int last_pos, int split_len,
                           int n_splits, int dtype, float qk_scale, void* stream) {
  if (B <= 0 || sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || sq * (Hq / Hkv) > kMaxRows || (D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1) || split_len <= 0 || split_len % kTile != 0 || n_splits <= 0 || last_pos < 0 ||
      last_pos >= max_len || (k_scale == nullptr) != (v_scale == nullptr) ||
      (block_tables != nullptr && (n_log <= 0 || page <= 0 || n_log * page != max_len)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.lens = static_cast<const int*>(lens);
  a.block_tables = static_cast<const int*>(block_tables);
  a.q_starts = static_cast<const int*>(q_starts);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B; a.sq = sq; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.max_len = max_len; a.n_log = n_log; a.page = page;
  a.width = width; a.uniform_start = uniform_start; a.last_pos = last_pos; a.split_len = split_len;
  a.n_splits = n_splits;
  a.qk_scale = qk_scale;
  a.st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? launch_all<__nv_bfloat16>(a) : launch_all<float>(a));
}

}  // extern "C"
