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
// Cache layouts:
//  * contiguous: k/v [B,max_len,Hkv,D], slot s of row b at row b*max_len+s;
//  * paged: k/v are the block pool [NB,page,Hkv,D] and slot s of row b lives
//    at row block_tables[b, s/page]*page + s%page.  Every position stays
//    logical.  Slots are addressed one by one through the table, so a tile
//    may straddle pages of any size (the TPU kernel needed page % 32).
// Ragged-q mode (q_starts [B] int32, speculative verify): each row reads its
// own start into the mask; kv_len only bounds the KV loop.
// int8-KV mode: k/v are int8 and k_scale/v_scale ([..,Hkv,1] f32 in the
// cache's layout) are read at the same rows.  The dequantization is deferred
// past the dots, which is exact because a slot's scale is constant along
// head_dim: k_scale multiplies the f32 score before the scale*log2(e)
// multiply, v_scale multiplies p before p is rounded to q's dtype (the
// softmax sum l takes the unscaled p), and dead slots stay 0.  The int8
// bytes are what crosses device memory.  The modes combine freely.
// Every CTA stops at its own row's last live slot (per-slot cursors and
// q_starts differ by row), so cache traffic follows each row's live length,
// not max_len; a dead slot (and a dead logical block, whose table entry
// points at the scratch block) is neither looked up nor loaded.
//
// What bounds it on this card: every K/V byte of the live prefix is read
// once for ~4 FLOP per byte (q_len*G rows share it), far below the H100's
// ~295 FLOP/byte ridge, so memory bandwidth bounds it at long contexts and
// latency (launch, the first loads, the merge) at short ones.
//
// Design (bf16 q, the cache bf16 or int8): one CTA per (b, kv head, KV split)
// of one consumer warpgroup and one producer warpgroup (csrc/hopper.cuh):
//  * the producer keeps 64-slot K and V tiles in flight in a ring of
//    kStages stages (full/empty mbarriers).  It looks each slot's cache row
//    up once a tile (through the table in paged mode) and issues 16-byte
//    cp.async copies, which land in the 128-byte-swizzled panels wgmma
//    reads.  A slot past the row's live end is neither looked up nor read:
//    its copy writes zeros, so a tile's tail rows are exact zeros and never
//    poison the P.V sums.  (A TMA box could not stop at a row's live end
//    inside a tile nor gather pages under 8 slots.)  It takes a whole
//    warpgroup: one warp's copies could not keep enough of the tile in
//    flight and set the pace (measured, PERF.md).
//  * int8-KV mode: the int8 tiles and the slots' f32 scales (4-byte copies)
//    land kLanding tiles ahead in a separate ring; the producer widens each
//    into the consumers' bf16 tiles (exact: |x| <= 128) with byte permutes
//    and an f32 add, not the quarter-rate conversion instructions, while
//    the consumers compute on the previous tile.
//  * the consumer warpgroup computes S^T = K.Q^T with wgmma m64nNk16: the 64
//    slots of a tile fill M and the q_len*G query rows fill N (8, 16, 32 or
//    64; padding rows of Q are zero and masked).  Q is staged once into
//    swizzled shared memory as the K-major B operand.  The softmax runs down
//    the columns: each warp holds 16 slots, so a column's maximum is reduced
//    across lanes by shuffles and across the four warps through shared
//    memory (one named barrier a tile); the sums stay per thread until the
//    end.  k_scale multiplies the f32 scores; p (times v_scale, rounded to
//    bf16) is written as P^T into a small swizzled tile, and O^T += V^T.P^T
//    runs as wgmma with V MN-major (the transpose bit) straight from the ring.
//  * the split plan (ops/decode_attention.py) follows the live length and
//    the CTAs the card can hold: one split where B*Hkv CTAs cover the card or
//    the prefix is a few tiles; else the splits write (m, l, acc) partials
//    and the last CTA of each (b, kv head) to arrive, told by an arrival
//    counter, merges them in split order in the same launch and sets the
//    counter back to 0.  The merge order is fixed, so a run repeated is
//    bit-identical.
// f32 q (the test path for token identity) keeps the first design: a
// CUDA-core partial pass (32-slot tiles staged synchronously) and a combine
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace nexus_hopper;

constexpr int kMaxRows = 64;  // q_len * group

// -- bf16 q: the Hopper kernel ----------------------------------------------------------------

constexpr int kSlots = 64;            // KV slots a ring stage holds: the M of S^T = K.Q^T
constexpr int kConsumerThreads = 128;  // one warpgroup
constexpr int kProducerThreads = 128;  // the producer warpgroup: one warp's 16-byte copies cannot
                                       // keep enough of a tile in flight (measured, PERF.md)
constexpr int kHopperThreads = kConsumerThreads + kProducerThreads;
constexpr int kMaxSplits = 64;        // the merge keeps [splits][N] weights in the idle ring

constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// N: the query rows q_len*G rounded up to a wgmma width
constexpr int cols_for(int rows) { return rows <= 8 ? 8 : rows <= 16 ? 16 : rows <= 32 ? 32 : 64; }

template <int D, bool kQuant, int N>
struct HopperLayout {  // byte offsets from a 1024-byte-aligned base
  static constexpr int kPanels = D / 64;
  static constexpr int kPanelBytes = kSlots * 128;          // 64 slots x one 128-byte row
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // a bf16 tile of 64 slots
  static constexpr int kStages = kQuant ? 2 : 3;            // bf16 K/V tiles the consumers read
  static constexpr int kLanding = kQuant ? 2 : 0;           // int8-KV: int8 K/V tiles in flight
  static constexpr int kRawBytes = kSlots * D;              // an int8 tile
  static constexpr int kQPanelBytes = N * 128;
  static constexpr int kQ = 0;                              // Q: kPanels panels of N rows (K-major B)
  static constexpr int kP = kQ + kPanels * kQPanelBytes;    // P^T: N rows x 64 slots (K-major B)
  static constexpr int kK = round_up(kP + N * 128, 1024);   // the ring's K tiles
  static constexpr int kV = kK + kStages * kTileBytes;      // the ring's V tiles
  static constexpr int kLand = kV + kStages * kTileBytes;   // int8-KV: [kLanding][K, V] int8 tiles
  static constexpr int kLandScales = kLand + kLanding * 2 * kRawBytes;  // [kLanding][k, v][kSlots] f32
  static constexpr int kScales = kLandScales + kLanding * 2 * kSlots * 4;  // [kStages][k, v][kSlots] f32
  static constexpr int kRed = kScales + (kQuant ? kStages * 2 * kSlots * 4 : 0);  // [4 warps][N] f32
  static constexpr int kRows = kRed + 4 * N * 4;  // [kSlots] int: the producer's slot -> cache row
  static constexpr int kFlag = kRows + kSlots * 4;  // int: this CTA merges the splits
  static constexpr int kBar = round_up(kFlag + 4, 8);  // k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 3 * kStages * 8 + 1024;  // + alignment slack
  static_assert(3 * kMaxSplits * N * 4 <= kRed - kK, "the merge's weights and (m, l) fit in the idle ring");
  static_assert(N * (D + 8) * 2 <= kRed - kK, "the output rows fit in the idle ring");
};

// Byte offset of 16-byte chunk `ch` (8 bf16 columns) of row r in 128B-swizzled panels of
// `panel_bytes` bytes (hopper.cuh's layout).
__device__ __forceinline__ uint32_t swz(int r, int ch, int panel_bytes) {
  return (ch >> 3) * panel_bytes + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// The producer's copies of one 64-slot tile: thread `pt` copies 16-byte chunk pt % kChunks of every
// (kProducerThreads / kChunks)-th row; rows_s[c] is slot c's cache row, -1 for a dead slot (zeros).
template <int D, bool kQuant>
__device__ __forceinline__ void issue_tile(unsigned char* dst, const char* src, const int* rows_s, int Hkv, int kvh,
                                           int pt) {
  constexpr int kRowBytes = kQuant ? D : 2 * D;
  constexpr int kChunks = kRowBytes / 16;
  constexpr int kRowsPerPass = kProducerThreads / kChunks;
  const int ch = pt % kChunks;
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int k = 0; k < kSlots / kRowsPerPass; ++k) {
    const int c = pt / kChunks + k * kRowsPerPass;
    const int row = rows_s[c];
    const char* g = row >= 0 ? src + ((size_t)row * Hkv + kvh) * kRowBytes + ch * 16 : src;
    // int8 tiles stay plain rows (the producer widens them); bf16 tiles land swizzled for wgmma
    const uint32_t off = kQuant ? c * kRowBytes + ch * 16 : swz(c, ch, kSlots * 128);
    cp_async_16(base + off, g, row >= 0 ? 16 : 0);
  }
}

// The producer warpgroup's barrier (the consumers use ids 1-8).
__device__ __forceinline__ void producer_sync() { named_barrier_sync(9, kProducerThreads); }

// int8 tile [64 slots][D] -> bf16 swizzled panels (exact: |x| <= 128), by the producer threads.
template <int D>
__device__ __forceinline__ void widen_tile(unsigned char* dst, const unsigned char* src, int pt) {
#pragma unroll
  for (int k = 0; k < kSlots * D / 16 / kProducerThreads; ++k) {
    const int i = pt + k * kProducerThreads;
    const int c = i / (D / 16), part = i % (D / 16);  // 16 int8 = two 8-column bf16 chunks
    const uint4 w = *reinterpret_cast<const uint4*>(src + c * D + part * 16);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    uint32_t h[8];
#pragma unroll
    for (int wd = 0; wd < 4; ++wd) {
      // no I2F/F2F (a quarter-rate pipe): byte u = x + 128 becomes the f32 2^23 + u, minus
      // 2^23 + 128 gives x exactly, and a small integer's bf16 is its f32's high half
      const uint32_t u = words[wd] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | e)) - 8388736.f;
      h[2 * wd] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
      h[2 * wd + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
    }
    *reinterpret_cast<uint4*>(dst + swz(c, 2 * part, kSlots * 128)) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(dst + swz(c, 2 * part + 1, kSlots * 128)) = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// Two CTAs an SM where the accumulators allow (<= 128 registers a thread): the ring of one CTA
// waits on memory while the other computes.
template <int D, bool kQuant, int N>
__global__ void __launch_bounds__(kHopperThreads, N <= 32 ? 2 : 1) decode_hopper_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_raw, const void* __restrict__ v_raw,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const int* __restrict__ lens,
    const int* __restrict__ block_tables, const int* __restrict__ q_starts, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, unsigned int* __restrict__ arrivals, int sq, int Hq,
    int Hkv, int max_len, int n_log, int page, int width, int uniform_start, int last_pos, int split_len,
    float qk_scale) {
  using L = HopperLayout<D, kQuant, N>;
  constexpr int kCols = N / 4;  // query-row columns a thread holds (two of every 8)
  extern __shared__ __align__(16) unsigned char smem_raw[];  // (the f32 kernel's declaration)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* v_full = k_full + L::kStages;
  uint64_t* empty = v_full + L::kStages;
  int* rows_s = reinterpret_cast<int*>(smem + L::kRows);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = Hq / Hkv, R = sq * G;
  const int lens_b = lens ? lens[b] : 0;
  const int row_start = q_starts ? q_starts[b] : uniform_start;
  // this row's live slots end at max(lens_b, row_start + sq) (the tail
  // window [width, row_start + j] may be empty): later slots are skipped
  const int tail_end = row_start + sq - 1 >= width ? row_start + sq : 0;
  const int row_end = max(lens_b, tail_end);
  const int s_begin = split * split_len;
  const int s_end = min(min(s_begin + split_len, last_pos + 1), row_end);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + kSlots - 1) / kSlots : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&k_full[st], kProducerThreads);  // one (cp.async) arrival per producer thread
      mbar_init(&v_full[st], kProducerThreads);  // (unused in int8-KV mode: k_full covers V)
      mbar_init(&empty[st], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup: the ring
    const int pt = threadIdx.x - kConsumerThreads;
    const char* kb = static_cast<const char*>(k_raw);
    const char* vb = static_cast<const char*>(v_raw);
    // each slot's cache row once a tile: through the table, or b*max_len + s; dead slots
    // (past this row's live end) are not looked up
    auto look_up = [&](int t) {
      producer_sync();  // every thread has issued the last tile's copies from rows_s
      for (int c = pt; c < kSlots; c += kProducerThreads) {
        const int s = s_begin + t * kSlots + c;
        int row = -1;
        if (s < s_end)
          row = block_tables ? block_tables[(size_t)b * n_log + s / page] * page + s % page : b * max_len + s;
        rows_s[c] = row;
      }
      producer_sync();
    };
    if constexpr (!kQuant) {
      // bf16: the copies land in the consumers' swizzled tiles
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % L::kStages;
        look_up(t);  // (the table reads overlap the wait)
        mbar_wait(&empty[st], ((t / L::kStages) & 1) ^ 1);  // the first round passes at once
        issue_tile<D, false>(smem + L::kK + st * L::kTileBytes, kb, rows_s, Hkv, kvh, pt);
        cp_async_mbar_arrive(&k_full[st]);
        issue_tile<D, false>(smem + L::kV + st * L::kTileBytes, vb, rows_s, Hkv, kvh, pt);
        cp_async_mbar_arrive(&v_full[st]);
      }
      cp_async_wait_all();
    } else {
      // int8-KV: int8 tiles land kLanding ahead; the producer widens each into the consumers'
      // bf16 tiles (K and V on k_full) while the consumers compute on the last one
      auto land = [&](int t) {
        if (t < n_tiles) {
          const int ls = t % L::kLanding;
          look_up(t);
          issue_tile<D, true>(smem + L::kLand + (2 * ls) * L::kRawBytes, kb, rows_s, Hkv, kvh, pt);
          issue_tile<D, true>(smem + L::kLand + (2 * ls + 1) * L::kRawBytes, vb, rows_s, Hkv, kvh, pt);
          const uint32_t sc = smem_u32(smem + L::kLandScales) + ls * 2 * kSlots * 4;
          for (int c = pt; c < kSlots; c += kProducerThreads) {
            const int row = rows_s[c];
            cp_async_4(sc + c * 4, row >= 0 ? k_scale + (size_t)row * Hkv + kvh : k_scale, row >= 0 ? 4 : 0);
            cp_async_4(sc + (kSlots + c) * 4, row >= 0 ? v_scale + (size_t)row * Hkv + kvh : v_scale,
                       row >= 0 ? 4 : 0);
          }
        }
        cp_async_commit();  // one group a tile (empty past the last)
      };
      for (int t = 0; t < L::kLanding; ++t) land(t);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % L::kStages, ls = t % L::kLanding;
        cp_async_wait_group<L::kLanding - 1>();  // this thread's copies of tile t have landed
        producer_sync();                          // and every producer thread's
        mbar_wait(&empty[st], ((t / L::kStages) & 1) ^ 1);
        widen_tile<D>(smem + L::kK + st * L::kTileBytes, smem + L::kLand + (2 * ls) * L::kRawBytes, pt);
        widen_tile<D>(smem + L::kV + st * L::kTileBytes, smem + L::kLand + (2 * ls + 1) * L::kRawBytes, pt);
        const float* from = reinterpret_cast<const float*>(smem + L::kLandScales) + ls * 2 * kSlots;
        float* to = reinterpret_cast<float*>(smem + L::kScales) + st * 2 * kSlots;
        for (int c = pt; c < 2 * kSlots; c += kProducerThreads) to[c] = from[c];
        fence_proxy_async_shared();  // the widened tiles are read by wgmma
        mbar_arrive(&k_full[st]);
        producer_sync();  // the landing stage is read: refill it
        land(t + L::kLanding);
      }
    }
    return;
  }

  // consumer warpgroup
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  float* red = reinterpret_cast<float*>(smem + L::kRed);

  // Q rows r = j*G + gi <- q[b, j, kvh*G + gi, :] as the K-major B operand; rows >= R are zeros.
  // Every load is issued before the first store: one round trip to memory, not N*D/1024.
  constexpr int kQChunks = (N * (D / 8) + kConsumerThreads - 1) / kConsumerThreads;
  uint4 qv[kQChunks];
#pragma unroll
  for (int k = 0; k < kQChunks; ++k) {
    const int i = tid + k * kConsumerThreads, r = i / (D / 8), ch = i % (D / 8);
    qv[k] = r < R ? *reinterpret_cast<const uint4*>(q + ((size_t)(b * sq + r / G) * Hq + kvh * G + r % G) * D + ch * 8)
                  : make_uint4(0, 0, 0, 0);  // (i past N rows: r >= N >= R)
  }
#pragma unroll
  for (int k = 0; k < kQChunks; ++k) {
    const int i = tid + k * kConsumerThreads;
    if (i < N * (D / 8))
      *reinterpret_cast<uint4*>(smem + L::kQ + swz(i / (D / 8), i % (D / 8), L::kQPanelBytes)) = qv[k];
  }
  fence_proxy_async_shared();  // read by wgmma (the async proxy)
  named_barrier_sync(1, kConsumerThreads);

  const uint32_t q_addr = smem_u32(smem + L::kQ), p_addr = smem_u32(smem + L::kP);
  float o[L::kPanels][N / 2];
#pragma unroll
  for (int pd = 0; pd < L::kPanels; ++pd) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) o[pd][i] = 0.f;
  }
  // column c = 2*j + e1 of this thread is query row 8*j + 2*t4 + e1
  float m_run[kCols], l_run[kCols];
  int lens_c[kCols], last_c[kCols];  // column c's live window: s < lens_c or width <= s <= last_c
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    m_run[c] = -INFINITY;
    l_run[c] = 0.f;  // this thread's share of the row sum (its two slots of every tile)
    const int r = 8 * (c >> 1) + 2 * t4 + (c & 1);
    lens_c[c] = r < R ? lens_b : 0;  // a padding row r >= R has no live slot
    last_c[c] = r < R ? row_start + r / G : -1;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % L::kStages;
    const uint32_t parity = (t / L::kStages) & 1;
    const int ts = s_begin + t * kSlots;
    const uint32_t k_addr = smem_u32(smem + L::kK + st * L::kTileBytes);
    const uint32_t v_addr = smem_u32(smem + L::kV + st * L::kTileBytes);
    float ks[2] = {1.f, 1.f}, vs[2] = {1.f, 1.f};
    mbar_wait(&k_full[st], parity);
    if constexpr (kQuant) {  // K and V widened; the producer fenced its stores for wgmma
      const float* sc = reinterpret_cast<const float*>(smem + L::kScales) + st * 2 * kSlots;
      ks[0] = sc[16 * warp + g];
      ks[1] = sc[16 * warp + g + 8];
      vs[0] = sc[kSlots + 16 * warp + g];
      vs[1] = sc[kSlots + 16 * warp + g + 8];
    } else {
      fence_proxy_async_shared();  // cp.async wrote through the generic proxy
    }

    // S^T = K.Q^T over D: A = the K tile (K-major), B = Q (K-major)
    float s[N / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<N, 0>(s, sw128_desc(k_addr + (kk / 4) * L::kPanelBytes + (kk % 4) * 32, 16, 1024),
                     sw128_desc(q_addr + (kk / 4) * L::kQPanelBytes + (kk % 4) * 32, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // mask, dequantize K, scale into the exp2 domain; s[4j + e] is slot 16*warp + g (+8 for
    // e >= 2) of the tile and query row 8j + 2*t4 + (e & 1)
    float cmax[kCols];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = ts + 16 * warp + g + (e >= 2 ? 8 : 0), c = 2 * j + (e & 1);
        const bool live = slot < s_end && (slot < lens_c[c] || (slot >= width && slot <= last_c[c]));
        float x = s[4 * j + e];
        if (kQuant) x *= ks[e >> 1];  // deferred dequant of K: exact, the scale is constant along D
        s[4 * j + e] = live ? x * qk_scale : -INFINITY;
      }
      cmax[2 * j] = fmaxf(s[4 * j], s[4 * j + 2]);
      cmax[2 * j + 1] = fmaxf(s[4 * j + 1], s[4 * j + 3]);
    }
    // the tile's column maxima: over the warp's 16 slots by shuffles, over the 4 warps in smem
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      cmax[c] = fmaxf(cmax[c], __shfl_xor_sync(0xffffffff, cmax[c], 4));
      cmax[c] = fmaxf(cmax[c], __shfl_xor_sync(0xffffffff, cmax[c], 8));
      cmax[c] = fmaxf(cmax[c], __shfl_xor_sync(0xffffffff, cmax[c], 16));
    }
    if (g == 0) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) red[warp * N + 8 * (c >> 1) + 2 * t4 + (c & 1)] = cmax[c];
    }
    named_barrier_sync(4, kConsumerThreads);
    float alpha[kCols], m_use[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = 8 * (c >> 1) + 2 * t4 + (c & 1);
      const float tmax = fmaxf(fmaxf(red[col], red[N + col]), fmaxf(red[2 * N + col], red[3 * N + col]));
      const float m_new = fmaxf(m_run[c], tmax);
      m_use[c] = (m_new == -INFINITY) ? 0.f : m_new;  // nothing live yet: p = alpha = 0
      alpha[c] = exp2f(m_run[c] - m_use[c]);
      m_run[c] = m_new;
    }
    // p; the sums take it unscaled; P^T (times v_scale, rounded to bf16) for the P.V product
    unsigned char* pt = smem + L::kP;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int c = 2 * j + e1, r = 8 * j + 2 * t4 + e1;
        const float p0 = exp2f(s[4 * j + e1] - m_use[c]);
        const float p1 = exp2f(s[4 * j + 2 + e1] - m_use[c]);
        l_run[c] = l_run[c] * alpha[c] + (p0 + p1);
        const int sl0 = 16 * warp + g;  // and sl0 + 8: chunk (sl0 >> 3) + 1
        *reinterpret_cast<__nv_bfloat16*>(pt + r * 128 + ((((sl0 >> 3)) ^ (r & 7)) << 4) + (sl0 & 7) * 2) =
            __float2bfloat16_rn(kQuant ? p0 * vs[0] : p0);
        *reinterpret_cast<__nv_bfloat16*>(pt + r * 128 + ((((sl0 >> 3) + 1) ^ (r & 7)) << 4) + (sl0 & 7) * 2) =
            __float2bfloat16_rn(kQuant ? p1 * vs[1] : p1);
      }
    }
#pragma unroll
    for (int pd = 0; pd < L::kPanels; ++pd) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[pd][4 * j + e] *= alpha[2 * j + (e & 1)];
      }
    }
    fence_proxy_async_shared();
    named_barrier_sync(5, kConsumerThreads);  // all of P^T is written
    if (!kQuant) {
      mbar_wait(&v_full[st], parity);
      fence_proxy_async_shared();
    }

    // O^T += V^T.P^T over the tile's 64 slots: A = V (MN-major, one panel per 64 of D), B = P^T
    wgmma_fence();
#pragma unroll
    for (int pd = 0; pd < L::kPanels; ++pd) {
#pragma unroll
      for (int kk = 0; kk < kSlots / 16; ++kk) {
        wgmma_ss<N, 1>(o[pd], sw128_desc(v_addr + pd * L::kPanelBytes + kk * 2048, L::kPanelBytes, 1024),
                       sw128_desc(p_addr + kk * 32, 16, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pd = 0; pd < L::kPanels; ++pd) fence_operands(o[pd]);
    mbar_arrive(&empty[st]);  // this thread is done with the stage's K and V
  }

  // the row sums: over the warp's lanes, then the four warps in order
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    l_run[c] += __shfl_xor_sync(0xffffffff, l_run[c], 4);
    l_run[c] += __shfl_xor_sync(0xffffffff, l_run[c], 8);
    l_run[c] += __shfl_xor_sync(0xffffffff, l_run[c], 16);
  }
  if (g == 0) {  // every warp read red for the last time before the last tile's barrier 5
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[warp * N + 8 * (c >> 1) + 2 * t4 + (c & 1)] = l_run[c];
  }
  named_barrier_sync(5, kConsumerThreads);
  float l_tot[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = 8 * (c >> 1) + 2 * t4 + (c & 1);
    l_tot[c] = ((red[col] + red[N + col]) + red[2 * N + col]) + red[3 * N + col];
  }

  // o[pd][4j + e] is head-dim row 64*pd + 16*warp + g (+8 for e >= 2), query row 8j + 2*t4 + (e & 1)
  if (n_splits == 1) {
    // o / l as bf16 rows in shared memory (the idle ring; rows padded against bank conflicts),
    // then each query row's D values as 16-byte stores
    constexpr int kRowElems = D + 8;
    __nv_bfloat16* o_s = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);  // [N][kRowElems]
    float inv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) inv[c] = 1.f / fmaxf(l_tot[c], 1e-30f);
#pragma unroll
    for (int pd = 0; pd < L::kPanels; ++pd) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t4 + (e & 1), d = 64 * pd + 16 * warp + g + (e >= 2 ? 8 : 0);
          o_s[r * kRowElems + d] = __float2bfloat16_rn(o[pd][4 * j + e] * inv[2 * j + (e & 1)]);
        }
      }
    }
    named_barrier_sync(6, kConsumerThreads);
    constexpr int kChunks = (N * D / 8 + kConsumerThreads - 1) / kConsumerThreads;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int i = tid + k * kConsumerThreads, r = i / (D / 8), ch = i % (D / 8);
      if (r < R)
        *reinterpret_cast<uint4*>(out + ((size_t)(b * sq + r / G) * Hq + kvh * G + r % G) * D + ch * 8) =
            *reinterpret_cast<const uint4*>(o_s + r * kRowElems + ch * 8);
    }
    return;
  }

  // several splits: write this split's partials, then the last CTA of (b, kvh) merges
  const size_t pair_base = (size_t)(b * Hkv + kvh) * n_splits * R;
  const size_t base = pair_base + (size_t)split * R;
#pragma unroll
  for (int pd = 0; pd < L::kPanels; ++pd) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t4 + (e & 1), d = 64 * pd + 16 * warp + g + (e >= 2 ? 8 : 0);
        if (r < R) part_acc[(base + r) * D + d] = o[pd][4 * j + e];
      }
    }
  }
  if (warp == 0 && g == 0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int r = 8 * (c >> 1) + 2 * t4 + (c & 1);
      if (r < R) {
        part_ml[(base + r) * 2] = m_run[c];
        part_ml[(base + r) * 2 + 1] = l_tot[c];
      }
    }
  }
  __threadfence();
  named_barrier_sync(6, kConsumerThreads);
  int* merges = reinterpret_cast<int*>(smem + L::kFlag);
  if (tid == 0) *merges = atomicAdd(&arrivals[b * Hkv + kvh], 1u) == (unsigned)(n_splits - 1);
  named_barrier_sync(7, kConsumerThreads);
  if (!*merges) return;
  __threadfence();

  // the merge, in split order.  Every split's (m, l) is staged in shared memory with one load a
  // thread, then per row the max, each split's weight and the weighted l; then each thread sums
  // its output elements over the splits, one independent load per element a split, so a
  // split costs one round trip to L2 (other SMs wrote the partials: read through L2).
  float* w = reinterpret_cast<float*>(smem + L::kK);  // [n_splits][N] weights: the rings are idle now
  float* ml = w + kMaxSplits * N;                     // [n_splits][N][2] (m, l)
  float* l_merged = red;                              // [N]
  for (int i = tid; i < n_splits * R; i += kConsumerThreads) {
    const int sp = i / R, r = i % R;
    const float2 v = __ldcg(reinterpret_cast<const float2*>(part_ml) + pair_base + (size_t)sp * R + r);
    ml[(sp * N + r) * 2] = v.x;
    ml[(sp * N + r) * 2 + 1] = v.y;
  }
  named_barrier_sync(8, kConsumerThreads);
  for (int r = tid; r < R; r += kConsumerThreads) {
    float m = -INFINITY;
    for (int sp = 0; sp < n_splits; ++sp) m = fmaxf(m, ml[(sp * N + r) * 2]);
    float l = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float ms = ml[(sp * N + r) * 2];
      const float wt = (ms == -INFINITY) ? 0.f : exp2f(ms - m);
      w[sp * N + r] = wt;
      l = fmaf(ml[(sp * N + r) * 2 + 1], wt, l);
    }
    l_merged[r] = l;
  }
  named_barrier_sync(8, kConsumerThreads);
  constexpr int kElems = (N * D + kConsumerThreads - 1) / kConsumerThreads;  // this thread's (r, d)
  float acc[kElems];
#pragma unroll
  for (int k = 0; k < kElems; ++k) acc[k] = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) {
    const float* part = part_acc + (pair_base + (size_t)sp * R) * D;
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      const int i = tid + k * kConsumerThreads;
      if (i < R * D) acc[k] = fmaf(__ldcg(part + i), w[sp * N + i / D], acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kElems; ++k) {
    const int i = tid + k * kConsumerThreads, r = i / D, d = i % D;
    if (i < R * D)
      out[((size_t)(b * sq + r / G) * Hq + kvh * G + r % G) * D + d] =
          __float2bfloat16_rn(acc[k] / fmaxf(l_merged[r], 1e-30f));
  }
  if (tid == 0) arrivals[b * Hkv + kvh] = 0;  // ready for the next launch
}

// -- f32 q: the first design (CUDA-core partial pass + combine) --------------------------------

constexpr int kThreads = 128;
constexpr int kTile = 32;     // KV slots per shared-memory tile (one per lane)

__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
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
  unsigned int* arrivals;  // bf16 with several splits: the merge's counters
  int B, sq, Hq, Hkv, D, max_len, n_log, page, width, uniform_start, last_pos, split_len, n_splits;
  float qk_scale;
  cudaStream_t st;
};

// -- f32 launches --------------------------------------------------------------------------------

template <int D, bool kQuant, bool kPaged>
cudaError_t launch_partial(const Args& a) {
  using KV = typename std::conditional<kQuant, int8_t, float>::type;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem_once(smem_set, decode_partial_kernel<float, D, kQuant, kPaged>,
                                    (int)Layout<KV, D>::bytes(kMaxRows));
  if (err != cudaSuccess) return err;
  const size_t smem = Layout<KV, D>::bytes(a.sq * (a.Hq / a.Hkv));
  decode_partial_kernel<float, D, kQuant, kPaged><<<dim3(a.n_splits, a.Hkv, a.B), kThreads, smem, a.st>>>(
      static_cast<const float*>(a.q), a.k, a.v, a.k_scale, a.v_scale, a.lens, a.block_tables, a.q_starts,
      a.part_acc, a.part_ml, a.sq, a.Hq, a.Hkv, a.max_len, a.n_log, a.page, a.width, a.uniform_start, a.last_pos,
      a.split_len, a.qk_scale);
  return cudaGetLastError();
}

template <bool kQuant, bool kPaged>
cudaError_t launch_partial_d(const Args& a) {
  return a.D == 128 ? launch_partial<128, kQuant, kPaged>(a) : launch_partial<64, kQuant, kPaged>(a);
}

template <bool kQuant>
cudaError_t launch_partial_paged(const Args& a) {
  return a.block_tables ? launch_partial_d<kQuant, true>(a) : launch_partial_d<kQuant, false>(a);
}

cudaError_t launch_f32(const Args& a) {
  const cudaError_t err = a.k_scale ? launch_partial_paged<true>(a) : launch_partial_paged<false>(a);
  if (err != cudaSuccess) return err;
  decode_combine_kernel<float><<<dim3(a.Hkv, a.B), kThreads, 0, a.st>>>(
      a.part_acc, a.part_ml, static_cast<float*>(a.out), a.sq, a.Hq, a.Hkv, a.D, a.n_splits);
  return cudaGetLastError();
}

// -- bf16 launches -------------------------------------------------------------------------------

template <int D, bool kQuant, int N>
struct Hopper {
  using L = HopperLayout<D, kQuant, N>;
  static cudaError_t prepare() {
    static std::atomic<unsigned long long> smem_set{0};
    return allow_smem_once(smem_set, decode_hopper_kernel<D, kQuant, N>, L::kBytes);
  }
  static cudaError_t launch(const Args& a) {
    const cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    decode_hopper_kernel<D, kQuant, N><<<dim3(a.n_splits, a.Hkv, a.B), kHopperThreads, L::kBytes, a.st>>>(
        static_cast<const __nv_bfloat16*>(a.q), a.k, a.v, a.k_scale, a.v_scale, a.lens, a.block_tables, a.q_starts,
        static_cast<__nv_bfloat16*>(a.out), a.part_acc, a.part_ml, a.arrivals, a.sq, a.Hq, a.Hkv, a.max_len,
        a.n_log, a.page, a.width, a.uniform_start, a.last_pos, a.split_len, a.qk_scale);
    return cudaGetLastError();
  }
  static int ctas_per_sm() {
    int n = 0;
    if (prepare() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_hopper_kernel<D, kQuant, N>, kHopperThreads,
                                                      L::kBytes) != cudaSuccess)
      return -1;
    return n;
  }
  static int smem_bytes() { return L::kBytes; }
};

struct HopperOps {
  cudaError_t (*launch)(const Args&);
  int (*ctas_per_sm)();
  int (*smem_bytes)();
};

template <int D, bool kQuant, int N>
HopperOps hopper_ops_of() {
  using H = Hopper<D, kQuant, N>;
  return {&H::launch, &H::ctas_per_sm, &H::smem_bytes};
}

template <int D, bool kQuant>
HopperOps hopper_ops_n(int n) {
  switch (n) {
    case 8: return hopper_ops_of<D, kQuant, 8>();
    case 16: return hopper_ops_of<D, kQuant, 16>();
    case 32: return hopper_ops_of<D, kQuant, 32>();
    default: return hopper_ops_of<D, kQuant, 64>();
  }
}

// The instantiation for head dim D (64 or 128), q_len*G query rows (<= 64) and the cache type.
HopperOps hopper_ops(int D, bool quant, int rows) {
  const int n = cols_for(rows);
  if (D == 128) return quant ? hopper_ops_n<128, true>(n) : hopper_ops_n<128, false>(n);
  return quant ? hopper_ops_n<64, true>(n) : hopper_ops_n<64, false>(n);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
// [0, last_pos].  Split i covers slots [i*split_len, (i+1)*split_len).
// part_acc [B,Hkv,n_splits,sq*G,D] and part_ml [B,Hkv,n_splits,sq*G,2] f32
// workspace.  f32: split_len a multiple of 32, always followed by the
// combine kernel.  bf16: split_len a multiple of 64, n_splits <= 64, q, k,
// v and out 16-byte aligned; with n_splits 1 the workspace is not touched; with
// more, the B*Hkv uint32 words just before part_ml are the merge's arrival
// counters, which must be 0 before the launch and are 0 again after it (the
// caller keeps them in a persistent zeroed workspace).  qk_scale = softmax
// scale * log2(e).  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for inputs the kernels do not take.
int nexus_decode_attention(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
                           const void* lens, const void* block_tables, const void* q_starts, void* out,
                           void* part_acc, void* part_ml, int B, int sq, int Hq, int Hkv, int D, int max_len,
                           int n_log, int page, int width, int uniform_start, int last_pos, int split_len,
                           int n_splits, int dtype, float qk_scale, void* stream) {
  if (B <= 0 || B > 65535 || sq <= 0 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 || sq * (Hq / Hkv) > kMaxRows ||
      (D != 64 && D != 128) || (dtype != 0 && dtype != 1) || split_len <= 0 || split_len % kTile != 0 ||
      n_splits <= 0 || last_pos < 0 || last_pos >= max_len || (k_scale == nullptr) != (v_scale == nullptr) ||
      (block_tables != nullptr && (n_log <= 0 || page <= 0 || n_log * page != max_len)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (split_len % kSlots != 0 || n_splits > kMaxSplits || !aligned16(q) || !aligned16(k) ||
                     !aligned16(v) || !aligned16(out) || (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr))))
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
  a.arrivals = dtype == 1 && n_splits > 1 ? reinterpret_cast<unsigned int*>(part_ml) - (size_t)B * Hkv : nullptr;
  a.B = B; a.sq = sq; a.Hq = Hq; a.Hkv = Hkv; a.D = D; a.max_len = max_len; a.n_log = n_log; a.page = page;
  a.width = width; a.uniform_start = uniform_start; a.last_pos = last_pos; a.split_len = split_len;
  a.n_splits = n_splits;
  a.qk_scale = qk_scale;
  a.st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)hopper_ops(D, k_scale != nullptr, sq * (Hq / Hkv)).launch(a);
  return (int)launch_f32(a);
}

// The bf16 kernel for head dim D, `rows` = q_len*G query rows and the cache type (int8 != 0:
// int8-KV): its dynamic shared memory in bytes, and the CTAs an SM holds on the current device
// (the split plan's input); -1 for shapes it does not take or a failed query.
int nexus_decode_smem_bytes(int D, int rows, int int8) {
  if ((D != 64 && D != 128) || rows <= 0 || rows > kMaxRows) return -1;
  return hopper_ops(D, int8 != 0, rows).smem_bytes();
}

int nexus_decode_ctas_per_sm(int D, int rows, int int8) {
  if ((D != 64 && D != 128) || rows <= 0 || rows > kMaxRows) return -1;
  return hopper_ops(D, int8 != 0, rows).ctas_per_sm();
}

}  // extern "C"
