// Grouped matmul for MoE experts on Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes; see tpu_nexus_torch/ops/_build.py).
//
// Replaces: tpu_nexus/ops/grouped_matmul.py::_gmm_kernel (launched by
// _gmm_raw) and ::_tgmm_kernel (launched by _tgmm_raw inside _gmm_bwd).
// Rows of lhs [M,K] are sorted by expert, each expert's run padded to a
// multiple of block_m, and tile_expert [M/block_m] names each row tile's
// expert.
//  * gmm (#7):  out[M,N] = lhs[tile] . B_e, with B_e = rhs[e] [K,N], or
//    with trans_rhs B_e = rhs[e]^T for rhs [E,N,K] (the backward's d_lhs,
//    read in place, no transposed copy); f32 sums, out in lhs's dtype.
//  * tgmm (#8): out[e] [K,N] f32 = sum over the tiles t of expert e of
//    lhs[t]^T . dout[t]; zero for an expert with no tile.
//
// What bounds them on this card: at the nexus_moe train step (M 36864,
// K 1024, N 2048, 8 experts) each call does 155 GFLOP on ~260-290 MB, some
// 600 FLOP per byte, twice the H100's bf16 ridge: the tensor cores are the
// bound (0.156 ms at 989 TFLOP/s), and only wgmma reaches their full rate.
//
// Design (bf16): one persistent CTA an SM (shared memory allows one) of
// three warpgroups, warp-specialised on the building blocks of
// csrc/hopper.cuh; each CTA walks work units grid-stride:
//  * a producer warpgroup gives up registers (setmaxnreg) and one thread of
//    it issues TMA into a ring of stages (3 in gmm, 4 in tgmm), each a
//    64-deep slab of the contraction (A 16 KB, B 32 KB, 128-byte swizzle)
//    completed on a full mbarrier and freed by an empty one.  The ring runs
//    across work units, so a unit's first loads overlap the previous one's
//    last products and its epilogue.
//  * two consumer warpgroups (setmaxnreg 232) own 64 rows each of a
//    128 x 256 output tile: per slab, four wgmma m64n256k16 from shared
//    memory into 128 f32 accumulators a thread; one slab's products stay in
//    flight while the next is issued, and a stage is freed once its
//    products have retired.
//  * gmm's epilogue rounds the tile to bf16 into a 64 KB staging tile in
//    the output map's swizzle, and one thread of each warpgroup hands it to
//    TMA stores that drain while the next tile's products run (the
//    nexus_moe gate/up took 0.320 ms with stores straight from the
//    registers, 0.210 so: PERF.md).  tgmm writes its f32 block from the
//    registers, once a unit of up to thousands of rows.
//  * operands are read in place through tensor maps (make_matrix_map), no
//    layout copied: gmm's A is lhs (K-major, a 2-D map); B is rhs through a
//    3-D map whose third coordinate is the expert, so one map serves every
//    expert, read MN-major ([E,K,N], the transpose bit) or K-major
//    ([E,N,K], trans_rhs).  tgmm contracts over rows: A = lhs^T and B = dout,
//    both MN-major from 64-row slabs of lhs and dout.  TMA zero-fills past
//    K, N and each expert's matrix, so ragged widths need no padding; TMA
//    stores stop at the ragged edge, tgmm's stores are guarded.
//  * gmm: a unit is a 128 x 256 output tile, walked in the grouped raster
//    (kGroupM row tiles x every column tile), so a group's lhs rows and its
//    experts' weight columns are reused from the 50 MB L2.  Both roles read
//    the tile's expert from tile_expert (the TPU's scalar prefetch); a
//    128-row tile never straddles two experts because block_m is a multiple
//    of 128.  An expert id outside [0,E) writes zeros and both roles skip
//    its slabs.
//  * tgmm: a unit is (expert, 128-row k tile, 256-column n tile); the CTA
//    contracts over every row of the expert's tiles, 64 rows a slab, keeps
//    the f32 sum in registers and writes each output element once: no
//    atomics, no split, bit-identical run to run.  The TPU carries the sum
//    across its sequential grid; here the loop over the expert's tiles is
//    inside the CTA.  The tiles are found by a forward scan of tile_expert
//    (next_tile), which sums every tile of e whatever the map's order, as
//    _tgmm_ref does.  Units run heaviest expert first (experts ranked by
//    their tile count in each CTA's prologue, up to kRankE experts; more
//    run in expert order), so uneven runs do not leave one CTA last; an
//    expert with no tile writes a zero block without entering the ring.
// Left for later: ping-pong consumers (each on its own tile), clusters with
// multicast, stream-K for tgmm's last wave, fp8.
//
// f32 inputs take CUDA-core kernels in this file (full f32, not TF32): a
// 64x64 tile per 256-thread CTA, 4x4 outputs a thread, 16-deep stages,
// masked loads at ragged K and N.  Rows must be 16-byte aligned and M a
// multiple of block_m (the wrapper checks).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace nexus_hopper;

typedef __nv_bfloat16 bf16;

constexpr int kGroupM = 8;  // gmm row tiles per L2 group (both dtypes)

// First tile index >= from whose expert is e, or nt.
__device__ __forceinline__ int next_tile(const int* __restrict__ tile_expert, int nt, int e, int from) {
  for (int i = from; i < nt; ++i)
    if (__ldg(tile_expert + i) == e) return i;
  return nt;
}

// ---- bf16: the Hopper kernels -------------------------------------------------

constexpr int kBM = 128;  // output rows a unit: two consumer warpgroups of 64
constexpr int kBN = 256;  // output columns a unit: wgmma m64n256k16
constexpr int kBK = 64;   // contraction depth a stage: one 128-byte swizzle span of bf16
constexpr int kGmmStages = 3;   // gmm: the ring and a 64 KB output staging tile
constexpr int kTgmmStages = 4;  // tgmm: the ring only (its f32 block is written once a unit)
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 40*128 + 232*256 <= 65536
constexpr int kPanel = kBK * 128;         // 64 rows x 128 bytes: one box
constexpr int kABytes = kBM * kBK * 2;    // 16 KB: gmm 128 rows x 64 deep; tgmm 64 deep x 128
constexpr int kBBytes = kBN * kBK * 2;    // 32 KB: 256 columns x 64 deep
constexpr int kRankE = 256;               // tgmm ranks up to this many experts by work

template <int kStages>
struct Ring {  // byte offsets from a 1024-byte-aligned base
  static constexpr int kA = 0;
  static constexpr int kB = kStages * kABytes;
  static constexpr int kBar = kB + kStages * kBBytes;  // full[kStages], empty[kStages]
  static constexpr int kEnd = kBar + 2 * kStages * 8;
};
struct GmmSmem : Ring<kGmmStages> {
  static constexpr int kOut = (kEnd + 1023) / 1024 * 1024;  // [2 warpgroups][4 panels] of 64 x 64 bf16
  static constexpr int kBytes = kOut + kBM * kBN * 2 + 1024;  // + alignment slack
};
struct TgmmSmem : Ring<kTgmmStages> {
  static constexpr int kTable = kEnd;  // tiles, first, order [kRankE] (int)
  static constexpr int kBytes = kTable + 3 * kRankE * 4 + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

template <int kStages>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  for (int st = 0; st < kStages; ++st) {
    mbar_init(&full[st], 1);
    mbar_init(&empty[st], kConsumerThreads);
  }
  fence_barrier_init();
}

// Ring slab `it` (counted across units): its stage and the parity of its round.
template <int kStages>
__device__ __forceinline__ int stage_of(int it) { return it % kStages; }
template <int kStages>
__device__ __forceinline__ uint32_t round_of(int it) { return (it / kStages) & 1; }

// The consumers' side of one slab: wait for it, issue its four k-steps (the first of a unit
// overwrites the accumulators), keep them in flight, and free the previous slab's stage once its
// products have retired.  desc_a/desc_b give a k-step's descriptors for the stage's A and B.
template <int kStages, int kTransA, int kTransB, typename DescA, typename DescB>
__device__ __forceinline__ void consume_slab(float (&acc)[kBN / 2], uint64_t* full, uint64_t* empty, int it,
                                             bool first, DescA desc_a, DescB desc_b) {
  const int st = stage_of<kStages>(it);
  mbar_wait(&full[st], round_of<kStages>(it));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_ss<kBN, kTransA, kTransB>(acc, desc_a(st, kk), desc_b(st, kk), !(first && kk == 0));
  wgmma_commit();
  wgmma_wait<1>();
  if (!first) mbar_arrive(&empty[stage_of<kStages>(it - 1)]);
}

// After a unit's last slab `it - 1`: wait for every product, free its stage.
template <int kStages>
__device__ __forceinline__ void drain(float (&acc)[kBN / 2], uint64_t* empty, int it) {
  wgmma_wait<0>();
  fence_operands(acc);
  mbar_arrive(&empty[stage_of<kStages>(it - 1)]);
}

// Unit `tile` of gmm's grouped raster: kGroupM row tiles x every column tile per group.
__device__ __forceinline__ void gmm_origin(int tile, int num_m, int num_n, int& m0, int& n0) {
  const int group = tile / (kGroupM * num_n);
  const int first_m = group * kGroupM;
  const int group_m = min(num_m - first_m, kGroupM);
  const int in_group = tile % (kGroupM * num_n);
  m0 = (first_m + in_group % group_m) * kBM;
  n0 = (in_group / group_m) * kBN;
}

// ---- kernel #7, bf16 ----------------------------------------------------------

// tm_lhs: lhs [M,K], boxes of 128 rows.  tm_rhs: rhs [E,K,N] with boxes of 64 rows (MN-major
// B, four boxes a slab), or with kTransB rhs [E,N,K] with boxes of 256 rows (K-major B).
// tm_out: out [M,N], boxes of 64 rows (one 64 x 64 panel of a warpgroup's staged rows).
template <bool kTransB>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_bf16_kernel(const __grid_constant__ CUtensorMap tm_lhs, const __grid_constant__ CUtensorMap tm_rhs,
                    const __grid_constant__ CUtensorMap tm_out, const int* __restrict__ tile_expert, int M,
                    int K, int N, int E, int block_m) {
  constexpr int S = kGmmStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GmmSmem::kBar);
  uint64_t* empty = full + S;
  const int num_m = M / kBM, num_n = (N + kBN - 1) / kBN, units = num_m * num_n;
  const int slabs = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) init_ring<S>(full, empty);
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup: one thread issues every load
    warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      prefetch_tensor_map(&tm_lhs);
      prefetch_tensor_map(&tm_rhs);
      int it = 0;
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
        int m0, n0;
        gmm_origin(unit, num_m, num_n, m0, n0);
        const int e = __ldg(tile_expert + m0 / block_m);
        if (e < 0 || e >= E) continue;  // the consumers write zeros
        for (int kb = 0; kb < slabs; ++kb, ++it) {
          const int st = stage_of<S>(it);
          mbar_wait(&empty[st], round_of<S>(it) ^ 1);  // the first round passes at once
          mbar_arrive_expect_tx(&full[st], kABytes + kBBytes);
          tma_load_3d(smem + GmmSmem::kA + st * kABytes, &tm_lhs, &full[st], kb * kBK, m0, 0);
          unsigned char* b = smem + GmmSmem::kB + st * kBBytes;
          if (kTransB) {
            tma_load_3d(b, &tm_rhs, &full[st], kb * kBK, n0, e);
          } else {
#pragma unroll
            for (int p = 0; p < kBN / 64; ++p)
              tma_load_3d(b + p * kPanel, &tm_rhs, &full[st], n0 + p * 64, kb * kBK, e);
          }
        }
      }
    }
  } else {
    // consumer warpgroups: 64 rows each of a 128 x 256 tile
    warpgroup_reg_alloc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;  // issues this warpgroup's output stores
    const uint32_t a_base = smem_u32(smem + GmmSmem::kA) + wg * 64 * 128;  // this warpgroup's 64 rows
    const uint32_t b_base = smem_u32(smem + GmmSmem::kB);
    unsigned char* staged = smem + GmmSmem::kOut + wg * (kBN / 64) * kPanel;  // 4 panels of 64 x 64
    auto desc_a = [&](int st, int kk) { return sw128_desc(a_base + st * kABytes + kk * 32, 16, 1024); };
    auto desc_b = [&](int st, int kk) {
      return kTransB ? sw128_desc(b_base + st * kBBytes + kk * 32, 16, 1024)
                     : sw128_desc(b_base + st * kBBytes + kk * 2048, kPanel, 1024);
    };
    int it = 0;
    for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
      int m0, n0;
      gmm_origin(unit, num_m, num_n, m0, n0);
      const int e = __ldg(tile_expert + m0 / block_m);
      const bool live = e >= 0 && e < E;
      float acc[kBN / 2];
      if (live) {
        for (int kb = 0; kb < slabs; ++kb, ++it)
          consume_slab<S, 0, (kTransB ? 0 : 1)>(acc, full, empty, it, kb == 0, desc_a, desc_b);
        drain<S>(acc, empty, it);
      }
      // Epilogue: the rows round to bf16 into this warpgroup's staging panels (the 128-byte
      // swizzle of the output map, conflict-free), then TMA stores them while the next tile's
      // products run; the staging is reused once the previous stores have read it.  Zeros for a
      // tile whose expert is outside [0, E), selected here: an instruction other than wgmma
      // that wrote the accumulators would make ptxas serialize the wgmma.
      if (leader) bulk_wait_group_read<0>();
      named_barrier_sync(1 + wg, 128);
      const int g = lane / 4, r = warp * 16 + g;  // accumulator rows r and r + 8, columns 8j + 2t
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        uint32_t* p = reinterpret_cast<uint32_t*>(staged + (j / 8) * kPanel + r * 128 + ((j % 8) ^ g) * 16) +
                      lane % 4;
        p[0] = live ? pack_bf16(acc[4 * j], acc[4 * j + 1]) : 0u;
        p[8 * 128 / 4] = live ? pack_bf16(acc[4 * j + 2], acc[4 * j + 3]) : 0u;
      }
      fence_proxy_async_shared();
      named_barrier_sync(1 + wg, 128);
      if (leader) {
#pragma unroll
        for (int p = 0; p < kBN / 64; ++p)
          if (n0 + p * 64 < N) tma_store_3d(&tm_out, staged + p * kPanel, n0 + p * 64, m0 + wg * 64, 0);
        bulk_commit_group();
      }
    }
    if (leader) bulk_wait_group<0>();
  }
}

// ---- kernel #8, bf16 ----------------------------------------------------------

// Tiles of expert e: from the prologue's table, or counted by a scan when E > kRankE.
__device__ __forceinline__ int tiles_of(const int* __restrict__ tile_expert, const int* table, int nt, int E,
                                        int e) {
  if (E <= kRankE) return table[e];
  int n = 0;
  for (int i = 0; i < nt; ++i) n += __ldg(tile_expert + i) == e;
  return n;
}

// tm_lhs: lhs [M,K] and tm_dout: dout [M,N], boxes of 64 rows (one slab: two lhs boxes, four
// dout boxes).  out [E,K,N] f32.
__global__ void __launch_bounds__(kThreads, 1)
    tgmm_bf16_kernel(const __grid_constant__ CUtensorMap tm_lhs, const __grid_constant__ CUtensorMap tm_dout,
                     const int* __restrict__ tile_expert, float* __restrict__ out, int M, int K, int N, int E,
                     int block_m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  constexpr int S = kTgmmStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TgmmSmem::kBar);
  uint64_t* empty = full + S;
  int* tiles = reinterpret_cast<int*>(smem + TgmmSmem::kTable);  // tiles[e]: expert e's tile count
  int* first = tiles + kRankE;                                // first[e]: its first tile (nt: none)
  int* order = first + kRankE;                                // order[r]: the r-th heaviest expert
  const int nt = M / block_m;
  const int num_k = (K + kBM - 1) / kBM, num_n = (N + kBN - 1) / kBN, per_expert = num_k * num_n;
  const int units = E * per_expert;
  const int slabs_per_tile = block_m / kBK;

  const bool ranked = E <= kRankE;
  if (threadIdx.x == 0) init_ring<S>(full, empty);
  if (ranked) {  // count each expert's tiles, find its first, rank heaviest first (ties by id)
    for (int e = threadIdx.x; e < E; e += kThreads) {
      tiles[e] = 0;
      first[e] = nt;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += kThreads) {
      const int e = __ldg(tile_expert + i);
      if (e >= 0 && e < E) {
        atomicAdd(&tiles[e], 1);
        atomicMin(&first[e], i);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += kThreads) {
      const int c = tiles[e];
      int rank = 0;
      for (int x = 0; x < E; ++x) rank += tiles[x] > c || (tiles[x] == c && x < e);
      order[rank] = e;
    }
  }
  __syncthreads();
  auto unit_origin = [&](int unit, int& e, int& k0, int& n0) {
    const int r = unit / per_expert, rest = unit % per_expert;
    e = ranked ? order[r] : r;
    k0 = (rest / num_n) * kBM;
    n0 = (rest % num_n) * kBN;
  };

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup: one thread issues every load
    warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      prefetch_tensor_map(&tm_lhs);
      prefetch_tensor_map(&tm_dout);
      int it = 0;
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
        int e, k0, n0;
        unit_origin(unit, e, k0, n0);
        // the expert's tiles in map order; with the table the walk stops at the last one (no
        // scan to the map's end), without it the scan ends the walk
        const int count = ranked ? tiles[e] : nt;
        int t = ranked ? first[e] : next_tile(tile_expert, nt, e, 0);
        for (int found = 0; t < nt && found < count; ++found) {
          for (int s = 0; s < slabs_per_tile; ++s, ++it) {
            const int st = stage_of<S>(it), r0 = t * block_m + s * kBK;
            mbar_wait(&empty[st], round_of<S>(it) ^ 1);
            mbar_arrive_expect_tx(&full[st], kABytes + kBBytes);
            unsigned char* a = smem + TgmmSmem::kA + st * kABytes;
            unsigned char* b = smem + TgmmSmem::kB + st * kBBytes;
#pragma unroll
            for (int p = 0; p < kBM / 64; ++p) tma_load_3d(a + p * kPanel, &tm_lhs, &full[st], k0 + p * 64, r0, 0);
#pragma unroll
            for (int p = 0; p < kBN / 64; ++p)
              tma_load_3d(b + p * kPanel, &tm_dout, &full[st], n0 + p * 64, r0, 0);
          }
          if (found + 1 < count) t = next_tile(tile_expert, nt, e, t + 1);
        }
      }
    }
  } else {
    // consumer warpgroups: 64 output rows each of a 128 x 256 block
    warpgroup_reg_alloc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    // A = lhs^T: this warpgroup's 64 output rows are the slab's lhs panel wg, read MN-major
    const uint32_t a_base = smem_u32(smem + TgmmSmem::kA) + wg * kPanel;
    const uint32_t b_base = smem_u32(smem + TgmmSmem::kB);
    auto desc_a = [&](int st, int kk) { return sw128_desc(a_base + st * kABytes + kk * 2048, kPanel, 1024); };
    auto desc_b = [&](int st, int kk) { return sw128_desc(b_base + st * kBBytes + kk * 2048, kPanel, 1024); };
    int it = 0;
    for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
      int e, k0, n0;
      unit_origin(unit, e, k0, n0);
      const int slabs = tiles_of(tile_expert, tiles, nt, E, e) * slabs_per_tile;
      float acc[kBN / 2];
      if (slabs > 0) {
        for (int s = 0; s < slabs; ++s, ++it) consume_slab<S, 1, 1>(acc, full, empty, it, s == 0, desc_a, desc_b);
        drain<S>(acc, empty, it);
      }
      // an expert with no tile: a zero block (selected, as in gmm's epilogue)
      const bool live = slabs > 0;
      const int row = k0 + wg * 64 + warp * 16 + lane / 4;
      float* o = out + static_cast<long long>(e) * K * N;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col < N) {
          if (row < K)
            *reinterpret_cast<float2*>(o + static_cast<long long>(row) * N + col) =
                live ? make_float2(acc[4 * j], acc[4 * j + 1]) : make_float2(0.f, 0.f);
          if (row + 8 < K)
            *reinterpret_cast<float2*>(o + static_cast<long long>(row + 8) * N + col) =
                live ? make_float2(acc[4 * j + 2], acc[4 * j + 3]) : make_float2(0.f, 0.f);
        }
      }
    }
  }
}

// ---- f32: CUDA cores ----------------------------------------------------------

constexpr int kFThreads = 256;  // f32: 16 x 16 threads, 4 x 4 outputs each
constexpr int kFTile = 64;
constexpr int kFDepth = 16;
constexpr int kFPad = 4;

// One 16-deep stage: As[k][m] and Bs[k][n], pitch kFTile + kFPad; thread
// (tx, ty) owns rows ty*4.. and columns tx*4.. of the 64x64 tile.
__device__ __forceinline__ void fma_stage(float (&acc)[4][4], const float* As, const float* Bs, int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < kFDepth; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(As + kk * (kFTile + kFPad) + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(Bs + kk * (kFTile + kFPad) + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p, bool valid) {
  return valid ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Store 4 floats of one global row into column `col` of 4 shared rows
// (the transposing store: k runs along the global row).
__device__ __forceinline__ void store_col(float* s, int col, float4 v) {
  s[0 * (kFTile + kFPad) + col] = v.x;
  s[1 * (kFTile + kFPad) + col] = v.y;
  s[2 * (kFTile + kFPad) + col] = v.z;
  s[3 * (kFTile + kFPad) + col] = v.w;
}

template <bool kTransB>
__global__ void __launch_bounds__(kFThreads)
    gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs, const int* __restrict__ tile_expert,
                   float* __restrict__ out, int M, int K, int N, int E, int block_m) {
  __shared__ __align__(16) float As[kFDepth * (kFTile + kFPad)];
  __shared__ __align__(16) float Bs[kFDepth * (kFTile + kFPad)];

  const int num_m = M / kFTile, num_n = (N + kFTile - 1) / kFTile;
  const int tile = blockIdx.x;
  const int group = tile / (kGroupM * num_n);
  const int first_m = group * kGroupM;
  const int group_m = min(num_m - first_m, kGroupM);
  const int in_group = tile % (kGroupM * num_n);
  const int m0 = (first_m + in_group % group_m) * kFTile;
  const int n0 = (in_group / group_m) * kFTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int e = __ldg(tile_expert + m0 / block_m);

  float acc[4][4] = {};
  if (e >= 0 && e < E) {
    const float* w = rhs + static_cast<long long>(e) * K * N;
    for (int k0 = 0; k0 < K; k0 += kFDepth) {
      {  // A: lhs [m][k] -> As[k][m]
        const int m = tid >> 2, k4 = (tid & 3) * 4;
        store_col(As + k4 * (kFTile + kFPad), m,
                  load4(lhs + static_cast<long long>(m0 + m) * K + k0 + k4, k0 + k4 < K));
      }
      if (kTransB) {  // B^T stored [n][k] -> Bs[k][n]
        const int n = tid >> 2, k4 = (tid & 3) * 4;
        store_col(Bs + k4 * (kFTile + kFPad), n,
                  load4(w + static_cast<long long>(n0 + n) * K + k0 + k4, n0 + n < N && k0 + k4 < K));
      } else {  // B stored [k][n]
        const int k = tid >> 4, n4 = (tid & 15) * 4;
        *reinterpret_cast<float4*>(Bs + k * (kFTile + kFPad) + n4) =
            load4(w + static_cast<long long>(k0 + k) * N + n0 + n4, k0 + k < K && n0 + n4 < N);
      }
      __syncthreads();
      fma_stage(acc, As, Bs, tx, ty);
      __syncthreads();
    }
  }
  const int col = n0 + tx * 4;
  if (col < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(out + static_cast<long long>(m0 + ty * 4 + i) * N + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

__global__ void __launch_bounds__(kFThreads)
    tgmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ dout, const int* __restrict__ tile_expert,
                    float* __restrict__ out, int M, int K, int N, int block_m) {
  __shared__ __align__(16) float As[kFDepth * (kFTile + kFPad)];
  __shared__ __align__(16) float Bs[kFDepth * (kFTile + kFPad)];

  const int n0 = blockIdx.x * kFTile, k0 = blockIdx.y * kFTile, e = blockIdx.z;
  const int nt = M / block_m;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int tile = next_tile(tile_expert, nt, e, 0); tile < nt; tile = next_tile(tile_expert, nt, e, tile + 1)) {
    for (int r0 = tile * block_m; r0 < (tile + 1) * block_m; r0 += kFDepth) {
      const int r = tid >> 4, c4 = (tid & 15) * 4;
      // A = lhs^T: lhs rows are the contraction, its columns the output rows
      *reinterpret_cast<float4*>(As + r * (kFTile + kFPad) + c4) =
          load4(lhs + static_cast<long long>(r0 + r) * K + k0 + c4, k0 + c4 < K);
      *reinterpret_cast<float4*>(Bs + r * (kFTile + kFPad) + c4) =
          load4(dout + static_cast<long long>(r0 + r) * N + n0 + c4, n0 + c4 < N);
      __syncthreads();
      fma_stage(acc, As, Bs, tx, ty);
      __syncthreads();
    }
  }
  float* o = out + static_cast<long long>(e) * K * N;
  const int col = n0 + tx * 4;
  if (col < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + ty * 4 + i;
      if (row < K)
        *reinterpret_cast<float4*>(o + static_cast<long long>(row) * N + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// Persistent grid: one CTA an SM of the current device (shared memory allows no more), no more
// than there are units.  Also makes the device's primary context current on the calling thread
// (cudaSetDevice): cuTensorMapEncodeTiled, which encodes the tensor maps, does not, and fails on a
// thread whose first CUDA call this is (the autograd engine's, in the backward).
cudaError_t persistent_grid(int units, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = units < sms ? units : sms;
  return err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (lhs, rhs and out).  lhs [M,K], out
// [M,N], tile_expert [M/block_m] int32, all contiguous; rhs [E,K,N], or
// with trans_rhs [E,N,K] used as its transpose.  M a multiple of block_m,
// block_m a multiple of 128; K and N rows 16-byte aligned; bf16: lhs and
// rhs 16-byte aligned (TMA).  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for inputs the kernels do not take.
int nexus_gmm(const void* lhs, const void* rhs, const void* tile_expert, void* out, int M, int K, int N, int E,
              int block_m, int trans_rhs, int dtype, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || block_m <= 0 || block_m % 128 != 0 || M % block_m != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  if (dtype == 1) {
    int grid = 0;
    CUtensorMap ta, tb, to;
    cudaError_t err = persistent_grid((M / kBM) * ((N + kBN - 1) / kBN), &grid);
    if (err == cudaSuccess) err = make_matrix_map(&ta, lhs, 1, M, K, kBM);
    if (err == cudaSuccess)
      err = trans_rhs ? make_matrix_map(&tb, rhs, E, N, K, kBN) : make_matrix_map(&tb, rhs, E, K, N, kBK);
    if (err == cudaSuccess) err = make_matrix_map(&to, out, 1, M, N, 64);
    if (err != cudaSuccess) return (int)err;
    const int smem = GmmSmem::kBytes;
    if (trans_rhs) {
      static std::atomic<unsigned long long> smem_set{0};
      if ((err = allow_smem_once(smem_set, gmm_bf16_kernel<true>, smem)) != cudaSuccess) return (int)err;
      gmm_bf16_kernel<true><<<grid, kThreads, smem, st>>>(ta, tb, to, te, M, K, N, E, block_m);
    } else {
      static std::atomic<unsigned long long> smem_set{0};
      if ((err = allow_smem_once(smem_set, gmm_bf16_kernel<false>, smem)) != cudaSuccess) return (int)err;
      gmm_bf16_kernel<false><<<grid, kThreads, smem, st>>>(ta, tb, to, te, M, K, N, E, block_m);
    }
  } else {
    const dim3 grid((M / kFTile) * ((N + kFTile - 1) / kFTile));
    const float* a = static_cast<const float*>(lhs);
    const float* b = static_cast<const float*>(rhs);
    float* o = static_cast<float*>(out);
    if (trans_rhs)
      gmm_f32_kernel<true><<<grid, kFThreads, 0, st>>>(a, b, te, o, M, K, N, E, block_m);
    else
      gmm_f32_kernel<false><<<grid, kFThreads, 0, st>>>(a, b, te, o, M, K, N, E, block_m);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype as above (lhs and dout).  lhs [M,K], dout [M,N], tile_expert
// [M/block_m] int32, out [E,K,N] f32, all contiguous; every element of out
// is written.  bf16: M > 0, lhs and dout 16-byte aligned (TMA).
int nexus_tgmm(const void* lhs, const void* dout, const void* tile_expert, void* out, int M, int K, int N, int E,
               int block_m, int dtype, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || block_m <= 0 || block_m % 128 != 0 || M % block_m != 0 ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && M == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  float* o = static_cast<float*>(out);
  if (dtype == 1) {
    int grid = 0;
    CUtensorMap ta, tb;
    cudaError_t err = persistent_grid(E * ((K + kBM - 1) / kBM) * ((N + kBN - 1) / kBN), &grid);
    if (err == cudaSuccess) err = make_matrix_map(&ta, lhs, 1, M, K, kBK);
    if (err == cudaSuccess) err = make_matrix_map(&tb, dout, 1, M, N, kBK);
    if (err != cudaSuccess) return (int)err;
    static std::atomic<unsigned long long> smem_set{0};
    if ((err = allow_smem_once(smem_set, tgmm_bf16_kernel, TgmmSmem::kBytes)) != cudaSuccess) return (int)err;
    tgmm_bf16_kernel<<<grid, kThreads, TgmmSmem::kBytes, st>>>(ta, tb, te, o, M, K, N, E, block_m);
  } else {
    const dim3 grid((N + kFTile - 1) / kFTile, (K + kFTile - 1) / kFTile, E);
    tgmm_f32_kernel<<<grid, kFThreads, 0, st>>>(static_cast<const float*>(lhs), static_cast<const float*>(dout), te,
                                                o, M, K, N, block_m);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a bf16 launch asks for: gmm (tgmm 0) or tgmm (1).
int nexus_gmm_smem_bytes(int tgmm) { return tgmm ? TgmmSmem::kBytes : GmmSmem::kBytes; }

}  // extern "C"
