// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, bound to PyTorch through a plain C interface (ctypes; see
// tpu_nexus_torch/ops/_build.py).
//
// Replaces: tpu_nexus/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _flash_backward).  Same function: with q~
// = q*scale*log2(e) rounded to the input dtype (computed once by the caller,
// ops/flash_attention.py::flash_bwd_qt, as _flash_backward computes qt once
// in XLA for both Pallas kernels), the forward's natural-log lse and dsum =
// rowsum(dO*O) (f32, also computed by the caller), per (query row i, key
// row j):
//     P  = exp2(q~_i.k_j - lse_i*log2(e))       (0 where causally masked)
//     dS = P * (dO_i.v_j - dsum_i)
//     dQ = scale * sum_j (dS->dtype) k_j                    (dQ kernel)
//     dV = sum_i (P->dtype)^T dO_i                         (dK/dV kernel)
//     dK = (1/log2(e)) * sum_i (dS->dtype)^T q~_i          (dK/dV kernel)
// dK and dV sum over the G query heads of each KV head inside the kernel
// (GQA), in f32, and are written once.  Layouts: q~/dO/dQ [B,S,Hq,D],
// k/v/dK/dV [B,S,Hkv,D], lse/dsum [B,Hq,S] f32.
//
// What bounds it on this card: at the training shape (B8 S2048 Hq16 Hkv8
// D128, causal) the function is 5 products of S*S*D/2 per head, 344 GFLOP,
// against 337 MB of inputs and grads read or written once: ~1,000 FLOP a
// byte, far above the H100's ~295 FLOP/byte ridge, so the tensor cores
// bound it.
//
// Design (bf16), the TPU's split kept: two kernels, each CTA owning its
// outputs and writing them once, so no atomics and a run repeated is
// bit-identical.  The split recomputes S and dP in both kernels (7 products
// where the bound counts 5: a ceiling of ~71 % of the bound); a fused kernel
// that sums dQ across CTAs with f32 atomics would not be deterministic.
// Both kernels follow the forward's pipeline (csrc/flash_attention.cu;
// building blocks in csrc/hopper.cuh): one CTA of three warpgroups, a
// producer warpgroup that gives up registers (setmaxnreg) and issues TMA
// through 4-D tensor maps over the model layout into an mbarrier ring, and
// two consumer warpgroups of 64 resident rows each that run every product
// on wgmma.  Tiles wholly above the diagonal are never loaded; only tiles on
// the diagonal or at a ragged end pay for masking, which compares row
// positions (the resident and streamed tiles differ in size).
//  * dQ (#2): a CTA per (q head, batch, 128-row Q tile), heaviest causal
//    tiles first.  q~ and dO arrive once; 64-row K and V tiles stream
//    through kStages stages.  Per K/V tile a consumer runs S = q~.K^T and
//    dP = dO.V^T (wgmma m64n64k16, both operands K-major from shared
//    memory), forms dS = P*(dP - dsum) in the accumulators, rounds it to
//    bf16 packed in place as the A operand (the accumulator layout is the
//    A-register layout), and runs dQ += dS.K with K read MN-major through
//    the descriptor's transpose bit.  lse and dsum are two rows a thread,
//    read once.
//  * dK/dV (#3): a CTA per (kv head, batch, 128-row KV tile), heaviest
//    (first) tiles first.  K and V arrive once; for each of the G query
//    heads, 64-row q~ and dO tiles from the first one that reaches the
//    diagonal on (the TPU's _q_index clamp) stream through the ring, with
//    their lse*log2(e) and dsum rows, which the producer warp stages with
//    plain loads (an f32 row of S floats has no 16-byte stride for TMA) and
//    counts into the same full barrier.  Per tile a consumer runs
//    S^T = K.q~^T and dP^T = V.dO^T, P^T = exp2(S^T - lse2[col]),
//    dS^T = P^T*(dP^T - dsum[col]), packs both to bf16 and runs
//    dV += P^T.dO and dK += dS^T.q~ (dO, q~ MN-major).  dK and dV stay in
//    registers (128 f32 a thread at D 128) across all G*n tiles.
//  * epilogues write dQ*scale, dK/log2(e) and dV as bf16 rows straight from
//    the registers; rows >= S are not written.
// Left for later: ping-pong scheduling of the two consumers, overlapping a
// tile's elementwise work with the next tile's products (queueing the next
// tile's S and dP behind dQ's product made ptxas serialize the wgmma, and
// dK/dV has no registers left for it), a persistent tile scheduler, a fused
// kernel with a deterministic dQ reduction, fp8.
//
// f32 inputs take CUDA-core FMA kernels in this file (64-row tiles, thread
// pairs own rows, as in the forward's f32 kernel), so the card can hold the
// kernel path against the plain path at f32 precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nexus_hopper;

constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// -- bf16: the Hopper kernels ------------------------------------------------------------------

constexpr int kResident = 128;               // rows a CTA owns: two consumer warpgroups of 64
constexpr int kStream = 64;                  // rows of a streamed tile
constexpr int kStages = 3;                   // streamed-tile ring depth
constexpr int kConsumerThreads = 256;
constexpr int kHopperThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kResidentPanel = kResident * 128;  // bytes of one 64-column box of a resident tile
constexpr int kStreamPanel = kStream * 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 40*128 + 232*256 <= 65536

template <int D>
struct Tiles {
  static constexpr int kPanels = D / 64;
  static constexpr int kResidentBytes = kPanels * kResidentPanel;
  static constexpr int kStreamBytes = kPanels * kStreamPanel;
};

template <int D>
struct DqSmem : Tiles<D> {  // byte offsets from a 1024-byte-aligned base
  static constexpr int kQ = 0;
  static constexpr int kDO = Tiles<D>::kResidentBytes;
  static constexpr int kK = 2 * Tiles<D>::kResidentBytes;
  static constexpr int kV = kK + kStages * Tiles<D>::kStreamBytes;
  static constexpr int kBarriers = kV + kStages * Tiles<D>::kStreamBytes;  // qd_full, k_full[], v_full[], empty[]
  static constexpr int kBytes = kBarriers + (1 + 3 * kStages) * 8 + 1024;  // + alignment slack
};

template <int D>
struct DkvSmem : Tiles<D> {
  static constexpr int kK = 0;
  static constexpr int kV = Tiles<D>::kResidentBytes;
  static constexpr int kQ = 2 * Tiles<D>::kResidentBytes;
  static constexpr int kDO = kQ + kStages * Tiles<D>::kStreamBytes;
  static constexpr int kRows = kDO + kStages * Tiles<D>::kStreamBytes;  // per stage: lse*log2(e), dsum (f32)
  static constexpr int kBarriers = kRows + kStages * 2 * kStream * 4;  // kv_full, q_full[], do_full[], empty[]
  static constexpr int kBytes = kBarriers + (1 + 3 * kStages) * 8 + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[64 x 64] = A . B^T over the head dim: A is 64 rows of a tile (K-major, 64-column panels
// a_panel bytes apart), B the 64 rows of a streamed or resident tile (K-major, b_panel apart).
template <int D>
__device__ __forceinline__ void gemm_abt(float (&acc)[32], uint32_t a_addr, int a_panel, uint32_t b_addr,
                                         int b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_m64n64k16_ss(acc, sw128_desc(a_addr + (kk / 4) * a_panel + off, 16, 1024),
                       sw128_desc(b_addr + (kk / 4) * b_panel + off, 16, 1024), kk > 0);
  }
}

// acc[64 x D] += A . B over 64 rows: A from registers (the packed fragments of a 64 x 64
// accumulator, four k-steps), B a streamed 64-row tile read MN-major (panels kStreamPanel apart).
template <int D>
__device__ __forceinline__ void gemm_ab(float (&acc)[D / 2], const uint32_t (&a)[4][4], uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = sw128_desc(b_addr + kk * 16 * 128, kStreamPanel, 1024);
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs_mn(acc, a[kk], desc);
    } else {
      wgmma_m64n64k16_rs_mn(acc, a[kk], desc);
    }
  }
}

// A fragments of a 64 x 64 accumulator, rounded to bf16: n-blocks (2kk, 2kk+1) are k-step kk.
__device__ __forceinline__ void pack_fragments(uint32_t (&a)[4][4], const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
  }
}

__device__ __forceinline__ void fence_fragments(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_operands(a[kk]);
}

// One tile at (row0, head h, batch b) into shared memory: D/64 panels of 64 columns, panel_bytes
// (= the map's box rows x 128) apart.
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, int panel_bytes, const CUtensorMap* map, uint64_t* bar,
                                         int h, int row0, int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load_4d(dst + p * panel_bytes, map, bar, p * 64, h, row0, b);
}

// dQ of one (q head, batch, 128-row Q tile).  Accumulator rows of a consumer thread: row0 and
// row0 + 8; columns j*8 + 2t + {0, 1} of n-block j.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1) flash_bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ dsum, bf16* __restrict__ dq, int S, int Hq, int Hkv,
    float scale, int causal) {
  using L = DqSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];  // (the f32 kernels' declaration)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(smem + L::kBarriers);
  uint64_t* k_full = qd_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kResident;  // heaviest causal Q tiles first
  const int kv_end = causal ? min(q0 + kResident, S) : S;  // keys past the tile's last row: never loaded
  const int n_kt = (kv_end + kStream - 1) / kStream;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup: one thread issues every load
    warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      const int kvh = h / (Hq / Hkv);
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      prefetch_tensor_map(&tm_do);
      mbar_arrive_expect_tx(qd_full, 2 * L::kResidentBytes);
      tma_tile<D>(smem + L::kQ, kResidentPanel, &tm_q, qd_full, h, q0, b);
      tma_tile<D>(smem + L::kDO, kResidentPanel, &tm_do, qd_full, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&empty[st], ((kt / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&k_full[st], L::kStreamBytes);
        tma_tile<D>(smem + L::kK + st * L::kStreamBytes, kStreamPanel, &tm_k, &k_full[st], kvh, kt * kStream, b);
        mbar_arrive_expect_tx(&v_full[st], L::kStreamBytes);
        tma_tile<D>(smem + L::kV + st * L::kStreamBytes, kStreamPanel, &tm_v, &v_full[st], kvh, kt * kStream, b);
      }
    }
  } else {
    // consumer warpgroups: 64 Q rows each
    warpgroup_reg_alloc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * 64;  // this warpgroup's first row
    const int row0 = r0 + warp * 16 + g;
    const uint32_t q_addr = smem_u32(smem + L::kQ) + wg * 64 * 128;
    const uint32_t do_addr = smem_u32(smem + L::kDO) + wg * 64 * 128;
    float lse2[2], dsr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = row0 + 8 * i;
      const size_t idx = ((size_t)b * Hq + h) * S + s;
      lse2[i] = s < S ? lse[idx] * kLog2e : 0.f;
      dsr[i] = s < S ? dsum[idx] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(qd_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kStages;
      const uint32_t parity = (kt / kStages) & 1;
      const int k0 = kt * kStream;
      const uint32_t k_addr = smem_u32(smem + L::kK + st * L::kStreamBytes);
      const uint32_t v_addr = smem_u32(smem + L::kV + st * L::kStreamBytes);
      mbar_wait(&k_full[st], parity);
      mbar_wait(&v_full[st], parity);
      if (causal && k0 > r0 + 63) {  // every key of the tile lies above this warpgroup's rows
        mbar_arrive(&empty[st]);
        continue;
      }
      __syncwarp();
      float s[32], dp[32];
      wgmma_fence();
      gemm_abt<D>(s, q_addr, kResidentPanel, k_addr, kStreamPanel);
      gemm_abt<D>(dp, do_addr, kResidentPanel, v_addr, kStreamPanel);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);

      const bool masked = (causal && k0 + kStream - 1 > r0) || k0 + kStream > S;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = exp2f(s[4 * j + e] - lse2[i]);
          if (masked) {
            const int row = row0 + 8 * i;
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            if (col >= S || (causal && col > row)) p = 0.f;
          }
          s[4 * j + e] = p * (dp[4 * j + e] - dsr[i]);  // dS
        }
      }
      // dQ += (dS->bf16) . K, rounded where the TPU kernel rounds dS
      uint32_t ds[4][4];
      pack_fragments(ds, s);
      wgmma_fence();
      gemm_ab<D>(acc, ds, k_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_fragments(ds);
      mbar_arrive(&empty[st]);  // this thread is done with the stage's K and V
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s_row = row0 + 8 * i;
      if (s_row < S) {
        bf16* orow = dq + (((size_t)b * S + s_row) * Hq + h) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
              __floats2bfloat162_rn(acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
        }
      }
    }
  }
}

// dK and dV of one (kv head, batch, 128-row KV tile), summed over the G query heads.
// Accumulator rows of a consumer thread are KV rows krow0 and krow0 + 8; the columns of S^T and
// dP^T are query rows.
template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1) flash_bwd_dkv_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ dsum, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int S, int Hq, int Hkv, int causal) {
  using L = DkvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* rows = reinterpret_cast<float*>(smem + L::kRows);  // stage st: lse2 [64] then dsum [64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBarriers);
  uint64_t* q_full = kv_full + 1;  // q~ (TMA) and the lse/dsum rows (32 producer lanes)
  uint64_t* do_full = q_full + kStages;
  uint64_t* empty = do_full + kStages;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kResident;  // heaviest causal KV tiles (the first) first
  const int group = Hq / Hkv;
  const int qt_first = causal ? k0 / kStream : 0;  // query rows before k0 see none of these keys
  const int n_qt = (S + kStream - 1) / kStream - qt_first;  // Q tiles a query head streams
  const int n_items = group * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&q_full[st], 1 + 32);
      mbar_init(&do_full[st], 1);
      mbar_init(&empty[st], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup: its first warp loads; lane 0 issues the TMA
    warpgroup_reg_dealloc<kProducerRegs>();
    if (threadIdx.x < kConsumerThreads + 32) {
      const int lane = threadIdx.x - kConsumerThreads;
      if (lane == 0) {
        prefetch_tensor_map(&tm_q);
        prefetch_tensor_map(&tm_k);
        prefetch_tensor_map(&tm_v);
        prefetch_tensor_map(&tm_do);
        mbar_arrive_expect_tx(kv_full, 2 * L::kResidentBytes);
        tma_tile<D>(smem + L::kK, kResidentPanel, &tm_k, kv_full, kvh, k0, b);
        tma_tile<D>(smem + L::kV, kResidentPanel, &tm_v, kv_full, kvh, k0, b);
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % kStages;
        const int h = kvh * group + it / n_qt;
        const int q0 = (qt_first + it % n_qt) * kStream;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&q_full[st], L::kStreamBytes);
          tma_tile<D>(smem + L::kQ + st * L::kStreamBytes, kStreamPanel, &tm_q, &q_full[st], h, q0, b);
          mbar_arrive_expect_tx(&do_full[st], L::kStreamBytes);
          tma_tile<D>(smem + L::kDO + st * L::kStreamBytes, kStreamPanel, &tm_do, &do_full[st], h, q0, b);
        }
        float* r = rows + st * 2 * kStream;
        const size_t base = ((size_t)b * Hq + h) * S;
#pragma unroll
        for (int j = 0; j < kStream / 32; ++j) {
          const int c = lane + 32 * j, s = q0 + c;
          r[c] = s < S ? lse[base + s] * kLog2e : 0.f;
          r[kStream + c] = s < S ? dsum[base + s] : 0.f;
        }
        mbar_arrive(&q_full[st]);  // releases this lane's row writes to the consumers
      }
    }
  } else {
    // consumer warpgroups: 64 KV rows each
    warpgroup_reg_alloc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kr0 = k0 + wg * 64;  // this warpgroup's first KV row
    const int krow0 = kr0 + warp * 16 + g;
    const uint32_t k_addr = smem_u32(smem + L::kK) + wg * 64 * 128;
    const uint32_t v_addr = smem_u32(smem + L::kV) + wg * 64 * 128;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_items; ++it) {
      const int st = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int q0 = (qt_first + it % n_qt) * kStream;
      const uint32_t q_addr = smem_u32(smem + L::kQ + st * L::kStreamBytes);
      const uint32_t do_addr = smem_u32(smem + L::kDO + st * L::kStreamBytes);
      const float* r = rows + st * 2 * kStream;
      mbar_wait(&q_full[st], parity);
      mbar_wait(&do_full[st], parity);
      if (causal && kr0 > q0 + kStream - 1) {  // every query row of the tile lies before this warpgroup's keys
        mbar_arrive(&empty[st]);
        continue;
      }
      __syncwarp();
      float s[32], dp[32];
      wgmma_fence();
      gemm_abt<D>(s, k_addr, kResidentPanel, q_addr, kStreamPanel);
      wgmma_commit();
      gemm_abt<D>(dp, v_addr, kResidentPanel, do_addr, kStreamPanel);
      wgmma_commit();
      wgmma_wait<1>();  // S^T has landed; dP^T may still be running
      fence_operands(s);

      const bool masked = (causal && kr0 + 63 > q0) || q0 + kStream > S;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          float p = exp2f(s[4 * j + e] - r[c]);
          if (masked) {
            const int krow = krow0 + 8 * (e >> 1);
            const int qrow = q0 + c;
            if (qrow >= S || (causal && krow > qrow)) p = 0.f;
          }
          s[4 * j + e] = p;  // P^T
        }
      }
      wgmma_wait<0>();
      fence_operands(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - r[kStream + c]);  // dS^T
        }
      }
      // dV += (P^T->bf16) . dO and dK += (dS^T->bf16) . q~ over the tile's 64 query rows
      uint32_t pa[4][4], sa[4][4];
      pack_fragments(pa, s);
      pack_fragments(sa, dp);
      wgmma_fence();
      gemm_ab<D>(dv_acc, pa, do_addr);
      gemm_ab<D>(dk_acc, sa, q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dv_acc);
      fence_operands(dk_acc);
      fence_fragments(pa);
      fence_fragments(sa);
      mbar_arrive(&empty[st]);  // this thread is done with the stage
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s_row = krow0 + 8 * i;
      if (s_row < S) {
        const size_t off = (((size_t)b * S + s_row) * Hkv + kvh) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8 + 2 * t) = __floats2bfloat162_rn(
              dk_acc[4 * n + 2 * i] * (1.f / kLog2e), dk_acc[4 * n + 2 * i + 1] * (1.f / kLog2e));
          *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8 + 2 * t) =
              __floats2bfloat162_rn(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 kernels (CUDA-core FMA): thread pair (2r, 2r+1) owns tile row r; each
// computes half of the row's 64 scores and accumulates half of its D outputs.
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kStride32 = 1;  // f32 row padding (words)

// Copy 64 rows of D f32 into shared memory (row stride D+1), scaled by
// `mul`; rows past S are zeroed.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int s0, int S, int heads, int h, int b,
                                              float mul) {
  constexpr int kC4 = D / 4;
  for (int i = threadIdx.x; i < 64 * kC4; i += kThreads) {
    const int r = i / kC4, c = i % kC4, s = s0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) val = *reinterpret_cast<const float4*>(src + ((size_t)(b * S + s) * heads + h) * D + c * 4);
    float* d = dst + r * (D + kStride32) + c * 4;
    d[0] = val.x * mul;
    d[1] = val.y * mul;
    d[2] = val.z * mul;
    d[3] = val.w * mul;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dq, int S, int Hq, int Hkv, float qscale, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = D + kStride32;
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [64][RS]
  float* dOs = Qs + kBlockQ * RS;
  float* Ks = dOs + kBlockQ * RS;
  float* Vs = Ks + kBlockK * RS;
  float* dSs = Vs + kBlockK * RS;  // [64][65]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * kBlockQ;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int row = q0 + r;

  load_tile_f32<D>(Qs, q, q0, S, Hq, h, b, qscale);
  load_tile_f32<D>(dOs, dout, q0, S, Hq, h, b, 1.f);
  const size_t ridx = ((size_t)b * Hq + h) * S + row;
  const float lse2 = row < S ? lse[ridx] * kLog2e : 0.f;
  const float dsr = row < S ? dsum[ridx] : 0.f;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const int n_tiles_all = (S + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(qt + 1, n_tiles_all) : n_tiles_all;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tile_f32<D>(Ks, k, k0, S, Hkv, kvh, b, 1.f);
    load_tile_f32<D>(Vs, v, k0, S, Hkv, kvh, b, 1.f);
    __syncthreads();
    const float* qr = Qs + r * RS;
    const float* dr = dOs + r * RS;
    for (int j = 0; j < kBlockK / 2; ++j) {
      const int c = half * (kBlockK / 2) + j;
      const float* kr = Ks + c * RS;
      const float* vr = Vs + c * RS;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dp = fmaf(dr[d], vr[d], dp);
      }
      const int col = k0 + c;
      float p = exp2f(s - lse2);
      if (col >= S || (causal && col > row)) p = 0.f;
      dSs[r * (kBlockK + 1) + c] = p * (dp - dsr);
    }
    __syncwarp();
    for (int c = 0; c < kBlockK; ++c) {
      const float ds = dSs[r * (kBlockK + 1) + c];
      const float* kr = Ks + c * RS + half * (D / 2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
    }
  }
  if (row < S) {
    float* orow = dq + ((size_t)(b * S + row) * Hq + h) * D + half * (D / 2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) orow[i] = acc[i] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
    float* __restrict__ dk, float* __restrict__ dv, int S, int Hq, int Hkv, float qscale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int RS = D + kStride32;
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [64][RS]
  float* Vs = Ks + kBlockK * RS;
  float* Qs = Vs + kBlockK * RS;
  float* dOs = Qs + kBlockQ * RS;
  float* Ps = dOs + kBlockQ * RS;           // [64][65]
  float* dSs = Ps + kBlockK * (kBlockQ + 1);  // [64][65]
  float* lse2s = dSs + kBlockK * (kBlockQ + 1);
  float* dsums = lse2s + kBlockQ;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = kt * kBlockK;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int krow = k0 + r;

  load_tile_f32<D>(Ks, k, k0, S, Hkv, kvh, b, 1.f);
  load_tile_f32<D>(Vs, v, k0, S, Hkv, kvh, b, 1.f);

  float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

  const int n_q_tiles = (S + kBlockQ - 1) / kBlockQ;
  const int qt_first = causal ? kt : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    for (int qt = qt_first; qt < n_q_tiles; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();
      load_tile_f32<D>(Qs, q, q0, S, Hq, h, b, qscale);
      load_tile_f32<D>(dOs, dout, q0, S, Hq, h, b, 1.f);
      if (threadIdx.x < kBlockQ) {
        const int s = q0 + threadIdx.x;
        const size_t idx = ((size_t)b * Hq + h) * S + s;
        lse2s[threadIdx.x] = s < S ? lse[idx] * kLog2e : 0.f;
        dsums[threadIdx.x] = s < S ? dsum[idx] : 0.f;
      }
      __syncthreads();
      const float* kr = Ks + r * RS;
      const float* vr = Vs + r * RS;
      for (int j = 0; j < kBlockQ / 2; ++j) {
        const int c = half * (kBlockQ / 2) + j;
        const float* qc = Qs + c * RS;
        const float* dc = dOs + c * RS;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(kr[d], qc[d], s);
          dp = fmaf(vr[d], dc[d], dp);
        }
        const int qrow = q0 + c;
        float p = exp2f(s - lse2s[c]);
        if (qrow >= S || (causal && krow > qrow)) p = 0.f;
        Ps[r * (kBlockQ + 1) + c] = p;
        dSs[r * (kBlockQ + 1) + c] = p * (dp - dsums[c]);
      }
      __syncwarp();
      for (int c = 0; c < kBlockQ; ++c) {
        const float p = Ps[r * (kBlockQ + 1) + c];
        const float ds = dSs[r * (kBlockQ + 1) + c];
        const float* dc = dOs + c * RS + half * (D / 2);
        const float* qc = Qs + c * RS + half * (D / 2);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          dvacc[i] = fmaf(p, dc[i], dvacc[i]);
          dkacc[i] = fmaf(ds, qc[i], dkacc[i]);
        }
      }
    }
  }
  if (krow < S) {
    const size_t off = ((size_t)(b * S + krow) * Hkv + kvh) * D + half * (D / 2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk[off + i] = dkacc[i] * (1.f / kLog2e);
      dv[off + i] = dvacc[i];
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_args(int B, int S, int Hq, int Hkv, int D, int dtype) {
  return B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128) || (dtype != 0 && dtype != 1) ||
         B > 65535 || (S + kBlockQ - 1) / kBlockQ > 65535;
}

// The tensor maps of a bf16 launch: q~ and dO with boxes of q_rows rows, K and V of kv_rows.
cudaError_t make_maps(CUtensorMap (&m)[4], const void* qt, const void* k, const void* v, const void* dout, int B,
                      int S, int Hq, int Hkv, int D, int q_rows, int kv_rows) {
  cudaError_t err;
  if ((err = make_bshd_map(&m[0], qt, B, S, Hq, D, q_rows)) != cudaSuccess) return err;
  if ((err = make_bshd_map(&m[1], k, B, S, Hkv, D, kv_rows)) != cudaSuccess) return err;
  if ((err = make_bshd_map(&m[2], v, B, S, Hkv, D, kv_rows)) != cudaSuccess) return err;
  return make_bshd_map(&m[3], dout, B, S, Hq, D, q_rows);
}

template <int D>
cudaError_t launch_dq(const void* qt, const void* k, const void* v, const void* dout, const float* lse,
                      const float* dsum, void* dq, int B, int S, int Hq, int Hkv, int dtype, float scale, int causal,
                      cudaStream_t st) {
  cudaError_t err;
  if (dtype == 1) {
    CUtensorMap m[4];
    if ((err = make_maps(m, qt, k, v, dout, B, S, Hq, Hkv, D, kResident, kStream)) != cudaSuccess) return err;
    const int smem = DqSmem<D>::kBytes;
    if ((err = set_smem(flash_bwd_dq_bf16_kernel<D>, smem)) != cudaSuccess) return err;
    const dim3 grid(Hq, B, (S + kResident - 1) / kResident);
    flash_bwd_dq_bf16_kernel<D><<<grid, kHopperThreads, smem, st>>>(m[0], m[1], m[2], m[3], lse, dsum,
                                                                    static_cast<bf16*>(dq), S, Hq, Hkv, scale,
                                                                    causal);
  } else {
    const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
    const size_t smem = ((size_t)(2 * kBlockQ + 2 * kBlockK) * (D + kStride32) + kBlockQ * (kBlockK + 1)) *
                        sizeof(float);
    if ((err = set_smem(flash_bwd_dq_f32_kernel<D>, smem)) != cudaSuccess) return err;
    // q arrives as q~, the product the kernel's qscale would form in f32: the kernel scales by 1
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(qt), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, dsum, static_cast<float*>(dq), S, Hq, Hkv, 1.f, scale, causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* qt, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dsum, void* dk, void* dv, int B, int S, int Hq, int Hkv, int dtype, int causal,
                       cudaStream_t st) {
  cudaError_t err;
  if (dtype == 1) {
    CUtensorMap m[4];
    if ((err = make_maps(m, qt, k, v, dout, B, S, Hq, Hkv, D, kStream, kResident)) != cudaSuccess) return err;
    const int smem = DkvSmem<D>::kBytes;
    if ((err = set_smem(flash_bwd_dkv_bf16_kernel<D>, smem)) != cudaSuccess) return err;
    const dim3 grid(Hkv, B, (S + kResident - 1) / kResident);
    flash_bwd_dkv_bf16_kernel<D><<<grid, kHopperThreads, smem, st>>>(
        m[0], m[1], m[2], m[3], lse, dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Hq, Hkv, causal);
  } else {
    const dim3 grid((S + kBlockK - 1) / kBlockK, Hkv, B);
    const size_t smem = ((size_t)(2 * kBlockQ + 2 * kBlockK) * (D + kStride32) +
                         2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ) *
                        sizeof(float);
    if ((err = set_smem(flash_bwd_dkv_f32_kernel<D>, smem)) != cudaSuccess) return err;
    flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(qt), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, dsum, static_cast<float*>(dk), static_cast<float*>(dv), S, Hq, Hkv,
        1.f, causal);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  qt is q~ = q*scale*log2(e) rounded to
// the dtype (ops/flash_attention.py::flash_bwd_qt); qt/k/v/dout/dq
// contiguous in [B,S,H,D]; lse and dsum [B,Hq,S] f32; scale computed by the
// caller in double precision.  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for inputs the kernels do not take (bf16: tensors
// not 16-byte aligned, as TMA needs).
int nexus_flash_bwd_dq(const void* qt, const void* k, const void* v, const void* dout, const void* lse,
                       const void* dsum, void* dq, int B, int S, int Hq, int Hkv, int D, int dtype, float scale,
                       int causal, void* stream) {
  if (bad_args(B, S, Hq, Hkv, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dsum);
  if (D == 128) return (int)launch_dq<128>(qt, k, v, dout, l, ds, dq, B, S, Hq, Hkv, dtype, scale, causal, st);
  return (int)launch_dq<64>(qt, k, v, dout, l, ds, dq, B, S, Hq, Hkv, dtype, scale, causal, st);
}

// Same conventions; dk/dv contiguous in [B,S,Hkv,D].
int nexus_flash_bwd_dkv(const void* qt, const void* k, const void* v, const void* dout, const void* lse,
                        const void* dsum, void* dk, void* dv, int B, int S, int Hq, int Hkv, int D, int dtype,
                        int causal, void* stream) {
  if (bad_args(B, S, Hq, Hkv, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dsum);
  if (D == 128) return (int)launch_dkv<128>(qt, k, v, dout, l, ds, dk, dv, B, S, Hq, Hkv, dtype, causal, st);
  return (int)launch_dkv<64>(qt, k, v, dout, l, ds, dk, dv, B, S, Hq, Hkv, dtype, causal, st);
}

// Dynamic shared memory a bf16 launch asks for: kernel 0 = dQ, 1 = dK/dV; D 64 or 128 (else -1).
int nexus_flash_bwd_smem_bytes(int kernel, int D) {
  if (D == 128) return kernel == 0 ? DqSmem<128>::kBytes : DkvSmem<128>::kBytes;
  if (D == 64) return kernel == 0 ? DqSmem<64>::kBytes : DkvSmem<64>::kBytes;
  return -1;
}

}  // extern "C"
