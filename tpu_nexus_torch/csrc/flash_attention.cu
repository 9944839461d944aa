// Flash-attention forward for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes; see tpu_nexus_torch/ops/_build.py).
//
// Replaces: tpu_nexus/ops/flash_attention.py::_fwd_kernel (launched by
// _flash_forward).  Same function: causal or full GQA self-attention over
// q [B,S,Hq,D], k/v [B,S,Hkv,D], online softmax in the exp2 domain with q
// pre-scaled by scale*log2(e) and rounded back to the input dtype, f32
// carry (acc, m, l), P rounded to the input dtype before P.V; returns out
// in model layout [B,S,Hq,D] and the natural-log logsumexp [B,Hq,S] (f32).
//
// What bounds it on this card: at prefill shapes (S >= 128, D = 128) the
// work is 4*B*Hq*S^2*D/2 FLOP against (q+k+v+out) bytes, far above the
// H100's ~295 FLOP/byte ridge, so the tensor cores bound it; at a short
// prompt (S 128) the bytes do, and the latency of a CTA's first loads.
//
// Design (bf16): one CTA of three warpgroups per (q head, batch, 128-row Q
// tile), warp-specialised (csrc/hopper.cuh holds the building blocks):
//  * a producer warpgroup gives up registers (setmaxnreg) and one thread
//    of it issues TMA: Q once, then 128-row K and V tiles into a ring of
//    kStages shared-memory stages, each with a full mbarrier for K, one
//    for V and an empty one.  The tensor maps are 4-D over the model layout
//    (D, H, S, B), so nothing is transposed or copied and GQA is the head
//    coordinate h / (Hq/Hkv); rows past S arrive zero-filled.  Loads run up
//    to the ring's depth ahead of the math, so the tensor cores do not
//    wait for each tile's load.
//  * two consumer warpgroups own 64 Q rows each.  They scale their Q rows
//    in shared memory in place (f32 multiply, round to bf16), then per K/V
//    tile: S = Q.K^T with wgmma m64n128k16 from shared memory (both K-major,
//    128-byte swizzle), the online softmax in registers (a row is shared by
//    the 4 threads of a quad), O += P.V with wgmma taking P from registers
//    (the f32 accumulator layout of one wgmma is the A-register layout of
//    the next, so P is rounded to bf16 and packed in place) and V from
//    shared memory MN-major through the descriptor's transpose bit: no
//    ldmatrix and no scalar shared loads.  A consumer releases a stage
//    after its P.V has retired (wgmma.wait_group).
//  * causal: Q tiles run heaviest first (the grid's slowest axis, reversed),
//    tiles wholly above the diagonal are never loaded, and only the diagonal
//    tile and a ragged tail pay for masking, so any S works without padding.
//  * epilogue: O / l is written as bf16 rows straight from the registers,
//    lse as f32; rows >= S are not written.  No atomics: a run repeated is
//    bit-identical.
// Left for later: ping-pong scheduling of the two consumers' softmax against
// each other's GEMMs, overlapping a warpgroup's softmax with its next Q.K^T,
// a persistent tile scheduler, K/V multicast across the GQA group, fp8.
//
// f32 inputs take a CUDA-core FMA kernel in this file (64-row tiles, 4
// warps), so the card can hold the kernel path against the plain path to
// token identity in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nexus_hopper;

constexpr float kLog2e = 1.4426950408889634f;

// -- bf16: the Hopper kernel -----------------------------------------------------------------

constexpr int kTileQ = 128;                 // Q rows a CTA: two consumer warpgroups of 64
constexpr int kTileK = 128;                 // K/V rows a pipeline stage
constexpr int kStages = 2;                  // K/V ring depth
constexpr int kConsumerThreads = 256;
constexpr int kHopperThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kPanelBytes = kTileK * 128;   // 128 rows of one 64-column box (128-byte rows)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 40*128 + 232*256 <= 65536
static_assert(kTileQ == kTileK, "a Q tile and a K/V tile share the panel size and the causal tile count");

template <int D>
struct SmemLayout {  // byte offsets from a 1024-byte-aligned base
  static constexpr int kPanels = D / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 128 rows x D bf16
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBarriers = kV + kStages * kTileBytes;  // q_full, k_full[], v_full[], empty[]
  static constexpr int kBytes = kBarriers + (1 + 3 * kStages) * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q.K^T over the head dim: Q rows of this warpgroup (K-major), one K tile (K-major).
template <int D>
__device__ __forceinline__ void qk_gemm(float (&s)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_m64n128k16_ss(s, sw128_desc(q_addr + off, 16, 1024), sw128_desc(k_addr + off, 16, 1024), kk > 0);
  }
}

// O += P.V over the tile's 128 K/V rows: P from registers, V MN-major.
template <int D>
__device__ __forceinline__ void pv_gemm(float (&o)[D / 2], uint32_t (&pa)[kTileK / 16][4], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    const uint64_t desc = sw128_desc(v_addr + kk * 16 * 128, kPanelBytes, 1024);
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs_mn(o, pa[kk], desc);
    } else {
      wgmma_m64n64k16_rs_mn(o, pa[kk], desc);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1) flash_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S,
    int Hq, int Hkv, float qscale, int causal) {
  using L = SmemLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];  // (the f32 kernel's declaration)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarriers);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heaviest causal Q tiles first
  const int q0 = qt * kTileQ;
  const int n_kt_all = (S + kTileK - 1) / kTileK;
  const int n_kt = causal ? min(qt + 1, n_kt_all) : n_kt_all;  // tiles above the diagonal: never loaded

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_arrive_expect_tx(q_full, L::kTileBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load_4d(smem + L::kQ + p * kPanelBytes, &tm_q, q_full, p * 64, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&empty[st], ((kt / kStages) & 1) ^ 1);  // the first round passes at once
        unsigned char* ks = smem + L::kK + st * L::kTileBytes;
        unsigned char* vs = smem + L::kV + st * L::kTileBytes;
        mbar_arrive_expect_tx(&k_full[st], L::kTileBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_4d(ks + p * kPanelBytes, &tm_k, &k_full[st], p * 64, kvh, kt * kTileK, b);
        mbar_arrive_expect_tx(&v_full[st], L::kTileBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_4d(vs + p * kPanelBytes, &tm_v, &v_full[st], p * 64, kvh, kt * kTileK, b);
      }
    }
  } else {
    // consumer warpgroups: 64 Q rows each
    warpgroup_reg_alloc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_addr = smem_u32(smem + L::kQ) + wg * 64 * 128;

    // the q prescale, in place: elementwise, so the swizzle does not matter
    mbar_wait(q_full, 0);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      uint4* rows = reinterpret_cast<uint4*>(smem + L::kQ + p * kPanelBytes + wg * 64 * 128);
#pragma unroll
      for (int i = tid; i < 64 * 128 / 16; i += 128) {
        uint4 val = rows[i];
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * qscale);
        rows[i] = val;
      }
    }
    fence_proxy_async_shared();  // the scaled rows are read by wgmma (the async proxy)
    named_barrier_sync(1 + wg, 128);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_row[2] = {-INFINITY, -INFINITY};
    float l_row[2] = {0.f, 0.f};  // this thread's partial row sums
    const int row0 = q0 + wg * 64 + warp * 16 + g;  // rows row0 and row0 + 8

    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kStages;
      const uint32_t parity = (kt / kStages) & 1;
      const int k0 = kt * kTileK;
      float s[64];
      mbar_wait(&k_full[st], parity);
      __syncwarp();
      wgmma_fence();
      qk_gemm<D>(s, q_addr, smem_u32(smem + L::kK + st * L::kTileBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);

      if ((causal && kt == qt) || k0 + kTileK > S) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + (e >= 2 ? 8 : 0);
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            if (col >= S || (causal && col > row)) s[4 * j + e] = -INFINITY;
          }
        }
      }
      // online softmax, exp2 domain (scores are already log2-scaled via q)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 2));
        const float m_new = fmaxf(m_row[i], mx[i]);
        m_use[i] = (m_new == -INFINITY) ? 0.f : m_new;  // a row with nothing live yet: p = alpha = 0
        alpha[i] = exp2f(m_row[i] - m_use[i]);
        m_row[i] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[4 * j + e] - m_use[e >> 1]);
          s[4 * j + e] = p;
          psum[e >> 1] += p;
        }
      }
      // P as the A operand of P.V's 8 k-steps: n-blocks (2kk, 2kk+1) of the S
      // accumulator are k-step kk's A fragment; rounded to bf16 here, as the
      // TPU kernel rounds p before its P.V dot
      uint32_t pa[kTileK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_row[i] = l_row[i] * alpha[i] + psum[i];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
      mbar_wait(&v_full[st], parity);
      __syncwarp();
      wgmma_fence();
      pv_gemm<D>(o, pa, smem_u32(smem + L::kV + st * L::kTileBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(o);
      mbar_arrive(&empty[st]);  // this thread is done with the stage's K and V
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_row[i];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      const float l_safe = fmaxf(l, 1e-30f);
      const int s_row = row0 + 8 * i;
      if (s_row < S) {
        __nv_bfloat16* orow = out + (((size_t)b * S + s_row) * Hq + h) * D;
        const float inv = 1.f / l_safe;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
              __floats2bfloat162_rn(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
        }
        if (t == 0) lse[((size_t)b * Hq + h) * S + s_row] = m_row[i] * (1.f / kLog2e) + logf(l_safe);
      }
    }
  }
}

// -- f32 ---------------------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

// f32: CUDA-core FMA version of the same tiling.  Thread pair (2r, 2r+1)
// owns Q row r: each computes half of the row's 64 scores, the pair shares
// the row max/sum through shuffles, and each accumulates half of the
// row's D outputs.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int S, int Hq, int Hkv, float qscale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [64][D+1]
  float* Ks = Qs + kBlockQ * (D + 1);              // [64][D+1]
  float* Vs = Ks + kBlockK * (D + 1);              // [64][D]
  float* Ps = Vs + kBlockK * D;                    // [64][65]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * kBlockQ;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int row = q0 + r;
  constexpr int kC4 = D / 4;

  for (int i = threadIdx.x; i < kBlockQ * kC4; i += kThreads) {
    const int rr = i / kC4, c = i % kC4, s = q0 + rr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) val = *reinterpret_cast<const float4*>(q + ((size_t)(b * S + s) * Hq + h) * D + c * 4);
    float* d = Qs + rr * (D + 1) + c * 4;
    d[0] = val.x * qscale;
    d[1] = val.y * qscale;
    d[2] = val.z * qscale;
    d[3] = val.w * qscale;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_row = -INFINITY, l_row = 0.f;

  const int n_tiles_all = (S + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(qt + 1, n_tiles_all) : n_tiles_all;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockK * kC4; i += kThreads) {
      const int rr = i / kC4, c = i % kC4, s = k0 + rr;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (s < S) {
        const size_t off = ((size_t)(b * S + s) * Hkv + kvh) * D + c * 4;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      float* dk = Ks + rr * (D + 1) + c * 4;
      dk[0] = kv.x;
      dk[1] = kv.y;
      dk[2] = kv.z;
      dk[3] = kv.w;
      *reinterpret_cast<float4*>(Vs + rr * D + c * 4) = vv;
    }
    __syncthreads();

    float s_loc[kBlockK / 2];
    float mx = -INFINITY;
#pragma unroll 4
    for (int j = 0; j < kBlockK / 2; ++j) {
      const int c = half * (kBlockK / 2) + j;
      const float* qr = Qs + r * (D + 1);
      const float* kr = Ks + c * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int col = k0 + c;
      if (col >= S || (causal && col > row)) s = -INFINITY;
      s_loc[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    const float m_new = fmaxf(m_row, mx);
    const float alpha = (m_row == -INFINITY) ? 0.f : exp2f(m_row - m_new);
    m_row = m_new;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 2; ++j) {
      const float p = (s_loc[j] == -INFINITY) ? 0.f : exp2f(s_loc[j] - m_new);
      psum += p;
      Ps[r * (kBlockK + 1) + half * (kBlockK / 2) + j] = p;
    }
    psum += __shfl_xor_sync(0xffffffff, psum, 1);
    l_row = l_row * alpha + psum;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBlockK; ++c) {
      const float p = Ps[r * (kBlockK + 1) + c];
      const float* vr = Vs + c * D + half * (D / 2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
    }
  }

  if (row < S) {
    const float l_safe = fmaxf(l_row, 1e-30f);
    float* orow = out + ((size_t)(b * S + row) * Hq + h) * D + half * (D / 2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) orow[i] = acc[i] / l_safe;
    if (half == 0) lse[((size_t)b * Hq + h) * S + row] = m_row * (1.f / kLog2e) + logf(l_safe);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/k/v/out contiguous in [B,S,H,D];
// lse [B,Hq,S] f32.  qscale = softmax scale * log2(e), computed by the
// caller in double precision.  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for inputs the kernels do not take (bf16: q, k, v
// not 16-byte aligned, as TMA needs).
int nexus_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S, int Hq,
                    int Hkv, int D, int dtype, float qscale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const int n_qt = (S + kTileQ - 1) / kTileQ;
    if (B > 65535 || n_qt > 65535) return (int)cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    if ((err = make_bshd_map(&tq, q, B, S, Hq, D, kTileQ)) != cudaSuccess) return (int)err;
    if ((err = make_bshd_map(&tk, k, B, S, Hkv, D, kTileK)) != cudaSuccess) return (int)err;
    if ((err = make_bshd_map(&tv, v, B, S, Hkv, D, kTileK)) != cudaSuccess) return (int)err;
    const dim3 grid(Hq, B, n_qt);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    auto* lf = static_cast<float*>(lse);
    if (D == 128) {
      const int smem = SmemLayout<128>::kBytes;
      err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_bf16_kernel<128><<<grid, kHopperThreads, smem, st>>>(tq, tk, tv, ob, lf, S, Hq, Hkv, qscale, causal);
    } else {
      const int smem = SmemLayout<64>::kBytes;
      err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_bf16_kernel<64><<<grid, kHopperThreads, smem, st>>>(tq, tk, tv, ob, lf, S, Hq, Hkv, qscale, causal);
    }
  } else {
    const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
    const size_t smem =
        (size_t)((kBlockQ + kBlockK) * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1)) * sizeof(float);
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(out);
    if (D == 128) {
      err = cudaFuncSetAttribute(flash_fwd_f32_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_f32_kernel<128><<<grid, kThreads, smem, st>>>(qf, kf, vf, of, static_cast<float*>(lse), S, Hq,
                                                              Hkv, qscale, causal);
    } else {
      err = cudaFuncSetAttribute(flash_fwd_f32_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_f32_kernel<64><<<grid, kThreads, smem, st>>>(qf, kf, vf, of, static_cast<float*>(lse), S, Hq,
                                                             Hkv, qscale, causal);
    }
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory a bf16 launch asks for at D 64 or 128 (else -1).
int nexus_flash_fwd_smem_bytes(int D) {
  return D == 128 ? SmemLayout<128>::kBytes : D == 64 ? SmemLayout<64>::kBytes : -1;
}

const char* nexus_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
