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
// work is 4*B*Hq*S^2*D/2 FLOP against (q+k+v+out) bytes, i.e. far above
// the H100's ~295 FLOP/byte ridge, so it is bound by the tensor cores.
// Design: one CTA (4 warps) per (b, q head, 64-row Q tile); each warp owns
// 16 Q rows and keeps its Q fragments, S tile and O accumulator in
// registers; K/V tiles of 64 rows are staged through shared memory with
// 16-byte loads; S = Q.K^T and O += P.V run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate).  Tiles wholly above the
// causal diagonal are never visited; only the diagonal tile and the ragged
// tail tile pay for masking, so any S works without padding.  A simple
// first kernel: no cp.async pipelining, no wgmma/TMA/warp specialisation.
//
// f32 inputs take a CUDA-core FMA kernel in this file with the same grid,
// tiling and softmax, so the card can hold the kernel path against the
// plain path to token identity in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 row padding: keeps 16-byte row alignment, spreads banks
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows` rows of D bf16 (row r of the tile is sequence position s0+r of
// head h) into shared memory with 16-byte loads; rows past S are zeroed.
// With `qscale` > 0 each element is multiplied by it in f32 and rounded back
// to bf16 (the q prescale of the TPU kernel).
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src, int s0, int S,
                                               int heads, int h, int b, float qscale) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int s = s0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S) {
      val = *reinterpret_cast<const uint4*>(src + ((size_t)(b * S + s) * heads + h) * D + c * 8);
      if (qscale > 0.f) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * qscale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int S, int Hq, int Hkv, float qscale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * (D + kPad);
  __nv_bfloat16* Vs = Ks + kBlockK * (D + kPad);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_tile_bf16<D>(Qs, q, q0, S, Hq, h, b, qscale);
  __syncthreads();

  // Q fragments (A operand, row-major 16x16 per k-step) stay in registers.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = Qs + (warp * 16 + g) * (D + kPad) + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * (D + kPad));
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * (D + kPad) + 8);
  }

  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};  // this thread's partial row sums
  const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8

  const int n_tiles_all = (S + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(qt + 1, n_tiles_all) : n_tiles_all;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(Ks, k, k0, S, Hkv, kvh, b, 0.f);
    load_tile_bf16<D>(Vs, v, k0, S, Hkv, kvh, b, 0.f);
    __syncthreads();

    float sacc[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kb = Ks + (j * 8 + g) * (D + kPad) + kk * 16 + 2 * t;
        mma_bf16_16816(sacc[j], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                       *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }
    const bool masked = (causal && kt == qt) || (k0 + kBlockK > S);
    if (masked) {
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >= 2 ? 8 : 0);
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= S || (causal && col > row)) sacc[j][e] = -INFINITY;
        }
      }
    }
    // online softmax, exp2 domain (scores are already log2-scaled via q)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sacc[j][0], sacc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sacc[j][2], sacc[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffff, mx[i], 2));
      const float m_new = fmaxf(m_row[i], mx[i]);
      alpha[i] = (m_row[i] == -INFINITY) ? 0.f : exp2f(m_row[i] - m_new);
      m_row[i] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float s = sacc[j][e];
        const float p = (s == -INFINITY) ? 0.f : exp2f(s - m_row[i]);
        sacc[j][e] = p;
        psum[i] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_row[i] = l_row[i] * alpha[i] + psum[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }
    // O += P.V: the S accumulator layout of n-tiles (2kk, 2kk+1) is exactly
    // the A-operand layout of k-step kk, so P never leaves registers (it is
    // rounded to bf16 here, as the TPU kernel rounds p before its P.V dot)
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      pa[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      pa[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
      const __nv_bfloat16* vb = Vs + (kk * 16 + 2 * t) * (D + kPad) + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vc = vb + n * 8;
        const uint32_t b0 = pack_bf16_raw(vc[0], vc[D + kPad]);
        const uint32_t b1 = pack_bf16_raw(vc[8 * (D + kPad)], vc[9 * (D + kPad)]);
        mma_bf16_16816(oacc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_row[i];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    const int s = row0 + 8 * i;
    if (s < S) {
      __nv_bfloat16* orow = out + ((size_t)(b * S + s) * Hq + h) * D;
      const float inv = 1.f / l_safe;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        __nv_bfloat162 val = __floats2bfloat162_rn(oacc[n][2 * i] * inv, oacc[n][2 * i + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) = val;
      }
      if (t == 0) lse[((size_t)b * Hq + h) * S + s] = m_row[i] * (1.f / kLog2e) + logf(l_safe);
    }
  }
}

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
// caller in double precision.  Returns the launch's cudaGetLastError().
int nexus_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S, int Hq,
                    int Hkv, int D, int dtype, float qscale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = (size_t)(kBlockQ + 2 * kBlockK) * (D + kPad) * sizeof(__nv_bfloat16);
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (D == 128) {
      err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_bf16_kernel<128><<<grid, kThreads, smem, st>>>(qb, kb, vb, ob, static_cast<float*>(lse), S, Hq,
                                                               Hkv, qscale, causal);
    } else {
      err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      flash_fwd_bf16_kernel<64><<<grid, kThreads, smem, st>>>(qb, kb, vb, ob, static_cast<float*>(lse), S, Hq,
                                                              Hkv, qscale, causal);
    }
  } else {
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

const char* nexus_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
