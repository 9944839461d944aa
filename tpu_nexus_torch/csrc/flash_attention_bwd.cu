// Flash-attention backward for Hopper (sm_90a): the dQ kernel and the dK/dV
// kernel, bound to PyTorch through a plain C interface (ctypes; see
// tpu_nexus_torch/ops/_build.py).
//
// Replaces: tpu_nexus/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (launched by _flash_backward).  Same function: with q
// pre-scaled by scale*log2(e) and rounded to the input dtype (q~), the
// forward's natural-log lse and dsum = rowsum(dO*O) (f32, computed by the
// caller), per (query row i, key row j):
//     P  = exp2(q~_i.k_j - lse_i*log2(e))       (0 where causally masked)
//     dS = P * (dO_i.v_j - dsum_i)
//     dQ = scale * sum_j (dS->dtype) k_j                    (dQ kernel)
//     dV = sum_i (P->dtype)^T dO_i                         (dK/dV kernel)
//     dK = (1/log2(e)) * sum_i (dS->dtype)^T q~_i          (dK/dV kernel)
// dK and dV sum over the G query heads of each KV head inside the kernel
// (GQA), in f32, and are written once.  Layouts: q/dO/out [B,S,Hq,D],
// k/v [B,S,Hkv,D], lse/dsum [B,Hq,S] f32; grads in the input's layout and
// dtype.
//
// What bounds it on this card: at training shapes (S 2048, D 128) the
// work is 5 matmuls of S*S*D per head (halved by causality) against a few
// bytes per element of q/k/v/dO/grads -- far above the H100's ~295
// FLOP/byte ridge, so it is bound by the tensor cores.  Design, as the TPU
// split has it (no atomics, deterministic run to run):
//   * dQ: one CTA (4 warps) per (b, q head, 64-row Q tile), looping over the
//     KV tiles up to the diagonal; each warp owns 16 Q rows and keeps its dQ
//     accumulator in registers.  S = q~.K^T and dP = dO.V^T run on mma.sync
//     m16n8k16 (bf16 in, f32 accumulate); dS stays in registers and its
//     accumulator fragment is reused as the A operand of dS.K, rounded to
//     bf16 exactly where the TPU kernel rounds it.
//   * dK/dV: one CTA per (b, kv head, 64-row KV tile), looping over the G
//     query heads and the Q tiles from the diagonal on; each warp owns 16 KV
//     rows and computes the transposed tiles S^T = K.q~^T and dP^T = V.dO^T
//     in 32-column halves, so P^T and dS^T are A operands of P^T.dO and
//     dS^T.q~ without leaving registers.
// Tiles are staged through shared memory with 16-byte loads; only the
// diagonal and the ragged tail tiles pay for masking, so any S works without
// padding.  A simple first kernel: no cp.async pipelining, no wgmma/TMA.
//
// f32 inputs take CUDA-core FMA kernels in this file with the same grids and
// tiling (thread pairs own rows, as in the forward's f32 kernel), so the card
// can hold the kernel path against the plain path at f32 precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 row padding: keeps 16-byte row alignment, spreads banks
constexpr int kStride32 = 1;  // f32 row padding (words)
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint32_t pack_bf16_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Copy 64 rows of D bf16 (row r = sequence position s0+r of head h) into
// shared memory with 16-byte loads; rows past S are zeroed.  With qscale > 0
// each element is multiplied by it in f32 and rounded back to bf16 (q~).
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, int s0, int S, int heads, int h, int b,
                                               float qscale) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int s = s0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S) {
      val = *reinterpret_cast<const uint4*>(src + ((size_t)(b * S + s) * heads + h) * D + c * 8);
      if (qscale > 0.f) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * qscale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c * 8) = val;
  }
}

// A fragment (row-major 16x16, k-step kk) of rows [row0, row0+16) of a tile.
template <int D>
__device__ __forceinline__ void load_a_frag(uint32_t* a, const bf16* tile, int row0, int kk, int g, int t) {
  const bf16* base = tile + (row0 + g) * (D + kPad) + kk * 16 + 2 * t;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * (D + kPad));
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * (D + kPad) + 8);
}

// ---------------------------------------------------------------------------
// bf16 dQ kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
    bf16* __restrict__ dq, int S, int Hq, int Hkv, float qscale, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kBlockQ * (D + kPad);
  bf16* Ks = dOs + kBlockQ * (D + kPad);
  bf16* Vs = Ks + kBlockK * (D + kPad);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8

  load_tile_bf16<D>(Qs, q, q0, S, Hq, h, b, qscale);
  load_tile_bf16<D>(dOs, dout, q0, S, Hq, h, b, 0.f);
  float lse2[2], dsr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = row0 + 8 * i;
    const size_t idx = ((size_t)b * Hq + h) * S + s;
    lse2[i] = s < S ? lse[idx] * kLog2e : 0.f;
    dsr[i] = s < S ? dsum[idx] : 0.f;
  }

  float dqacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dqacc[n][0] = dqacc[n][1] = dqacc[n][2] = dqacc[n][3] = 0.f;

  const int n_tiles_all = (S + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(qt + 1, n_tiles_all) : n_tiles_all;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile (and Q/dO are staged)
    load_tile_bf16<D>(Ks, k, k0, S, Hkv, kvh, b, 0.f);
    load_tile_bf16<D>(Vs, v, k0, S, Hkv, kvh, b, 0.f);
    __syncthreads();

    float sacc[kBlockK / 8][4], dpacc[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = dpacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a_frag<D>(qa, Qs, warp * 16, kk, g, t);
      load_a_frag<D>(da, dOs, warp * 16, kk, g, t);
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        const bf16* kb = Ks + (j * 8 + g) * (D + kPad) + kk * 16 + 2 * t;
        mma_bf16_16816(sacc[j], qa, ld32(kb), ld32(kb + 8));
        const bf16* vb = Vs + (j * 8 + g) * (D + kPad) + kk * 16 + 2 * t;
        mma_bf16_16816(dpacc[j], da, ld32(vb), ld32(vb + 8));
      }
    }
    const bool masked = (causal && kt == qt) || (k0 + kBlockK > S);
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(sacc[j][e] - lse2[i]);
        if (masked) {
          const int row = row0 + 8 * i;
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= S || (causal && col > row)) p = 0.f;
        }
        sacc[j][e] = p * (dpacc[j][e] - dsr[i]);  // dS
      }
    }
    // dQ += (dS->bf16) . K: the accumulator fragment of n-tiles (2kk, 2kk+1)
    // is the A operand of k-step kk; K^T's B operand is K read row-wise.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      a[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      a[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      a[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
      const bf16* kb = Ks + (kk * 16 + 2 * t) * (D + kPad) + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* kc = kb + n * 8;
        const uint32_t b0 = pack_bf16_raw(kc[0], kc[D + kPad]);
        const uint32_t b1 = pack_bf16_raw(kc[8 * (D + kPad)], kc[9 * (D + kPad)]);
        mma_bf16_16816(dqacc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = row0 + 8 * i;
    if (s < S) {
      bf16* orow = dq + ((size_t)(b * S + s) * Hq + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        __nv_bfloat162 val = __floats2bfloat162_rn(dqacc[n][2 * i] * scale, dqacc[n][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) = val;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dK/dV kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Hq, int Hkv, float qscale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kBlockK * (D + kPad);
  bf16* Qs = Vs + kBlockK * (D + kPad);
  bf16* dOs = Qs + kBlockQ * (D + kPad);
  float* lse2s = reinterpret_cast<float*>(dOs + kBlockQ * (D + kPad));
  float* dsums = lse2s + kBlockQ;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = kt * kBlockK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int krow0 = k0 + warp * 16 + g;  // KV rows krow0 and krow0 + 8

  load_tile_bf16<D>(Ks, k, k0, S, Hkv, kvh, b, 0.f);
  load_tile_bf16<D>(Vs, v, k0, S, Hkv, kvh, b, 0.f);

  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[n][e] = dvacc[n][e] = 0.f;

  const int n_q_tiles = (S + kBlockQ - 1) / kBlockQ;
  const int qt_first = causal ? kt : 0;  // Q tiles wholly above the diagonal see none of these keys
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    for (int qt = qt_first; qt < n_q_tiles; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile_bf16<D>(Qs, q, q0, S, Hq, h, b, qscale);
      load_tile_bf16<D>(dOs, dout, q0, S, Hq, h, b, 0.f);
      if (threadIdx.x < kBlockQ) {
        const int s = q0 + threadIdx.x;
        const size_t idx = ((size_t)b * Hq + h) * S + s;
        lse2s[threadIdx.x] = s < S ? lse[idx] * kLog2e : 0.f;
        dsums[threadIdx.x] = s < S ? dsum[idx] : 0.f;
      }
      __syncthreads();
      const bool masked = (causal && qt == kt) || (q0 + kBlockQ > S);

#pragma unroll
      for (int half = 0; half < 2; ++half) {  // 32 query columns at a time
        const int c0 = half * 32;
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ka[4], va[4];
          load_a_frag<D>(ka, Ks, warp * 16, kk, g, t);
          load_a_frag<D>(va, Vs, warp * 16, kk, g, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bf16* qb = Qs + (c0 + j * 8 + g) * (D + kPad) + kk * 16 + 2 * t;
            mma_bf16_16816(st[j], ka, ld32(qb), ld32(qb + 8));
            const bf16* db = dOs + (c0 + j * 8 + g) * (D + kPad) + kk * 16 + 2 * t;
            mma_bf16_16816(dpt[j], va, ld32(db), ld32(db + 8));
          }
        }
        // P^T and dS^T: rows are KV rows, columns are query rows
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + j * 8 + 2 * t + (e & 1);
            float p = exp2f(st[j][e] - lse2s[c]);
            if (masked) {
              const int krow = krow0 + (e >= 2 ? 8 : 0);
              const int qrow = q0 + c;
              if (qrow >= S || (causal && krow > qrow)) p = 0.f;
            }
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - dsums[c]);
          }
        }
        // dV += (P^T->bf16) . dO and dK += (dS^T->bf16) . q~ over these 32
        // query rows (two k-steps of 16)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t pa[4], sa[4];
          pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
          pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
          pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
          pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
          sa[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
          sa[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
          sa[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
          sa[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
          const int r = c0 + kk * 16 + 2 * t;
          const bf16* db = dOs + r * (D + kPad) + g;
          const bf16* qb = Qs + r * (D + kPad) + g;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const bf16* dc = db + n * 8;
            mma_bf16_16816(dvacc[n], pa, pack_bf16_raw(dc[0], dc[D + kPad]),
                           pack_bf16_raw(dc[8 * (D + kPad)], dc[9 * (D + kPad)]));
            const bf16* qc = qb + n * 8;
            mma_bf16_16816(dkacc[n], sa, pack_bf16_raw(qc[0], qc[D + kPad]),
                           pack_bf16_raw(qc[8 * (D + kPad)], qc[9 * (D + kPad)]));
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = krow0 + 8 * i;
    if (s < S) {
      const size_t off = ((size_t)(b * S + s) * Hkv + kvh) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8 + 2 * t) =
            __floats2bfloat162_rn(dkacc[n][2 * i] * (1.f / kLog2e), dkacc[n][2 * i + 1] * (1.f / kLog2e));
        *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8 + 2 * t) =
            __floats2bfloat162_rn(dvacc[n][2 * i], dvacc[n][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 kernels (CUDA-core FMA): thread pair (2r, 2r+1) owns tile row r; each
// computes half of the row's 64 scores and accumulates half of its D outputs.
// ---------------------------------------------------------------------------

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
  return B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128) || (dtype != 0 && dtype != 1);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* dsum, void* dq, int B, int S, int Hq, int Hkv, int dtype, float qscale,
                      float scale, int causal, cudaStream_t st) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = (size_t)(2 * kBlockQ + 2 * kBlockK) * (D + kPad) * sizeof(bf16);
    err = set_smem(flash_bwd_dq_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, dsum, static_cast<bf16*>(dq), S, Hq, Hkv, qscale, scale, causal);
  } else {
    const size_t smem = ((size_t)(2 * kBlockQ + 2 * kBlockK) * (D + kStride32) + kBlockQ * (kBlockK + 1)) *
                        sizeof(float);
    err = set_smem(flash_bwd_dq_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, dsum, static_cast<float*>(dq), S, Hq, Hkv, qscale, scale, causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dsum, void* dk, void* dv, int B, int S, int Hq, int Hkv, int dtype,
                       float qscale, int causal, cudaStream_t st) {
  const dim3 grid((S + kBlockK - 1) / kBlockK, Hkv, B);
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = (size_t)(2 * kBlockQ + 2 * kBlockK) * (D + kPad) * sizeof(bf16) +
                        2 * kBlockQ * sizeof(float);
    err = set_smem(flash_bwd_dkv_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Hq, Hkv,
        qscale, causal);
  } else {
    const size_t smem = ((size_t)(2 * kBlockQ + 2 * kBlockK) * (D + kStride32) +
                         2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ) *
                        sizeof(float);
    err = set_smem(flash_bwd_dkv_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, dsum, static_cast<float*>(dk), static_cast<float*>(dv), S, Hq, Hkv,
        qscale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/k/v/dout/dq contiguous in [B,S,H,D];
// lse and dsum [B,Hq,S] f32.  qscale = softmax scale * log2(e) and scale,
// both computed by the caller in double precision.  Returns the launch's
// cudaGetLastError().
int nexus_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* dsum, void* dq, int B, int S, int Hq, int Hkv, int D, int dtype, float qscale,
                       float scale, int causal, void* stream) {
  if (bad_args(B, S, Hq, Hkv, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dsum);
  if (D == 128) return (int)launch_dq<128>(q, k, v, dout, l, ds, dq, B, S, Hq, Hkv, dtype, qscale, scale, causal, st);
  return (int)launch_dq<64>(q, k, v, dout, l, ds, dq, B, S, Hq, Hkv, dtype, qscale, scale, causal, st);
}

// Same conventions; dk/dv contiguous in [B,S,Hkv,D].
int nexus_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                        const void* dsum, void* dk, void* dv, int B, int S, int Hq, int Hkv, int D, int dtype,
                        float qscale, int causal, void* stream) {
  if (bad_args(B, S, Hq, Hkv, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dsum);
  if (D == 128) return (int)launch_dkv<128>(q, k, v, dout, l, ds, dk, dv, B, S, Hq, Hkv, dtype, qscale, causal, st);
  return (int)launch_dkv<64>(q, k, v, dout, l, ds, dk, dv, B, S, Hq, Hkv, dtype, qscale, causal, st);
}

}  // extern "C"
