// Dequant-inside-matmul for weight-only-quantized decode on Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes; see
// tpu_nexus_torch/ops/_build.py).
//
// Replaces: tpu_nexus/ops/quant_matmul.py::_int8_kernel and ::_int4_kernel
// (both launched by quant_matmul).  Same functions, y [M,N] in x's dtype
// from x [M,K] (bf16 or f32, M <= 256) with f32 accumulation:
//  * int8: W is q [K,N] int8 (N contiguous) with a per-output-channel scale
//    s [N] f32.  y = (x . q8) * s: the bytes convert to floats on the way to
//    the FMA, and the scale multiplies the f32 sum once, at finalize.
//  * int4: W is packed [K/2,N] int8, two sign-extended nibbles a byte in the
//    per-group half-split order (packed row i of a G-row group holds row i
//    in its low nibble and row i + G/2 in its high nibble), with group
//    scales s [K/G,N] f32.  Each value is nibble * s in f32, ROUNDED to x's
//    dtype, then multiplied into the f32 sum (the order the TPU kernel and
//    the plain version use; without the rounding bf16 results differ).
//
// What bounds it on this card: at decode-sized M every weight byte is read
// once for 2*M FLOP, far below the ridge, so the packed weight's bytes over
// the HBM rate are the bound.  Design:
//  * partial pass: one CTA per (128-column strip, K split, 8-row M tile);
//    the 4 warps take 32 rows each of a 128-row weight tile whose
//    activations are staged in shared memory.  N = 1024 gives only 8 strips,
//    so K is split across CTAs until the grid fills the CTAs resident on
//    the 132 SMs (4 each) in one even wave.
//  * f32 activations: the FMAs run on the CUDA cores.  A lane owns 4
//    adjacent columns, so a warp reads 128 contiguous bytes of one weight
//    row per load (32-bit loads, 8 rows in flight per lane), and the
//    activations are read as broadcast 16-byte loads.
//  * bf16 activations: mma.sync m16n8k16 with the weight as the A operand
//    (see the note above quant_matmul_mma_kernel): 16-byte weight loads, the
//    int8 -> bf16 convert (int4: unpack, scale, round) feeds the fragment
//    directly.  wgmma and a cp.async/TMA pipeline are later steps.
//  * no atomics: warps are summed in a fixed order in shared memory, splits
//    in a fixed order by the finalize pass (which also applies the int8
//    scale and casts), so a result is bit-identical run to run.
//  * ragged edges are masked in the kernel: any K and N, any even group
//    from 2 up to K; when N is not a multiple of the load width (4 bytes
//    f32 path, 16 bytes bf16 path) the wide loads fall back to byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;     // weight columns per CTA, 4 per lane
constexpr int kRowsM = 8;      // activation rows per CTA
constexpr int kTileRows = 128; // weight rows (int4: packed rows) per staged tile
constexpr int kWarpRows = kTileRows / kWarps;
constexpr int kUnroll = 8;     // weight rows a lane keeps in flight

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// The 4 weight bytes of columns [n0, n0+4) of one row, column n0 in the low
// byte: one 32-bit load where the pitch allows, else bytes masked at N.
__device__ __forceinline__ uint32_t load_w4(const int8_t* __restrict__ row, int n0, int N, bool aligned) {
  if (aligned && n0 + 3 < N) return __ldg(reinterpret_cast<const uint32_t*>(row + n0));
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n0 + c < N) w |= static_cast<uint32_t>(static_cast<uint8_t>(row[n0 + c])) << (8 * c);
  return w;
}

__device__ __forceinline__ void load_f4(float (&dst)[4], const float* __restrict__ row, int n0, int N, bool aligned) {
  if (aligned && n0 + 3 < N) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + n0));
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) dst[c] = (n0 + c < N) ? row[n0 + c] : 0.f;
}

// ---- f32 activations: CUDA-core FMAs ------------------------------------------
//
// rows = K (int8) or K/2 packed rows (int4); split i covers weight rows
// [i*rows_per_split, (i+1)*rows_per_split).  part [n_splits, M, N] f32.
// The int4 value nibble * s is already in x's dtype (f32): nothing to round.
template <bool kInt4>
__global__ void __launch_bounds__(kThreads, 4) quant_matmul_f32_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s, float* __restrict__ part,
    int M, int K, int N, int rows, int rows_per_split, int half_group, bool aligned) {
  constexpr int kX = kInt4 ? 2 : 1;  // activation rows staged per weight row
  __shared__ __align__(16) float x_s[kX][kTileRows][kRowsM];
  __shared__ __align__(16) float red_s[kWarps - 1][kRowsM][kCols];
  __shared__ int g_s[kTileRows];  // int4: the scale group of each packed row

  const int split = blockIdx.y, m0 = blockIdx.z * kRowsM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kCols + lane * 4;
  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, rows);

  float acc[kRowsM][4];
#pragma unroll
  for (int m = 0; m < kRowsM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  float sc[4] = {0.f, 0.f, 0.f, 0.f};  // int4: this lane's columns' scales of group sc_group
  int sc_group = -1;

  for (int r0 = r_begin; r0 < r_end; r0 += kTileRows) {
    __syncthreads();  // the previous tile's activations are fully consumed
    {
      // thread t stages the activations that weight row r0 + t multiplies
      const int r = r0 + threadIdx.x;
      int k_lo = r, k_hi = 0, g = 0;
      if (kInt4) {
        g = r / half_group;
        k_lo = g * 2 * half_group + (r - g * half_group);
        k_hi = k_lo + half_group;
        g_s[threadIdx.x] = g;
      }
      float lo[kRowsM], hi[kRowsM];
#pragma unroll
      for (int m = 0; m < kRowsM; ++m) {
        const bool ok = r < r_end && m0 + m < M;
        lo[m] = ok ? x[(size_t)(m0 + m) * K + k_lo] : 0.f;
        hi[m] = (kInt4 && ok) ? x[(size_t)(m0 + m) * K + k_hi] : 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(&x_s[0][threadIdx.x][0]);
      dst[0] = make_float4(lo[0], lo[1], lo[2], lo[3]);
      dst[1] = make_float4(lo[4], lo[5], lo[6], lo[7]);
      if (kInt4) {
        float4* dst_hi = reinterpret_cast<float4*>(&x_s[kX - 1][threadIdx.x][0]);
        dst_hi[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
        dst_hi[1] = make_float4(hi[4], hi[5], hi[6], hi[7]);
      }
    }
    __syncthreads();

    const int t_warp = warp * kWarpRows;  // this warp's first row within the tile
#pragma unroll
    for (int j0 = 0; j0 < kWarpRows; j0 += kUnroll) {
      uint32_t wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + t_warp + j0 + u;
        wv[u] = (r < r_end && n0 < N) ? load_w4(q + (size_t)r * N, n0, N, aligned) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t_warp + j0 + u;
        const float4 a0 = *reinterpret_cast<const float4*>(&x_s[0][t][0]);
        const float4 a1 = *reinterpret_cast<const float4*>(&x_s[0][t][4]);
        const float xa[kRowsM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        if (kInt4) {
          if (r0 + t < r_end && n0 < N) {  // uniform across the warp but for the column mask
            const int g = g_s[t];
            if (g != sc_group) {
              load_f4(sc, s + (size_t)g * N, n0, N, aligned);
              sc_group = g;
            }
          }
          const float4 b0 = *reinterpret_cast<const float4*>(&x_s[kX - 1][t][0]);
          const float4 b1 = *reinterpret_cast<const float4*>(&x_s[kX - 1][t][4]);
          const float xb[kRowsM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // arithmetic shifts sign-extend: low nibble = row i, high = row i + G/2
            const int lo_n = static_cast<int>(wv[u] << (28 - 8 * c)) >> 28;
            const int hi_n = static_cast<int>(wv[u] << (24 - 8 * c)) >> 28;
            const float w_lo = static_cast<float>(lo_n) * sc[c];
            const float w_hi = static_cast<float>(hi_n) * sc[c];
#pragma unroll
            for (int m = 0; m < kRowsM; ++m) {
              acc[m][c] = fmaf(xa[m], w_lo, acc[m][c]);
              acc[m][c] = fmaf(xb[m], w_hi, acc[m][c]);
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float wf = static_cast<float>(static_cast<int>(wv[u] << (24 - 8 * c)) >> 24);
#pragma unroll
            for (int m = 0; m < kRowsM; ++m) acc[m][c] = fmaf(xa[m], wf, acc[m][c]);
          }
        }
      }
    }
  }

  // sum the 4 warps in a fixed order, then write this split's partial
  if (warp > 0) {
#pragma unroll
    for (int m = 0; m < kRowsM; ++m)
      *reinterpret_cast<float4*>(&red_s[warp - 1][m][lane * 4]) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  if (warp == 0 && n0 < N) {
#pragma unroll
    for (int m = 0; m < kRowsM; ++m) {
#pragma unroll
      for (int w = 0; w < kWarps - 1; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(&red_s[w][m][lane * 4]);
        acc[m][0] += v.x; acc[m][1] += v.y; acc[m][2] += v.z; acc[m][3] += v.w;
      }
      if (m0 + m < M) {
        float* dst = part + ((size_t)split * M + m0 + m) * N + n0;
        if (aligned && n0 + 3 < N) {
          *reinterpret_cast<float4*>(dst) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n0 + c < N) dst[c] = acc[m][c];
        }
      }
    }
  }
}


// ---- bf16 activations: the tensor cores (mma.sync m16n8k16) -------------------
//
// The product is taken transposed, y^T [N,M] = W^T . x^T, so that the weight
// is the mma's A operand and the 8-row activation tile is exactly its n = 8.
// A's fragment wants pairs of values adjacent in k for one column; the weight
// is stored with n contiguous, so a lane loads 16 adjacent columns (16 bytes)
// of each of its k rows and pairs bytes from two rows while converting them,
// which costs nothing extra: every byte has to be converted anyway.  The 4
// lanes of a quad share 16 columns and split the 16 k slots of the mma; the 8
// quads of a warp cover the CTA's 128 columns, so one load instruction reads
// 128 contiguous bytes of each of 4 rows.  Which weight row sits in which k
// slot is free as long as x follows: int8 uses rows in order, int4 puts the
// low nibbles of 8 packed rows in slots 0-7 and their high nibbles (rows
// G/2 further on) in slots 8-15, so a packed row is unpacked in place.

constexpr int kXPad = 8;  // bf16 of padding per staged activation row: conflict-free fragment loads

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 16 weight bytes of columns [n0, n0+16) of one row, column n0 in the
// low byte of .x: one 16-byte load where the pitch allows, else bytes
// masked at N.
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ row, int n0, int N, bool aligned) {
  if (aligned && n0 + 15 < N) return __ldg(reinterpret_cast<const uint4*>(row + n0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (n0 + c < N) w[c / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[n0 + c])) << (8 * (c % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// byte c (0..15) of a 16-byte row as a signed value; its low / high nibble sign-extended
__device__ __forceinline__ float byte_of(const uint4& v, int c) {
  return static_cast<float>(static_cast<int>(word_of(v, c / 4) << (24 - 8 * (c % 4))) >> 24);
}
__device__ __forceinline__ float lo_nibble_of(const uint4& v, int c) {
  return static_cast<float>(static_cast<int>(word_of(v, c / 4) << (28 - 8 * (c % 4))) >> 28);
}
__device__ __forceinline__ float hi_nibble_of(const uint4& v, int c) {
  return static_cast<float>(static_cast<int>(word_of(v, c / 4) << (24 - 8 * (c % 4))) >> 28);
}

template <bool kInt4>
__global__ void __launch_bounds__(kThreads, 4) quant_matmul_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ part, int M, int K, int N, int rows, int rows_per_split, int half_group, bool aligned,
    bool x_aligned) {
  constexpr int kX = kInt4 ? 2 : 1;            // staged activation rows per weight row
  constexpr int kPitch = kTileRows + kXPad;    // bf16 per staged activation row
  constexpr int kBlockRows = kInt4 ? 8 : 16;   // weight rows (packed rows) per mma k block
  constexpr int kLoads = kInt4 ? 2 : 4;        // 16-byte rows a lane loads per k block
  __shared__ __align__(16) __nv_bfloat16 x_s[kX][kRowsM][kPitch];
  __shared__ __align__(16) float red_s[kWarps - 1][kRowsM][kCols];
  __shared__ int g_s[kTileRows];  // int4: the scale group of each packed row

  const int split = blockIdx.y, m0 = blockIdx.z * kRowsM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kCols + g * 16;  // this quad's 16 columns
  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, rows);

  float acc[8][4];  // [column pair][(c0,m=2t), (c0,2t+1), (c1,2t), (c1,2t+1)]
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float sc[2][16];  // int4: the scales of this lane's columns for its two packed rows' groups
  int sc_group[2] = {-1, -1};
  if (kInt4) {
#pragma unroll
    for (int c = 0; c < 16; ++c) sc[0][c] = sc[1][c] = 0.f;
  }

  for (int r0 = r_begin; r0 < r_end; r0 += kTileRows) {
    __syncthreads();  // the previous tile's activations are fully consumed
    if (kInt4) {
      // thread j stages the two activations packed row r0 + j multiplies
      const int j = threadIdx.x, r = r0 + j;
      const int grp = r / half_group;
      const int k_lo = grp * 2 * half_group + (r - grp * half_group), k_hi = k_lo + half_group;
      g_s[j] = grp;
#pragma unroll
      for (int m = 0; m < kRowsM; ++m) {
        const bool ok = r < r_end && m0 + m < M;
        x_s[0][m][j] = ok ? x[(size_t)(m0 + m) * K + k_lo] : __float2bfloat16_rn(0.f);
        x_s[kX - 1][m][j] = ok ? x[(size_t)(m0 + m) * K + k_hi] : __float2bfloat16_rn(0.f);
      }
    } else {
      // thread i stages 8 adjacent k of one activation row
      const int m = threadIdx.x / 16, j = (threadIdx.x % 16) * 8;
      const __nv_bfloat16* src = x + (size_t)(m0 + m) * K + r0 + j;
      if (x_aligned && m0 + m < M && r0 + j + 7 < r_end) {
        *reinterpret_cast<uint4*>(&x_s[0][m][j]) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          x_s[0][m][j + e] = (m0 + m < M && r0 + j + e < r_end) ? src[e] : __float2bfloat16_rn(0.f);
      }
    }
    __syncthreads();

#pragma unroll
    for (int blk = 0; blk < kWarpRows / kBlockRows; ++blk) {
      const int jl = warp * kWarpRows + blk * kBlockRows;  // the block's first row within the tile
      // int8: rows 2t, 2t+1, 2t+8, 2t+9 of the block; int4: packed rows 2t, 2t+1
      uint4 w[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int r = r0 + jl + 2 * t + (i & 1) + (i >> 1) * 8;
        w[i] = (r < r_end && n0 < N) ? load_w16(q + (size_t)r * N, n0, N, aligned) : make_uint4(0u, 0u, 0u, 0u);
      }
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&x_s[0][g][jl + 2 * t]);
      const uint32_t b1 = kInt4 ? *reinterpret_cast<const uint32_t*>(&x_s[kX - 1][g][jl + 2 * t])
                                : *reinterpret_cast<const uint32_t*>(&x_s[0][g][jl + 2 * t + 8]);
      if (kInt4) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + jl + 2 * t + i;
          if (r < r_end && n0 < N) {
            const int grp = g_s[jl + 2 * t + i];
            if (grp != sc_group[i]) {
#pragma unroll
              for (int c4 = 0; c4 < 4; ++c4) {
                float v[4];
                load_f4(v, s + (size_t)grp * N, n0 + 4 * c4, N, aligned);
                sc[i][4 * c4] = v[0]; sc[i][4 * c4 + 1] = v[1]; sc[i][4 * c4 + 2] = v[2]; sc[i][4 * c4 + 3] = v[3];
              }
              sc_group[i] = grp;
            }
          }
        }
      }
#pragma unroll
      for (int cp = 0; cp < 8; ++cp) {
        const int c0 = 2 * cp, c1 = c0 + 1;
        uint32_t a[4];
        if (kInt4) {
          // slots 2t, 2t+1: the low nibbles of packed rows 2t, 2t+1; slots 2t+8, 2t+9: their high nibbles
          a[0] = pack_bf16(lo_nibble_of(w[0], c0) * sc[0][c0], lo_nibble_of(w[1], c0) * sc[1][c0]);
          a[1] = pack_bf16(lo_nibble_of(w[0], c1) * sc[0][c1], lo_nibble_of(w[1], c1) * sc[1][c1]);
          a[2] = pack_bf16(hi_nibble_of(w[0], c0) * sc[0][c0], hi_nibble_of(w[1], c0) * sc[1][c0]);
          a[3] = pack_bf16(hi_nibble_of(w[0], c1) * sc[0][c1], hi_nibble_of(w[1], c1) * sc[1][c1]);
        } else {
          a[0] = pack_bf16(byte_of(w[0], c0), byte_of(w[1], c0));
          a[1] = pack_bf16(byte_of(w[0], c1), byte_of(w[1], c1));
          a[2] = pack_bf16(byte_of(w[kLoads - 2], c0), byte_of(w[kLoads - 1], c0));
          a[3] = pack_bf16(byte_of(w[kLoads - 2], c1), byte_of(w[kLoads - 1], c1));
        }
        mma_bf16_16816(acc[cp], a, b0, b1);
      }
    }
  }

  // sum the 4 warps in a fixed order, then write this split's partial:
  // this lane holds activation rows 2t, 2t+1 of its quad's 16 columns
  if (warp > 0) {
#pragma unroll
    for (int cp = 0; cp < 8; ++cp) {
      *reinterpret_cast<float2*>(&red_s[warp - 1][2 * t][g * 16 + 2 * cp]) = make_float2(acc[cp][0], acc[cp][2]);
      *reinterpret_cast<float2*>(&red_s[warp - 1][2 * t + 1][g * 16 + 2 * cp]) = make_float2(acc[cp][1], acc[cp][3]);
    }
  }
  __syncthreads();
  if (warp == 0 && n0 < N) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = 2 * t + i;
      float row[16];
#pragma unroll
      for (int cp = 0; cp < 8; ++cp) {
        row[2 * cp] = acc[cp][i];
        row[2 * cp + 1] = acc[cp][2 + i];
      }
#pragma unroll
      for (int w = 0; w < kWarps - 1; ++w)
#pragma unroll
        for (int c = 0; c < 16; ++c) row[c] += red_s[w][m][g * 16 + c];
      if (m0 + m < M) {
        float* dst = part + ((size_t)split * M + m0 + m) * N + n0;
        if (aligned && n0 + 15 < N) {
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4)
            reinterpret_cast<float4*>(dst)[c4] = make_float4(row[4 * c4], row[4 * c4 + 1], row[4 * c4 + 2], row[4 * c4 + 3]);
        } else {
#pragma unroll
          for (int c = 0; c < 16; ++c)
            if (n0 + c < N) dst[c] = row[c];
        }
      }
    }
  }
}

// y[m,n] = T(sum over splits of part[sp,m,n] (* s[n] for int8)), splits in order
template <typename T>
__global__ void __launch_bounds__(256) quant_matmul_finalize_kernel(
    const float* __restrict__ part, const float* __restrict__ s, T* __restrict__ y, int M, int N, int n_splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) sum += part[(size_t)sp * total + i];
  if (s) sum *= s[i % N];
  store_out(y + i, sum);
}

template <typename T, bool kInt4>
cudaError_t launch(const void* x, const void* q, const void* s, void* y, void* part, int M, int K, int N,
                   int half_group, int rows_per_split, int n_splits, cudaStream_t st) {
  const int rows = kInt4 ? K / 2 : K;
  const auto at = [](const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; };
  const dim3 grid((N + kCols - 1) / kCols, n_splits, (M + kRowsM - 1) / kRowsM);
  if (std::is_same<T, __nv_bfloat16>::value) {
    // bf16: tensor cores, 16-byte weight loads
    const bool aligned = N % 16 == 0 && at(q, 16) && at(s, 16) && at(part, 16);
    quant_matmul_mma_kernel<kInt4><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(part), M, K, N, rows, rows_per_split, half_group, aligned, K % 8 == 0 && at(x, 16));
  } else {
    // f32: CUDA-core FMAs, 4-byte weight loads
    const bool aligned = N % 4 == 0 && at(q, 4) && at(s, 16) && at(part, 16);
    quant_matmul_f32_kernel<kInt4><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(part), M, K, N, rows, rows_per_split, half_group, aligned);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * N;
  quant_matmul_finalize_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), kInt4 ? nullptr : static_cast<const float*>(s), static_cast<T*>(y), M, N,
      n_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y).  x [M,K], y [M,N] and the
// f32 workspace part [n_splits,M,N], all contiguous.  half_group = 0: int8,
// q [K,N] int8 and s [N] f32.  half_group = G/2 > 0: int4, q [K/2,N] packed
// and s [K/G,N] f32.  Split i covers weight rows (packed rows for int4)
// [i*rows_per_split, (i+1)*rows_per_split); rows_per_split must be a
// multiple of 128 and n_splits must cover all rows.  Returns the launches'
// cudaGetLastError().
int nexus_quant_matmul(const void* x, const void* q, const void* s, void* y, void* part, int M, int K, int N,
                       int half_group, int rows_per_split, int n_splits, int dtype, void* stream) {
  const bool int4 = half_group > 0;
  if (M <= 0 || K <= 0 || N <= 0 || half_group < 0 || (dtype != 0 && dtype != 1) || rows_per_split <= 0 ||
      rows_per_split % kTileRows != 0 || n_splits <= 0 || n_splits > 65535 || (M + kRowsM - 1) / kRowsM > 65535)
    return (int)cudaErrorInvalidValue;
  if (int4 && K % (2 * half_group) != 0) return (int)cudaErrorInvalidValue;
  const int rows = int4 ? K / 2 : K;
  if ((long long)n_splits * rows_per_split < rows || (long long)(n_splits - 1) * rows_per_split >= rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = int4 ? launch<__nv_bfloat16, true>(x, q, s, y, part, M, K, N, half_group, rows_per_split, n_splits, st)
               : launch<__nv_bfloat16, false>(x, q, s, y, part, M, K, N, half_group, rows_per_split, n_splits, st);
  } else {
    err = int4 ? launch<float, true>(x, q, s, y, part, M, K, N, half_group, rows_per_split, n_splits, st)
               : launch<float, false>(x, q, s, y, part, M, K, N, half_group, rows_per_split, n_splits, st);
  }
  return (int)err;
}

}  // extern "C"
