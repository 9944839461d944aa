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
// the HBM rate are the bound.
//
// int4 with bf16 activations (the quantized decode step's path) is one
// launch of quant_int4_ring_kernel, built for that bound:
//  * even bytes per SM: the work is a stream-K walk over units of one ring
//    stage (64 packed rows x a 128-column strip, for each 8-row M chunk).
//    The units, strip after strip, are cut into equal contiguous runs, one
//    for each persistent CTA (ops/quant_matmul.py::int4_plan): no thin last
//    wave.  Where the strips are fewer than the CTAs, each strip is cut
//    into the same number of runs, so no run straddles two strips.
//  * the K split merged in the launch: a CTA whose run covers a whole strip
//    writes y; a strip shared by several CTAs gets each one's f32 partial
//    in a workspace (it stays in L2), and the last CTA to arrive, told by a
//    per-strip arrival counter, sums the partials in CTA order (k order),
//    writes y in bf16 and sets the counter back to 0.  A run shares at most
//    its first and its last strip; their sums wait in registers and are
//    published together once the run is streamed.  No atomics on values:
//    bit-identical run to run.  No second launch.
//  * a ring fed by a producer warp: TMA brings each stage's packed tile
//    (a 2-D map over [K/2, N] int8, 128-byte swizzle, zero fill past the
//    edges) and its group-scale rows (a map over [K/G, N] f32) into an
//    8-stage mbarrier ring; the producer's lanes copy the stage's
//    activations beside them with 16-byte cp.async, already in the
//    kernel's k-slot order (per stage, not once a CTA: at K 14336 a run's
//    activations would not fit beside the ring).  One CTA an SM keeps
//    ~72 KB of weight in flight (two CTAs with 5 stages each read slower:
//    the probe's stages5_two_ctas).
//  * dequant by bit operations: the nibbles are made offset-binary
//    (n ^ 8 = n + 8) and byte-permuted into the mantissa of 2^23
//    (0x4B000000 | u is the float 2^23 + u); one FADD of -(2^23 + 8) gives
//    n exactly and one FMUL rounds n * s once, the f32 product of the plain
//    version and the TPU kernel; one cvt.rn.bf16x2 rounds two values to x's
//    dtype.  No int -> float conversion on the weights (the kernel's few
//    I2F belong to the 32-bit divisions of its run bounds).
//  * what sets its pace, measured (chip_smoke.py --phases build,int4_probe;
//    PERF.md): not HBM.  The ring alone streams the decode step's largest
//    weight at about two thirds of the HBM rate; the consumers' dequant
//    (~6 instructions a weight value with the addressing, at ~2 IPC) and
//    the merge at the end (dependent round trips to L2) add to it.
//  * tensor cores: mma.sync m16n8k16 with the weight as A (the layout note
//    above quant_matmul_mma_kernel), eight consumer warps taking one 8-row
//    k block of each stage.  At M 8 the products are ~1 us of tensor-core
//    time against a ~10 us byte bound, so the synchronous mma, which takes
//    A from the registers the dequant writes, costs nothing that matters;
//    M above 8 runs one 8-row chunk a tile, chunks of one strip next to
//    each other in the walk so their weight reads meet in L2.
//  * shapes it takes: N % 16 == 0 (TMA's 16-byte row pitch), G % 16 == 0 (a
//    k block of 8 packed rows in one group, a 16-byte activation copy in
//    one group half), 16-byte-aligned operands.  Any other int4 shape takes
//    quant_matmul_mma_kernel<true> and its finalize pass (the "pitch
//    branch"), chosen from the shape before launch.
//
// The other paths keep their first design:
//  * partial pass: one CTA per (128-column strip, K split, 8-row M tile);
//    the 4 warps take 32 rows each of a 128-row weight tile whose
//    activations are staged in shared memory.  N = 1024 gives only 8 strips,
//    so K is split across CTAs until the grid fills the CTAs resident on
//    the 132 SMs (4 each) in one even wave.
//  * f32 activations: the FMAs run on the CUDA cores.  A lane owns 4
//    adjacent columns, so a warp reads 128 contiguous bytes of one weight
//    row per load (32-bit loads, 8 rows in flight per lane), and the
//    activations are read as broadcast 16-byte loads.
//  * bf16 activations (int8, and int4's pitch branch): mma.sync m16n8k16
//    with the weight as the A operand (see the note above
//    quant_matmul_mma_kernel): 16-byte weight loads, the int8 -> bf16
//    convert (int4: unpack, scale, round) feeds the fragment directly.
//  * no atomics: warps are summed in a fixed order in shared memory, splits
//    in a fixed order by the finalize pass (which also applies the int8
//    scale and casts), so a result is bit-identical run to run.
//  * ragged edges are masked in the kernel: any K and N, any even group
//    from 2 up to K; when N is not a multiple of the load width (4 bytes
//    f32 path, 16 bytes bf16 path) the wide loads fall back to byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace nexus_hopper;

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

// ---- int4, bf16 activations: the ring kernel --------------------------------------------
//
// A persistent CTA of eight consumer warps and one producer warp walks its run [begin, end) of
// the units (see the source note): unit u is stage kb = u % n_kb (packed rows [64 kb, 64 kb +
// 64)) of tile u / n_kb, and tile = strip * n_mc + (8-row M chunk).  Stage by stage the producer
// brings the unit's packed tile, its scale rows and its activations into the ring; consumer warp
// w dequantizes packed rows 8w .. 8w + 7 of the stage into the A fragments of eight m16n8k16 mma
// (the k-slot order of quant_matmul_mma_kernel<true>: the low nibbles of the 8 rows in slots 0-7,
// the high nibbles in 8-15) against the 8 activation rows staged in that slot order.
//
// A run holds at most two tiles it shares with other CTAs: its first (slot 0) and its last (slot
// 1).  Their sums are kept in registers, and published (partial, fence, arrival) together once
// the run is streamed: the round trips to L2 that a merge needs never stall the ring mid-run.

constexpr int kRingWarps = 8;                        // consumer warps: one 8-row k block of a stage each
constexpr int kRingThreads = (kRingWarps + 1) * 32;  // + the producer warp
constexpr int kRingRows = 8 * kRingWarps;            // packed rows a stage
constexpr int kRingStages = 8;
constexpr int kRingCtasPerSm = 1;  // the ring's 147 KB of shared memory: one CTA an SM
constexpr int kMaxScaleRows = 8;                     // groups a stage can touch (G % 16 == 0)
constexpr int kRingXPitch = 2 * kRingRows + kXPad;   // bf16 a staged activation row: 64 low, 64 high slots
constexpr int kRedPitch = kCols + 4;                 // f32 a row of a warp's sums: fewer bank conflicts

struct RingSmem {  // byte offsets from a 1024-byte-aligned base
  static constexpr int kPackedBytes = kRingRows * kCols;         // a stage's packed tile (128B swizzle)
  static constexpr int kScaleBytes = kMaxScaleRows * kCols * 4;  // its scale rows [rows][128] f32
  static constexpr int kXBytes = kRowsM * kRingXPitch * 2;       // its activations [8][136] bf16
  static constexpr int kPacked = 0;
  static constexpr int kScales = kPacked + kRingStages * kPackedBytes;
  static constexpr int kX = kScales + kRingStages * kScaleBytes;
  static constexpr int kRed = kX + kRingStages * kXBytes;                   // [warp][8 rows][kRedPitch] f32
  static constexpr int kFlag = kRed + kRingWarps * kRowsM * kRedPitch * 4;  // int[2]: merges of slots 0, 1
  static constexpr int kBar = kFlag + 16;                                   // full[stages], empty[stages]
  static constexpr int kBytes = kBar + 2 * kRingStages * 8 + 1024;          // + alignment slack
};

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and Montgomery's round-up method;
// make_divider gives the magic number).  The packed rows' groups, at every stage.
struct Divider {
  uint32_t mul, shift;
  __device__ __forceinline__ int operator()(int n) const {
    return static_cast<int>((__umulhi(static_cast<uint32_t>(n), mul) + static_cast<uint32_t>(n)) >> shift);
  }
};

Divider make_divider(uint32_t d) {
  uint32_t shift = 0;
  while ((1ull << shift) < d) ++shift;
  return {static_cast<uint32_t>((((1ull << shift) - d) << 32) / d + 1), shift};
}

// The bits of 2^23 as f32.  Read from constant memory (the compiler cannot fold it), so the byte
// permute below takes it as its constant-bank operand and keeps its selector immediate, instead of
// materializing a selector register for every value.
__constant__ uint32_t kTwoPow23Bits = 0x4B000000u;

// One weight value from four offset-binary nibbles (n + 8 in the low 4 bits of each byte): byte j
// permuted into the mantissa of 2^23 is the float 2^23 + n + 8, exact; subtracting 2^23 + 8 gives
// n exactly, and the product with the group scale rounds once: the f32 n * s of the plain version.
__device__ __forceinline__ float int4_value(uint32_t nibbles, int j, float s) {
  return (__uint_as_float(__byte_perm(nibbles, kTwoPow23Bits, 0x7650 + j)) - 8388616.f) * s;
}

// CTA c's run of units starts at c * units / grid; owner(u) is the CTA whose run holds unit u
// (grid * units < 2^32: the launch checks it).  Divisions once a CTA and once a merged tile.
__device__ __forceinline__ int run_begin(int c, int units) {
  return static_cast<int>(static_cast<uint32_t>(c) * static_cast<uint32_t>(units) / gridDim.x);
}
__device__ __forceinline__ int run_owner(int u, int units) {
  return static_cast<int>((static_cast<uint32_t>(u + 1) * gridDim.x - 1) / static_cast<uint32_t>(units));
}

// counter += 1 at GPU scope with acquire-release semantics; returns the value before
__device__ __forceinline__ unsigned arrive_acq_rel(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// 4 adjacent outputs of y, rounded to bf16
__device__ __forceinline__ void store_y4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// tm_q: packed [K/2, N] uint8, boxes of 64 rows x 128 columns, 128-byte swizzle.  tm_s: scales
// [K/G, N] f32, boxes of scale_rows rows x 128 columns.  part: [grid][2][8][128] f32, a CTA's
// partials of its first (0) and last (1) tile; arrivals: [tiles] counters, 0 between launches.
__global__ void __launch_bounds__(kRingThreads, kRingCtasPerSm) quant_int4_ring_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_s,
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, float* __restrict__ part,
    unsigned* __restrict__ arrivals, int M, int K, int N, int half_group, int scale_rows, int n_kb, int n_mc,
    int units, Divider div_h8) {
  extern __shared__ __align__(16) unsigned char ring_smem_raw[];
  // aligned by an offset from the array (not through an integer), so the compiler keeps every
  // access below in the shared window (LDS/STS, not generic loads)
  unsigned char* smem = ring_smem_raw + ((1024 - (smem_u32(ring_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RingSmem::kBar);
  uint64_t* empty = full + kRingStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int begin = run_begin(blockIdx.x, units), end = run_begin(blockIdx.x + 1, units);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kRingStages; ++st) {
      mbar_init(&full[st], 1 + 32);  // the TMA's expect_tx, the producer lanes' cp.async
      mbar_init(&empty[st], kRingWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kRingWarps) {
    // producer warp: lane 0 issues the TMA loads, every lane copies 4 x 16 bytes of activations
    if (lane == 0) {
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_s);
    }
    const int rows = K / 2, m_in = lane / 4;
    // the walk's position, stepped (no division a stage): tile = strip * n_mc + mc, stage kb
    int kb = begin % n_kb, mc = (begin / n_kb) % n_mc, strip = begin / n_kb / n_mc, st = 0, phase = 0;
    for (int u = begin; u < end; ++u) {
      const int m = mc * kRowsM + m_in;
      mbar_wait(&empty[st], phase ^ 1);  // the first round passes at once
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], RingSmem::kPackedBytes + scale_rows * kCols * 4);
        tma_load_3d(smem + RingSmem::kPacked + st * RingSmem::kPackedBytes, &tm_q, &full[st], strip * kCols,
                    kb * kRingRows, 0);
        tma_load_3d(smem + RingSmem::kScales + st * RingSmem::kScaleBytes, &tm_s, &full[st], strip * kCols,
                    div_h8(kb * 8), 0);
      }
      // activation row m_in, chunks of 8 slots: 0-7 the low slots (packed rows 8j .. 8j + 7 of the
      // stage), 8-15 the high slots.  Packed row r of group grp holds K index r + grp * G/2 in its
      // low nibble and that + G/2 in its high one; G % 16 == 0 keeps a chunk in one group half.
      const uint32_t xs = smem_u32(smem + RingSmem::kX + st * RingSmem::kXBytes) + m_in * kRingXPitch * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ch = (lane % 4) * 4 + i, jc = ch % 8, r = kb * kRingRows + jc * 8;
        const int k = r + (div_h8(kb * 8 + jc) + ch / 8) * half_group;
        const bool ok = m < M && r < rows;
        cp_async_16(xs + ((ch / 8) * kRingRows + jc * 8) * 2, ok ? x + static_cast<size_t>(m) * K + k : x,
                    ok ? 16 : 0);
      }
      cp_async_mbar_arrive(&full[st]);
      if (++st == kRingStages) st = 0, phase ^= 1;
      if (++kb == n_kb) {
        kb = 0;
        if (++mc == n_mc) mc = 0, ++strip;
      }
    }
  } else {
    // consumer warps
    const int g = lane / 4, t = lane % 4;
    const int m_in = threadIdx.x / 32, col = (threadIdx.x % 32) * 4;  // this thread's 4 outputs of a tile
    float* red = reinterpret_cast<float*>(smem + RingSmem::kRed);
    int* merges = reinterpret_cast<int*>(smem + RingSmem::kFlag);
    int shared_tile[2] = {-1, -1};  // the run's first (0) and last (1) tile shared with other CTAs
    float4 shared_sum[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    int st = 0, phase = 0;
    for (int u = begin; u < end;) {
      const int tile = u / n_kb, tile_begin = tile * n_kb;  // one division a tile
      const int seg_begin = u, seg_end = min(end, tile_begin + n_kb);
      float acc[8][4];  // [column pair][(c0, m 2t), (c0, 2t+1), (c1, 2t), (c1, 2t+1)]
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      for (; u < seg_end; ++u) {
        const int kb = u - tile_begin;
        mbar_wait(&full[st], phase);
        // packed rows 8w + 2t and 8w + 2t + 1, columns 16g .. 16g + 15 (chunk g, swizzled by row)
        const unsigned char* pk = smem + RingSmem::kPacked + st * RingSmem::kPackedBytes + (8 * warp + 2 * t) * kCols;
        const uint4 w0 = *reinterpret_cast<const uint4*>(pk + ((g ^ (2 * t)) << 4));
        const uint4 w1 = *reinterpret_cast<const uint4*>(pk + kCols + ((g ^ (2 * t + 1)) << 4));
        // the k block's group (G % 16 == 0: one group for its 8 rows), as a row of the staged scales
        const float* srow = reinterpret_cast<const float*>(smem + RingSmem::kScales + st * RingSmem::kScaleBytes) +
                            (div_h8(kb * 8 + warp) - div_h8(kb * 8)) * kCols + g * 16;
        float sc[16];
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const float4 v = reinterpret_cast<const float4*>(srow)[c4];
          sc[4 * c4] = v.x, sc[4 * c4 + 1] = v.y, sc[4 * c4 + 2] = v.z, sc[4 * c4 + 3] = v.w;
        }
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(smem + RingSmem::kX + st * RingSmem::kXBytes) +
                                  g * kRingXPitch + 8 * warp + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xs);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xs + kRingRows);
        const uint32_t r0[4] = {w0.x, w0.y, w0.z, w0.w}, r1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // columns 4q .. 4q + 3: word q of each row
          const uint32_t lo0 = (r0[q] & 0x0F0F0F0Fu) ^ 0x08080808u, hi0 = ((r0[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
          const uint32_t lo1 = (r1[q] & 0x0F0F0F0Fu) ^ 0x08080808u, hi1 = ((r1[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // column pair cp = 2q + h: columns c0 = 4q + 2h and c1 = c0 + 1
            const int j0 = 2 * h, j1 = j0 + 1;
            const float s0 = sc[4 * q + j0], s1 = sc[4 * q + j1];
            uint32_t a[4];
            a[0] = pack_bf16(int4_value(lo0, j0, s0), int4_value(lo1, j0, s0));
            a[1] = pack_bf16(int4_value(lo0, j1, s1), int4_value(lo1, j1, s1));
            a[2] = pack_bf16(int4_value(hi0, j0, s0), int4_value(hi1, j0, s0));
            a[3] = pack_bf16(int4_value(hi0, j1, s1), int4_value(hi1, j1, s1));
            mma_bf16_16816(acc[2 * q + h], a, b0, b1);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        if (++st == kRingStages) st = 0, phase ^= 1;
      }

      // The tile's sums: the eight warps added in a fixed order (through shared memory), then y
      // for a tile the run covers whole, else kept for the end of the run.
      float* rw = red + warp * kRowsM * kRedPitch;
#pragma unroll
      for (int cp = 0; cp < 8; ++cp) {
        const int c = 16 * g + 2 * cp;
        *reinterpret_cast<float2*>(rw + (2 * t) * kRedPitch + c) = make_float2(acc[cp][0], acc[cp][2]);
        *reinterpret_cast<float2*>(rw + (2 * t + 1) * kRedPitch + c) = make_float2(acc[cp][1], acc[cp][3]);
      }
      named_barrier_sync(1, kRingWarps * 32);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kRingWarps; ++w) {
        const float4 r = *reinterpret_cast<const float4*>(red + (w * kRowsM + m_in) * kRedPitch + col);
        v.x += r.x, v.y += r.y, v.z += r.z, v.w += r.w;
      }
      named_barrier_sync(1, kRingWarps * 32);  // red is free for the next tile
      if (seg_begin == tile_begin && seg_end == tile_begin + n_kb) {
        const int m = (tile % n_mc) * kRowsM + m_in, n = (tile / n_mc) * kCols + col;
        if (m < M && n < N) store_y4(y + static_cast<size_t>(m) * N + n, v);
      } else if (seg_begin == begin) {
        shared_tile[0] = tile, shared_sum[0] = v;
      } else {
        shared_tile[1] = tile, shared_sum[1] = v;
      }
    }

    // The shared tiles: each partial written, then one arrival a tile (by threads 0 and 1, after
    // the barrier that orders every thread's stores); the last CTA of a tile to arrive adds its
    // partials in CTA (k) order, writes y and sets the counter back to 0.
    if (shared_tile[0] >= 0 || shared_tile[1] >= 0) {
#pragma unroll
      for (int slot = 0; slot < 2; ++slot)
        if (shared_tile[slot] >= 0)
          *reinterpret_cast<float4*>(part + ((static_cast<size_t>(blockIdx.x) * 2 + slot) * kRowsM + m_in) * kCols +
                                     col) = shared_sum[slot];
      named_barrier_sync(1, kRingWarps * 32);
      if (threadIdx.x < 2) {
        const int tile = threadIdx.x == 0 ? shared_tile[0] : shared_tile[1];
        // one acquire-release arrival: it publishes the CTA's partials (ordered before it by the
        // barrier) and, for the last to arrive, orders the other CTAs' partials before the merge
        merges[threadIdx.x] = tile >= 0 && arrive_acq_rel(&arrivals[tile]) ==
                                               static_cast<unsigned>(run_owner(tile * n_kb + n_kb - 1, units) -
                                                                     run_owner(tile * n_kb, units));
      }
      named_barrier_sync(1, kRingWarps * 32);
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        if (!merges[slot]) continue;
        const int tile = shared_tile[slot], tile_begin = tile * n_kb;
        const int first = run_owner(tile_begin, units), last = run_owner(tile_begin + n_kb - 1, units);
        // the first contributor's run may start in an earlier tile (its slot 1); the others start here
        const int first_slot = run_begin(first, units) < tile_begin ? 1 : 0;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c0 = first; c0 <= last; c0 += 16) {  // sixteen loads in flight, then added in order
          float4 p[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = c0 + j, sl = c == first ? first_slot : 0;
            p[j] = c <= last ? __ldcg(reinterpret_cast<const float4*>(
                                   part + ((static_cast<size_t>(c) * 2 + sl) * kRowsM + m_in) * kCols + col))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (c0 + j <= last) sum.x += p[j].x, sum.y += p[j].y, sum.z += p[j].z, sum.w += p[j].w;
        }
        const int m = (tile % n_mc) * kRowsM + m_in, n = (tile / n_mc) * kCols + col;
        if (m < M && n < N) store_y4(y + static_cast<size_t>(m) * N + n, sum);
        if (threadIdx.x == 0) arrivals[tile] = 0u;
      }
    }
  }
}

// A row-major matrix [rows, cols] of `elem`-byte values as a 3-D tensor map (cols, rows, 1) with
// boxes of box_cols x box_rows; rows and columns past the edges arrive zero-filled.
cudaError_t make_rows_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, int rows, int cols,
                          int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

std::atomic<unsigned long long> ring_smem_set{0};

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

// int4 with bf16 activations through the ring kernel, one launch.  x [M,K] bf16, q [K/2,N] packed
// int8, s [K/G,N] f32, y [M,N] bf16, part [grid][2][8][128] f32, arrivals [ceil(N/128) *
// ceil(M/8)] uint32 (0 on entry, 0 on return); all contiguous and 16-byte aligned.  half_group =
// G/2 with G % 16 == 0, N % 16 == 0, M <= 256; scale_rows: the most groups a 64-row stage touches
// (ops/quant_matmul.py::int4_scale_rows); grid: the CTAs, no more than the units.  Returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for inputs the kernel does not take.
int nexus_quant_int4_ring(const void* x, const void* q, const void* s, void* y, void* part, void* arrivals, int M,
                          int K, int N, int half_group, int scale_rows, int grid, void* stream) {
  const auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (M <= 0 || M > 256 || K <= 0 || N <= 0 || N % 16 != 0 || half_group <= 0 || half_group % 8 != 0 ||
      K % (2 * half_group) != 0 || scale_rows <= 0 || scale_rows > kMaxScaleRows || grid <= 0 || !at16(x) ||
      !at16(q) || !at16(s) || !at16(y) || !at16(part) || arrivals == nullptr)
    return (int)cudaErrorInvalidValue;
  const int rows = K / 2, n_kb = (rows + kRingRows - 1) / kRingRows, n_mc = (M + kRowsM - 1) / kRowsM;
  const long long units = static_cast<long long>((N + kCols - 1) / kCols) * n_mc * n_kb;
  if (grid > units || units * grid >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  // the device's primary context current on this thread: the map encoder needs one
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  CUtensorMap tm_q, tm_s;
  if (err == cudaSuccess)
    err = make_rows_map(&tm_q, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, N, kCols, kRingRows,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_rows_map(&tm_s, s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / (2 * half_group), N, kCols, scale_rows,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess) err = allow_smem_once(ring_smem_set, quant_int4_ring_kernel, RingSmem::kBytes);
  if (err != cudaSuccess) return (int)err;
  quant_int4_ring_kernel<<<grid, kRingThreads, RingSmem::kBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_s, static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
      static_cast<unsigned*>(arrivals), M, K, N, half_group, scale_rows, n_kb, n_mc, static_cast<int>(units),
      make_divider(static_cast<uint32_t>(half_group / 8)));
  return (int)cudaGetLastError();
}

// CTAs of the ring kernel an SM holds (-1 on error), and the dynamic shared memory a launch asks for.
int nexus_quant_int4_ctas_per_sm() {
  int n = 0;
  if (allow_smem_once(ring_smem_set, quant_int4_ring_kernel, RingSmem::kBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, quant_int4_ring_kernel, kRingThreads, RingSmem::kBytes) !=
          cudaSuccess)
    return -1;
  return n;
}

int nexus_quant_int4_smem_bytes() { return RingSmem::kBytes; }

}  // extern "C"
