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
// bound (0.156 ms at 989 TFLOP/s).  Design, a simple right kernel first:
//  * bf16: one CTA of 4 warps per 128x128 output tile, mma.sync m16n8k16
//    with f32 accumulators (each warp 64x64), the contraction staged 32
//    deep through shared memory by cp.async, double-buffered.  Operands
//    reach the fragments through ldmatrix; an operand stored with the
//    output index contiguous (rhs [K,N], and in tgmm both lhs and dout,
//    which are contracted over their row index) goes through
//    ldmatrix.trans, so no layout needs a transposed copy.  wgmma, TMA and
//    a deeper pipeline are later steps.
//  * gmm CTA order: the tile index runs over groups of 8 row tiles, and
//    over every column tile inside a group, so a group's lhs rows and its
//    experts' weight columns are reused from L2 instead of HBM.
//  * The CTA reads its expert from tile_expert itself (the TPU's scalar
//    prefetch); a 128-row tile never straddles two experts because
//    block_m is a multiple of 128.  An expert id outside [0,E) writes
//    zeros.
//  * tgmm: one CTA per (expert, 128-row k tile, 128-col n tile).  The TPU
//    carries an f32 block across the grid's m axis; Hopper blocks share no
//    carry, so the CTA loops over its expert's tiles itself, keeps the sum
//    in registers and writes each output element once.  It finds the tiles
//    by a forward scan of tile_expert (at most a few hundred ints, in L1):
//    for the sorted map the dispatch builds that is the expert's one
//    contiguous run, and for any other order it still sums every tile of
//    e, as the reference's _tgmm_ref does.  No atomics: bit-identical run
//    to run.
//  * f32: the FMAs run on the CUDA cores in full f32 (not TF32): a 64x64
//    tile per 256-thread CTA, 4x4 outputs a thread, 16-deep stages.
//  * Ragged K and N are masked (zero-filled loads, guarded stores); rows
//    must be 16-byte aligned, M a multiple of block_m (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // bf16: 4 warps, 2 x 2 over the CTA tile
constexpr int kTile = 128;     // bf16 CTA output tile edge (rows and columns)
constexpr int kDepth = 32;     // bf16 contraction depth per stage
constexpr int kPad = 8;        // bf16 row padding: 16-byte rows, conflict-free ldmatrix
constexpr int kStageElems = kTile * (kDepth + kPad) > kDepth * (kTile + kPad)
                                ? kTile * (kDepth + kPad)
                                : kDepth * (kTile + kPad);
constexpr int kGroupM = 8;     // gmm row tiles per L2 group

constexpr int kFThreads = 256;  // f32: 16 x 16 threads, 4 x 4 outputs each
constexpr int kFTile = 64;
constexpr int kFDepth = 16;
constexpr int kFPad = 4;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16-byte async copy; a source size of 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a ROWS x COLS bf16 block of a row-major global matrix (row pitch ld)
// into shared memory rows of pitch COLS + kPad: global row r0 + r, column
// c0 + c.  16-byte chunks at or past row_limit / col_limit are zero-filled.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_block(bf16* dst, const bf16* __restrict__ src, long long ld, int r0, int c0,
                                           int row_limit, int col_limit) {
  constexpr int kChunksPerRow = COLS / 8;
  constexpr int kChunks = ROWS * kChunksPerRow;
  static_assert(kChunks % kThreads == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int j = 0; j < kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunksPerRow, c = (i % kChunksPerRow) * 8;
    const bool valid = (r0 + r < row_limit) && (c0 + c < col_limit);
    const bf16* g = valid ? src + static_cast<long long>(r0 + r) * ld + (c0 + c) : src;
    cp_async16(dst + r * (COLS + kPad) + c, g, valid);
  }
}

// One kDepth-deep stage of the CTA's 128x128 product on the tensor cores.
// A is stored [m][k] (kACol false; pitch kDepth + kPad) or [k][m] (kACol
// true; pitch kTile + kPad); B is stored [k][n] (kBNK false; pitch kTile +
// kPad) or [n][k] (kBNK true; pitch kDepth + kPad).  Warp (wm, wn) owns
// rows wm*64.. and columns wn*64.. of the tile: 4 m16 x 8 n8 fragments.
template <bool kACol, bool kBNK>
__device__ __forceinline__ void mma_stage(float (&acc)[4][8][4], const bf16* As, const bf16* Bs, int wm, int wn,
                                          int lane) {
  const int r8 = lane & 7, hi = (lane >> 3) & 1, q = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 16) {
    uint32_t a[4][4], b[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int m0 = wm * 64 + mi * 16;
      if (kACol) {
        ldsm_x4_trans(a[mi], As + (kk + r8 + q * 8) * (kTile + kPad) + m0 + hi * 8);
      } else {
        ldsm_x4(a[mi], As + (m0 + r8 + hi * 8) * (kDepth + kPad) + kk + q * 8);
      }
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n0 = wn * 64 + nj * 16;
      if (kBNK) {
        ldsm_x4(b[nj], Bs + (n0 + r8 + q * 8) * (kDepth + kPad) + kk + hi * 8);
      } else {
        ldsm_x4_trans(b[nj], Bs + (kk + r8 + hi * 8) * (kTile + kPad) + n0 + q * 8);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        mma_bf16_16816(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
  }
}

// ---- kernel #7, bf16 ----------------------------------------------------------

template <bool kTransB>
__global__ void __launch_bounds__(kThreads)
    gmm_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs, const int* __restrict__ tile_expert,
                    bf16* __restrict__ out, int M, int K, int N, int E, int block_m) {
  __shared__ __align__(16) bf16 As[2][kStageElems];
  __shared__ __align__(16) bf16 Bs[2][kStageElems];

  const int num_m = M / kTile, num_n = (N + kTile - 1) / kTile;
  const int tile = blockIdx.x;
  const int group = tile / (kGroupM * num_n);
  const int first_m = group * kGroupM;
  const int group_m = min(num_m - first_m, kGroupM);
  const int in_group = tile % (kGroupM * num_n);
  const int m0 = (first_m + in_group % group_m) * kTile;
  const int n0 = (in_group / group_m) * kTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;
  const int e = __ldg(tile_expert + m0 / block_m);

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  if (e >= 0 && e < E) {
    const bf16* w = rhs + static_cast<long long>(e) * K * N;
    const int steps = (K + kDepth - 1) / kDepth;
    auto load = [&](int buf, int k0) {
      load_block<kTile, kDepth>(As[buf], lhs, K, m0, k0, M, K);
      if (kTransB) {
        load_block<kTile, kDepth>(Bs[buf], w, K, n0, k0, N, K);
      } else {
        load_block<kDepth, kTile>(Bs[buf], w, N, k0, n0, K, N);
      }
    };
    load(0, 0);
    cp_async_commit();
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) {
        load((s + 1) & 1, (s + 1) * kDepth);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      mma_stage<false, kTransB>(acc, As[s & 1], Bs[s & 1], wm, wn, lane);
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int row = m0 + wm * 64 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + wn * 64 + ni * 8 + 2 * t;
      if (col < N) {
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row + 8) * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
  }
}

// ---- kernel #8, bf16 ----------------------------------------------------------

// First tile index >= from whose expert is e, or nt.
__device__ __forceinline__ int next_tile(const int* __restrict__ tile_expert, int nt, int e, int from) {
  for (int i = from; i < nt; ++i)
    if (__ldg(tile_expert + i) == e) return i;
  return nt;
}

__global__ void __launch_bounds__(kThreads)
    tgmm_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ dout, const int* __restrict__ tile_expert,
                     float* __restrict__ out, int M, int K, int N, int block_m) {
  __shared__ __align__(16) bf16 As[2][kStageElems];
  __shared__ __align__(16) bf16 Bs[2][kStageElems];

  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile, e = blockIdx.z;
  const int nt = M / block_m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t = lane & 3;

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

  // A = lhs^T: stored [row][k] straight from lhs rows (kACol); B = dout
  // rows [row][n] (kBNK false).  Both contracted over the row index.
  auto load = [&](int buf, int r0) {
    load_block<kDepth, kTile>(As[buf], lhs, K, r0, k0, M, K);
    load_block<kDepth, kTile>(Bs[buf], dout, N, r0, n0, M, N);
  };
  int cur_t = next_tile(tile_expert, nt, e, 0), cur_off = 0, buf = 0;
  if (cur_t < nt) load(0, cur_t * block_m);
  cp_async_commit();
  while (cur_t < nt) {
    int nx_t = cur_t, nx_off = cur_off + kDepth;
    if (nx_off == block_m) {
      nx_off = 0;
      nx_t = next_tile(tile_expert, nt, e, cur_t + 1);
    }
    if (nx_t < nt) {
      load(buf ^ 1, nx_t * block_m + nx_off);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_stage<true, false>(acc, As[buf], Bs[buf], wm, wn, lane);
    __syncthreads();
    cur_t = nx_t;
    cur_off = nx_off;
    buf ^= 1;
  }

  float* o = out + static_cast<long long>(e) * K * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int row = k0 + wm * 64 + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + wn * 64 + ni * 8 + 2 * t;
      if (col < N) {
        if (row < K)
          *reinterpret_cast<float2*>(o + static_cast<long long>(row) * N + col) =
              make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        if (row + 8 < K)
          *reinterpret_cast<float2*>(o + static_cast<long long>(row + 8) * N + col) =
              make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
  }
}

// ---- f32: CUDA cores ----------------------------------------------------------

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (lhs, rhs and out).  lhs [M,K], out
// [M,N], tile_expert [M/block_m] int32, all contiguous; rhs [E,K,N], or
// with trans_rhs [E,N,K] used as its transpose.  M a multiple of block_m,
// block_m a multiple of 128; K and N rows 16-byte aligned.  Returns the
// launch's cudaGetLastError().
int nexus_gmm(const void* lhs, const void* rhs, const void* tile_expert, void* out, int M, int K, int N, int E,
              int block_m, int trans_rhs, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  if (dtype == 1) {
    const dim3 grid((M / kTile) * ((N + kTile - 1) / kTile));
    const bf16* a = static_cast<const bf16*>(lhs);
    const bf16* b = static_cast<const bf16*>(rhs);
    bf16* o = static_cast<bf16*>(out);
    if (trans_rhs)
      gmm_bf16_kernel<true><<<grid, kThreads, 0, st>>>(a, b, te, o, M, K, N, E, block_m);
    else
      gmm_bf16_kernel<false><<<grid, kThreads, 0, st>>>(a, b, te, o, M, K, N, E, block_m);
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
// is written.
int nexus_tgmm(const void* lhs, const void* dout, const void* tile_expert, void* out, int M, int K, int N, int E,
               int block_m, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* te = static_cast<const int*>(tile_expert);
  float* o = static_cast<float*>(out);
  if (dtype == 1) {
    const dim3 grid((N + kTile - 1) / kTile, (K + kTile - 1) / kTile, E);
    tgmm_bf16_kernel<<<grid, kThreads, 0, st>>>(static_cast<const bf16*>(lhs), static_cast<const bf16*>(dout), te, o,
                                                M, K, N, block_m);
  } else {
    const dim3 grid((N + kFTile - 1) / kFTile, (K + kFTile - 1) / kFTile, E);
    tgmm_f32_kernel<<<grid, kFThreads, 0, st>>>(static_cast<const float*>(lhs), static_cast<const float*>(dout), te,
                                                o, M, K, N, block_m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
