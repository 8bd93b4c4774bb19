// Block-pattern sparse matmul for Hopper (sm_90a): fp32 and int8 variants.
//
//   y[:, t*tile : (t+1)*tile] = sum_{k < nnz[t]} x[:, block_ids[t,k]*block : +block] @ w_comp[t, k]
//
// Replaces the TPU kernels pattern_spmm_pallas / pattern_spmm_pallas_quant
// (src/repro/kernels/pattern_spmm.py).  There the grid is (row tiles,
// output tiles, k_max) and the accumulator carries across the sequential
// k steps in VMEM.  Here one thread block owns a BM x BN patch of one
// output tile and walks that tile's bricks in a loop, so nothing carries
// between blocks; it stops at nnz[t] (the padded slots hold zero weights,
// so stopping there changes nothing), which also skips the padding's work.
//
// Per brick the block stages the gathered x slice (the Input Preprocessing
// Unit: rows of x at the columns block_ids[t,k] names) and the brick
// itself in shared memory, BK rows of depth at a time, and every thread
// accumulates a TM x TN register tile.  Ragged rows, depth and columns
// are masked on load (zeros) and on store, so any block/tile geometry
// works, down to block 9 and tile 8.  A tile with nnz[t] == 0 writes zeros.
//
// fp32 accumulates with IEEE fmaf (no TF32).  int8 sums each brick's
// partial exactly in int32, then folds it as
// acc = __fadd_rn(acc, __fmul_rn(w_scale, (float)partial)) in k order, which
// forbids FMA contraction, so the fold rounds as the plain PyTorch version
// (acc + s * partial) does.  The caller multiplies the per-row activation
// scale afterwards.
//
// Each C entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // output rows per thread block
constexpr int BN = 64;  // output columns of the tile per thread block
constexpr int BK = 32;  // brick depth staged in shared memory per step
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int TX = BN / TN;        // 16 threads across columns
constexpr int TY = BM / TM;        // 16 threads across rows
constexpr int THREADS = TX * TY;   // 256

// A thread owns rows ty + TY*i and columns tx + TX*j of the block's patch:
// neighbouring threads read neighbouring brick columns from shared memory.

template <typename In, typename Stage>
__device__ __forceinline__ void stage_tiles(
    Stage (&xs)[BM][BK + 1], Stage (&ws)[BK][BN],
    const In* __restrict__ xcol, const In* __restrict__ brick,
    int row0, int col0, int d0, int M, int K, int block, int tile) {
  for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    const int gr = row0 + r, gd = d0 + c;
    xs[r][c] = (gr < M && gd < block)
                   ? static_cast<Stage>(xcol[(size_t)gr * K + gd])
                   : Stage(0);
  }
  for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gd = d0 + r, gc = col0 + c;
    ws[r][c] = (gd < block && gc < tile)
                   ? static_cast<Stage>(brick[(size_t)gd * tile + gc])
                   : Stage(0);
  }
}

__global__ void __launch_bounds__(THREADS)
pattern_spmm_f32_kernel(const float* __restrict__ x,          // [M, K]
                        const float* __restrict__ w_comp,     // [T, k_max, block, tile]
                        const int32_t* __restrict__ block_ids,  // [T, k_max]
                        const int32_t* __restrict__ nnz,      // [T]
                        float* __restrict__ y,                // [M, T*tile]
                        int M, int K, int T, int k_max, int block, int tile) {
  __shared__ float xs[BM][BK + 1];  // +1: rows land in different banks
  __shared__ float ws[BK][BN];
  const int t = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.z * BN;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_bricks = nnz[t];
  for (int k = 0; k < n_bricks; ++k) {
    const size_t slot = (size_t)t * k_max + k;
    const float* xcol = x + (size_t)block_ids[slot] * block;
    const float* brick = w_comp + slot * block * tile;
    for (int d0 = 0; d0 < block; d0 += BK) {
      stage_tiles(xs, ws, xcol, brick, row0, col0, d0, M, K, block, tile);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < BK; ++d) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[ty + TY * i][d];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[d][tx + TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const size_t ld = (size_t)T * tile;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + TY * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + TX * j;
      if (c < tile) y[r * ld + (size_t)t * tile + c] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
pattern_spmm_i8_kernel(const int8_t* __restrict__ xq,         // [M, K]
                       const int8_t* __restrict__ w_comp,     // [T, k_max, block, tile]
                       const int32_t* __restrict__ block_ids,  // [T, k_max]
                       const float* __restrict__ w_scales,    // [T, k_max]
                       const int32_t* __restrict__ nnz,       // [T]
                       float* __restrict__ y,                 // [M, T*tile]
                       int M, int K, int T, int k_max, int block, int tile) {
  __shared__ int32_t xs[BM][BK + 1];
  __shared__ int32_t ws[BK][BN];
  const int t = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.z * BN;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_bricks = nnz[t];
  for (int k = 0; k < n_bricks; ++k) {
    const size_t slot = (size_t)t * k_max + k;
    const int8_t* xcol = xq + (size_t)block_ids[slot] * block;
    const int8_t* brick = w_comp + slot * block * tile;
    int32_t part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0;
    for (int d0 = 0; d0 < block; d0 += BK) {
      stage_tiles(xs, ws, xcol, brick, row0, col0, d0, M, K, block, tile);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < BK; ++d) {
        int32_t a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[ty + TY * i][d];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[d][tx + TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
    const float s = w_scales[slot];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = __fadd_rn(acc[i][j],
                              __fmul_rn(s, __int2float_rn(part[i][j])));
  }

  const size_t ld = (size_t)T * tile;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + TY * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + TX * j;
      if (c < tile) y[r * ld + (size_t)t * tile + c] = acc[i][j];
    }
  }
}

dim3 grid_for(int M, int T, int tile) {
  return dim3((M + BM - 1) / BM, T, (tile + BN - 1) / BN);
}

}  // namespace

extern "C" int pattern_spmm_f32(const void* x, const void* w_comp,
                                const void* block_ids, const void* nnz,
                                void* y, int M, int K, int T, int k_max,
                                int block, int tile, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  pattern_spmm_f32_kernel<<<grid_for(M, T, tile), THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w_comp, (const int32_t*)block_ids,
      (const int32_t*)nnz, (float*)y, M, K, T, k_max, block, tile);
  return (int)cudaGetLastError();
}

extern "C" int pattern_spmm_i8(const void* xq, const void* w_comp,
                               const void* block_ids, const void* w_scales,
                               const void* nnz, void* y, int M, int K, int T,
                               int k_max, int block, int tile, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  pattern_spmm_i8_kernel<<<grid_for(M, T, tile), THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const int8_t*)w_comp, (const int32_t*)block_ids,
      (const float*)w_scales, (const int32_t*)nnz, (float*)y, M, K, T, k_max,
      block, tile);
  return (int)cudaGetLastError();
}
