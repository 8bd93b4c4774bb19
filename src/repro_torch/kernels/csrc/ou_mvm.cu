// OU-granular crossbar matrix-vector multiply for Hopper (sm_90a).
//
//   y[c] = sum over row bands b with flag[b]:  x[band b] . w[band b, c]
//   flag[b] = any(x[b*ou_rows : (b+1)*ou_rows] != 0)
//
// Replaces the TPU kernel ou_mvm_pallas (src/repro/kernels/ou_mvm.py).
// There the grid walks (row band, OU column group) in order, one
// ou_rows x ou_cols Operation Unit per step, and a band whose input slice
// is all zero (the paper's all-zero input detection, section IV-A) is
// skipped through a scalar-prefetched flag.  The flag is the IEEE
// comparison x != 0, so -0.0 counts as zero and NaN does not.
//
// What bounds it on the H100: bytes.  A call does 2 operations per weight
// it reads (one multiply-add per weight of a live band), far below the
// card's operations-per-byte balance, so the least time is the live
// bands' weight rows over the memory rate.  What the design does about
// it: a skipped band reads no weights at all (its flag is computed here
// from x, which every warp reads as a broadcast), and each warp reads a
// weight row's 32 consecutive columns as one coalesced 128-byte load.
//
// Layout: one thread block owns COLS = 32 output columns (a warp across
// them, so four 8-wide OU column groups) and SPLITS = 32 warps, each warp
// walking one contiguous range of row bands in band order and adding each
// live band's fp32 partial (an fmaf chain over the band's rows) into its
// accumulator.  The 32 range sums are then added in range order through
// shared memory.  No atomics: the same inputs give the same bits on every
// run.  Ragged R (the last band is short) and ragged C are masked.
//
// A simple kernel: C / 32 blocks is 2 to 16 blocks at VGG16's widths,
// far from filling 132 SMs; a split of the bands over more blocks, with
// a second fixed-order pass, is later work.
//
// The C entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;    // output columns per thread block (one warp)
constexpr int SPLITS = 32;  // band ranges per thread block (one warp each)

__global__ void __launch_bounds__(COLS * SPLITS)
ou_mvm_f32_kernel(const float* __restrict__ x,  // [R]
                  const float* __restrict__ w,  // [R, C]
                  float* __restrict__ y,        // [C]
                  int R, int C, int ou_rows) {
  __shared__ float part[SPLITS][COLS];
  const int lane = threadIdx.x;
  const int s = threadIdx.y;
  const int c = blockIdx.x * COLS + lane;
  const int n_bands = (R + ou_rows - 1) / ou_rows;
  const int per = (n_bands + SPLITS - 1) / SPLITS;
  const int b0 = s * per;
  const int b1 = min(b0 + per, n_bands);
  float acc = 0.f;
  for (int b = b0; b < b1; ++b) {
    const int r0 = b * ou_rows;
    const int r1 = min(r0 + ou_rows, R);
    // all-zero input detection; every lane of the warp reads the same x,
    // so the branch is uniform and a skipped band issues no weight load
    bool live = false;
    for (int r = r0; r < r1; ++r) live |= (x[r] != 0.f);
    if (!live || c >= C) continue;
    float p = 0.f;
#pragma unroll 4
    for (int r = r0; r < r1; ++r) p = fmaf(x[r], w[(size_t)r * C + c], p);
    acc += p;
  }
  part[s][lane] = acc;
  __syncthreads();
  if (s == 0 && c < C) {
    float sum = part[0][lane];
    for (int i = 1; i < SPLITS; ++i) sum += part[i][lane];
    y[c] = sum;
  }
}

}  // namespace

extern "C" int ou_mvm_f32(const void* x, const void* w, void* y, int R,
                          int C, int ou_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + COLS - 1) / COLS);
  const dim3 block(COLS, SPLITS);
  ou_mvm_f32_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)y, R, C, ou_rows);
  return (int)cudaGetLastError();
}
