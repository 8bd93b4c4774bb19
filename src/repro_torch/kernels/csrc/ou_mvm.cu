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
// bands' weight rows over the memory rate.  At VGG16's widths (R up to
// 4608 rows, C up to 512 columns) the calls are so short (7-15 us) that
// each dependent trip to memory shows: a reduction across blocks (a
// second launch; or a fence, an atomic ticket and the partials read back
// from L2; or a cluster barrier) costs ~1.7 us a call on the H100,
// more than the walk's own latency.  What the design does about it:
//   - no reduction across blocks: each block owns a slab of VEC columns
//     (one column-lane) and walks every row of it, so the slabs alone
//     give enough blocks.  One launch, one pass.  Wider slabs (2 to 32
//     column-lanes) were measured and lost or tied (PERF.md section 6);
//   - 16-byte loads: a thread reads its slab's 4 columns of a weight
//     row as one float4 (where C % 4 == 0 and w is 16-byte aligned; else
//     one column and 4-byte loads); the block's 512 row-lanes take every
//     512th row, so a warp reads 32 consecutive rows at once;
//   - loads in flight: a thread issues the loads of UNROLL rows before
//     the first multiply-add;
//   - the flags once per chunk: x is staged in shared memory CHUNK rows
//     at a time (one chunk at VGG16's widths), by one coalesced pass,
//     then each band's flag and each row's, behind barriers.  A band
//     that straddles a chunk's edge reads its rows outside the chunk
//     from global memory.  A row of a skipped band issues no weight load
//     (its load is predicated off), so a NaN weight there never reaches
//     y.  CHUNK is a multiple of the row-lanes, so a thread walks its
//     rows in the same order whatever R: any R works, with the bits of
//     a single pass.
// A thread sums its rows with fmaf in row order; the block sums its
// row-lanes by a fixed pairwise tree, by shuffles within a warp and in
// shared memory across its 16 warps.  No atomics: the
// same inputs give the same bits on every run, and a column's result
// does not depend on the other columns.  Ragged R (the last band is
// short) and ragged C are masked.
//
// The C entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;  // row-lanes of a block
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 16;    // rows whose loads a thread issues together
constexpr int CHUNK = THREADS * UNROLL;  // rows of x in shared memory at once

template <int VEC>
struct Cols;  // VEC consecutive columns of one weight row

template <>
struct Cols<4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p, bool ok) {
    v = ok ? __ldg(reinterpret_cast<const float4*>(p))
           : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float operator[](int i) const {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};

template <>
struct Cols<1> {
  float v;
  __device__ __forceinline__ void load(const float* p, bool ok) {
    v = ok ? __ldg(p) : 0.f;
  }
  __device__ __forceinline__ float operator[](int) const { return v; }
};

// Bytes of dynamic shared memory: a chunk's x (float), each row's flag
// and the flag of each band that meets the chunk (one byte each); at
// most 49,153, within the H100's 227 KB a block.
size_t smem_bytes(int R, int ou_rows) {
  const int n = R < CHUNK ? R : CHUNK;
  return (sizeof(float) + 1) * (size_t)n + (n - 1) / ou_rows + 2;
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
ou_mvm_f32_kernel(const float* __restrict__ x,  // [R]
                  const float* __restrict__ w,  // [R, C]
                  float* __restrict__ y,        // [C]
                  int R, int C, int ou_rows) {
  extern __shared__ float xs[];
  __shared__ float red[WARPS][VEC];
  const int chunk = R < CHUNK ? R : CHUNK;
  unsigned char* row_live = reinterpret_cast<unsigned char*>(xs + chunk);
  unsigned char* band_live = row_live + chunk;

  const int tid = threadIdx.x;
  const int c = blockIdx.x * VEC;
  const bool col_ok = c < C;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;

  for (int lo = 0; lo < R; lo += CHUNK) {
    const int n = min(CHUNK, R - lo);
    const int b0 = lo / ou_rows, b1 = (lo + n - 1) / ou_rows;
    if (lo > 0) __syncthreads();  // the last chunk's readers are done
    // x in one coalesced pass; all-zero input detection, one flag a
    // band, then each row's
    for (int i = tid; i < n; i += THREADS) xs[i] = x[lo + i];
    __syncthreads();
    for (int b = b0 + tid; b <= b1; b += THREADS) {
      const int blo = b * ou_rows, bhi = min(blo + ou_rows, R);
      bool live = false;
      for (int r = blo; r < bhi; ++r)
        live |= (r >= lo && r < lo + n ? xs[r - lo] : __ldg(x + r)) != 0.f;
      band_live[b - b0] = live;
    }
    __syncthreads();
    for (int i = tid; i < n; i += THREADS)
      row_live[i] = band_live[(lo + i) / ou_rows - b0];
    __syncthreads();

    // row-lane tid walks the chunk's rows tid, tid + THREADS, ... in order
    Cols<VEC> wv[UNROLL];
    float xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = tid + u * THREADS;
      const bool ok = col_ok && i < n && row_live[i];
      xv[u] = ok ? xs[i] : 0.f;
      wv[u].load(w + (size_t)(lo + i) * C + c, ok);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xv[u], wv[u][v], acc[v]);
  }

  // the row-lanes' sums by a fixed pairwise tree: within a warp by
  // shuffles (lane i takes lane i + off), then across warps in shared
  // memory (warp i takes warp i + stride)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      acc[v] += __shfl_down_sync(0xffffffffu, acc[v], off);
  const int warp = tid / 32;
  if (tid % 32 == 0) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[warp][v] = acc[v];
  }
  __syncthreads();
#pragma unroll
  for (int stride = WARPS / 2; stride > 0; stride >>= 1) {
    if (tid < stride * VEC) red[tid / VEC][tid % VEC] +=
        red[tid / VEC + stride][tid % VEC];
    __syncthreads();
  }
  if (tid < VEC && c + tid < C) y[c + tid] = red[0][tid];
}

template <int VEC>
cudaError_t launch(const float* x, const float* w, float* y, int R, int C,
                   int ou_rows, cudaStream_t stream) {
  auto kernel = ou_mvm_f32_kernel<VEC>;
  const size_t smem = smem_bytes(R, ou_rows);
  constexpr size_t static_smem = WARPS * VEC * sizeof(float);
  if (smem + static_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(C + VEC - 1) / VEC, THREADS, smem, stream>>>(x, w, y, R, C,
                                                         ou_rows);
  return cudaGetLastError();
}

}  // namespace

// One block a slab of vec columns: 4 (C % 4 == 0, w 16-byte aligned:
// float4 loads) or 1.
extern "C" int ou_mvm_f32(const void* x, const void* w, void* y, int R,
                          int C, int ou_rows, int vec, int device,
                          void* stream) {
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  err = vec == 4 ? launch<4>(xf, wf, (float*)y, R, C, ou_rows, s)
                 : launch<1>(xf, wf, (float*)y, R, C, ou_rows, s);
  return (int)err;
}
