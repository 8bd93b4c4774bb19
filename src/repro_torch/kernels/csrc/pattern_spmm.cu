// Block-pattern sparse matmul for Hopper (sm_90a): fp32 and int8 variants.
//
//   y[:, t*tile : (t+1)*tile] = sum_{k < nnz[t]} x[:, block_ids[t,k]*block : +block] @ w_comp[t, k]
//
// Replaces the TPU kernels pattern_spmm_pallas / pattern_spmm_pallas_quant
// (src/repro/kernels/pattern_spmm.py).  There the grid is (row tiles,
// output tiles, k_max) and the accumulator carries across the sequential
// k steps in VMEM.  Here the padded slots k >= nnz[t] hold zero weights,
// so every kernel stops at nnz[t], which also skips the padding's work.
//
// fp32 (pattern_spmm_f32_kernel, namespace f32 below).  What bounds it:
// operations.  IEEE fp32 has no tensor-core path (TF32 misses the 2e-5
// bar), so its ceiling is the CUDA cores' 67 TFLOP/s, and a VGG16
// forward's bricks hold far more operations per byte than that rate
// needs.  At the serving shapes (8 slots, 128 x 128 bricks) the deep
// layers have 32 to 512 rows and 1 to 4 output tiles, too few thread
// blocks for 132 SMs.  What the design does about it:
//   - the split walk: block (row tile, t, slab * S + s) walks only the
//     s-th of S runs of ceil(nnz[t] / S) bricks of its tile.  The plan
//     is chosen by the wrapper from the shapes alone (kernels/
//     pattern_spmm.py, _split_plan): S from the output tiles and k_max,
//     never from the row count, so an output's bits do not depend on the
//     batch; the block tile from the grid's size.  With S > 1 each block writes
//     its partial to a workspace [S, M, T*tile] that the wrapper
//     allocates, and a second kernel sums the S partials in the fixed
//     order 0..S-1: no atomics, so a result is bit-identical from run to
//     run.  The second kernel is a programmatic dependent launch
//     (griddepcontrol): it is scheduled while the walk stores, and waits
//     for the walk's end before it reads;
//   - register tiling: a thread owns TM x TN outputs (8 x 8, or 4 x 8
//     for 32-row tiles) and reads its operands from shared memory as
//     float4: per 4 steps of depth, TM float4 of x (its rows, 4 depths
//     each) and 4 * TN / 4 float4 of the brick, 16 FMAs per load at 8 x 8;
//     a pipeline step stages 16 or 32 of depth (the plan picks 32 where
//     few blocks share an SM, to amortize each step's wait);
//   - asynchronous staging: the gathered x slice (rows of x at the
//     columns block_ids[t,k] names: the Input Preprocessing Unit) and the
//     brick are copied with cp.async into a ring of three shared-memory
//     stages, two steps ahead of the one computed.  x is staged
//     row-major, as it lies in memory (cp.async cannot transpose): a
//     thread's float4 reads
//     run along depth, and the threads of a quarter warp read one row,
//     so the reads broadcast.  16-byte cp.async.cg when block, tile and K
//     are multiples of 4 floats and the pointers 16-byte aligned, else a
//     4-byte cp.async per element (block 9, tile 8 take it); both zero-
//     fill the ragged rows, depth and columns, which are masked on store.
// Every sum is IEEE fmaf in depth order, bricks in k order within a split.
//
// int8 (pattern_spmm_i8_kernel): a simple SIMT kernel.  One thread block
// per (64-row tile, output tile, 64-column slab) stages the gathered x
// slice and the brick in shared memory 32 rows of depth at a time; each
// thread accumulates a 4 x 4 register tile.  It sums each brick's partial
// exactly in int32, then folds it as
// acc = __fadd_rn(acc, __fmul_rn(w_scale, (float)partial)) in k order, which
// forbids FMA contraction, so the fold rounds as the plain PyTorch version
// (acc + s * partial) does.  The caller multiplies the per-row activation
// scale afterwards.  Bound by bytes (the int8 tensor-core rate outruns
// device memory); int8 MMA and TMA are later work.
//
// A tile with nnz[t] == 0 writes zeros.  Each C entry point launches on
// the stream it is given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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


namespace f32 {

constexpr int XPAD = 4;    // x rows of BK + 4 floats: 16-byte aligned rows
constexpr int STAGES = 3;  // shared-memory stages: two steps in flight

__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? bytes : 0;  // 0 bytes read: the target is zero-filled
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most STAGES - 2 groups are in flight: this step's landed
__device__ __forceinline__ void cp_async_wait_step() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// A thread owns rows ty + TY * i (i < TM) and, for each of its TN / 4
// column groups g, columns g * (BN / G) + 4 tx .. + 3: the 8 threads of a
// quarter warp read 8 consecutive float4 of a brick row (no bank
// conflict) and share one x row (a broadcast).
template <int BM, int BN, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * STAGES * (BM * (BK + XPAD) + BK * BN);
}

template <int BM, int BN, int TM, int TN, int BK, int VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
pattern_spmm_f32_kernel(const float* __restrict__ x,           // [M, K]
                        const float* __restrict__ w_comp,      // [T, k_max, block, tile]
                        const int32_t* __restrict__ block_ids,  // [T, k_max]
                        const int32_t* __restrict__ nnz,       // [T]
                        float* __restrict__ out,  // y [M, T*tile], or the workspace [S, M, T*tile]
                        int M, int K, int T, int k_max, int block, int tile,
                        int splits) {
  constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  constexpr int G = TN / 4, GSTRIDE = BN / G;
  extern __shared__ __align__(16) float smem[];
  auto xs = reinterpret_cast<float (*)[BM][BK + XPAD]>(smem);
  auto ws = reinterpret_cast<float (*)[BK][BN]>(smem + STAGES * BM * (BK + XPAD));

  const int t = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int slab = blockIdx.z / splits;
  const int s = blockIdx.z - slab * splits;
  const int col0 = slab * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;

  // this block's run of bricks: [s * ceil(n / S), ...) of the tile's n
  const int n = nnz[t];
  const int chunk = (n + splits - 1) / splits;
  const int kb = min(s * chunk, n);
  const int ke = min(kb + chunk, n);
  const int nsub = (block + BK - 1) / BK;
  const int steps = (ke - kb) * nsub;

  auto stage = [&](int step, int buf) {
    const int k = kb + step / nsub;
    const int d0 = (step - (step / nsub) * nsub) * BK;
    const size_t slot = (size_t)t * k_max + k;
    const float* xcol = x + (size_t)__ldg(block_ids + slot) * block;
    const float* brick = w_comp + slot * block * tile;
    for (int i = tid; i < BM * BK / VEC; i += THREADS) {
      const int r = i / (BK / VEC), c = (i % (BK / VEC)) * VEC;
      const int gr = row0 + r, gd = d0 + c;
      const bool ok = gr < M && gd < block;
      cp_async(&xs[buf][r][c], ok ? xcol + (size_t)gr * K + gd : x, ok,
               4 * VEC);
    }
    for (int i = tid; i < BK * BN / VEC; i += THREADS) {
      const int r = i / (BN / VEC), c = (i % (BN / VEC)) * VEC;
      const int gd = d0 + r, gc = col0 + c;
      const bool ok = gd < block && gc < tile;
      cp_async(&ws[buf][r][c], ok ? brick + (size_t)gd * tile + gc : w_comp,
               ok, 4 * VEC);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < steps) stage(j, j);
    cp_async_commit();
  }
  for (int j = 0; j < steps; ++j) {
    cp_async_wait_step();
    // every thread has its share of step j, and is done with step j - 1,
    // whose stage the copies issued next overwrite
    __syncthreads();
    const int ahead = j + STAGES - 1;
    if (ahead < steps) stage(ahead, ahead % STAGES);
    cp_async_commit();
    const int buf = j % STAGES;
#pragma unroll
    for (int d4 = 0; d4 < BK; d4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(&xs[buf][ty + TY * i][d4]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float b[TN];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              &ws[buf][d4 + dd][g * GSTRIDE + tx * 4]);
          b[4 * g] = v.x;
          b[4 * g + 1] = v.y;
          b[4 * g + 2] = v.z;
          b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = dd == 0 ? a[i].x : dd == 1 ? a[i].y
                         : dd == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int jn = 0; jn < TN; ++jn)
            acc[i][jn] = fmaf(av, b[jn], acc[i][jn]);
        }
      }
    }
  }

  // let the reduction grid launch now (it waits for this grid's end
  // before it reads a partial): its launch overlaps these stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const size_t ld = (size_t)T * tile;
  float* dst = out + (size_t)s * M * ld + (size_t)t * tile;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + TY * i;
    if (r >= M) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = col0 + g * GSTRIDE + tx * 4;
      float* o = dst + (size_t)r * ld + c;
      if (VEC == 4) {
        if (c < tile)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                          acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < tile) o[e] = acc[i][4 * g + e];
      }
    }
  }
}

// y[i] = ws[0][i] + ws[1][i] + ... + ws[S-1][i], in that order.  Launched
// as a programmatic dependent of the split walk: it waits here until the
// walk's grid has ended and its partials are visible.
__global__ void __launch_bounds__(256)
split_reduce_kernel(const float* __restrict__ ws, float* __restrict__ y,
                    long long n, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float a = ws[i];
#pragma unroll 8
    for (int s = 1; s < splits; ++s) a += ws[s * n + i];
    y[i] = a;
  }
}

template <int BM, int BN, int TM, int TN, int BK, int VEC>
cudaError_t launch(const float* x, const float* w_comp,
                   const int32_t* block_ids, const int32_t* nnz, float* out,
                   int M, int K, int T, int k_max, int block, int tile,
                   int splits, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, BN, BK>();
  auto kernel = pattern_spmm_f32_kernel<BM, BN, TM, TN, BK, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, T, ((tile + BN - 1) / BN) * splits);
  kernel<<<grid, (BM / TM) * (BN / TN), smem, stream>>>(
      x, w_comp, block_ids, nnz, out, M, K, T, k_max, block, tile, splits);
  return cudaGetLastError();
}

// config: the block tile _split_plan picked, by index into _TILE_SHAPES
template <int VEC>
cudaError_t launch_config(int config, const float* x, const float* w_comp,
                          const int32_t* block_ids, const int32_t* nnz,
                          float* out, int M, int K, int T, int k_max,
                          int block, int tile, int splits,
                          cudaStream_t stream) {
#define SPMM_CONFIG(ID, BM, BN, TM, TN, BK)                                 \
  case ID:                                                                  \
    return launch<BM, BN, TM, TN, BK, VEC>(x, w_comp, block_ids, nnz, out,  \
                                           M, K, T, k_max, block, tile,     \
                                           splits, stream);
  switch (config) {
    SPMM_CONFIG(0, 64, 128, 8, 8, 16)
    SPMM_CONFIG(1, 32, 128, 4, 8, 16)
    SPMM_CONFIG(2, 64, 32, 4, 4, 16)
    SPMM_CONFIG(3, 32, 128, 4, 8, 32)
    default:
      return cudaErrorInvalidValue;
  }
#undef SPMM_CONFIG
}

}  // namespace f32

}  // namespace

// splits == 1: the kernel writes y.  splits > 1: it writes its partials
// to workspace [splits, M, T*tile] and a second launch sums them into y.
// vec: 4 for 16-byte copies (block, tile, K multiples of 4, pointers
// 16-byte aligned), 1 for 4-byte copies.
extern "C" int pattern_spmm_f32(const void* x, const void* w_comp,
                                const void* block_ids, const void* nnz,
                                void* y, void* workspace, int M, int K, int T,
                                int k_max, int block, int tile, int config,
                                int splits, int vec, int device,
                                void* stream) {
  if (splits < 1 || (vec != 1 && vec != 4)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float* out = splits == 1 ? (float*)y : (float*)workspace;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w_comp;
  const int32_t* ids = (const int32_t*)block_ids;
  const int32_t* n_t = (const int32_t*)nnz;
  err = vec == 4 ? f32::launch_config<4>(config, xf, wf, ids, n_t, out, M, K,
                                         T, k_max, block, tile, splits, s)
                 : f32::launch_config<1>(config, xf, wf, ids, n_t, out, M, K,
                                         T, k_max, block, tile, splits, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)M * T * tile;
  const int blocks = (int)std::min<long long>((n + 255) / 256, 132 * 16);
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, f32::split_reduce_kernel,
                           (const float*)workspace, (float*)y, n, splits);
  if (err != cudaSuccess) return (int)err;
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
