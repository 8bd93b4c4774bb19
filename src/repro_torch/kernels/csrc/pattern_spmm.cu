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
// int8 (namespace i8 below).  What bounds it: bytes.  int8 x int8
// products run on the tensor cores at 1,979 TOP/s, which outruns device
// memory at every VGG16 layer.  At the serving shapes the deep layers
// have 32 to 128 rows and 1 to 4 output tiles of up to 36 bricks, so a
// block per (row tile, output tile) leaves most SMs idle while each
// walks its bricks in series.  What the design does about it:
//   - the split walk, as fp32 has it: block (row tile, t, slab * S + s)
//     walks the s-th run of its tile's bricks, and with S > 1 a second
//     launch sums the S fp32 partials in the order 0..S-1
//     (split_reduce_kernel).  The wrapper's plan (_quant_plan) takes S
//     from the output tiles and k_max only, never from the rows, so an
//     output's bits do not depend on the batch it is in: tiles of 8 or
//     more bricks split into runs of at least 3.  The rows pick only the
//     block tile (16, 32 or 64 rows), which changes no bit;
//   - tensor cores: each warp owns 16 or 32 rows x 32 columns and runs
//     mma.sync.m16n8k32.s32.s8.s8.s32 over the staged depth, 32 bytes a
//     step.  A brick's int32 partial is exact (|part| <= block * 127^2,
//     far inside 2^31), and it folds into the fp32 accumulator once per
//     brick, in k order, as
//     acc = __fadd_rn(acc, __fmul_rn(w_scale, __int2float_rn(part))),
//     which forbids FMA contraction: with S = 1 the result is the plain
//     version's (acc + s * partial) bit for bit;
//   - the layout: for 8-bit operands mma.sync takes B K-major (.col),
//     cp.async cannot transpose, and sm_90's ldmatrix transposes only
//     16-bit elements.  The bricks are stored [T, k_max, block, tile],
//     tile-contiguous, so the kernel reads a K-major copy
//     [T, k_max, tile, block] that the executor makes once per program
//     (kernels/pattern_spmm.py, kmajor_bricks; never saved).  With it the
//     gathered x rows and the brick rows are both K-contiguous: both are
//     staged by cp.async and read by ldmatrix.x4 straight into the
//     MMA's A and B fragments;
//   - asynchronous staging: a ring of three shared-memory stages, two
//     64-byte-deep steps in flight while one computes.  16-byte
//     cp.async.cg where block and K are multiples of 16 bytes and the
//     pointers 16-byte aligned, 4-byte cp.async.ca where they are
//     multiples of 4, else synchronous byte copies (block 9, tile 8).
//     The ragged depth (up to the MMA's 32), rows (up to 16) and columns
//     (up to 8) are zero-filled and masked on store.  Rows of the stage
//     are 80 bytes apart, so the 8 rows of an ldmatrix fall in 8
//     distinct 16-byte bank groups.
//
// A tile with nnz[t] == 0 writes zeros.  Each C entry point launches on
// the stream it is given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// The fixed-order sum of split partials.  A split walk writes S partials
// to a workspace [S, n]; split_reduce_kernel sums them as
// y[i] = ws[0][i] + ws[1][i] + ... + ws[S-1][i], in that order: no
// atomics, so a result is bit-identical from run to run.  It is launched
// as a programmatic dependent of the walk (griddepcontrol): scheduled
// while the walk stores, it waits for the walk's end before it reads.

// Let the dependent grid launch now; it still waits for this grid's end
// before it reads.  A no-op when nothing depends on the grid.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

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

// Launch split_reduce_kernel on `stream` as a programmatic dependent of
// the kernel launched on it just before.
inline cudaError_t launch_split_reduce(const float* ws, float* y, long long n,
                                       int splits, cudaStream_t stream) {
  const int blocks = (int)std::min<long long>((n + 255) / 256, 132 * 16);
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, split_reduce_kernel, ws, y, n,
                                       splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

constexpr int STAGES = 3;  // shared-memory stages: two steps in flight

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most STAGES - 2 groups are in flight: this step's landed
__device__ __forceinline__ void cp_async_wait_step() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

namespace f32 {

constexpr int XPAD = 4;    // x rows of BK + 4 floats: 16-byte aligned rows

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
  allow_dependents();
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

namespace i8 {

constexpr int BK = 64;         // brick depth staged a pipeline step: two MMA k-steps
constexpr int ROWB = BK + 16;  // bytes between staged rows (see the note above)
constexpr int WN = 32;         // output columns per warp: four m16n8 MMAs

// Copy VEC bytes global -> shared, or zero-fill the target when !valid.
// 16 and 4 bytes go asynchronously (cp.async); 1 byte synchronously.
template <int VEC>
__device__ __forceinline__ void copy(int8_t* smem, const int8_t* gmem,
                                     bool valid) {
  if constexpr (VEC == 1) {
    *smem = valid ? *gmem : int8_t(0);
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int n = valid ? VEC : 0;  // 0 bytes read: the target is zero-filled
    if constexpr (VEC == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(gmem), "r"(n));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                   "l"(gmem), "r"(n));
  }
}


// Four 8 x 16-byte matrices from shared memory, one row address a lane.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const int8_t* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16 x 32, row) . b (32 x 8, col), int8 in, exact int32 sums
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments (PTX ISA, mma.m16n8k32 with .s8; g = lane / 4, q = lane % 4):
// A register i holds row g + 8 * (i & 1), bytes 4q..4q+3 + 16 * (i >> 1);
// B register j holds column g, depth 4q..4q+3 + 16 * j; D holds rows g
// and g + 8, columns 2q and 2q + 1.  ldmatrix.x4 gives lane l, in
// register i, row l / 4 and bytes 4 (l % 4).. of the i-th 8 x 16-byte
// matrix, whose row addresses lanes 8i..8i+7 supply: so A (rows of x)
// and B (rows of the K-major brick) load as they are staged.
template <int BM, int BN, int WM, int VEC>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
pattern_spmm_i8_kernel(const int8_t* __restrict__ xq,         // [M, K]
                       const int8_t* __restrict__ w_kt,       // [T, k_max, tile, block]
                       const int32_t* __restrict__ block_ids,  // [T, k_max]
                       const float* __restrict__ w_scales,    // [T, k_max]
                       const int32_t* __restrict__ nnz,       // [T]
                       float* __restrict__ out,  // y [M, T*tile], or the workspace [S, M, T*tile]
                       int M, int K, int T, int k_max, int block, int tile,
                       int splits) {
  constexpr int WARPS_N = BN / WN;
  constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int CH = BK / VEC;  // copies per staged row
  __shared__ __align__(16) int8_t smem[STAGES][(BM + BN) * ROWB];

  const int t = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int slab = blockIdx.z / splits;
  const int s = blockIdx.z - slab * splits;
  const int col0 = slab * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;

  // this block's run of bricks: [s * ceil(n / S), ...) of the tile's n
  const int n = nnz[t];
  const int chunk = (n + splits - 1) / splits;
  const int kb = min(s * chunk, n);
  const int ke = min(kb + chunk, n);
  const int nsub = (block + BK - 1) / BK;
  const int steps = (ke - kb) * nsub;

  // rows 0..BM-1 of a stage: the gathered x slice; rows BM..: the brick's
  // columns col0.., each row BK bytes of depth from d0
  auto stage = [&](int step, int buf) {
    const int kr = step / nsub;
    const int d0 = (step - kr * nsub) * BK;
    const size_t slot = (size_t)t * k_max + kb + kr;
    const int8_t* xcol = xq + (size_t)__ldg(block_ids + slot) * block;
    const int8_t* brick = w_kt + slot * tile * block;
    for (int i = tid; i < (BM + BN) * CH; i += THREADS) {
      const int r = i / CH, c = (i - r * CH) * VEC;
      const int gd = d0 + c;
      bool ok;
      const int8_t* src;
      if (r < BM) {
        const int gr = row0 + r;
        ok = gr < M && gd < block;
        src = xcol + (size_t)gr * K + gd;
      } else {
        const int gn = col0 + r - BM;
        ok = gn < tile && gd < block;
        src = brick + (size_t)gn * block + gd;
      }
      copy<VEC>(&smem[buf][r * ROWB + c], ok ? src : xq, ok);
    }
  };

  float acc[MT][NT][4];
  int32_t part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        part[i][j][e] = 0;
      }

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
    const int8_t* xs = smem[j % STAGES];
    const int8_t* ws = xs + BM * ROWB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], xs + (wm0 + i * 16 + (lane & 15)) * ROWB + kk +
                              (lane >> 4) * 16);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4(r, ws + (wn0 + p * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                ROWB + kk + ((lane >> 3) & 1) * 16);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
          mma_s8(part[i][jn], a[i], b[jn][0], b[jn][1]);
    }
    // a brick's last step: fold its exact partial, in k order
    const int kr = j / nsub;
    if (j - kr * nsub == nsub - 1) {
      const float sc = __ldg(w_scales + (size_t)t * k_max + kb + kr);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][jn][e] = __fadd_rn(
                acc[i][jn][e], __fmul_rn(sc, __int2float_rn(part[i][jn][e])));
            part[i][jn][e] = 0;
          }
    }
  }

  allow_dependents();
  const size_t ld = (size_t)T * tile;
  float* dst = out + (size_t)s * M * ld + (size_t)t * tile;
  const bool even = (tile & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm0 + i * 16 + (lane >> 2) + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const int c = col0 + wn0 + jn * 8 + (lane & 3) * 2;
        float* o = dst + (size_t)r * ld + c;
        const float a0 = acc[i][jn][2 * h], a1 = acc[i][jn][2 * h + 1];
        if (even && c + 1 < tile) {  // 8-byte aligned: ld, t*tile, c even
          *reinterpret_cast<float2*>(o) = make_float2(a0, a1);
        } else {
          if (c < tile) o[0] = a0;
          if (c + 1 < tile) o[1] = a1;
        }
      }
    }
}

template <int BM, int BN, int WM, int VEC>
cudaError_t launch(const int8_t* xq, const int8_t* w_kt,
                   const int32_t* block_ids, const float* w_scales,
                   const int32_t* nnz, float* out, int M, int K, int T,
                   int k_max, int block, int tile, int splits,
                   cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, T, ((tile + BN - 1) / BN) * splits);
  pattern_spmm_i8_kernel<BM, BN, WM, VEC>
      <<<grid, (BM / WM) * (BN / WN) * 32, 0, stream>>>(
          xq, w_kt, block_ids, w_scales, nnz, out, M, K, T, k_max, block,
          tile, splits);
  return cudaGetLastError();
}

// config: the block tile _quant_plan picked, by index into
// _QUANT_TILE_SHAPES (rows, columns, rows a warp)
template <int VEC>
cudaError_t launch_config(int config, const int8_t* xq, const int8_t* w_kt,
                          const int32_t* block_ids, const float* w_scales,
                          const int32_t* nnz, float* out, int M, int K, int T,
                          int k_max, int block, int tile, int splits,
                          cudaStream_t stream) {
#define SPMM_I8_CONFIG(ID, BM, BN, WM)                                      \
  case ID:                                                                  \
    return launch<BM, BN, WM, VEC>(xq, w_kt, block_ids, w_scales, nnz, out, \
                                   M, K, T, k_max, block, tile, splits,     \
                                   stream);
  switch (config) {
    SPMM_I8_CONFIG(0, 64, 128, 32)
    SPMM_I8_CONFIG(1, 32, 128, 16)
    SPMM_I8_CONFIG(2, 16, 128, 16)
    SPMM_I8_CONFIG(3, 32, 32, 16)
    default:
      return cudaErrorInvalidValue;
  }
#undef SPMM_I8_CONFIG
}

}  // namespace i8

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
  return (int)launch_split_reduce((const float*)workspace, (float*)y,
                                  (long long)M * T * tile, splits, s);
}

// The int8 kernel reads the K-major bricks w_kt [T, k_max, tile, block].
// splits and workspace as pattern_spmm_f32's.  vec: bytes a copy, 16
// (block and K multiples of 16, pointers 16-byte aligned), 4 (multiples
// of 4, 4-byte aligned) or 1.
extern "C" int pattern_spmm_i8(const void* xq, const void* w_kt,
                               const void* block_ids, const void* w_scales,
                               const void* nnz, void* y, void* workspace,
                               int M, int K, int T, int k_max, int block,
                               int tile, int config, int splits, int vec,
                               int device, void* stream) {
  if (splits < 1 || (vec != 1 && vec != 4 && vec != 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float* out = splits == 1 ? (float*)y : (float*)workspace;
  const int8_t* xi = (const int8_t*)xq;
  const int8_t* wi = (const int8_t*)w_kt;
  const int32_t* ids = (const int32_t*)block_ids;
  const float* sc = (const float*)w_scales;
  const int32_t* n_t = (const int32_t*)nnz;
  err = vec == 16 ? i8::launch_config<16>(config, xi, wi, ids, sc, n_t, out,
                                          M, K, T, k_max, block, tile,
                                          splits, s)
        : vec == 4 ? i8::launch_config<4>(config, xi, wi, ids, sc, n_t, out,
                                          M, K, T, k_max, block, tile,
                                          splits, s)
                   : i8::launch_config<1>(config, xi, wi, ids, sc, n_t, out,
                                          M, K, T, k_max, block, tile,
                                          splits, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_split_reduce((const float*)workspace, (float*)y,
                                  (long long)M * T * tile, splits, s);
}
