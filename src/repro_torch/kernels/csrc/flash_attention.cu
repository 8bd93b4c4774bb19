// Flash-Attention-2 forward for Hopper (sm_90a): a tensor-core route for
// bf16 and fp16 inputs, a SIMT route on the CUDA cores for fp32 inputs.
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
//   over the keys j with  j < kv_len,  j <= i (causal),  j > i - window (window)
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py).  There the grid walks
// (head row, query tile, key tile) with the key tile innermost, carrying
// the running max, denominator and accumulator in VMEM scratch from one
// grid step to the next, and skipping key tiles strictly above the causal
// diagonal.  Here one thread block owns one (head row, 64-query tile) and
// a loop inside the block takes the place of the sequential key-tile grid
// dimension, so nothing carries over between blocks.  Key tiles wholly
// above the causal diagonal, wholly below the sliding window, or past
// kv_len are never loaded or computed.
//
// Query positions start at 0 (as the Pallas kernel's do).  GQA is folded
// in the kernel: query head h reads key/value head h / (Hq / Hkv), so the
// repeated key heads are never materialised.  Every tensor is addressed
// through (batch, head, seq) strides with a unit stride along D, so a
// [B, S, H, D] cache is read in place through a transposed view.
//
// What bounds it on the H100: operations.  At the generation path's
// prefill shapes (32 query heads, 8 key heads, D = 80, bf16) a query tile
// of 64 rows reads each key tile once for 64 x 64 x 2 x 80 multiply-adds,
// far above the card's operations-per-byte balance.  The least time is
// the unmasked pairs' 4 * D operations at the bf16 tensor cores' rate.
// The route is chosen by the input type, never on failure: bf16 and fp16
// run flash_mma_kernel (the scores and P V on the tensor cores, below);
// fp32 runs flash_fwd_kernel on the CUDA cores, since fp32's
// 2e-5 tolerance cannot be met through 16-bit tensor-core inputs.
//
// Masked scores are -inf and the exponent of a row whose keys are all
// masked so far is held at 0, so a row with no visible key ends with a
// zero denominator and is written as 0 — the reference oracle's value
// (src/repro/kernels/ref.py, flash_attention_ref).  Ragged Sq and Sk are
// masked, not padded.  The output has the input's type; every sum is fp32.
//
// SIMT layout (fp32): 128 threads per block, BQ = 64 query rows, BK = 64
// keys per tile.  Thread (rg, cg) = (tid / 8, tid % 8) owns query rows
// 4rg..4rg+3; for the scores it owns keys cg + 8j (j < 8), for the output
// columns cg + 8j (j < DM / 8).  The kernel is instantiated for a widest
// head DM of 128 (D <= 128: 16 output columns a row, the register plan of
// the D-80 and D-128 paths) and of 256 (D in (128, 256]: 32 columns a row,
// 128 fp32 accumulators a thread).  The 8 lanes of a row group are
// neighbours in one warp, so a row's max and sum are warp shuffles and the
// probabilities a row group writes to shared memory are read back by the
// same warp.  Shared memory: Q and K at a row stride of D + 1 (odd, so the
// four rows a warp reads at one depth fall in different banks), V at D, P
// at BK + 1: 78,592 bytes at D = 80, 115,456 at D = 128, 213,760 at
// D = 256 (one block an SM, under the 232,448-byte opt-in limit).
//
// Each C entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr int DMAX = 256;    // largest head dimension
constexpr int RPT = 4;       // query rows per thread
constexpr int CPT = BK / 8;  // keys per thread in a score tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_h, q_s;  // strides in elements: batch, head, sequence
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
  int Hq, Hkv, Sq, Sk, D;
  float scale;
  int causal;
  int window;  // <= 0: no window
  int kv_len;  // keys at positions >= kv_len are masked
};

size_t smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
          (size_t)BQ * (BK + 1));
}

// DM: the widest head this instantiation takes (128 or 256)
template <int DM>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  constexpr int DPT = DM / 8;  // output columns per thread
  extern __shared__ float smem[];
  const int D = p.D;
  const int ldq = D + 1;
  const int ldp = BK + 1;
  float* Qs = smem;             // [BQ][ldq]
  float* Ks = Qs + BQ * ldq;    // [BK][ldq]
  float* Vs = Ks + BK * ldq;    // [BK][D]
  float* Ps = Vs + BK * D;      // [BQ][ldp]

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq;
  const int h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * BQ;

  const float* q = static_cast<const float*>(p.q) + b * p.q_b + h * p.q_h;
  const float* k = static_cast<const float*>(p.k) + b * p.k_b + hk * p.k_h;
  const float* v = static_cast<const float*>(p.v) + b * p.v_b + hk * p.v_h;
  float* o = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int qi = q0 + r;
    Qs[r * ldq + d] = qi < p.Sq ? q[qi * p.q_s + d] : 0.f;
  }

  // the key tiles any query of this tile can see
  const int k_lim = min(p.kv_len, p.Sk);
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_end = k_lim;
  if (p.causal) k_end = min(k_end, q_last + 1);
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D;
      const int d = i - r * D;
      const int kj = k0 + r;
      const bool ok = kj < k_lim;
      Ks[r * ldq + d] = ok ? k[kj * p.k_s + d] : 0.f;
      Vs[r * D + d] = ok ? v[kj * p.v_s + d] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(rg * RPT + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(cg + 8 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      const int qpos = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + cg + 8 * j;
        bool keep = kpos < k_lim;
        if (p.causal) keep = keep && qpos >= kpos;
        if (p.window > 0) keep = keep && kpos > qpos - p.window;
        s[i][j] = keep ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // no visible key yet: keep the row at zero (alpha 1, p 0)
      const bool dead = m_new == -INFINITY;
      const float alpha = dead ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = dead ? 0.f : expf(s[i][j] - m_new);
        Ps[r * ldp + cg + 8 * j] = pj;
        sum += pj;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    // a row group's probabilities are read back by the same warp
    __syncwarp();

    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(rg * RPT + i) * ldp + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = cg + 8 * j;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ps
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + rg * RPT + i;
    if (qi >= p.Sq) continue;
    const bool empty = !(l[i] > 0.f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = cg + 8 * j;
      if (d < D) o[qi * p.o_s + d] = empty ? 0.f : acc[i][j] / l[i];
    }
  }
}

template <int DM>
cudaError_t launch_simt(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.Hq);
  flash_fwd_kernel<DM><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const Params& p, int B, cudaStream_t stream) {
  if (p.D <= 128) return launch_simt<128>(p, B, stream);
  return launch_simt<DMAX>(p, B, stream);
}

// ---------------------------------------------------------------------------
// The tensor-core route, for bf16 and fp16 inputs (flash_mma_kernel).
//
// Both products run on the tensor cores through mma.sync.m16n8k16 with
// fp32 accumulation.  128 threads; warp w owns query rows 16w..16w+15 of
// a 64-row tile.  Q, K and V stay in their 16-bit type in shared memory,
// at a row stride of DP + 8 elements (DP: D rounded up to an instantiated
// width, the extra columns zero-filled), so the 8 rows one ldmatrix reads
// fall in 8 different 16-byte bank groups.  Q's fragments are loaded once
// with ldmatrix (at DP = 256 at each k16 step, below); K and V tiles of
// 64 keys are copied with cp.async (16 bytes, zero-filled past kv_len and
// past D) into the second of two stages while the first is computed.
//
// DP = 256 (paligemma's head width): the fragments of Q (16 k16 steps x
// 4 registers), the output accumulators (32 n8 tiles x 4) and one key
// tile's scores (8 x 4) would hold 224 registers a thread before any
// address, against the 255 a thread may have.  So at DP = 256 Q's
// fragments are read again from shared memory (where Q stays for the
// whole block) at each k16 step of Q K^T: one more ldmatrix beside the
// four that read K, and 64 registers freed, as FA-2 does at D = 256.
// Shared memory is 2 x (64 + 4 x 64) x 264 = 168,960 bytes: one block
// an SM.
//
// S = Q K^T: per key tile a warp holds 16 x 64 fp32 scores in the MMA's
// accumulator fragments: thread (lane) holds rows lane/4 and lane/4 + 8,
// keys 8j + 2(lane % 4) + {0, 1}.  On the tiles at an edge of the mask
// (the diagonal, the window's far end, kv_len) the masks are applied by
// each element's (row, key); the row maxima and sums are taken over the
// thread's 16 values and then across the quad with two shuffles; l sums
// the fp32 p.  The scores are kept in base 2 (scale * log2(e)), so each
// exponential is one ex2.approx (relative error ~2^-22, against the
// 2^-16 of the P split below).
//
// P V: the reference multiplies fp32 p by v upcast to fp32.  One 16-bit P
// would round each p by up to 2^-8 (bf16's unit roundoff u).  So
// P = P_hi + P_lo with P_hi = bf16(p) and P_lo = bf16(p - P_hi), and two
// MMAs against the same V fragment (ldmatrix.trans) add both: what is
// left of p is at most u of p - P_hi, so at most u^2 = 2^-16 of p, and
// about 2^-18 of p on average.  Across n keys that moves an output by
// at most 2^-16 * sum_j p_j |v_j| / l, and by about 2^-18 * |v| / sqrt(n)
// for rounding errors of random sign.  fp16 inputs take fp16 terms
// (u = 2^-11); below 2^-14 fp16 is subnormal, which leaves at most 2^-25
// absolute of each p.  The accumulator fragments of S are
// the A fragments of P V for the same rows (two 8-key tiles per k16 step),
// so P never goes through shared memory.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 64;    // query rows per block, 16 per warp
constexpr int BKV = 64;   // keys per tile
constexpr int THREADS = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the target is zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 2^x on the special-function unit (relative error ~2^-22); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  // c += a (16 x 16, row) * b (16 x 8, col), fp32 accumulators
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // (hi, lo) halves of the pair (x, y): hi = 16-bit(x), lo = 16-bit(x - hi)
  static __device__ __forceinline__ void split2(float x, float y,
                                                uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const __nv_bfloat162 l = __floats2bfloat162_rn(
        x - __low2float(h), y - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
  static __device__ __forceinline__ uint32_t pack2(float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ void split2(float x, float y,
                                                uint32_t& hi, uint32_t& lo) {
    const __half2 h = __floats2half2_rn(x, y);
    const __half2 l = __floats2half2_rn(x - __low2float(h),
                                        y - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
  static __device__ __forceinline__ uint32_t pack2(float x, float y) {
    const __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

constexpr size_t smem_bytes(int dp) {
  return sizeof(uint16_t) * (size_t)(BQ + 4 * BKV) * (dp + 8);
}

// Three blocks an SM up to D = 80, two up to 128, one at 256 (shared
// memory holds no second).  At D = 80 ptxas spills ~64 bytes a thread to
// fit 168 registers, and on an H100 (700 W) the 4500-token prefill call
// still ran ~10 % faster than at two blocks with no spill.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, DP <= 80 ? 3 : DP <= 128 ? 2 : 1)
flash_mma_kernel(const Params p) {
  constexpr int LD = DP + 8;  // row stride in elements
  constexpr int KS = DP / 16;  // k16 steps of Q K^T
  constexpr int NT = DP / 8;   // n8 tiles of the output
  constexpr int CH = DP / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* Ks = Qs + BQ * LD;                     // [2][BKV][LD]
  T* Vs = Ks + 2 * BKV * LD;                // [2][BKV][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq;
  const int h = bh - b * p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int D = p.D;

  const T* q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + hk * p.k_h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + hk * p.v_h;
  T* o = static_cast<T*>(p.o) + b * p.o_b + h * p.o_h;

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const bool ok = q0 + r < p.Sq && c < D;
    cp_async16(Qs + r * LD + c, ok ? q + (q0 + r) * p.q_s + c : q, ok);
  }

  // the key tiles any query of this tile can see
  const int key_lim = min(p.kv_len, p.Sk);
  const int row_last = min(q0 + BQ, p.Sq) - 1;
  int key_end = key_lim;
  if (p.causal) key_end = min(key_end, row_last + 1);
  const int key_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int tile_lo = key_begin / BKV;
  const int tile_hi = (key_end + BKV - 1) / BKV;

  auto load_kv = [&](int tile, int buf) {
    T* kd = Ks + buf * BKV * LD;
    T* vd = Vs + buf * BKV * LD;
    for (int i = tid; i < BKV * CH; i += THREADS) {
      const int r = i / CH;
      const int c = (i - r * CH) * 8;
      const int kj = tile * BKV + r;
      const bool ok = kj < key_lim && c < D;
      cp_async16(kd + r * LD + c, ok ? k + kj * p.k_s + c : k, ok);
      cp_async16(vd + r * LD + c, ok ? v + kj * p.v_s + c : v, ok);
    }
  };

  if (tile_lo < tile_hi) load_kv(tile_lo, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  // Q's fragments, held for the whole walk below DP = 256
  uint32_t qf[DP == 256 ? 1 : KS][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + (lane >> 2);  // and row_a + 8
  const int col_a = 2 * (lane & 3);
  // scores in base 2: p = 2^(s log2(e) - m), the same p as e^(s - m)
  const float scale2 = p.scale * 1.4426950408889634f;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int buf = (tile - tile_lo) & 1;
    if (tile + 1 < tile_hi) load_kv(tile + 1, buf ^ 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    if constexpr (DP != 256) {
      if (tile == tile_lo) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                              (lane >> 4) * 8);
      }
    }
    const T* kt = Ks + buf * BKV * LD;
    const T* vt = Vs + buf * BKV * LD;

    float sc[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      if constexpr (DP == 256) {
        ldsm_x4(qa, Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                        (lane >> 4) * 8);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
      }
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        Ops<T>::mma(sc[2 * np], qa, kb[0], kb[1]);
        Ops<T>::mma(sc[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    const int k0 = tile * BKV;
    // a tile that every query of the block sees whole needs no mask
    const bool edge = k0 + BKV > key_lim ||
                      (p.causal && k0 + BKV - 1 > q0) ||
                      (p.window > 0 && k0 <= q0 + BQ - 1 - p.window);
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = row_a + 8 * half;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& s = sc[j][2 * half + e];
          if (edge) {
            const int kpos = k0 + 8 * j + col_a + e;
            bool vis = kpos < key_lim;
            if (p.causal) vis = vis && kpos <= qpos;
            if (p.window > 0) vis = vis && kpos > qpos - p.window;
            s = vis ? s * scale2 : -INFINITY;
          } else {
            s *= scale2;
          }
          mx = fmaxf(mx, s);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      // no visible key yet: keep the row at zero (alpha 1, p 0)
      const bool dead = m_new == -INFINITY;
      alpha[half] = dead ? 1.f : ex2(m_run[half] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& s = sc[j][2 * half + e];
          s = dead ? 0.f : ex2(s - m_new);
          sum += s;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[half] = alpha[half] * l_run[half] + sum;
      m_run[half] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P_hi V + P_lo V, 16 keys per step
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t ph[4], pl[4];
      Ops<T>::split2(sc[2 * kc][0], sc[2 * kc][1], ph[0], pl[0]);
      Ops<T>::split2(sc[2 * kc][2], sc[2 * kc][3], ph[1], pl[1]);
      Ops<T>::split2(sc[2 * kc + 1][0], sc[2 * kc + 1][1], ph[2], pl[2]);
      Ops<T>::split2(sc[2 * kc + 1][2], sc[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LD + np * 16 + (lane >> 4) * 8);
        Ops<T>::mma(acc[2 * np], ph, vb[0], vb[1]);
        Ops<T>::mma(acc[2 * np], pl, vb[0], vb[1]);
        Ops<T>::mma(acc[2 * np + 1], ph, vb[2], vb[3]);
        Ops<T>::mma(acc[2 * np + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the next tile's copies overwrite this stage
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row_a + 8 * half;
    if (qi >= p.Sq) continue;
    const float l = l_run[half];
    const bool empty = !(l > 0.f);
    T* orow = o + qi * p.o_s;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = 8 * n + col_a;
      if (d < D) {
        const float x0 = empty ? 0.f : acc[n][2 * half] / l;
        const float x1 = empty ? 0.f : acc[n][2 * half + 1] / l;
        *reinterpret_cast<uint32_t*>(orow + d) = Ops<T>::pack2(x0, x1);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.Hq);
  flash_mma_kernel<T, DP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// D rounded up to the widths instantiated
template <typename T>
cudaError_t launch_d(const Params& p, int B, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, B, stream);
  if (p.D <= 64) return launch<T, 64>(p, B, stream);
  if (p.D <= 80) return launch<T, 80>(p, B, stream);
  if (p.D <= 128) return launch<T, 128>(p, B, stream);
  return launch<T, 256>(p, B, stream);
}

}  // namespace tc

}  // namespace

// Strides are in elements, in the order (batch, head, sequence) for each
// of q, k, v, o.  flash_attention_fwd takes float32 inputs (the SIMT
// kernel); flash_attention_fwd_mma takes bf16 (dtype 1) or fp16 (dtype 2)
// inputs (the tensor-core kernel), D a multiple of 8, every sequence and
// head stride a multiple of 8 elements and every base 16-byte aligned.
#define FLASH_ARGS                                                          \
  const void *q, const void *k, const void *v, void *o, int dtype, int B,  \
      int Hq, int Hkv, int Sq, int Sk, int D, long long q_b, long long q_h, \
      long long q_s, long long k_b, long long k_h, long long k_s,           \
      long long v_b, long long v_h, long long v_s, long long o_b,           \
      long long o_h, long long o_s, float scale, int causal, int window,    \
      int kv_len, int device, void *stream

static int check_args(int D, int B, int Hq, int Hkv, int device) {
  if (D < 1 || D > DMAX || Hkv < 1 || Hq % Hkv != 0 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

extern "C" int flash_attention_fwd(FLASH_ARGS) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  int err = check_args(D, B, Hq, Hkv, device);
  if (err != 0) return err;
  if (B == 0 || Sq == 0) return 0;
  Params p{q,   k,   v,   o,   q_b, q_h, q_s,   k_b,    k_h,    k_s,
           v_b, v_h, v_s, o_b, o_h, o_s, Hq,    Hkv,    Sq,     Sk,
           D,   scale, causal, window, kv_len};
  return (int)launch_fp32(p, B, (cudaStream_t)stream);
}

extern "C" int flash_attention_fwd_mma(FLASH_ARGS) {
  if (D % 8 != 0) return (int)cudaErrorInvalidValue;
  int err = check_args(D, B, Hq, Hkv, device);
  if (err != 0) return err;
  if (B == 0 || Sq == 0) return 0;
  Params p{q,   k,   v,   o,   q_b, q_h, q_s,   k_b,    k_h,    k_s,
           v_b, v_h, v_s, o_b, o_h, o_s, Hq,    Hkv,    Sq,     Sk,
           D,   scale, causal, window, kv_len};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 1: return (int)tc::launch_d<__nv_bfloat16>(p, B, s);
    case 2: return (int)tc::launch_d<__half>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
