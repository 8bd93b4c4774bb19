// Flash-Attention-2 forward for Hopper (sm_90a), on the CUDA cores in fp32.
//
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
//   over the keys j with  j < kv_len,  j <= i (causal),  j > i - window (window)
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py).  There the grid walks
// (head row, query tile, key tile) with the key tile innermost, carrying
// the running max, denominator and accumulator in VMEM scratch from one
// grid step to the next, and skipping key tiles strictly above the causal
// diagonal.  Here one thread block owns one (head row, query tile) and a
// loop inside the block takes the place of the sequential key-tile grid
// dimension, so nothing carries over between blocks.
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
// the unmasked pairs' 4 * D operations at the bf16 tensor cores' rate;
// this simple kernel runs them on the fp32 CUDA cores instead (about 15x
// slower at peak).  What the design does about it: key tiles wholly above
// the causal diagonal, wholly below the sliding window, or past kv_len are
// never loaded or computed; the Q, K and V tiles are staged in shared
// memory in fp32 so each value loaded from device memory feeds 64 rows or
// columns of multiply-adds.  wgmma, TMA and a bf16 P.V product are later
// work.
//
// Layout: 128 threads per block, BQ = 64 query rows, BK = 64 keys per
// tile.  Thread (rg, cg) = (tid / 8, tid % 8) owns query rows 4rg..4rg+3;
// for the scores it owns keys cg + 8j (j < 8), for the output columns
// cg + 8j (j < 16, up to D = 128).  The 8 lanes of a row group are
// neighbours in one warp, so a row's max and sum are warp shuffles and the
// probabilities a row group writes to shared memory are read back by the
// same warp.  Shared memory: Q and K at a row stride of D + 1 (odd, so the
// four rows a warp reads at one depth fall in different banks), V at D, P
// at BK + 1: 78,592 bytes at D = 80, 115,456 at D = 128.
//
// Masked scores are -inf and the exponent of a row whose keys are all
// masked so far is held at 0, so a row with no visible key ends with a
// zero denominator and is written as 0 — the reference oracle's value
// (src/repro/kernels/ref.py, flash_attention_ref).  Ragged Sq and Sk are
// masked, not padded.  Inputs are fp32, bf16 or fp16 (all three the same
// type); the output has the input's type; every sum is fp32.
//
// The C entry point launches on the stream it is given and returns
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
constexpr int DMAX = 128;    // largest head dimension
constexpr int RPT = 4;       // query rows per thread
constexpr int CPT = BK / 8;  // keys per thread in a score tile
constexpr int DPT = DMAX / 8;  // output columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
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

  const T* q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + hk * p.k_h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + hk * p.v_h;
  T* o = static_cast<T*>(p.o) + b * p.o_b + h * p.o_h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int qi = q0 + r;
    Qs[r * ldq + d] = qi < p.Sq ? to_f(q[qi * p.q_s + d]) : 0.f;
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
      Ks[r * ldq + d] = ok ? to_f(k[kj * p.k_s + d]) : 0.f;
      Vs[r * D + d] = ok ? to_f(v[kj * p.v_s + d]) : 0.f;
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
      if (d < D) o[qi * p.o_s + d] = from_f<T>(empty ? 0.f : acc[i][j] / l[i]);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.Hq);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  Strides are in elements, in
// the order (batch, head, sequence) for each of q, k, v, o.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Sk, int D, long long q_b, long long q_h,
    long long q_s, long long k_b, long long k_h, long long k_s, long long v_b,
    long long v_h, long long v_s, long long o_b, long long o_h, long long o_s,
    float scale, int causal, int window, int kv_len, int device,
    void* stream) {
  if (D < 1 || D > DMAX || Hkv < 1 || Hq % Hkv != 0 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Sq == 0) return 0;
  Params p{q,   k,   v,   o,   q_b, q_h, q_s,   k_b,    k_h,    k_s,
           v_b, v_h, v_s, o_b, o_h, o_s, Hq,    Hkv,    Sq,     Sk,
           D,   scale, causal, window, kv_len};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: err = launch<float>(p, B, s); break;
    case 1: err = launch<__nv_bfloat16>(p, B, s); break;
    case 2: err = launch<__half>(p, B, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
