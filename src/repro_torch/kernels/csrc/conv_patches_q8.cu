// Conv patch rows quantized to int8 (im2col + per-row int8), for Hopper
// (sm_90a), in one launch:
//
//   row = (b*H + y)*W + x,   v[f] = x[b, c, y + dy - K/2, x + dx - K/2]
//   for f = c*K*K + dy*K + dx (zero outside the image and for
//   C*K*K <= f < k_pad), and then, in float32 and in this order:
//   amax = max_f |v[f]|,  scale[row] = amax * fl(1/127),
//   inv = amax > 0 ? fl(fl(1/amax) * 127) : 0,
//   xq[row, f] = int8(clamp(rint(v[f] * inv), -127, 127)),
//
// which is core/quantize.quantize_rows over conv_patches.cu's rows, bit for
// bit, as PyTorch computes it on the card: its CUDA division of a tensor by
// a scalar multiplies by the scalar's reciprocal, and `127 / t` is
// `t.reciprocal() * 127`.  It replaces no TPU kernel: the reference
// quantizes the rows with XLA ops after XLA's im2col.  The port ran the
// float32 patch kernel and then quantize_rows' eager passes (abs, amax,
// divides, where, multiply, round, clamp, cast) over the float32 rows, which
// crossed device memory about ten times.
//
// What bounds it on the H100: bytes.  Its least traffic is the activations
// read once, the int8 rows written once (K*K times the activations' count,
// and more where k_pad pads them) and a float32 scale a row.  The float32
// rows never reach device memory.  What the design does about it:
//   - a block owns a tile of tb images x th rows x tw columns of output
//     pixels and all C channels (kernels/patches.py, _q8_plan), so a row's
//     amax is known before any of its features is written.  It streams the
//     tile's input halo through shared memory twice, cc channels at a time:
//     pass 1 keeps each halo position's channel amax (a row's amax is the
//     largest of its K*K positions': a max is exact in any order, and a
//     position outside the image counts 0), pass 2 quantizes.  Pass 2 runs
//     the chunks backwards, so pass 1's last chunk is used again as it
//     stands; the second read of the others mostly hits L2;
//   - the halo is staged channels innermost (a position's cc channels
//     contiguous), two chunks deep: where the channels are innermost in x
//     too, 16-byte cp.async copies (zero-filled outside the image) land
//     the next chunk while the block works on this one; under any other
//     strides 4-byte loads, in step;
//   - a thread quantizes 4 channels of one pixel: a 16-byte shared load a
//     tap, 4*K*K bytes whose channel and tap are compile-time constants,
//     four values packed into a word by their low bytes after adding
//     1.5 * 2^23 (that sum's last bit rounds half to even, as rint does).
//     Neighbouring lanes take neighbouring channels, so the shared loads
//     and the word stores into the tile's int8 rows meet no bank conflict;
//   - the block copies the row tile out with coalesced 16-byte streaming
//     stores where k_pad and the output allow it (vec 16; else bytes).
//     Each chunk's features start on a 16-byte boundary (16 | cc); the last
//     chunk also writes the row's zero padding;
//   - one launch for the whole batch and layer, grid (tiles); the plan
//     takes smaller tiles and wider chunks where the map is small, so the
//     deep layers still fill the card.
// The arithmetic uses __fmul_rn / __fadd_rn / __frcp_rn, which nvcc never
// contracts into an FMA.  Inputs hold no NaN (a NaN row's bytes are not
// PyTorch's, whose cast of NaN is undefined).
//
// The C entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr float RINT_MAGIC = 12582912.0f;   // 1.5 * 2^23
constexpr float INV_QMAX = 0x1.020408p-7f;  // fl(1/127)

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// Byte offsets of a block's shared memory (_q8_smem in patches.py): each
// halo position's element offset in x (-1 outside the image), the staged
// halo (one or, where there are several chunks, two buffers of
// round16(cc) channels a position), the tile's int8 rows of a chunk, each
// halo position's channel amax, each pixel's inverse scale, output row
// and halo position.
struct Layout {
  int pos_off, halo, rows, pos_amax, pix_inv, pix_row, pix_pos, total;
};

__host__ __device__ inline Layout q8_layout(int tb, int th, int tw, int cc,
                                            int C, int k) {
  const int n_pos = tb * (th + k - 1) * (tw + k - 1);
  const int npix = tb * th * tw, cca = round16(cc);
  Layout l;
  l.pos_off = 0;
  l.halo = round16(8 * n_pos);
  l.rows = l.halo + (C > cc ? 2 : 1) * n_pos * cca * 4;
  l.pos_amax = l.rows + npix * cca * k * k;
  l.pix_inv = l.pos_amax + 4 * n_pos;
  l.pix_row = l.pix_inv + 4 * npix;
  l.pix_pos = l.pix_row + 4 * npix;
  l.total = l.pix_pos + 4 * npix;
  return l;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait(bool leave_one) {
  if (leave_one)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// |v| as bits: non-negative floats order as unsigned integers.
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// One int8 feature as the low byte of a word: rint(clamp(v * inv)).
__device__ __forceinline__ unsigned quant_word(float v, float inv) {
  const float p = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(p, RINT_MAGIC));
}

// The 4*K*K bytes of 4 channels of one pixel, in the rows' feature order
// (channel, then tap), as K*K words: hp is the halo at the pixel's tap
// (0, 0) and the first of the channels; row and col are the floats
// between halo rows and between halo positions.
template <int K>
__device__ __forceinline__ void quantize_quad(const float* hp, int row,
                                              int col, float inv,
                                              unsigned* dst) {
  constexpr int KK = K * K;
  unsigned b[4 * KK];
#pragma unroll
  for (int t = 0; t < KK; ++t) {
    const float4 v =
        *reinterpret_cast<const float4*>(hp + (t / K) * row + (t % K) * col);
    b[t] = quant_word(v.x, inv);
    b[KK + t] = quant_word(v.y, inv);
    b[2 * KK + t] = quant_word(v.z, inv);
    b[3 * KK + t] = quant_word(v.w, inv);
  }
#pragma unroll
  for (int w = 0; w < KK; ++w)
    dst[w] = __byte_perm(__byte_perm(b[4 * w], b[4 * w + 1], 0x0040),
                         __byte_perm(b[4 * w + 2], b[4 * w + 3], 0x0040),
                         0x5410);
}

struct Tile {
  const float* x;  // x at the tile's first image
  long long sc;
  const long long* pos_off;
  int n_pos, cca, mode;
};

// Stage channels [c0, c0 + nc) of every halo position into hb, channel
// innermost (position pos, channel c at hb[pos*cca + c - c0]); mode 0
// also zeroes the channels up to the next multiple of 4.  Commits one
// cp.async group (empty in mode 0, whose loads finish in step).
__device__ void stage(const Tile& t, float* hb, int c0, int nc) {
  const int tid = threadIdx.x;
  if (t.mode == 1) {
    const int nq = nc / 4;
    if ((nq & (nq - 1)) == 0 && nq <= THREADS) {  // a fixed quad a thread
      const int q = tid & (nq - 1), step = THREADS / nq;
      const float* src = t.x + (c0 + 4 * q) * t.sc;
      for (int pos = tid / nq; pos < t.n_pos; pos += step) {
        const long long off = t.pos_off[pos];
        cp_async16(hb + pos * t.cca + 4 * q, off >= 0 ? src + off : t.x,
                   off >= 0);
      }
    } else {
      for (int i = tid; i < t.n_pos * nq; i += THREADS) {
        const int q = i % nq, pos = i / nq;
        const long long off = t.pos_off[pos];
        cp_async16(hb + pos * t.cca + 4 * q,
                   off >= 0 ? t.x + off + (c0 + 4 * q) * t.sc : t.x,
                   off >= 0);
      }
    }
  } else {  // any strides: neighbouring threads, neighbouring positions
    const int nc4 = (nc + 3) / 4 * 4;
    for (int i = tid; i < t.n_pos * nc4; i += THREADS) {
      const int pos = i % t.n_pos, c = i / t.n_pos;
      const long long off = t.pos_off[pos];
      float v = 0.f;
      if (off >= 0 && c < nc) v = __ldg(t.x + off + (c0 + c) * t.sc);
      hb[pos * t.cca + c] = v;
    }
  }
  cp_async_commit();
}

// Pass 1 on one staged chunk: each halo position's amax over its nc
// channels folded into pos_amax.  A thread reads 4 channels of a
// position; the lanes that share it reduce by shuffles where they are a
// power of two, and their first lane folds the result in.
__device__ void chunk_amax(const Tile& t, const float* hb, int nc,
                           unsigned* pos_amax) {
  const int tid = threadIdx.x;
  const int nq = (nc + 3) / 4;
  if ((nq & (nq - 1)) == 0 && nq <= THREADS) {
    const int q = tid & (nq - 1), step = THREADS / nq;
    const int lanes = min(nq, 32);  // a position's lanes in one warp
    const unsigned mask = lanes == 32
        ? 0xffffffffu
        : ((1u << lanes) - 1u) << ((tid & 31) & ~(lanes - 1));
    for (int pos = tid / nq; pos < t.n_pos; pos += step) {
      const float4 v =
          *reinterpret_cast<const float4*>(hb + pos * t.cca + 4 * q);
      unsigned m = max(max(abs_bits(v.x), abs_bits(v.y)),
                       max(abs_bits(v.z), abs_bits(v.w)));
      for (int o = lanes / 2; o > 0; o >>= 1)
        m = max(m, __shfl_xor_sync(mask, m, o));
      if ((tid & (lanes - 1)) == 0 && m) atomicMax(pos_amax + pos, m);
    }
  } else {
    for (int i = tid; i < t.n_pos * nq; i += THREADS) {
      const int q = i % nq, pos = i / nq;
      const float4 v =
          *reinterpret_cast<const float4*>(hb + pos * t.cca + 4 * q);
      const unsigned m = max(max(abs_bits(v.x), abs_bits(v.y)),
                             max(abs_bits(v.z), abs_bits(v.w)));
      if (m) atomicMax(pos_amax + pos, m);
    }
  }
}

// Pass 2 on one staged chunk: every pixel's 4*ceil(nc/4)*K*K bytes of it
// into the row tile, a quad of channels a thread, quads fastest.
template <int K>
__device__ void chunk_quantize(const Tile& t, const float* hb, int nc,
                               int npix, int hw, const int* pix_row,
                               const int* pix_pos, const float* pix_inv,
                               unsigned char* rows, int row_bytes) {
  constexpr int KK = K * K;
  const int tid = threadIdx.x;
  const int nq = (nc + 3) / 4;
  const int row = hw * t.cca;
  if ((nq & (nq - 1)) == 0 && nq <= THREADS) {
    const int q = tid & (nq - 1), step = THREADS / nq;
    for (int p = tid / nq; p < npix; p += step) {
      if (pix_row[p] < 0) continue;
      quantize_quad<K>(hb + pix_pos[p] * t.cca + 4 * q, row, t.cca,
                       pix_inv[p],
                       reinterpret_cast<unsigned*>(rows + p * row_bytes +
                                                   4 * KK * q));
    }
  } else {
    for (int i = tid; i < npix * nq; i += THREADS) {
      const int q = i % nq, p = i / nq;
      if (pix_row[p] < 0) continue;
      quantize_quad<K>(hb + pix_pos[p] * t.cca + 4 * q, row, t.cca,
                       pix_inv[p],
                       reinterpret_cast<unsigned*>(rows + p * row_bytes +
                                                   4 * KK * q));
    }
  }
}

template <int K, int VEC>
__global__ void __launch_bounds__(THREADS)
conv_patches_q8_kernel(const float* __restrict__ x, long long sb,
                       long long sc, long long sy, long long sx,
                       int8_t* __restrict__ xq, float* __restrict__ scale,
                       int B, int C, int H, int W, int k_pad, int tb, int th,
                       int tw, int cc, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KK = K * K, R = K / 2;
  const Layout l = q8_layout(tb, th, tw, cc, C, K);
  long long* pos_off = reinterpret_cast<long long*>(smem + l.pos_off);
  float* halo = reinterpret_cast<float*>(smem + l.halo);
  unsigned char* rows = smem + l.rows;
  unsigned* pos_amax = reinterpret_cast<unsigned*>(smem + l.pos_amax);
  float* pix_inv = reinterpret_cast<float*>(smem + l.pix_inv);
  int* pix_row = reinterpret_cast<int*>(smem + l.pix_row);
  int* pix_pos = reinterpret_cast<int*>(smem + l.pix_pos);
  const int hh = th + K - 1, hw = tw + K - 1;
  const int cca = round16(cc), npix = tb * th * tw;
  const int n_pos = tb * hh * hw, row_bytes = cca * KK;
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  int t = blockIdx.x;
  const int x0 = (t % tiles_x) * tw;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * th;
  const int b0 = (t / tiles_y) * tb;
  const int nb = min(tb, B - b0);
  const int tid = threadIdx.x;

  // 0. where each halo position lies in x, and each pixel's output row
  for (int pos = tid; pos < n_pos; pos += THREADS) {
    const int xx = pos % hw, r = pos / hw;
    const int yy = r % hh, bb = r / hh;
    const int gy = y0 + yy - R, gx = x0 + xx - R;
    pos_off[pos] = bb < nb && gy >= 0 && gy < H && gx >= 0 && gx < W
                       ? bb * sb + gy * sy + gx * sx
                       : -1;
    pos_amax[pos] = 0u;
  }
  for (int p = tid; p < npix; p += THREADS) {
    const int px = p % tw, r = p / tw;
    const int py = r % th, bb = r / th;
    const int gy = y0 + py, gx = x0 + px;
    pix_row[p] = bb < nb && gy < H && gx < W ? ((b0 + bb) * H + gy) * W + gx
                                             : -1;
    pix_pos[p] = (bb * hh + py) * hw + px;
  }
  __syncthreads();

  const Tile tile{x + b0 * sb, sc, pos_off, n_pos, cca, mode};
  float* const hbuf[2] = {halo, halo + n_pos * cca};
  const int n = (C + cc - 1) / cc;

  // 1. pass 1: each halo position's channel amax, chunk by chunk
  stage(tile, hbuf[0], 0, min(cc, C));
  for (int s = 0; s < n; ++s) {
    const bool next = s + 1 < n;
    if (next)
      stage(tile, hbuf[(s + 1) & 1], (s + 1) * cc, min(cc, C - (s + 1) * cc));
    cp_async_wait(next);
    __syncthreads();
    chunk_amax(tile, hbuf[s & 1], min(cc, C - s * cc), pos_amax);
    __syncthreads();
  }

  // 2. each pixel's row amax over its K*K positions; its scale and inverse
  for (int p = tid; p < npix; p += THREADS) {
    if (pix_row[p] < 0) continue;
    unsigned m = 0u;
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
        m = max(m, pos_amax[pix_pos[p] + dy * hw + dx]);
    const float a = __uint_as_float(m);
    pix_inv[p] = a > 0.f ? __fmul_rn(__frcp_rn(a), 127.f) : 0.f;
    scale[pix_row[p]] = __fmul_rn(a, INV_QMAX);
  }

  // 3. pass 2, the chunks backwards (the last is still staged): quantize
  // into the row tile, then copy the tile out; the last chunk runs on to
  // k_pad
  for (int c = n - 1; c >= 0; --c) {
    const int c0 = c * cc, nc = min(cc, C - c0);
    const bool next = c > 0;
    if (next) stage(tile, hbuf[(c - 1) & 1], c0 - cc, cc);
    cp_async_wait(next);
    __syncthreads();
    chunk_quantize<K>(tile, hbuf[c & 1], nc, npix, hw, pix_row, pix_pos,
                      pix_inv, rows, row_bytes);
    __syncthreads();

    const int f0 = c0 * KK;
    const int f1 = c + 1 == n ? k_pad : (c0 + cc) * KK;
    const int have = (nc + 3) / 4 * 4 * KK;  // bytes of a row written
    const int nvec = (f1 - f0) / VEC;
    // (p, q) of item i, stepped by THREADS items without a division
    const int dp = THREADS / nvec, dq = THREADS % nvec;
    int p = tid / nvec, q = tid % nvec;
    for (; p < npix; p += dp, q += dq) {
      if (q >= nvec) {
        q -= nvec;
        if (++p >= npix) break;
      }
      const int r = pix_row[p];
      if (r < 0) continue;
      int8_t* orow = xq + (long long)r * k_pad + f0;
      const unsigned char* src = rows + p * row_bytes;
      if constexpr (VEC == 16) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        const int b = 16 * q;
        if (b < have) {
          v = *reinterpret_cast<const uint4*>(src + b);
          if (b + 16 > have) {  // words past the written bytes are zero
            if (b + 4 >= have) v.y = 0u;
            if (b + 8 >= have) v.z = 0u;
            if (b + 12 >= have) v.w = 0u;
          }
        }
        __stcs(reinterpret_cast<uint4*>(orow + b), v);
      } else {
        orow[q] = q < have ? (int8_t)src[q] : (int8_t)0;
      }
    }
  }
}

template <int K, int VEC>
cudaError_t launch(const float* x, long long sb, long long sc, long long sy,
                   long long sx, int8_t* xq, float* scale, int B, int C,
                   int H, int W, int k_pad, int tb, int th, int tw, int cc,
                   int mode, cudaStream_t stream) {
  const long long tiles = (long long)((B + tb - 1) / tb) *
                          ((H + th - 1) / th) * ((W + tw - 1) / tw);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the plan keeps a block within what it takes without opting in
  const int smem = q8_layout(tb, th, tw, cc, C, K).total;
  if (smem > SMEM_DEFAULT) return cudaErrorInvalidValue;
  conv_patches_q8_kernel<K, VEC><<<(unsigned)tiles, THREADS, smem, stream>>>(
      x, sb, sc, sy, sx, xq, scale, B, C, H, W, k_pad, tb, th, tw, cc, mode);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_vec(int vec, const float* x, long long sb, long long sc,
                       long long sy, long long sx, int8_t* xq, float* scale,
                       int B, int C, int H, int W, int k_pad, int tb, int th,
                       int tw, int cc, int mode, cudaStream_t s) {
  return vec == 16
             ? launch<K, 16>(x, sb, sc, sy, sx, xq, scale, B, C, H, W, k_pad,
                             tb, th, tw, cc, mode, s)
             : launch<K, 1>(x, sb, sc, sy, sx, xq, scale, B, C, H, W, k_pad,
                            tb, th, tw, cc, mode, s);
}

}  // namespace

// x: float32 [B, C, H, W] read through its strides (in elements); xq: int8
// [B*H*W, k_pad], row-major; scale: float32 [B*H*W].  k: 1, 3, 5 or 7.
// Tile (tb, th, tw) and channel chunk cc as _q8_plan gives them (cc a
// multiple of 16 where C > cc; shared memory within 48 KB).  mode: 0 any
// strides, 4-byte loads; 1 channels innermost, 16-byte cp.async copies
// (stride of C 1, C and the other strides multiples of 4, x 16-byte
// aligned).  vec: 16 (k_pad a multiple of 16, xq 16-byte aligned) or 1.
// Every output row index B*H*W - 1 fits an int.
extern "C" int conv_patches_q8(const void* x, long long sb, long long sc,
                               long long sy, long long sx, void* xq,
                               void* scale, int B, int C, int H, int W, int k,
                               int k_pad, int tb, int th, int tw, int cc,
                               int mode, int vec, int device, void* stream) {
  if ((vec != 1 && vec != 16) || mode < 0 || mode > 1 || tb < 1 || th < 1 ||
      tw < 1 || cc < 1 || k_pad < C * k * k || (vec == 16 && k_pad % 16) ||
      (C > cc && cc % 16) || (mode == 1 && (cc % 4 || C % 4)) ||
      (long long)B * H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  int8_t* q = (int8_t*)xq;
  float* sf = (float*)scale;
  switch (k) {
    case 1:
      return (int)launch_vec<1>(vec, xf, sb, sc, sy, sx, q, sf, B, C, H, W,
                                k_pad, tb, th, tw, cc, mode, s);
    case 3:
      return (int)launch_vec<3>(vec, xf, sb, sc, sy, sx, q, sf, B, C, H, W,
                                k_pad, tb, th, tw, cc, mode, s);
    case 5:
      return (int)launch_vec<5>(vec, xf, sb, sc, sy, sx, q, sf, B, C, H, W,
                                k_pad, tb, th, tw, cc, mode, s);
    case 7:
      return (int)launch_vec<7>(vec, xf, sb, sc, sy, sx, q, sf, B, C, H, W,
                                k_pad, tb, th, tw, cc, mode, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
