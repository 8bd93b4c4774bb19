// Conv patch extraction (im2col) for Hopper (sm_90a), in one launch.
//
//   out[(b*H + y)*W + x, c*K*K + dy*K + dx] = x[b, c, y + dy - K/2, x + dx - K/2]
//
// (zero where the tap falls outside the image), and out[row, f] = 0 for
// the features C*K*K <= f < k_pad: the padded rows the pattern spmm reads
// (engine/lowering.conv_matrix's feature order).  It replaces no TPU
// kernel: the reference leaves im2col to XLA, which fuses it.  The port
// ran F.unfold (one launch per image, after a copy of the channels-last
// activations to NCHW), a transposing copy and a zero pad of its result,
// so the patch rows crossed device memory about four times.
//
// What bounds it on the H100: bytes, with no arithmetic at all.  Its
// least traffic is the activations read once and the padded rows written
// once; the rows are K*K times (and more, padded) the activations, so the
// writes are nearly all of it.  What the design does about it:
//   - each output byte written once, by 16-byte stores where k_pad and
//     the output allow it (vec 4; else 4-byte stores).  A warp writes one
//     pixel's features of a channel chunk, a contiguous stretch of the
//     row, so every store is coalesced;
//   - each activation read from device memory about once: a block owns a
//     tile of tb images x th rows x tw columns of output pixels and a
//     chunk of cc input channels, and stages the tile's input halo
//     (tb x cc x (th + K - 1) x (tw + K - 1)) in shared memory, zero
//     outside the image, before any store; the K*K taps of a pixel then
//     read shared memory.  The plan (kernels/patches.py, _patch_plan)
//     takes the tile from H, W and B (about 64 pixels, rows cut evenly)
//     and the chunk from C, within the 48 KB a block takes unasked;
//   - reads that follow the layout, chosen by the wrapper from the
//     strides (_halo_mode): channels-last activations (the spmm's NHWC
//     output, permuted; so are channel_norm's, ReLU's and the pool's
//     outputs) are staged channels-fastest, 16 bytes of 4 channels a
//     load (mode 1); any other strides, NCHW (the uploaded images) among
//     them, columns-fastest, 4 bytes a load (mode 0).  Each channel of
//     the halo starts at an odd word offset, so the 4-channel loads'
//     shared-memory stores fall in distinct banks;
//   - one launch for the whole batch and layer: grid (tiles, chunks).
//     The last chunk of a row also writes the row's zero padding.
// A pure copy: each output is an input value or +0, bit for bit.
//
// The C entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_DEFAULT = 48 * 1024;

// Words between two channels of a staged halo: the halo's area, made odd.
__host__ __device__ inline int halo_plane(int th, int tw, int k) {
  return ((th + k - 1) * (tw + k - 1)) | 1;
}

template <int K, int VEC>
__global__ void __launch_bounds__(THREADS)
conv_patches_kernel(const float* __restrict__ x, long long sb, long long sc,
                    long long sy, long long sx, float* __restrict__ out,
                    int B, int C, int H, int W, int k_pad, int tb, int th,
                    int tw, int cc, int mode) {
  extern __shared__ float halo[];
  constexpr int KK = K * K, R = K / 2;
  const int hh = th + K - 1, hw = tw + K - 1;
  const int plane = halo_plane(th, tw, K);
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  int t = blockIdx.x;
  const int x0 = (t % tiles_x) * tw;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * th;
  const int b0 = (t / tiles_y) * tb;
  const int c0 = blockIdx.y * cc;
  const int nc = min(cc, C - c0), nb = min(tb, B - b0);
  const int tid = threadIdx.x;

  // 1. the tile's input halo, zero outside the image
  const int n_pos = nb * hh * hw;
  if (mode == 1) {  // channels-last, 4 channels a 16-byte load
    const int nq = nc / 4;
    for (int i = tid; i < n_pos * nq; i += THREADS) {
      const int q = i % nq;
      int pos = i / nq;
      const int xx = pos % hw;
      pos /= hw;
      const int yy = pos % hh, bb = pos / hh;
      const int gy = y0 + yy - R, gx = x0 + xx - R;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(reinterpret_cast<const float4*>(
            x + (b0 + bb) * sb + (c0 + 4 * q) * sc + gy * sy + gx * sx));
      float* d = halo + (bb * cc + 4 * q) * plane + yy * hw + xx;
      d[0] = v.x;
      d[plane] = v.y;
      d[2 * plane] = v.z;
      d[3 * plane] = v.w;
    }
  } else {  // any strides: neighbouring threads, columns
    for (int i = tid; i < n_pos * nc; i += THREADS) {
      const int xx = i % hw;
      const int row = i / hw;
      const int yy = row % hh;
      const int ci = (row / hh) % nc;
      const int bb = row / (hh * nc);
      const int gy = y0 + yy - R, gx = x0 + xx - R;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(x + (b0 + bb) * sb + (c0 + ci) * sc + gy * sy + gx * sx);
      halo[(bb * cc + ci) * plane + yy * hw + xx] = v;
    }
  }
  __syncthreads();

  // 2. each pixel's features of this chunk, a warp a pixel; the last
  // chunk runs on to k_pad, writing the zero padding
  const int f0 = c0 * KK;
  const int f1 = c0 + cc >= C ? k_pad : (c0 + cc) * KK;
  const int nvec = (f1 - f0) / VEC;
  const int warp = tid / 32, lane = tid % 32;
  for (int p = warp; p < tb * th * tw; p += WARPS) {
    const int px = p % tw, r = p / tw;
    const int py = r % th, bb = r / th;
    const int gy = y0 + py, gx = x0 + px;
    if (bb >= nb || gy >= H || gx >= W) continue;
    float* orow = out + (((long long)(b0 + bb) * H + gy) * W + gx) * k_pad + f0;
    const float* hp = halo + bb * cc * plane + py * hw + px;
    for (int q = lane; q < nvec; q += 32) {
      float v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int f = f0 + q * VEC + j;
        const int c = f / KK, tap = f - c * KK;
        const int dy = tap / K, dx = tap - dy * K;
        v[j] = c < C ? hp[(c - c0) * plane + dy * hw + dx] : 0.f;
      }
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(orow + 4 * q) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        orow[q] = v[0];
      }
    }
  }
}

template <int K, int VEC>
cudaError_t launch(const float* x, long long sb, long long sc, long long sy,
                   long long sx, float* out, int B, int C, int H, int W,
                   int k_pad, int tb, int th, int tw, int cc, int mode,
                   cudaStream_t stream) {
  const long long tiles = (long long)((B + tb - 1) / tb) *
                          ((H + th - 1) / th) * ((W + tw - 1) / tw);
  const int chunks = (C + cc - 1) / cc;
  if (tiles > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidValue;
  // the plan keeps the halo within what a block takes without opting in
  const size_t smem = sizeof(float) * (size_t)tb * cc * halo_plane(th, tw, K);
  if (smem > SMEM_DEFAULT) return cudaErrorInvalidValue;
  conv_patches_kernel<K, VEC><<<dim3((unsigned)tiles, chunks), THREADS, smem,
                                 stream>>>(
      x, sb, sc, sy, sx, out, B, C, H, W, k_pad, tb, th, tw, cc, mode);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_vec(int vec, const float* x, long long sb, long long sc,
                       long long sy, long long sx, float* out, int B, int C,
                       int H, int W, int k_pad, int tb, int th, int tw,
                       int cc, int mode, cudaStream_t s) {
  return vec == 4
             ? launch<K, 4>(x, sb, sc, sy, sx, out, B, C, H, W, k_pad, tb,
                            th, tw, cc, mode, s)
             : launch<K, 1>(x, sb, sc, sy, sx, out, B, C, H, W, k_pad, tb,
                            th, tw, cc, mode, s);
}

}  // namespace

// x: float32 [B, C, H, W] read through its strides (in elements); out:
// float32 [B*H*W, k_pad], row-major.  k: 1, 3, 5 or 7.  Tile (tb, th, tw)
// and channel chunk cc as _patch_plan gives them (cc a multiple of 4
// where C > cc; the halo within 48 KB).  mode: 0 columns-fastest, 1
// channels-fastest by 16-byte loads (stride of C 1, C and the other
// strides multiples of 4, x 16-byte aligned).  vec: 4 (k_pad a multiple
// of 4, out 16-byte aligned) or 1.
extern "C" int conv_patches_f32(const void* x, long long sb, long long sc,
                                long long sy, long long sx, void* out, int B,
                                int C, int H, int W, int k, int k_pad, int tb,
                                int th, int tw, int cc, int mode, int vec,
                                int device, void* stream) {
  if ((vec != 1 && vec != 4) || mode < 0 || mode > 1 || tb < 1 || th < 1 ||
      tw < 1 || cc < 1 || k_pad < C * k * k || (vec == 4 && k_pad % 4) ||
      (vec == 4 && C > cc && cc % 4) || (mode == 1 && (cc % 4 || C % 4)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  float* of = (float*)out;
  switch (k) {
    case 1:
      return (int)launch_vec<1>(vec, xf, sb, sc, sy, sx, of, B, C, H, W,
                                k_pad, tb, th, tw, cc, mode, s);
    case 3:
      return (int)launch_vec<3>(vec, xf, sb, sc, sy, sx, of, B, C, H, W,
                                k_pad, tb, th, tw, cc, mode, s);
    case 5:
      return (int)launch_vec<5>(vec, xf, sb, sc, sy, sx, of, B, C, H, W,
                                k_pad, tb, th, tw, cc, mode, s);
    case 7:
      return (int)launch_vec<7>(vec, xf, sb, sc, sy, sx, of, B, C, H, W,
                                k_pad, tb, th, tw, cc, mode, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
