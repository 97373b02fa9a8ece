// Forward of one ESRGAN residual dense block (5C) for Hopper (sm_90a).
//
// Replaces the TPU kernel trainner_tpu/ops/pallas_kernels.py::rdb5c_canvas
// (body _rdb5c_kernel_body). It computes the same function: five 3x3
// "scatter-to-future" implicit-GEMM stages against the packed weights of
// models/rrdb.py::_rdb_pack_kernels (tap-major rows, (9*cin, N)):
//
//   stage 0: P  = conv(x;  wx)   N = 4gc+nf   c1 = lrelu(P[:gc] + b1)
//   stage s: Q  = conv(c_s; w_s) N = (4-s)gc+nf
//            c_{s+1} = lrelu(S[s*gc:(s+1)*gc] + Q[:gc] + b_{s+1})   (s = 1..3)
//   stage 4: out = 0.2 * (S[4gc:] + Q + b5) + x
//
// S is an f32 scratch of width 4gc+nf per pixel that holds every future
// partial sum: each stage adds its product's columns past the first gc
// into it. Sums are kept in f32 in the same order as the TPU kernel; c1..c4
// and out are rounded to the working type (f32 or bf16) once.
//
// No canvas. The TPU kernel works on a flat zero-ring canvas because of
// Mosaic's alignment limits; here each block loads an 18x18 halo tile of
// NHWC input and writes zeros for taps outside the image, which is the
// conv's zero padding, so ragged and non-square h, w need nothing else.
//
// Bound: per pixel one block does
//   2*9*(nf(4gc+nf) + gc(3gc+nf) + gc(2gc+nf) + gc(gc+nf) + gc*nf)
// FLOPs = 479,232 at nf 64, gc 32 (about 4.3e12 per ESRGAN forward at b=8,
// 128x128 LR, in its 69 blocks alone), against a few hundred bytes of
// input, residuals and output per pixel: the block is compute-bound on
// this card.
// This first version does the products as f32 FMAs on the CUDA cores (the
// f32 path must stay exact f32, as the TPU kernel's f32 path is), with
// register tiles of 4 pixels x 8 columns per thread and the halo tile and
// all nine taps' weights staged in shared memory, so each input element is
// read from device memory once per 32-column slice of N rather than nine
// times. Tensor-core products (wgmma for bf16, 3xTF32 for f32), TMA loads
// and one fused launch for all five stages are work for later versions.

#include "conv3x3_tile.cuh"

namespace {

using namespace rdbk;

constexpr size_t SMEM_BYTES = CONV_SMEM_BYTES;

// One 3x3 implicit-GEMM stage. Block = 16x16 output pixels of one image x
// 32 product columns. Thread = 4 consecutive pixels of one row x 8 columns.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rdb_stage(const T* __restrict__ in, int cin,
          const T* __restrict__ wp, int ncols,
          const float* __restrict__ bias,
          float* __restrict__ acc, int accw, int acc_off,
          T* __restrict__ feat,
          const T* __restrict__ resid,
          int gc, int first, int last,
          int h, int w, int tiles_x, int tiles_y) {
  extern __shared__ float smem[];
  float r[4][8];
  conv3x3_tile<T>(smem, in, cin, 0, cin, wp, ncols, h, w, tiles_x, tiles_y, r);

  const TileCoords tc = tile_coords(tiles_x, tiles_y);
  const int yy = tc.yy;
  if (yy >= h) return;
  const int n = tc.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xx = tc.xx0 + i;
    if (xx >= w) break;
    const long long pix = ((long long)tc.bi * h + yy) * w + xx;
    float* s = acc + pix * accw + acc_off + n;
#pragma unroll
    for (int g = 0; g < 8; g += 4) {
      float sv[4] = {0.f, 0.f, 0.f, 0.f};
      float o[4];
      if (last) {
        float xv[4];
        load4(s + g, sv);
        load4(resid + pix * ncols + n + g, xv);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = (sv[e] + r[i][g + e] + bias[n + g + e]) * 0.2f + xv[e];
        store4(feat + pix * ncols + n + g, o);
      } else if (n < gc) {
        if (!first) load4(s + g, sv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = sv[e] + r[i][g + e] + bias[n + g + e];
          o[e] = v >= 0.f ? v : v * 0.2f;
        }
        store4(feat + pix * gc + n + g, o);
      } else {
        if (!first) load4(s + g, sv);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = sv[e] + r[i][g + e];
        store4(s + g, o);
      }
    }
  }
}

template <typename T>
int launch_all(const void* x, const void* const* wts, const float* const* bs,
               float* acc, void* const* cs, void* out,
               int b, int h, int w, int nf, int gc, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rdb_stage<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  const int accw = 4 * gc + nf;
  for (int s = 0; s < 5; ++s) {
    const T* in = static_cast<const T*>(s == 0 ? x : cs[s - 1]);
    const int cin = s == 0 ? nf : gc;
    const int ncols = accw - s * gc;
    T* feat = static_cast<T*>(s < 4 ? cs[s] : out);
    const dim3 grid((unsigned)(b * tiles_y * tiles_x), (unsigned)(ncols / BN));
    rdb_stage<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
        in, cin, static_cast<const T*>(wts[s]), ncols, bs[s], acc, accw,
        s * gc, feat, s == 4 ? static_cast<const T*>(x) : nullptr, gc,
        s == 0, s == 4, h, w, tiles_x, tiles_y);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, out: (b, h, w, nf) NHWC; c1..c4:
// (b, h, w, gc); acc: (b*h*w, 4gc+nf) f32 scratch; w0..w4: packed
// (9*cin, N) in the working type; b0..b4: f32. nf and gc are multiples of
// 32. Returns cudaGetLastError() of the first launch that failed, else 0.
int rdb5c_forward(int dtype, const void* x,
                  const void* w0, const void* w1, const void* w2,
                  const void* w3, const void* w4,
                  const float* b0, const float* b1, const float* b2,
                  const float* b3, const float* b4,
                  float* acc, void* c1, void* c2, void* c3, void* c4,
                  void* out, int b, int h, int w, int nf, int gc,
                  void* stream) {
  const void* wts[5] = {w0, w1, w2, w3, w4};
  const float* bs[5] = {b0, b1, b2, b3, b4};
  void* cs[4] = {c1, c2, c3, c4};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(x, wts, bs, acc, cs, out, b, h, w, nf, gc, st);
  if (dtype == 1)
    return launch_all<__nv_bfloat16>(x, wts, bs, acc, cs, out, b, h, w, nf,
                                     gc, st);
  return (int)cudaErrorInvalidValue;
}

const char* rdb5c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
