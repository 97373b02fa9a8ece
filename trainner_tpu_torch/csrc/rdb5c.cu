// Forward of one ESRGAN residual dense block (5C) for Hopper (sm_90a).
//
// Replaces the TPU kernel trainner_tpu/ops/pallas_kernels.py::rdb5c_canvas
// (body _rdb5c_kernel_body). It computes the same function from the packed
// weights of models/rrdb.py::_rdb_pack_kernels (tap-major rows, (9*cin, N)):
// five 3x3 convs with lrelu over the dense concatenation [x|c1..c4], then
// out = 0.2 * conv5 + x. Sums are f32; c1..c4 and out are rounded to the
// working type (f32 or bf16) once.
//
// Bound: per pixel one block does
//   2*9*(nf(4gc+nf) + gc(3gc+nf) + gc(2gc+nf) + gc(gc+nf) + gc*nf)
// FLOPs = 479,232 at nf 64, gc 32 (about 4.3e12 per ESRGAN forward at b=8,
// 128x128 LR, in its 69 blocks alone), against a few hundred bytes of
// input, residuals and output per pixel: the block is bound by operations
// on this card, in f32 by the CUDA cores' rate and in bf16 by the tensor
// cores'.
//
// No canvas. The TPU kernel works on a flat zero-ring canvas because of
// Mosaic's alignment limits; here each block loads a halo tile of NHWC
// input with zeros for taps outside the image, which is the conv's zero
// padding, so ragged and non-square h, w need nothing else.
//
// Two paths, chosen by the working type alone:
//
// bf16 (rdb_stage_mma, tile in conv3x3_mma.cuh): five launches, one per
//   conv, each a gather: stage k reads the chunks of [x|c1..ck] where they
//   lie (K = 9*(nf + k*gc)) against the rows of the packed weights that
//   belong to conv k, and writes only c_{k+1} (or out). The products run on
//   the tensor cores (mma.sync m16n8k16, f32 sums in registers); there is
//   no f32 scratch in device memory: a block moves 512 bytes per pixel plus
//   the halos, under the operations bound. The scatter form below would
//   move another 3.6 KB per pixel of f32 partial sums (0.14 ms at b=8,
//   128x128, twice the operations bound). See conv3x3_mma.cuh for what the
//   tile does about shared-memory traffic, weight loads, overlap and grids.
//   The f32 order of the sums differs from the scatter form's; the two-ulp
//   tolerance of the comparison with the plain version covers it.
//
// f32 (rdb_stage, tile in conv3x3_tile.cuh): five "scatter-to-future"
//   stages as in the TPU kernel,
//     stage 0: P  = conv(x;  wx)   N = 4gc+nf   c1 = lrelu(P[:gc] + b1)
//     stage s: Q  = conv(c_s; w_s) N = (4-s)gc+nf
//              c_{s+1} = lrelu(S[s*gc:(s+1)*gc] + Q[:gc] + b_{s+1})  (s = 1..3)
//     stage 4: out = 0.2 * (S[4gc:] + Q + b5) + x
//   with S an f32 scratch of width 4gc+nf per pixel that holds every future
//   partial sum. Products are exact f32 FMAs on the CUDA cores, register
//   tiles of 4 pixels x 8 columns per thread. 3xTF32 on the tensor cores and
//   one fused launch for all five stages are work for later versions.

#include "conv3x3_mma.cuh"
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: one conv of the block per launch.
// ---------------------------------------------------------------------------
struct FwdEpilogue {
  const float* bias;        // this conv's bias
  rdbm::bf16* feat;         // c_{k+1} (pitch = its width) or out
  int feat_pitch;
  const rdbm::bf16* resid;  // x for the last conv, else null
  int h, w;

  __device__ __forceinline__ void operator()(float (&acc)[2][4][4], int bi,
                                             int y0, int x0) const {
    const rdbm::FragCoords f = rdbm::frag_coords();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int yy = y0 + f.row0 + mt;
      if (yy >= h) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int xx = x0 + f.col0 + 8 * half;
        if (xx >= w) continue;
        const long long pix = ((long long)bi * h + yy) * w + xx;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = f.n + nt * 8;
          float v0 = acc[mt][nt][2 * half] + __ldg(bias + n);
          float v1 = acc[mt][nt][2 * half + 1] + __ldg(bias + n + 1);
          if (resid != nullptr) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                resid + pix * feat_pitch + n);
            v0 = v0 * 0.2f + __low2float(xv);
            v1 = v1 * 0.2f + __high2float(xv);
          } else {
            v0 = v0 >= 0.f ? v0 : v0 * 0.2f;
            v1 = v1 >= 0.f ? v1 : v1 * 0.2f;
          }
          *reinterpret_cast<__nv_bfloat162*>(feat + pix * feat_pitch + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
};

// two blocks fit an SM where the stage is narrow: at most 128 registers
__global__ void __launch_bounds__(rdbm::THREADS, 2)
rdb_stage_mma(const __grid_constant__ rdbm::ConvArgs args,
              const FwdEpilogue epi) {
  rdbm::conv3x3_mma<false>(args, epi);
}

int launch_all_mma(const void* x_, const void* const* wts,
                   const float* const* bs, void* const* cs, void* out,
                   int b, int h, int w, int nf, int gc, cudaStream_t stream) {
  using rdbm::bf16;
  if ((nf + 4 * gc) / rdbm::KC > rdbm::MAXCH) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  static int per_sm[rdbm::MAXCH + 1] = {0};
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rdb_stage_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)rdbm::conv_smem_bytes(rdbm::MAXCH));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const bf16* x = static_cast<const bf16*>(x_);
  rdbm::ConvArgs args;
  args.h = h;
  args.w = w;
  args.tiles_x = (w + rdbm::TW - 1) / rdbm::TW;
  args.tiles_y = (h + rdbm::TH - 1) / rdbm::TH;
  args.ntiles = b * args.tiles_y * args.tiles_x;
  for (int k = 0; k < 5; ++k) {
    const int cout = k < 4 ? gc : nf;
    args.nchunks = (nf + k * gc) / rdbm::KC;
    for (int j = 0; j < args.nchunks; ++j) {
      // chunk j of [x|c1..ck] lies in feature s at channel cl
      const int c0 = j * rdbm::KC;
      const int s = c0 < nf ? 0 : 1 + (c0 - nf) / gc;
      const int cl = c0 < nf ? c0 : (c0 - nf) % gc;
      const int ncols = 4 * gc + nf - s * gc;  // width of packed weight s
      rdbm::ChunkSrc& c = args.ch[j];
      c.a = (s == 0 ? x : static_cast<const bf16*>(cs[s - 1])) + cl;
      c.a_pitch = s == 0 ? nf : gc;
      // conv k's columns of packed weight s start at (k - s) * gc
      c.w = static_cast<const bf16*>(wts[s]) + (long long)cl * ncols +
            (k - s) * gc;
      c.w_pitch = ncols;
      c.w_tap = s == 0 ? nf : gc;
    }
    FwdEpilogue epi;
    epi.bias = bs[k];
    epi.feat = static_cast<bf16*>(k < 4 ? cs[k] : out);
    epi.feat_pitch = cout;
    epi.resid = k == 4 ? x : nullptr;
    epi.h = h;
    epi.w = w;
    const int nslices = cout / rdbm::BN;
    const dim3 grid((unsigned)rdbm::conv_grid_x(rdb_stage_mma, per_sm,
                                                args.nchunks, args.ntiles,
                                                nslices),
                    (unsigned)nslices);
    rdb_stage_mma<<<grid, rdbm::THREADS,
                    rdbm::conv_smem_bytes(args.nchunks), stream>>>(args, epi);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, out: (b, h, w, nf) NHWC; c1..c4:
// (b, h, w, gc); acc: (b*h*w, 4gc+nf) f32 scratch of the f32 path (bf16
// does not read it; it may be null); w0..w4: packed (9*cin, N) in the
// working type; b0..b4: f32. nf and gc are multiples of 32; bf16 needs
// nf + 4gc <= 256. Returns the first CUDA error, else 0.
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
    return launch_all_mma(x, wts, bs, cs, out, b, h, w, nf, gc, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one bf16 stage over cin input channels.
int rdb5c_stage_smem_bytes(int cin) {
  return (int)rdbm::conv_smem_bytes(cin / rdbm::KC);
}

const char* rdb5c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
