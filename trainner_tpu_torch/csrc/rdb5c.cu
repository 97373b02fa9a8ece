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
// on this card, by the tensor cores' rate: bf16 at 989 TFLOP/s, f32 as
// 3xTF32, three tf32 products (495 TFLOP/s) per f32 product.
//
// No canvas. The TPU kernel works on a flat zero-ring canvas because of
// Mosaic's alignment limits; here each block loads a halo tile of NHWC
// input with zeros for taps outside the image, which is the conv's zero
// padding, so ragged and non-square h, w need nothing else.
//
// On a tensor axis (trainner_tpu_torch/parallel/tensor.py) a conv split by
// output column runs alone: rdb5c_forward_stage launches stage k over the
// columns [c0, c0 + n) of its output, by pointer offsets into the same
// packed weights, bias, output and residual, and writes only those
// columns. A range narrower than the 32-column slice of a block (conv5's
// 64 columns over 4 ranks) is computed in a 32-column window inside the
// conv's columns that holds it, and the epilogue masks the columns
// outside the range (the *_cols_* kernels; the others keep the epilogue
// without a mask, whose f32 kernel has no register to spare): no
// padding, no copy of the weights. The bound of such a stage is n / N of
// its stage's operations.
//
// Five launches, one per conv, each a gather on the tile of conv3x3_mma.cuh
// (rdb_stage_mma in bf16, rdb_streamed_stage_mma for a bf16 stage over more
// than 256 channels, rdb_stage_tf32 in f32): stage k reads the chunks of [x|c1..ck] where they lie
// (K = 9*(nf + k*gc)) against the rows of the packed weights that belong to
// conv k, and writes only c_{k+1} (or out). There is no f32 scratch in
// device memory: a block moves 512 (bf16) or 1,024 (f32) bytes per pixel
// plus the halos, under the operations bound; the TPU kernel's
// "scatter-to-future" form would move another 3.6 KB per pixel of f32
// partial sums. See conv3x3_mma.cuh for the products (mma.sync in bf16,
// 3xTF32 in f32), shared-memory traffic, weights, overlap and grids. The
// f32 order of the sums differs from the plain version's; its tolerance
// covers that and 3xTF32's error (about 2^-21 of each product).

#include "conv3x3_mma.cuh"

namespace {

using rdbm::bf16;

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, bool MASK>
struct FwdEpilogue {
  const float* bias;  // this conv's bias
  T* feat;            // c_{k+1} (pitch = its width) or out
  int feat_pitch;
  const T* resid;     // x for the last conv, else null
  int h, w;
  int keep_lo, keep_hi;  // MASK: the columns written, keep_lo <= n < keep_hi

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
            const float2 xv = rdbm::load2(resid + pix * feat_pitch + n);
            v0 = v0 * 0.2f + xv.x;
            v1 = v1 * 0.2f + xv.y;
          } else {
            v0 = v0 >= 0.f ? v0 : v0 * 0.2f;
            v1 = v1 >= 0.f ? v1 : v1 * 0.2f;
          }
          T* dst = feat + pix * feat_pitch + n;
          if constexpr (MASK) {
            const bool k0 = n >= keep_lo && n < keep_hi;
            const bool k1 = n + 1 >= keep_lo && n + 1 < keep_hi;
            if (k0 && k1) {
              rdbm::store2(dst, v0, v1);
            } else {
              if (k0) store1(dst, v0);
              if (k1) store1(dst + 1, v1);
            }
          } else {
            rdbm::store2(dst, v0, v1);
          }
        }
      }
    }
  }
};

// two blocks fit an SM where the stage is narrow: at most 128 registers
__global__ void __launch_bounds__(rdbm::THREADS, 2)
rdb_stage_mma(const __grid_constant__ rdbm::ConvArgs<bf16> args,
              const FwdEpilogue<bf16, false> epi) {
  rdbm::conv3x3_mma<false, false>(args, epi);
}

// a bf16 stage over more than MAXCH chunks: one block per SM, the ring of
// three (halo tile, slab) pairs
__global__ void __launch_bounds__(rdbm::THREADS, 1)
rdb_streamed_stage_mma(const __grid_constant__ rdbm::ConvArgs<bf16> args,
                       const FwdEpilogue<bf16, false> epi) {
  rdbm::conv3x3_mma<false, true>(args, epi);
}

// one block per SM: the ring of two f32 (halo tile, slab) pairs
__global__ void __launch_bounds__(rdbm::THREADS, 1)
rdb_stage_tf32(const __grid_constant__ rdbm::ConvArgs<float> args,
               const FwdEpilogue<float, false> epi) {
  rdbm::conv3x3_mma<false, false>(args, epi);
}

// the same three over a column range that is not whole 32-column slices
__global__ void __launch_bounds__(rdbm::THREADS, 2)
rdb_stage_cols_mma(const __grid_constant__ rdbm::ConvArgs<bf16> args,
                   const FwdEpilogue<bf16, true> epi) {
  rdbm::conv3x3_mma<false, false>(args, epi);
}

__global__ void __launch_bounds__(rdbm::THREADS, 1)
rdb_streamed_stage_cols_mma(const __grid_constant__ rdbm::ConvArgs<bf16> args,
                            const FwdEpilogue<bf16, true> epi) {
  rdbm::conv3x3_mma<false, true>(args, epi);
}

__global__ void __launch_bounds__(rdbm::THREADS, 1)
rdb_stage_cols_tf32(const __grid_constant__ rdbm::ConvArgs<float> args,
                    const FwdEpilogue<float, true> epi) {
  rdbm::conv3x3_mma<false, false>(args, epi);
}

template <typename T>
int configure() {
  constexpr bool F32 = std::is_same<T, float>::value;
  static bool configured[rdbm::MAX_DEVICES] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= rdbm::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    const size_t narrow = rdbm::conv_smem_bytes<T>(rdbm::MAXCH);
    const size_t wide = rdbm::conv_smem_bytes<T>(rdbm::MAXCH + 1);
    const void* kernels[4];
    size_t bytes[4];
    int n = 0;
    if (F32) {
      kernels[n] = (const void*)rdb_stage_tf32, bytes[n++] = narrow;
      kernels[n] = (const void*)rdb_stage_cols_tf32, bytes[n++] = narrow;
    } else {
      kernels[n] = (const void*)rdb_stage_mma, bytes[n++] = narrow;
      kernels[n] = (const void*)rdb_stage_cols_mma, bytes[n++] = narrow;
      kernels[n] = (const void*)rdb_streamed_stage_mma, bytes[n++] = wide;
      kernels[n] = (const void*)rdb_streamed_stage_cols_mma,
      bytes[n++] = wide;
    }
    for (int i = 0; i < n; ++i) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes[i]);
      if (e != cudaSuccess) return (int)e;
    }
    configured[dev] = true;
  }
  return 0;
}

// One launch of stage args over nslices 32-column slices, with the
// epilogue masked (the *_cols_* kernels) or not.
template <typename T, bool MASK>
int launch_tile(const rdbm::ConvArgs<T>& args, const FwdEpilogue<T, MASK>& epi,
                int nslices, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  static int per_sm[rdbm::MAXCH + 1] = {0};
  static int per_sm_streamed[1] = {0};
  const int key = F32 ? 0 : args.nchunks;
  const size_t smem = rdbm::conv_smem_bytes<T>(args.nchunks);
  const auto grid = [&](auto kernel, auto& cache, int k) {
    return dim3((unsigned)rdbm::conv_grid_x(kernel, cache, k, smem,
                                            args.ntiles, nslices),
                (unsigned)nslices);
  };
  if constexpr (F32 && MASK) {
    rdb_stage_cols_tf32<<<grid(rdb_stage_cols_tf32, per_sm, key),
                          rdbm::THREADS, smem, stream>>>(args, epi);
  } else if constexpr (F32) {
    rdb_stage_tf32<<<grid(rdb_stage_tf32, per_sm, key), rdbm::THREADS,
                     smem, stream>>>(args, epi);
  } else if (rdbm::bf16_streams(args.nchunks)) {
    if constexpr (MASK)
      rdb_streamed_stage_cols_mma<<<grid(rdb_streamed_stage_cols_mma,
                                         per_sm_streamed, 0),
                                    rdbm::THREADS, smem, stream>>>(args,
                                                                   epi);
    else
      rdb_streamed_stage_mma<<<grid(rdb_streamed_stage_mma,
                                    per_sm_streamed, 0),
                               rdbm::THREADS, smem, stream>>>(args, epi);
  } else if constexpr (MASK) {
    rdb_stage_cols_mma<<<grid(rdb_stage_cols_mma, per_sm, key),
                         rdbm::THREADS, smem, stream>>>(args, epi);
  } else {
    rdb_stage_mma<<<grid(rdb_stage_mma, per_sm, key), rdbm::THREADS, smem,
                    stream>>>(args, epi);
  }
  return (int)cudaGetLastError();
}

// Stage k (0-based) over the columns [c0, c0 + n) of its output: c0 = 0,
// n = its width is the whole stage.
template <typename T>
int launch_stage(int k, const void* x_, const void* const* wts,
                 const float* bias, void* const* cs, void* dst, int b, int h,
                 int w, int nf, int gc, int c0, int n, cudaStream_t stream) {
  const int cout = k < 4 ? gc : nf;
  if (c0 < 0 || n < 1 || c0 + n > cout) return (int)cudaErrorInvalidValue;
  // the 32-column slices that hold the range, from a base inside the conv
  int base = c0 & ~7;
  int nslices = (c0 + n - base + rdbm::BN - 1) / rdbm::BN;
  if (base + nslices * rdbm::BN > cout) base = cout - nslices * rdbm::BN;
  if (base < 0 || base > c0) return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  rdbm::ConvArgs<T> args;
  args.h = h;
  args.w = w;
  args.tiles_x = (w + rdbm::TW - 1) / rdbm::TW;
  args.tiles_y = (h + rdbm::TH - 1) / rdbm::TH;
  args.ntiles = b * args.tiles_y * args.tiles_x;
  // segment s: feature s of [x|c1..ck] against packed weight s, whose
  // columns for conv k start at (k - s) * gc
  args.nseg = k + 1;
  args.nchunks = 0;
  for (int s = 0; s <= k; ++s) {
    const int cin = s == 0 ? nf : gc;
    const int ncols = 4 * gc + nf - s * gc;  // width of packed weight s
    rdbm::Segment<T>& sg = args.seg[s];
    sg.a = s == 0 ? x : static_cast<const T*>(cs[s - 1]);
    sg.a_pitch = cin;
    sg.w = static_cast<const T*>(wts[s]) + (k - s) * gc + base;
    sg.w_pitch = ncols;
    sg.w_tap = cin;
    sg.w_step = rdbm::KC * ncols;
    sg.nchunks = cin / rdbm::KC;
    args.nchunks += sg.nchunks;
  }
  const auto fill = [&](auto& epi) {
    epi.bias = bias + base;
    epi.feat = static_cast<T*>(dst) + base;
    epi.feat_pitch = cout;
    epi.resid = k == 4 ? x + base : nullptr;
    epi.h = h;
    epi.w = w;
    epi.keep_lo = c0 - base;
    epi.keep_hi = c0 + n - base;
  };
  if (c0 == base && n == nslices * rdbm::BN) {  // whole slices
    FwdEpilogue<T, false> epi;
    fill(epi);
    return launch_tile<T, false>(args, epi, nslices, stream);
  }
  FwdEpilogue<T, true> epi;
  fill(epi);
  return launch_tile<T, true>(args, epi, nslices, stream);
}

template <typename T>
int launch_all(const void* x_, const void* const* wts,
               const float* const* bs, void* const* cs, void* out,
               int b, int h, int w, int nf, int gc, cudaStream_t stream) {
  int e = configure<T>();
  if (e) return e;
  for (int k = 0; k < 5; ++k) {
    const int cout = k < 4 ? gc : nf;
    e = launch_stage<T>(k, x_, wts, bs[k], cs, k < 4 ? cs[k] : out, b, h, w,
                        nf, gc, 0, cout, stream);
    if (e) return e;
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, out: (b, h, w, nf) NHWC; c1..c4:
// (b, h, w, gc); w0..w4: packed (9*cin, N) in the working type; b0..b4:
// f32. nf and gc are multiples of 32. Returns the first CUDA error, else 0.
int rdb5c_forward(int dtype, const void* x,
                  const void* w0, const void* w1, const void* w2,
                  const void* w3, const void* w4,
                  const float* b0, const float* b1, const float* b2,
                  const float* b3, const float* b4,
                  void* c1, void* c2, void* c3, void* c4,
                  void* out, int b, int h, int w, int nf, int gc,
                  void* stream) {
  const void* wts[5] = {w0, w1, w2, w3, w4};
  const float* bs[5] = {b0, b1, b2, b3, b4};
  void* cs[4] = {c1, c2, c3, c4};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_all<float>(x, wts, bs, cs, out, b, h, w, nf, gc, st);
  if (dtype == 1)
    return launch_all<bf16>(x, wts, bs, cs, out, b, h, w, nf, gc, st);
  return (int)cudaErrorInvalidValue;
}

// Stage k (0-based) alone over the columns [c0, c0 + n) of its output,
// written into dst (b, h, w, width of conv k) and nothing else: x and
// c1..ck as rdb5c_forward (c_{k+1}.. may be null), b_k its f32 bias.
int rdb5c_forward_stage(int dtype, int k, const void* x,
                        const void* w0, const void* w1, const void* w2,
                        const void* w3, const void* w4, const float* bias,
                        const void* c1, const void* c2, const void* c3,
                        const void* c4, void* dst, int b, int h, int w,
                        int nf, int gc, int c0, int n, void* stream) {
  const void* wts[5] = {w0, w1, w2, w3, w4};
  void* cs[4] = {const_cast<void*>(c1), const_cast<void*>(c2),
                 const_cast<void*>(c3), const_cast<void*>(c4)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 0 || k > 4) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    const int e = configure<float>();
    return e ? e : launch_stage<float>(k, x, wts, bias, cs, dst, b, h, w, nf,
                                       gc, c0, n, st);
  }
  if (dtype == 1) {
    const int e = configure<bf16>();
    return e ? e : launch_stage<bf16>(k, x, wts, bias, cs, dst, b, h, w, nf,
                                      gc, c0, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one stage over cin input channels.
int rdb5c_stage_smem_bytes(int dtype, int cin) {
  return (int)(dtype == 0 ? rdbm::conv_smem_bytes<float>(cin / rdbm::KC)
                          : rdbm::conv_smem_bytes<bf16>(cin / rdbm::KC));
}

const char* rdb5c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
