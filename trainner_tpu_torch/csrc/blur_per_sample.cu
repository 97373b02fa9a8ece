// Per-sample blur for Hopper (sm_90a): every sample of a batch is
// cross-correlated with its own k x k kernel, with reflect padding.
//
// Replaces the TPU kernel
// trainner_tpu/ops/pallas_kernels.py::blur_per_sample_pallas (body
// _blur_kernel_body). It computes the same function,
//
//   out[n, y, x, ch] = sum_{dy, dx} K[n, dy, dx]
//                      * X[n, refl(y + dy - k/2), refl(x + dx - k/2), ch]
//
// with refl the reflection without the edge pixel (-i -> i,
// h-1+i -> h-1-i, as jnp.pad(mode="reflect")), sums in f32 in tap order
// (dy outer, dx inner, one FMA per tap) and one rounding to x's type.
//
// Nothing of the TPU kernel's shape is carried over. That kernel pads a
// copy of the batch in device memory, folds the channels into the lane
// dimension, aligns the canvas to (8, 128) tiles and shifts the whole
// sample with two rolls per tap. Here one thread block owns one sample's
// tile of 8 x 32 output pixels: it copies the sample's k*k taps and the
// (8+k-1) x (32+k-1) x c input halo into shared memory as f32, computing
// the reflected source index at load, so no padded copy exists; then each
// thread sums its pixel's channels over the k*k taps. A warp is one row of
// 32 pixels, so its shared-memory reads are c floats apart: free of bank
// conflicts for c = 1 and c = 3; the tap is a broadcast read.
//
// Bound: 2*k*k FLOPs per output value against 2 values moved (one read,
// one written): at k = 21 that is 882 f32 FLOPs per 8 bytes, so the
// kernel is bound by operations (67 TFLOP/s f32 on the CUDA cores; a
// per-sample kernel gives the tensor cores no shared operand). This first
// version issues one shared-memory read per FMA and one broadcast read per
// tap and so sits at the shared-memory pipe's rate, not the FMA rate.
// Several output rows per thread (each loaded value feeds one tap of each
// row) and taps held in registers are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;
constexpr int TW = 32;
constexpr int THREADS = TH * TW;
constexpr size_t MAX_SMEM = 232448;  // what one block may use on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

// Source index of padded position i in [0, n): one reflection is enough
// while k/2 < n; positions that only pixels outside the image would read
// are clamped into range.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

// CH channels per pass of the tap loop; c is a multiple of CH.
template <typename T, int CH>
__global__ void __launch_bounds__(THREADS)
blur_kernel(const T* __restrict__ x, const float* __restrict__ kernels,
            T* __restrict__ out, int h, int w, int c, int k, int tiles_x,
            int tiles_y) {
  extern __shared__ float smem[];
  const int pad = k / 2;
  const int halo_h = TH + k - 1;
  const int row_len = (TW + k - 1) * c;
  float* taps = smem;          // k*k
  float* tile = smem + k * k;  // halo_h x (TW+k-1) x c

  int blk = blockIdx.x;
  const int tile_x = blk % tiles_x;
  blk /= tiles_x;
  const int tile_y = blk % tiles_y;
  const int n = blk / tiles_y;
  const int y0 = tile_y * TH;
  const int x0 = tile_x * TW;

  const float* kn = kernels + (size_t)n * k * k;
  for (int i = threadIdx.x; i < k * k; i += THREADS) taps[i] = kn[i];
  const T* xn = x + (size_t)n * h * w * c;
  for (int i = threadIdx.x; i < halo_h * row_len; i += THREADS) {
    const int r = i / row_len;
    const int rem = i - r * row_len;
    const int col = rem / c;
    const int ch = rem - col * c;
    const int gy = reflect(y0 - pad + r, h);
    const int gx = reflect(x0 - pad + col, w);
    tile[i] = to_f32(xn[((size_t)gy * w + gx) * c + ch]);
  }
  __syncthreads();

  const int ly = threadIdx.x / TW;
  const int lx = threadIdx.x % TW;
  const int oy = y0 + ly;
  const int ox = x0 + lx;
  if (oy >= h || ox >= w) return;
  T* o = out + (((size_t)n * h + oy) * w + ox) * c;
  for (int ch0 = 0; ch0 < c; ch0 += CH) {
    float acc[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) acc[j] = 0.f;
    const float* base = tile + ly * row_len + lx * c + ch0;
    for (int dy = 0; dy < k; ++dy) {
      const float* row = base + dy * row_len;
      const float* tp = taps + dy * k;
      for (int dx = 0; dx < k; ++dx) {
        const float t = tp[dx];
#pragma unroll
        for (int j = 0; j < CH; ++j)
          acc[j] = fmaf(row[dx * c + j], t, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) store(o + ch0 + j, acc[j]);
  }
}

template <typename T, int CH>
int launch(const void* x, const float* kernels, void* out, int b, int h,
           int w, int c, int k, cudaStream_t stream) {
  static size_t configured = 48 * 1024;  // the default limit
  const size_t smem =
      ((size_t)k * k + (size_t)(TH + k - 1) * (TW + k - 1) * c) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        blur_kernel<T, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  const long long blocks = (long long)b * tiles_y * tiles_x;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  blur_kernel<T, CH><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), kernels, static_cast<T*>(out), h, w, c, k,
      tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* kernels, void* out, int b, int h,
             int w, int c, int k, cudaStream_t stream) {
  if (c % 3 == 0)
    return launch<T, 3>(x, kernels, out, b, h, w, c, k, stream);
  return launch<T, 1>(x, kernels, out, b, h, w, c, k, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of x and out). x, out: (b, h, w, c)
// NHWC contiguous; kernels: (b, k, k) f32 contiguous, k odd, k/2 < min(h, w).
// Returns 0, or the CUDA error of the launch (cudaErrorInvalidValue when
// the halo tile does not fit one block's shared memory).
int blur_per_sample(int dtype, const void* x, const float* kernels, void* out,
                    int b, int h, int w, int c, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || k % 2 == 0 ||
      k / 2 >= h || k / 2 >= w)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(x, kernels, out, b, h, w, c, k, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, kernels, out, b, h, w, c, k, st);
  return (int)cudaErrorInvalidValue;
}

// Bytes of shared memory one block needs at (c, k).
long long blur_per_sample_smem_bytes(int c, int k) {
  return (long long)(((size_t)k * k +
                      (size_t)(TH + k - 1) * (TW + k - 1) * c) *
                     sizeof(float));
}

const char* blur_per_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
