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
// tile of TH = 32 rows by R * NWX columns and copies the sample's taps and
// the tile's input halo into shared memory as f32, computing the reflected
// source index once per halo pixel at load, so no padded copy exists and
// the inner loop does no index arithmetic.
//
// Bound: 2*k*k FLOPs per output value against 2 values moved (one read,
// one written): at k = 21 that is 882 f32 FLOPs per 8 bytes, so the
// kernel is bound by operations, 67 TFLOP/s f32 on the CUDA cores. The
// first version gave each thread one output pixel: c + 1 shared-memory
// reads per c FMAs, so it ran at the shared-memory pipe's rate (one
// warp-wide 32-bit read per clock against four warp-wide FMAs), 16 % of
// the bound. This one keeps the FMA pipe busy instead:
//  * Register blocking. A thread computes R consecutive outputs of one row
//    and one channel. For each dy it reads the row's k taps (broadcast
//    16-byte reads, kp = k rounded up to 4 floats a row) and R + k - 1
//    inputs into registers, and does R * k FMAs: at R = 8, k = 21 that is
//    34 reads for 168 FMAs, against 4 reads for 3 FMAs before. With k a
//    template parameter the window is indexed at compile time.
//  * Layout. The halo is planar per channel, rows at an odd pitch, and the
//    32 lanes of a warp walk 32 rows: a warp-wide read touches 32 banks.
//    The warps of a block split the channels (up to CW_MAX, each warp then
//    looping over every CW-th channel) and the tile's column groups.
//  * Stores. The sums go to a staging tile in shared memory, NHWC-ordered
//    at an odd row pitch, and leave in coalesced runs of whole tile rows.
//  * Halo. Threads copy the halo pixel by pixel, HALO_UNROLL pixels in
//    flight, converting to f32. Loading it, the taps and storing the tile
//    are about 30 % of the time at the producer's HR canvas on an H100,
//    not overlapped with the FMAs since the whole grid is resident at once
//    (scripts/blur_variants.py: "one-dy", "no-halo-one-dy"; by 4-byte
//    cp.async or value by value it was slower).
//  * Grid. Each block loads its halo and computes one tile. Large batches
//    take the wide tile (R = 8, four column groups: 32 x 32 px, 12 warps at
//    c = 3; R = 16 with two groups was 4 % slower), held to the registers
//    that let an SM keep WIDE_MIN_BLOCKS of them; where the wide tile gives
//    fewer than two blocks per SM, the narrow one (R = 4, one group: 32 x 4
//    px), so a small canvas still spreads over the card (the LR canvas: 256
//    blocks; R = 2 would give 512, at twice the shared reads per FMA).
//  * Tensor cores. Per sample, a Toeplitz band of the taps is a B operand
//    that every row of a tile shares. But an f32 result within 1e-5 needs
//    3xTF32, and the band wastes (TW + k - 1) / k of its products, which
//    puts its ceiling within 2x of this FMA form and puts the bit-exact
//    identity kernel at risk; it is left out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 32;          // output rows per tile: one per lane
constexpr int CW_MAX = 3;       // warps across the channels of a block
constexpr int WIDE_R = 8;       // wide tile: outputs per thread,
constexpr int WIDE_NWX = 4;     //   column groups
constexpr int NARROW_R = 4;     // narrow tile
constexpr int NARROW_NWX = 1;
constexpr int WIDE_MIN_BLOCKS = 2;  // resident wide blocks an SM must hold
constexpr int HALO_UNROLL = 4;  // halo pixels a thread has in flight
constexpr int MAX_K = 21;       // the largest k with a window of its own
constexpr size_t MAX_SMEM = 232448;  // what one block may use on sm_90
constexpr int MAX_DEVICES = 64;      // cards one process may launch on

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

// Shared memory of one block, in floats: the taps (k rows of kp), the halo
// (c planes of hh rows at an odd pitch), the staging tile (TH rows of
// tw * c + 1).
struct Geometry {
  int tw, hh, hwid, pitch, plane, kp, taps, halo, stage_pitch, words;
  __host__ __device__ Geometry(int r, int nwx, int c, int k) {
    tw = r * nwx;
    hh = TH + k - 1;
    hwid = tw + k - 1;
    pitch = hwid | 1;
    plane = hh * pitch;
    kp = (k + 3) & ~3;
    taps = k * kp;
    halo = c * plane;
    stage_pitch = tw * c + 1;
    words = taps + halo + TH * stage_pitch;
  }
};

// K > 0: a window of R + K - 1 registers; K == 0: any k, the window slides
// through R registers. The wide tile asks for registers that let an SM hold
// WIDE_MIN_BLOCKS blocks, so that the producer's HR canvas (512 blocks) is
// resident at once, with no second wave.
template <typename T, int K, int R, int NWX>
__global__ void __launch_bounds__(32 * CW_MAX * NWX,
                                  NWX == WIDE_NWX ? WIDE_MIN_BLOCKS : 1)
blur_kernel(const T* __restrict__ x, const float* __restrict__ kernels,
            T* __restrict__ out, int h, int w, int c, int k, int tiles_x,
            int tiles_y) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kk = K ? K : k;
  const Geometry geo(R, NWX, c, kk);
  float* taps = smem;
  float* halo = smem + geo.taps;
  float* stage = halo + geo.halo;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;

  int blk = blockIdx.x;
  const int tile_x = blk % tiles_x;
  blk /= tiles_x;
  const int tile_y = blk % tiles_y;
  const int n = blk / tiles_y;
  const int y0 = tile_y * TH;
  const int x0 = tile_x * geo.tw;
  const int pad = kk / 2;

  const float* kn = kernels + (size_t)n * kk * kk;
  for (int i = tid; i < geo.taps; i += nthreads) {
    const int dy = i / geo.kp, dx = i - dy * geo.kp;
    taps[i] = dx < kk ? kn[dy * kk + dx] : 0.f;
  }
  // the halo, HALO_UNROLL pixels a thread at a time so that their loads
  // are in flight together
  const T* xn = x + (size_t)n * h * w * c;
  const int npix = geo.hh * geo.hwid;
  for (int p0 = tid; p0 < npix; p0 += HALO_UNROLL * nthreads) {
    const T* src[HALO_UNROLL];
    float* dst[HALO_UNROLL];
#pragma unroll
    for (int u = 0; u < HALO_UNROLL; ++u) {
      const int p = min(p0 + u * nthreads, npix - 1);
      const int r = p / geo.hwid;
      const int col = p - r * geo.hwid;
      src[u] = xn + ((size_t)reflect(y0 - pad + r, h) * w +
                     reflect(x0 - pad + col, w)) * c;
      dst[u] = halo + r * geo.pitch + col;
    }
    for (int ch = 0; ch < c; ++ch) {
      float v[HALO_UNROLL];
#pragma unroll
      for (int u = 0; u < HALO_UNROLL; ++u) v[u] = to_f32(src[u][ch]);
#pragma unroll
      for (int u = 0; u < HALO_UNROLL; ++u) dst[u][ch * geo.plane] = v[u];
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cw = nthreads / (32 * NWX);  // warps across the channels
  const int lx0 = (warp / cw) * R;       // this warp's first tile column
  for (int ch = warp % cw; ch < c; ch += cw) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    const float* src = halo + ch * geo.plane + lane * geo.pitch + lx0;
    const float* tp = taps;
#pragma unroll 1
    for (int dy = 0; dy < kk; ++dy, src += geo.pitch, tp += geo.kp) {
      if constexpr (K > 0) {
        constexpr int KP = (K + 3) & ~3;
        float t[KP];
#pragma unroll
        for (int q = 0; q < KP / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(tp)[q];
          t[4 * q] = v.x;
          t[4 * q + 1] = v.y;
          t[4 * q + 2] = v.z;
          t[4 * q + 3] = v.w;
        }
        float win[R + K - 1];
#pragma unroll
        for (int i = 0; i < R + K - 1; ++i) win[i] = src[i];
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(win[r + dx], t[dx], acc[r]);
      } else {
        float win[R];
#pragma unroll
        for (int r = 0; r < R; ++r) win[r] = src[r];
        for (int dx = 0; dx < kk; ++dx) {
          const float t = tp[dx];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(win[r], t, acc[r]);
          if (dx + 1 < kk) {
#pragma unroll
            for (int r = 0; r < R - 1; ++r) win[r] = win[r + 1];
            win[R - 1] = src[dx + R];
          }
        }
      }
    }
    float* st = stage + lane * geo.stage_pitch + lx0 * c + ch;
#pragma unroll
    for (int r = 0; r < R; ++r) st[r * c] = acc[r];
  }
  __syncthreads();

  // whole tile rows, coalesced: row r holds the valid columns' c values
  const int vh = min(TH, h - y0);
  const int row_len = min(geo.tw, w - x0) * c;
  T* on = out + (((size_t)n * h + y0) * w + x0) * c;
  for (int i = tid; i < vh * row_len; i += nthreads) {
    const int r = i / row_len;
    const int e = i - r * row_len;
    store(on + (size_t)r * w * c + e, stage[r * geo.stage_pitch + e]);
  }
}

size_t smem_bytes(int r, int nwx, int c, int k) {
  return (size_t)Geometry(r, nwx, c, k).words * sizeof(float);
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename T, int K, int R, int NWX>
int launch(const void* x, const float* kernels, void* out, int b, int h,
           int w, int c, int k, cudaStream_t stream) {
  // the limit set on each card (0: the default 48 KiB), an attribute of
  // each card: a process that launches on several sets it on each
  static size_t configured[MAX_DEVICES] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const size_t smem = smem_bytes(R, NWX, c, k);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > (configured[dev] ? configured[dev] : 48 * 1024)) {
    const cudaError_t e = cudaFuncSetAttribute(
        blur_kernel<T, K, R, NWX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = smem;
  }
  const int tw = R * NWX;
  const int tiles_x = (w + tw - 1) / tw;
  const int tiles_y = (h + TH - 1) / TH;
  const long long blocks = (long long)b * tiles_y * tiles_x;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int threads = 32 * (c < CW_MAX ? c : CW_MAX) * NWX;
  blur_kernel<T, K, R, NWX><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), kernels, static_cast<T*>(out), h, w, c, k,
      tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

// The wide tile where it gives at least two blocks per SM and fits, else
// the narrow one.
template <typename T, int K>
int by_tile(const void* x, const float* kernels, void* out, int b, int h,
            int w, int c, int k, cudaStream_t stream) {
  const int tw = WIDE_R * WIDE_NWX;
  const long long wide_blocks =
      (long long)b * ((h + TH - 1) / TH) * ((w + tw - 1) / tw);
  if (wide_blocks >= 2LL * sm_count() &&
      smem_bytes(WIDE_R, WIDE_NWX, c, k) <= MAX_SMEM)
    return launch<T, K, WIDE_R, WIDE_NWX>(x, kernels, out, b, h, w, c, k,
                                          stream);
  return launch<T, K, NARROW_R, NARROW_NWX>(x, kernels, out, b, h, w, c, k,
                                            stream);
}

template <typename T>
int dispatch(const void* x, const float* kernels, void* out, int b, int h,
             int w, int c, int k, cudaStream_t stream) {
  static_assert(MAX_K == 21, "one case per odd k up to MAX_K");
  switch (k) {
#define BLUR_CASE(KK) \
  case KK:            \
    return by_tile<T, KK>(x, kernels, out, b, h, w, c, k, stream);
    BLUR_CASE(3) BLUR_CASE(5) BLUR_CASE(7) BLUR_CASE(9) BLUR_CASE(11)
    BLUR_CASE(13) BLUR_CASE(15) BLUR_CASE(17) BLUR_CASE(19) BLUR_CASE(21)
#undef BLUR_CASE
    default:
      return by_tile<T, 0>(x, kernels, out, b, h, w, c, k, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of x and out). x, out: (b, h, w, c)
// NHWC contiguous; kernels: (b, k, k) f32 contiguous, k odd, k/2 < min(h, w).
// Returns 0, or the CUDA error of the launch (cudaErrorInvalidValue when
// the tile does not fit one block's shared memory).
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

// Bytes of shared memory one block needs at (c, k) on the narrow tile, the
// least of the two: (c, k) runs where this fits.
long long blur_per_sample_smem_bytes(int c, int k) {
  return (long long)smem_bytes(NARROW_R, NARROW_NWX, c, k);
}

const char* blur_per_sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
