// Shared pieces of the residual dense block kernels (rdb5c.cu, rdb5c_bwd.cu):
// vector loads and stores of f32 / bf16 values as f32, and the main loop of
// one 3x3 zero-padded implicit-GEMM tile on the CUDA cores.
//
// conv3x3_tile computes, for one 16x16 tile of output pixels of one image
// and 32 product columns,
//
//   r[pixel][col] = sum over taps t, channels c of
//                   in[pixel + s_t][in_off + c] * wp[(t*cin + c)][n0 + col]
//
// with s_t = (t/3 - 1, t%3 - 1) and zeros for taps outside the image. `in`
// is NHWC with a row pitch of in_pitch values per pixel, so a column slice
// of a wider buffer can be the conv's input. Each thread ends with a
// register tile of 4 consecutive pixels of one row x 8 columns; the caller
// writes its own epilogue with tile_coords.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rdbk {

constexpr int TH = 16;              // output rows per block
constexpr int TW = 16;              // output columns per block
constexpr int HH = TH + 2;          // halo tile rows
constexpr int HW = TW + 2;          // halo tile columns
constexpr int HPIX = HH * HW;       // 324 halo pixels
constexpr int LDA = 329;            // A-tile row pitch; LDA % 8 == 1 keeps the stores conflict-free
constexpr int KC = 32;              // input channels per chunk
constexpr int BN = 32;              // product columns per block
constexpr int THREADS = 256;        // 64 pixel groups x 4 column groups
constexpr size_t CONV_SMEM_BYTES = (size_t)(KC * LDA + 9 * KC * BN) * sizeof(float);

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  o[0] = __low2float(lo); o[1] = __high2float(lo);
  o[2] = __low2float(hi); o[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Where a thread's register tile lies: image bi, row yy, first column xx0
// (pixels xx0 .. xx0+3), first product column n (columns n .. n+7).
struct TileCoords {
  int bi, yy, xx0, n;
};

__device__ __forceinline__ TileCoords tile_coords(int tiles_x, int tiles_y) {
  const int tid = threadIdx.x;
  int tile = blockIdx.x;
  const int tx_t = tile % tiles_x;
  tile /= tiles_x;
  const int ty_t = tile % tiles_y;
  const int tp = tid >> 2;
  TileCoords c;
  c.bi = tile / tiles_y;
  c.yy = ty_t * TH + (tp >> 2);
  c.xx0 = tx_t * TW + (tp & 3) * 4;
  c.n = blockIdx.y * BN + (tid & 3) * 8;
  return c;
}

// smem: CONV_SMEM_BYTES of dynamic shared memory. Block = THREADS threads;
// blockIdx.x = (image, tile row, tile column), blockIdx.y = column slice.
template <typename T>
__device__ __forceinline__ void conv3x3_tile(
    float* smem, const T* __restrict__ in, int in_pitch, int in_off, int cin,
    const T* __restrict__ wp, int ncols, int h, int w, int tiles_x,
    int tiles_y, float (&r)[4][8]) {
  float* As = smem;               // [KC][LDA]: channel-major halo tile
  float* Ws = smem + KC * LDA;    // [9][KC][BN]

  const int tid = threadIdx.x;
  int tile = blockIdx.x;
  const int tx_t = tile % tiles_x;
  tile /= tiles_x;
  const int ty_t = tile % tiles_y;
  const int bi = tile / tiles_y;
  const int y0 = ty_t * TH;
  const int x0 = tx_t * TW;
  const int n0 = blockIdx.y * BN;

  const int tc = tid & 3;          // columns n0 + tc*8 .. +8
  const int tp = tid >> 2;         // pixel group 0..63
  const int prow = tp >> 2;        // tile row 0..15
  const int pcol = (tp & 3) * 4;   // tile columns pcol .. pcol+4

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) r[i][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += KC) {
    // halo tile of channels c0..c0+KC; zeros outside the image
    for (int i = tid; i < HPIX * (KC / 4); i += THREADS) {
      const int hp = i >> 3;
      const int cg = i & 7;
      const int yy = y0 + hp / HW - 1;
      const int xx = x0 + hp % HW - 1;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        const long long pix = ((long long)bi * h + yy) * w + xx;
        load4(in + pix * in_pitch + in_off + c0 + cg * 4, v);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) As[(cg * 4 + e) * LDA + hp] = v[e];
    }
    // weights of all nine taps for these channels and columns
    for (int i = tid; i < 9 * KC * (BN / 4); i += THREADS) {
      const int cg = i & 7;
      const int k = (i >> 3) % KC;
      const int t = (i >> 3) / KC;
      float v[4];
      load4(wp + (long long)(t * cin + c0 + k) * ncols + n0 + cg * 4, v);
      store4(Ws + (t * KC + k) * BN + cg * 4, v);
    }
    __syncthreads();

#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const float* ab = As + (prow + t / 3) * HW + pcol + t % 3;
      const float* wb = Ws + t * KC * BN + tc * 8;
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ab[k * LDA + i];
        const float4 b0 = *reinterpret_cast<const float4*>(wb + k * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(wb + k * BN + 4);
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) r[i][j] = fmaf(a[i], b[j], r[i][j]);
      }
    }
    __syncthreads();
  }
}

}  // namespace rdbk
