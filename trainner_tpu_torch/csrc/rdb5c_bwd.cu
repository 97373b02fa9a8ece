// Backward of one ESRGAN residual dense block (5C) for Hopper (sm_90a).
//
// Replaces the TPU kernel trainner_tpu/ops/pallas_kernels.py::
// rdb5c_canvas_bwd (body _rdb5c_bwd_kernel_body, tap table _vtab). From
// g = d out, the forward's residuals x, c1..c4 (c_0 = x) and the packed
// stage weights W_k (9*cin_k, N_k), N_k = (4-k)gc + nf, it computes
//
//   dc5 = 0.2 g                                   db5 = sum_p dc5 (f32)
//   for k = 4..0, with dy_k = [da_{k+1} .. da_4 | dc5]   (N_k wide):
//     dc_k = sum_t dy_k[p - s_t] W_k[t]^T         (transposed 3x3 conv)
//     da_k = dc_k * lrelu'(c_k)   (k >= 1)        db_k = sum_p da_k
//     dx   = dc_0 + g             (k == 0)
//     dW_k[t] = sum_p c_k[p + s_t]^T dy_k[p]      (f32, over all pixels)
//
// lrelu' is read from the sign of the activation: 1 where c_k >= 0 (also
// at c_k == 0), else 0.2, as the TPU kernel reads it. dc5 and da_k are
// rounded to the working type (f32 or bf16) before they enter any product
// or db1..db4; db5 is summed from the f32 dc5; dx is rounded once. All
// sums are f32.
//
// Design. No canvas, no mask, no rolls, no sequential batch grid:
//  * G = [da1|da2|da3|da4|dc5] is one buffer of width 4gc+nf per pixel in
//    the working type. dy_k is its column slice from k*gc, read with a row
//    pitch; each dx stage writes its da_k into slot k-1. The five db are
//    column sums of G.
//  * A dx stage is a zero-padded 3x3 correlation of dy_k with the
//    tap-flipped, transposed weight V_k[t'] = W_k[8-t']^T, built once per
//    call by vtab_kernel. It runs the forward's implicit-GEMM tile
//    (conv3x3_tile: halo tile with zeros outside the image, f32 FMAs on
//    the CUDA cores) with its own epilogue.
//  * dW reduces over all b*h*w pixels, which the TPU kernel gets from its
//    sequential grid. Here pixel tiles run in parallel: dw_kernel writes
//    one partial per split of the pixel tiles, and reduce_splits adds the
//    partials in a fixed order. No atomics: results are the same from run
//    to run. The db column sums go the same two-pass way.
//
// Bound: 4*9*(nf(4gc+nf) + gc(3gc+nf) + gc(2gc+nf) + gc(gc+nf) + gc*nf)
// = 958,464 FLOPs per pixel at nf 64, gc 32 (twice the forward: dx and dW)
// against (3nf + 4gc) values read or written per pixel: compute-bound on
// this card. Tensor-core products (wgmma for bf16, 3xTF32 for f32), TMA
// and one fused launch are work for later versions.

#include "conv3x3_tile.cuh"

namespace {

using namespace rdbk;

// ---------------------------------------------------------------------------
// V tables: V_k[(t', n), c] = W_k[(8-t', c), n], all five stages in one
// launch. off[k] = first element of stage k in the packed layout (the same
// offsets hold for W and V: both have 9*cin_k*N_k elements).
// ---------------------------------------------------------------------------
struct Stages {
  const void* w[5];     // packed weights W_k
  const void* act[5];   // x, c1, c2, c3, c4
  int cin[5];
  int ncols[5];
  int off[6];
};

template <typename T>
__global__ void vtab_kernel(Stages st, T* __restrict__ v) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= st.off[5]) return;
  int k = 0;
  while (idx >= st.off[k + 1]) ++k;
  const int cin = st.cin[k], n = st.ncols[k];
  int rem = idx - st.off[k];
  const int c = rem % cin;
  rem /= cin;
  const int nn = rem % n;
  const int t = rem / n;
  v[idx] = static_cast<const T*>(st.w[k])[((8 - t) * cin + c) * n + nn];
}

// dc5 = 0.2 g, rounded, into the last nf columns of G.
template <typename T>
__global__ void dc5_kernel(const T* __restrict__ g, T* __restrict__ G,
                           long long npix, int nf, int gw) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = nf / 4;
  if (i >= npix * q) return;
  const long long pix = i / q;
  const int c = (int)(i % q) * 4;
  float v[4];
  load4(g + pix * nf + c, v);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] *= 0.2f;
  store4(G + pix * gw + (gw - nf) + c, v);
}

// One dx stage: dc_k = conv3x3(dy_k; V_k). Epilogue, stage k >= 1:
// da_k = dc_k * lrelu'(c_k) into G's slot k-1; stage 0: dx = dc_0 + g.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rdb_dx_stage(const T* __restrict__ G, int gw, int dy_off, int dy_cols,
             const T* __restrict__ vt, int ncols,
             const T* __restrict__ act,      // c_k (k >= 1) or g (k == 0)
             T* __restrict__ dst, int dst_pitch, int dst_off, int last,
             int h, int w, int tiles_x, int tiles_y) {
  extern __shared__ float smem[];
  float r[4][8];
  conv3x3_tile<T>(smem, G, gw, dy_off, dy_cols, vt, ncols, h, w, tiles_x,
                  tiles_y, r);
  const TileCoords tc = tile_coords(tiles_x, tiles_y);
  if (tc.yy >= h) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xx = tc.xx0 + i;
    if (xx >= w) break;
    const long long pix = ((long long)tc.bi * h + tc.yy) * w + xx;
#pragma unroll
    for (int q = 0; q < 8; q += 4) {
      float a[4], o[4];
      load4(act + pix * ncols + tc.n + q, a);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = last ? r[i][q + e] + a[e]
                    : r[i][q + e] * (a[e] >= 0.f ? 1.f : 0.2f);
      store4(dst + pix * dst_pitch + dst_off + tc.n + q, o);
    }
  }
}

// ---------------------------------------------------------------------------
// dW partials. One block = one (stage, 32-channel slice of the activation,
// 32-column slice of dy_k) for all nine taps, over the pixel tiles
// split, split + nsplit, ... Thread = 4 channels x 2 columns x 9 taps.
// ---------------------------------------------------------------------------
constexpr int DW_THREADS = 128;
constexpr int DW_KC = 32;
constexpr int DW_BN = 32;
constexpr size_t DW_SMEM_BYTES =
    (size_t)(HPIX * DW_KC + TH * TW * DW_BN) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
dw_kernel(Stages st, const T* __restrict__ G, int gw, int gc,
          float* __restrict__ part, int h, int w, int tiles_x, int tiles_y,
          int ntiles, int nsplit) {
  extern __shared__ float smem[];
  float* As = smem;                 // [HPIX][DW_KC]: pixel-major halo tile
  float* Ds = smem + HPIX * DW_KC;  // [TH*TW][DW_BN]

  // blockIdx.y -> (stage k, channel slice cs, column slice ns)
  int k = 0, slot = blockIdx.y;
  for (;; ++k) {
    const int n_here = (st.cin[k] / DW_KC) * (st.ncols[k] / DW_BN);
    if (slot < n_here) break;
    slot -= n_here;
  }
  const int cin = st.cin[k], ncols = st.ncols[k];
  const int cs = slot / (ncols / DW_BN);
  const int ns = slot % (ncols / DW_BN);
  const T* act = static_cast<const T*>(st.act[k]);
  const int dy_off = k * gc + ns * DW_BN;

  const int tid = threadIdx.x;
  const int ng = tid & 15;          // columns ng*2, ng*2+1
  const int cg = tid >> 4;          // channels cg*4 .. cg*4+3

  float acc[9][4][2];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i][0] = acc[t][i][1] = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += nsplit) {
    int rest = tile;
    const int x0 = (rest % tiles_x) * TW;
    rest /= tiles_x;
    const int y0 = (rest % tiles_y) * TH;
    const int bi = rest / tiles_y;
    for (int i = tid; i < HPIX * (DW_KC / 4); i += DW_THREADS) {
      const int hp = i >> 3;
      const int q = i & 7;
      const int yy = y0 + hp / HW - 1;
      const int xx = x0 + hp % HW - 1;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        const long long pix = ((long long)bi * h + yy) * w + xx;
        load4(act + pix * cin + cs * DW_KC + q * 4, v);
      }
      store4(As + hp * DW_KC + q * 4, v);
    }
    for (int i = tid; i < TH * TW * (DW_BN / 4); i += DW_THREADS) {
      const int p = i >> 3;
      const int q = i & 7;
      const int yy = y0 + p / TW;
      const int xx = x0 + p % TW;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (yy < h && xx < w) {
        const long long pix = ((long long)bi * h + yy) * w + xx;
        load4(G + pix * gw + dy_off + q * 4, v);
      }
      store4(Ds + p * DW_BN + q * 4, v);
    }
    __syncthreads();

#pragma unroll 2
    for (int p = 0; p < TH * TW; ++p) {
      const float2 d = *reinterpret_cast<const float2*>(Ds + p * DW_BN + ng * 2);
      const float* ab = As + ((p / TW) * HW + p % TW) * DW_KC + cg * 4;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(
            ab + ((t / 3) * HW + t % 3) * DW_KC);
        acc[t][0][0] = fmaf(a.x, d.x, acc[t][0][0]);
        acc[t][0][1] = fmaf(a.x, d.y, acc[t][0][1]);
        acc[t][1][0] = fmaf(a.y, d.x, acc[t][1][0]);
        acc[t][1][1] = fmaf(a.y, d.y, acc[t][1][1]);
        acc[t][2][0] = fmaf(a.z, d.x, acc[t][2][0]);
        acc[t][2][1] = fmaf(a.z, d.y, acc[t][2][1]);
        acc[t][3][0] = fmaf(a.w, d.x, acc[t][3][0]);
        acc[t][3][1] = fmaf(a.w, d.y, acc[t][3][1]);
      }
    }
    __syncthreads();
  }

  float* out = part + (long long)blockIdx.x * st.off[5] + st.off[k];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = t * cin + cs * DW_KC + cg * 4 + i;
      *reinterpret_cast<float2*>(out + (long long)row * ncols + ns * DW_BN +
                                 ng * 2) =
          make_float2(acc[t][i][0], acc[t][i][1]);
    }
}

// Column sums of G over a range of pixels, one partial row per block:
// columns below 4gc sum the rounded da_k, the last nf columns sum the f32
// 0.2 g. blockDim.x = gw.
template <typename T>
__global__ void colsum_kernel(const T* __restrict__ G, const T* __restrict__ g,
                              float* __restrict__ part, long long npix,
                              int nf, int gw, int rows_per_block) {
  const int c = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * rows_per_block;
  long long p1 = p0 + rows_per_block;
  if (p1 > npix) p1 = npix;
  float s = 0.f;
  if (c < gw - nf) {
    for (long long p = p0; p < p1; ++p) s += to_float(G[p * gw + c]);
  } else {
    const int cc = c - (gw - nf);
    for (long long p = p0; p < p1; ++p) s += 0.2f * to_float(g[p * nf + cc]);
  }
  part[(long long)blockIdx.x * gw + c] = s;
}

// out[i] = part[0][i] + part[1][i] + ... in that order.
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ out, int n, int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += part[(long long)k * n + i];
  out[i] = s;
}

#define RDB_CHECK_LAUNCH()                        \
  do {                                            \
    const cudaError_t e_ = cudaGetLastError();    \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)

template <typename T>
int launch_bwd(const void* g_, const void* x_, void* const* cs,
               const void* const* wts, void* G_, void* vt_, float* dw_part,
               float* db_part, void* dx_, float* dw, float* db,
               int b, int h, int w, int nf, int gc, int dw_splits,
               int db_splits, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        rdb_dx_stage<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)CONV_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)DW_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const T* g = static_cast<const T*>(g_);
  T* G = static_cast<T*>(G_);
  T* vt = static_cast<T*>(vt_);
  const int gw = 4 * gc + nf;
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  const int ntiles = b * tiles_y * tiles_x;
  const long long npix = (long long)b * h * w;

  Stages st;
  st.off[0] = 0;
  int dw_slots = 0;
  for (int k = 0; k < 5; ++k) {
    st.w[k] = wts[k];
    st.act[k] = k == 0 ? x_ : cs[k - 1];
    st.cin[k] = k == 0 ? nf : gc;
    st.ncols[k] = gw - k * gc;
    st.off[k + 1] = st.off[k] + 9 * st.cin[k] * st.ncols[k];
    dw_slots += (st.cin[k] / DW_KC) * (st.ncols[k] / DW_BN);
  }
  const int total = st.off[5];

  vtab_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(st, vt);
  RDB_CHECK_LAUNCH();
  dc5_kernel<T><<<(unsigned)((npix * (nf / 4) + 255) / 256), 256, 0, stream>>>(
      g, G, npix, nf, gw);
  RDB_CHECK_LAUNCH();

  for (int k = 4; k >= 0; --k) {
    const int ncols = st.cin[k];
    const dim3 grid((unsigned)ntiles, (unsigned)(ncols / BN));
    rdb_dx_stage<T><<<grid, THREADS, CONV_SMEM_BYTES, stream>>>(
        G, gw, k * gc, st.ncols[k], vt + st.off[k], ncols,
        k == 0 ? g : static_cast<const T*>(cs[k - 1]),
        k == 0 ? static_cast<T*>(dx_) : G, k == 0 ? nf : gw,
        k == 0 ? 0 : (k - 1) * gc, k == 0, h, w, tiles_x, tiles_y);
    RDB_CHECK_LAUNCH();
  }

  const dim3 dw_grid((unsigned)dw_splits, (unsigned)dw_slots);
  dw_kernel<T><<<dw_grid, DW_THREADS, DW_SMEM_BYTES, stream>>>(
      st, G, gw, gc, dw_part, h, w, tiles_x, tiles_y, ntiles, dw_splits);
  RDB_CHECK_LAUNCH();
  reduce_splits<<<(total + 255) / 256, 256, 0, stream>>>(dw_part, dw, total,
                                                         dw_splits);
  RDB_CHECK_LAUNCH();

  const int rows = (int)((npix + db_splits - 1) / db_splits);
  colsum_kernel<T><<<db_splits, gw, 0, stream>>>(G, g, db_part, npix, nf, gw,
                                                 rows);
  RDB_CHECK_LAUNCH();
  reduce_splits<<<(gw + 255) / 256, 256, 0, stream>>>(db_part, db, gw,
                                                      db_splits);
  RDB_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. g, x, dx: (b, h, w, nf) NHWC; c1..c4:
// (b, h, w, gc); w0..w4: packed (9*cin, N) in the working type.
// Scratch, allocated by the caller: G (b*h*w, 4gc+nf) and vt (as many
// values as w0..w4 together) in the working type; dw_part (dw_splits x
// that many) and db_part (db_splits x (4gc+nf)) f32.
// Outputs: dx in the working type; dw: the five packed dW one after the
// other, f32; db: [db1|db2|db3|db4|db5], f32. nf and gc are multiples of
// 32, 4gc+nf <= 1024, dw_splits <= the number of 16x16 pixel tiles.
// Returns cudaGetLastError() of the first launch that failed, else 0.
int rdb5c_backward(int dtype, const void* g, const void* x,
                   void* c1, void* c2, void* c3, void* c4,
                   const void* w0, const void* w1, const void* w2,
                   const void* w3, const void* w4,
                   void* G, void* vt, float* dw_part, float* db_part,
                   void* dx, float* dw, float* db,
                   int b, int h, int w, int nf, int gc,
                   int dw_splits, int db_splits, void* stream) {
  void* cs[4] = {c1, c2, c3, c4};
  const void* wts[5] = {w0, w1, w2, w3, w4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(g, x, cs, wts, G, vt, dw_part, db_part, dx, dw,
                             db, b, h, w, nf, gc, dw_splits, db_splits, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, x, cs, wts, G, vt, dw_part, db_part,
                                     dx, dw, db, b, h, w, nf, gc, dw_splits,
                                     db_splits, s);
  return (int)cudaErrorInvalidValue;
}

const char* rdb5c_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
