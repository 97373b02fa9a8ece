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
//    tap-flipped, transposed weight V_k[t'] = W_k[8-t']^T: the forward's
//    implicit-GEMM tile with its own epilogue (lrelu' from the sign of c_k,
//    or + g for dx).
//  * dW reduces over all b*h*w pixels, which the TPU kernel gets from its
//    sequential grid. Here pixel tiles run in parallel: the dW kernel writes
//    one partial per split of the pixel tiles, and reduce_splits adds the
//    partials in a fixed order. No atomics: results are the same from run
//    to run. The db column sums go the same two-pass way. The number of
//    splits is rdb5c_backward_dw_splits, which the caller asks for to size
//    the partials and the launch checks.
//
// Bound: 4*9*(nf(4gc+nf) + gc(3gc+nf) + gc(2gc+nf) + gc(gc+nf) + gc*nf)
// = 958,464 FLOPs per pixel at nf 64, gc 32 (twice the forward: dx and dW)
// against (3nf + 4gc) values read or written per pixel: bound by operations
// on this card.
//
// Two paths, chosen by the working type alone:
//
// bf16, on the tensor cores (mma.sync m16n8k16, f32 sums in registers):
//  * dx stages: rdb_dx_stage_mma, the tile of conv3x3_mma.cuh with DX set.
//    It reads V_k straight from the packed W_k (the rows of a tap's
//    [cin][N] slab are already "output column major" for the transposed
//    product), so no V table is built. See that header for what the tile
//    does about shared-memory traffic, weight loads, overlap and grids.
//  * dW: dw_mma_kernel. Per tap the product is c_k[p + s_t]^T dy_k[p] with
//    the pixels as K, so both operands are K-slow in their natural
//    pixel-major tiles and both come through ldmatrix.trans; a row of 16
//    tile pixels is one k16 step. A block owns one (stage, 32 channels, 32
//    columns) slot for all nine taps; a warp owns 16 channels x 16 columns x
//    9 taps (72 f32 sums a thread), kept in registers over all the block's
//    pixel tiles. For each halo row of c_k it loads three A fragments (the
//    three column shifts) and uses each against three rows of dy_k, whose
//    fragments stay in registers from row to row: 4 ldmatrix feed 18 mma.
//    The activation's halo tile and the dy tile are loaded once per tile by
//    cp.async (zeros outside the image) into two buffers, the next tile in
//    flight while this one is multiplied. Splits are sized so that one wave
//    of blocks (two per SM) covers the card: at b=32, 32x32 that is 10
//    splits x 26 slots, and 10 partials to add instead of 64.
//
// f32, exact FMAs on the CUDA cores: rdb_dx_stage (tile of
// conv3x3_tile.cuh) on a V table built once per call by vtab_kernel, and
// dw_kernel. 3xTF32 on the tensor cores and one fused launch are work for
// later versions.

#include "conv3x3_mma.cuh"
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.
// ---------------------------------------------------------------------------
struct DxEpilogue {
  const rdbm::bf16* act;  // c_k (k >= 1) or g (k == 0), pitch = ncols
  int ncols;
  rdbm::bf16* dst;        // G's slot k-1 (pitch gw) or dx (pitch nf)
  int dst_pitch;
  int last;               // k == 0
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
          const __nv_bfloat162 av = *reinterpret_cast<const __nv_bfloat162*>(
              act + pix * ncols + n);
          const float a0 = __low2float(av), a1 = __high2float(av);
          float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
          if (last) {
            v0 += a0;
            v1 += a1;
          } else {
            v0 *= a0 >= 0.f ? 1.f : 0.2f;
            v1 *= a1 >= 0.f ? 1.f : 0.2f;
          }
          *reinterpret_cast<__nv_bfloat162*>(dst + pix * dst_pitch + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
};

// two blocks fit an SM where the stage is narrow: at most 128 registers
__global__ void __launch_bounds__(rdbm::THREADS, 2)
rdb_dx_stage_mma(const __grid_constant__ rdbm::ConvArgs args,
                 const DxEpilogue epi) {
  rdbm::conv3x3_mma<true>(args, epi);
}

constexpr int DWM_THREADS = 128;  // 4 warps: 2 channel halves x 2 column halves
constexpr int DWM_A_BYTES = rdbm::HPIX * rdbm::PITCH;          // c_k halo tile
constexpr int DWM_D_BYTES = rdbm::TH * rdbm::TW * rdbm::PITCH;  // dy_k tile
constexpr int DWM_BUF_BYTES = DWM_A_BYTES + DWM_D_BYTES;
constexpr size_t DWM_SMEM_BYTES = 2 * (size_t)DWM_BUF_BYTES;
constexpr int DWM_BLOCKS_PER_SM = 2;

// One block = one (stage, 32-channel slice, 32-column slice) slot, all nine
// taps, over the pixel tiles blockIdx.x, blockIdx.x + nsplit, ...
__global__ void __launch_bounds__(DWM_THREADS)
dw_mma_kernel(const __grid_constant__ Stages st,
              const rdbm::bf16* __restrict__ G, int gw, int gc,
              float* __restrict__ part, int h, int w, int tiles_x,
              int tiles_y, int ntiles, int nsplit) {
  using rdbm::bf16;
  using rdbm::BN;
  using rdbm::HPIX;
  using rdbm::HW;
  using rdbm::KC;
  using rdbm::PITCH;
  using rdbm::TH;
  using rdbm::TW;
  using rdbm::cp_async16;
  using rdbm::cp_async_commit;
  using rdbm::cp_async_wait;
  using rdbm::ldmatrix_x4_trans;
  using rdbm::mma_bf16;
  using rdbm::smem_u32;
  extern __shared__ __align__(128) unsigned char smem_dw[];
  const uint32_t base = smem_u32(smem_dw);

  int k = 0, slot = blockIdx.y;
  for (;; ++k) {
    const int n_here = (st.cin[k] / KC) * (st.ncols[k] / BN);
    if (slot < n_here) break;
    slot -= n_here;
  }
  const int cin = st.cin[k], ncols = st.ncols[k];
  const int cs = slot / (ncols / BN);
  const int ns = slot % (ncols / BN);
  const bf16* act = static_cast<const bf16*>(st.act[k]) + cs * KC;
  const bf16* dy = G + k * gc + ns * BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = warp & 1;   // channels cs*32 + mt*16 .. +16
  const int nh = warp >> 1;  // columns ns*32 + nh*16 .. +16
  const int mi = lane >> 3;

  auto start_loads = [&](int tile, int buf) {
    if (tile < ntiles) {
      int rest = tile;
      const int x0 = (rest % tiles_x) * TW;
      rest /= tiles_x;
      const int y0 = (rest % tiles_y) * TH;
      const int bi = rest / tiles_y;
      const uint32_t abuf = base + buf * DWM_BUF_BYTES;
      const uint32_t dbuf = abuf + DWM_A_BYTES;
      for (int i = tid; i < HPIX * 4; i += DWM_THREADS) {
        const int hp = i >> 2, q = i & 3;
        const int yy = y0 + hp / HW - 1;
        const int xx = x0 + hp % HW - 1;
        const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
        const long long pix = inside ? ((long long)bi * h + yy) * w + xx : 0;
        cp_async16(abuf + hp * PITCH + q * 16, act + pix * cin + q * 8,
                   inside ? 16 : 0);
      }
      for (int i = tid; i < TH * TW * 4; i += DWM_THREADS) {
        const int p = i >> 2, q = i & 3;
        const int yy = y0 + p / TW;
        const int xx = x0 + p % TW;
        const bool inside = yy < h && xx < w;
        const long long pix = inside ? ((long long)bi * h + yy) * w + xx : 0;
        cp_async16(dbuf + p * PITCH + q * 16, dy + pix * gw + q * 8,
                   inside ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // A (c_k^T, 16 channels x 16 pixels of a halo row): matrix mi holds
  // channels (mi & 1)*8.., pixels (mi >> 1)*8..; stored pixel-major.
  const int a_lane = ((lane & 7) + 8 * (mi >> 1)) * PITCH + mt * 32 + (mi & 1) * 16;
  // B (dy_k, 16 pixels of a tile row x 16 columns): matrix mi holds column
  // group mi >> 1, pixels (mi & 1)*8..
  const int d_lane = ((lane & 7) + 8 * (mi & 1)) * PITCH + nh * 32 + (mi >> 1) * 16;

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  int buf = 0;
  start_loads(blockIdx.x, 0);
#pragma unroll 1
  for (int tile = blockIdx.x; tile < ntiles; tile += nsplit, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();
    start_loads(tile + nsplit, buf ^ 1);

    const uint32_t abuf = base + buf * DWM_BUF_BYTES + a_lane;
    const uint32_t dbuf = base + buf * DWM_BUF_BYTES + DWM_A_BYTES + d_lane;
    uint32_t bw[3][4];  // dy fragments of tile rows r with r % 3 = index
#pragma unroll 1
    for (int o = 0; o < 6; ++o) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int rp = 3 * o + u;  // halo row of c_k
        if (rp < TH) ldmatrix_x4_trans(bw[u], dbuf + rp * TW * PITCH);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, abuf + (rp * HW + dx) * PITCH);
#pragma unroll
          for (int dyi = 0; dyi < 3; ++dyi) {
            const int r = rp - dyi;  // tile row of dy_k under tap row dyi
            if (r >= 0 && r < TH) {
              const uint32_t(&bf)[4] = bw[(u - dyi + 3) % 3];
              mma_bf16(acc[dyi * 3 + dx][0], a, bf[0], bf[1]);
              mma_bf16(acc[dyi * 3 + dx][1], a, bf[2], bf[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = part + (long long)blockIdx.x * st.off[5] + st.off[k];
  const int c = cs * KC + mt * 16 + (lane >> 2);
  const int n = ns * BN + nh * 16 + 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            out + (long long)(t * cin + c + 8 * half) * ncols + n + nt * 8) =
            make_float2(acc[t][nt][2 * half], acc[t][nt][2 * half + 1]);
}

int count_dw_slots(int nf, int gc) {
  int slots = 0;
  for (int k = 0; k < 5; ++k)
    slots += ((k == 0 ? nf : gc) / 32) * ((4 * gc + nf - k * gc) / 32);
  return slots;
}

// Splits of the pixel tiles among the dW blocks. f32: up to 64. bf16: one
// wave of DWM_BLOCKS_PER_SM blocks per SM over all slots.
int dw_split_count(int dtype, int b, int h, int w, int nf, int gc) {
  const int ntiles = b * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  int cap = 64;
  if (dtype == 1) {
    static int sms = 0;
    if (!sms) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    cap = DWM_BLOCKS_PER_SM * sms / count_dw_slots(nf, gc);
    if (cap < 1) cap = 1;
  }
  return ntiles < cap ? ntiles : cap;
}

int launch_bwd_mma(const void* g_, const void* x_, void* const* cs,
                   const void* const* wts, void* G_, float* dw_part,
                   float* db_part, void* dx_, float* dw, float* db,
                   int b, int h, int w, int nf, int gc, int dw_splits_,
                   int db_splits, cudaStream_t stream) {
  using rdbm::bf16;
  if ((nf + 4 * gc) / rdbm::KC > rdbm::MAXCH) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  static int per_sm[rdbm::MAXCH + 1] = {0};
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        rdb_dx_stage_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)rdbm::conv_smem_bytes(rdbm::MAXCH));
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        dw_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)DWM_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const bf16* g = static_cast<const bf16*>(g_);
  bf16* G = static_cast<bf16*>(G_);
  const int gw = 4 * gc + nf;
  const long long npix = (long long)b * h * w;

  rdbm::ConvArgs args;
  args.h = h;
  args.w = w;
  args.tiles_x = (w + rdbm::TW - 1) / rdbm::TW;
  args.tiles_y = (h + rdbm::TH - 1) / rdbm::TH;
  args.ntiles = b * args.tiles_y * args.tiles_x;

  Stages st;
  st.off[0] = 0;
  for (int k = 0; k < 5; ++k) {
    st.w[k] = wts[k];
    st.act[k] = k == 0 ? x_ : cs[k - 1];
    st.cin[k] = k == 0 ? nf : gc;
    st.ncols[k] = gw - k * gc;
    st.off[k + 1] = st.off[k] + 9 * st.cin[k] * st.ncols[k];
  }
  const int total = st.off[5];

  dc5_kernel<bf16><<<(unsigned)((npix * (nf / 4) + 255) / 256), 256, 0,
                     stream>>>(g, G, npix, nf, gw);
  RDB_CHECK_LAUNCH();

  for (int k = 4; k >= 0; --k) {
    const int ncols = st.cin[k];  // columns of dc_k
    args.nchunks = st.ncols[k] / rdbm::KC;
    for (int j = 0; j < args.nchunks; ++j) {
      rdbm::ChunkSrc& c = args.ch[j];
      c.a = G + k * gc + j * rdbm::KC;
      c.a_pitch = gw;
      c.w = static_cast<const bf16*>(wts[k]) + j * rdbm::KC;
      c.w_pitch = st.ncols[k];
      c.w_tap = st.cin[k];
    }
    DxEpilogue epi;
    epi.act = k == 0 ? g : static_cast<const bf16*>(cs[k - 1]);
    epi.ncols = ncols;
    epi.dst = k == 0 ? static_cast<bf16*>(dx_) : G + (k - 1) * gc;
    epi.dst_pitch = k == 0 ? nf : gw;
    epi.last = k == 0;
    epi.h = h;
    epi.w = w;
    const int nslices = ncols / rdbm::BN;
    const dim3 grid((unsigned)rdbm::conv_grid_x(rdb_dx_stage_mma, per_sm,
                                                args.nchunks, args.ntiles,
                                                nslices),
                    (unsigned)nslices);
    rdb_dx_stage_mma<<<grid, rdbm::THREADS,
                       rdbm::conv_smem_bytes(args.nchunks), stream>>>(args,
                                                                      epi);
    RDB_CHECK_LAUNCH();
  }

  const dim3 dw_grid((unsigned)dw_splits_,
                     (unsigned)count_dw_slots(nf, gc));
  dw_mma_kernel<<<dw_grid, DWM_THREADS, DWM_SMEM_BYTES, stream>>>(
      st, G, gw, gc, dw_part, h, w, args.tiles_x, args.tiles_y, args.ntiles,
      dw_splits_);
  RDB_CHECK_LAUNCH();
  reduce_splits<<<(total + 255) / 256, 256, 0, stream>>>(dw_part, dw, total,
                                                         dw_splits_);
  RDB_CHECK_LAUNCH();

  const int rows = (int)((npix + db_splits - 1) / db_splits);
  colsum_kernel<bf16><<<db_splits, gw, 0, stream>>>(G, g, db_part, npix, nf,
                                                    gw, rows);
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
// values as w0..w4 together; f32 only, bf16 does not read it and it may be
// null) in the working type; dw_part (dw_splits x that many) and db_part
// (db_splits x (4gc+nf)) f32. dw_splits must be what
// rdb5c_backward_dw_splits returns for the same call.
// Outputs: dx in the working type; dw: the five packed dW one after the
// other, f32; db: [db1|db2|db3|db4|db5], f32. nf and gc are multiples of
// 32, 4gc+nf <= 1024 (bf16: <= 256). Returns the first CUDA error, else 0.
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
  if (dw_splits != dw_split_count(dtype, b, h, w, nf, gc))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(g, x, cs, wts, G, vt, dw_part, db_part, dx, dw,
                             db, b, h, w, nf, gc, dw_splits, db_splits, s);
  if (dtype == 1)
    return launch_bwd_mma(g, x, cs, wts, G, dw_part, db_part, dx, dw, db, b,
                          h, w, nf, gc, dw_splits, db_splits, s);
  return (int)cudaErrorInvalidValue;
}

// The number of dW partials the kernel of this type writes for this shape:
// the caller sizes dw_part by it.
int rdb5c_backward_dw_splits(int dtype, int b, int h, int w, int nf, int gc) {
  return dw_split_count(dtype, b, h, w, nf, gc);
}

// Dynamic shared memory of the bf16 dW kernel.
int rdb5c_backward_dw_smem_bytes() { return (int)DWM_SMEM_BYTES; }

const char* rdb5c_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
