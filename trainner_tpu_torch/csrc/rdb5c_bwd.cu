// Backward of one ESRGAN residual dense block (5C) for Hopper (sm_90a).
//
// Replaces the TPU kernel trainner_tpu/ops/pallas_kernels.py::
// rdb5c_canvas_bwd (body _rdb5c_bwd_kernel_body, tap table _vtab). From
// g = d out, the forward's residuals x, c1..c4 (c_0 = x) and the packed
// stage weights W_k (9*cin, N_k), N_k = (4-k)gc + nf, it computes
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
//    tap-flipped, transposed weight V_k[t'] = W_k[8-t']^T: the tile of
//    conv3x3_mma.cuh with DX set (rdb_dx_stage_mma in bf16,
//    rdb_dx_streamed_stage_mma for a bf16 stage over more than 256 columns
//    of dy, rdb_dx_stage_tf32 in f32) and its own epilogue (lrelu' from the sign
//    of c_k, or + g for dx). It reads V_k straight from the packed W_k (the
//    rows of a tap's [cin][N] slab are already "output column major" for
//    the transposed product), so no V table is built.
//  * dW reduces over all b*h*w pixels, which the TPU kernel gets from its
//    sequential grid. Here pixel tiles run in parallel: the dW kernel writes
//    one partial per split of the pixel tiles, and reduce_splits adds the
//    partials in a fixed order. No atomics: results are the same from run
//    to run. The db column sums go the same two-pass way. The number of
//    splits is rdb5c_backward_dw_splits, which the caller asks for to size
//    the partials and the launch checks: one wave of dW blocks over the
//    card.
//
// Bound: 4*9*(nf(4gc+nf) + gc(3gc+nf) + gc(2gc+nf) + gc(gc+nf) + gc*nf)
// = 958,464 FLOPs per pixel at nf 64, gc 32 (twice the forward: dx and dW)
// against (3nf + 4gc) values read or written per pixel: bound by operations
// on this card, by the tensor cores' rate (bf16 989 TFLOP/s; f32 as
// 3xTF32, three tf32 products at 495 TFLOP/s per f32 product).
//
// On a tensor axis (trainner_tpu_torch/parallel/tensor.py), a conv j split
// by output column computes only its own columns' share, by the entry
// points below rdb5c_backward, which trainner_tpu_torch/ops/rdb5c.py::
// rdb5c_backward_split calls in turn with the collectives between them:
//  * rdb5c_bwd_part: once dy_j (conv j's output gradient) is known, the
//    rank's columns' term of every dx stage s <= j, from a copy of dy_j
//    that holds its columns alone in a 32-column window (zeros around
//    them), against the window's columns of W_s: the dx tile with an
//    epilogue that stores the f32 sums (rdb_dx_part_*). The terms are
//    summed over the tensor group (in one all-reduce per split conv).
//  * rdb5c_bwd_dx_stage: dx stage k reduces over the column runs of dy_k
//    that belong to whole convs alone, and its epilogue adds the summed
//    terms before lrelu' (or + g) (rdb_dx_*stage_part_*). A stage whose terms all came that way
//    (stage 4 when conv5 is split) is that epilogue alone
//    (part_epilogue_kernel).
//  * rdb5c_bwd_dw: the dW slots of columns outside the rank's are skipped
//    (their partials written as zeros), so the reduction keeps its fixed
//    order and reruns stay bit-equal.
//  * rdb5c_bwd_dc5 and rdb5c_bwd_db: dc5 and the column sums, as above.
//
// dW, per tap the product c_k[p + s_t]^T dy_k[p] with the pixels as K: a
// block owns one (stage, 32 channels, 32 columns) slot for all nine taps
// and keeps its sums in registers over all its pixel tiles. For each halo
// row of c_k it loads A fragments for the three column shifts and uses
// each against three rows of dy_k, whose fragments stay in registers from
// row to row. The activation's halo tile and the dy tile come once per tile
// by cp.async (zeros outside the image) into two buffers, the next tile in
// flight while this one is multiplied.
//  * bf16, dw_mma_kernel: mma.sync m16n8k16, both operands K-slow in their
//    natural pixel-major tiles, so both come through ldmatrix.trans; a warp
//    owns 16 channels x 16 columns x 9 taps (72 f32 sums a thread): 4
//    ldmatrix feed 18 mma. Two blocks of 4 warps per SM.
//  * f32, dw_tf32_kernel: 3xTF32 on mma.sync m16n8k8. There is no 32-bit
//    ldmatrix.trans, so fragments come by 32-bit loads from tiles at a
//    pitch of 40 floats: the four pixels x eight channels (or columns) of a
//    fragment load fall in 32 different banks. Each dy row is split into
//    tf32 hi and lo once and used for nine products, each A fragment for
//    six. Its buffers take 185,600 bytes, one block per SM, so the block
//    has 8 warps: the four (channel half, column half) quadrants for the
//    upper and the lower eight tile rows, whose sums are added in a fixed
//    order at the end.

#include "conv3x3_mma.cuh"

namespace {

using rdbm::bf16;

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const bf16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float* v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// The five stages for the dW kernels. off[k] = first element of stage k's
// dW in the packed layout.
struct Stages {
  const void* w[5];     // packed weights W_k
  const void* act[5];   // x, c1, c2, c3, c4
  int cin[5];
  int ncols[5];
  int off[6];
  unsigned live[5];     // bit c: the 32-column group c of W_k is computed
};

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

// ---------------------------------------------------------------------------
// dx stages on the tile of conv3x3_mma.cuh.
// ---------------------------------------------------------------------------
// PART: the f32 terms of split convs added before lrelu' (a kernel of its
// own, rdb_dx_*_part_*: the f32 tile of the plain stage has no register
// to spare)
template <typename T, bool PART>
struct DxEpilogue {
  const T* act;  // c_k (k >= 1) or g (k == 0), pitch = ncols
  int ncols;
  T* dst;        // G's slot k-1 (pitch gw) or dx (pitch nf)
  int dst_pitch;
  int last;      // k == 0
  int h, w;
  const float* part;  // PART: the summed terms of split convs
  int part_pitch;

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
          const float2 a = rdbm::load2(act + pix * ncols + n);
          float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
          if constexpr (PART) {
            const float2 q = rdbm::load2(part + pix * part_pitch + n);
            v0 += q.x;
            v1 += q.y;
          }
          if (last) {
            v0 += a.x;
            v1 += a.y;
          } else {
            v0 *= a.x >= 0.f ? 1.f : 0.2f;
            v1 *= a.y >= 0.f ? 1.f : 0.2f;
          }
          rdbm::store2(dst + pix * dst_pitch + n, v0, v1);
        }
      }
    }
  }
};

// two blocks fit an SM where the stage is narrow: at most 128 registers
__global__ void __launch_bounds__(rdbm::THREADS, 2)
rdb_dx_stage_mma(const __grid_constant__ rdbm::ConvArgs<bf16> args,
                 const DxEpilogue<bf16, false> epi) {
  rdbm::conv3x3_mma<true, false>(args, epi);
}

// a bf16 dx stage over more than MAXCH chunks of dy: one block per SM, the
// ring of three (halo tile, slab) pairs
__global__ void __launch_bounds__(rdbm::THREADS, 1)
rdb_dx_streamed_stage_mma(const __grid_constant__ rdbm::ConvArgs<bf16> args,
                          const DxEpilogue<bf16, false> epi) {
  rdbm::conv3x3_mma<true, true>(args, epi);
}

// one block per SM: the ring of two f32 (halo tile, slab) pairs
__global__ void __launch_bounds__(rdbm::THREADS, 1)
rdb_dx_stage_tf32(const __grid_constant__ rdbm::ConvArgs<float> args,
                  const DxEpilogue<float, false> epi) {
  rdbm::conv3x3_mma<true, false>(args, epi);
}

// the same three adding the summed terms of split convs
__global__ void __launch_bounds__(rdbm::THREADS, 2)
rdb_dx_stage_part_mma(const __grid_constant__ rdbm::ConvArgs<bf16> args,
                      const DxEpilogue<bf16, true> epi) {
  rdbm::conv3x3_mma<true, false>(args, epi);
}

__global__ void __launch_bounds__(rdbm::THREADS, 1)
rdb_dx_streamed_stage_part_mma(
    const __grid_constant__ rdbm::ConvArgs<bf16> args,
    const DxEpilogue<bf16, true> epi) {
  rdbm::conv3x3_mma<true, true>(args, epi);
}

__global__ void __launch_bounds__(rdbm::THREADS, 1)
rdb_dx_stage_part_tf32(const __grid_constant__ rdbm::ConvArgs<float> args,
                       const DxEpilogue<float, true> epi) {
  rdbm::conv3x3_mma<true, false>(args, epi);
}

// A split conv's term of one dx stage: the f32 sums as they are.
struct PartEpilogue {
  float* out;  // (pixels, out_pitch)
  int out_pitch;
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
        for (int nt = 0; nt < 4; ++nt)
          rdbm::store2(out + pix * out_pitch + f.n + nt * 8,
                       acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
};

__global__ void __launch_bounds__(rdbm::THREADS, 2)
rdb_dx_part_mma(const __grid_constant__ rdbm::ConvArgs<bf16> args,
                const PartEpilogue epi) {
  rdbm::conv3x3_mma<true, false>(args, epi);
}

__global__ void __launch_bounds__(rdbm::THREADS, 1)
rdb_dx_part_streamed_mma(const __grid_constant__ rdbm::ConvArgs<bf16> args,
                         const PartEpilogue epi) {
  rdbm::conv3x3_mma<true, true>(args, epi);
}

__global__ void __launch_bounds__(rdbm::THREADS, 1)
rdb_dx_part_tf32(const __grid_constant__ rdbm::ConvArgs<float> args,
                 const PartEpilogue epi) {
  rdbm::conv3x3_mma<true, false>(args, epi);
}

// A dx stage whose every term came from split convs: its epilogue alone,
// v = part, then lrelu' from the sign of c_k (or + g), rounded once.
template <typename T>
__global__ void part_epilogue_kernel(const float* __restrict__ part,
                                     int part_pitch, const T* __restrict__ act,
                                     int ncols, T* __restrict__ dst,
                                     int dst_pitch, int last,
                                     long long npix) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = ncols / 2;
  if (i >= npix * q) return;
  const long long pix = i / q;
  const int c = (int)(i % q) * 2;
  const float2 a = rdbm::load2(act + pix * ncols + c);
  const float2 p = rdbm::load2(part + pix * part_pitch + c);
  float v0 = p.x, v1 = p.y;
  if (last) {
    v0 += a.x;
    v1 += a.y;
  } else {
    v0 *= a.x >= 0.f ? 1.f : 0.2f;
    v1 *= a.y >= 0.f ? 1.f : 0.2f;
  }
  rdbm::store2(dst + pix * dst_pitch + c, v0, v1);
}

// ---------------------------------------------------------------------------
// dW partials in bf16.
// ---------------------------------------------------------------------------
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
  // a slot of columns that another tensor rank owns: zeros, no tiles
  const int first = (st.live[k] >> ns) & 1u ? (int)blockIdx.x : ntiles;

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
  start_loads(first, 0);
#pragma unroll 1
  for (int tile = first; tile < ntiles; tile += nsplit, buf ^= 1) {
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


// ---------------------------------------------------------------------------
// dW partials in f32, 3xTF32.
// ---------------------------------------------------------------------------
constexpr int DWT_THREADS = 256;  // 8 warps: channel half x column half x row half
constexpr int DWT_PITCH = 160;    // bytes per tile pixel: 40 floats, 8 banks apart
constexpr int DWT_A_BYTES = rdbm::HPIX * DWT_PITCH;           // c_k halo tile
constexpr int DWT_D_BYTES = rdbm::TH * rdbm::TW * DWT_PITCH;  // dy_k tile
constexpr int DWT_BUF_BYTES = DWT_A_BYTES + DWT_D_BYTES;
constexpr size_t DWT_SMEM_BYTES = 2 * (size_t)DWT_BUF_BYTES;

// One block = one (stage, 32-channel slice, 32-column slice) slot, all nine
// taps, over the pixel tiles blockIdx.x, blockIdx.x + nsplit, ...
__global__ void __launch_bounds__(DWT_THREADS, 1)
dw_tf32_kernel(const __grid_constant__ Stages st,
               const float* __restrict__ G, int gw, int gc,
               float* __restrict__ part, int h, int w, int tiles_x,
               int tiles_y, int ntiles, int nsplit) {
  using rdbm::BN;
  using rdbm::HPIX;
  using rdbm::HW;
  using rdbm::KC;
  using rdbm::TH;
  using rdbm::TW;
  constexpr int PW = DWT_PITCH / 4;  // floats per tile pixel
  extern __shared__ __align__(128) unsigned char smem_dwt[];
  const uint32_t base = rdbm::smem_u32(smem_dwt);

  int k = 0, slot = blockIdx.y;
  for (;; ++k) {
    const int n_here = (st.cin[k] / KC) * (st.ncols[k] / BN);
    if (slot < n_here) break;
    slot -= n_here;
  }
  const int cin = st.cin[k], ncols = st.ncols[k];
  const int cs = slot / (ncols / BN);
  const int ns = slot % (ncols / BN);
  const float* act = static_cast<const float*>(st.act[k]) + cs * KC;
  const float* dy = G + k * gc + ns * BN;
  // a slot of columns that another tensor rank owns: zeros, no tiles
  const int first = (st.live[k] >> ns) & 1u ? (int)blockIdx.x : ntiles;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = warp & 1;         // channels cs*32 + mt*16 .. +16
  const int nh = (warp >> 1) & 1;  // columns ns*32 + nh*16 .. +16
  const int rh = warp >> 2;        // tile rows 8*rh .. +8
  const int g = lane >> 2, t4 = lane & 3;

  auto start_loads = [&](int tile, int buf) {
    if (tile < ntiles) {
      int rest = tile;
      const int x0 = (rest % tiles_x) * TW;
      rest /= tiles_x;
      const int y0 = (rest % tiles_y) * TH;
      const int bi = rest / tiles_y;
      const uint32_t abuf = base + buf * DWT_BUF_BYTES;
      const uint32_t dbuf = abuf + DWT_A_BYTES;
      for (int i = tid; i < HPIX * 8; i += DWT_THREADS) {
        const int hp = i >> 3, q = i & 7;
        const int yy = y0 + hp / HW - 1;
        const int xx = x0 + hp % HW - 1;
        const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
        const long long pix = inside ? ((long long)bi * h + yy) * w + xx : 0;
        rdbm::cp_async16(abuf + hp * DWT_PITCH + q * 16,
                         act + pix * cin + q * 4, inside ? 16 : 0);
      }
      for (int i = tid; i < TH * TW * 8; i += DWT_THREADS) {
        const int p = i >> 3, q = i & 7;
        const int yy = y0 + p / TW;
        const int xx = x0 + p % TW;
        const bool inside = yy < h && xx < w;
        const long long pix = inside ? ((long long)bi * h + yy) * w + xx : 0;
        rdbm::cp_async16(dbuf + p * DWT_PITCH + q * 16, dy + pix * gw + q * 4,
                         inside ? 16 : 0);
      }
    }
    rdbm::cp_async_commit();
  };

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  int buf = 0;
  start_loads(first, 0);
#pragma unroll 1
  for (int tile = first; tile < ntiles; tile += nsplit, buf ^= 1) {
    rdbm::cp_async_wait<0>();
    __syncthreads();
    start_loads(tile + nsplit, buf ^ 1);

    // A (c_k^T: 16 channels x 8 pixels per k-step): lane reads channel g
    // (+8) of pixel t4 (+4); B (dy_k: 8 pixels x 8 columns): column g of
    // pixel t4 (+4)
    const float* as = reinterpret_cast<const float*>(
                          smem_dwt + buf * DWT_BUF_BYTES) +
                      t4 * PW + mt * 16 + g;
    const float* ds = reinterpret_cast<const float*>(
                          smem_dwt + buf * DWT_BUF_BYTES + DWT_A_BYTES) +
                      t4 * PW + nh * 16 + g;
    // dy fragments of the warp's tile rows r with (r - 8*rh) % 3 = index,
    // split into tf32 hi and lo: [row][k-step][n-tile][register]
    uint32_t bhi[3][2][2][2], blo[3][2][2][2];
#pragma unroll 1
    for (int o = 0; o < 4; ++o) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int j = 3 * o + u;  // halo row 8*rh + j of c_k
        if (j >= 10) continue;
        const int rp = 8 * rh + j;
        if (j < 8) {
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                rdbm::split_tf32(
                    __float_as_uint(ds[(rp * TW + 8 * s + 4 * e) * PW + nt * 8]),
                    bhi[u][s][nt][e], blo[u][s][nt][e]);
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          uint32_t ahi[2][4], alo[2][4];
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              rdbm::split_tf32(
                  __float_as_uint(as[(rp * HW + dx + 8 * s + 4 * (e >> 1)) * PW +
                                     8 * (e & 1)]),
                  ahi[s][e], alo[s][e]);
#pragma unroll
          for (int dyi = 0; dyi < 3; ++dyi) {
            const int jr = j - dyi;  // the warp's tile row under tap row dyi
            if (jr >= 0 && jr < 8) {
              const int b = (u - dyi + 3) % 3;
#pragma unroll
              for (int s = 0; s < 2; ++s)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
                  rdbm::mma_3xtf32(acc[dyi * 3 + dx][nt], ahi[s], alo[s],
                                   bhi[b][s][nt], blo[b][s][nt]);
            }
          }
        }
      }
    }
  }
  rdbm::cp_async_wait<0>();
  __syncthreads();

  // the lower row half's sums onto the upper's, in that order
  float* red = reinterpret_cast<float*>(smem_dwt) + (warp & 3) * 72 * 32 + lane;
  if (rh == 1) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((t * 2 + nt) * 4 + e) * 32] = acc[t][nt][e];
  }
  __syncthreads();
  if (rh == 1) return;

  float* out = part + (long long)blockIdx.x * st.off[5] + st.off[k];
  const int c = cs * KC + mt * 16 + g;
  const int n = ns * BN + nh * 16 + 2 * t4;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = 2 * half;
        *reinterpret_cast<float2*>(
            out + (long long)(t * cin + c + 8 * half) * ncols + n + nt * 8) =
            make_float2(acc[t][nt][e] + red[((t * 2 + nt) * 4 + e) * 32],
                        acc[t][nt][e + 1] +
                            red[((t * 2 + nt) * 4 + e + 1) * 32]);
      }
}

int count_dw_slots(int nf, int gc) {
  int slots = 0;
  for (int k = 0; k < 5; ++k)
    slots += ((k == 0 ? nf : gc) / 32) * ((4 * gc + nf - k * gc) / 32);
  return slots;
}

// Splits of the pixel tiles among the dW blocks: one wave of blocks over
// all slots (two bf16 blocks per SM, one f32 block).
int dw_split_count(int dtype, int b, int h, int w, int nf, int gc) {
  const int ntiles =
      b * ((h + rdbm::TH - 1) / rdbm::TH) * ((w + rdbm::TW - 1) / rdbm::TW);
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int cap = (dtype == 1 ? DWM_BLOCKS_PER_SM : 1) * sms / count_dw_slots(nf, gc);
  if (cap < 1) cap = 1;
  return ntiles < cap ? ntiles : cap;
}

template <typename T>
int configure_bwd() {
  constexpr bool F32 = std::is_same<T, float>::value;
  static bool configured[rdbm::MAX_DEVICES] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= rdbm::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (configured[dev]) return 0;
  const size_t narrow = rdbm::conv_smem_bytes<T>(rdbm::MAXCH);
  const size_t wide = rdbm::conv_smem_bytes<T>(rdbm::MAXCH + 1);
  const void* kernels[8];
  size_t bytes[8];
  int n = 0;
  if (F32) {
    kernels[n] = (const void*)rdb_dx_stage_tf32, bytes[n++] = narrow;
    kernels[n] = (const void*)rdb_dx_stage_part_tf32, bytes[n++] = narrow;
    kernels[n] = (const void*)rdb_dx_part_tf32, bytes[n++] = narrow;
    kernels[n] = (const void*)dw_tf32_kernel, bytes[n++] = DWT_SMEM_BYTES;
  } else {
    kernels[n] = (const void*)rdb_dx_stage_mma, bytes[n++] = narrow;
    kernels[n] = (const void*)rdb_dx_stage_part_mma, bytes[n++] = narrow;
    kernels[n] = (const void*)rdb_dx_part_mma, bytes[n++] = narrow;
    kernels[n] = (const void*)rdb_dx_streamed_stage_mma, bytes[n++] = wide;
    kernels[n] = (const void*)rdb_dx_streamed_stage_part_mma,
    bytes[n++] = wide;
    kernels[n] = (const void*)rdb_dx_part_streamed_mma, bytes[n++] = wide;
    kernels[n] = (const void*)dw_mma_kernel, bytes[n++] = DWM_SMEM_BYTES;
  }
  for (int i = 0; i < n; ++i) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes[i]);
    if (e != cudaSuccess) return (int)e;
  }
  configured[dev] = true;
  return 0;
}

template <typename T>
rdbm::ConvArgs<T> tile_args(int b, int h, int w) {
  rdbm::ConvArgs<T> args;
  args.h = h;
  args.w = w;
  args.tiles_x = (w + rdbm::TW - 1) / rdbm::TW;
  args.tiles_y = (h + rdbm::TH - 1) / rdbm::TH;
  args.ntiles = b * args.tiles_y * args.tiles_x;
  args.nseg = 0;
  args.nchunks = 0;
  return args;
}

// One launch of the dx tile over args' segments, nslices 32-column slices
// of output, with a stage's epilogue (DxEpilogue) or a split conv's term's
// (PartEpilogue).
template <typename T, typename Epi>
int launch_dx_tile(const rdbm::ConvArgs<T>& args, const Epi& epi,
                   int nslices, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  // a split conv's terms; a stage adding such terms; a plain stage
  constexpr bool TERMS = std::is_same<Epi, PartEpilogue>::value;
  constexpr bool ADDS = std::is_same<Epi, DxEpilogue<T, true>>::value;
  static int per_sm[rdbm::MAXCH + 1] = {0};
  static int per_sm_streamed[1] = {0};
  const size_t smem = rdbm::conv_smem_bytes<T>(args.nchunks);
  const auto grid = [&](auto kernel, auto& cache, int key) {
    return dim3((unsigned)rdbm::conv_grid_x(kernel, cache, key, smem,
                                            args.ntiles, nslices),
                (unsigned)nslices);
  };
  constexpr int T_ = rdbm::THREADS;
  if constexpr (F32) {
    if constexpr (TERMS)
      rdb_dx_part_tf32<<<grid(rdb_dx_part_tf32, per_sm, 0), T_, smem,
                         stream>>>(args, epi);
    else if constexpr (ADDS)
      rdb_dx_stage_part_tf32<<<grid(rdb_dx_stage_part_tf32, per_sm, 0), T_,
                               smem, stream>>>(args, epi);
    else
      rdb_dx_stage_tf32<<<grid(rdb_dx_stage_tf32, per_sm, 0), T_, smem,
                          stream>>>(args, epi);
  } else if (rdbm::bf16_streams(args.nchunks)) {
    if constexpr (TERMS)
      rdb_dx_part_streamed_mma<<<grid(rdb_dx_part_streamed_mma,
                                      per_sm_streamed, 0),
                                 T_, smem, stream>>>(args, epi);
    else if constexpr (ADDS)
      rdb_dx_streamed_stage_part_mma<<<grid(rdb_dx_streamed_stage_part_mma,
                                            per_sm_streamed, 0),
                                       T_, smem, stream>>>(args, epi);
    else
      rdb_dx_streamed_stage_mma<<<grid(rdb_dx_streamed_stage_mma,
                                       per_sm_streamed, 0),
                                  T_, smem, stream>>>(args, epi);
  } else {
    if constexpr (TERMS)
      rdb_dx_part_mma<<<grid(rdb_dx_part_mma, per_sm, args.nchunks), T_,
                        smem, stream>>>(args, epi);
    else if constexpr (ADDS)
      rdb_dx_stage_part_mma<<<grid(rdb_dx_stage_part_mma, per_sm,
                                   args.nchunks),
                              T_, smem, stream>>>(args, epi);
    else
      rdb_dx_stage_mma<<<grid(rdb_dx_stage_mma, per_sm, args.nchunks), T_,
                         smem, stream>>>(args, epi);
  }
  return (int)cudaGetLastError();
}

// dx stage k over the column runs [lo_i, lo_i + n_i) of dy_k (from G's
// column k * gc, and of W_k's columns), adding part (pitch part_pitch)
// before lrelu' (or + g) where it is not null. With no run, the
// epilogue alone.
template <typename T>
int launch_dx_stage(int k, const T* G, const T* wk, int nruns,
                    const int* run_lo, const int* run_n, const float* part,
                    int part_pitch, const T* act, T* dst, int dst_pitch,
                    int b, int h, int w, int nf, int gc,
                    cudaStream_t stream) {
  const int gw = 4 * gc + nf;
  const int cin = k == 0 ? nf : gc;
  const int ncols = gw - k * gc;  // columns of dy_k and of W_k
  if (nruns < 0 || nruns > rdbm::NSEG) return (int)cudaErrorInvalidValue;
  if (nruns == 0) {
    if (part == nullptr) return (int)cudaErrorInvalidValue;
    const long long npix = (long long)b * h * w;
    part_epilogue_kernel<T><<<(unsigned)((npix * (cin / 2) + 255) / 256), 256,
                              0, stream>>>(part, part_pitch, act, cin, dst,
                                           dst_pitch, k == 0, npix);
    return (int)cudaGetLastError();
  }
  rdbm::ConvArgs<T> args = tile_args<T>(b, h, w);
  args.nseg = nruns;
  for (int i = 0; i < nruns; ++i) {
    if (run_lo[i] % rdbm::KC || run_n[i] % rdbm::KC || run_n[i] < 1 ||
        run_lo[i] + run_n[i] > ncols)
      return (int)cudaErrorInvalidValue;
    rdbm::Segment<T>& sg = args.seg[i];
    sg.a = G + k * gc + run_lo[i];
    sg.a_pitch = gw;
    sg.w = wk + run_lo[i];
    sg.w_pitch = ncols;
    sg.w_tap = cin;
    sg.w_step = rdbm::KC;
    sg.nchunks = run_n[i] / rdbm::KC;
    args.nchunks += sg.nchunks;
  }
  const auto fill = [&](auto& epi) {
    epi.act = act;
    epi.ncols = cin;
    epi.dst = dst;
    epi.dst_pitch = dst_pitch;
    epi.last = k == 0;
    epi.h = h;
    epi.w = w;
    epi.part = part;
    epi.part_pitch = part_pitch;
  };
  if (part == nullptr) {
    DxEpilogue<T, false> epi;
    fill(epi);
    return launch_dx_tile<T>(args, epi, cin / rdbm::BN, stream);
  }
  DxEpilogue<T, true> epi;
  fill(epi);
  return launch_dx_tile<T>(args, epi, cin / rdbm::BN, stream);
}

template <typename T>
Stages make_stages(const void* x, void* const* cs, const void* const* wts,
                   int nf, int gc, const unsigned* live) {
  Stages st;
  st.off[0] = 0;
  for (int k = 0; k < 5; ++k) {
    st.w[k] = wts ? wts[k] : nullptr;
    st.act[k] = k == 0 ? x : cs[k - 1];
    st.cin[k] = k == 0 ? nf : gc;
    st.ncols[k] = 4 * gc + nf - k * gc;
    st.off[k + 1] = st.off[k] + 9 * st.cin[k] * st.ncols[k];
    st.live[k] = live ? live[k] : ~0u;
  }
  return st;
}

template <typename T>
int launch_dw(const Stages& st, const T* G, float* dw_part, float* dw, int b,
              int h, int w, int nf, int gc, int dw_splits,
              cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int gw = 4 * gc + nf;
  const int tiles_x = (w + rdbm::TW - 1) / rdbm::TW;
  const int tiles_y = (h + rdbm::TH - 1) / rdbm::TH;
  const int ntiles = b * tiles_y * tiles_x;
  const dim3 dw_grid((unsigned)dw_splits, (unsigned)count_dw_slots(nf, gc));
  if constexpr (F32)
    dw_tf32_kernel<<<dw_grid, DWT_THREADS, DWT_SMEM_BYTES, stream>>>(
        st, G, gw, gc, dw_part, h, w, tiles_x, tiles_y, ntiles, dw_splits);
  else
    dw_mma_kernel<<<dw_grid, DWM_THREADS, DWM_SMEM_BYTES, stream>>>(
        st, G, gw, gc, dw_part, h, w, tiles_x, tiles_y, ntiles, dw_splits);
  RDB_CHECK_LAUNCH();
  const int total = st.off[5];
  reduce_splits<<<(total + 255) / 256, 256, 0, stream>>>(dw_part, dw, total,
                                                         dw_splits);
  RDB_CHECK_LAUNCH();
  return 0;
}

template <typename T>
int launch_db(const T* G, const T* g, float* db_part, float* db, int b,
              int h, int w, int nf, int gc, int db_splits,
              cudaStream_t stream) {
  const int gw = 4 * gc + nf;
  const long long npix = (long long)b * h * w;
  const int rows = (int)((npix + db_splits - 1) / db_splits);
  colsum_kernel<T><<<db_splits, gw, 0, stream>>>(G, g, db_part, npix, nf, gw,
                                                 rows);
  RDB_CHECK_LAUNCH();
  reduce_splits<<<(gw + 255) / 256, 256, 0, stream>>>(db_part, db, gw,
                                                      db_splits);
  RDB_CHECK_LAUNCH();
  return 0;
}

template <typename T>
int launch_dc5(const T* g, T* G, int b, int h, int w, int nf, int gc,
               cudaStream_t stream) {
  const long long npix = (long long)b * h * w;
  dc5_kernel<T><<<(unsigned)((npix * (nf / 4) + 255) / 256), 256, 0,
                  stream>>>(g, G, npix, nf, 4 * gc + nf);
  RDB_CHECK_LAUNCH();
  return 0;
}

template <typename T>
int launch_bwd(const void* g_, const void* x_, void* const* cs,
               const void* const* wts, void* G_, float* dw_part,
               float* db_part, void* dx_, float* dw, float* db,
               int b, int h, int w, int nf, int gc, int dw_splits,
               int db_splits, cudaStream_t stream) {
  int e = configure_bwd<T>();
  if (e) return e;
  const T* g = static_cast<const T*>(g_);
  T* G = static_cast<T*>(G_);
  const int gw = 4 * gc + nf;
  if ((e = launch_dc5<T>(g, G, b, h, w, nf, gc, stream))) return e;
  for (int k = 4; k >= 0; --k) {
    // dy_k = G's columns from k*gc against the packed W_k as it lies
    const int lo = 0, n = gw - k * gc;
    e = launch_dx_stage<T>(
        k, G, static_cast<const T*>(wts[k]), 1, &lo, &n, nullptr, 0,
        k == 0 ? g : static_cast<const T*>(cs[k - 1]),
        k == 0 ? static_cast<T*>(dx_) : G + (k - 1) * gc, k == 0 ? nf : gw,
        b, h, w, nf, gc, stream);
    if (e) return e;
  }
  const Stages st = make_stages<T>(x_, cs, wts, nf, gc, nullptr);
  if ((e = launch_dw<T>(st, G, dw_part, dw, b, h, w, nf, gc, dw_splits,
                        stream)))
    return e;
  return launch_db<T>(G, g, db_part, db, b, h, w, nf, gc, db_splits, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. g, x, dx: (b, h, w, nf) NHWC; c1..c4:
// (b, h, w, gc); w0..w4: packed (9*cin, N) in the working type.
// Scratch, allocated by the caller: G (b*h*w, 4gc+nf) in the working type;
// dw_part (dw_splits x as many values as w0..w4 together) and db_part
// (db_splits x (4gc+nf)) f32. dw_splits must be what
// rdb5c_backward_dw_splits returns for the same call.
// Outputs: dx in the working type; dw: the five packed dW one after the
// other, f32; db: [db1|db2|db3|db4|db5], f32. nf and gc are multiples of
// 32, 4gc+nf <= 1024. Returns the first CUDA error, else 0.
int rdb5c_backward(int dtype, const void* g, const void* x,
                   void* c1, void* c2, void* c3, void* c4,
                   const void* w0, const void* w1, const void* w2,
                   const void* w3, const void* w4,
                   void* G, float* dw_part, float* db_part,
                   void* dx, float* dw, float* db,
                   int b, int h, int w, int nf, int gc,
                   int dw_splits, int db_splits, void* stream) {
  void* cs[4] = {c1, c2, c3, c4};
  const void* wts[5] = {w0, w1, w2, w3, w4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dw_splits != dw_split_count(dtype, b, h, w, nf, gc))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(g, x, cs, wts, G, dw_part, db_part, dx, dw, db,
                             b, h, w, nf, gc, dw_splits, db_splits, s);
  if (dtype == 1)
    return launch_bwd<bf16>(g, x, cs, wts, G, dw_part, db_part, dx, dw, db,
                            b, h, w, nf, gc, dw_splits, db_splits, s);
  return (int)cudaErrorInvalidValue;
}

// The pieces of the split backward (see the top of this file), in the
// layout of rdb5c_backward. dtype: 0 = float32, 1 = bfloat16.

// dc5 = 0.2 g into G's last nf columns.
int rdb5c_bwd_dc5(int dtype, const void* g, void* G, int b, int h, int w,
                  int nf, int gc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dc5<float>(static_cast<const float*>(g),
                             static_cast<float*>(G), b, h, w, nf, gc, s);
  if (dtype == 1)
    return launch_dc5<bf16>(static_cast<const bf16*>(g),
                            static_cast<bf16*>(G), b, h, w, nf, gc, s);
  return (int)cudaErrorInvalidValue;
}

// A split conv's term of one dx stage: dyw (pixels, win) in the working
// type, the conv's output gradient in a 32-column window (zeros outside
// the rank's columns), against the columns [c0, c0 + win) of the packed
// weight wk (9*cin, wpitch); the f32 sums into out (pixels, out_pitch),
// its first cin columns.
int rdb5c_bwd_part(int dtype, const void* dyw, const void* wk, float* out,
                   int win, int cin, int wpitch, int c0, int out_pitch,
                   int b, int h, int w, int nf, int gc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (win % rdbm::KC || cin % rdbm::BN || c0 % rdbm::KC || c0 < 0 ||
      c0 + win > wpitch)
    return (int)cudaErrorInvalidValue;
  PartEpilogue epi;
  epi.out = out;
  epi.out_pitch = out_pitch;
  epi.h = h;
  epi.w = w;
  auto run = [&](auto tag) -> int {
    using T = decltype(tag);
    const int e = configure_bwd<T>();
    if (e) return e;
    rdbm::ConvArgs<T> args = tile_args<T>(b, h, w);
    args.nseg = 1;
    rdbm::Segment<T>& sg = args.seg[0];
    sg.a = static_cast<const T*>(dyw);
    sg.a_pitch = win;
    sg.w = static_cast<const T*>(wk) + c0;
    sg.w_pitch = wpitch;
    sg.w_tap = cin;
    sg.w_step = rdbm::KC;
    sg.nchunks = win / rdbm::KC;
    args.nchunks = sg.nchunks;
    return launch_dx_tile<T>(args, epi, cin / rdbm::BN, s);
  };
  if (dtype == 0) return run(float());
  if (dtype == 1) return run(bf16());
  return (int)cudaErrorInvalidValue;
}

// dx stage k over nruns column runs of dy_k (run_lo, run_n: multiples of
// 32, relative to conv k's first column), plus part where it is not null;
// into dst (G's slot k-1 at pitch dst_pitch, or dx). act: c_k, or g.
int rdb5c_bwd_dx_stage(int dtype, const void* G, const void* wk, int k,
                       int nruns, const int* run_lo, const int* run_n,
                       const float* part, const void* act, void* dst,
                       int part_pitch, int dst_pitch, int last, int b, int h,
                       int w, int nf, int gc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 0 || k > 4 || last != (k == 0 ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto tag) -> int {
    using T = decltype(tag);
    const int e = configure_bwd<T>();
    if (e) return e;
    return launch_dx_stage<T>(k, static_cast<const T*>(G),
                              static_cast<const T*>(wk), nruns, run_lo, run_n,
                              part, part_pitch, static_cast<const T*>(act),
                              static_cast<T*>(dst), dst_pitch, b, h, w, nf,
                              gc, s);
  };
  if (dtype == 0) return run(float());
  if (dtype == 1) return run(bf16());
  return (int)cudaErrorInvalidValue;
}

// dW of the five stages with the slots of dead 32-column groups (live[k]
// bit c clear) written as zeros; dw_part as rdb5c_backward's.
int rdb5c_bwd_dw(int dtype, const void* G, const void* x, void* c1, void* c2,
                 void* c3, void* c4, float* dw_part, float* dw,
                 const unsigned* live, int dw_splits, int b, int h, int w,
                 int nf, int gc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* cs[4] = {c1, c2, c3, c4};
  if (dw_splits != dw_split_count(dtype, b, h, w, nf, gc))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto tag) -> int {
    using T = decltype(tag);
    const int e = configure_bwd<T>();
    if (e) return e;
    const Stages st = make_stages<T>(x, cs, nullptr, nf, gc, live);
    return launch_dw<T>(st, static_cast<const T*>(G), dw_part, dw, b, h, w,
                        nf, gc, dw_splits, s);
  };
  if (dtype == 0) return run(float());
  if (dtype == 1) return run(bf16());
  return (int)cudaErrorInvalidValue;
}

// db1..db5 as rdb5c_backward's.
int rdb5c_bwd_db(int dtype, const void* G, const void* g, float* db_part,
                 float* db, int db_splits, int b, int h, int w, int nf,
                 int gc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_db<float>(static_cast<const float*>(G),
                            static_cast<const float*>(g), db_part, db, b, h,
                            w, nf, gc, db_splits, s);
  if (dtype == 1)
    return launch_db<bf16>(static_cast<const bf16*>(G),
                           static_cast<const bf16*>(g), db_part, db, b, h, w,
                           nf, gc, db_splits, s);
  return (int)cudaErrorInvalidValue;
}

// The number of dW partials the kernel of this type writes for this shape:
// the caller sizes dw_part by it.
int rdb5c_backward_dw_splits(int dtype, int b, int h, int w, int nf, int gc) {
  return dw_split_count(dtype, b, h, w, nf, gc);
}

// Dynamic shared memory of the dW kernel of this type.
int rdb5c_backward_dw_smem_bytes(int dtype) {
  return (int)(dtype == 0 ? DWT_SMEM_BYTES : DWM_SMEM_BYTES);
}

const char* rdb5c_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
