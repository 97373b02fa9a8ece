// The bf16 tile of the residual dense block kernels (rdb5c.cu, rdb5c_bwd.cu)
// on Hopper's tensor cores: one 3x3 zero-padded implicit GEMM
//
//   r[pixel][col] = sum over chunks j, taps t, channels c < 32 of
//                   in_j[pixel + s_t][c] * B_j[t][c][col]
//
// with s_t = (t/3 - 1, t%3 - 1), f32 sums, and zeros for taps outside the
// image. It serves the forward stages of the TPU kernel
// trainner_tpu/ops/pallas_kernels.py::rdb5c_canvas and the dx stages of
// rdb5c_canvas_bwd; the f32 instantiations keep conv3x3_tile.cuh.
//
// Bound: operations (a block forward is 479,232 FLOPs per pixel against 512
// bytes of bf16 activations). What the earlier f32-FMA tile lost, and what
// this one does about it:
//  1. Tensor cores. Products are mma.sync.m16n8k16 (bf16 in, f32 sums in
//     registers); both operands reach the registers through ldmatrix, and
//     the build's SASS shows HMMA. The warpgroup form of the same tiling
//     (wgmma.m64n32k16, both operands through shared-memory descriptors
//     over 128-byte core matrices) was built and held against the plain
//     version too; it was no faster, because a conv of the block has only
//     32 output columns and a wgmma that narrow does not fill the tensor
//     cores, so the simpler form stays. PERF.md has both sets of times.
//  2. Shared-memory traffic. The A operand is one halo tile per 32-channel
//     chunk, pixel-major, bf16, exactly as NHWC has it: no transposition and
//     no widening. A pixel's 64 bytes sit at a pitch of 80, so eight
//     neighbouring pixels fall in eight different 16-byte bank groups. A
//     lane's ldmatrix row address is its pixel shifted by the tap, so the
//     nine taps are nine offsets into one tile and nothing is copied per tap.
//  3. Weights stationary. A block keeps its 32-column slice of the stage's
//     weights for all nine taps and all chunks in shared memory (18 KB per
//     chunk, XOR-swizzled rows of 64 bytes) and walks over pixel tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ... The slab of chunk j arrives
//     with the first tile's chunk j, so its load overlaps the first products.
//  4. No f32 scratch. The stage is a gather: each chunk names its own
//     activation (pointer, pitch) and its own rows of the packed weights, so
//     a forward stage reads [x|c1..ck] where they already lie and writes only
//     its own columns. Nothing is kept between stages but the bf16 features.
//  5. Overlap. Halo tiles come by 16-byte cp.async (source size 0 outside the
//     image, which is the zero padding) into a ring of three buffers: two
//     chunks are in flight while one is multiplied, across tile borders. The
//     addresses of a thread's pieces are worked out once per tile.
//  6. Grids. One launch takes min(tiles, blocks the card holds at once) per
//     column slice (two blocks per SM where the stage's weights leave room);
//     at b=32, 32x32 that is 128 or 2 x 66 blocks on 132 SMs.
//
// B_j comes from packed (9*cin, N) weights without a copy in device memory:
//   DX = false: B_j[t][c][n] = w_j[(t*w_tap + c) * w_pitch + n0 + n]
//               (k-major rows; fragments by ldmatrix.trans)
//   DX = true:  B_j[t][c][n] = w_j[((8-t)*w_tap + n0 + n) * w_pitch + c]
//               (the tap-flipped transpose; fragments by ldmatrix)
// with n0 = 32 * blockIdx.y.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rdbm {

typedef __nv_bfloat16 bf16;

constexpr int TH = 16;                     // output rows per tile
constexpr int TW = 16;                     // output columns per tile
constexpr int HW = TW + 2;                 // halo tile columns
constexpr int HPIX = (TH + 2) * HW;        // 324 halo pixels
constexpr int KC = 32;                     // channels per chunk
constexpr int BN = 32;                     // product columns per block
constexpr int PITCH = 80;                  // bytes per tile pixel: 64 + 16 of padding
constexpr int A_BYTES = HPIX * PITCH;      // one halo tile of one chunk
constexpr int W_BYTES = 9 * KC * BN * 2;   // one chunk's weights, nine taps
constexpr int NSTAGE = 3;                  // halo tiles in the ring
constexpr int MAXCH = 8;                   // chunks whose weights fit beside the ring
constexpr int THREADS = 256;               // 8 warps, each 2 tile rows x 32 columns

constexpr size_t conv_smem_bytes(int nchunks) {
  return (size_t)nchunks * W_BYTES + (size_t)NSTAGE * A_BYTES;
}

struct ChunkSrc {
  const bf16* a;   // activation: this chunk's first channel at pixel 0
  int a_pitch;     // values per pixel
  const bf16* w;   // packed weights: this chunk's first row and column
  int w_pitch;     // values per row
  int w_tap;       // rows per tap
};

struct ConvArgs {
  ChunkSrc ch[MAXCH];
  int nchunks;
  int h, w, tiles_x, tiles_y, ntiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte group q of row `row` in a tile of 64-byte rows:
// the group index is XORed with bits 1-2 of the row, so eight consecutive
// rows of one group fall in eight different bank groups.
__device__ __forceinline__ int swizzle64(int row, int q) {
  return row * 64 + ((q ^ ((row >> 1) & 3)) << 4);
}

// Where a thread's accumulators lie. acc[mt][nt][2*half + e] is the sum of
// tile row 2*warp + mt, tile column (lane >> 2) + 8*half, product column
// n0 + nt*8 + 2*(lane & 3) + e.
struct FragCoords {
  int row0, col0, n;
};

__device__ __forceinline__ FragCoords frag_coords() {
  const int lane = threadIdx.x & 31;
  FragCoords f;
  f.row0 = 2 * (threadIdx.x >> 5);
  f.col0 = lane >> 2;
  f.n = blockIdx.y * BN + 2 * (lane & 3);
  return f;
}

// Dynamic shared memory: conv_smem_bytes(args.nchunks). Block = THREADS
// threads; blockIdx.x < args.ntiles starts the walk over pixel tiles,
// blockIdx.y is the column slice. epi(acc, image, y0, x0) is called once
// per tile with the finished sums.
template <bool DX, typename Epilogue>
__device__ __forceinline__ void conv3x3_mma(const ConvArgs& args,
                                            const Epilogue& epi) {
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const uint32_t ws_base = smem_u32(smem_mma);
  const uint32_t as_base = ws_base + args.nchunks * W_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nch = args.nchunks;
  const int h = args.h, w = args.w;
  const int n0 = blockIdx.y * BN;
  const int step = gridDim.x;
  const int my_tiles = (args.ntiles - (int)blockIdx.x + step - 1) / step;
  const int nitems = my_tiles * nch;

  // the load cursor runs NSTAGE - 1 (tile, chunk) items ahead of the products
  int ld_item = 0, ld_chunk = 0, ld_tile = blockIdx.x;
  auto place = [&](int tile, int& bi, int& y0, int& x0) {
    x0 = (tile % args.tiles_x) * TW;
    tile /= args.tiles_x;
    y0 = (tile % args.tiles_y) * TH;
    bi = tile / args.tiles_y;
  };
  // A thread copies the 16-byte pieces tid, tid + THREADS, ... of a halo
  // tile (piece i: halo pixel i / 4, channels 8 * (i % 4) ..). Their image
  // pixels are the same for every chunk of a tile: ld_pix holds them, -1
  // outside the image.
  constexpr int PIECES = (HPIX * 4 + THREADS - 1) / THREADS;
  int ld_pix[PIECES];
  auto aim = [&](int tile) {
    int bi, y0, x0;
    place(tile, bi, y0, x0);
#pragma unroll
    for (int m = 0; m < PIECES; ++m) {
      const int hp = (tid + m * THREADS) >> 2;
      const int yy = y0 + hp / HW - 1;
      const int xx = x0 + hp % HW - 1;
      ld_pix[m] = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                      ? (bi * h + yy) * w + xx
                      : -1;
    }
  };
  aim(ld_tile);

  auto start_loads = [&]() {
    if (ld_item < nitems) {
      const ChunkSrc& c = args.ch[ld_chunk];
      const uint32_t abuf = as_base + (ld_item % NSTAGE) * A_BYTES;
#pragma unroll
      for (int m = 0; m < PIECES; ++m) {
        const int i = tid + m * THREADS;
        if (i < HPIX * 4) {
          const int q = i & 3;
          const bool inside = ld_pix[m] >= 0;
          cp_async16(abuf + (i >> 2) * PITCH + q * 16,
                     c.a + (inside ? (long long)ld_pix[m] * c.a_pitch : 0) +
                         q * 8,
                     inside ? 16 : 0);
        }
      }
      if (ld_item < nch) {  // first tile: this chunk's weights ride along
        const uint32_t wbuf = ws_base + ld_chunk * W_BYTES;
        for (int i = tid; i < 9 * KC * 4; i += THREADS) {
          const int q = i & 3;
          const int r = (i >> 2) & (KC - 1);
          const int t = i >> 7;
          const bf16* src =
              DX ? c.w + (long long)((8 - t) * c.w_tap + n0 + r) * c.w_pitch +
                       q * 8
                 : c.w + (long long)(t * c.w_tap + r) * c.w_pitch + n0 + q * 8;
          cp_async16(wbuf + swizzle64(t * KC + r, q), src, 16);
        }
      }
      ++ld_item;
      if (++ld_chunk == nch) {
        ld_chunk = 0;
        ld_tile += step;
        aim(ld_tile);
      }
    }
    cp_async_commit();
  };

  // per-lane parts of the ldmatrix row addresses
  const int mi = lane >> 3;  // which 8x8 matrix of an x4 this lane addresses
  // A: pixel lane & 15 of tile row 2*warp, k half lane >> 4
  const int a_lane = ((2 * warp) * HW + (lane & 15)) * PITCH + (lane >> 4) * 16;
  // B, x4 number p: column group nt = 2p + (mi >> 1), k half mi & 1
  const int b_sw = (lane & 7) >> 1;  // bits 1-2 of every row this lane reads

  float acc[2][4][4];
  int tile = blockIdx.x, chunk = 0;

#pragma unroll 1
  for (int s = 0; s < NSTAGE - 1; ++s) start_loads();

#pragma unroll 1
  for (int it = 0; it < nitems; ++it) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    start_loads();

    if (chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }

    const uint32_t abuf = as_base + (it % NSTAGE) * A_BYTES + a_lane;
    const uint32_t wbuf = ws_base + chunk * W_BYTES;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], abuf + ((mt + t / 3) * HW + t % 3) * PITCH +
                                 kk * 32);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int nt = 2 * p + (mi >> 1);
          if (DX) {
            const int row = t * KC + nt * 8 + (lane & 7);
            const int q = kk * 2 + (mi & 1);
            ldmatrix_x4(b[p], wbuf + row * 64 + ((q ^ b_sw) << 4));
          } else {
            const int row = t * KC + kk * 16 + (mi & 1) * 8 + (lane & 7);
            ldmatrix_x4_trans(b[p], wbuf + row * 64 + ((nt ^ b_sw) << 4));
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                     b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }

    if (++chunk == nch) {
      int bi, y0, x0;
      place(tile, bi, y0, x0);
      epi(acc, bi, y0, x0);
      chunk = 0;
      tile += step;
    }
  }
  cp_async_wait<0>();
}

// Blocks along x for one launch of `kernel` with `nchunks` chunks: as many
// as the card holds at once, shared among the column slices, and no more
// than there are tiles. per_sm is the caller's cache of that kernel's
// blocks per SM by number of chunks, zeros at first.
template <typename Kernel>
inline int conv_grid_x(Kernel kernel, int (&per_sm)[MAXCH + 1], int nchunks,
                       int ntiles, int nslices) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (!per_sm[nchunks]) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                  conv_smem_bytes(nchunks));
    per_sm[nchunks] = n > 0 ? n : 1;
  }
  int gx = sms * per_sm[nchunks] / nslices;
  if (gx < 1) gx = 1;
  return gx < ntiles ? gx : ntiles;
}

}  // namespace rdbm
