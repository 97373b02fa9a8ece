// The tile of the residual dense block kernels (rdb5c.cu, rdb5c_bwd.cu) on
// Hopper's tensor cores: one 3x3 zero-padded implicit GEMM
//
//   r[pixel][col] = sum over chunks j, taps t, channels c < 32 of
//                   in_j[pixel + s_t][c] * B_j[t][c][col]
//
// with s_t = (t/3 - 1, t%3 - 1), f32 sums, and zeros for taps outside the
// image. It serves the forward stages of the TPU kernel
// trainner_tpu/ops/pallas_kernels.py::rdb5c_canvas and the dx stages of
// rdb5c_canvas_bwd, in both working types.
//
// Bound: operations (a block forward is 479,232 FLOPs per pixel against 512
// bytes of bf16 or 1 KB of f32 activations). The two types:
//  * bf16: mma.sync.m16n8k16 (bf16 in, f32 sums in registers), 989 TFLOP/s
//    peak. The warpgroup form of the same tiling (wgmma.m64n32k16) was built
//    and held against the plain version too; it was no faster, because a
//    conv of the block has only 32 output columns and a wgmma that narrow
//    does not fill the tensor cores, so the simpler form stays.
//  * f32: 3xTF32 on mma.sync.m16n8k8 (tf32 in, f32 sums). Each operand is
//    split a = hi + lo (hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi)) and
//    each product taken as lo*hi' + hi*lo' + hi*hi'; lo*lo' (about 2^-22
//    relative) is dropped. Each k-step's three products sum in an
//    accumulator of their own, added to the output's with a rounding FADD. Three products of a 495 TFLOP/s unit make 165
//    TFLOP/s of f32 work, against 67 on the CUDA cores. The tile is bound
//    by issuing those HMMAs and the split's ALU work (a cvt.rna is four
//    instructions, a split nine): an A fragment is split once per load and
//    used for all four n-tiles, and a chunk's weight slab is split once in
//    shared memory (hi in place, lo in a buffer beside the ring) rather
//    than by each of the eight warps that read it, which took 10 % off the
//    forward.
// What the tile does about the rest:
//  1. Shared-memory traffic. The A operand is one halo tile per 32-channel
//     chunk, pixel-major, exactly as NHWC has it: no transposition and no
//     widening. A pixel's 64 (bf16) or 128 (f32) bytes sit at a pitch 16
//     bytes longer, so eight neighbouring pixels fall in eight different
//     16-byte bank groups. A lane's ldmatrix row address is its pixel
//     shifted by the tap, so the nine taps are nine offsets into one tile.
//     On f32 data a non-transposed ldmatrix.x4 gives exactly the m16n8k8
//     tf32 A fragment (lane -> pixel lane/4, channel lane%4 of each 8x4
//     sub-tile), so both types read A the same way.
//  2. Weights. bf16: a block keeps its 32-column slice of the stage's
//     weights for all nine taps and all chunks in shared memory (18 KB per
//     chunk, XOR-swizzled rows of 64 bytes) where the stage has at most
//     MAXCH chunks. A wider stage (nf + 4gc > 256: the last forward stage,
//     the first dx stages) streams each chunk's slab through the ring
//     beside its halo tile instead (STREAM: three 44,352-byte slots, the
//     slab from L2, where it stays hot), which takes every width; the
//     stationary form stays as it was where it fits. f32: one chunk's slab
//     is 36 KB, so the widest stage's would not fit beside a halo tile; f32
//     always streams, its lo halves in one more slab beside the ring
//     (203,904 bytes).
//     There is no 32-bit ldmatrix.trans, so f32 B fragments come by 32-bit
//     loads from rows of 128 bytes whose 16-byte groups are XOR-swizzled so
//     that a warp's 32 loads hit 32 banks, k-major rows for the forward and
//     n-major rows for dx.
//  3. No f32 scratch. The stage is a gather: each segment of chunks names
//     its own activation (pointer, pitch) and its own rows of the packed
//     weights, so a forward stage reads [x|c1..ck] where they already lie
//     and writes only its own columns.
//  4. Overlap. Halo tiles (and the streamed slabs) come by 16-byte cp.async
//     (source size 0 outside the image, which is the zero padding) into a
//     ring: three bf16 halo tiles, three bf16 (halo tile, slab) pairs, or
//     two f32 pairs. One
//     load is in flight while a chunk is multiplied, across tile borders.
//  5. Grids. Persistent blocks walk over pixel tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ...; one launch takes min(tiles, blocks the
//     card holds at once) per column slice.
//
// B_j comes from packed (9*cin, N) weights without a copy in device memory:
//   DX = false: B_j[t][c][n] = w_j[(t*w_tap + c) * w_pitch + n0 + n]
//               (k-major rows; bf16 fragments by ldmatrix.trans)
//   DX = true:  B_j[t][c][n] = w_j[((8-t)*w_tap + n0 + n) * w_pitch + c]
//               (the tap-flipped transpose, n-major; bf16 by ldmatrix)
// with n0 = 32 * blockIdx.y.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rdbm {

typedef __nv_bfloat16 bf16;

// a kernel's dynamic shared-memory limit is an attribute of each card:
// a process that launches on several cards sets it once on each
constexpr int MAX_DEVICES = 64;
constexpr int TH = 16;                     // output rows per tile
constexpr int TW = 16;                     // output columns per tile
constexpr int HW = TW + 2;                 // halo tile columns
constexpr int HPIX = (TH + 2) * HW;        // 324 halo pixels
constexpr int KC = 32;                     // channels per chunk
constexpr int BN = 32;                     // product columns per block
constexpr int THREADS = 256;               // 8 warps, each 2 tile rows x 32 columns
// bf16
constexpr int PITCH = 80;                  // bytes per tile pixel: 64 + 16 of padding
constexpr int A_BYTES = HPIX * PITCH;      // one halo tile of one chunk
constexpr int W_BYTES = 9 * KC * BN * 2;   // one chunk's weights, nine taps
constexpr int NSTAGE = 3;                  // halo tiles in the ring
constexpr int MAXCH = 8;                   // chunks whose weights fit beside the ring
constexpr int STREAM_SLOT_BYTES = A_BYTES + W_BYTES;  // streamed: halo tile + its slab
constexpr int STREAM_NSTAGE = 3;           // slots in the streamed ring
// f32
constexpr int F32_PITCH = 144;             // bytes per tile pixel: 128 + 16 of padding
constexpr int F32_A_BYTES = HPIX * F32_PITCH;
constexpr int F32_W_BYTES = 9 * KC * BN * 4;
constexpr int F32_SLOT_BYTES = F32_A_BYTES + F32_W_BYTES;  // halo tile + its slab
constexpr int F32_NSTAGE = 2;              // slots in the ring
// the ring, then the lo halves of the slab being multiplied
constexpr int F32_SMEM_BYTES = F32_NSTAGE * F32_SLOT_BYTES + F32_W_BYTES;
constexpr int NSEG = 5;                    // activations a stage reads at most

// Whether a bf16 stage over nchunks chunks streams its weights.
constexpr bool bf16_streams(int nchunks) { return nchunks > MAXCH; }

template <typename T>
constexpr size_t conv_smem_bytes(int nchunks) {
  return std::is_same<T, float>::value ? (size_t)F32_SMEM_BYTES
         : bf16_streams(nchunks)
             ? (size_t)STREAM_NSTAGE * STREAM_SLOT_BYTES
             : (size_t)nchunks * W_BYTES + (size_t)NSTAGE * A_BYTES;
}

// Chunks j < nchunks of one activation: chunk j reads channels a + 32j and
// the weights from w + j * w_step on.
template <typename T>
struct Segment {
  const T* a;      // activation: first chunk's first channel at pixel 0
  const T* w;      // packed weights: first chunk's first row and column
  int a_pitch;     // values per pixel
  int w_pitch;     // values per weight row
  int w_tap;       // weight rows per tap
  int w_step;      // values from one chunk's weights to the next's
  int nchunks;
};

template <typename T>
struct ConvArgs {
  Segment<T> seg[NSEG];
  int nseg, nchunks;  // nchunks: over all segments
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

// d (16x8, f32) += a (16x8, tf32, row) * b (8x8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo in tf32: hi rounded to nearest (ties away) on the 13 dropped
// mantissa bits, lo the same of the exact remainder.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  const float f = __uint_as_float(x);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(f));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(f - __uint_as_float(hi)));
}

// d += a * b in 3xTF32, the small products first. The three mmas sum into
// a zeroed accumulator and that sum goes onto d with an FADD: an mma cuts
// its running sum towards zero, so on d itself the cut of every one of a
// conv's up to 648 steps leaned the same way and the block's output with
// them; the FADD rounds to nearest, and the cuts inside one k-step are
// small beside d.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, alo, bhi[0], bhi[1]);
  mma_tf32(p, ahi, blo[0], blo[1]);
  mma_tf32(p, ahi, bhi[0], bhi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += p[e];
}

// Byte offset of 16-byte group q of row `row` in a tile of 64-byte rows:
// the group index is XORed with bits 1-2 of the row, so eight consecutive
// rows of one group fall in eight different bank groups.
__device__ __forceinline__ int swizzle64(int row, int q) {
  return row * 64 + ((q ^ ((row >> 1) & 3)) << 4);
}

// Byte offset of 16-byte group q of row `row` in an f32 slab of 128-byte
// rows. k-major rows (the forward) XOR q with 2 * (row % 4): the four k of
// a fragment load lie in four rows, each lane pair of one row in its own
// group pair. n-major rows (dx) XOR q with row % 8: the eight n of a
// fragment load lie in eight rows.
template <bool DX>
__device__ __forceinline__ int swizzle128(int row, int q) {
  return row * 128 + ((q ^ (DX ? row & 7 : (row & 3) << 1)) << 4);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// bf16: one chunk's 32-column slice of the weights, nine taps, into
// XOR-swizzled rows of 64 bytes. Out of line: it runs on a block's first
// tile only, and inlined it made the dx stage's main loop 53 instructions
// longer and the stage 3-5 % slower (the instruction cache, by all signs).
template <bool DX>
__device__ __noinline__ void load_w_slab(uint32_t wbuf, const bf16* w,
                                         int w_tap, int w_pitch, int n0) {
  for (int i = threadIdx.x; i < 9 * KC * 4; i += THREADS) {
    const int q = i & 3;
    const int r = (i >> 2) & (KC - 1);
    const int t = i >> 7;
    const bf16* src =
        DX ? w + (long long)((8 - t) * w_tap + n0 + r) * w_pitch + q * 8
           : w + (long long)(t * w_tap + r) * w_pitch + n0 + q * 8;
    cp_async16(wbuf + swizzle64(t * KC + r, q), src, 16);
  }
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

// Dynamic shared memory: conv_smem_bytes<T>(args.nchunks). Block = THREADS
// threads; blockIdx.x < args.ntiles starts the walk over pixel tiles,
// blockIdx.y is the column slice. epi(acc, image, y0, x0) is called once
// per tile with the finished sums. STREAM (bf16 only, where
// bf16_streams(args.nchunks)): the weights ride through the ring.
template <bool DX, bool STREAM, typename T, typename Epilogue>
__device__ __forceinline__ void conv3x3_mma(const ConvArgs<T>& args,
                                            const Epilogue& epi) {
  constexpr bool F32 = std::is_same<T, float>::value;
  static_assert(!(F32 && STREAM), "f32 always streams, in its own ring");
  // 16-byte pieces per pixel, 1 << PSH: shifts and masks keep the piece
  // arithmetic free of the sign fix-ups a signed / or % would add to
  // every cp.async
  const int PSH = F32 ? 3 : 2;
  const int PPX = 1 << PSH;
  const int VPP = 16 / (int)sizeof(T);       // values per piece
  const int APITCH = F32 ? F32_PITCH : PITCH;
  const int NST = F32 ? F32_NSTAGE : STREAM ? STREAM_NSTAGE : NSTAGE;
  const int SLOT = F32 ? F32_SLOT_BYTES : STREAM ? STREAM_SLOT_BYTES : A_BYTES;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  // bf16: the stage's weights, then the ring of halo tiles; streamed bf16
  // and f32: the ring, each slot a halo tile and its chunk's weights
  const uint32_t base = smem_u32(smem_mma);
  const uint32_t ring = F32 || STREAM ? base : base + args.nchunks * W_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nch = args.nchunks;
  const int h = args.h, w = args.w;
  const int n0 = blockIdx.y * BN;
  const int step = gridDim.x;
  const int my_tiles = (args.ntiles - (int)blockIdx.x + step - 1) / step;
  const int nitems = my_tiles * nch;

  // the load cursor runs NST - 1 (tile, chunk) items ahead of the products
  int ld_item = 0, ld_seg = 0, ld_sub = 0, ld_tile = blockIdx.x;
  auto place = [&](int tile, int& bi, int& y0, int& x0) {
    x0 = (tile % args.tiles_x) * TW;
    tile /= args.tiles_x;
    y0 = (tile % args.tiles_y) * TH;
    bi = tile / args.tiles_y;
  };
  // A thread copies the 16-byte pieces tid, tid + THREADS, ... of a halo
  // tile (piece i: halo pixel i / PPX, values VPP * (i % PPX) ..). Their
  // image pixels are the same for every chunk of a tile: ld_pix holds them,
  // -1 outside the image.
  const int PIECES = (HPIX * PPX + THREADS - 1) / THREADS;
  int ld_pix[PIECES];
  auto aim = [&](int tile) {
    int bi, y0, x0;
    place(tile, bi, y0, x0);
#pragma unroll
    for (int m = 0; m < PIECES; ++m) {
      const int hp = (tid + m * THREADS) >> PSH;
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
      const Segment<T>& sg = args.seg[ld_seg];
      const T* a = sg.a + ld_sub * KC;
      const T* wsrc = sg.w + (long long)ld_sub * sg.w_step;
      const uint32_t abuf = ring + (ld_item % NST) * SLOT;
#pragma unroll
      for (int m = 0; m < PIECES; ++m) {
        const int i = tid + m * THREADS;
        if (i < HPIX * PPX) {
          const int q = i & (PPX - 1);
          const bool inside = ld_pix[m] >= 0;
          cp_async16(abuf + (i >> PSH) * APITCH + q * 16,
                     a + (inside ? (long long)ld_pix[m] * sg.a_pitch : 0) +
                         q * VPP,
                     inside ? 16 : 0);
        }
      }
      if constexpr (F32) {
        // this chunk's slab, beside its halo tile, for every tile
        const uint32_t wbuf = abuf + F32_A_BYTES;
#pragma unroll 3
        for (int i = tid; i < 9 * KC * 8; i += THREADS) {
          const int q = i & 7;
          const int r = (i >> 3) & (KC - 1);
          const int t = i >> 8;
          const T* src =
              DX ? wsrc + (long long)((8 - t) * sg.w_tap + n0 + r) * sg.w_pitch +
                       q * 4
                 : wsrc + (long long)(t * sg.w_tap + r) * sg.w_pitch + n0 +
                       q * 4;
          cp_async16(wbuf + swizzle128<DX>(t * KC + r, q), src, 16);
        }
      } else if constexpr (STREAM) {  // this chunk's slab, every tile
        load_w_slab<DX>(abuf + A_BYTES, wsrc, sg.w_tap, sg.w_pitch, n0);
      } else if (ld_item < nch) {  // first tile: this chunk's weights ride along
        load_w_slab<DX>(base + ld_item * W_BYTES, wsrc, sg.w_tap, sg.w_pitch,
                        n0);
      }
      ++ld_item;
      if (++ld_sub == sg.nchunks) {
        ld_sub = 0;
        if (++ld_seg == args.nseg) {
          ld_seg = 0;
          ld_tile += step;
          aim(ld_tile);
        }
      }
    }
    cp_async_commit();
  };

  // A's ldmatrix row address: pixel lane & 15 of tile row 2*warp, k half
  // lane >> 4
  const int a_lane =
      ((2 * warp) * HW + (lane & 15)) * APITCH + (lane >> 4) * 16;

  float acc[2][4][4];
  int tile = blockIdx.x, chunk = 0;

#pragma unroll 1
  for (int s = 0; s < NST - 1; ++s) start_loads();

#pragma unroll 1
  for (int it = 0; it < nitems; ++it) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    start_loads();

    const uint32_t slot = ring + (it % NST) * SLOT;
    const uint32_t abuf = slot + a_lane;
    if constexpr (F32) {
      // this chunk's slab split once: tf32 hi in place, lo beside the ring
      uint4* whi =
          reinterpret_cast<uint4*>(smem_mma + (slot - base) + F32_A_BYTES);
      uint4* wlo = reinterpret_cast<uint4*>(smem_mma + F32_NSTAGE *
                                                           F32_SLOT_BYTES);
#pragma unroll 3
      for (int i = tid; i < F32_W_BYTES / 16; i += THREADS) {
        const uint4 v = whi[i];
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        whi[i] = hi;
        wlo[i] = lo;
      }
      __syncthreads();
    }

    if (chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }

    if constexpr (F32) {
      // B: lane reads k = lane & 3 (+4) of column lane >> 2 of each n-tile
      const int g = lane >> 2, t4 = lane & 3;
      const unsigned char* whi = smem_mma + (slot - base) + F32_A_BYTES;
      const unsigned char* wlo = smem_mma + F32_NSTAGE * F32_SLOT_BYTES;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t ahi[2][4], alo[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, abuf + ((mt + t / 3) * HW + t % 3) * APITCH +
                               kk * 32);
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(a[e], ahi[mt][e], alo[mt][e]);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            uint32_t bhi[2], blo[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // k = 8kk + 4e + t4, n = 8nt + g
              const int off =
                  DX ? swizzle128<true>(t * KC + nt * 8 + g, 2 * kk + e) + t4 * 4
                     : swizzle128<false>(t * KC + kk * 8 + e * 4 + t4,
                                         2 * nt + (g >> 2)) +
                           (g & 3) * 4;
              bhi[e] = *reinterpret_cast<const uint32_t*>(whi + off);
              blo[e] = *reinterpret_cast<const uint32_t*>(wlo + off);
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_3xtf32(acc[mt][nt], ahi[mt], alo[mt], bhi, blo);
          }
        }
      }
    } else {
      // B, x4 number p: column group nt = 2p + (mi >> 1), k half mi & 1
      const int mi = lane >> 3;  // the 8x8 matrix of an x4 this lane addresses
      const int b_sw = (lane & 7) >> 1;  // bits 1-2 of every row it reads
      const uint32_t wbuf = STREAM ? slot + A_BYTES : base + chunk * W_BYTES;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t a[2][4], b[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(a[mt], abuf + ((mt + t / 3) * HW + t % 3) * APITCH +
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

// Blocks along x for one launch of `kernel` with `smem` bytes of dynamic
// shared memory: as many as the card holds at once, shared among the
// column slices, and no more than there are tiles. per_sm is the caller's
// cache of that kernel's blocks per SM, indexed by `key` (the number of
// chunks where it decides the shared memory), zeros at first.
template <typename Kernel, int N>
inline int conv_grid_x(Kernel kernel, int (&per_sm)[N], int key, size_t smem,
                       int ntiles, int nslices) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (!per_sm[key]) {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem);
    per_sm[key] = n > 0 ? n : 1;
  }
  int gx = sms * per_sm[key] / nslices;
  if (gx < 1) gx = 1;
  return gx < ntiles ? gx : ntiles;
}

}  // namespace rdbm
