// How Hopper's tensor cores add the products of one tf32 mma.sync.
//
// One mma.sync.m16n8k8 (tf32 in, f32 sums), the instruction of the f32
// block kernels' 3xTF32 (conv3x3_mma.cuh::mma_tf32), per case: D = A B + C
// with A 16x8, B 8x8, C and D 16x8, all row-major f32 in device memory. A
// case's inputs are chosen by the caller (chip_smoke.py's tf32 phase) so
// that the ways a unit may add eight products and the accumulator give
// different D: each product rounded or not, the terms aligned to the
// largest exponent with a few extra bits and the rest cut off, the sum
// rounded to nearest or towards zero. The CPU emulation of 3xTF32 in
// tests/test_torch_rdb5c_tf32.py follows what this reads.
//
// Not a kernel of any path: one warp per case, no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void tf32_mma_cases(const float* __restrict__ a,
                               const float* __restrict__ b,
                               const float* __restrict__ c,
                               float* __restrict__ d, int ncases) {
  const int cs = blockIdx.x;
  if (cs >= ncases) return;
  const int lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const float* A = a + cs * 128;
  const float* B = b + cs * 64;
  const float* C = c + cs * 128;
  float* D = d + cs * 128;
  // PTX's fragment layouts of m16n8k8 .tf32
  const uint32_t a0 = __float_as_uint(A[g * 8 + t]);
  const uint32_t a1 = __float_as_uint(A[(g + 8) * 8 + t]);
  const uint32_t a2 = __float_as_uint(A[g * 8 + t + 4]);
  const uint32_t a3 = __float_as_uint(A[(g + 8) * 8 + t + 4]);
  const uint32_t b0 = __float_as_uint(B[t * 8 + g]);
  const uint32_t b1 = __float_as_uint(B[(t + 4) * 8 + g]);
  float d0 = C[g * 8 + 2 * t], d1 = C[g * 8 + 2 * t + 1];
  float d2 = C[(g + 8) * 8 + 2 * t], d3 = C[(g + 8) * 8 + 2 * t + 1];
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  D[g * 8 + 2 * t] = d0;
  D[g * 8 + 2 * t + 1] = d1;
  D[(g + 8) * 8 + 2 * t] = d2;
  D[(g + 8) * 8 + 2 * t + 1] = d3;
}

}  // namespace

extern "C" {

// a, c, d: ncases x 16 x 8 f32; b: ncases x 8 x 8 f32. Returns the launch's
// CUDA error, else 0.
int tf32_mma_probe(const float* a, const float* b, const float* c, float* d,
                   int ncases, void* stream) {
  if (ncases <= 0) return (int)cudaErrorInvalidValue;
  tf32_mma_cases<<<ncases, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, d, ncases);
  return (int)cudaGetLastError();
}

}  // extern "C"
