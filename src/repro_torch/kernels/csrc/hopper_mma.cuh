// Warp-level tensor-core and asynchronous-copy helpers for sm_90a, shared
// by the port's CUDA sources (inline PTX: `cp.async`, `ldmatrix`,
// `mma.sync m16n8k16` bf16 -> f32, `mma.sync m16n8k8` tf32 -> f32), and
// the host's once-per-device shared-memory opt-in.
//
// Fragment layouts of `mma.sync.m16n8k16.row.col` (g = lane / 4,
// q = lane % 4): A (16 x 16) a0 = row g, k 2q..2q+1; a1 = row g + 8;
// a2, a3 = the same at k + 8.  B (16 x 8) b0 = k 2q..2q+1 of column g,
// b1 = k + 8.  C (16 x 8) c0, c1 = row g, columns 2q, 2q+1; c2, c3 =
// row g + 8.
//
// `mma.sync.m16n8k8.row.col` tf32, one 32-bit value per register: A (16 x
// 8) a0 = row g, k q; a1 = row g + 8, k q; a2, a3 = the same at k q + 4.
// B (8 x 8) b0 = k q of column g, b1 = k q + 4.  C as above.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (the source
// is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += a (16x8, row) . b (8x8, col), tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero; the low 13 bits of the result are 0.  For finite x below the
// largest tf32 this is `cvt.rna.tf32.f32`, done as two integer
// instructions: half a tf32 ulp added to the magnitude bits, then the low
// 13 bits cleared (a carry into the exponent is the correct rounding).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo for tf32 products: hi = tf32_rna(x), lo = x - hi (exact in
// f32, |lo| <= 2^-11 |x|), passed as it is: a tf32 `mma` takes an
// operand's sign, exponent and top 10 mantissa bits, so the tensor cores
// see lo truncated to tf32, |x - hi - lo_tf32| < 2^-21 |x|.  Rounding lo
// as well costs two more integer instructions per value and changed no
// error on the card (PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Programmatic dependent launch: a primary grid lets the grid launched
// after it (with cudaLaunchAttributeProgrammaticStreamSerialization) start;
// that grid waits for the primary's completion and memory before reading.
__device__ __forceinline__ void launch_dependent_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` once per device
// (`done`: the caller's record for this kernel), so that a launch inside a
// CUDA graph capture makes no other API call than cudaGetDevice.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, size_t bytes,
                            bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

}  // namespace hopper
