// Fused AMAT group-dequant + batched expert matmul for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels with one body, `amat_tiles`:
//  * `_amat_batched_kernel` in src/repro/kernels/amat_matmul/kernel.py
//    (entry points `amat_batched_matmul_pallas` and
//    `amat_batched_matmul_t_pallas`), with the output-major (`wo`) code
//    layout as the TRANSPOSED template flag: C entry `amat_batched_matmul`;
//  * `_amat_matmul_kernel` in the same file (`amat_matmul_pallas`, one
//    matrix, static mode 'high' | 'low'): C entry `amat_single_matmul`, the
//    K-major body at E = 1 with the precision passed by value;
//  * `_expert_matmul_kernel` in src/repro/kernels/expert_matmul/kernel.py
//    (`expert_matmul_pallas`, the batched function with the flag in a (1, 1)
//    block): C entry `amat_batched_matmul` on K-major codes.
//
//   out[e] = x[e] @ W_e                          (f32 accumulation)
//   W_e    = (c - z) * s                         if use_lsb[e]   (MSB+LSB)
//   W_e    = ((c >> shift) - (z >> shift)) * s * 2^shift   else  (MSB only)
//
// x [E, M, K] (f32 or bf16), codes [E, K, N] uint8 with N % 4 == 0 (the
// wrapper pads a ragged N; or codes_t [E, N, K] when TRANSPOSED), scales
// [E, K/G, N] f32, zps [E, K/G, N] uint8, use_lsb [E] uint8, out [E, M, N]
// f32.  The integer right shift equals the
// reference's floor(c * 2^-shift), so the dequantized weights are
// bit-identical to the plain version's; only the order of the f32 sums
// differs.
//
// What bounds it on an H100: bytes.  At the decode shapes of
// Qwen1.5-MoE-A2.7B (E=60, M=8, K=2048, N=2816 for `wi`) the codes alone are
// 346 MB against 5.5 GFLOP, about 16 FLOP per byte, far below the ~20
// FLOP/byte at which f32 CUDA-core arithmetic (67 TFLOP/s) would overtake
// HBM3 (3.35 TB/s).  The design therefore reads every code byte once, as
// uint8, and never writes a dequantized weight to device memory: a block
// dequantizes its [32, 256] weight tile straight into shared memory and
// every thread reads its column from there.  Each K tile is 32 rows, so it
// lies inside one quantization group (group_size % 32 == 0) and needs one
// scale and one zero-point per column.
//
// Layout of the work: grid (ceil(N/256), ceil(M/8), E); each block reads its
// own use_lsb[e] (the TPU kernel's scalar prefetch; the single-matrix entry
// takes the precision as a kernel argument), loops over K in 32-row
// tiles, stages the x tile and the dequantized weight tile in shared memory,
// and keeps 8 f32 accumulators per thread (one output column, 8 rows).  The
// ragged M and N edges are masked in the block.  No tensor cores, TMA or
// wgmma yet: this is the simple version that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;        // x rows per block: the decode capacity floor
constexpr int BN = 256;      // output columns per block, one per thread
constexpr int BK = 32;       // K rows per tile: one quantization group
constexpr int THREADS = BN;

static_assert(BM * BK == THREADS, "x tile is one element per thread");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One block's [BM, BN] output tile of x [M, K] @ W [K, N] for one matrix:
// `sh` and `mult` are its precision (0 and 1 for MSB+LSB; shift and
// 2^shift for MSB only).
template <typename XT, bool TRANSPOSED>
__device__ __forceinline__ void amat_tiles(const XT* __restrict__ xe,
                                           const uint8_t* __restrict__ ce,
                                           const float* __restrict__ se,
                                           const uint8_t* __restrict__ ze,
                                           float* __restrict__ oe, int M,
                                           int K, int N, int group_size,
                                           int sh, float mult) {
  __shared__ __align__(16) float xs[BM][BK];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const size_t meta = static_cast<size_t>(k0 / group_size) * N;

    // x tile [BM, BK], one element per thread, zero past the M edge.
    {
      const int r = tid / BK;
      const int kk = tid % BK;
      const int m = m0 + r;
      xs[r][kk] = (m < M) ? to_f32(xe[static_cast<size_t>(m) * K + k0 + kk])
                          : 0.f;
    }

    // Dequantized weight tile [BK, BN], zero past the N edge.
    if (TRANSPOSED) {
      // codes_t[n, k]: the tile's 32 codes of column n are contiguous
      // (two 16-byte loads); the transpose happens on the way into `ws`.
      const int n = n0 + tid;
      if (n < N) {
        const float s = se[meta + n] * mult;
        const int z = ze[meta + n] >> sh;
        const uint4* src =
            reinterpret_cast<const uint4*>(ce + static_cast<size_t>(n) * K + k0);
        const uint4 v0 = src[0];
        const uint4 v1 = src[1];
        const uint32_t words[8] = {v0.x, v0.y, v0.z, v0.w,
                                   v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const int c = (words[kk >> 2] >> (8 * (kk & 3))) & 0xff;
          ws[kk][tid] = static_cast<float>((c >> sh) - z) * s;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) ws[kk][tid] = 0.f;
      }
    } else {
      // codes[k, n], rows of N bytes (N % 4 == 0, padded by the
      // wrapper): 64 threads cover one 256-column row with 4-byte loads,
      // 4 rows per pass, 8 passes.
      const int c4 = tid & 63;
      const int rr = tid >> 6;
      const int n = n0 + 4 * c4;
      if (n < N) {
        float s[4];
        int z[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j] = se[meta + n + j] * mult;
          z[j] = ze[meta + n + j] >> sh;
        }
#pragma unroll
        for (int p = 0; p < BK / 4; ++p) {
          const int kk = rr + 4 * p;
          const uchar4 v = *reinterpret_cast<const uchar4*>(
              ce + static_cast<size_t>(k0 + kk) * N + n);
          float4 w;
          w.x = static_cast<float>((v.x >> sh) - z[0]) * s[0];
          w.y = static_cast<float>((v.y >> sh) - z[1]) * s[1];
          w.z = static_cast<float>((v.z >> sh) - z[2]) * s[2];
          w.w = static_cast<float>((v.w >> sh) - z[3]) * s[3];
          *reinterpret_cast<float4*>(&ws[kk][4 * c4]) = w;
        }
      } else {
#pragma unroll
        for (int p = 0; p < BK / 4; ++p) {
          *reinterpret_cast<float4*>(&ws[rr + 4 * p][4 * c4]) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    __syncthreads();

    // acc[r] += x[m0 + r, k0:k0+32] . W[k0:k0+32, n0 + tid]
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      const float w0 = ws[kk][tid];
      const float w1 = ws[kk + 1][tid];
      const float w2 = ws[kk + 2][tid];
      const float w3 = ws[kk + 3][tid];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[r][kk]);
        acc[r] = fmaf(xv.x, w0, acc[r]);
        acc[r] = fmaf(xv.y, w1, acc[r]);
        acc[r] = fmaf(xv.z, w2, acc[r]);
        acc[r] = fmaf(xv.w, w3, acc[r]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tid;
  if (n < N) {
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const int m = m0 + r;
      if (m < M) oe[static_cast<size_t>(m) * N + n] = acc[r];
    }
  }
}

template <typename XT, bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS)
amat_batched_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
                    const float* __restrict__ scales,
                    const uint8_t* __restrict__ zps,
                    const uint8_t* __restrict__ use_lsb,
                    float* __restrict__ out, int M, int K, int N,
                    int group_size, int shift) {
  const int e = blockIdx.z;
  // Per-expert precision: the low-bit path shifts code and zero-point and
  // scales by 2^shift; the high-bit path uses them as they are.
  const bool hi = use_lsb[e] != 0;
  const size_t G = K / group_size;
  amat_tiles<XT, TRANSPOSED>(
      x + static_cast<size_t>(e) * M * K, codes + static_cast<size_t>(e) * K * N,
      scales + e * G * N, zps + e * G * N, out + static_cast<size_t>(e) * M * N,
      M, K, N, group_size, hi ? 0 : shift,
      hi ? 1.0f : static_cast<float>(1 << shift));
}

template <typename XT>
__global__ void __launch_bounds__(THREADS)
amat_single_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
                   const float* __restrict__ scales,
                   const uint8_t* __restrict__ zps, float* __restrict__ out,
                   int M, int K, int N, int group_size, int sh, float mult) {
  amat_tiles<XT, false>(x, codes, scales, zps, out, M, K, N, group_size, sh,
                        mult);
}

template <typename XT>
void launch_batched(bool transposed, dim3 grid, cudaStream_t stream,
                    const void* x, const uint8_t* codes, const float* scales,
                    const uint8_t* zps, const uint8_t* use_lsb, float* out,
                    int M, int K, int N, int group_size, int shift) {
  const XT* xt = static_cast<const XT*>(x);
  if (transposed) {
    amat_batched_kernel<XT, true><<<grid, THREADS, 0, stream>>>(
        xt, codes, scales, zps, use_lsb, out, M, K, N, group_size, shift);
  } else {
    amat_batched_kernel<XT, false><<<grid, THREADS, 0, stream>>>(
        xt, codes, scales, zps, use_lsb, out, M, K, N, group_size, shift);
  }
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16.  Each entry returns the CUDA error
// code of its launch (0 on success); the caller checks it.

// Batched experts, per-expert precision use_lsb [E]; transposed = 1 reads
// output-major codes [E, N, K].
int amat_batched_matmul(const void* x, int x_dtype, const void* codes,
                        const void* scales, const void* zps,
                        const void* use_lsb, void* out, int E, int M, int K,
                        int N, int group_size, int shift, int transposed,
                        void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  const uint8_t* z = static_cast<const uint8_t*>(zps);
  const uint8_t* u = static_cast<const uint8_t*>(use_lsb);
  float* o = static_cast<float*>(out);
  switch (x_dtype) {
    case 0:
      launch_batched<float>(transposed != 0, grid, s, x, c, sc, z, u, o, M, K,
                            N, group_size, shift);
      break;
    case 1:
      launch_batched<__nv_bfloat16>(transposed != 0, grid, s, x, c, sc, z, u,
                                    o, M, K, N, group_size, shift);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One matrix: x [M, K] @ dequant(codes [K, N]) with a static precision,
// high = 1 for MSB+LSB ('high'), 0 for MSB only at `shift` ('low').
int amat_single_matmul(const void* x, int x_dtype, const void* codes,
                       const void* scales, const void* zps, void* out, int M,
                       int K, int N, int group_size, int shift, int high,
                       void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  const uint8_t* z = static_cast<const uint8_t*>(zps);
  float* o = static_cast<float*>(out);
  const int sh = high ? 0 : shift;
  const float mult = high ? 1.0f : static_cast<float>(1 << shift);
  switch (x_dtype) {
    case 0:
      amat_single_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), c, sc, z, o, M, K, N, group_size, sh,
          mult);
      break;
    case 1:
      amat_single_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), c, sc, z, o, M, K, N,
          group_size, sh, mult);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* amat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
