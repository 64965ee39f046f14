// Fused AMAT group-dequant + matmuls for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels:
//  * `_amat_batched_kernel` in src/repro/kernels/amat_matmul/kernel.py
//    (entry points `amat_batched_matmul_pallas` and
//    `amat_batched_matmul_t_pallas`), with the output-major (`wo`) code
//    layout as the TRANSPOSED template flag: C entry `amat_batched_matmul`.
//    Both types of x run on the tensor cores
//    (`amat_batched_mma_kernel<MT, TRANSPOSED, NP>`): bf16 x as it is
//    (NP = 1), f32 x as three exact bf16 planes (NP = 3, below);
//  * `_amat_matmul_kernel` in the same file (`amat_matmul_pallas`, one
//    matrix, static mode 'high' | 'low'): C entry `amat_single_matmul`.
//    Both types of x run on the tensor cores (`amat_single_mma_kernel`):
//    bf16 x as it is, f32 x as three exact bf16 planes;
//  * `_expert_matmul_kernel` in src/repro/kernels/expert_matmul/kernel.py
//    (`expert_matmul_pallas`, the batched function with the flag in a (1, 1)
//    block): C entry `amat_batched_matmul` on K-major codes.
// Every kernel that multiplies runs one body, `amat_mma_tiles`.
//
//   out[e] = x[e] @ W_e                          (f32 accumulation)
//   W_e    = (c - z) * s                         if use_lsb[e]   (MSB+LSB)
//   W_e    = ((c >> shift) - (z >> shift)) * s * 2^shift   else  (MSB only)
//
// x [E, M, K] (f32 or bf16), codes [E, K, N] uint8 (or codes_t [E, N, K]
// when TRANSPOSED), scales [E, K/G, N] f32, zps [E, K/G, N] uint8, use_lsb
// [E] uint8, out [E, M, N] f32; the wrapper pads a ragged N to a multiple
// of 16.  The integer right shift equals the reference's floor(c *
// 2^-shift), so the dequantized weights are bit-identical to the plain
// version's; only the order of the f32 sums differs.
//
// What bounds them on an H100: bytes.  At the decode shapes of
// Qwen1.5-MoE-A2.7B (E=60, M=8, K=2048, N=2816 for `wi`) the codes alone are
// 346 MB against 5.5 GFLOP (16.6 GFLOP of bf16 work for the three planes
// of f32 x), at most 48 FLOP per byte, far below the ~300 FLOP/byte at
// which bf16 tensor work (989 TFLOP/s) would overtake HBM3 (3.35 TB/s).
// Every kernel here therefore reads every code byte once, as uint8, and
// never writes a dequantized weight to device memory.  One matrix at
// prefill sizes with f32 x (M=128, K=2048, N=2816) is the exception: its
// three bf16 products (4.4 GFLOP) outlast its 9.2 MB of traffic.
//
// The design:
//  * each weight is an integer of at most 8 bits, (c - z) or (c >> s) -
//    (z >> s), exact in bf16, and x is bf16, so each 32-row group's
//    product runs exactly on the tensor cores (`mma.sync m16n8k16` bf16 ->
//    f32, x fragments by `ldmatrix`) into a group accumulator; the group's
//    scale (times 2^shift in MSB-only) applies after it in f32;
//  * a block owns 64 columns and up to 128 rows of M (8 warps: two along
//    M from 32 rows up, the rest along the columns), so a code is read
//    from device memory once per block and dequantized by the warps that
//    own its column (one or two per block), straight from the code tile in
//    shared memory into their B fragments in registers: no bf16 tile and
//    no second barrier per chunk.  Output-major codes hold the two k rows
//    of a fragment register side by side: one 16-bit load;
//  * x, codes, scales and zero-points arrive by 16-byte `cp.async` in a
//    ring of chunks of 32 rows; a barrier admits 2 or 4 chunks at once
//    while the next two batches are in flight;
//  * batched experts (`amat_batched_mma_kernel`): the expert is blockIdx.z
//    and each block reads its own use_lsb[e] (the TPU kernel's scalar
//    prefetch) and runs the whole of K; at the decode shapes the grid is
//    44 x 60 blocks (`wi`), 32 x 60 (`wo`), many per SM;
//  * f32 x (NP = 3 of either kernel): a split pass (`split_planes_kernel`)
//    writes x as three bf16 planes, hi = bf16(x), mid = bf16(x - hi), lo =
//    bf16(x - hi - mid).  Each subtraction is exact in f32 and after two
//    of them at most 8 significant bits are left, so hi + mid + lo == x
//    exactly (subnormals aside), and each plane's product with an integer
//    weight is exact in the f32 accumulator: the planes' bf16 products
//    into the same group accumulator, against the same B fragments, differ
//    from the plain version only in the order of the f32 sums.  The pass
//    runs flat over all of x, so the planes lie [3][x's shape] and the
//    body reads plane p one plane stride (the size of x) after plane 0:
//    one pass for both kernels, and the batched kernel offsets x by expert
//    alone.  Three planes triple the x tiles in shared memory, so this
//    route takes at most 4 m16 tiles per block; a block of one m16 tile
//    takes 8 rows, hi and mid packed into one m16 tile and lo into a
//    second (`TcWarps::PACKED`), two products per k16 step for the decode
//    batch.  The multiplying kernel is launched as a programmatic
//    dependent of the split pass;
//  * one matrix (`amat_single_mma_kernel`): its 44 column blocks would
//    fill a third of the 132 SMs, so K is split across blocks in whole
//    groups (blockIdx.z) to reach two blocks per SM; each split writes
//    f32 partials [splits, M, N] and `sum_splits_kernel` adds them in
//    split order: deterministic, no atomics.  The sum is launched as a
//    programmatic dependent of the main kernel, which hides its launch.
// Ragged M rows and columns past N arrive as zeros (cp.async zero-fill)
// and are not stored; these kernels take N % 16 == 0 (the wrapper pads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int BK = 32;             // K rows per chunk: one quantization group
constexpr int TC_BN = 64;          // output columns per block
constexpr int TC_THREADS = 256;    // 8 warps
constexpr int TC_LDX = BK + 8;     // x tile row: 40 bf16 (80 bytes)
constexpr int TC_LDC = TC_BN + 16; // K-major code tile row: 80 bytes
constexpr int TC_LDT = BK + 16;    // output-major code tile row: 48 bytes
constexpr int SUM_THREADS = 256;
constexpr int SUM_BATCH = 8;       // partials loaded before they are added
constexpr int SPLIT_THREADS = 256;

// The warps of a block: two along M when the block has two or more m16
// tiles, the rest along its 64 columns.
template <int MT, int NP>
struct TcWarps {
  static constexpr int WM = MT >= 2 ? 2 : 1;   // warps along M
  static constexpr int WN = 8 / WM;            // warps along N
  static constexpr int MW = MT / WM;           // m16 tiles per warp
  static constexpr int COLS = TC_BN / WN;      // columns per warp: 8 or 16
  static constexpr int NT = COLS / 8;          // n8 tiles per warp
  // One m16 tile of three planes covers 8 rows of x, packed into two m16
  // tiles, hi over mid and lo over zeros: a k16 step takes two products
  // and two `ldmatrix`, not three, the stage is a third smaller, and the
  // decode batch (8 rows) fills the tiles instead of half of three.  Each
  // lane's row g + 8 result is then its row g's mid product.  The rows of
  // x a block covers, and the m16 tiles of x a stage holds.
  static constexpr bool PACKED = NP == 3 && MT == 1;
  static constexpr int ROWS = PACKED ? 8 : 16 * MT;
  static constexpr int XT = PACKED ? 2 : NP;
  // Chunks of 32 rows a block computes between two barriers (independent
  // chains for the warps' schedulers), and the ring of chunks: two
  // iterations' chunks in flight while one iteration computes (49 KB of
  // shared memory at one m16 tile, 77 KB at eight; 55 and 80 KB with
  // output-major codes).  Three planes do two or three times the tensor
  // work per chunk, so 2 chunks suffice (32, 62 and 107 KB at 1, 2 and 4
  // m16 tiles; at one tile five blocks per SM, as many as 48 registers
  // allow, where 4 chunks, 65 KB and three blocks, took 4-7% longer on
  // an H100).
  static constexpr int CPI = (MT <= 2 && NP == 1) ? 4 : 2;
  static constexpr int STAGES = 3 * CPI;
};

// One slot of the ring: a chunk of 32 rows of K.  Padded rows: the 8 rows
// an `ldmatrix` of x reads fall in 8 distinct 16-byte bank groups.  K-major
// codes are [32 k][64 n] and the 4 code rows 2q (q = lane % 4) a B
// fragment gathers fall in 4 distinct banks; output-major codes are [64 n]
// [32 k] in rows of 48 bytes (16-byte aligned `cp.async` destinations), so
// the 8 columns g a fragment gathers start at words 12 g mod 32 and, with
// the 2 words of their k pairs, fall in 16 distinct banks.  NP planes of
// x: 1 for bf16 x, 3 for the exact bf16 planes of f32 x, in XT m16 tiles.
template <int MT, bool TRANSPOSED, int NP>
struct __align__(16) TcStage {
  __nv_bfloat16 x[TcWarps<MT, NP>::XT][16 * MT][TC_LDX];  // 32 of K
  uint8_t codes[TRANSPOSED ? TC_BN : BK][TRANSPOSED ? TC_LDT : TC_LDC];
  float scales[TC_BN];
  uint8_t zps[TC_BN];
};

template <int MT, bool TRANSPOSED, int NP>
constexpr size_t tc_smem_bytes() {
  return TcWarps<MT, NP>::STAGES * sizeof(TcStage<MT, TRANSPOSED, NP>);
}

// The body of both tensor-core kernels: rows m0 .. m0 + ROWS of x [M, K]
// against columns n0 .. n0+64 of one matrix's codes ([K, N], or [N, K]
// when TRANSPOSED; metadata [K/G, N]), over quantization groups [g_begin,
// g_end), the sums written to dst [M, N].  `sh` and `mult` are the
// precision (0 and 1 for MSB+LSB; shift and 2^shift for MSB only).  Each
// warp builds the B fragments of its columns straight from the code tile
// in registers (each weight an exact bf16 integer), so one barrier per CPI
// chunks suffices.  x holds NP planes of [M, K], plane p at x + p *
// plane_stride (unused for NP = 1); each plane's product goes into the
// same group accumulator.
template <int MT, bool TRANSPOSED, int NP>
__device__ __forceinline__ void amat_mma_tiles(
    unsigned char* smem, const __nv_bfloat16* __restrict__ x,
    size_t plane_stride, const uint8_t* __restrict__ codes,
    const float* __restrict__ scales, const uint8_t* __restrict__ zps,
    float* __restrict__ dst, int M, int K, int N, int group_size,
    int g_begin, int g_end, int sh, float mult) {
  using W = TcWarps<MT, NP>;
  using Stage = TcStage<MT, TRANSPOSED, NP>;
  constexpr int STAGES = W::STAGES;
  constexpr int CPI = W::CPI;
  Stage* st = reinterpret_cast<Stage*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / W::WN;
  const int wn = warp % W::WN;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int n0 = blockIdx.x * TC_BN;
  const int m0 = blockIdx.y * W::ROWS;
  const int per_group = group_size / BK;
  const int c_begin = g_begin * per_group;
  const int n_chunks = (g_end - g_begin) * per_group;

  // Chunk c (32 rows of K, inside one group) into ring slot `slot`.
  auto load = [&](int c, int slot) {
    Stage& s = st[slot];
    const int k0 = (c_begin + c) * BK;
    const size_t meta = static_cast<size_t>(k0 / group_size) * N;
    if constexpr (W::PACKED) {
      // Plane pl's row r to tile pl / 2, row r + 8 (pl % 2).
      if (tid < NP * 8 * 4) {
        const int pl = tid >> 5;
        const int r = (tid >> 2) & 7;
        const int p = tid & 3;
        const bool ok = m0 + r < M;
        cp_async16(&s.x[pl >> 1][r + 8 * (pl & 1)][p * 8],
                   ok ? x + pl * plane_stride +
                            static_cast<size_t>(m0 + r) * K + k0 + p * 8
                      : x,
                   ok);
      }
    } else {
#pragma unroll
      for (int pl = 0; pl < NP; ++pl) {
        const __nv_bfloat16* xp = x + pl * plane_stride;
        for (int i = tid; i < 16 * MT * 4; i += TC_THREADS) {
          const int r = i >> 2;
          const int p = i & 3;
          const bool ok = m0 + r < M;
          cp_async16(&s.x[pl][r][p * 8],
                     ok ? xp + static_cast<size_t>(m0 + r) * K + k0 + p * 8
                        : x,
                     ok);
        }
      }
    }
    if (tid < 128) {
      if constexpr (TRANSPOSED) {
        // Column n0 + r: its chunk is 32 contiguous bytes of codes_t.
        const int r = tid >> 1;
        const int p = tid & 1;
        const int n = n0 + r;
        const bool ok = n < N;
        cp_async16(&s.codes[r][p * 16],
                   ok ? codes + static_cast<size_t>(n) * K + k0 + p * 16
                      : codes,
                   ok);
      } else {
        const int r = tid >> 2;
        const int p = tid & 3;
        const int n = n0 + p * 16;
        const bool ok = n < N;
        cp_async16(&s.codes[r][p * 16],
                   ok ? codes + static_cast<size_t>(k0 + r) * N + n : codes,
                   ok);
      }
    } else if (tid < 144) {
      const int i = tid - 128;
      const int n = n0 + i * 4;
      const bool ok = n < N;
      cp_async16(&s.scales[i * 4], ok ? scales + meta + n : scales, ok);
    } else if (tid < 148) {
      const int i = tid - 144;
      const int n = n0 + i * 16;
      const bool ok = n < N;
      cp_async16(&s.zps[i * 16], ok ? zps + meta + n : zps, ok);
    }
  };

  float acc[W::MW][W::NT][4];
#pragma unroll
  for (int i = 0; i < W::MW; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if constexpr (W::PACKED) {
    // The zeros under lo, written once: the loads never touch them, and
    // the loop's first barrier orders them before any product.
    for (int i = tid; i < STAGES * 8 * 4; i += TC_THREADS)
      *reinterpret_cast<uint4*>(&st[i >> 5].x[1][8 + ((i >> 2) & 7)]
                                              [(i & 3) * 8]) =
          make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int c = 0; c < STAGES - CPI; ++c) {
    if (c < n_chunks) load(c, c);
    cp_async_commit();
  }

  launch_dependent_grid();  // a split sum may launch and wait now
  for (int c0 = 0; c0 < n_chunks; c0 += CPI) {
    // Chunks c0 .. c0 + CPI - 1 have landed once at most STAGES - 2 CPI
    // later groups are pending; after the barrier every warp is done with
    // the last iteration's slots, which the next loads refill.
    cp_async_wait<STAGES - 2 * CPI>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < CPI; ++i) {
      const int next = c0 + STAGES - CPI + i;
      if (next < n_chunks) load(next, next % STAGES);
      cp_async_commit();
    }

#pragma unroll
    for (int ci = 0; ci < CPI; ++ci) {
      if (c0 + ci >= n_chunks) break;
      const Stage& s = st[(c0 + ci) % STAGES];

      // B fragments of this warp's n8 tiles: column wn*COLS + 8j + g, rows
      // kk + 2q, 2q+1 (b0) and kk + 8 + 2q, 2q+1 (b1), as bf16 integers.
      // Output-major codes hold each row pair in one 16-bit word.
      uint32_t b[2][W::NT][2];
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        const int n = wn * W::COLS + 8 * j + g;
        const int z = s.zps[n] >> sh;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 16 * kk + 8 * h + 2 * q;
            int c_lo, c_hi;
            if constexpr (TRANSPOSED) {
              const uint32_t pair =
                  *reinterpret_cast<const uint16_t*>(&s.codes[n][k]);
              c_lo = pair & 0xff;
              c_hi = pair >> 8;
            } else {
              c_lo = s.codes[k][n];
              c_hi = s.codes[k + 1][n];
            }
            b[kk][j][h] = pack_bf16(static_cast<float>((c_lo >> sh) - z),
                                    static_cast<float>((c_hi >> sh) - z));
          }
      }

      // The group's exact product, then its scale.
      float gacc[W::MW][W::NT][4];
#pragma unroll
      for (int i = 0; i < W::MW; ++i)
#pragma unroll
        for (int j = 0; j < W::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[i][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int i = 0; i < W::MW; ++i)
#pragma unroll
          for (int t = 0; t < W::XT; ++t) {
            uint32_t a[4];
            ldmatrix_x4(a, &s.x[t][(wm * W::MW + i) * 16 + (lane & 15)]
                               [16 * kk + (lane >> 4) * 8]);
#pragma unroll
            for (int j = 0; j < W::NT; ++j)
              mma_bf16(gacc[i][j], a, b[kk][j][0], b[kk][j][1]);
          }
      if constexpr (W::PACKED) {
        // Row g: hi + lo in c0, c1, mid in c2, c3.
#pragma unroll
        for (int j = 0; j < W::NT; ++j) {
          gacc[0][j][0] += gacc[0][j][2];
          gacc[0][j][1] += gacc[0][j][3];
        }
      }
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(
            &s.scales[wn * W::COLS + 8 * j + 2 * q]);
        const float s0 = sc.x * mult;
        const float s1 = sc.y * mult;
#pragma unroll
        for (int i = 0; i < W::MW; ++i) {
          acc[i][j][0] = fmaf(s0, gacc[i][j][0], acc[i][j][0]);
          acc[i][j][1] = fmaf(s1, gacc[i][j][1], acc[i][j][1]);
          acc[i][j][2] = fmaf(s0, gacc[i][j][2], acc[i][j][2]);
          acc[i][j][3] = fmaf(s1, gacc[i][j][3], acc[i][j][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < W::MW; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j) {
      const int row = m0 + (wm * W::MW + i) * 16 + g;
      const int col = n0 + wn * W::COLS + 8 * j + 2 * q;
      if (col >= N) continue;
      if (row < M)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(row) * N + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (!W::PACKED && row + 8 < M)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(row + 8) * N +
                                   col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// One matrix, static precision: the quantization groups of split
// blockIdx.z of gridDim.z.  With one split the block writes `out` [M, N];
// otherwise its partial sums go to partials[blockIdx.z].  x is NP planes
// of [M, K] bf16, one after the other: bf16 x itself, or the three planes
// of f32 x.
template <int MT, int NP>
__global__ void __launch_bounds__(TC_THREADS)
amat_single_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ codes,
                       const float* __restrict__ scales,
                       const uint8_t* __restrict__ zps,
                       float* __restrict__ out, float* __restrict__ partials,
                       int M, int K, int N, int group_size, int sh,
                       float mult) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // The planes of f32 x come from the split pass, of which this grid is a
  // programmatic dependent: it launches early and waits here.
  if constexpr (NP > 1) wait_for_primary_grid();
  const int splits = gridDim.z;
  const int G = K / group_size;
  float* dst = splits == 1
                   ? out
                   : partials + static_cast<size_t>(blockIdx.z) * M * N;
  amat_mma_tiles<MT, false, NP>(
      tc_smem, x, NP > 1 ? static_cast<size_t>(M) * K : 0, codes, scales,
      zps, dst, M, K, N, group_size, blockIdx.z * G / splits, (blockIdx.z + 1) * G / splits,
      sh, mult);
}

// Batched experts: expert blockIdx.z over the whole of K, at its own
// precision use_lsb[e] (the low-bit path shifts code and zero-point and
// scales by 2^shift; the high-bit path uses them as they are).  x is NP
// planes of [E, M, K] bf16, one after the other: bf16 x itself, or the
// three planes of f32 x, so plane p of expert e starts at x + p*E*M*K +
// e*M*K.
template <int MT, bool TRANSPOSED, int NP>
__global__ void __launch_bounds__(TC_THREADS)
amat_batched_mma_kernel(const __nv_bfloat16* __restrict__ x,
                        const uint8_t* __restrict__ codes,
                        const float* __restrict__ scales,
                        const uint8_t* __restrict__ zps,
                        const uint8_t* __restrict__ use_lsb,
                        float* __restrict__ out, int M, int K, int N,
                        int group_size, int shift) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // The planes of f32 x come from the split pass, of which this grid is a
  // programmatic dependent: it launches early and waits here.
  if constexpr (NP > 1) wait_for_primary_grid();
  const int e = blockIdx.z;
  const bool hi = use_lsb[e] != 0;
  const int G = K / group_size;
  const size_t meta = static_cast<size_t>(e) * G * N;
  const size_t expert_x = static_cast<size_t>(M) * K;
  amat_mma_tiles<MT, TRANSPOSED, NP>(
      tc_smem, x + e * expert_x, gridDim.z * expert_x,
      codes + static_cast<size_t>(e) * K * N, scales + meta, zps + meta,
      out + static_cast<size_t>(e) * M * N, M, K, N, group_size, 0, G,
      hi ? 0 : shift, hi ? 1.0f : static_cast<float>(1 << shift));
}

// f32 x [count] -> planes [3][count] bf16: hi = bf16(x), mid = bf16(x -
// hi), lo = bf16(x - hi - mid), each rounded to nearest even; every
// subtraction is exact in f32, so hi + mid + lo == x.  count % 4 == 0 and
// x is 16-byte aligned.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_planes_kernel(const float* __restrict__ x,
                    __nv_bfloat16* __restrict__ planes, size_t count) {
  launch_dependent_grid();  // the three-plane kernel may launch and wait
  const size_t i =
      (static_cast<size_t>(blockIdx.x) * SPLIT_THREADS + threadIdx.x) * 4;
  if (i >= count) return;
  const float4 v = *reinterpret_cast<const float4*>(x + i);
  float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const __nv_bfloat162 b01 = __floats2bfloat162_rn(r[0], r[1]);
    const __nv_bfloat162 b23 = __floats2bfloat162_rn(r[2], r[3]);
    const float2 f01 = __bfloat1622float2(b01);
    const float2 f23 = __bfloat1622float2(b23);
    r[0] -= f01.x;
    r[1] -= f01.y;
    r[2] -= f23.x;
    r[3] -= f23.y;
    *reinterpret_cast<uint2*>(planes + p * count + i) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&b01),
                   *reinterpret_cast<const uint32_t*>(&b23));
  }
}

// out[i] = sum over s of partials[s][i], in split order; count % 4 == 0.
// Launched as a programmatic dependent of the main kernel, so that its
// launch overlaps the main kernel; it waits for that grid's completion and
// memory before reading.  Each thread loads SUM_BATCH partials before
// adding them, so that their reads overlap.
__global__ void __launch_bounds__(SUM_THREADS)
sum_splits_kernel(const float* __restrict__ partials, float* __restrict__ out,
                  int splits, size_t count) {
  wait_for_primary_grid();
  const size_t i =
      (static_cast<size_t>(blockIdx.x) * SUM_THREADS + threadIdx.x) * 4;
  if (i >= count) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < splits; s0 += SUM_BATCH) {
    float4 v[SUM_BATCH];
#pragma unroll
    for (int j = 0; j < SUM_BATCH; ++j)
      if (s0 + j < splits)
        v[j] = *reinterpret_cast<const float4*>(
            partials + static_cast<size_t>(s0 + j) * count + i);
#pragma unroll
    for (int j = 0; j < SUM_BATCH; ++j)
      if (s0 + j < splits) {
        acc.x += v[j].x;
        acc.y += v[j].y;
        acc.z += v[j].z;
        acc.w += v[j].w;
      }
  }
  *reinterpret_cast<float4*>(out + i) = acc;
}

// f(std::integral_constant<int, MT>{}) for m_tiles = MT in 1, 2, 4, 8.
template <typename F>
int with_m_tiles(int m_tiles, F&& f) {
  switch (m_tiles) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch `kernel` on `stream` as a programmatic dependent of the grid
// before it: it may start before that grid ends, and waits for it
// (`wait_for_primary_grid`) before reading its output.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             int threads, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <int MT, int NP>
int launch_single_mma(const __nv_bfloat16* x, const uint8_t* codes,
                      const float* scales, const uint8_t* zps, float* out,
                      float* partials, int splits, int M, int K, int N,
                      int group_size, int sh, float mult,
                      cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<MT, false, NP>();
  static bool done[MAX_DEVICES] = {};
  cudaError_t err =
      allow_smem_once(amat_single_mma_kernel<MT, NP>, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int ROWS = TcWarps<MT, NP>::ROWS;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + ROWS - 1) / ROWS, splits);
  if constexpr (NP > 1) {
    err = launch_dependent(amat_single_mma_kernel<MT, NP>, grid, TC_THREADS,
                           bytes, stream, x, codes, scales, zps, out,
                           partials, M, K, N, group_size, sh, mult);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    amat_single_mma_kernel<MT, NP><<<grid, TC_THREADS, bytes, stream>>>(
        x, codes, scales, zps, out, partials, M, K, N, group_size, sh, mult);
  }
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t count = static_cast<size_t>(M) * N;
    const size_t blocks = (count / 4 + SUM_THREADS - 1) / SUM_THREADS;
    err = launch_dependent(sum_splits_kernel,
                           dim3(static_cast<unsigned>(blocks)), SUM_THREADS,
                           0, stream, static_cast<const float*>(partials),
                           out, splits, count);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MT, bool TRANSPOSED, int NP>
int launch_batched_mma(const __nv_bfloat16* x, const uint8_t* codes,
                       const float* scales, const uint8_t* zps,
                       const uint8_t* use_lsb, float* out, int E, int M,
                       int K, int N, int group_size, int shift,
                       cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<MT, TRANSPOSED, NP>();
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = allow_smem_once(
      amat_batched_mma_kernel<MT, TRANSPOSED, NP>, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int ROWS = TcWarps<MT, NP>::ROWS;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + ROWS - 1) / ROWS, E);
  if constexpr (NP > 1) {
    err = launch_dependent(amat_batched_mma_kernel<MT, TRANSPOSED, NP>, grid,
                           TC_THREADS, bytes, stream, x, codes, scales, zps,
                           use_lsb, out, M, K, N, group_size, shift);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    amat_batched_mma_kernel<MT, TRANSPOSED, NP>
        <<<grid, TC_THREADS, bytes, stream>>>(x, codes, scales, zps, use_lsb,
                                              out, M, K, N, group_size, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

// f32 x [count] (16-byte aligned, count % 4 == 0) -> its three bf16
// planes [3][count] by the split pass, enqueued on `stream`.
cudaError_t split_planes(const void* x, __nv_bfloat16* planes, size_t count,
                         cudaStream_t stream) {
  const size_t blocks = (count / 4 + SPLIT_THREADS - 1) / SPLIT_THREADS;
  split_planes_kernel<<<static_cast<unsigned>(blocks), SPLIT_THREADS, 0,
                        stream>>>(static_cast<const float*>(x), planes,
                                  count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16.  Each entry returns the CUDA error
// code of its launch (0 on success); the caller checks it.

// Batched experts, per-expert precision use_lsb [E]; transposed = 1 reads
// output-major codes [E, N, K].  Runs on the tensor cores on blocks of 16
// * m_tiles rows and 64 columns.  bf16 x runs as it is (m_tiles 1, 2, 4
// or 8; planes unused).  f32 x first goes through the split pass into
// planes, bf16 scratch of 3 * E * M * K, then runs as three planes
// (m_tiles 1, 2 or 4; one m16 tile covers 8 rows).  Takes N % 16 == 0 and 16-byte aligned x, codes,
// scales and zps.
int amat_batched_matmul(const void* x, int x_dtype, const void* codes,
                        const void* scales, const void* zps,
                        const void* use_lsb, void* out, void* planes,
                        int m_tiles, int E, int M, int K, int N,
                        int group_size, int shift, int transposed,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  const uint8_t* z = static_cast<const uint8_t*>(zps);
  const uint8_t* u = static_cast<const uint8_t*>(use_lsb);
  float* o = static_cast<float*>(out);
  if (N % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0) {
    if (planes == nullptr || m_tiles > 4)
      return static_cast<int>(cudaErrorInvalidValue);
    __nv_bfloat16* pl = static_cast<__nv_bfloat16*>(planes);
    const cudaError_t err =
        split_planes(x, pl, static_cast<size_t>(E) * M * K, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return with_m_tiles(m_tiles, [&](auto mt) {
      constexpr int MT = decltype(mt)::value;
      if constexpr (MT > 4) {
        return static_cast<int>(cudaErrorInvalidValue);
      } else {
        return transposed
                   ? launch_batched_mma<MT, true, 3>(pl, c, sc, z, u, o, E, M,
                                                     K, N, group_size, shift,
                                                     s)
                   : launch_batched_mma<MT, false, 3>(pl, c, sc, z, u, o, E,
                                                      M, K, N, group_size,
                                                      shift, s);
      }
    });
  }
  if (x_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  return with_m_tiles(m_tiles, [&](auto mt) {
    constexpr int MT = decltype(mt)::value;
    return transposed
               ? launch_batched_mma<MT, true, 1>(xb, c, sc, z, u, o, E, M, K,
                                                 N, group_size, shift, s)
               : launch_batched_mma<MT, false, 1>(xb, c, sc, z, u, o, E, M,
                                                  K, N, group_size, shift, s);
  });
}

// One matrix: x [M, K] @ dequant(codes [K, N]) with a static precision,
// high = 1 for MSB+LSB ('high'), 0 for MSB only at `shift` ('low'), on
// the tensor cores, on blocks of 16 * m_tiles rows and 64 columns with K
// split `splits` ways in whole groups; with splits > 1, partials is f32
// scratch of splits * M * N.  bf16 x runs as it is (m_tiles 1, 2, 4 or
// 8; planes unused).  f32 x first goes through the split pass into
// planes, bf16 scratch of 3 * M * K, then runs as three planes (m_tiles
// 1, 2 or 4; one m16 tile covers 8 rows).  Takes N % 16 == 0 and 16-byte aligned x, codes, scales and
// zps.
int amat_single_matmul(const void* x, int x_dtype, const void* codes,
                       const void* scales, const void* zps, void* out,
                       void* partials, void* planes, int m_tiles, int splits,
                       int M, int K, int N, int group_size, int shift,
                       int high, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  const uint8_t* z = static_cast<const uint8_t*>(zps);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partials);
  const int sh = high ? 0 : shift;
  const float mult = high ? 1.0f : static_cast<float>(1 << shift);
  if (N % 16 != 0 || splits < 1 || splits > K / group_size ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0) {
    if (planes == nullptr || m_tiles > 4)
      return static_cast<int>(cudaErrorInvalidValue);
    __nv_bfloat16* pl = static_cast<__nv_bfloat16*>(planes);
    const cudaError_t err =
        split_planes(x, pl, static_cast<size_t>(M) * K, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return with_m_tiles(m_tiles, [&](auto mt) {
      constexpr int MT = decltype(mt)::value;
      if constexpr (MT > 4) {
        return static_cast<int>(cudaErrorInvalidValue);
      } else {
        return launch_single_mma<MT, 3>(pl, c, sc, z, o, part, splits, M, K,
                                        N, group_size, sh, mult, s);
      }
    });
  }
  if (x_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  return with_m_tiles(m_tiles, [&](auto mt) {
    return launch_single_mma<decltype(mt)::value, 1>(
        xb, c, sc, z, o, part, splits, M, K, N, group_size, sh, mult, s);
  });
}

const char* amat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
