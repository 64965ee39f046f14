// Causal GQA flash attention with an optional sliding window, for Hopper
// (sm_90a).
//
// Both kernels below replace the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attn/kernel.py (entry point
// `flash_attention_pallas`):
//
//   out[b, q, h] = softmax_k(mask(q, k) ? (Q[b, q, h] . K[b, k, h/rep]) * D^-0.5
//                                      : -1e30) @ V[b, :, h/rep]
//
// q [B, Sq, H, D], k / v [B, Sk, Hkv, D] (all f32 or all bf16, contiguous),
// out [B, Sq, H, D] f32, rep = H / Hkv: query head h reads KV head h / rep,
// as the reference's (hkv, rep) reshape does.  The mask is start-aligned:
// key k is visible to query q iff k < Sk, k <= q when causal, and
// q - k < window when a window is given.
//
// Arithmetic as the reference does it: scores in f32, the scale applied to
// the f32 dot product, masked scores set to the finite -1e30 (not -inf), an
// online softmax whose m, l and output accumulator are f32, and the output
// acc / max(l, 1e-30).  The finite sentinel matters: a tile that is fully
// masked for a row before that row's first visible key gives p = exp(0) = 1,
// and the next visible tile's correction exp(-1e30 - m) = 0 wipes it
// exactly; with -inf it would give NaN.  Rows with no visible key at all are
// outside the contract (the reference's value there depends on its tiling).
//
// What bounds it on an H100: operations.  At Qwen1.5-MoE-A2.7B's attention
// (B=4, S=4096, 16 heads of 128, causal) it does 4*D = 512 FLOP per visible
// (query, key) pair, 275 GFLOP, against 0.34 GB of q, k, v (bf16) and out
// (f32): some 800 FLOP per byte.  Both kernels run on the tensor cores in
// the FlashAttention-2 shape: one block of 4 warps per (64 query rows,
// query head, batch), heaviest causal tiles first; each warp owns 16 query
// rows; K and V tiles arrive by `cp.async` in a two-stage ring, the next
// tile in flight while this one computes; the score fragment (the `mma` C
// layout) becomes P's A fragment in registers; the four lanes that share a
// row take its max and sum by xor shuffles 1 and 2.  By input type:
//
// bf16 inputs, `flash_mma_kernel`.  q.k of bf16 inputs is exact on the
// tensor cores (`mma.sync m16n8k16` bf16 -> f32).  p.v has f32
// probabilities; a single bf16 p misses the 1e-4 tolerance, so each p is
// split as p_hi = bf16(p), p_lo = bf16(p - p_hi) (|p - p_hi - p_lo| <=
// 2^-18 |p|) and p.v runs as two bf16 products into the f32 accumulator.
// Three bf16 products per pair: a bound of 3 * 2*D FLOP at 989 TFLOP/s.
// Q fragments are loaded once by `ldmatrix` and kept in registers; tiles
// of 64 keys; V's B fragments come from `ldmatrix.trans` of the row-major
// tile.  At D=128 shared memory is Q plus two stages of K and V, 85 KiB:
// two blocks per SM.
//
// f32 inputs, `flash_tf32_kernel` (3xTF32).  A single TF32 product (10
// mantissa bits) misses the tolerance, and arbitrary f32 values have no
// exact split into few parts, so each operand x of q.k and p.v is split as
// hi = tf32(x), rounded to nearest with ties away, and lo = x - hi, which
// the tensor cores read truncated to tf32 (`split_tf32`), and each product
// runs as hi.hi + hi.lo + lo.hi (`mma.sync m16n8k8` tf32 -> f32), leaving
// out lo.lo: within about 2^-21 of each product.  Six TF32 products per
// pair: a bound of 6 * 2*D FLOP at 494.7 TFLOP/s.  q, k, v stay f32 in
// shared memory (Q once, K and V in tiles of 32 keys, two stages: 105 KiB
// at D=128, two blocks per SM) and every fragment is split in registers as
// it is loaded.  Within each k16 block of q.k the lane's A and B columns q
// and q + 4 stand for head dims 4q and 4q + 1 (first k8 step) and 4q + 2
// and 4q + 3 (second), so one 16-byte load gives both steps' fragments;
// the sum over the head dim is the same.  In p.v, A column q stands for
// key 2q and column q + 4 for key 2q + 1, which are the score columns the
// lane already holds, and V's B rows are read in the same order: no
// shuffle.  Row strides: Q and K rows start 16 words (mod 32) apart, so
// the 8 lanes of each quarter-warp's 16-byte load hit distinct banks; V
// rows 4 words (mod 32) apart, so the 32 scalar loads of a B fragment
// (rows 2q and 2q + 1, column g) hit 32 banks.  hi.hi and the two cross products of
// q.k go to separate accumulators, added before the scale.
//
// Both kernels skip the K/V tiles wholly above the causal diagonal of the
// block's last row or wholly before the window of its first row: exact
// for any row with a visible key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;             // query rows per block
constexpr int BKV = 64;            // keys per tile (bf16)
constexpr int TF_KV = 32;          // keys per tile (f32)
constexpr int MMA_THREADS = 128;   // 4 warps x 16 query rows
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16 inputs (see the note at the top).

template <int D>
struct MmaLayout {
  static constexpr int LD = D + 8;          // row of Q, K, V: no ldmatrix
                                            // bank conflicts
  static constexpr int TILE = 64 * LD;      // bf16 elements of one tile
  static constexpr size_t BYTES = 5 * TILE * sizeof(__nv_bfloat16);
};                                          // Q, K x 2 stages, V x 2 stages

// Rows s0 .. s0+63 of a [S, *, D] bf16 sequence (row stride `stride`)
// into dst [64][LD] by cp.async, zeros past row S.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                size_t stride, int s0, int S) {
  constexpr int PER_ROW = D / 8;
  for (int c = threadIdx.x; c < 64 * PER_ROW; c += MMA_THREADS) {
    const int r = c / PER_ROW;
    const int d0 = (c % PER_ROW) * 8;
    const bool ok = s0 + r < S;
    cp_async16(dst + r * MmaLayout<D>::LD + d0,
               ok ? src + static_cast<size_t>(s0 + r) * stride + d0 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, float* __restrict__ out,
                 int Sq, int Sk, int H, int Hkv, int causal, int window,
                 float scale) {
  using L = MmaLayout<D>;
  constexpr int DK = D / 16;   // k16 steps of q.k; n16 pairs of p.v
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* Ks = Qs + L::TILE;       // stage s at Ks + s * TILE
  __nv_bfloat16* Vs = Ks + 2 * L::TILE;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  // The KV tiles that hold a visible key for some row of this tile.
  const int n_kt = (Sk + BKV - 1) / BKV;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kt_end = causal ? min(n_kt, q_last / BKV + 1) : n_kt;
  const int first_key = window > 0 ? q0 - window + 1 : 0;
  const int kt_begin = first_key > 0 ? first_key / BKV : 0;

  load_tile_async<D>(Qs, qb, q_stride, q0, Sq);
  if (kt_begin < kt_end) {
    load_tile_async<D>(Ks, kb, kv_stride, kt_begin * BKV, Sk);
    load_tile_async<D>(Vs, vb, kv_stride, kt_begin * BKV, Sk);
  }
  cp_async_commit();

  // This lane's rows of the C fragments: r = 0 -> row_a, r = 1 -> row_a + 8.
  const int row_a = q0 + warp * 16 + (lane >> 2);
  uint32_t qf[DK][4];
  float o[2 * DK][4];
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      // Into the other stage, read by the last tile: the barrier at the end
      // of the last iteration has passed.
      load_tile_async<D>(Ks + (stage ^ 1) * L::TILE, kb, kv_stride,
                         (kt + 1) * BKV, Sk);
      load_tile_async<D>(Vs + (stage ^ 1) * L::TILE, vb, kv_stride,
                         (kt + 1) * BKV, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_begin) {
#pragma unroll
      for (int kd = 0; kd < DK; ++kd)
        ldmatrix_x4(qf[kd], Qs + (warp * 16 + (lane & 15)) * L::LD +
                                kd * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Ks + stage * L::TILE;
    const __nv_bfloat16* Vt = Vs + stage * L::TILE;

    // Scores of this warp's 16 rows against the tile's 64 keys: 8 n8 tiles.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DK; ++kd)
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                 L::LD +
                             kd * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], qf[kd], bk[0], bk[1]);
        mma_bf16(s[2 * j2 + 1], qf[kd], bk[2], bk[3]);
      }

    // Mask and scale, then the online softmax of each of the lane's two
    // rows; the quad of lanes that holds a row reduces by xor 1 and 2.
    const int k0 = kt * BKV;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row_a + (e >> 1) * 8;
        const int kj = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
        bool vis = kj < Sk;
        if (causal) vis = vis && qi >= kj;
        if (window > 0) vis = vis && qi - kj < window;
        s[j][e] = vis ? s[j][e] * scale : NEG_INF;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_new);
          rs += s[j][e];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < 2 * DK; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }

    // o += p_hi . V + p_lo . V, 16 keys at a time; the two score n8 tiles
    // of those keys are P's A fragment.
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = &s[2 * t + (i >> 1)][2 * (i & 1)];
        const __nv_bfloat162 ph = __floats2bfloat162_rn(p[0], p[1]);
        const float2 phf = __bfloat1622float2(ph);
        hi[i] = *reinterpret_cast<const uint32_t*>(&ph);
        lo[i] = pack_bf16(p[0] - phf.x, p[1] - phf.y);
      }
#pragma unroll
      for (int j2 = 0; j2 < DK; ++j2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + (t * 16 + (lane & 15)) * L::LD + j2 * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * j2], hi, bv[0], bv[1]);
        mma_bf16(o[2 * j2], lo, bv[0], bv[1]);
        mma_bf16(o[2 * j2 + 1], hi, bv[2], bv[3]);
        mma_bf16(o[2 * j2 + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // a block with no tile still waits for its Q copy

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_a + 8 * r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = out + (static_cast<size_t>(b) * Sq + qi) * q_stride +
                  static_cast<size_t>(h) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j)
      *reinterpret_cast<float2*>(orow + j * 8) =
          make_float2(o[j][2 * r] / denom, o[j][2 * r + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// f32 inputs, 3xTF32 (see the note at the top).

template <int D>
struct Tf32Layout {
  static constexpr int LDQK = D % 32 == 0 ? D + 16 : D + 32;  // = 16 mod 32
  static constexpr int LDV = D + 4;                           // = 4 mod 32
  static constexpr int Q_FLOATS = BQ * LDQK;
  static constexpr int K_FLOATS = TF_KV * LDQK;  // one stage
  static constexpr int V_FLOATS = TF_KV * LDV;   // one stage
  static constexpr size_t BYTES =
      (Q_FLOATS + 2 * (K_FLOATS + V_FLOATS)) * sizeof(float);
};

// `rows` rows from s0 of a [S, *, D] f32 sequence (row stride `stride`)
// into dst [rows][ld] by cp.async, zeros past row S.
template <int D>
__device__ __forceinline__ void load_f32_async(float* dst, int ld, int rows,
                                               const float* src,
                                               size_t stride, int s0, int S) {
  constexpr int PER_ROW = D / 4;
  for (int c = threadIdx.x; c < rows * PER_ROW; c += MMA_THREADS) {
    const int r = c / PER_ROW;
    const int d0 = (c % PER_ROW) * 4;
    const bool ok = s0 + r < S;
    cp_async16(dst + r * ld + d0,
               ok ? src + static_cast<size_t>(s0 + r) * stride + d0 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Sq, int Sk, int H, int Hkv, int causal, int window,
                  float scale) {
  using L = Tf32Layout<D>;
  constexpr int DK = D / 16;   // k16 blocks of q.k (two k8 steps each)
  constexpr int DN = D / 8;    // n8 tiles of p.v
  constexpr int NT = TF_KV / 8;  // n8 tiles of a score tile
  extern __shared__ __align__(16) float tf_smem[];
  float* Qs = tf_smem;
  float* Ks = Qs + L::Q_FLOATS;      // stage s at Ks + s * K_FLOATS
  float* Vs = Ks + 2 * L::K_FLOATS;  // stage s at Vs + s * V_FLOATS

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int qd = lane & 3;

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  // The KV tiles that hold a visible key for some row of this tile.
  const int n_kt = (Sk + TF_KV - 1) / TF_KV;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kt_end = causal ? min(n_kt, q_last / TF_KV + 1) : n_kt;
  const int first_key = window > 0 ? q0 - window + 1 : 0;
  const int kt_begin = first_key > 0 ? first_key / TF_KV : 0;

  load_f32_async<D>(Qs, L::LDQK, BQ, qb, q_stride, q0, Sq);
  if (kt_begin < kt_end) {
    load_f32_async<D>(Ks, L::LDQK, TF_KV, kb, kv_stride, kt_begin * TF_KV,
                      Sk);
    load_f32_async<D>(Vs, L::LDV, TF_KV, vb, kv_stride, kt_begin * TF_KV, Sk);
  }
  cp_async_commit();

  // This lane's rows of the C fragments: r = 0 -> row_a, r = 1 -> row_a + 8.
  const int row_a = q0 + warp * 16 + g;
  // Head dims 4qd .. 4qd + 3 of row g of this warp's Q rows, and of key g.
  const float* q_lane = Qs + (warp * 16 + g) * L::LDQK + 4 * qd;
  float o[DN][4];
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      // Into the other stage, read by the last tile: the barrier at the end
      // of the last iteration has passed.
      load_f32_async<D>(Ks + (stage ^ 1) * L::K_FLOATS, L::LDQK, TF_KV, kb,
                        kv_stride, (kt + 1) * TF_KV, Sk);
      load_f32_async<D>(Vs + (stage ^ 1) * L::V_FLOATS, L::LDV, TF_KV, vb,
                        kv_stride, (kt + 1) * TF_KV, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + stage * L::K_FLOATS;
    const float* Vt = Vs + stage * L::V_FLOATS;

    // Scores of this warp's 16 rows against the tile's 32 keys: NT n8
    // tiles; hi.hi into s, hi.lo + lo.hi into c.
    float s[NT][4], c[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = c[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DK; ++kd) {
      const float4 qa = *reinterpret_cast<const float4*>(q_lane + 16 * kd);
      const float4 qc = *reinterpret_cast<const float4*>(
          q_lane + 8 * L::LDQK + 16 * kd);
      // A of step t: a0 row g, a1 row g + 8 at dim 4qd + 2t; a2, a3 at
      // dim 4qd + 2t + 1.
      uint32_t ah[2][4], al[2][4];
      split_tf32(qa.x, ah[0][0], al[0][0]);
      split_tf32(qc.x, ah[0][1], al[0][1]);
      split_tf32(qa.y, ah[0][2], al[0][2]);
      split_tf32(qc.y, ah[0][3], al[0][3]);
      split_tf32(qa.z, ah[1][0], al[1][0]);
      split_tf32(qc.z, ah[1][1], al[1][1]);
      split_tf32(qa.w, ah[1][2], al[1][2]);
      split_tf32(qc.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // B of step t: key 8j + g at dims 4qd + 2t (b0) and + 1 (b1).
        const float4 kv = *reinterpret_cast<const float4*>(
            Kt + (8 * j + g) * L::LDQK + 16 * kd + 4 * qd);
        uint32_t bh[4], bl[4];
        split_tf32(kv.x, bh[0], bl[0]);
        split_tf32(kv.y, bh[1], bl[1]);
        split_tf32(kv.z, bh[2], bl[2]);
        split_tf32(kv.w, bh[3], bl[3]);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_tf32(s[j], ah[t], bh[2 * t], bh[2 * t + 1]);
          mma_tf32(c[j], ah[t], bl[2 * t], bl[2 * t + 1]);
          mma_tf32(c[j], al[t], bh[2 * t], bh[2 * t + 1]);
        }
      }
    }

    // Mask and scale, then the online softmax of each of the lane's two
    // rows; the quad of lanes that holds a row reduces by xor 1 and 2.
    const int k0 = kt * TF_KV;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row_a + (e >> 1) * 8;
        const int kj = k0 + j * 8 + 2 * qd + (e & 1);
        bool vis = kj < Sk;
        if (causal) vis = vis && qi >= kj;
        if (window > 0) vis = vis && qi - kj < window;
        s[j][e] = vis ? (s[j][e] + c[j][e]) * scale : NEG_INF;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_new);
          rs += s[j][e];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }

    // o += p.V over the score tile's keys, one k8 step per n8 score tile:
    // A column qd is key 8j + 2qd and column qd + 4 key 8j + 2qd + 1, the
    // lane's own score columns; V's B rows follow the same order.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const float* v0 = Vt + (8 * j + 2 * qd) * L::LDV + g;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        uint32_t vh[2], vl[2];
        split_tf32(v0[8 * n], vh[0], vl[0]);
        split_tf32(v0[L::LDV + 8 * n], vh[1], vl[1]);
        mma_tf32(o[n], ph, vh[0], vh[1]);
        mma_tf32(o[n], ph, vl[0], vl[1]);
        mma_tf32(o[n], pl, vh[0], vh[1]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // a block with no tile still waits for its Q copy

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_a + 8 * r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = out + (static_cast<size_t>(b) * Sq + qi) * q_stride +
                  static_cast<size_t>(h) * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      *reinterpret_cast<float2*>(orow + j * 8) =
          make_float2(o[j][2 * r] / denom, o[j][2 * r + 1] / denom);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, float* out, int B,
               int Sq, int Sk, int H, int Hkv, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr size_t bytes = MmaLayout<D>::BYTES;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = allow_smem_once(flash_mma_kernel<D>, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_mma_kernel<D><<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, Sq, Sk, H, Hkv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, float* out,
                int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
                float scale, cudaStream_t stream) {
  constexpr size_t bytes = Tf32Layout<D>::BYTES;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = allow_smem_once(flash_tf32_kernel<D>, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_tf32_kernel<D><<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), out, Sq, Sk, H, Hkv, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 runs `flash_mma_kernel`, f32 `flash_tf32_kernel`.
template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, float* out,
                 int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
                 float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_mma<D>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window,
                         scale, stream);
  } else {
    return launch_tf32<D>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window,
                          scale, stream);
  }
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, float* out,
             int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_typed<T, 16>(q, k, v, out, B, Sq, Sk, H, Hkv, causal,
                                 window, scale, s);
    case 32:
      return launch_typed<T, 32>(q, k, v, out, B, Sq, Sk, H, Hkv, causal,
                                 window, scale, s);
    case 64:
      return launch_typed<T, 64>(q, k, v, out, B, Sq, Sk, H, Hkv, causal,
                                 window, scale, s);
    case 128:
      return launch_typed<T, 128>(q, k, v, out, B, Sq, Sk, H, Hkv, causal,
                                  window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike); D in {16, 32, 64,
// 128}; window <= 0 means no sliding window.  Returns the CUDA error code
// of the launch (0 on success); the caller checks it.
int flash_attention(const void* q, const void* k, const void* v, int dtype,
                    void* out, int B, int Sq, int Sk, int H, int Hkv, int D,
                    int causal, int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      return launch_d<float>(D, q, k, v, o, B, Sq, Sk, H, Hkv, causal, window,
                             scale, s);
    case 1:
      return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                     window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
