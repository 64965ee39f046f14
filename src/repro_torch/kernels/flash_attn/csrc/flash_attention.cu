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
// (f32): some 800 FLOP per byte.  Two kernels, by input type:
//
// bf16 inputs, `flash_mma_kernel` (tensor cores, FlashAttention-2 shape).
// q.k of bf16 inputs is exact on the tensor cores (`mma.sync m16n8k16`
// bf16 -> f32).  p.v has f32 probabilities; a single bf16 p misses the
// 1e-4 tolerance, so each p is split as p_hi = bf16(p), p_lo = bf16(p -
// p_hi) (|p - p_hi - p_lo| <= 2^-18 |p|) and p.v runs as two bf16
// products into the f32 accumulator.  Three bf16 products per pair: a
// bound of 3 * 2*D FLOP at 989 TFLOP/s.  One block of 4 warps per (64
// query rows, query head, batch), heaviest causal tiles first; each warp
// owns 16 query rows, its Q fragments loaded once by `ldmatrix` and kept
// in registers.  K and V tiles of 64 keys arrive as bf16 by `cp.async` in
// a two-stage ring, the next tile in flight while this one computes.  The
// score fragment (the `mma` C layout) becomes P's A fragment in registers;
// V's B fragments come from `ldmatrix.trans` of the row-major tile.  The
// four lanes that share a row take its max and sum by xor shuffles 1 and 2.
// At D=128 shared memory is Q plus two stages of K and V, 85 KiB: two
// blocks per SM.
//
// f32 inputs, `flash_kernel<float, D>` (CUDA cores; TF32 would round the
// inputs to 10 mantissa bits, so there is no exact tensor-core route):
// one block per (query tile of 64 rows, query head, batch), the heaviest
// causal tiles first.  The block stages its Q tile in shared memory as
// f32, then walks the K/V tiles of 64 keys that hold a visible key for
// any of its rows.  256 threads as 16 x 16: thread (ty, tx) owns query
// rows 4*ty .. 4*ty+3, keys tx + 16*j of each tile for the scores, and
// D/16 output columns.  The 16 threads that share a row sit in one
// half-warp, so the row max and sum are warp shuffles.  The probabilities
// go through shared memory (in the K tile's space) to the P @ V product.
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

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int TX = 16;        // threads across a row
constexpr int TY = 16;        // row groups
constexpr int THREADS = TX * TY;
constexpr int RPT = BQ / TY;  // query rows per thread
constexpr int KPT = BKV / TX; // keys per thread per tile
constexpr int PAD = 4;        // row padding of Q, K and P: no bank conflicts
constexpr float NEG_INF = -1e30f;

static_assert(RPT == 4 && KPT == 4, "the score loop is written for 4 x 4");
static_assert(BQ == 64 && BKV == 64, "load_rows stages 64 rows");

template <int D>
struct Layout {
  static constexpr int LDQ = D + PAD;        // Q [BQ][D + PAD]
  static constexpr int LDK = D + PAD;        // K [BKV][D + PAD]
  static constexpr int LDP = BKV + PAD;      // P [BQ][BKV + PAD], in K's space
  static constexpr int KP = (BKV * LDK > BQ * LDP) ? BKV * LDK : BQ * LDP;
  static constexpr int CPT = D / TX;         // output columns per thread
  static constexpr int VEC = CPT < 4 ? CPT : 4;
  static constexpr int FLOATS = BQ * LDQ + KP + BKV * D;  // + V [BKV][D]
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// 16 bytes of one row into f32 shared memory: 4 f32 values.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
// Rows s0 .. s0+63 of a [S, *, D] sequence (row stride `stride` elements)
// into dst [64][ld] as f32, zero past row S.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t stride, int s0, int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = D / V;
  for (int c = threadIdx.x; c < 64 * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int d0 = (c % PER_ROW) * V;
    float* o = dst + r * ld + d0;
    if (s0 + r < S) {
      load16(src + static_cast<size_t>(s0 + r) * stride + d0, o);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = 0.f;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = *src;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    *dst = src[0];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
             int H, int Hkv, int causal, int window, float scale) {
  using L = Layout<D>;
  constexpr int CPT = L::CPT;
  constexpr int VEC = L::VEC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KPs = Qs + BQ * L::LDQ;
  float* Vs = KPs + L::KP;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x / TX;
  const int tx = threadIdx.x % TX;
  const int row0 = ty * RPT;

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;

  load_rows<T, D>(Qs, L::LDQ, qb, q_stride, q0, Sq);

  // The KV tiles that hold a visible key for some row of this tile.
  const int n_kt = (Sk + BKV - 1) / BKV;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kt_end = causal ? min(n_kt, q_last / BKV + 1) : n_kt;
  const int first_key = window > 0 ? q0 - window + 1 : 0;
  const int kt_begin = first_key > 0 ? first_key / BKV : 0;

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the last tile's P and V are read
    load_rows<T, D>(KPs, L::LDK, kb, kv_stride, k0, Sk);
    load_rows<T, D>(Vs, D, vb, kv_stride, k0, Sk);
    __syncthreads();

    // Scores of rows row0 + i against keys k0 + tx + 16 j.
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(row0 + i) * L::LDQ + d]);
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &KPs[(tx + TX * j) * L::LDK + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Mask, then the online softmax of each row; the 16 threads of a row
    // are one half-warp, so xor shuffles below 16 stay inside it and give
    // every one of them the same max and sum.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + row0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kj = k0 + tx + TX * j;
        bool vis = kj < Sk;
        if (causal) vis = vis && qi >= kj;
        if (window > 0) vis = vis && qi - kj < window;
        s[i][j] = vis ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done with the K tile
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        KPs[(row0 + i) * L::LDP + tx + TX * j] = s[i][j];
    __syncwarp();     // a row's P is written by its own half-warp

    // acc[i] += P[row0 + i, :] @ V[:, this thread's columns]
#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&KPs[(row0 + i) * L::LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
#pragma unroll
        for (int g = 0; g < CPT / VEC; ++g)
          load_vec<VEC>(&Vs[(kk + u) * D + g * TX * VEC + tx * VEC],
                        &vv[g * VEC]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float o[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[c] = acc[i][c] / denom;
    float* orow = out + (static_cast<size_t>(b) * Sq + qi) * q_stride +
                  static_cast<size_t>(h) * D;
#pragma unroll
    for (int g = 0; g < CPT / VEC; ++g)
      store_vec<VEC>(orow + g * TX * VEC + tx * VEC, &o[g * VEC]);
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs on the tensor cores (see the note at the top).

using namespace hopper;

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, float* out, int B,
           int Sq, int Sk, int H, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, Sq, Sk, H, Hkv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, float* out, int B,
               int Sq, int Sk, int H, int Hkv, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr size_t bytes = MmaLayout<D>::BYTES;
  // Set once per device, so that a launch inside a CUDA graph capture
  // makes no other API call than cudaGetDevice.
  constexpr int MAX_DEVICES = 64;
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || !attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) attr_set[dev] = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_mma_kernel<D><<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, Sq, Sk, H, Hkv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 runs the tensor-core kernel, f32 the CUDA-core one.
template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, float* out,
                 int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
                 float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_mma<D>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window,
                         scale, stream);
  } else {
    return launch<T, D>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window,
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
