// Causal GQA flash attention with an optional sliding window, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
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
// (f32): some 800 FLOP per byte.  This first version runs on the CUDA cores
// in f32 (67 TFLOP/s).  With bf16 inputs, q.k could run exactly on the
// tensor cores (bf16 products in an f32 accumulator), leaving p.v, whose
// probabilities are f32, to set the bound at about half; no tensor cores,
// TMA or wgmma yet.
//
// Layout of the work: one block per (query tile of 64 rows, query head,
// batch), the heaviest causal tiles first.  The block stages its Q tile in
// shared memory as f32, then walks the K/V tiles of 64 keys that hold a
// visible key for any of its rows (tiles wholly above the causal diagonal,
// or wholly before the window of its first row, are skipped: exact for any
// row with a visible key).  256 threads as 16 x 16: thread (ty, tx) owns
// query rows 4*ty .. 4*ty+3, keys tx + 16*j of each tile for the scores,
// and D/16 output columns.  The 16 threads that share a row sit in one
// half-warp, so the row max and sum are warp shuffles.  The probabilities
// go through shared memory (in the K tile's space) to the P @ V product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// 16 bytes of one row into f32 shared memory: 4 f32 or 8 bf16 values.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
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

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, float* out,
             int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window,
                           scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window,
                            scale, s);
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
