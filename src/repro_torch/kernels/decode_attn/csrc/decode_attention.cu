// One attention layer of a batched decode step, for Hopper (sm_90a): RoPE
// on the new query and key rows, the new K and V rows appended to the bf16
// cache, and attention of each sequence's one query over its valid cache
// rows, in one split kernel and (when the cache spans more than one chunk)
// one merge kernel.
//
// It replaces no TPU kernel: the JAX package's decode step is plain `jnp`
// (`decode_attention` in src/repro/models/layers.py, `apply_rope` and the
// row writes of `_attn_decode` in src/repro/models/model.py).  The port
// added it because the plain route cast the whole K and V cache to f32 in
// every layer of every step, whatever each sequence's length, and took
// about 60 launches a layer to do it.  The function is the plain route's
// (src/repro_torch/kernels/decode_attn/ref.py):
//
//   q' = bf16(rope(q, pos)),  k' = bf16(rope(k, pos))
//   K[b, pos[b]] = k',  V[b, pos[b]] = v          (if pos[b] < S)
//   out[b, h] = bf16(softmax_j(s_j) @ V[b, :, h / rep]),
//   s_j = (q'[b, h] . K[b, j, h / rep]) * D^-0.5 (soft-capped if asked)
//
// over the rows lo <= j < hi, with cur = pos[b] + 1, hi = min(cur, S) and
// lo = max(cur - window, 0) (0 without a window).  Rows outside [lo, hi)
// weigh exactly 0 in the plain route's softmax (exp(-1e30 - m) = 0 in f32),
// so they are not read.  Where no row is valid (a windowed idle slot whose
// position ran past the cache) the plain route's scores are all -1e30 and
// its softmax weighs every row of the cache alike; so does this kernel.
// An idle slot at pos >= S writes nothing and, without a window, attends
// over all S rows, as the plain route's dropped write and mask do.  With
// RoPE and the append off (`k_new` null) the kernel only attends, with
// cur = pos[b] (the caller's count of valid rows): the route of the ring
// cache, of int8 KV after its dequantization and of the aligned window.
//
// Rounding as the plain route's: the angle pos * freq is one f32 product
// (freq is the plain code's vector, computed once by the wrapper), cosf and
// sinf as PyTorch's elementwise kernels call them, and the rotation's
// products and sums rounded one by one (`__fmul_rn`, `__fsub_rn`,
// `__fadd_rn`: no FMA contraction), then rounded to bf16, so the rows
// written equal the plain route's.  Scores, softmax and the value sum run
// in f32; only their order differs from the plain route's f32 gemv.
//
// What bounds it on an H100: bytes.  A query head does 4 * D operations per
// cached row of 4 * D bytes (K and V in bf16) shared by rep = H / Hkv query
// heads: rep operations a byte (1 to 5 in the port's configurations)
// against the card's ~295, so the work is reading each valid row once.
// Design for that:
//  * split KV (flash-decoding): a CTA of 128 threads per (chunk of rows,
//    KV head, group of up to 8 of its query heads, sequence); the grid
//    follows the cache's static shape and a CTA whose chunk lies outside
//    its sequence's [lo, hi) exits at once, so the host passes no lengths
//    and never waits for the device;
//  * D / 8 threads per row, each reading one 16-byte run of 8 bf16 values,
//    neighbouring threads on neighbouring addresses; the warp's lanes of a
//    row add their partial dot products by xor shuffles; U row passes'
//    loads are issued before their arithmetic, to keep bytes in flight;
//  * f32 math on the CUDA cores: one query row per head (times rep) gives
//    the tensor cores no tile to fill;
//  * the chunk's scores stay in shared memory between the K pass and the V
//    pass; each CTA leaves its (max, sum, accumulator) in an f32 scratch
//    that the merge kernel folds, or writes the output itself when the
//    cache is one chunk long;
//  * a CTA's first row group rotates its query rows once (each angle's
//    cos and sin serve every head) into shared memory; the CTA whose chunk
//    holds pos rotates the new k row itself and takes it and the new v
//    row from shared memory (no CTA reads that row from the cache, so
//    there is no ordering between CTAs); the first query group's CTA
//    writes both rows to the cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPart = 4;   // m, l and two pad words before each partial's acc

struct Params {
  const __nv_bfloat16* q;      // [B, H, D]
  const __nv_bfloat16* k_new;  // [B, Hkv, D]; null: attend only
  const __nv_bfloat16* v_new;  // [B, Hkv, D]
  __nv_bfloat16* k_cache;      // [B, S, Hkv, D]
  __nv_bfloat16* v_cache;      // [B, S, Hkv, D]
  const int64_t* pos;          // pos[b * pos_stride]
  const float* freq;           // [D / 2] (with k_new)
  float* part;                 // [B, H, n_chunks, kPart + D]; null: direct
  __nv_bfloat16* out;          // [B, H, D]
  int B, S, H, Hkv, D, rep, n_groups, chunk, n_chunks;
  int pos_stride, cur_offset, window;  // window <= 0: none
  float scale, softcap;                // softcap <= 0: none
};

// The rows sequence b attends over, and the row this step writes.
struct Rows {
  int lo, hi;
  int new_row;   // -1: none
  bool uniform;  // no valid row: every row weighs alike
};

__device__ __forceinline__ Rows rows_of(const Params& p, int b) {
  const long long pos = p.pos[static_cast<long long>(b) * p.pos_stride];
  const long long cur = pos + p.cur_offset;
  const long long hi = cur < p.S ? cur : p.S;
  const long long lo =
      (p.window > 0 && cur - p.window > 0) ? cur - p.window : 0;
  Rows r;
  r.uniform = lo >= hi;
  r.lo = r.uniform ? 0 : static_cast<int>(lo);
  r.hi = r.uniform ? p.S : static_cast<int>(hi);
  r.new_row = (p.k_new != nullptr && pos >= 0 && pos < p.S)
                  ? static_cast<int>(pos) : -1;
  return r;
}

__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Exact for values that are bf16 already.
__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// cos and sin of the angles pos * freq of dims [d0, d0 + 8), the angle one
// f32 product, as apply_rope computes them.
template <int D>
__device__ __forceinline__ void angles8(int d0, float posf, const float* freq,
                                        float c[8], float s[8]) {
  const int f0 = d0 < D / 2 ? d0 : d0 - D / 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float ang = __fmul_rn(posf, freq[f0 + i]);
    c[i] = cosf(ang);
    s[i] = sinf(ang);
  }
}

// Dims [d0, d0 + 8) of `row` rotated by RoPE, rounded to bf16 as
// apply_rope's cast does: x1 * cos - x2 * sin in the first half, x2 * cos +
// x1 * sin in the second, each product and sum rounded alone.
template <int D>
__device__ __forceinline__ void rope8(const __nv_bfloat16* row, int d0,
                                      const float c[8], const float s[8],
                                      float out[8]) {
  constexpr int kHalf = D / 2;
  const bool first = d0 < kHalf;
  float x[8], y[8];  // this run, and its partner in the other half
  unpack8(*reinterpret_cast<const uint4*>(row + d0), x);
  unpack8(*reinterpret_cast<const uint4*>(row + (first ? d0 + kHalf
                                                       : d0 - kHalf)), y);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = first
        ? __fsub_rn(__fmul_rn(x[i], c[i]), __fmul_rn(y[i], s[i]))
        : __fadd_rn(__fmul_rn(x[i], c[i]), __fmul_rn(y[i], s[i]));
    out[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One CTA: rows [j0, j1) of chunk blockIdx.x, KV head and query group
// blockIdx.y, sequence blockIdx.z; R query heads (the group's last may be
// short of R, its spare rows computed on zeros and never stored).
template <int D, int R>
__global__ void __launch_bounds__(kThreads)
    decode_attn_split_kernel(const Params p) {
  constexpr int TPR = D / 8;             // threads per row
  constexpr int RPI = kThreads / TPR;    // rows per pass of the CTA
  constexpr int U = R <= 4 ? 4 : 2;      // passes with loads in flight
  const int c = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / p.n_groups;
  const int grp = blockIdx.y - kvh * p.n_groups;
  const Rows rw = rows_of(p, b);
  const int c0 = c * p.chunk;
  const int j0 = max(c0, rw.lo), j1 = min(c0 + p.chunk, rw.hi);
  if (j0 >= j1) return;
  const int h0 = kvh * p.rep + grp * R;
  const int nr = min(R, p.rep - grp * R);
  const int tid = threadIdx.x, t = tid % TPR, g = tid / TPR;
  const int lane = tid & 31, warp = tid >> 5;
  const int d0 = 8 * t;

  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);  // [R][chunk]; then [kWarps][R][D]
  __shared__ float s_m[R], s_l[R];
  __shared__ __align__(16) float s_q[R][D];
  __shared__ __align__(16) __nv_bfloat16 s_new[2][D];

  // The first row group rotates the query rows (and, in the chunk that
  // holds pos, the new k row) once; every row group reads them back.
  const int new_row =
      (rw.new_row >= j0 && rw.new_row < j1) ? rw.new_row : -1;
  if (g == 0) {
    const bool fused = p.k_new != nullptr;
    float cs[8], sn[8];
    if (fused)
      angles8<D>(d0, __ll2float_rn(
                         p.pos[static_cast<long long>(b) * p.pos_stride]),
                 p.freq, cs, sn);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x[8];
      if (r < nr) {
        const __nv_bfloat16* row =
            p.q + (static_cast<size_t>(b) * p.H + h0 + r) * D;
        if (fused)
          rope8<D>(row, d0, cs, sn, x);
        else
          unpack8(*reinterpret_cast<const uint4*>(row + d0), x);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(&s_q[r][d0]);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    if (new_row >= 0) {
      const size_t row = (static_cast<size_t>(b) * p.Hkv + kvh) * D;
      float kr[8];
      rope8<D>(p.k_new + row, d0, cs, sn, kr);
      const uint4 kp = pack8(kr);
      const uint4 vp = *reinterpret_cast<const uint4*>(p.v_new + row + d0);
      *reinterpret_cast<uint4*>(&s_new[0][d0]) = kp;
      *reinterpret_cast<uint4*>(&s_new[1][d0]) = vp;
      if (grp == 0) {
        const size_t dst =
            ((static_cast<size_t>(b) * p.S + new_row) * p.Hkv + kvh) * D +
            d0;
        *reinterpret_cast<uint4*>(p.k_cache + dst) = kp;
        *reinterpret_cast<uint4*>(p.v_cache + dst) = vp;
      }
    }
  }
  __syncthreads();
  float qr[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4* src = reinterpret_cast<const float4*>(&s_q[r][d0]);
    const float4 a = src[0], c4 = src[1];
    qr[r][0] = a.x; qr[r][1] = a.y; qr[r][2] = a.z; qr[r][3] = a.w;
    qr[r][4] = c4.x; qr[r][5] = c4.y; qr[r][6] = c4.z; qr[r][7] = c4.w;
  }

  const size_t row_stride = static_cast<size_t>(p.Hkv) * D;
  const size_t at0 =
      (static_cast<size_t>(b) * p.S * p.Hkv + kvh) * D + d0;
  const __nv_bfloat16* kb = p.k_cache + at0;
  const __nv_bfloat16* vb = p.v_cache + at0;
  const int CH = p.chunk;

  // K pass: the scores of rows [j0, j1) into shared memory.  `base` is the
  // same in every thread, so every lane reaches the shuffles.
  for (int base = j0; base < j1; base += RPI * U) {
    uint4 kv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * RPI + g;
      if (j >= j1 || rw.uniform)
        kv[u] = make_uint4(0u, 0u, 0u, 0u);
      else if (j == new_row)
        kv[u] = *reinterpret_cast<const uint4*>(&s_new[0][d0]);
      else
        kv[u] = *reinterpret_cast<const uint4*>(kb + j * row_stride);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * RPI + g;
      float kf[8];
      unpack8(kv[u], kf);
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s = fmaf(qr[r][i], kf[i], s);
        dot[r] = s;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
      }
      if (t == 0 && j < j1) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = dot[r] * p.scale;
          if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
          sc[r * CH + (j - c0)] = rw.uniform ? 0.f : s;
        }
      }
    }
  }
  __syncthreads();

  // The chunk's max and the probabilities exp(s - m), with their sum.
  const int n = j1 - j0;
  for (int r = warp; r < R; r += kWarps) {
    float* s = sc + r * CH + (j0 - c0);
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, s[i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(s[i] - m);
      s[i] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      s_m[r] = m;
      s_l[r] = l;
    }
  }
  __syncthreads();

  // V pass: this thread's 8 dims of sum_j p_j v_j over its rows.
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  for (int base = j0; base < j1; base += RPI * U) {
    uint4 vv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * RPI + g;
      if (j >= j1)
        vv[u] = make_uint4(0u, 0u, 0u, 0u);
      else if (j == new_row)
        vv[u] = *reinterpret_cast<const uint4*>(&s_new[1][d0]);
      else
        vv[u] = *reinterpret_cast<const uint4*>(vb + j * row_stride);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * RPI + g;
      if (j < j1) {
        float vf[8];
        unpack8(vv[u], vf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pr = sc[r * CH + (j - c0)];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(pr, vf[i], acc[r][i]);
        }
      }
    }
  }

  // Sum over the rows of a warp (lanes TPR apart), then over the warps.
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);
  }
  __syncthreads();  // every thread has read its probabilities
  float* red = sc;
  if (lane < TPR) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float4* dst = reinterpret_cast<float4*>(red + (warp * R + r) * D + d0);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();
  const size_t stride = kPart + D;
  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[(w * R + r) * D + d];
    const size_t h = static_cast<size_t>(b) * p.H + h0 + r;
    if (p.part == nullptr)
      p.out[h * D + d] = __float2bfloat16_rn(a / s_l[r]);
    else
      p.part[(h * p.n_chunks + c) * stride + kPart + d] = a;
  }
  if (p.part != nullptr && tid < nr) {
    const size_t h = static_cast<size_t>(b) * p.H + h0 + tid;
    p.part[(h * p.n_chunks + c) * stride] = s_m[tid];
    p.part[(h * p.n_chunks + c) * stride + 1] = s_l[tid];
  }
}

// One CTA of D threads per (query head, sequence): folds the partials of
// the chunks that sequence's rows touch.
__global__ void __launch_bounds__(256) decode_attn_merge_kernel(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const Rows rw = rows_of(p, b);
  const int ca = rw.lo / p.chunk, cb = (rw.hi - 1) / p.chunk;
  const size_t stride = kPart + p.D;
  const float* part = p.part +
      (static_cast<size_t>(b) * p.H + h) * p.n_chunks * stride;
  float m = -INFINITY;
  for (int c = ca; c <= cb; ++c) m = fmaxf(m, part[c * stride]);
  float l = 0.f, a = 0.f;
  for (int c = ca; c <= cb; ++c) {
    const float w = expf(part[c * stride] - m);
    l = fmaf(part[c * stride + 1], w, l);
    a = fmaf(part[c * stride + kPart + d], w, a);
  }
  p.out[(static_cast<size_t>(b) * p.H + h) * p.D + d] =
      __float2bfloat16_rn(a / l);
}

template <int D, int R>
cudaError_t launch_split(const Params& p, cudaStream_t s) {
  const int words = R * p.chunk > kWarps * R * D ? R * p.chunk
                                                  : kWarps * R * D;
  const dim3 grid(p.n_chunks, p.Hkv * p.n_groups, p.B);
  decode_attn_split_kernel<D, R>
      <<<grid, kThreads, sizeof(float) * words, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int R, const Params& p, cudaStream_t s) {
  switch (R) {
    case 1: return launch_split<D, 1>(p, s);
    case 2: return launch_split<D, 2>(p, s);
    case 4: return launch_split<D, 4>(p, s);
    case 8: return launch_split<D, 8>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, D], caches [B, S, Hkv, D], out [B, H, D]: bf16, contiguous,
// 16-byte aligned.  k_new / v_new [B, Hkv, D] and freq [D / 2] f32, or all
// three null to attend only.  pos: int64, pos[b * pos_stride]; a sequence
// attends over rows below min(pos[b] + cur_offset, S).  R in {1, 2, 4, 8}
// query heads a CTA; chunk rows a CTA; part: f32 scratch [B, H,
// ceil(S / chunk), 4 + D], or null when S <= chunk.  window <= 0: none;
// softcap <= 0: none.  D in {32, 64, 128, 256}.  Returns the CUDA error
// code of the launches (0 on success); the caller checks it.
int decode_attention(const void* q, const void* k_new, const void* v_new,
                     void* k_cache, void* v_cache, const void* pos,
                     int pos_stride, int cur_offset, const void* freq,
                     void* part, void* out, int B, int S, int H, int Hkv,
                     int D, int R, int chunk, int window, float scale,
                     float softcap, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || chunk <= 0 ||
      (k_new == nullptr) != (v_new == nullptr) ||
      (k_new != nullptr && freq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_new = static_cast<const __nv_bfloat16*>(k_new);
  p.v_new = static_cast<const __nv_bfloat16*>(v_new);
  p.k_cache = static_cast<__nv_bfloat16*>(k_cache);
  p.v_cache = static_cast<__nv_bfloat16*>(v_cache);
  p.pos = static_cast<const int64_t*>(pos);
  p.freq = static_cast<const float*>(freq);
  p.part = static_cast<float*>(part);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.rep = H / Hkv;
  p.n_groups = (p.rep + R - 1) / R;
  p.chunk = chunk;
  p.n_chunks = (S + chunk - 1) / chunk;
  p.pos_stride = pos_stride;
  p.cur_offset = cur_offset;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  if (p.n_chunks > 1 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch_d<32>(R, p, s); break;
    case 64: err = launch_d<64>(R, p, s); break;
    case 128: err = launch_d<128>(R, p, s); break;
    case 256: err = launch_d<256>(R, p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  decode_attn_merge_kernel<<<dim3(H, B), D, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* decode_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
