// The attention of one multi-head latent attention (MLA) layer of a batched
// decode step, absorbed, for Hopper (sm_90a): RoPE on the query's and the
// new key's rope dims, the new latent and rope rows appended to the bf16
// caches, and attention of all heads of each sequence over its latent rows,
// in one split kernel and (when the cache spans more than one chunk) one
// merge kernel.
//
// It replaces no TPU kernel: the JAX package has no MLA.  The port added it
// for DeepSeek-V2-Lite, whose cache holds per token and layer a normed
// latent c_kv of R = 512 dims and one rotated key k_pe of E = 64 dims shared
// by all heads.  Without the absorption each step would lift every cached
// latent row through kv_b to each head's K and V.  With it, W_UK is folded
// into the query (q_lat = W_UK q_nope, by the caller), and every head reads
// the latent rows themselves.  The function is the plain route's
// (src/repro_torch/kernels/mla_decode/ref.py):
//
//   q_pe' = bf16(rope(q_pe, pos)),  k_pe' = bf16(rope(k_pe, pos))
//   ckv[b, pos[b]] = c_kv,  kpe[b, pos[b]] = k_pe'          (if pos[b] < S)
//   o_lat[h, b] = bf16(softmax_j(s_j) @ ckv[b]),
//   s_j = (q_lat[b, h] . ckv[b, j] + q_pe'[b, h] . kpe[b, j]) * scale
//
// over the rows j < min(pos[b] + 1, S).  Rounding of the rotation as the
// plain route's: the angle pos * freq is one f32 product (freq is the plain
// code's vector, passed by the wrapper), cosf and sinf as PyTorch's
// elementwise kernels call them, times the cos/sin scale where it is not 1,
// and the products and sums rounded one by one, then to bf16; so the rows
// written equal the plain route's.  Scores, softmax and the value sum run in
// f32 on the tensor cores' f32 accumulators; the probabilities enter the
// value product as three bf16 terms (hi + mid + lo, 24 bits of mantissa
// together: two terms leave 2^-18 of each, which a sum that cancels to
// near 0 shows), so only the order of the sums differs from the plain
// route's f32.
//
// What bounds it on an H100: bytes.  A row of 1,152 bytes serves every head:
// 2 * H * (R + E) + 2 * H * R operations, 30 a byte at 16 heads, below the
// card's ~295 for bf16 on the tensor cores but above the ~20 that its f32
// CUDA cores sustain, so the products run on the tensor cores with the 16
// heads as the M = 16 of `mma.sync m16n8k16`.  Design for that:
//  * split KV (flash-decoding): one CTA of 4 warps per (chunk of rows,
//    sequence); the grid follows the cache's static shape and a CTA whose
//    chunk lies past its sequence's rows exits at once, so the host passes no
//    lengths and never waits for the device;
//  * each CTA reads its rows once, in tiles of 32 (36,864 bytes of latent
//    and rope dims), double-buffered in shared memory with `cp.async`;
//  * scores: each warp takes 8 rows of a tile against the whole query (16
//    heads by 576 dims, rotated once into shared memory by the CTA); the
//    softmax's running max and sum per head are shared through shared
//    memory, so every warp holds the same;
//  * values: each warp takes 128 of the 512 output dims, over all 32 rows of
//    the tile, with the latent rows read again from shared memory as the
//    value operand (`ldmatrix.trans`);
//  * each CTA leaves its (max, sum, accumulator) in an f32 scratch that the
//    merge kernel folds, or writes the output itself when the cache is one
//    chunk long;
//  * the CTA whose chunk holds pos rotates the new rope key, writes both new
//    rows to the caches, and uses them from shared memory (no CTA reads that
//    row from the cache, so there is no ordering between CTAs).
// The output is o_lat in [H, B, R], the layout the caller's W_UV product
// reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int R = 512;             // latent dims
constexpr int E = 64;              // rope dims
constexpr int KD = R + E;          // score depth
constexpr int HM = 16;             // heads, the MMA's M
constexpr int TR = 32;             // rows a tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int LDK = KD + 8;        // shared row stride (elements)
constexpr int LDP = TR + 8;        // probabilities' row stride
constexpr int RUNS = KD / 8;       // 16-byte runs of a row
constexpr int kPart = 4;           // m, l and two pad words before each acc
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSplit = 3;          // bf16 terms of a probability
constexpr size_t kSmem =
    sizeof(bf16) * (HM * LDK + 2 * TR * LDK + kSplit * HM * LDP + KD) +
    sizeof(float) * 2 * kWarps * HM;

struct Params {
  const bf16* q_lat;           // [B, H, R] at strides (q_lat_sb, q_lat_sh)
  const bf16* q_pe;            // [B, H, E] before RoPE
  const bf16* ckv_new;         // [B, R] at stride ckv_new_sb
  const bf16* kpe_new;         // [B, E] before RoPE
  bf16* ckv;                   // [B, S, R]
  bf16* kpe;                   // [B, S, E]
  const int64_t* pos;          // pos[b * pos_stride]
  const float* freq;           // [E / 2]
  float* part;                 // [B, H, n_chunks, kPart + R]; null: direct
  bf16* out;                   // [H, B, R]
  long long q_lat_sb, q_lat_sh, q_pe_sb, q_pe_sh, ckv_new_sb, kpe_new_sb;
  int B, S, H, chunk, n_chunks, pos_stride;
  float rope_scale, scale;
};

__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// Dims [d0, d0 + 8) of the E-dim `row` rotated at position `posf`: each half
// with the other, as apply_rope_freqs computes it, rounded to bf16.
__device__ __forceinline__ uint4 rope8(const bf16* row, int d0, float posf,
                                       const float* freq, float rs) {
  constexpr int kHalf = E / 2;
  const bool first = d0 < kHalf;
  const int f0 = first ? d0 : d0 - kHalf;
  float x[8], y[8], out[8];  // this run, and its partner in the other half
  unpack8(*reinterpret_cast<const uint4*>(row + d0), x);
  unpack8(*reinterpret_cast<const uint4*>(row + (first ? d0 + kHalf
                                                       : d0 - kHalf)), y);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float ang = __fmul_rn(posf, freq[f0 + i]);
    float c = cosf(ang), s = sinf(ang);
    if (rs != 1.f) {
      c = __fmul_rn(c, rs);
      s = __fmul_rn(s, rs);
    }
    const float v = first
        ? __fsub_rn(__fmul_rn(x[i], c), __fmul_rn(y[i], s))
        : __fadd_rn(__fmul_rn(x[i], c), __fmul_rn(y[i], s));
    out[i] = __bfloat162float(__float2bfloat16_rn(v));
  }
  return pack8(out);
}

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  return hopper::pack_bf16(lo, hi);
}

// One CTA: rows [j0, j1) of chunk blockIdx.x of sequence blockIdx.y, all
// heads.
__global__ void __launch_bounds__(kThreads, 2)
    mla_decode_split_kernel(const Params p) {
  const int c = blockIdx.x, b = blockIdx.y;
  const long long pos = p.pos[static_cast<long long>(b) * p.pos_stride];
  const int hi = pos + 1 < p.S ? static_cast<int>(pos + 1) : p.S;
  const int j0 = c * p.chunk;
  const int j1 = min(j0 + p.chunk, hi);
  if (j0 >= j1) return;
  const int new_row = (pos >= j0 && pos < j1) ? static_cast<int>(pos) : -1;
  const int n_tiles = (j1 - j0 + TR - 1) / TR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;

  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);       // [HM][LDK]
  bf16* sK = sQ + HM * LDK;                         // [2][TR][LDK]
  bf16* sP = sK + 2 * TR * LDK;                     // [kSplit][HM][LDP]
  bf16* sNew = sP + kSplit * HM * LDP;              // [KD]
  float* red_max = reinterpret_cast<float*>(sNew + KD);  // [kWarps][HM]
  float* red_sum = red_max + kWarps * HM;

  const size_t seq = static_cast<size_t>(b) * p.S;
  auto load_tile = [&](int t) {
    const int base = j0 + t * TR;
    bf16* dst = sK + (t & 1) * TR * LDK;
    for (int i = tid; i < TR * RUNS; i += kThreads) {
      const int r = i / RUNS, cc = i - r * RUNS;
      const int j = base + r;
      const bool ok = j < j1 && j != new_row;
      const size_t row = seq + (ok ? j : j0);
      const bf16* src = cc < R / 8 ? p.ckv + row * R + cc * 8
                                   : p.kpe + row * E + (cc - R / 8) * 8;
      hopper::cp_async16(dst + r * LDK + cc * 8, src, ok);
    }
    hopper::cp_async_commit();
  };
  load_tile(0);

  // The query: q_lat, and q_pe rotated, one row a head (zeros past H).
  const float posf = __ll2float_rn(pos);
  for (int i = tid; i < HM * (R / 8); i += kThreads) {
    const int h = i / (R / 8), cc = i - h * (R / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (h < p.H)
      v = *reinterpret_cast<const uint4*>(p.q_lat + b * p.q_lat_sb +
                                          h * p.q_lat_sh + cc * 8);
    *reinterpret_cast<uint4*>(sQ + h * LDK + cc * 8) = v;
  }
  for (int i = tid; i < HM * (E / 8); i += kThreads) {
    const int h = i / (E / 8), d0 = 8 * (i - h * (E / 8));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (h < p.H)
      v = rope8(p.q_pe + b * p.q_pe_sb + h * p.q_pe_sh, d0, posf, p.freq,
                p.rope_scale);
    *reinterpret_cast<uint4*>(sQ + h * LDK + R + d0) = v;
  }
  // The new rows: into shared memory for this CTA's tile, and the caches.
  if (new_row >= 0) {
    for (int i = tid; i < RUNS; i += kThreads) {
      uint4 v;
      if (i < R / 8) {
        v = *reinterpret_cast<const uint4*>(p.ckv_new + b * p.ckv_new_sb +
                                            i * 8);
        *reinterpret_cast<uint4*>(p.ckv + (seq + new_row) * R + i * 8) = v;
      } else {
        const int d0 = 8 * (i - R / 8);
        v = rope8(p.kpe_new + b * p.kpe_new_sb, d0, posf, p.freq,
                  p.rope_scale);
        *reinterpret_cast<uint4*>(p.kpe + (seq + new_row) * E + d0) = v;
      }
      *reinterpret_cast<uint4*>(sNew + i * 8) = v;
    }
  }

  const float sl2 = p.scale * kLog2e;
  float m_run[2] = {-INFINITY, -INFINITY};  // heads g and g + 8
  float l_run[2] = {0.f, 0.f};
  float acc[16][4];  // this warp's 128 output dims: 16 tiles of 8
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const int base = j0 + t * TR;
    bf16* sKt = sK + (t & 1) * TR * LDK;
    if (new_row >= base && new_row < base + TR) {
      for (int i = tid; i < RUNS; i += kThreads)
        *reinterpret_cast<uint4*>(sKt + (new_row - base) * LDK + i * 8) =
            *reinterpret_cast<const uint4*>(sNew + i * 8);
      __syncthreads();
    }

    // Scores of this warp's 8 rows for all heads, in four chains of 9
    // k-steps each, added in f32 at the end: the tensor cores' f32
    // accumulation truncates, and shorter chains keep it near the plain
    // route's rounding.
    float sc[4][4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[ch][i] = 0.f;
    const bf16* qa = sQ + (lane & 15) * LDK + (lane >> 4) * 8;
    const bf16* kb = sKt + (warp * 8 + (lane & 7)) * LDK + (lane >> 3) * 8;
#pragma unroll 3
    for (int kk = 0; kk < KD / 16; kk += 4) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        uint32_t a0[4], a1[4], bk[4];
        const int k0 = (kk + 2 * h2) * 16;
        hopper::ldmatrix_x4(a0, qa + k0);
        hopper::ldmatrix_x4(a1, qa + k0 + 16);
        hopper::ldmatrix_x4(bk, kb + k0);
        hopper::mma_bf16(sc[2 * h2], a0, bk[0], bk[1]);
        hopper::mma_bf16(sc[2 * h2 + 1], a1, bk[2], bk[3]);
      }
    }
    const int r0 = warp * 8 + 2 * q4;  // this thread's rows r0, r0 + 1
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dot = (sc[0][i] + sc[1][i]) + (sc[2][i] + sc[3][i]);
      s[i] = base + r0 + (i & 1) < j1 ? dot * sl2 : -INFINITY;
    }
    float mx0 = fmaxf(s[0], s[1]), mx1 = fmaxf(s[2], s[3]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (q4 == 0) {
      red_max[warp * HM + g] = mx0;
      red_max[warp * HM + g + 8] = mx1;
    }
    __syncthreads();
    float tm0 = red_max[g], tm1 = red_max[g + 8];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      tm0 = fmaxf(tm0, red_max[w * HM + g]);
      tm1 = fmaxf(tm1, red_max[w * HM + g + 8]);
    }
    const float mn0 = fmaxf(m_run[0], tm0), mn1 = fmaxf(m_run[1], tm1);
    const float al0 = exp2f(m_run[0] - mn0), al1 = exp2f(m_run[1] - mn1);
    m_run[0] = mn0;
    m_run[1] = mn1;
    float pr[4];
    pr[0] = exp2f(s[0] - mn0);
    pr[1] = exp2f(s[1] - mn0);
    pr[2] = exp2f(s[2] - mn1);
    pr[3] = exp2f(s[3] - mn1);
    // p as kSplit bf16 terms: each the rounding of what the ones before
    // leave (exact in f32).
    float rest[4] = {pr[0], pr[1], pr[2], pr[3]};
#pragma unroll
    for (int t3 = 0; t3 < kSplit; ++t3) {
      float term[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        term[i] = __bfloat162float(__float2bfloat16_rn(rest[i]));
        rest[i] -= term[i];
      }
      bf16* dst = sP + t3 * HM * LDP;
      *reinterpret_cast<uint32_t*>(dst + g * LDP + r0) =
          bf2(term[0], term[1]);
      *reinterpret_cast<uint32_t*>(dst + (g + 8) * LDP + r0) =
          bf2(term[2], term[3]);
    }
    float ps0 = pr[0] + pr[1], ps1 = pr[2] + pr[3];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    if (q4 == 0) {
      red_sum[warp * HM + g] = ps0;
      red_sum[warp * HM + g + 8] = ps1;
    }
    __syncthreads();
    float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ts0 += red_sum[w * HM + g];
      ts1 += red_sum[w * HM + g + 8];
    }
    l_run[0] = l_run[0] * al0 + ts0;
    l_run[1] = l_run[1] * al1 + ts1;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // Values: this warp's 128 latent dims over the tile's 32 rows.
    const int mi = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < TR / 16; ++ks) {
      uint32_t ap[kSplit][4];
#pragma unroll
      for (int t3 = 0; t3 < kSplit; ++t3)
        hopper::ldmatrix_x4(ap[t3], sP + t3 * HM * LDP + (lane & 15) * LDP +
                                        ks * 16 + (lane >> 4) * 8);
      const bf16* vb = sKt + (ks * 16 + (mi & 1) * 8 + (lane & 7)) * LDK +
                       warp * 128 + (mi >> 1) * 8;
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t bv[4];
        hopper::ldmatrix_x4_trans(bv, vb + np * 16);
#pragma unroll
        for (int t3 = 0; t3 < kSplit; ++t3) {
          hopper::mma_bf16(acc[2 * np], ap[t3], bv[0], bv[1]);
          hopper::mma_bf16(acc[2 * np + 1], ap[t3], bv[2], bv[3]);
        }
      }
    }
    // Every warp is done with this stage and the probabilities before the
    // next tile's copy and scores overwrite them.
    __syncthreads();
  }

  const int heads[2] = {g, g + 8};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = heads[hh];
    if (h >= p.H) continue;
    const size_t ph = static_cast<size_t>(b) * p.H + h;
    if (p.part == nullptr) {
      bf16* o = p.out + (static_cast<size_t>(h) * p.B + b) * R + warp * 128 +
                2 * q4;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<uint32_t*>(o + n * 8) =
            bf2(acc[n][2 * hh] / l_run[hh], acc[n][2 * hh + 1] / l_run[hh]);
    } else {
      float* dst = p.part + (ph * p.n_chunks + c) * (kPart + R);
      if (warp == 0 && q4 == 0) {
        dst[0] = m_run[hh];
        dst[1] = l_run[hh];
      }
      float* a = dst + kPart + warp * 128 + 2 * q4;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<float2*>(a + n * 8) =
            make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
}

// One CTA of 128 threads per (head, sequence), 4 dims a thread: folds the
// partials of the chunks that sequence's rows touch.
__global__ void __launch_bounds__(kThreads) mla_decode_merge_kernel(
    const Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = 4 * threadIdx.x;
  const long long pos = p.pos[static_cast<long long>(b) * p.pos_stride];
  const int hi = pos + 1 < p.S ? static_cast<int>(pos + 1) : p.S;
  const int cb = (hi - 1) / p.chunk;
  const size_t stride = kPart + R;
  const float* part =
      p.part + (static_cast<size_t>(b) * p.H + h) * p.n_chunks * stride;
  float m = -INFINITY;
  for (int c = 0; c <= cb; ++c) m = fmaxf(m, part[c * stride]);
  float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c <= cb; ++c) {
    const float w = exp2f(part[c * stride] - m);
    l = fmaf(part[c * stride + 1], w, l);
    const float4 v =
        *reinterpret_cast<const float4*>(part + c * stride + kPart + d);
    a[0] = fmaf(v.x, w, a[0]);
    a[1] = fmaf(v.y, w, a[1]);
    a[2] = fmaf(v.z, w, a[2]);
    a[3] = fmaf(v.w, w, a[3]);
  }
  bf16* o = p.out + (static_cast<size_t>(h) * p.B + b) * R + d;
  *reinterpret_cast<uint32_t*>(o) = bf2(a[0] / l, a[1] / l);
  *reinterpret_cast<uint32_t*>(o + 2) = bf2(a[2] / l, a[3] / l);
}

bool g_smem_done[hopper::MAX_DEVICES];

}  // namespace

extern "C" {

// q_lat [B, H, 512] and q_pe [B, H, 64] at strides (sb, sh) in elements,
// ckv_new [B, 512] and kpe_new [B, 64] at stride sb, caches [B, S, 512] and
// [B, S, 64], out [H, B, 512]: bf16, each row contiguous and 16-byte
// aligned.  pos: int64, pos[b * pos_stride].  freq: [32] f32.  part: f32
// scratch [B, H, ceil(S / chunk), 4 + 512], or null when S <= chunk.
// H <= 16.  Returns the CUDA error code of the launches (0 on success).
int mla_decode(const void* q_lat, long long q_lat_sb, long long q_lat_sh,
               const void* q_pe, long long q_pe_sb, long long q_pe_sh,
               const void* ckv_new, long long ckv_new_sb,
               const void* kpe_new, long long kpe_new_sb, void* ckv,
               void* kpe, const void* pos, int pos_stride, const void* freq,
               float rope_scale, float scale, void* part, void* out, int B,
               int S, int H, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || H > HM || chunk <= 0 ||
      chunk % TR != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q_lat = static_cast<const bf16*>(q_lat);
  p.q_pe = static_cast<const bf16*>(q_pe);
  p.ckv_new = static_cast<const bf16*>(ckv_new);
  p.kpe_new = static_cast<const bf16*>(kpe_new);
  p.ckv = static_cast<bf16*>(ckv);
  p.kpe = static_cast<bf16*>(kpe);
  p.pos = static_cast<const int64_t*>(pos);
  p.freq = static_cast<const float*>(freq);
  p.part = static_cast<float*>(part);
  p.out = static_cast<bf16*>(out);
  p.q_lat_sb = q_lat_sb;
  p.q_lat_sh = q_lat_sh;
  p.q_pe_sb = q_pe_sb;
  p.q_pe_sh = q_pe_sh;
  p.ckv_new_sb = ckv_new_sb;
  p.kpe_new_sb = kpe_new_sb;
  p.B = B;
  p.S = S;
  p.H = H;
  p.chunk = chunk;
  p.n_chunks = (S + chunk - 1) / chunk;
  p.pos_stride = pos_stride;
  p.rope_scale = rope_scale;
  p.scale = scale;
  if (p.n_chunks > 1 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      hopper::allow_smem_once(mla_decode_split_kernel, kSmem, g_smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mla_decode_split_kernel<<<dim3(p.n_chunks, B), kThreads, kSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  mla_decode_merge_kernel<<<dim3(H, B), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* mla_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
