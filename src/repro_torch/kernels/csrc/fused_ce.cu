// Logits-free fused LM cross-entropy for Hopper (sm_90a): the forward
// sweep (labelled, or with the in-sweep Gumbel-argmax draw of GNB's
// sampled labels) and the two backward sweeps, d(normed hidden) and dW.
//
// Replaces the TPU kernels of src/repro/kernels/fused_ce.py:
//   the forward (SAMPLE = false)       _ce_forward (pallas_call :521,
//                                      body _ce_fwd_kernel :281)
//   the forward (SAMPLE = true)        _ce_forward_sampled (:544, body :312)
//     fp32 h: ce_forward_kernel<SAMPLE>; bf16 h: ce_mma_kernel with the
//     kEpiLse / kEpiSample epilogue; both then ce_combine_kernel
//   ce_backward_dh_kernel              _ce_backward's dh sweep (:601, body
//                                      _ce_bwd_dh_kernel :388) and the dh
//                                      half of its fused schedule (:583,
//                                      body _ce_bwd_fused_kernel :443)
//   ce_backward_dw_kernel              _ce_backward's dW sweep (:621, body
//                                      _ce_bwd_dw_kernel :413) and the dW
//                                      half of the fused schedule
// The TPU's one-sweep "fused" backward exists only because of a Pallas
// pipelining rule (an output block must not be revisited after another
// was written); blocks here own their outputs outright, so the backward
// is always the dh kernel and the dW kernel.
//
// The function, as the reference computes it: the final norm applied to
// each hidden row (fp32 statistics, cast back to h's dtype T: ln =
// (x - mu) * rstd * scale + bias, rms = x * rstd * (1 + scale)); logits
// h_n . W^T with W cast to T and products summed in fp32; softcap
// c * tanh(s / c); padded vocab columns (>= V) at the -1e30 sentinel.
//   forward:  lse = m + log(max(l, 1e-37)) by the online max / sum-exp,
//             and the logit at the label, or, sampled, the first argmax
//             of s + g over valid columns with g = hash_gumbel(seed, row,
//             col) and the raw logit there; ``row`` is the row's index, or
//             row_ids[row] where the caller gives each row its index in a
//             larger batch (a data-parallel rank's rows).  Only (N,) vectors are
//             written; the (N, Vp) logits never exist.
//   backward: d = (exp(s - lse) - onehot(label)) * rs * dcap, rs the
//             rowscale times the loss cotangent; dh = d . W (W in fp32)
//             and dW = d^T . h_n (h_n in fp32), both summed in fp32, dW
//             rounded once into W's dtype.
//
// Bound: operations.  Each sweep multiplies (N, D) by (D, Vp): 2 N D Vp
// flops for the forward, twice that for each backward kernel (the logits
// are recomputed), against one read of h and W.  At the GPT-2 small
// training shape (N = 8192, D = 768, Vp = 50304) that is ~2,600 flops per
// byte, far above the ~295 where the card's bf16 tensor cores stop being
// the limit.
//
// The forward with h in fp32 (the card-vs-CPU checks) computes on the
// fp32 FMA units, with shared-memory tiles and a 4x8 tile of outputs per
// thread:
//   * the TPU's sequential vocab grid axis becomes a loop inside a block;
//     the forward keeps one running (m, l, label logit) or (m, l, best z,
//     its column, its logit) per output row in each thread's registers,
//     merges the 16 threads of a row by shuffles at the end, and splits
//     the vocab over gridDim.y blocks so a short batch still fills the
//     card; a second small kernel merges the splits in column order
//     (strict > across splits, earliest column on ties within one, so the
//     draw is the first argmax of the whole row, as the reference's);
//   * the row statistics of the norm come from a small first kernel, one
//     warp per row, shared by every tile of that row;
//   * IEEE rounding intrinsics keep the norm, softcap and d arithmetic in
//     the reference's operation order (no contraction into FMA).
// With h in bf16 (the training path) the forward runs on the bf16 tensor
// cores through the backward's product kernel (below): after the same
// prep (h_n in bf16, an fp32 W's hi plane; ~90 MB at N = 8192), one
// ce_mma_kernel sweep computes s = h_n . hi^T over the whole vocabulary,
// 128 x 128 tiles with the row tiles fastest, and its epilogue folds each
// tile into one partial per row (fold_tile: a thread's 8 columns, the 4
// lanes of a quad by shuffles, the 4 column warps through shared memory,
// earliest column on ties); ce_combine_kernel merges the Vp / 128
// partials of each row in column order.  h_n and hi are the reference's
// casts, so each product is exact and only the order of the fp32 sums
// differs from the plain version.
//
// The backward with h in bf16 (the training path) runs on the bf16 tensor
// cores (mma.sync.m16n8k16, fp32 accumulate), in a workspace design:
//   * a prep kernel writes h_n, the normed rows rounded to bf16, once into
//     an (Np, D) plane (rows padded to 128 with zeros), and one splits an
//     fp32 W into bf16 planes hi = bf16(W) and lo = bf16(W - hi);
//   * the vocabulary goes in chunks of cw columns (a multiple of 128, as
//     many as keep the d workspace under 256 MiB; 7296 at N = 8192).  For
//     each chunk a logits kernel recomputes s = h_n . hi^T (hi is exactly
//     the reference's cast of W to h's dtype, so one bf16 product is the
//     reference's logits) and writes d in fp32 as two bf16 planes d_hi =
//     bf16(d), d_lo = bf16(d - d_hi) to the (Np, cw) workspace; then the
//     dh kernel adds d . W over the chunk into an fp32 accumulator as
//     d_hi.W_hi + d_hi.W_lo + d_lo.W_hi (two passes for bf16 W), and the dW
//     kernel writes the chunk's rows of dW = d^T . h_n over all rows as
//     d_hi^T.h_n + d_lo^T.h_n (h_n is exact in bf16), rounded once into W's
//     dtype.  Each pair of pieces carries ~16 of fp32's 24 bits, the
//     dropped lo.lo term is ~2^-18 of a product, and every sum runs in
//     fp32: the reference's fp32 operands to well inside the element-wise
//     contract (2^-16 of each element's sum of absolute terms).  A
//     per-slice design (a block owning rows by a D-slice, recomputing the
//     logits for each slice) would hold no workspace but pay the logits
//     D / slice times; the workspace costs 4 N cw bytes written and read
//     a chunk (239 MB at N = 8192: ~0.07 ms each way at 3.35 TB/s);
//   * one mma kernel serves the three products (and the forward's logits,
//     above): a 128 x 128 output tile per block of 8 warps (64 x 32 each:
//     4 x 4 mma tiles, 64 fp32 accumulators a thread and 64 more for the
//     part in flight, see kPromote), k-steps of 32 through a 3-stage
//     cp.async ring of padded shared-memory tiles, fragments by ldmatrix
//     (.trans where an operand's contiguous axis is not k), the operand
//     layouts (tied or untied W, d or d^T) as template flags, and the
//     epilogue (d to the workspace, dh accumulate, dW store, the forward's
//     fold) as a template case.  Blocks own their outputs: no atomics, dW
//     deterministic and rounded once.  At the training shape the grids are
//     3648 (logits), 384 (dh) and 342 (dW) blocks a chunk, all above the
//     card's 132 SMs;
//   * the chunk loop runs on the host, on the caller's stream.
// With h in fp32 (the card-vs-CPU checks and tests; not the training
// path) the backward keeps the first version on the fp32 FMA units: the
// dh kernel owns 32 rows and loops over the vocabulary, the dW kernel owns
// 32 vocabulary columns and loops over the rows; each recomputes a logits
// tile, writes its d tile to shared memory, and adds d . X (X = W or h_n,
// staged 128 columns of D at a time) into an fp32 accumulator in shared
// memory.  The accumulator covers one D-slab of at most kMaxSlab columns
// (bwd_slab), and gridDim.y runs over the slabs, so shared memory does not
// grow with D: at D = 4096 each block keeps (32, 1024) and the logits are
// recomputed once per slab, four times.  Each element's sum runs over the
// vocabulary in the same order whatever the slab, so the slabs change no
// value.  The bf16 split would give fp32 logits only with three
// more passes, and the fp32 tolerance (1e-5 of the largest element) leaves
// no room for a single-bf16 logits product.
// The C entry points return cudaGetLastError() after the launches and
// never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's masked-logit sentinel
constexpr int kBK = 32;            // D-depth of one staged logits chunk
constexpr int kBD = 128;           // D-width of one staged product chunk
constexpr int kXS = kBD + 1;       // its padded row stride
constexpr int kOwn = 32;           // dh: rows per block; dW: columns
constexpr int kInner = 64;         // dh: columns per step; dW: rows
constexpr int kDS = kInner + 1;    // padded row stride of the d tile

enum NormKind { kNormNone = 0, kNormLn = 1, kNormRms = 2 };

struct CeArgs {
  const void* h;        // (N, D) of T
  const void* w;        // (Vp, D), or (D, Vp) transposed, of TW
  const float* normp;   // (2, D): the norm's scale row and bias row
  const float* stats;   // (N, 2): mean and 1/sqrt(var + eps) of each row
  const int* labels;    // (N,): labels, or the sampled labels (backward)
  const float* rs;      // (N,): rowscale times the cotangent (backward)
  const float* lse;     // (N,): saved log-sum-exp (backward)
  const int* row_ids;   // (N,): the hash's row of each row, or null: r
  int N, D, V, Vp;
  int norm;
  float eps, softcap;   // softcap 0: none
  uint32_t seed0, seed1;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round through T and back: W cast to h's dtype, the normed row's cast.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Element (r, k) of the normed hidden, rounded to T, as fp32.
template <typename T>
__device__ __forceinline__ float hn_at(const CeArgs& a, int r, int k) {
  const float x = to_float(static_cast<const T*>(a.h)[(size_t)r * a.D + k]);
  if (a.norm == kNormNone) return x;
  const float mu = a.stats[2 * r], rstd = a.stats[2 * r + 1];
  const float scale = a.normp[k];
  float y;
  if (a.norm == kNormLn) {
    y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), scale),
                  a.normp[a.D + k]);
  } else {
    y = __fmul_rn(__fmul_rn(x, rstd), __fadd_rn(1.0f, scale));
  }
  return round_to<T>(y);
}

// Element (column c, depth k) of W in its stored dtype, as fp32.
template <typename TW, bool TRANSW>
__device__ __forceinline__ float w_at(const CeArgs& a, int c, int k) {
  const TW* w = static_cast<const TW*>(a.w);
  return to_float(TRANSW ? w[(size_t)k * a.Vp + c] : w[(size_t)c * a.D + k]);
}

// The logit of one summed dot product: softcap, then the padded-vocab
// mask.  *dcap gets the softcap's derivative factor (1 when uncapped).
__device__ __forceinline__ float finish_logit(const CeArgs& a, float raw,
                                              int c, float* dcap) {
  float s = raw, dc = 1.0f;
  if (a.softcap > 0.0f) {
    const float t = tanhf(raw / a.softcap);
    s = a.softcap * t;
    dc = __fsub_rn(1.0f, __fmul_rn(t, t));
  }
  *dcap = dc;
  return c < a.V ? s : kNegInf;
}

// d logit of one entry: (p - onehot) * rs, times the softcap factor.
__device__ __forceinline__ float dlogit(const CeArgs& a, float raw, int c,
                                        float lse, int lab, float rs) {
  float dcap;
  const float s = finish_logit(a, raw, c, &dcap);
  const float p = expf(s - lse);
  const float d = __fmul_rn(__fsub_rn(p, c == lab ? 1.0f : 0.0f), rs);
  return a.softcap > 0.0f ? __fmul_rn(d, dcap) : d;
}

// lowbias32-style finalizer and the counter-based Gumbel(0, 1) noise of
// the reference (fused_ce.py:_mix32, hash_gumbel), in native uint32.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The hash's row word of row r, mix32(row ^ seed0), with row = r or the
// caller's row_ids[r]; computed once per row.
__device__ __forceinline__ uint32_t row_word(const CeArgs& a, int r) {
  const int row = a.row_ids != nullptr && r < a.N ? a.row_ids[r] : r;
  return mix32((uint32_t)row ^ a.seed0);
}

// ``row_mix`` is a row's row_word.
__device__ __forceinline__ float hash_gumbel(uint32_t row_mix, uint32_t col,
                                             uint32_t seed1) {
  const uint32_t x = mix32(row_mix ^ (col * 0x9E3779B9u) ^ seed1);
  float u = (float)(x >> 8) * (1.0f / 16777216.0f);
  u = fminf(fmaxf(u, 1e-7f), 1.0f - 1e-7f);
  return -logf(-logf(u));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Mean and 1/sqrt(var + eps) of each row (ln), or 0 and 1/sqrt(mean(x^2)
// + eps) (rms): one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ h, float* __restrict__ stats, int N,
                 int D, int norm, float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (r >= N) return;
  const T* x = h + (size_t)r * D;
  float mu = 0.0f;
  if (norm == kNormLn) {
    float s = 0.0f;
    for (int k = lane; k < D; k += 32) s += to_float(x[k]);
    mu = warp_sum(s) / (float)D;
  }
  float v = 0.0f;
  for (int k = lane; k < D; k += 32) {
    const float d = to_float(x[k]) - mu;
    v = fmaf(d, d, v);
  }
  const float var = warp_sum(v) / (float)D;
  if (lane == 0) {
    stats[2 * r] = mu;
    stats[2 * r + 1] = 1.0f / sqrtf(var + eps);
  }
}

// acc[i][j] += h_n[r0 + ty + 16 i] . wc[c0 + tx + 16 j] over the whole of
// D, with wc = W cast to T; products and sums in fp32, each kBK-deep chunk
// summed apart and then added to acc (one long chain of fp32 FMAs over D
// drifts by ~sqrt(D) roundings of the running sum: ~1e-5 on a logit at D
// 8192; chunks keep it to ~sqrt(D / kBK) of them).  A 16 x 16 grid of
// threads, each with TM x TN outputs strided by 16 (conflict-free shared
// reads).  As is [kBK][BM + 1], Bs [kBK][BN + 1]; rows past N read 0.
template <typename T, typename TW, bool TRANSW, int BM, int BN, int TM,
          int TN>
__device__ __forceinline__ void logits_tile(const CeArgs& a, int r0, int c0,
                                            float* As, float* Bs,
                                            float (&acc)[TM][TN]) {
  static_assert(BM == 16 * TM && BN == 16 * TN, "a 16 x 16 thread grid");
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < a.D; k0 += kBK) {
    for (int e = threadIdx.x; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      As[k * (BM + 1) + r] = r0 + r < a.N ? hn_at<T>(a, r0 + r, k0 + k) : 0.0f;
    }
    for (int e = threadIdx.x; e < BN * kBK; e += kThreads) {
      const int c = TRANSW ? e % BN : e / kBK;
      const int k = TRANSW ? e / BN : e % kBK;
      Bs[k * (BN + 1) + c] = round_to<T>(w_at<TW, TRANSW>(a, c0 + c, k0 + k));
    }
    __syncthreads();
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k * (BM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k * (BN + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// forward

constexpr int kFwdBM = 64, kFwdBN = 128, kFwdTM = 4, kFwdTN = 8;

// Block (row tile, vocab split): the running online reductions over the
// split's vocab tiles, merged over the 16 threads of each row, written as
// partials part[{m, l, ll, zm}][split][row] (and part_idx for the draw).
template <typename T, typename TW, bool TRANSW, bool SAMPLE>
__global__ void __launch_bounds__(kThreads)
ce_forward_kernel(CeArgs a, int tiles_per_split, float* __restrict__ part,
                  int* __restrict__ part_idx) {
  constexpr int BM = kFwdBM, BN = kFwdBN, TM = kFwdTM, TN = kFwdTN;
  __shared__ float As[kBK * (BM + 1)];
  __shared__ float Bs[kBK * (BN + 1)];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * BM;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(a.Vp / BN, t0 + tiles_per_split);

  float m[TM], l[TM], ll[TM], zm[TM];
  int lab[TM], zi[TM];
  uint32_t rmix[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + 16 * i;
    m[i] = kNegInf;
    l[i] = 0.0f;
    ll[i] = 0.0f;
    zm[i] = kNegInf;
    zi[i] = 0;
    lab[i] = !SAMPLE && r < a.N ? a.labels[r] : -1;
    rmix[i] = row_word(a, r);
  }

  for (int tile = t0; tile < t1; ++tile) {
    const int c0 = tile * BN;
    float acc[TM][TN] = {};
    logits_tile<T, TW, TRANSW, BM, BN, TM, TN>(a, r0, c0, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float s[TN];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float dcap;
        s[j] = finish_logit(a, acc[i][j], c0 + tx + 16 * j, &dcap);
        tmax = fmaxf(tmax, s[j]);
      }
      const float m_new = fmaxf(m[i], tmax);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (c0 + tx + 16 * j < a.V) sum += expf(s[j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + tx + 16 * j;
        if (SAMPLE) {
          if (c < a.V) {
            const float z = s[j] + hash_gumbel(rmix[i], (uint32_t)c, a.seed1);
            if (z > zm[i]) {   // strict: a thread's columns rise, so the
              zm[i] = z;       // earliest of equal maxima stays
              zi[i] = c;
              ll[i] = s[j];
            }
          }
        } else if (c == lab[i]) {
          ll[i] = s[j];
        }
      }
    }
  }

  // merge the 16 threads of each row (lanes tx = 0..15 of a half warp)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float ll2 = __shfl_xor_sync(0xffffffffu, ll[i], off);
      const float mn = fmaxf(m[i], m2);
      l[i] = l[i] * expf(m[i] - mn) + l2 * expf(m2 - mn);
      m[i] = mn;
      if (SAMPLE) {
        const float z2 = __shfl_xor_sync(0xffffffffu, zm[i], off);
        const int i2 = __shfl_xor_sync(0xffffffffu, zi[i], off);
        if (z2 > zm[i] || (z2 == zm[i] && i2 < zi[i])) {
          zm[i] = z2;
          zi[i] = i2;
          ll[i] = ll2;
        }
      } else {
        ll[i] += ll2;   // one column of the row holds the label
      }
    }
  }
  if (tx != 0) return;
  const size_t P = (size_t)gridDim.y * a.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= a.N) continue;
    const size_t o = (size_t)blockIdx.y * a.N + r;
    part[o] = m[i];
    part[P + o] = l[i];
    part[2 * P + o] = ll[i];
    if (SAMPLE) {
      part[3 * P + o] = zm[i];
      part_idx[o] = zi[i];
    }
  }
}

// Merge the vocab splits of each row in column order: lse, the label (or
// drawn) logit and the draw.
__global__ void __launch_bounds__(kThreads)
ce_combine_kernel(int N, int splits, int sample,
                  const float* __restrict__ part,
                  const int* __restrict__ part_idx, float* __restrict__ lse,
                  float* __restrict__ ll, int* __restrict__ yhat) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const size_t P = (size_t)splits * N;
  float M = kNegInf, L = 0.0f, LL = 0.0f, Z = kNegInf;
  int I = 0;
  for (int s = 0; s < splits; ++s) {
    const size_t o = (size_t)s * N + r;
    const float m = part[o];
    const float mn = fmaxf(M, m);
    L = L * expf(M - mn) + part[P + o] * expf(m - mn);
    M = mn;
    if (sample) {
      const float z = part[3 * P + o];
      if (z > Z) {
        Z = z;
        I = part_idx[o];
        LL = part[2 * P + o];
      }
    } else {
      LL += part[2 * P + o];
    }
  }
  lse[r] = M + logf(fmaxf(L, 1e-37f));
  ll[r] = LL;
  if (sample) yhat[r] = I;
}

// ---------------------------------------------------------------------------
// backward on the fp32 FMA units (h in fp32)

// acc[o][k0 + kk] += sum_q dS[o][q] * Xs[q][kk] over one staged chunk of
// kBD columns; thread t owns rows o = 4 (t / 32) + i and columns
// kk = t % 32 + 32 j (broadcast dS reads, consecutive Xs reads).
__device__ __forceinline__ void accumulate_chunk(float* acc, int acc_stride,
                                                 int k0, const float* dS,
                                                 const float* Xs) {
  const int lane = threadIdx.x % 32, grp = threadIdx.x / 32;
  float part[4][4] = {};
#pragma unroll 4
  for (int q = 0; q < kInner; ++q) {
    float dv[4], xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) dv[i] = dS[(4 * grp + i) * kDS + q];
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = Xs[q * kXS + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = fmaf(dv[i], xv[j], part[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[(4 * grp + i) * acc_stride + k0 + lane + 32 * j] += part[i][j];
}

// Widest D-slab of a backward block's accumulator: (32, 1280) fp32 and
// the staging below fill 218 KB of the 227 KB a block may have.
constexpr int kMaxSlab = 1280;

// The slab width for D (a multiple of kBD): D split into the fewest slabs
// of at most kMaxSlab columns, as evenly as kBD allows; the last may be
// narrower.
__host__ __device__ constexpr int bwd_slab(int D) {
  return (D / kBD + (D + kMaxSlab - 1) / kMaxSlab - 1) /
         ((D + kMaxSlab - 1) / kMaxSlab) * kBD;
}

// Shared memory of a backward block, in floats: the (kOwn, slab)
// accumulator, the d tile, the two logits staging tiles and the product
// staging chunk.
__host__ __device__ constexpr int bwd_smem_floats(int slab) {
  return kOwn * (slab + 1) + kOwn * kDS + kBK * (kOwn + 1) +
         kBK * (kInner + 1) + kInner * kXS;
}

// Block (kOwn rows, D-slab blockIdx.y).  Loops over vocab tiles of kInner
// columns; dh rows written as fp32 (a fused norm: the caller pulls them
// back through it) or in T.
template <typename T, typename TW, bool TRANSW>
__global__ void __launch_bounds__(kThreads)
ce_backward_dh_kernel(CeArgs a, void* __restrict__ dh, int dh_f32) {
  constexpr int BM = kOwn, BN = kInner, TM = BM / 16, TN = BN / 16;
  extern __shared__ float smem[];
  const int slab = bwd_slab(a.D);
  const int k_lo = blockIdx.y * slab, width = min(slab, a.D - k_lo);
  const int acc_stride = slab + 1;
  float* acc = smem;                        // [kOwn][slab + 1]
  float* dS = acc + kOwn * acc_stride;      // [kOwn][kDS]: d[row][col]
  float* As = dS + kOwn * kDS;              // [kBK][BM + 1]
  float* Bs = As + kBK * (BM + 1);          // [kBK][BN + 1]
  float* Xs = Bs + kBK * (BN + 1);          // [kInner][kXS]: W rows, fp32
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * BM;
  for (int e = threadIdx.x; e < kOwn * acc_stride; e += kThreads) acc[e] = 0.0f;

  float lse[TM], rs[TM];
  int lab[TM];
  bool live[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + 16 * i;
    live[i] = r < a.N;
    lse[i] = live[i] ? a.lse[r] : 0.0f;
    rs[i] = live[i] ? a.rs[r] : 0.0f;
    lab[i] = live[i] ? a.labels[r] : -1;
  }

  for (int c0 = 0; c0 < a.Vp; c0 += BN) {
    float s[TM][TN] = {};
    logits_tile<T, TW, TRANSW, BM, BN, TM, TN>(a, r0, c0, As, Bs, s);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + tx + 16 * j;
        dS[(ty + 16 * i) * kDS + tx + 16 * j] =
            live[i] ? dlogit(a, s[i][j], c, lse[i], lab[i], rs[i]) : 0.0f;
      }
    for (int k0 = k_lo; k0 < k_lo + width; k0 += kBD) {
      for (int e = threadIdx.x; e < kInner * kBD; e += kThreads) {
        const int c = TRANSW ? e % kInner : e / kBD;
        const int k = TRANSW ? e / kInner : e % kBD;
        Xs[c * kXS + k] = w_at<TW, TRANSW>(a, c0 + c, k0 + k);
      }
      __syncthreads();
      accumulate_chunk(acc, acc_stride, k0 - k_lo, dS, Xs);
      __syncthreads();
    }
  }

  for (int e = threadIdx.x; e < kOwn * width; e += kThreads) {
    const int r = e / width, k = e % width;
    if (r0 + r >= a.N) continue;
    const float v = acc[r * acc_stride + k];
    const size_t o = (size_t)(r0 + r) * a.D + k_lo + k;
    if (dh_f32) {
      static_cast<float*>(dh)[o] = v;
    } else {
      static_cast<T*>(dh)[o] = from_float<T>(v);
    }
  }
}

// Block (kOwn vocab columns, D-slab blockIdx.y).  Loops over row tiles of
// kInner rows; dW rounds once from the fp32 accumulator into W's dtype and
// layout.
template <typename T, typename TW, bool TRANSW>
__global__ void __launch_bounds__(kThreads)
ce_backward_dw_kernel(CeArgs a, TW* __restrict__ dw) {
  constexpr int BM = kInner, BN = kOwn, TM = BM / 16, TN = BN / 16;
  extern __shared__ float smem[];
  const int slab = bwd_slab(a.D);
  const int k_lo = blockIdx.y * slab, width = min(slab, a.D - k_lo);
  const int acc_stride = slab + 1;
  float* acc = smem;                        // [kOwn][slab + 1]
  float* dS = acc + kOwn * acc_stride;      // [kOwn][kDS]: d[col][row]
  float* As = dS + kOwn * kDS;              // [kBK][BM + 1]
  float* Bs = As + kBK * (BM + 1);          // [kBK][BN + 1]
  float* Xs = Bs + kBK * (BN + 1);          // [kInner][kXS]: h_n rows, fp32
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * BN;
  for (int e = threadIdx.x; e < kOwn * acc_stride; e += kThreads) acc[e] = 0.0f;

  for (int r0 = 0; r0 < a.N; r0 += BM) {
    float lse[TM], rs[TM];
    int lab[TM];
    bool live[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = r0 + ty + 16 * i;
      live[i] = r < a.N;
      lse[i] = live[i] ? a.lse[r] : 0.0f;
      rs[i] = live[i] ? a.rs[r] : 0.0f;
      lab[i] = live[i] ? a.labels[r] : -1;
    }
    float s[TM][TN] = {};
    logits_tile<T, TW, TRANSW, BM, BN, TM, TN>(a, r0, c0, As, Bs, s);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + tx + 16 * j;
        dS[(tx + 16 * j) * kDS + ty + 16 * i] =
            live[i] ? dlogit(a, s[i][j], c, lse[i], lab[i], rs[i]) : 0.0f;
      }
    for (int k0 = k_lo; k0 < k_lo + width; k0 += kBD) {
      for (int e = threadIdx.x; e < kInner * kBD; e += kThreads) {
        const int r = e / kBD, k = e % kBD;
        Xs[r * kXS + k] = r0 + r < a.N ? hn_at<T>(a, r0 + r, k0 + k) : 0.0f;
      }
      __syncthreads();
      accumulate_chunk(acc, acc_stride, k0 - k_lo, dS, Xs);
      __syncthreads();
    }
  }

  for (int e = threadIdx.x; e < kOwn * width; e += kThreads) {
    const int c = TRANSW ? e % kOwn : e / width;
    const int k = TRANSW ? e / kOwn : e % width;
    const size_t o = TRANSW ? (size_t)(k_lo + k) * a.Vp + c0 + c
                            : (size_t)(c0 + c) * a.D + k_lo + k;
    dw[o] = from_float<TW>(acc[c * acc_stride + k]);
  }
}

// ---------------------------------------------------------------------------
// backward on the bf16 tensor cores (h in bf16)

constexpr int kMT = 128;               // output tile rows of an mma block
constexpr int kNT = 128;               // output tile columns
constexpr int kKT = 32;                // k-depth of one pipeline stage
constexpr int kStages = 3;             // cp.async ring depth
// The tensor cores add a product into an fp32 accumulator truncating the
// bits below the larger operand's last place, so a long chain drifts
// toward zero by up to an ulp of the running sum per mma (one chain over
// a 50304-column sweep put 20-67% of dh's elements past 2^-16 of their
// absolute sum on an H100).  Each block therefore sums kPromote
// stages (64 of k) on the tensor cores and adds that part into the running
// sum with a rounded fp32 add.
constexpr int kPromote = 2;
constexpr int kKmStride = kKT + 8;     // padded row of a k-contiguous tile
constexpr int kMnStride = kMT + 8;     // padded row of an m/n-contiguous tile
constexpr int kPlane = kMT * kKmStride;  // bf16 elements of one tile plane
static_assert(kMT == kNT && kMT * kKmStride >= kKT * kMnStride,
              "one plane size serves both layouts");
constexpr size_t kWsBudget = size_t(256) << 20;  // bytes of the d workspace

// d to the workspace, dh accumulate, dW store; the forward's fold of the
// logits into (m, l, label logit) or, sampled, (m, l, draw) per row
enum Epilogue {
  kEpiDlogits = 0,
  kEpiDh = 1,
  kEpiDw = 2,
  kEpiLse = 3,
  kEpiSample = 4
};

// One operand of a product: bf16 planes hi and lo (lo unused with fewer
// passes), leading dimension ld in elements.  KMAJOR: element (i, k) at
// i * ld + k; else at k * ld + i.
struct Operand {
  const bf16* hi;
  const bf16* lo;
  int ld;
};

// Epilogue state.  Logits: the chunk's first vocab column c0 and the d
// workspace planes (ldd columns).  dh: the fp32 accumulator (ld D), whether
// this chunk is the first (overwrite), and the bf16 output of the last
// chunk (null unless dh is returned in h's dtype).  dW: c0 and the output
// in W's dtype and layout.  Forward: the partials that ce_combine_kernel
// merges, part[{m, l, ll, zm}][tile][row] and part_idx[tile][row].
struct Epi {
  int c0;
  bf16* d_hi;
  bf16* d_lo;
  int ldd;
  float* acc;
  int first;
  bf16* out_t;
  void* dw;
  float* part;
  int* part_idx;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  if (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  }
}

// c += a . b: one m16n8k16 product, bf16 operands, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage one 128 x kKT tile of a plane (rows i0.., depth k0..) in shared
// memory: 512 copies of 16 bytes, two a thread.
template <bool KMAJOR>
__device__ __forceinline__ void load_plane(bf16* dst, const bf16* src,
                                           int ld, int i0, int k0) {
#pragma unroll
  for (int e = threadIdx.x; e < kMT * kKT / 8; e += kThreads) {
    if (KMAJOR) {
      const int i = e / (kKT / 8), k = (e % (kKT / 8)) * 8;
      cp_async16(dst + i * kKmStride + k,
                 src + (size_t)(i0 + i) * ld + k0 + k);
    } else {
      const int k = e / (kMT / 8), i = (e % (kMT / 8)) * 8;
      cp_async16(dst + k * kMnStride + i,
                 src + (size_t)(k0 + k) * ld + i0 + i);
    }
  }
}

// The A fragment of 16 rows from r0 at depth kk of a staged tile.
template <bool KMAJOR>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* t,
                                       int r0, int kk) {
  const int lane = threadIdx.x % 32;
  if (KMAJOR) {
    ldsm_x4<false>(r, t + (r0 + (lane & 15)) * kKmStride + kk +
                          (lane >> 4) * 8);
  } else {
    const int q = lane >> 3, i = lane & 7;
    ldsm_x4<true>(r, t + (kk + (q >> 1) * 8 + i) * kMnStride + r0 +
                         (q & 1) * 8);
  }
}

// The B fragments of two n8 tiles (16 columns from c0) at depth kk: {b0,
// b1} of the first, then of the second.
template <bool KMAJOR>
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], const bf16* t,
                                       int c0, int kk) {
  const int lane = threadIdx.x % 32;
  const int q = lane >> 3, i = lane & 7;
  if (KMAJOR) {
    ldsm_x4<false>(r, t + (c0 + (q >> 1) * 8 + i) * kKmStride + kk +
                          (q & 1) * 8);
  } else {
    ldsm_x4<true>(r, t + (kk + (q & 1) * 8 + i) * kMnStride + c0 +
                         (q >> 1) * 8);
  }
}

// The forward's epilogue: the logits tile at rows m0.., vocab columns c0
// (all columns of the sweep from epi.c0 + n0 on) folded into one partial
// per row, part[{m, l, ll, zm}][c0 / 128][row] (and part_idx): each thread
// folds its 8 columns of each of its 8 rows in ascending order, the 4
// lanes of a quad merge by shuffles and the 4 column warps through shared
// memory (the drained cp.async ring) in column order.  The draw keeps the
// earliest column among equal maxima at every merge, so with
// ce_combine_kernel's strict > across tiles it is the first argmax of the
// row, as the reference's.
template <bool SAMPLE>
__device__ __forceinline__ void fold_tile(const float (&acc)[4][4][4],
                                          const CeArgs& a, const Epi& epi,
                                          int m0, int n0,
                                          unsigned char* smem_raw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int c0 = epi.c0 + n0;
  const int cl = c0 + wn * 32 + 2 * (lane % 4);  // column of j = 0, e = 0
  float* red = reinterpret_cast<float*>(smem_raw);  // [4][4 wn][kMT rows]
  int* red_i = reinterpret_cast<int*>(red + 16 * kMT);  // [4 wn][kMT rows]
  __syncthreads();  // every warp is done reading the ring
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * 64 + i * 16 + lane / 4 + 8 * h;
      const int r = m0 + rl;
      float s[8], m = kNegInf;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float dcap;
        s[k] = finish_logit(a, acc[i][k >> 1][2 * h + (k & 1)],
                            cl + 8 * (k >> 1) + (k & 1), &dcap);
        m = fmaxf(m, s[k]);
      }
      float l = 0.0f, ll = 0.0f, zm = kNegInf;
      int zi = 0;
      const int lab = !SAMPLE && r < a.N ? a.labels[r] : -1;
      const uint32_t rmix = row_word(a, r);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = cl + 8 * (k >> 1) + (k & 1);
        if (c < a.V) {
          l += expf(s[k] - m);
          if (SAMPLE) {
            const float z = s[k] + hash_gumbel(rmix, (uint32_t)c, a.seed1);
            if (z > zm) {  // strict: the columns rise
              zm = z;
              zi = c;
              ll = s[k];
            }
          }
        }
        if (!SAMPLE && c == lab) ll = s[k];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
        const float ll2 = __shfl_xor_sync(0xffffffffu, ll, off);
        const float mn = fmaxf(m, m2);
        l = l * expf(m - mn) + l2 * expf(m2 - mn);
        m = mn;
        if (SAMPLE) {
          const float z2 = __shfl_xor_sync(0xffffffffu, zm, off);
          const int i2 = __shfl_xor_sync(0xffffffffu, zi, off);
          if (z2 > zm || (z2 == zm && i2 < zi)) {
            zm = z2;
            zi = i2;
            ll = ll2;
          }
        } else {
          ll += ll2;  // one column of the row holds the label
        }
      }
      if (lane % 4 == 0) {
        red[(0 * 4 + wn) * kMT + rl] = m;
        red[(1 * 4 + wn) * kMT + rl] = l;
        red[(2 * 4 + wn) * kMT + rl] = ll;
        red[(3 * 4 + wn) * kMT + rl] = zm;
        red_i[wn * kMT + rl] = zi;
      }
    }
  __syncthreads();
  const int rl = threadIdx.x, r = m0 + rl;
  if (rl >= kMT || r >= a.N) return;
  float M = kNegInf, L = 0.0f, LL = 0.0f, Z = kNegInf;
  int I = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {  // column order
    const float m = red[w * kMT + rl];
    const float mn = fmaxf(M, m);
    L = L * expf(M - mn) + red[(4 + w) * kMT + rl] * expf(m - mn);
    M = mn;
    if (SAMPLE) {
      const float z = red[(12 + w) * kMT + rl];
      if (z > Z) {
        Z = z;
        I = red_i[w * kMT + rl];
        LL = red[(8 + w) * kMT + rl];
      }
    } else {
      LL += red[(8 + w) * kMT + rl];
    }
  }
  const size_t P = (size_t)(a.Vp / kNT) * a.N;
  const size_t o = (size_t)(c0 / kNT) * a.N + r;
  epi.part[o] = M;
  epi.part[P + o] = L;
  epi.part[2 * P + o] = LL;
  if (SAMPLE) {
    epi.part[3 * P + o] = Z;
    epi.part_idx[o] = I;
  }
}

// The 128 x 128 tile at block (m0, n0) of the passes of A (M x K) . B
// (K x N) over k < K: PASSES 1 is hi.hi, 2 adds A_lo.B_hi, 3 adds
// A_hi.B_lo too; then the epilogue EPI.  Every dimension is a multiple of
// the tile: the callers pad rows to 128, and D and every chunk are
// multiples of 128.  The forward's grid runs the row tiles fastest, so
// that the blocks in flight share a few tiles of W and all of h_n stays in
// the L2 cache: W is read from memory about once.
template <bool A_KMAJOR, bool B_KMAJOR, int PASSES, int EPI, typename TW,
          bool TRANSW>
__global__ void __launch_bounds__(kThreads)
ce_mma_kernel(Operand A, Operand B, int K, CeArgs a, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int kAPlanes = PASSES >= 2 ? 2 : 1;
  constexpr int kBPlanes = PASSES == 3 ? 2 : 1;
  constexpr int kStageElems = (kAPlanes + kBPlanes) * kPlane;
  constexpr bool kFold = EPI == kEpiLse || EPI == kEpiSample;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // a 2 x 4 grid of 64 x 32 tiles
  const int m0 = (kFold ? blockIdx.x : blockIdx.y) * kMT;
  const int n0 = (kFold ? blockIdx.y : blockIdx.x) * kNT;

  auto stage_load = [&](int s, int kt) {
    bf16* base = smem + s * kStageElems;
    const int k0 = kt * kKT;
    load_plane<A_KMAJOR>(base, A.hi, A.ld, m0, k0);
    if (kAPlanes == 2)
      load_plane<A_KMAJOR>(base + kPlane, A.lo, A.ld, m0, k0);
    bf16* bb = base + kAPlanes * kPlane;
    load_plane<B_KMAJOR>(bb, B.hi, B.ld, n0, k0);
    if (kBPlanes == 2) load_plane<B_KMAJOR>(bb + kPlane, B.lo, B.ld, n0, k0);
  };

  // part sums kPromote stages on the tensor cores; acc sums the parts with
  // IEEE fp32 adds (see kPromote)
  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.0f;

  const int nk = K / kKT;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage_load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) stage_load(nxt % kStages, nxt);
    cp_async_commit();
    const bf16* base = smem + (kt % kStages) * kStageElems;
    const bf16* tb = base + kAPlanes * kPlane;
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 16) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        frag_b<B_KMAJOR>(r, tb, wn * 32 + p * 16, kk);
        bh[2 * p][0] = r[0];
        bh[2 * p][1] = r[1];
        bh[2 * p + 1][0] = r[2];
        bh[2 * p + 1][1] = r[3];
        if (kBPlanes == 2) {
          frag_b<B_KMAJOR>(r, tb + kPlane, wn * 32 + p * 16, kk);
          bl[2 * p][0] = r[0];
          bl[2 * p][1] = r[1];
          bl[2 * p + 1][0] = r[2];
          bl[2 * p + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t ah[4], al[4];
        frag_a<A_KMAJOR>(ah, base, wm * 64 + i * 16, kk);
        if (kAPlanes == 2)
          frag_a<A_KMAJOR>(al, base + kPlane, wm * 64 + i * 16, kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(part[i][j], ah, bh[j][0], bh[j][1]);
          if (PASSES >= 2) mma_bf16(part[i][j], al, bh[j][0], bh[j][1]);
          if (PASSES == 3) mma_bf16(part[i][j], ah, bl[j][0], bl[j][1]);
        }
      }
    }
    if ((kt + 1) % kPromote == 0 || kt == nk - 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
            part[i][j][e] = 0.0f;
          }
    }
  }
  cp_async_wait<0>();
  if constexpr (kFold) {
    fold_tile<EPI == kEpiSample>(acc, a, epi, m0, n0, smem_raw);
    return;
  }

  // acc[i][j][2 h + e] is the tile's element at row wm 64 + 16 i + lane / 4
  // + 8 h, column wn 32 + 8 j + 2 (lane % 4) + e
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 64 + i * 16 + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn * 32 + j * 8 + 2 * (lane % 4);
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (EPI == kEpiDlogits) {
          // r: a row (past N: d = 0); c: a column of the chunk
          float d0 = 0.0f, d1 = 0.0f;
          if (r < a.N) {
            const float lse = a.lse[r], rs = a.rs[r];
            const int lab = a.labels[r];
            d0 = dlogit(a, v0, epi.c0 + c, lse, lab, rs);
            d1 = dlogit(a, v1, epi.c0 + c + 1, lse, lab, rs);
          }
          const bf16 h0 = __float2bfloat16_rn(d0);
          const bf16 h1 = __float2bfloat16_rn(d1);
          __nv_bfloat162 hi, lo;
          hi.x = h0;
          hi.y = h1;
          lo.x = __float2bfloat16_rn(__fsub_rn(d0, __bfloat162float(h0)));
          lo.y = __float2bfloat16_rn(__fsub_rn(d1, __bfloat162float(h1)));
          const size_t o = (size_t)r * epi.ldd + c;
          *reinterpret_cast<__nv_bfloat162*>(epi.d_hi + o) = hi;
          *reinterpret_cast<__nv_bfloat162*>(epi.d_lo + o) = lo;
        } else if (EPI == kEpiDh) {
          // r: a row, c: a column of D
          if (r >= a.N) continue;
          const size_t o = (size_t)r * a.D + c;
          float2 v = make_float2(v0, v1);
          if (!epi.first) {
            const float2 p = *reinterpret_cast<const float2*>(epi.acc + o);
            v.x = __fadd_rn(p.x, v.x);
            v.y = __fadd_rn(p.y, v.y);
          }
          if (epi.out_t != nullptr) {
            __nv_bfloat162 t;
            t.x = __float2bfloat16_rn(v.x);
            t.y = __float2bfloat16_rn(v.y);
            *reinterpret_cast<__nv_bfloat162*>(epi.out_t + o) = t;
          } else {
            *reinterpret_cast<float2*>(epi.acc + o) = v;
          }
        } else {
          // r: a vocab column of the chunk, c: a column of D
          TW* dw = static_cast<TW*>(epi.dw);
          const int col = epi.c0 + r;
          if (TRANSW) {
            dw[(size_t)c * a.Vp + col] = from_float<TW>(v0);
            dw[(size_t)(c + 1) * a.Vp + col] = from_float<TW>(v1);
          } else {
            dw[(size_t)col * a.D + c] = from_float<TW>(v0);
            dw[(size_t)col * a.D + c + 1] = from_float<TW>(v1);
          }
        }
      }
    }
}

// h_n, the normed rows rounded to bf16, in an (Np, D) plane; rows past N
// are zero.
__global__ void __launch_bounds__(kThreads)
ce_prep_hn_kernel(CeArgs a, int Np, bf16* __restrict__ hn) {
  const size_t n = (size_t)Np * a.D;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    const int r = (int)(e / a.D), k = (int)(e % a.D);
    hn[e] = __float2bfloat16_rn(r < a.N ? hn_at<bf16>(a, r, k) : 0.0f);
  }
}

// hi = bf16(w) and, unless lo is null, lo = bf16(w - hi), element by
// element.
__global__ void __launch_bounds__(kThreads)
ce_split_kernel(const float* __restrict__ w, size_t n, bf16* __restrict__ hi,
                bf16* __restrict__ lo) {
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    const float x = w[e];
    const bf16 h = __float2bfloat16_rn(x);
    hi[e] = h;
    if (lo != nullptr)
      lo[e] = __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(h)));
  }
}

// ---------------------------------------------------------------------------
// host side

template <typename T>
cudaError_t launch_row_stats(const CeArgs& a, float* stats, cudaStream_t st) {
  if (a.norm == kNormNone) return cudaSuccess;
  const int rows_per_block = kThreads / 32;
  row_stats_kernel<T><<<(a.N + rows_per_block - 1) / rows_per_block,
                        kThreads, 0, st>>>(static_cast<const T*>(a.h), stats,
                                           a.N, a.D, a.norm, a.eps);
  return cudaGetLastError();
}

template <typename T, typename TW, bool TRANSW, bool SAMPLE>
cudaError_t forward_impl(const CeArgs& a, float* stats, int splits,
                         int tiles_per_split, float* part, int* part_idx,
                         float* lse, float* ll, int* yhat, unsigned char*,
                         cudaStream_t st) {
  cudaError_t err = launch_row_stats<T>(a, stats, st);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kFwdBM - 1) / kFwdBM, splits);
  ce_forward_kernel<T, TW, TRANSW, SAMPLE>
      <<<grid, kThreads, 0, st>>>(a, tiles_per_split, part, part_idx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_combine_kernel<<<(a.N + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.N, splits, SAMPLE ? 1 : 0, part, part_idx, lse, ll, yhat);
  return cudaGetLastError();
}

template <typename T, typename TW, bool TRANSW>
cudaError_t dh_impl(const CeArgs& a, float* stats, void* dh, int dh_f32,
                    unsigned char*, cudaStream_t st) {
  cudaError_t err = launch_row_stats<T>(a, stats, st);
  if (err != cudaSuccess) return err;
  const int slab = bwd_slab(a.D);
  const size_t smem = sizeof(float) * bwd_smem_floats(slab);
  err = cudaFuncSetAttribute(ce_backward_dh_kernel<T, TW, TRANSW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kOwn - 1) / kOwn, (a.D + slab - 1) / slab);
  ce_backward_dh_kernel<T, TW, TRANSW>
      <<<grid, kThreads, smem, st>>>(a, dh, dh_f32);
  return cudaGetLastError();
}

template <typename T, typename TW, bool TRANSW>
cudaError_t dw_impl(const CeArgs& a, float* stats, void* dw,
                    unsigned char*, cudaStream_t st) {
  cudaError_t err = launch_row_stats<T>(a, stats, st);
  if (err != cudaSuccess) return err;
  const int slab = bwd_slab(a.D);
  const size_t smem = sizeof(float) * bwd_smem_floats(slab);
  err = cudaFuncSetAttribute(ce_backward_dw_kernel<T, TW, TRANSW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Vp / kOwn, (a.D + slab - 1) / slab);
  ce_backward_dw_kernel<T, TW, TRANSW>
      <<<grid, kThreads, smem, st>>>(a, static_cast<TW*>(dw));
  return cudaGetLastError();
}

// The tensor-core workspace, at 256-byte offsets: h_n (Np, D); W's hi and
// (backward) lo planes, fp32 W only; the backward's d_hi and d_lo (Np, cw)
// and, when dh is returned in bf16, its fp32 accumulator (N, D).
struct TcPlan {
  int Np, cw, n_chunks;
  bool w_lo_plane;
  size_t hn, w_hi, w_lo, d_hi, d_lo, acc, bytes;
};

size_t up256(size_t x) { return (x + 255) / 256 * 256; }

TcPlan tc_plan(int N, int D, int Vp, int w_bf16, int dh_acc) {
  TcPlan p;
  p.Np = (N + kMT - 1) / kMT * kMT;
  const int tiles = Vp / kNT;
  const size_t per_tile = size_t(4) * p.Np * kNT;  // d_hi and d_lo bytes
  const int max_tiles =
      (int)std::min<size_t>(tiles, std::max<size_t>(1, kWsBudget / per_tile));
  const int n = (tiles + max_tiles - 1) / max_tiles;
  const int per = (tiles + n - 1) / n;
  p.n_chunks = (tiles + per - 1) / per;
  p.cw = per * kNT;
  p.w_lo_plane = true;
  const size_t wbytes = w_bf16 ? 0 : up256(size_t(2) * Vp * D);
  p.hn = 0;
  p.w_hi = p.hn + up256(size_t(2) * p.Np * D);
  p.w_lo = p.w_hi + wbytes;
  p.d_hi = p.w_lo + wbytes;
  p.d_lo = p.d_hi + up256(size_t(2) * p.Np * p.cw);
  p.acc = p.d_lo + up256(size_t(2) * p.Np * p.cw);
  p.bytes = p.acc + (dh_acc ? up256(size_t(4) * N * D) : 0);
  return p;
}

// The forward's: h_n and W's hi plane alone (one sweep, no d planes).
TcPlan fwd_plan(int N, int D, int Vp, int w_bf16) {
  TcPlan p = tc_plan(N, D, Vp, w_bf16, 0);
  p.n_chunks = 1;
  p.cw = Vp;
  p.w_lo_plane = false;
  p.w_lo = p.d_hi = p.d_lo = p.acc = p.bytes =
      p.w_hi + (w_bf16 ? 0 : up256(size_t(2) * Vp * D));
  return p;
}

template <bool A_KMAJOR, bool B_KMAJOR, int PASSES, int EPI, typename TW,
          bool TRANSW>
cudaError_t launch_mma(dim3 grid, const Operand& A, const Operand& B, int K,
                       const CeArgs& a, const Epi& epi, cudaStream_t st) {
  constexpr int planes = (PASSES >= 2 ? 2 : 1) + (PASSES == 3 ? 2 : 1);
  const int smem = (int)(sizeof(bf16) * kStages * planes * kPlane);
  auto kern = ce_mma_kernel<A_KMAJOR, B_KMAJOR, PASSES, EPI, TW, TRANSW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, st>>>(A, B, K, a, epi);
  return cudaGetLastError();
}

// Row statistics, h_n and W's planes: what every chunk reads.
template <typename TW>
cudaError_t tc_prep(const CeArgs& a, float* stats, const TcPlan& p,
                    unsigned char* ws, cudaStream_t st) {
  cudaError_t err = launch_row_stats<bf16>(a, stats, st);
  if (err != cudaSuccess) return err;
  ce_prep_hn_kernel<<<1024, kThreads, 0, st>>>(
      a, p.Np, reinterpret_cast<bf16*>(ws + p.hn));
  err = cudaGetLastError();
  if (err != cudaSuccess || !std::is_same<TW, float>::value) return err;
  ce_split_kernel<<<2048, kThreads, 0, st>>>(
      static_cast<const float*>(a.w), (size_t)a.Vp * a.D,
      reinterpret_cast<bf16*>(ws + p.w_hi),
      p.w_lo_plane ? reinterpret_cast<bf16*>(ws + p.w_lo) : nullptr);
  return cudaGetLastError();
}

// W's bf16 planes from vocab column c0 on: (vocab c, depth k) lies at
// c D + k in a tied W (Vp, D) and at k Vp + c in an untied one (D, Vp).
template <typename TW, bool TRANSW>
Operand w_operand(const CeArgs& a, const TcPlan& p, unsigned char* ws,
                  int c0) {
  const size_t off = TRANSW ? (size_t)c0 : (size_t)c0 * a.D;
  const int ld = TRANSW ? a.Vp : a.D;
  if (!std::is_same<TW, float>::value)
    return Operand{static_cast<const bf16*>(a.w) + off, nullptr, ld};
  return Operand{reinterpret_cast<const bf16*>(ws + p.w_hi) + off,
                 reinterpret_cast<const bf16*>(ws + p.w_lo) + off, ld};
}

// d of the chunk of columns c0 .. c0 + width into the workspace: s = h_n .
// hi^T over k = D (W k-contiguous when tied).
template <typename TW, bool TRANSW>
cudaError_t tc_dlogits(const CeArgs& a, const TcPlan& p, unsigned char* ws,
                       int c0, int width, cudaStream_t st) {
  const Operand hn{reinterpret_cast<const bf16*>(ws + p.hn), nullptr, a.D};
  Epi epi{};
  epi.c0 = c0;
  epi.d_hi = reinterpret_cast<bf16*>(ws + p.d_hi);
  epi.d_lo = reinterpret_cast<bf16*>(ws + p.d_lo);
  epi.ldd = p.cw;
  return launch_mma<true, !TRANSW, 1, kEpiDlogits, TW, TRANSW>(
      dim3(width / kNT, p.Np / kMT), hn, w_operand<TW, TRANSW>(a, p, ws, c0),
      a.D, a, epi, st);
}

// The forward with bf16 h: s = h_n . hi^T over the whole vocabulary in
// one mma sweep whose epilogue folds each 128-column tile into a partial
// per row (fold_tile), then ce_combine_kernel merges the Vp / 128 partials
// of each row in column order.
template <typename TW, bool TRANSW, bool SAMPLE>
cudaError_t forward_tc_impl(const CeArgs& a, float* stats, int splits, int,
                            float* part, int* part_idx, float* lse,
                            float* ll, int* yhat, unsigned char* ws,
                            cudaStream_t st) {
  if (splits != a.Vp / kNT) return cudaErrorInvalidValue;
  const TcPlan p = fwd_plan(a.N, a.D, a.Vp, !std::is_same<TW, float>::value);
  cudaError_t err = tc_prep<TW>(a, stats, p, ws, st);
  if (err != cudaSuccess) return err;
  const Operand hn{reinterpret_cast<const bf16*>(ws + p.hn), nullptr, a.D};
  Epi epi{};
  epi.part = part;
  epi.part_idx = part_idx;
  err = launch_mma<true, !TRANSW, 1, SAMPLE ? kEpiSample : kEpiLse, TW,
                   TRANSW>(dim3(p.Np / kMT, splits), hn,
                           w_operand<TW, TRANSW>(a, p, ws, 0), a.D, a, epi,
                           st);
  if (err != cudaSuccess) return err;
  ce_combine_kernel<<<(a.N + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.N, splits, SAMPLE ? 1 : 0, part, part_idx, lse, ll, yhat);
  return cudaGetLastError();
}

template <typename TW, bool TRANSW>
cudaError_t dh_tc_impl(const CeArgs& a, float* stats, void* dh, int dh_f32,
                       unsigned char* ws, cudaStream_t st) {
  constexpr bool kW32 = std::is_same<TW, float>::value;
  const TcPlan p = tc_plan(a.N, a.D, a.Vp, !kW32, !dh_f32);
  cudaError_t err = tc_prep<TW>(a, stats, p, ws, st);
  if (err != cudaSuccess) return err;
  const Operand d{reinterpret_cast<const bf16*>(ws + p.d_hi),
                  reinterpret_cast<const bf16*>(ws + p.d_lo), p.cw};
  const dim3 grid(a.D / kNT, p.Np / kMT);
  for (int ci = 0; ci < p.n_chunks; ++ci) {
    const int c0 = ci * p.cw, width = std::min(p.cw, a.Vp - c0);
    err = tc_dlogits<TW, TRANSW>(a, p, ws, c0, width, st);
    if (err != cudaSuccess) return err;
    Epi epi{};
    epi.acc = dh_f32 ? static_cast<float*>(dh)
                     : reinterpret_cast<float*>(ws + p.acc);
    epi.first = ci == 0;
    epi.out_t = !dh_f32 && ci == p.n_chunks - 1 ? static_cast<bf16*>(dh)
                                                 : nullptr;
    // d . W: k runs over the chunk's vocab columns, n over D; W is
    // n-contiguous there when tied, k-contiguous when untied
    const Operand w = w_operand<TW, TRANSW>(a, p, ws, c0);
    err = kW32 ? launch_mma<true, TRANSW, 3, kEpiDh, TW, TRANSW>(
                     grid, d, w, width, a, epi, st)
               : launch_mma<true, TRANSW, 2, kEpiDh, TW, TRANSW>(
                     grid, d, w, width, a, epi, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename TW, bool TRANSW>
cudaError_t dw_tc_impl(const CeArgs& a, float* stats, void* dw,
                       unsigned char* ws, cudaStream_t st) {
  const TcPlan p = tc_plan(a.N, a.D, a.Vp, !std::is_same<TW, float>::value,
                           0);
  cudaError_t err = tc_prep<TW>(a, stats, p, ws, st);
  if (err != cudaSuccess) return err;
  // d^T . h_n: m runs over the chunk's vocab columns, k over the rows
  // (d^T m-contiguous), n over D (h_n n-contiguous)
  const Operand dt{reinterpret_cast<const bf16*>(ws + p.d_hi),
                   reinterpret_cast<const bf16*>(ws + p.d_lo), p.cw};
  const Operand hn{reinterpret_cast<const bf16*>(ws + p.hn), nullptr, a.D};
  for (int ci = 0; ci < p.n_chunks; ++ci) {
    const int c0 = ci * p.cw, width = std::min(p.cw, a.Vp - c0);
    err = tc_dlogits<TW, TRANSW>(a, p, ws, c0, width, st);
    if (err != cudaSuccess) return err;
    Epi epi{};
    epi.c0 = c0;
    epi.dw = dw;
    err = launch_mma<false, false, 2, kEpiDw, TW, TRANSW>(
        dim3(a.D / kNT, width / kMT), dt, hn, p.Np, a, epi, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

typedef cudaError_t (*ForwardFn)(const CeArgs&, float*, int, int, float*,
                                 int*, float*, float*, int*, unsigned char*,
                                 cudaStream_t);
typedef cudaError_t (*DhFn)(const CeArgs&, float*, void*, int,
                            unsigned char*, cudaStream_t);
typedef cudaError_t (*DwFn)(const CeArgs&, float*, void*, unsigned char*,
                            cudaStream_t);

// Tables indexed by 4 * h_bf16 + 2 * w_bf16 + transpose_w: fp32 h on the
// FMA units, bf16 h on the tensor cores.
template <bool SAMPLE>
ForwardFn pick_forward(int index) {
  static const ForwardFn table[8] = {
      forward_impl<float, float, false, SAMPLE>,
      forward_impl<float, float, true, SAMPLE>,
      forward_impl<float, bf16, false, SAMPLE>,
      forward_impl<float, bf16, true, SAMPLE>,
      forward_tc_impl<float, false, SAMPLE>,
      forward_tc_impl<float, true, SAMPLE>,
      forward_tc_impl<bf16, false, SAMPLE>,
      forward_tc_impl<bf16, true, SAMPLE>};
  return table[index];
}

const DhFn kDhTable[8] = {
    dh_impl<float, float, false>, dh_impl<float, float, true>,
    dh_impl<float, bf16, false>,  dh_impl<float, bf16, true>,
    dh_tc_impl<float, false>,     dh_tc_impl<float, true>,
    dh_tc_impl<bf16, false>,      dh_tc_impl<bf16, true>};

const DwFn kDwTable[8] = {
    dw_impl<float, float, false>, dw_impl<float, float, true>,
    dw_impl<float, bf16, false>,  dw_impl<float, bf16, true>,
    dw_tc_impl<float, false>,     dw_tc_impl<float, true>,
    dw_tc_impl<bf16, false>,      dw_tc_impl<bf16, true>};

CeArgs make_args(const void* h, const void* w, const float* normp,
                 const float* stats, const int* labels, const float* rs,
                 const float* lse, int N, int D, int V, int Vp, int norm,
                 float eps, float softcap, unsigned int seed0,
                 unsigned int seed1, const int* row_ids = nullptr) {
  CeArgs a;
  a.h = h;
  a.w = w;
  a.normp = normp;
  a.stats = stats;
  a.labels = labels;
  a.rs = rs;
  a.lse = lse;
  a.N = N;
  a.D = D;
  a.V = V;
  a.Vp = Vp;
  a.norm = norm;
  a.eps = eps;
  a.softcap = softcap;
  a.seed0 = seed0;
  a.seed1 = seed1;
  a.row_ids = row_ids;
  return a;
}

int table_index(int h_bf16, int w_bf16, int transpose_w) {
  return 4 * (h_bf16 != 0) + 2 * (w_bf16 != 0) + (transpose_w != 0);
}

}  // namespace

extern "C" {

// Workspace bytes the forward asks for (0 with fp32 h).
long long ce_forward_ws_bytes(int N, int D, int Vp, int h_bf16, int w_bf16) {
  if (!h_bf16) return 0;
  return (long long)fwd_plan(N, D, Vp, w_bf16).bytes;
}

// lse, ll (and, sampled, yhat) of every row.  row_ids: (N,) int32, the
// hash's row of each row (sampled only), or null for the row's index.
// stats: (N, 2) fp32 scratch;
// part: (4, splits, N) fp32 and part_idx (splits, N) int32 scratch, with
// splits = Vp / 128 and one tile each for bf16 h; ws: the workspace of
// ce_forward_ws_bytes.
int ce_forward_launch(const void* h, const void* w, const float* normp,
                      float* stats, const int* labels, const int* row_ids,
                      float* part, int* part_idx, float* lse, float* ll,
                      int* yhat, int N,
                      int D, int V, int Vp, int h_bf16, int w_bf16,
                      int transpose_w, int norm, float eps, float softcap,
                      int sample, unsigned int seed0, unsigned int seed1,
                      int splits, int tiles_per_split, void* ws,
                      void* stream) {
  const CeArgs a = make_args(h, w, normp, stats, labels, nullptr, nullptr, N,
                             D, V, Vp, norm, eps, softcap, seed0, seed1,
                             row_ids);
  const int idx = table_index(h_bf16, w_bf16, transpose_w);
  const ForwardFn fn = sample ? pick_forward<true>(idx)
                              : pick_forward<false>(idx);
  return (int)fn(a, stats, splits, tiles_per_split, part, part_idx, lse, ll,
                 yhat, static_cast<unsigned char*>(ws),
                 static_cast<cudaStream_t>(stream));
}

// The norm's statistics of each row, stats (N, 2): what the kernels
// normalize with (for checking them against the plain version).
int ce_row_stats_launch(const void* h, float* stats, int N, int D,
                        int h_bf16, int norm, float eps, void* stream) {
  const CeArgs a = make_args(h, nullptr, nullptr, stats, nullptr, nullptr,
                             nullptr, N, D, 0, 0, norm, eps, 0.0f, 0u, 0u);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(h_bf16 ? launch_row_stats<bf16>(a, stats, st)
                      : launch_row_stats<float>(a, stats, st));
}

// Workspace bytes the backward asks for (0 with fp32 h).
long long ce_backward_ws_bytes(int N, int D, int Vp, int h_bf16, int w_bf16,
                               int dh_f32) {
  if (!h_bf16) return 0;
  return (long long)tc_plan(N, D, Vp, w_bf16, !dh_f32).bytes;
}

// dh (N, D): fp32 when dh_f32, else h's dtype.  ws: the workspace of
// ce_backward_ws_bytes(..., dh_f32).
int ce_backward_dh_launch(const void* h, const void* w, const float* normp,
                          float* stats, const int* labels, const float* rs,
                          const float* lse, void* dh, int dh_f32, void* ws,
                          int N, int D, int V, int Vp, int h_bf16, int w_bf16,
                          int transpose_w, int norm, float eps, float softcap,
                          void* stream) {
  const CeArgs a = make_args(h, w, normp, stats, labels, rs, lse, N, D, V,
                             Vp, norm, eps, softcap, 0u, 0u);
  return (int)kDhTable[table_index(h_bf16, w_bf16, transpose_w)](
      a, stats, dh, dh_f32, static_cast<unsigned char*>(ws),
      static_cast<cudaStream_t>(stream));
}

// dW, W's shape and dtype.  ws: the workspace of ce_backward_ws_bytes(...,
// 1).
int ce_backward_dw_launch(const void* h, const void* w, const float* normp,
                          float* stats, const int* labels, const float* rs,
                          const float* lse, void* dw, void* ws, int N, int D,
                          int V, int Vp, int h_bf16, int w_bf16,
                          int transpose_w, int norm, float eps, float softcap,
                          void* stream) {
  const CeArgs a = make_args(h, w, normp, stats, labels, rs, lse, N, D, V,
                             Vp, norm, eps, softcap, 0u, 0u);
  return (int)kDwTable[table_index(h_bf16, w_bf16, transpose_w)](
      a, stats, dw, static_cast<unsigned char*>(ws),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
