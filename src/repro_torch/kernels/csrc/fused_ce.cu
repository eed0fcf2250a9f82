// Logits-free fused LM cross-entropy for Hopper (sm_90a): the forward
// sweep (labelled, or with the in-sweep Gumbel-argmax draw of GNB's
// sampled labels) and the two backward sweeps, d(normed hidden) and dW.
//
// Replaces the TPU kernels of src/repro/kernels/fused_ce.py:
//   the forward (SAMPLE = false)       _ce_forward (pallas_call :521,
//                                      body _ce_fwd_kernel :281)
//   the forward (SAMPLE = true)        _ce_forward_sampled (:544, body :312)
//     fp32 h: ce_forward_kernel<SAMPLE>; bf16 h: ce_fwd_wgmma_kernel<.,
//     SAMPLE> (wgmma fed by TMA, the fold in registers); both then
//     ce_combine_kernel
//   the backward                       _ce_backward's fused schedule (:583,
//                                      body _ce_bwd_fused_kernel :443), its
//                                      dh sweep (:601, _ce_bwd_dh_kernel
//                                      :388) and its dW sweep (:621,
//                                      _ce_bwd_dw_kernel :413)
//     fp32 h: ce_backward_dh_kernel and ce_backward_dw_kernel; bf16 h:
//     ce_wgmma_kernel's logits, dh and dW cases, one prep and one logits
//     sweep a chunk for both gradients or for one (ce_backward_launch
//     with a null dh or dW)
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
// Bound: operations.  Each product multiplies (N, D) by (D, Vp): 2 N D Vp
// flops for the forward, three times that for the backward (the logits
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
// cores through wgmma, fed by TMA (ce_fwd_wgmma_kernel).
//   * Bound: operations.  One product of 2 N D Vp flops (633 GFLOP at
//     GPT-2 small's N 8192, D 768, Vp 50304: 0.64 ms at the bf16 peak)
//     against one read of h and W (~170 MB, ~0.05 ms).  The fold adds an
//     expf an element (for the draw also the hash and two logf), work for
//     the FP32 and special-function units that the products do not use.
//   * Passes.  The backward's prep writes h_n, the normed rows rounded to
//     bf16 (rows padded to 128), and for an fp32 W its hi plane bf16(W)
//     (ce_split_kernel with no lo plane):
//     the reference's casts, so one bf16 pass gives the reference's
//     logits, each product exact and only the order of the fp32 sums
//     differing from the plain version.  Then one persistent sweep over the
//     whole vocabulary (its walk: the note above ce_fwd_wgmma_kernel), and
//     ce_combine_kernel merges each row's k partials (k pieces of the
//     vocabulary a row tile, 33 at the models' shapes on an H100: 5.4 MB
//     at N 8192 where one partial a 128-column tile took 64 MB).
//   * Pipeline.  One 384-thread block an SM: a producer warpgroup, which
//     gives its registers to the other two (setmaxnreg) and whose first
//     thread keeps a ring of three 128-deep stages full (64 KB each: h_n
//     and W as 64-deep halves of 128-byte swizzled boxes,
//     cp.async.bulk.tensor onto full/empty mbarriers), and two consumer
//     warpgroups on the rows 0-63 and 64-127 of each 128 x 128 tile.  Each
//     64-deep half sums on the tensor cores into a fresh part (four
//     m64n128k16 wgmmas) that is promoted into acc (see kWgBK), so the
//     logits equal the sums of the mma.sync kernel this replaced, which
//     promoted every 64 of k too; two parts alternate, so a half's wgmmas
//     run while the last one is added.
//   * The fold runs from registers: in the m64n128 accumulator layout one
//     row's 128 columns lie in the 4 lanes of a quad; each thread folds
//     its 32 columns of each of its 2 rows in ascending order (a max, then
//     the sum of exp(s - max); the label logit, or the first argmax of s +
//     g with its raw logit), two xor shuffles merge the quad (among equal
//     z the smaller column), and lane q carries row q's fold across the
//     unit's run of tiles (strict > across tiles).  No shared memory, no
//     block barrier, no branch inside (fold_cols).  It runs while the
//     producer refills the ring, not under products (see the note above
//     ce_fwd_wgmma_kernel).
//   * What bounds it on an H100: the fold and the feed, not the tensor
//     cores.  At GPT-2 small's shape a call's sweep takes ~1.5 ms against
//     the products' 0.64 at the peak; without its fold the kernel before
//     the producer warp took 1.21 ms of its 1.62
//     (tests/_ce_forward_compare.py, NVIDIA H100 80GB HBM3, 700 W), and
//     the draw's fold (the hash and two precise logf an element) makes
//     row 12 about twice row 11 at D 768.
//   * The draw keeps its exact arithmetic: softcap, the -1e30 sentinel,
//     row_ids and the hash (mix32, hash_gumbel) with precise expf and logf,
//     so ŷ is the first argmax of s + g over the valid columns, as the
//     reference draws it, whatever the pieces.
//
// The backward with h in bf16 (the training path) runs on the bf16 tensor
// cores through wgmma, fed by TMA (ce_wgmma_kernel), in a workspace design.
// It replaces the TPU's fused schedule (_ce_bwd_fused_kernel :443, one
// logits recompute for both gradients) and its dh and dW sweeps
// (_ce_bwd_dh_kernel :388, _ce_bwd_dw_kernel :413): ce_backward_launch
// runs the fused schedule, or with a null dh or dW one of its halves on
// the same kernels.
//   * Bound: operations.  A call does three products of 2 N D Vp flops
//     each (the logits recompute, d . W, d^T . h_n: 1.90 TFLOP at GPT-2
//     small's N 8192, D 768, Vp 50304) against ~0.35 GB of inputs and
//     outputs, ~1.9 ms at the bf16 peak against ~0.1 ms of bytes.
//   * Passes.  One prep writes h_n, the normed rows rounded to bf16, into
//     an (Np, D) plane (rows padded to 128 with zeros), and splits an fp32
//     W into bf16 planes hi = bf16(W) and lo = bf16(W - hi).  Then, for
//     each chunk of cw vocabulary columns, one logits sweep s = h_n . hi^T
//     (hi is exactly the reference's cast of W to h's dtype, so one bf16
//     pass is the reference's logits) writes d in fp32 as two bf16 planes
//     d_hi = bf16(d), d_lo = bf16(d - d_hi) to the (Np, cw) workspace; the
//     dh product adds d . W over the chunk into an fp32 accumulator as
//     d_hi.W_hi + d_hi.W_lo + d_lo.W_hi (d_hi.W + d_lo.W for bf16 W) and
//     the dW product writes the chunk's rows of dW = d_hi^T.h_n +
//     d_lo^T.h_n (h_n is exact in bf16), rounded once into W's dtype: six
//     bf16 passes of 2 N D Vp (five with bf16 W).  The pieces are needed:
//     each pair carries ~16 of fp32's 24 bits, the dropped lo.lo term is
//     ~2^-18 of a product, and every sum runs in fp32, which holds the
//     contract (2^-16 of each element's sum of absolute terms); one piece
//     puts most elements beyond it.  The standalone dh and dW calls run
//     the prep and the logits each (one pass more apiece).
//   * Pipeline.  Each product is one persistent launch of one 384-thread
//     block an SM walking 128 x 128 output tiles.  Warp 8 (its warpgroup
//     hands its registers to the consumers by setmaxnreg, 232 against 40)
//     keeps a ring of 64-deep stages full (192 KB: 6 stages for the
//     logits, 4 for dW and for dh with bf16 W, 3 for dh with fp32 W)
//     with cp.async.bulk.tensor loads of 128-byte swizzled boxes, each
//     stage's bytes counted on a full mbarrier and its reuse gated by an
//     empty one; two consumer warpgroups issue m64n128k16 wgmmas on rows
//     0-63 and 64-127 of the tile straight from shared memory, the four
//     operand layouts (tied or untied W, dh or dW) set by the descriptors'
//     major-ness and the instruction's transpose bits, no copy; the tile's
//     epilogue (d and its split to the workspace, dh accumulate, dW store)
//     runs from registers while the producer loads the next tile's
//     stages.  Blocks own their output tiles: no atomics, dW deterministic
//     and rounded once, the combined call equal to the standalone ones bit
//     for bit.
//   * Promotion.  The tensor cores drop bits below the larger operand's
//     last place when they add into their accumulator (see kPromote), so
//     each stage's wgmmas (64 of k, every pass) sum into a fresh part and
//     the part is added into the tile's sum with a rounded fp32 add.  That
//     keeps 64 + 64 accumulators a consumer thread, so a warpgroup's tile
//     is 64 x 128.
//   * Chunk width cw: the caller's (ce_backward_launch's cw, a multiple
//     of 128 columns).  fused_ce.py:backward_plan gives the seed, as many
//     128-column tiles as keep the two d planes under 256 MiB (57 tiles,
//     cw 7296, 7 chunks at N 8192), and kernels/autotune.py may measure a
//     wider or narrower one for a shape.  On an H100 the combined call
//     took 8.1, 7.6, 7.4 and 7.3 ms at 128, 256, 512 and 1024 MiB of
//     planes at GPT-2 small's shape, and 181, 184, 193 and 210 ms at
//     gemma2-9b's (N 8192, D 3584, Vp 256000): 256 MiB is within 4% of
//     each shape's best.  A chunk whose planes stay in the 50 MB L2 (cw
//     <= ~1500 at N 8192) would give dW's launch 12 tiles a chunk for 132
//     SMs; at 7296 the three launches of a chunk have 3648, 384 and 342.
//   * The chunk loop runs on the host, on the caller's stream.
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
#include <cuda.h>
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
// the bf16 tensor cores (h in bf16): wgmma fed by TMA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The tensor cores add a product into an fp32 accumulator truncating the
// bits below the larger operand's last place, so a long chain drifts
// toward zero by up to an ulp of the running sum per product (one chain
// over a 50304-column sweep put 20-67% of dh's elements past 2^-16 of
// their absolute sum on an H100).  Every product below therefore sums one
// kWgBK-deep stage on the tensor cores into a fresh part and adds the part
// into the tile's sum with a rounded fp32 add (the promotion).
constexpr int kWgBM = 128;        // output tile rows
constexpr int kWgBN = 128;        // output tile columns
constexpr int kWgBK = 64;         // k of one stage, summed apart (promotion)
constexpr int kWgThreads = 384;   // two consumer warpgroups, one producer
constexpr int kTileBytes = kWgBM * kWgBK * 2;  // one bf16 plane of a stage
constexpr int kRingBytes = 12 * kTileBytes;    // 192 KB: 3, 4 or 6 stages
constexpr int kConsumerRegs = 232, kProducerRegs = 40;  // 2 x 128 x 232 +
                                                        // 128 x 40 <= 64 K
// d to the workspace, dh accumulate, dW store
enum BwdEpilogue { kEpiDlogits = 0, kEpiDh = 1, kEpiDw = 2 };

// Epilogue state.  Logits: the chunk's first vocab column c0 and the d
// workspace planes (ldd columns).  dh: the fp32 accumulator (ld D), whether
// this chunk is the first (overwrite), and the bf16 output of the last
// chunk (null unless dh is returned in h's dtype).  dW: c0 and the output
// in W's dtype and layout.
struct Epi {
  int c0;
  bf16* d_hi;
  bf16* d_lo;
  int ldd;
  float* acc;
  int first;
  bf16* out_t;
  void* dw;
};

// The TMA descriptors of one product: A's and B's hi and lo planes (lo
// unused with fewer passes).
struct Maps {
  CUtensorMap a_hi, a_lo, b_hi, b_lo;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also sets the bytes the barrier's phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Until the phase of parity ``parity`` has completed (the phase before a
// fresh barrier's first counts as completed, parity 1).  A wait of ~10 s
// (2^34 cycles; a tile takes microseconds) traps: a load that never lands
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// One box of a 2-d tensor map into shared memory at coordinates (x
// innermost, y), its bytes counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// The 128 x 64 tile of an operand at (rows r0.., depth k0..): K-major, one
// box of 128 rows of 64 (one 128-byte swizzle row each); MN-major, two
// boxes of 64 depth rows of 64 (rows r0.. and r0 + 64..), 8 KB apart.
template <bool MN>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int r0, int k0) {
  if (MN) {
    tma_load(dst, map, bar, r0, k0);
    tma_load(dst + kTileBytes / 2, map, bar, r0 + 64, k0);
  } else {
    tma_load(dst, map, bar, k0, r0);
  }
}

// The wgmma descriptor of a 128-byte swizzled tile at p: 8-row groups
// 1024 bytes apart (SBO), 64-wide MN blocks lbo apart (MN-major).
__device__ __forceinline__ uint64_t wg_desc(const unsigned char* p,
                                            uint32_t lbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// k-step s (16 of k) of a staged tile: K-major, 32 bytes along the
// swizzle row; MN-major, 16 rows of 128 bytes (the second 64-wide block
// of a 128-wide B 8 KB on).
template <bool MN>
__device__ __forceinline__ uint64_t wg_desc_k(const unsigned char* t,
                                              int s) {
  return MN ? wg_desc(t + s * 2048, kTileBytes / 2) : wg_desc(t + s * 32, 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the registers of d here: reads after a wgmma_wait cannot move above
// it, writes before a wgmma_fence cannot move below it.
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d (m64n128) += A B (scale_d 0: d = A B), both from shared memory; TA, TB
// 1 where the operand is MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The epilogue of one consumer thread: acc[4 j + 2 h + e] is the tile's
// element at row r + 8 h, column c + 8 j + e.
template <int EPI, typename TW, bool TRANSW>
__device__ __forceinline__ void wg_epilogue(const float (&acc)[64],
                                            const CeArgs& a, const Epi& epi,
                                            int r, int c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (EPI == kEpiDlogits) {
      // row: a token row (past N: d = 0); c: a column of the chunk
      const bool live = row < a.N;
      const float lse = live ? a.lse[row] : 0.0f;
      const float rs = live ? a.rs[row] : 0.0f;
      const int lab = live ? a.labels[row] : -1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c + 8 * j;
        float d0 = 0.0f, d1 = 0.0f;
        if (live) {
          d0 = dlogit(a, acc[4 * j + 2 * h], epi.c0 + col, lse, lab, rs);
          d1 = dlogit(a, acc[4 * j + 2 * h + 1], epi.c0 + col + 1, lse, lab,
                      rs);
        }
        const bf16 h0 = __float2bfloat16_rn(d0);
        const bf16 h1 = __float2bfloat16_rn(d1);
        __nv_bfloat162 hi, lo;
        hi.x = h0;
        hi.y = h1;
        lo.x = __float2bfloat16_rn(__fsub_rn(d0, __bfloat162float(h0)));
        lo.y = __float2bfloat16_rn(__fsub_rn(d1, __bfloat162float(h1)));
        const size_t o = (size_t)row * epi.ldd + col;
        *reinterpret_cast<__nv_bfloat162*>(epi.d_hi + o) = hi;
        *reinterpret_cast<__nv_bfloat162*>(epi.d_lo + o) = lo;
      }
    } else if (EPI == kEpiDh) {
      // row: a token row; c: a column of D.  The earlier chunks' sums of
      // the row are loaded in one batch before any is used: loaded one at
      // a time, each waits behind the producer's TMA traffic (on an H100
      // at GPT-2 small's shape, 0.65 ms a chunk, twice the product itself)
      if (row >= a.N) continue;
      const size_t o0 = (size_t)row * a.D + c;
      float2 prev[16];
      if (!epi.first) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          prev[j] = __ldcg(reinterpret_cast<const float2*>(epi.acc + o0 +
                                                           8 * j));
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const size_t o = o0 + 8 * j;
        float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (!epi.first) {
          v.x = __fadd_rn(prev[j].x, v.x);
          v.y = __fadd_rn(prev[j].y, v.y);
        }
        if (epi.out_t != nullptr) {
          __nv_bfloat162 t;
          t.x = __float2bfloat16_rn(v.x);
          t.y = __float2bfloat16_rn(v.y);
          *reinterpret_cast<__nv_bfloat162*>(epi.out_t + o) = t;
        } else {
          *reinterpret_cast<float2*>(epi.acc + o) = v;
        }
      }
    } else {
      // row: a vocab column of the chunk; c: a column of D
      TW* dw = static_cast<TW*>(epi.dw);
      const int col = epi.c0 + row;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = c + 8 * j;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (TRANSW) {
          dw[(size_t)k * a.Vp + col] = from_float<TW>(v0);
          dw[(size_t)(k + 1) * a.Vp + col] = from_float<TW>(v1);
        } else {
          dw[(size_t)col * a.D + k] = from_float<TW>(v0);
          dw[(size_t)col * a.D + k + 1] = from_float<TW>(v1);
        }
      }
    }
  }
}

// The backward's products, A (M x K) . B (K x N) over k < K, PASSES 1 the
// hi planes alone, 2 adding A_lo.B_hi, 3 adding A_hi.B_lo too, then the
// epilogue EPI; A_MN / B_MN: the operand is stored MN-major (its k not
// contiguous).  A persistent block of one SM walks the 128 x 128 output
// tiles t = blockIdx.x, + gridDim.x, ...: the logits run the row tiles
// fastest (the blocks in flight share a few tiles of W and keep all of h_n
// in the L2 cache), d . W and d^T . h_n the D tiles (the blocks in flight
// share a block of d).  Warp 8 (the producer warpgroup, its registers
// given to the consumers) keeps the ring of 64-deep stages full with TMA
// loads on mbarriers; consumer warpgroup g (threads 128 g..) issues the
// wgmmas of rows 64 g.. of each tile, sums each stage's passes on the
// tensor cores into part and adds part into acc with rounded fp32 adds
// (the promotion, see kWgBK), releases the stage, and stores the tile
// while the producer is already loading the next one's stages.  Every
// dimension is a multiple of 128; blocks own their output tiles outright.
template <int EPI, bool A_MN, bool B_MN, int PASSES, typename TW,
          bool TRANSW>
__global__ void __launch_bounds__(kWgThreads, 1)
ce_wgmma_kernel(const __grid_constant__ Maps maps, int K, int tiles_m,
                int tiles_n, CeArgs a, Epi epi) {
  constexpr int kAPlanes = PASSES >= 2 ? 2 : 1;
  constexpr int kBPlanes = PASSES == 3 ? 2 : 1;
  constexpr int kStageBytes = (kAPlanes + kBPlanes) * kTileBytes;
  constexpr int kRing = kRingBytes / kStageBytes;
  static_assert(kRing * kStageBytes == kRingBytes, "whole stages");
  extern __shared__ __align__(128) unsigned char wg_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* ring =
      wg_smem + ((1024 - (smem_addr(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingBytes);
  uint64_t* empty = full + kRing;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);    // the producer's expect_tx, then the bytes
      mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = tiles_m * tiles_n;
  const int nk = K / kWgBK;
  auto coords = [&](int t, int& m0, int& n0) {
    const bool rows_fast = EPI == kEpiDlogits;
    m0 = (rows_fast ? t % tiles_m : t / tiles_n) * kWgBM;
    n0 = (rows_fast ? t / tiles_m : t % tiles_n) * kWgBN;
  };

  if (threadIdx.x >= 256) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) {
      // B's vocabulary offset: the logits' rows of W, d . W's depth
      const int b_r = EPI == kEpiDlogits ? epi.c0 : 0;
      const int b_k = EPI == kEpiDh ? epi.c0 : 0;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int m0, n0;
        coords(t, m0, n0);
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * kStageBytes;
          uint64_t* bar = &full[stage];
          mbar_expect_tx(bar, kStageBytes);
          const int k0 = kb * kWgBK;
          load_tile<A_MN>(st, &maps.a_hi, bar, m0, k0);
          if (kAPlanes == 2)
            load_tile<A_MN>(st + kTileBytes, &maps.a_lo, bar, m0, k0);
          unsigned char* sb = st + kAPlanes * kTileBytes;
          load_tile<B_MN>(sb, &maps.b_hi, bar, b_r + n0, b_k + k0);
          if (kBPlanes == 2)
            load_tile<B_MN>(sb + kTileBytes, &maps.b_lo, bar, b_r + n0,
                            b_k + k0);
          if (++stage == kRing) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int g = threadIdx.x / 128;
    const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int m0, n0;
      coords(t, m0, n0);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = ring + stage * kStageBytes;
        const unsigned char* ta = st + g * (kTileBytes / 2);  // rows 64 g..
        const unsigned char* tb = st + kAPlanes * kTileBytes;
        hold(part);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kWgBK / 16; ++s) {
          const uint64_t da = wg_desc_k<A_MN>(ta, s);
          const uint64_t db = wg_desc_k<B_MN>(tb, s);
          wgmma_n128<A_MN, B_MN>(part, da, db, s > 0);
          if (PASSES >= 2)
            wgmma_n128<A_MN, B_MN>(part, wg_desc_k<A_MN>(ta + kTileBytes, s),
                                   db, 1);
          if (PASSES == 3)
            wgmma_n128<A_MN, B_MN>(part, da,
                                   wg_desc_k<B_MN>(tb + kTileBytes, s), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        hold(part);
        if (lane == 0) mbar_arrive(&empty[stage]);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        if (++stage == kRing) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_epilogue<EPI, TW, TRANSW>(acc, a, epi,
                                   m0 + 64 * g + 16 * warp + lane / 4,
                                   n0 + 2 * (lane % 4));
    }
  }
}

// ---------------------------------------------------------------------------
// the forward on the bf16 tensor cores: ce_fwd_wgmma_kernel
//
// A persistent block of one SM walks 128 x 128 logits tiles.  The walk
// (fused_ce.py:forward_plan mirrors it): the (Np / 128) x (Vp / 128)
// tiles, each row tile's vocabulary cut into k pieces of consecutive
// tiles, the first T % k of them one tile longer; the row tiles in groups
// of G, and within a group unit (j, i), piece j of row tile i, with the
// row tiles fastest; block b takes the units b, b + gridDim.x, ..., one
// run of consecutive tiles each.  The blocks in flight then share a few W
// tiles and a group's rows of h_n, which stay in the 50 MB L2 cache: G
// is every row tile where h_n takes at most 20 MB (GPT-2 small's 12.6 MB
// at N 8192), else 12 (about the square root of the blocks in flight, so
// a group's rows and the W tiles in flight take about as many bytes).
// The host picks k for the fewest tiles on the busiest block.
//
// A block is 384 threads: consumer warpgroup g (warps 4 g..4 g + 3, g <
// 2) owns rows 64 g.. of every tile, and the two share one ring of
// kFwdRing 128-deep stages (h_n's 128 rows and the W tile, each as two
// 64-deep halves) that the producer warpgroup's first thread fills (the
// note above ce_fwd_wgmma_kernel).

struct FwdPlan {
  int n_rt, T, k, nk;  // row tiles, vocab tiles, pieces, stages a tile
  int G;               // row tiles a group
};

// The partials that ce_combine_kernel merges, one per (piece, row):
// part[{m, l, ll, zm}][piece][row] and part_idx[piece][row].
struct FoldOut {
  float* part;
  int* part_idx;
};

struct FwdUnit {
  int m0, j, v0, v1;  // rows m0.., piece j, vocab tiles [v0, v1)
};

// Unit u: in group u / (G k) of G row tiles (the last may hold fewer),
// piece j of row tile i, the row tiles fastest.
__device__ __forceinline__ FwdUnit fwd_unit(const FwdPlan& p, int u) {
  const int grp = u / (p.G * p.k), r = u % (p.G * p.k);
  const int rows = min(p.G, p.n_rt - grp * p.G);
  const int j = r / rows, q = p.T / p.k, rem = p.T % p.k;
  FwdUnit f;
  f.m0 = (grp * p.G + r % rows) * kWgBM;
  f.j = j;
  f.v0 = j * q + min(j, rem);
  f.v1 = f.v0 + q + (j < rem ? 1 : 0);
  return f;
}

// A fold of some columns of one row: lse's (m, l) over its valid columns
// and the label logit ll, or (sampled) the first argmax zi of s + g, its
// z and its raw logit ll.
struct Fold {
  float m, l, ll, z;
  int zi;
};

// (m, l) <- the log-sum-exp merge of (m, l) and (m2, l2): l e^(m - mn) +
// l2 e^(m2 - mn) with mn = max(m, m2).  One factor is e^0 = 1, so one
// expf; the products and the sum are rounded apart (no contraction), so
// the two lanes of a shuffle pair agree bit for bit.
__device__ __forceinline__ void lse_merge(float& m, float& l, float m2,
                                          float l2) {
  const float e = expf(-fabsf(m - m2));
  const bool mine = m >= m2;
  l = __fadd_rn(__fmul_rn(l, mine ? 1.0f : e), __fmul_rn(l2, mine ? e : 1.0f));
  m = fmaxf(m, m2);
}

// The quad's four threads, which hold the other 96 columns of f's row,
// merged into f by xor shuffles 1 and 2 (among equal z the smaller
// column); every lane of the quad ends with the row's fold.
template <bool SAMPLE>
__device__ __forceinline__ void quad_merge(Fold& f) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, f.m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, f.l, off);
    const float ll2 = __shfl_xor_sync(0xffffffffu, f.ll, off);
    lse_merge(f.m, f.l, m2, l2);
    if (SAMPLE) {
      const float z2 = __shfl_xor_sync(0xffffffffu, f.z, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, f.zi, off);
      if (z2 > f.z || (z2 == f.z && i2 < f.zi)) {
        f.z = z2;
        f.zi = i2;
        f.ll = ll2;
      }
    } else {
      f.ll = __fadd_rn(f.ll, ll2);  // one column of the row holds the label
    }
  }
}

// A consumer thread's two rows of its warpgroup's 64 x 128 tile (rows r, r
// + 8: row h's elements at acc[4 j + 2 h + e], vocab columns c + 8 j + e,
// j < 16, e < 2), folded from registers: each row's 32 logits finished
// (finish_logit's arithmetic, written back over acc) and their max taken,
// then folded in ascending column order (the sum of exp(s - max), and the
// label logit or the draw: strict >, the thread's columns rise).  The
// code has no branch inside: the softcap is a template argument, a column
// past V adds exp(-inf) = +0 to the sum (the same bits as skipping it) and
// cannot win the draw, so the 64 elements' exp, hash and logf chains are
// one block the compiler interleaves (a branch around each element's
// chain kept them apart: on an H100 at GPT-2 small's shape the fold then
// took more time than the products).
template <bool SAMPLE, bool CAP>
__device__ __forceinline__ void fold_cols(float (&acc)[64], const CeArgs& a,
                                          int c, const int (&lab)[2],
                                          const uint32_t (&rmix)[2],
                                          Fold (&f)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) f[h] = Fold{kNegInf, 0.0f, 0.0f, kNegInf, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = acc[4 * j + 2 * h + e];
        if (CAP) x = a.softcap * tanhf(x / a.softcap);
        x = c + 8 * j + e < a.V ? x : kNegInf;
        f[h].m = fmaxf(f[h].m, x);
      }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c + 8 * j + e;
      const bool valid = col < a.V;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s = acc[4 * j + 2 * h + e];
        f[h].l += expf(valid ? s - f[h].m : -INFINITY);
        if (SAMPLE) {
          const float z = s + hash_gumbel(rmix[h], (uint32_t)col, a.seed1);
          const bool take = valid && z > f[h].z;
          f[h].z = take ? z : f[h].z;
          f[h].zi = take ? col : f[h].zi;
          f[h].ll = take ? s : f[h].ll;
        } else {
          f[h].ll = col == lab[h] ? s : f[h].ll;
        }
      }
    }
}

// fold_cols with the call's softcap, then each row's quad merged
// (quad_merge).
template <bool SAMPLE>
__device__ __forceinline__ void fold_rows(float (&acc)[64], const CeArgs& a,
                                          int c, const int (&lab)[2],
                                          const uint32_t (&rmix)[2],
                                          Fold (&f)[2]) {
  if (a.softcap > 0.0f)
    fold_cols<SAMPLE, true>(acc, a, c, lab, rmix, f);
  else
    fold_cols<SAMPLE, false>(acc, a, c, lab, rmix, f);
  quad_merge<SAMPLE>(f[0]);
  quad_merge<SAMPLE>(f[1]);
}

// The running fold of a unit's row (lane q's row q, q < 2): merge one
// tile's fold t of the row into it where ``mine``; strict > for the draw,
// since the tile's columns follow the run's.
template <bool SAMPLE>
__device__ __forceinline__ void run_merge(Fold& run, bool mine,
                                          const Fold& t) {
  if (!mine) return;
  lse_merge(run.m, run.l, t.m, t.l);
  if (SAMPLE) {
    if (t.z > run.z) {
      run.z = t.z;
      run.zi = t.zi;
      run.ll = t.ll;
    }
  } else {
    run.ll = __fadd_rn(run.ll, t.ll);
  }
}

// ---- the forward's feed, products and kernel (tests/_ce_forward_compare.py
// builds variants with another text from this line to the prep kernels)
constexpr int kFwdThreads = 384;  // two consumer warpgroups, one producer
constexpr int kFwdRing = 3;       // 128-deep stages
constexpr int kFwdK = 2 * kWgBK;  // k of a stage: two promotions
constexpr int kFwdHBox = 128;     // rows of h_n's TMA box
// a stage: h_n 128 x 128 and W 128 x 128, each two 64-deep halves
constexpr int kFwdStageBytes = 4 * kTileBytes;
// the ring, 1024 bytes to align it, its full and empty barriers
constexpr int kFwdSmem = kFwdRing * kFwdStageBytes + 1024 + 2 * kFwdRing * 8;
constexpr int kFwdConsumerRegs = 240, kFwdProducerRegs = 24;  // 2 x 128 x
                                                              // 240 + 128 x
                                                              // 24 <= 64 K

// The producer (warpgroup 2's first thread): every stage of the block's
// walk, each into its ring slot once both consumer warpgroups released it.
template <bool B_MN>
__device__ __forceinline__ void fwd_produce(const Maps& maps,
                                            const FwdPlan& p, int units,
                                            unsigned char* ring,
                                            uint64_t* full,
                                            uint64_t* empty) {
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const FwdUnit f = fwd_unit(p, u);
    for (int v = f.v0; v < f.v1; ++v)
      for (int kb = 0; kb < p.nk; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * kFwdStageBytes;
        uint64_t* bar = &full[stage];
        mbar_expect_tx(bar, kFwdStageBytes);
        const int k0 = kb * kFwdK;
        load_tile<false>(st, &maps.a_hi, bar, f.m0, k0);
        load_tile<false>(st + kTileBytes, &maps.a_hi, bar, f.m0, k0 + kWgBK);
        unsigned char* sb = st + 2 * kTileBytes;
        load_tile<B_MN>(sb, &maps.b_hi, bar, v * kWgBN, k0);
        load_tile<B_MN>(sb + kTileBytes, &maps.b_hi, bar, v * kWgBN,
                        k0 + kWgBK);
        if (++stage == kFwdRing) {
          stage = 0;
          phase ^= 1;
        }
      }
  }
}

// Issue the four m64n128k16 wgmmas of 64-deep half ``h`` of the stage at
// ``st`` into d (d = the half's product), one commit group.  da, db: the
// descriptors of the stage's rows of h_n and of W at k = 0; a half is 16
// KB further (1024 in a descriptor's address field), a k-step 32 bytes
// (K-major, 2) or 16 rows of 128 bytes (MN-major, 128).
template <bool B_MN>
__device__ __forceinline__ void issue_half(float (&d)[64], uint64_t da,
                                           uint64_t db, int h) {
  hold(d);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kWgBK / 16; ++s)
    wgmma_n128<0, B_MN>(d, da + 1024 * h + 2 * s,
                        db + 1024 * h + (B_MN ? 128 : 2) * s, s > 0);
  wgmma_commit();
}

// acc += d, the promotion of one half's product once its group is done
// (the caller's wgmma_wait).
__device__ __forceinline__ void promote(float (&acc)[64], float (&d)[64]) {
  hold(d);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// The logits of one forward call, h_n (Np x D) . hi^T over the whole
// vocabulary, folded into one partial per (piece, row) with no logit
// leaving the registers.
//   * Feed.  Warpgroup 2 gives its registers to the consumers
//     (setmaxnreg: 240 a consumer thread, 24 a producer thread; ptxas
//     allocates the consumers' code up to 240) and its first thread keeps
//     the ring of kFwdRing 128-deep stages full with 128-byte swizzled TMA
//     boxes, across tiles and units, so the ring is full when a fold
//     begins and the next tile's products start at once.  No consumer
//     waits on an empty barrier.
//   * Products.  Warpgroup g sums each 64-deep half of a stage for its 64
//     rows on the tensor cores into a fresh part (four m64n128k16 wgmmas
//     straight from shared memory; the W tile K-major when tied, MN-major
//     when untied, by descriptor alone) and adds the part into acc (the
//     promotion).  Two parts alternate, so a half's wgmmas run while the
//     previous half's part is added.  A 128-deep stage halves the
//     handshakes a product.
//   * Fold.  At the end of a tile each warpgroup folds its 64 rows from acc
//     (fold_rows; lane q < 2 of each quad then merges the tile into the
//     running fold of the quad's row q, strict > across tiles) while the
//     producer refills the ring; at the end of a unit each lane q < 2
//     writes its row's partial.  The fold does not run under products: a
//     ping-pong that puts it there (each warpgroup its own 64-row tiles,
//     their products in turns; tests/_ce_forward_variants.cu) feeds 1.5x
//     the bytes a product and was slower on an H100 at every timed shape
//     once the fold lost its branches (PERF.md, PR 32).
//   * Registers: acc 64 and two parts of 64 a thread, the running fold 5,
//     the unit's labels or row hash words 2 (ptxas: 20-36 bytes of spill
//     at 240, and its C7514 note that the wgmmas are serialized).
template <bool B_MN, bool SAMPLE>
__global__ void __launch_bounds__(kFwdThreads, 1)
ce_fwd_wgmma_kernel(const __grid_constant__ Maps maps, FwdPlan p, CeArgs a,
                    FoldOut out) {
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* ring =
      wg_smem + ((1024 - (smem_addr(wg_smem) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kFwdRing * kFwdStageBytes);
  uint64_t* empty = full + kFwdRing;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdRing; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx, then the bytes
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int units = p.n_rt * p.k;
  if (threadIdx.x >= 256) {
    reg_dealloc<kFwdProducerRegs>();
    if (threadIdx.x == 256)
      fwd_produce<B_MN>(maps, p, units, ring, full, empty);
    return;
  }
  reg_alloc<kFwdConsumerRegs>();
  const int g = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int q = lane % 4;
  const int rl = 64 * g + 16 * warp + lane / 4;  // the thread's first row
  float acc[64], part0[64], part1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part0[i] = part1[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  // the descriptors of slot s: rows 64 g.. of h_n, and W
  auto desc_a = [&](int s) {
    return wg_desc_k<false>(ring + s * kFwdStageBytes + g * (kTileBytes / 2),
                            0);
  };
  auto desc_b = [&](int s) {
    return wg_desc_k<B_MN>(ring + s * kFwdStageBytes + 2 * kTileBytes, 0);
  };
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const FwdUnit f = fwd_unit(p, u);
    int lab[2];
    uint32_t rmix[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.m0 + rl + 8 * h;
      lab[h] = !SAMPLE && row < a.N ? a.labels[row] : -1;
      rmix[h] = SAMPLE ? row_word(a, row) : 0u;
    }
    Fold run{kNegInf, 0.0f, 0.0f, kNegInf, 0};  // lane q's row q (q < 2)
    for (int v = f.v0; v < f.v1; ++v) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      int prev = 0;
      for (int kb = 0; kb < p.nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint64_t da = desc_a(stage), db = desc_b(stage);
        issue_half<B_MN>(part0, da, db, 0);
        if (kb > 0) {
          // the previous stage's second half, then its slot
          wgmma_wait<1>();
          promote(acc, part1);
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        issue_half<B_MN>(part1, da, db, 1);
        wgmma_wait<1>();
        promote(acc, part0);
        prev = stage;
        if (++stage == kFwdRing) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      promote(acc, part1);
      if (lane == 0) mbar_arrive(&empty[prev]);
      const int col = v * kWgBN + 2 * q;
      Fold fr[2];
      fold_rows<SAMPLE>(acc, a, col, lab, rmix, fr);
      run_merge<SAMPLE>(run, q == 0, fr[0]);
      run_merge<SAMPLE>(run, q == 1, fr[1]);
    }
    const int row = f.m0 + rl + 8 * q;
    if (q < 2 && row < a.N) {
      const size_t P4 = (size_t)p.k * a.N;
      const size_t o = (size_t)f.j * a.N + row;
      out.part[o] = run.m;
      out.part[P4 + o] = run.l;
      out.part[2 * P4 + o] = run.ll;
      if (SAMPLE) {
        out.part[3 * P4 + o] = run.z;
        out.part_idx[o] = run.zi;
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

// hi = bf16(w) and, unless lo is null, lo = bf16(w - hi), four elements a
// thread and step (16-byte loads, read once: streaming).  n4 = n / 4: n
// is a multiple of 4 (D % 128 == 0) and w starts on a 16-byte boundary
// (the wrapper's check).
__global__ void __launch_bounds__(kThreads)
ce_split_kernel(const float4* __restrict__ w, size_t n4,
                uint2* __restrict__ hi, uint2* __restrict__ lo) {
  auto bits = [](__nv_bfloat162 v) {
    return *reinterpret_cast<const uint32_t*>(&v);
  };
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n4;
       e += (size_t)gridDim.x * kThreads) {
    const float4 x = __ldcs(w + e);
    const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    hi[e] = make_uint2(bits(a), bits(b));
    if (lo != nullptr)
      lo[e] = make_uint2(
          bits(__floats2bfloat162_rn(__fsub_rn(x.x, __low2float(a)),
                                     __fsub_rn(x.y, __high2float(a)))),
          bits(__floats2bfloat162_rn(__fsub_rn(x.z, __low2float(b)),
                                     __fsub_rn(x.w, __high2float(b)))));
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
// and, when dh is returned in bf16, its fp32 accumulator (N, D).  cw, the
// vocabulary columns of a chunk, is the caller's (valid_cw).
struct TcPlan {
  int Np, cw, n_chunks;
  bool w_lo_plane;
  size_t hn, w_hi, w_lo, d_hi, d_lo, acc, bytes;
};

size_t up256(size_t x) { return (x + 255) / 256 * 256; }

// A chunk width the backward takes: whole 128-column tiles, at most Vp.
bool valid_cw(int Vp, int cw) {
  return cw > 0 && cw % kWgBN == 0 && cw <= Vp;
}

TcPlan tc_plan(int N, int D, int Vp, int w_bf16, int dh_acc, int cw) {
  TcPlan p;
  p.Np = (N + kWgBM - 1) / kWgBM * kWgBM;
  p.n_chunks = (Vp + cw - 1) / cw;
  p.cw = cw;
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
  TcPlan p = tc_plan(N, D, Vp, w_bf16, 0, Vp);
  p.n_chunks = 1;
  p.cw = Vp;
  p.w_lo_plane = false;
  p.w_lo = p.d_hi = p.d_lo = p.acc = p.bytes =
      p.w_hi + (w_bf16 ? 0 : up256(size_t(2) * Vp * D));
  return p;
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
      static_cast<const float4*>(a.w), (size_t)a.Vp * a.D / 4,
      reinterpret_cast<uint2*>(ws + p.w_hi),
      p.w_lo_plane ? reinterpret_cast<uint2*>(ws + p.w_lo) : nullptr);
  return cudaGetLastError();
}

// W's bf16 hi plane: the workspace's for an fp32 W, else W itself; (vocab
// c, depth k) lies at c D + k in a tied W (Vp, D) and at k Vp + c in an
// untied one (D, Vp).
template <typename TW>
const bf16* w_hi_plane(const CeArgs& a, const TcPlan& p,
                       const unsigned char* ws) {
  if (!std::is_same<TW, float>::value) return static_cast<const bf16*>(a.w);
  return reinterpret_cast<const bf16*>(ws + p.w_hi);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links no libcuda); null where it is missing.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// The TMA map of a (outer, inner) bf16 plane: boxes of 64 inner elements
// (one 128-byte swizzle row) by box_rows, swizzled 128 bytes as the wgmma
// descriptors read them.  box_rows 128 for an operand read K-major (inner
// is its k), 64 for one read MN-major.
bool plane_map(CUtensorMap* map, const void* base, int inner, int outer,
               int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

template <int EPI, bool A_MN, bool B_MN, int PASSES, typename TW,
          bool TRANSW>
cudaError_t launch_wgmma(const Maps& maps, int K, int tiles_m, int tiles_n,
                         const CeArgs& a, const Epi& epi, cudaStream_t st) {
  // the ring, 1024 bytes to align it, and its full and empty barriers
  constexpr int smem = kRingBytes + 1024 + 2 * 6 * 8;
  auto kern = ce_wgmma_kernel<EPI, A_MN, B_MN, PASSES, TW, TRANSW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = std::min(tiles_m * tiles_n, sm_count());
  kern<<<grid, kWgThreads, smem, st>>>(maps, K, tiles_m, tiles_n, a, epi);
  return cudaGetLastError();
}

// The forward with bf16 h: the prep (h_n, and W's hi plane for an fp32
// W), one persistent ce_fwd_wgmma_kernel sweep over the whole vocabulary
// in ``splits`` = k pieces a row tile, the row tiles in groups of
// ``group`` (fused_ce.py:forward_plan), then ce_combine_kernel merges each
// row's k partials in column order.
template <typename TW, bool TRANSW, bool SAMPLE>
cudaError_t forward_tc_impl(const CeArgs& a, float* stats, int splits,
                            int group, float* part, int* part_idx, float* lse,
                            float* ll, int* yhat, unsigned char* ws,
                            cudaStream_t st) {
  const int T = a.Vp / kWgBN;
  if (splits < 1 || splits > T) return cudaErrorInvalidValue;
  const TcPlan p = fwd_plan(a.N, a.D, a.Vp, !std::is_same<TW, float>::value);
  cudaError_t err = tc_prep<TW>(a, stats, p, ws, st);
  if (err != cudaSuccess) return err;
  // A = h_n K-major; B = W, n over the vocabulary, K-major tied and
  // MN-major untied (the backward's logits maps)
  const int w_in = TRANSW ? a.Vp : a.D, w_out = TRANSW ? a.D : a.Vp;
  Maps m{};
  if (!(plane_map(&m.a_hi, ws + p.hn, a.D, p.Np, kFwdHBox) &&
        plane_map(&m.b_hi, w_hi_plane<TW>(a, p, ws), w_in, w_out,
                  TRANSW ? 64 : 128)))
    return cudaErrorInvalidValue;
  if (group < 1 || group > p.Np / kWgBM) return cudaErrorInvalidValue;
  const FwdPlan fp{p.Np / kWgBM, T, splits, a.D / kFwdK, group};
  const int units = fp.n_rt * fp.k;
  auto kern = ce_fwd_wgmma_kernel<TRANSW, SAMPLE>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kFwdSmem);
  if (err != cudaSuccess) return err;
  kern<<<std::min(sm_count(), units), kFwdThreads, kFwdSmem, st>>>(
      m, fp, a, FoldOut{part, part_idx});
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_combine_kernel<<<(a.N + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.N, splits, SAMPLE ? 1 : 0, part, part_idx, lse, ll, yhat);
  return cudaGetLastError();
}

// The bf16-h backward: one prep, then for each vocabulary chunk one logits
// sweep writing d as (d_hi, d_lo), the dh product (unless dh is null) and
// the dW product (unless dw is null).  The products of a chunk follow its
// logits on the stream, and the next chunk's logits follow both.
template <typename TW, bool TRANSW>
cudaError_t backward_tc_impl(const CeArgs& a, float* stats, void* dh,
                             int dh_f32, void* dw, int cw, unsigned char* ws,
                             cudaStream_t st) {
  constexpr bool kW32 = std::is_same<TW, float>::value;
  if (!valid_cw(a.Vp, cw)) return cudaErrorInvalidValue;
  const TcPlan p =
      tc_plan(a.N, a.D, a.Vp, !kW32, dh != nullptr && !dh_f32, cw);
  cudaError_t err = tc_prep<TW>(a, stats, p, ws, st);
  if (err != cudaSuccess) return err;
  const bf16* hn = reinterpret_cast<const bf16*>(ws + p.hn);
  const bf16* w_hi = w_hi_plane<TW>(a, p, ws);
  const bf16* w_lo = reinterpret_cast<const bf16*>(ws + p.w_lo);
  bf16* d_hi = reinterpret_cast<bf16*>(ws + p.d_hi);
  bf16* d_lo = reinterpret_cast<bf16*>(ws + p.d_lo);
  // W as stored: (Vp, D) tied, (D, Vp) untied
  const int w_in = TRANSW ? a.Vp : a.D, w_out = TRANSW ? a.D : a.Vp;
  // logits h_n . hi^T: A = h_n K-major; B = W, n over the vocabulary,
  // K-major tied and MN-major untied
  Maps lg{}, mh{}, mw{};
  bool ok = plane_map(&lg.a_hi, hn, a.D, p.Np, 128) &&
            plane_map(&lg.b_hi, w_hi, w_in, w_out, TRANSW ? 64 : 128);
  // d . W: A = d K-major; B = W, n over D, MN-major tied, K-major untied
  if (dh != nullptr)
    ok = ok && plane_map(&mh.a_hi, d_hi, p.cw, p.Np, 128) &&
         plane_map(&mh.a_lo, d_lo, p.cw, p.Np, 128) &&
         plane_map(&mh.b_hi, w_hi, w_in, w_out, TRANSW ? 128 : 64) &&
         (!kW32 || plane_map(&mh.b_lo, w_lo, w_in, w_out, TRANSW ? 128 : 64));
  // d^T . h_n: A = d^T (m the chunk's columns, k the rows), B = h_n (n
  // over D), both MN-major
  if (dw != nullptr)
    ok = ok && plane_map(&mw.a_hi, d_hi, p.cw, p.Np, 64) &&
         plane_map(&mw.a_lo, d_lo, p.cw, p.Np, 64) &&
         plane_map(&mw.b_hi, hn, a.D, p.Np, 64);
  if (!ok) return cudaErrorInvalidValue;
  for (int ci = 0; ci < p.n_chunks; ++ci) {
    const int c0 = ci * p.cw, width = std::min(p.cw, a.Vp - c0);
    Epi e{};
    e.c0 = c0;
    e.d_hi = d_hi;
    e.d_lo = d_lo;
    e.ldd = p.cw;
    err = launch_wgmma<kEpiDlogits, false, TRANSW, 1, TW, TRANSW>(
        lg, a.D, p.Np / kWgBM, width / kWgBN, a, e, st);
    if (err != cudaSuccess) return err;
    if (dh != nullptr) {
      Epi eh{};
      eh.c0 = c0;
      eh.acc = dh_f32 ? static_cast<float*>(dh)
                      : reinterpret_cast<float*>(ws + p.acc);
      eh.first = ci == 0;
      eh.out_t = !dh_f32 && ci == p.n_chunks - 1 ? static_cast<bf16*>(dh)
                                                  : nullptr;
      err = kW32 ? launch_wgmma<kEpiDh, false, !TRANSW, 3, TW, TRANSW>(
                       mh, width, p.Np / kWgBM, a.D / kWgBN, a, eh, st)
                 : launch_wgmma<kEpiDh, false, !TRANSW, 2, TW, TRANSW>(
                       mh, width, p.Np / kWgBM, a.D / kWgBN, a, eh, st);
      if (err != cudaSuccess) return err;
    }
    if (dw != nullptr) {
      Epi ew{};
      ew.c0 = c0;
      ew.dw = dw;
      err = launch_wgmma<kEpiDw, true, true, 2, TW, TRANSW>(
          mw, p.Np, width / kWgBM, a.D / kWgBN, a, ew, st);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// The backward with h in fp32: the dh kernel (unless dh is null), then
// the dW kernel (unless dw is null).  It has no chunks: cw must be 0.
template <typename T, typename TW, bool TRANSW>
cudaError_t backward_impl(const CeArgs& a, float* stats, void* dh,
                          int dh_f32, void* dw, int cw, unsigned char* ws,
                          cudaStream_t st) {
  if (cw != 0) return cudaErrorInvalidValue;
  if (dh != nullptr) {
    const cudaError_t err =
        dh_impl<T, TW, TRANSW>(a, stats, dh, dh_f32, ws, st);
    if (err != cudaSuccess || dw == nullptr) return err;
  }
  return dw_impl<T, TW, TRANSW>(a, stats, dw, ws, st);
}

typedef cudaError_t (*ForwardFn)(const CeArgs&, float*, int, int, float*,
                                 int*, float*, float*, int*, unsigned char*,
                                 cudaStream_t);
typedef cudaError_t (*BackwardFn)(const CeArgs&, float*, void*, int, void*,
                                  int, unsigned char*, cudaStream_t);

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

const BackwardFn kBackwardTable[8] = {
    backward_impl<float, float, false>, backward_impl<float, float, true>,
    backward_impl<float, bf16, false>,  backward_impl<float, bf16, true>,
    backward_tc_impl<float, false>,     backward_tc_impl<float, true>,
    backward_tc_impl<bf16, false>,      backward_tc_impl<bf16, true>};

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
// part: (4, splits, N) fp32 and part_idx (splits, N) int32 scratch: with
// fp32 h splits vocab splits of ``per`` tiles each, with bf16 h splits =
// k, the pieces of forward_plan, and ``per`` its row group; ws: the
// workspace of ce_forward_ws_bytes.
int ce_forward_launch(const void* h, const void* w, const float* normp,
                      float* stats, const int* labels, const int* row_ids,
                      float* part, int* part_idx, float* lse, float* ll,
                      int* yhat, int N,
                      int D, int V, int Vp, int h_bf16, int w_bf16,
                      int transpose_w, int norm, float eps, float softcap,
                      int sample, unsigned int seed0, unsigned int seed1,
                      int splits, int per, void* ws, void* stream) {
  const CeArgs a = make_args(h, w, normp, stats, labels, nullptr, nullptr, N,
                             D, V, Vp, norm, eps, softcap, seed0, seed1,
                             row_ids);
  const int idx = table_index(h_bf16, w_bf16, transpose_w);
  const ForwardFn fn = sample ? pick_forward<true>(idx)
                              : pick_forward<false>(idx);
  return (int)fn(a, stats, splits, per, part, part_idx, lse, ll,
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

// Workspace bytes the backward asks for at chunk width cw (0 with fp32
// h, whose cw is 0; -1 for a cw the route does not take).
long long ce_backward_ws_bytes(int N, int D, int Vp, int h_bf16, int w_bf16,
                               int dh_f32, int cw) {
  if (!h_bf16) return cw == 0 ? 0 : -1;
  if (!valid_cw(Vp, cw)) return -1;
  return (long long)tc_plan(N, D, Vp, w_bf16, !dh_f32, cw).bytes;
}

// dh (N, D; fp32 when dh_f32, else h's dtype) and dW (W's shape and
// dtype); a null dh or dW is not computed (dh_f32 is then 1), so one call
// gives both or either.  With bf16 h one prep and one logits sweep a chunk
// feed the products asked for, each bit for bit what it gives alone, in
// chunks of cw vocabulary columns (a multiple of 128 up to Vp; another
// returns cudaErrorInvalidValue); with fp32 h the two FMA kernels (cw 0).
// ws: the workspace of ce_backward_ws_bytes(..., dh_f32, cw).
int ce_backward_launch(const void* h, const void* w, const float* normp,
                       float* stats, const int* labels, const float* rs,
                       const float* lse, void* dh, int dh_f32, void* dw,
                       void* ws, int N, int D, int V, int Vp, int h_bf16,
                       int w_bf16, int transpose_w, int norm, float eps,
                       float softcap, int cw, void* stream) {
  const CeArgs a = make_args(h, w, normp, stats, labels, rs, lse, N, D, V,
                             Vp, norm, eps, softcap, 0u, 0u);
  return (int)kBackwardTable[table_index(h_bf16, w_bf16, transpose_w)](
      a, stats, dh, dh_f32, dw, cw, static_cast<unsigned char*>(ws),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
