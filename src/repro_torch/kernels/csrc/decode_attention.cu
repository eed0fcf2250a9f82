// Decode attention for Hopper (sm_90a): one query token per (slot, head)
// against the slot-major ring KV cache of the serve engine.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_pallas, bodies _decode_kernel (bf16/fp32 cache) and
// _decode_kernel_q8 (int8 cache + fp32 per-token scales).  It computes the
// same function: fp32 scores q.k * scale, optional softcap c*tanh(s/c), ring
// validity abs = pos - ((pos - s) mod C) >= 0 (and abs > pos - window),
// masked scores at the -1e30 sentinel, fp32 online softmax over the ring,
// GQA h -> h / G, output acc / max(l, 1e-30) in q's dtype.  An int8 entry
// dequantizes as fp32(q8) * scale, rounded once into q's dtype.
//
// Query-head tiles.  A block holds each of its query heads' fp32 query
// slice and accumulator in registers, GMAX x EPL of each a lane: at hd 256
// a lane holds 8 elements of a row, so a group of 16 would need 256
// registers before the scores (the limit is 255).  A KV head's G query
// heads are therefore split into T = ceil(G / 8) tiles of ceil(G / T)
// heads each (recurrentgemma-2b's G 10: two tiles of 5 on the GMAX 8
// instantiation; G 16: two of 8), each tile its own blocks, walking the
// same ring: the ring is read once a tile (at 8 slots x 2048 rows x hd 256
// in bf16, 16.8 MB a tile, which the 50 MB L2 can hold across them).
//
// Bound: device-memory bytes.  Each query token reads the K/V rows of its
// slot that can be valid once and does 4 flops per cache element, far below
// the ~20 flops per byte where the card's fp32 units would limit.  Until the
// ring wraps (0 <= pos < C) a row s > pos holds absolute position s - C < 0,
// always masked, so the walk covers n_rows = min(C, pos + 1) rows (C for a
// negative position, whose rows are all masked and all walked, as the
// reference's softmax averages them).  A memory-bound call is fast when
// enough bytes are in flight: 3.35 TB/s times ~0.7 us of latency is ~2.3 MB
// across the card, ~18 KB per SM.  Design:
//   * the ring walk of one (slot, kv-head, head tile) is split across S
//     blocks, each
//     taking rows [ceil(i n / S), ceil((i + 1) n / S)) of the slot's n_rows
//     walkable rows, computed on the device from positions[n].  One block
//     serves all the query heads of its tile, so each K/V byte is read from
//     device memory once a tile.  The S blocks form one thread-block
//     cluster;
//   * S is chosen on the host from static shapes only (N, Hkv, T, C;
//     kernels/decode_attention.py:split_count): the smallest power of two
//     up to 8 (the portable cluster size) with N * Hkv * T * S at least one
//     block per SM, and no split under 16 ring rows.  At 8 slots x 12
//     heads that is S = 2 (192 blocks).  Measured on the H100
//     (tests/_decode_compare.py): at C = 512 and 1024 S = 2, 4 and 8 take
//     within ~1 us of each other, while on a served burst's short walks
//     (~70 rows) every split above 1 adds merge and cluster work that the
//     walk cannot amortise, S = 2 the least.  Where N * Hkv alone fills the
//     card (64 slots x 12 heads = 768 blocks) S is 1, and the block writes
//     its output with no cluster work at all;
//   * each thread streams the cache words it reads itself through a
//     two-stage shared-memory ring with cp.async (16 bytes a copy where the
//     lane layout allows; the int8 scales 4), a stage holding kStageRows
//     rows: a split of up to two stages is in flight at once (one load
//     round at the serving shapes), a longer one issues stage s + 2 once
//     stage s is used.  The copies land where only their own thread reads
//     them, so the walk has no barrier, and the ring costs no registers
//     (6 blocks of 128 threads an SM at GPT-2's width);
//   * inside the block, "workers" of LPK lanes take one cache row each,
//     each lane its words of the row, and keep a running (m, l, acc) per
//     query head; workers merge with the online softmax's rescale
//     exp(m_w - M), first by shuffles in a warp, then across warps in
//     shared memory, into the block's partial (m, l, acc[G][HD]);
//   * the S partials merge in the same launch through distributed shared
//     memory: each block pushes 1/S of its partial's outputs, and its m and
//     l, into a slot of the block that owns those outputs
//     (map_shared_rank; remote stores cost no round trip), the cluster
//     synchronises once, and each block merges its 1/S of the outputs from
//     its own shared memory with the same rescale.  A barrier arrive at the
//     start, waited on before the first remote store, makes sure every
//     block of the cluster runs before another writes its shared memory.
//     No workspace, no second kernel;
//   * int8 entries become fp32 on the integer and fp32 pipes and round to
//     bf16 two at a time: one conversion instruction per byte made the
//     conversion units the limit of the int8 walk.
// The -1e30 / -inf semantics: a masked row inside the walk scores -1e30, a
// row past the walk -inf (p = 0).  A split whose rows are all masked holds
// m = -1e30 and weighs exp(-1e30 - M) = 0 against a real score, and 1
// (the uniform average) when every row of the slot is masked.  A split with
// no rows publishes m = -inf, l = 0, acc = 0 and weighs exactly 0 (the
// merge never evaluates exp(-inf - (-inf))).  Exponentials take __expf
// (ex2.approx of x log2 e); fp32 outputs stay within 1e-5 of the plain
// version's.
// Launch checks stay with the caller: the C entry point launches through
// cudaLaunchKernelEx with the cluster dimension on the caller's stream,
// returns its cudaError_t (then cudaGetLastError()) and never synchronises.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStageBytes = 8192;   // one K (or V) plane of one ring stage
constexpr int kMaxStages = 2;       // ring depth
constexpr int kStageRows = 64;      // at most, per ring stage
constexpr int kBatch = 4;           // rows per online-softmax update
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr float kNegInf = -1e30f;   // the reference's masked-score sentinel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One read of B bytes (4, 8 or 16) as a plain word type.
template <int B> struct Word;
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// E contiguous elements of T at p (aligned to their size) into fp32, in
// loads of up to 16 bytes.
template <typename T, int E>
__device__ __forceinline__ void load_float(const T* p, float* out) {
  constexpr int kBytes = E * sizeof(T);
  constexpr int kWord = kBytes < 16 ? kBytes : 16;
  using WT = typename Word<kWord>::T;
  WT w[kBytes / kWord];
#pragma unroll
  for (int i = 0; i < kBytes / kWord; ++i)
    w[i] = reinterpret_cast<const WT*>(p)[i];
  const T* e = reinterpret_cast<const T*>(w);
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = to_float(e[i]);
}

// E int8 entries (E % 4 == 0, as 32-bit words) dequantized: fp32(q8) * scale,
// rounded once into QT.  fp32(q8) is built on the integer and fp32 pipes
// (2^23 + (q8 + 128) as float bits, less 2^23 + 128: exact), not with one
// conversion instruction per byte, and bf16 rounds two values at a time:
// the conversion units are the int8 walk's limit otherwise.
template <typename QT, int E>
__device__ __forceinline__ void dequant(const uint32_t* w, float scale,
                                        float* out) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] =
          (__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + j)) -
           8388736.f) * scale;
  }
  if constexpr (sizeof(QT) == 2) {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(out[e], out[e + 1]);
      out[e] = __low2float(h);
      out[e + 1] = __high2float(h);
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes (4, 8 or 16) from global to shared; with ok false the N bytes
// are zeros (source size 0: nothing is read).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N), "r"(ok ? N : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies but the newest `pending` groups have landed.
__device__ __forceinline__ void cp_async_wait(int pending) {
  static_assert(kMaxStages <= 4, "one wait_group immediate per ring depth");
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Lane layout of one cache row of HD elements of KV: LPK lanes per row,
// EPL elements per lane in NLD words of LB bytes (EPW elements), word i of
// lane li at element (i * LPK + li) * EPW, so that each word's copy reads
// the row contiguously across the lanes; and the ring stage: ROWS rows per
// stage (at most kStageRows, and at most kStageBytes of K), U per worker,
// B per online-softmax update.  Small head groups take 16 bytes a lane
// (an int8 row of a lone head: 16 elements, which halves the lanes that
// repeat each row's softmax work), large groups spread the row over the
// warp so that the per-lane (GMAX x EPL) accumulators fit in registers (at
// least 4 bytes a lane, the smallest cp.async).
template <typename KV, int HD, int GMAX> struct Layout {
  static constexpr int kVec = 16 / sizeof(KV);        // elements per 16 B
  static constexpr int kEpl =
      GMAX == 1 && sizeof(KV) == 1 ? 16 : (kVec < 8 ? kVec : 8);
  static constexpr int kWide = HD * (int)sizeof(KV) / 4 < 32
                                   ? HD * (int)sizeof(KV) / 4 : 32;
  static constexpr int LPK =
      GMAX <= 2 ? (HD / kEpl < 32 ? HD / kEpl : 32) : kWide;
  static constexpr int EPL = HD / LPK;
  static constexpr int LANE_BYTES = EPL * sizeof(KV);
  static constexpr int LB = LANE_BYTES < 16 ? LANE_BYTES : 16;
  static constexpr int NLD = LANE_BYTES / LB;
  static constexpr int EPW = LB / sizeof(KV);
  static constexpr int KPW = 32 / LPK;                // rows per warp step
  static constexpr int NWORK = kWarps * KPW;          // workers per block
  static constexpr int ROW_BYTES = HD * sizeof(KV);
  static constexpr int kFit = kStageBytes / ROW_BYTES < kStageRows
                                 ? kStageBytes / ROW_BYTES : kStageRows;
  static constexpr int ROWS = kFit > NWORK ? kFit : NWORK;
  static constexpr int U = ROWS / NWORK;              // rows per worker
  static constexpr int B = U < kBatch ? U : kBatch;
  // a stage holds each thread's own words, [U][K, V][NLD] words of LB
  // bytes, lanes side by side (no bank conflicts), then int8's scales
  static constexpr int WORDS = U * 2 * NLD;
  static constexpr int SCALES = WORDS * kThreads * LB;
  static constexpr int STAGE =
      SCALES + (sizeof(KV) == 1 ? U * 2 * kThreads * 4 : 0);
  // GPT-2's width keeps 6 blocks an SM
  static constexpr int MIN_BLOCKS = HD == 64 && GMAX == 1 ? 6 : 1;
  static_assert(ROWS % NWORK == 0 && U % B == 0, "stage rows per worker");
  static_assert(LB >= 4 && STAGE % 16 == 0, "cp.async sizes and alignment");
  static_assert(sizeof(KV) != 1 || EPL % 4 == 0,
                "int8 lanes dequantize whole words");
  using W = typename Word<LB>::T;
};

// Shared memory: the cluster merge's slots, [splits][chunk + 2G] floats
// (this block's chunk of every split's acc, then every split's m and l),
// then the ring (after the walk, the warps' partials).
__host__ __device__ inline int merge_chunk(int G, int HD, int splits) {
  return (G * HD + splits - 1) / splits;
}
__host__ __device__ inline int ring_offset(int G, int HD, int splits) {
  return (splits * (merge_chunk(G, HD, splits) + 2 * G) * 4 + 15) / 16 * 16;
}

template <typename QT, typename KV, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads, (Layout<KV, HD, GMAX>::MIN_BLOCKS))
decode_attention_kernel(const QT* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ positions,
                        QT* __restrict__ out, int H, int Hkv, int C,
                        int splits, int tiles, int depth, float scale,
                        int window, float softcap) {
  using L = Layout<KV, HD, GMAX>;
  using W = typename L::W;
  constexpr bool kQuant = sizeof(KV) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster has started before any writes another's
  // shared memory: arrive now, wait before the first remote write
  if (splits > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int split = static_cast<int>(cluster.block_rank());
  const int unit = blockIdx.x / splits;      // (n * Hkv + hk) * tiles + tile
  const int head = unit / tiles;                      // n * Hkv + hk
  const int n = head / Hkv;
  const int hk = head % Hkv;
  // this tile's query heads: G of the tile from q row n * H + q0
  const int per_tile = (H / Hkv + tiles - 1) / tiles;
  const int g_lo = (unit % tiles) * per_tile;
  const int G = min(per_tile, H / Hkv - g_lo);
  const size_t q0 = (size_t)n * H + (size_t)hk * (H / Hkv) + g_lo;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / L::LPK;                      // row slot in the warp
  const int li = lane % L::LPK;                       // lane within the row
  const int worker = warp * L::KPW + sub;

  const int pos = positions[n];
  const int n_rows = pos >= 0 && pos < C ? pos + 1 : C;
  const int lo = (split * n_rows + splits - 1) / splits;
  const int hi = ((split + 1) * n_rows + splits - 1) / splits;
  // ring index t holds absolute position pos - ((pos - t) mod C) =
  // base + t, less C past p0 = pos mod C (floor-mod, as jnp.mod)
  int p0 = pos % C;
  if (p0 < 0) p0 += C;
  const int base = pos - p0;

  // this lane's elements of every query head of the group, in fp32
  float qf[GMAX][L::EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < L::NLD; ++i) {
      if (g < G)
        load_float<QT, L::EPW>(q + (q0 + g) * HD +
                                   (i * L::LPK + li) * L::EPW,
                               qf[g] + i * L::EPW);
      else
#pragma unroll
        for (int e = 0; e < L::EPW; ++e) qf[g][i * L::EPW + e] = 0.f;
    }
  }
  float m[GMAX], l[GMAX], acc[GMAX][L::EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < L::EPL; ++e) acc[g][e] = 0.f;
  }

  const int chunk = merge_chunk(G, HD, splits);
  const int slot = chunk + 2 * G;                     // floats per split
  float* slots = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + ring_offset(G, HD, splits);
  const size_t row_stride = (size_t)Hkv * HD;         // elements per ring entry
  const KV* kbase = k + (size_t)n * C * row_stride + (size_t)hk * HD;
  const KV* vbase = v + (size_t)n * C * row_stride + (size_t)hk * HD;
  const float* ksbase = kQuant ? k_scale + (size_t)n * C : nullptr;
  const float* vsbase = kQuant ? v_scale + (size_t)n * C : nullptr;

  // stage s: rows lo + s * ROWS ..., row u * NWORK + worker of it for
  // u < U; each thread copies the words it reads itself, so the walk needs
  // no barrier (rows past the split's end land as zeros)
  W* const ring_w = reinterpret_cast<W*>(ring);
  auto word = [&](int s, int u, int plane, int i) -> W* {
    return ring_w + (size_t)(s % depth) * (L::STAGE / L::LB) +
           ((u * 2 + plane) * L::NLD + i) * kThreads + threadIdx.x;
  };
  auto scale_of = [&](int s, int u, int plane) -> float* {
    return reinterpret_cast<float*>(ring + (s % depth) * L::STAGE +
                                    L::SCALES) +
           (u * 2 + plane) * kThreads + threadIdx.x;
  };
  auto issue = [&](int s) {
    const int t0 = lo + s * L::ROWS;
#pragma unroll
    for (int u = 0; u < L::U; ++u) {
      const int t = t0 + u * L::NWORK + worker;
      const bool ok = t < hi;
      const size_t src = (size_t)(ok ? t : lo) * row_stride;
#pragma unroll
      for (int i = 0; i < L::NLD; ++i) {
        const int off = (i * L::LPK + li) * L::EPW;
        cp_async<L::LB>(word(s, u, 0, i), kbase + src + off, ok);
        cp_async<L::LB>(word(s, u, 1, i), vbase + src + off, ok);
      }
      if constexpr (kQuant) {
        cp_async<4>(scale_of(s, u, 0), ksbase + (ok ? t : lo), ok);
        cp_async<4>(scale_of(s, u, 1), vsbase + (ok ? t : lo), ok);
      }
    }
  };

  // row u of stage s, this lane's slice of plane 0 (K) or 1 (V), in fp32
  // (int8: scaled and rounded through QT)
  auto row_slice = [&](int s, int u, int plane, float* out) {
    W w[L::NLD];
#pragma unroll
    for (int i = 0; i < L::NLD; ++i) w[i] = *word(s, u, plane, i);
    if constexpr (kQuant) {
      dequant<QT, L::EPL>(reinterpret_cast<const uint32_t*>(w),
                          *scale_of(s, u, plane), out);
    } else {
      const KV* e = reinterpret_cast<const KV*>(w);
#pragma unroll
      for (int i = 0; i < L::EPL; ++i) out[i] = to_float(e[i]);
    }
  };

  const int n_stages = (hi - lo + L::ROWS - 1) / L::ROWS;   // 0: no rows
  for (int s = 0; s < depth; ++s) {
    if (s < n_stages) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait(depth - 1);                         // this thread's words
    const int t0 = lo + s * L::ROWS;
    for (int u0 = 0; u0 < L::U; u0 += L::B) {
      float sc[L::B][GMAX];
#pragma unroll
      for (int u = 0; u < L::B; ++u) {
        const int t = t0 + (u0 + u) * L::NWORK + worker;
        float kf[L::EPL];
        row_slice(s, u0 + u, 0, kf);
        const int abs_pos = base + t - (t > p0 ? C : 0);
        const bool valid = abs_pos >= 0 && abs_pos > pos - window;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          float d = 0.f;
          if (g < G) {
#pragma unroll
            for (int e = 0; e < L::EPL; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
            for (int off = L::LPK / 2; off > 0; off >>= 1)
              d += __shfl_xor_sync(0xffffffffu, d, off);
          }
          float x = d * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          // a row past the split's end is no entry at all: -inf, so p = 0
          sc[u][g] = t < hi ? (valid ? x : kNegInf) : -INFINITY;
        }
      }

      // rescale each head's running sums, then add the batch's rows, each
      // V row read (and dequantized) once for all G heads
      float p[GMAX][L::B];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) continue;
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < L::B; ++u) m_new = fmaxf(m_new, sc[u][g]);
        const float alpha = __expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < L::B; ++u) {
          p[g][u] = __expf(sc[u][g] - m_new);
          psum += p[g][u];
        }
        l[g] = l[g] * alpha + psum;
#pragma unroll
        for (int e = 0; e < L::EPL; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
      }
#pragma unroll
      for (int u = 0; u < L::B; ++u) {
        float vf[L::EPL];
        row_slice(s, u0 + u, 1, vf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= G) continue;
#pragma unroll
          for (int e = 0; e < L::EPL; ++e)
            acc[g][e] = fmaf(p[g][u], vf[e], acc[g][e]);
        }
      }
    }
    if (s + depth < n_stages) issue(s + depth);     // into slot s % depth
    cp_async_commit();
  }
  cp_async_wait(0);
  __syncthreads();                                    // the ring is free

  // merge the workers of one warp (lanes li of every row slot pair up)
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) continue;
#pragma unroll
    for (int off = L::LPK; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], m_o);
      const float a = __expf(m[g] - M);
      const float b = __expf(m_o - M);
      l[g] = l[g] * a + l_o * b;
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + acc_o * b;
      }
      m[g] = M;
    }
  }

  // then the warps, through the ring's shared memory: [warp][g] m, l and
  // acc[HD]
  float* sm_m = reinterpret_cast<float*>(ring);
  float* sm_l = sm_m + kWarps * G;
  float* sm_acc = sm_m + 2 * kWarps * G;
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) continue;
      if (li == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < L::EPL; ++e)
        sm_acc[(warp * G + g) * HD + (e / L::EPW * L::LPK + li) * L::EPW +
               e % L::EPW] = acc[g][e];
    }
  }
  __syncthreads();

  // the block's partial over the warps: with one split it is the output;
  // else it is pushed through distributed shared memory, output element i
  // to the slot of this split in block i / chunk, which merges it, and m
  // and l of every head to every block
  if (splits > 1)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = __expf(sm_m[w * G + g] - M);
      lsum += sm_l[w * G + g] * c;
      a += sm_acc[w * G * HD + i] * c;
    }
    if (splits == 1) {
      out[q0 * HD + i] = static_cast<QT>(a / fmaxf(lsum, 1e-30f));
      continue;
    }
    cluster.map_shared_rank(slots, i / chunk)[split * slot + i % chunk] = a;
    if (i % HD == 0) {
      const float m_out = hi > lo ? M : -INFINITY;    // no rows: adds nothing
      for (int r = 0; r < splits; ++r) {
        float* dst = cluster.map_shared_rank(slots, r) + split * slot + chunk;
        dst[g] = m_out;
        dst[G + g] = lsum;
      }
    }
  }
  if (splits == 1) return;
  cluster.sync();

  // this block's chunk of the outputs, from every split's slot
  const int end = min((split + 1) * chunk, G * HD);
  for (int i = split * chunk + threadIdx.x; i < end; i += kThreads) {
    const int g = i / HD;
    const int j = i - split * chunk;
    float M = -INFINITY;
    for (int r = 0; r < splits; ++r) M = fmaxf(M, slots[r * slot + chunk + g]);
    float lsum = 0.f, a = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float m_r = slots[r * slot + chunk + g];
      const float c = m_r == -INFINITY ? 0.f : __expf(m_r - M);
      lsum += slots[r * slot + chunk + G + g] * c;
      a += slots[r * slot + j] * c;
    }
    out[q0 * HD + i] = static_cast<QT>(a / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int* pos;
  void* out;
  int N, H, Hkv, C, splits, tiles;
  float scale;
  int window;
  float softcap;
  cudaStream_t stream;
  int* max_clusters;   // non-null: report the occupancy, launch nothing
};

template <typename QT, typename KV, int HD, int GMAX>
cudaError_t run(const Args& a) {
  using L = Layout<KV, HD, GMAX>;
  auto kern = decode_attention_kernel<QT, KV, HD, GMAX>;
  const int G = (a.H / a.Hkv + a.tiles - 1) / a.tiles;    // heads a tile
  // ring depth: every stage of the longest split where four hold it
  const int rows_max = (a.C + a.splits - 1) / a.splits;
  const int stages = (rows_max + L::ROWS - 1) / L::ROWS;
  const int depth = stages < kMaxStages ? stages : kMaxStages;
  const int merge = kWarps * G * (HD + 2) * 4;
  const int ring = depth * L::STAGE;
  const size_t smem =
      ring_offset(G, HD, a.splits) + (ring > merge ? ring : merge);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits * a.N * a.Hkv * a.tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (a.max_clusters)
    return cudaOccupancyMaxActiveClusters(a.max_clusters, kern, &cfg);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const QT*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.ks, a.vs, a.pos, static_cast<QT*>(a.out),
      a.H, a.Hkv, a.C, a.splits, a.tiles, depth, a.scale, a.window,
      a.softcap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// G: the query heads of one tile.
template <typename QT, typename KV, int HD>
cudaError_t by_group(int G, const Args& a) {
  if (G == 1) return run<QT, KV, HD, 1>(a);
  if (G == 2) return run<QT, KV, HD, 2>(a);
  if (G <= 4) return run<QT, KV, HD, 4>(a);
  if (G <= 8) return run<QT, KV, HD, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename QT, typename KV>
cudaError_t by_head_dim(int hd, int G, const Args& a) {
  if (hd == 64) return by_group<QT, KV, 64>(G, a);
  if (hd == 128) return by_group<QT, KV, 128>(G, a);
  if (hd == 256) return by_group<QT, KV, 256>(G, a);
  return cudaErrorInvalidValue;
}

int dispatch(int hd, int q_bf16, int kv_int8, const Args& a) {
  if (a.N <= 0 || a.C <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 ||
      a.splits < 1 || a.splits > kMaxSplits || a.tiles < 1)
    return cudaErrorInvalidValue;
  // every tile holds at least one head
  const int G = (a.H / a.Hkv + a.tiles - 1) / a.tiles;
  if ((a.tiles - 1) * G >= a.H / a.Hkv) return cudaErrorInvalidValue;
  if (q_bf16) {
    if (kv_int8) return by_head_dim<__nv_bfloat16, int8_t>(hd, G, a);
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(hd, G, a);
  }
  if (kv_int8) return by_head_dim<float, int8_t>(hd, G, a);
  return by_head_dim<float, float>(hd, G, a);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Tensors are contiguous:
// q/out (N, H, hd); k/v (N, C, Hkv, hd); k_scale/v_scale (N, C) fp32 or
// null; positions (N,) int32.  q_bf16: 1 for bf16 q/out, 0 for fp32.
// kv_int8: 1 for an int8 cache with scales, 0 for a cache in q's dtype.
// splits: blocks per (slot, kv-head, tile), the cluster size, 1 to 8.
// tiles: tiles of each kv-head's H / Hkv query heads, ceil(H / Hkv / tiles)
// heads a tile (at most 8), every tile non-empty.  window:
// 1 << 30 for global attention; softcap <= 0: none.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* positions, void* out, int N, int H,
    int Hkv, int C, int hd, int q_bf16, int kv_int8, int splits, int tiles,
    float scale, int window, float softcap, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(positions), out, N, H, Hkv, C, splits,
               tiles, scale, window, softcap,
               static_cast<cudaStream_t>(stream), nullptr};
  return dispatch(hd, q_bf16, kv_int8, a);
}

// cudaOccupancyMaxActiveClusters of the launch decode_attention_launch
// would make at these shapes, into *max_clusters; returns its cudaError_t.
extern "C" int decode_attention_max_active_clusters(
    int N, int H, int Hkv, int C, int hd, int q_bf16, int kv_int8,
    int splits, int tiles, int* max_clusters) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, N, H, Hkv, C, splits, tiles, 1.f, 1 << 30, 0.f,
               nullptr, max_clusters};
  return dispatch(hd, q_bf16, kv_int8, a);
}
