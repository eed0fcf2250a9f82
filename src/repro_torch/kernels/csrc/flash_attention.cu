// Training-path flash attention for Hopper (sm_90a): the forward and the
// two backward kernels, dQ and dK/dV.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   forward_kernel (fp32),   _forward (pallas_call :198, body _fwd_kernel
//   forward_wgmma_kernel     :111)
//   (bf16)
//   dq_kernel (fp32),        _backward's dQ (pallas_call :333, body
//   dq_wgmma_kernel (bf16)   _dq_kernel :239)
//   dkv_kernel (fp32),       _backward's dK/dV (pallas_call :374, body
//   dkv_wgmma_kernel (bf16)  _dkv_kernel :268), summed over the GQA group
//
// The function, as the reference computes it, for q (B, H, Sq, hd) and k,
// v (B, Hkv, Sk, hd), query head h reading KV head h / (H / Hkv):
//   s = (q . k) * scale in fp32; z = c * tanh(s / c) with a softcap c;
//   query row r (position q_offset + r) attends key c when c <= q_offset
//   + r (causal) and c > q_offset + r - window (window 1 << 30: none);
//   masked scores sit at -1e30 and a where guard gives them p = 0, so a
//   fully-masked tile adds nothing; l = max(l, 1e-30), so a row with no
//   key gets o = 0 and lse = -1e30 + log(1e-30).
//   forward:  the online softmax over key tiles (running max m, sum l and
//             an fp32 accumulator), o = acc / l rounded once into q's
//             dtype, lse = m + log(l) in fp32;
//   dQ:       p = exp(z - lse), ds = p * (do . v - delta) * (1 - t^2 with
//             a softcap), dq += (ds . k) * scale per key tile, rounded once;
//   dK/dV:    dv += p^T . do and dk += (ds^T . q) * scale over the q tiles
//             of every query head of the group, rounded once.
//   delta = rowsum(do * o) comes in from the caller (a plain op on the
//   rounded o, as in the reference).
//
// Bound: operations.  At GPT-2 small's training shape (B = 8, H = 12,
// S = 1024, hd = 64, causal) one product over the attended pairs is 6.4
// GFLOP against ~13 MB per (B, H, S, hd) plane: ~500 flops per byte, above
// the ~295 where the bf16 tensor cores stop being the limit.
//
// Two routes, by dtype.
//
// fp32 (the card-vs-CPU checks, held to 1e-5 of the largest element,
// which one bf16 product cannot meet): every product on the fp32 FMA
// units (forward_kernel, dq_kernel, dkv_kernel):
//   * the TPU's sequential key-tile grid axis becomes a loop inside a
//     block: a forward or dQ block owns 64 query rows of one head and
//     walks the key tiles of the band the mask allows (the reference's
//     _kv_band), a dK/dV block owns 64 keys of one KV head and walks the q
//     tiles of _q_band for each query head of its group, so the group sum
//     stays in registers: no atomics, deterministic;
//   * tiles are staged in shared memory in fp32 (rows padded to hd + 1
//     floats, so that the 16 threads reading 16 rows at one depth hit 16
//     banks); each of the 256 threads computes a 4x4 block of a (64, 64)
//     score tile (rows ty + 16 i, columns tx + 16 j) and owns 4 rows x
//     hd / 16 columns of each accumulator;
//   * at hd 256 four (64, 257) fp32 planes would take 263 KB, over the
//     227 KB of a block: dQ blocks own 32 query rows (a 2x4 block of a
//     (32, 64) tile a thread) and dK/dV blocks 32 keys (4x2 of (64, 32));
//   * the forward's row max and row sum reduce over the 16 threads of a
//     row by shuffles (the 16 lanes of a half warp);
//   * sequence lengths need not divide the tile: rows and keys past the
//     end load as zeros and are masked.
//
// bf16 (the training path): every kernel on the bf16 tensor cores
// (forward_wgmma_kernel, dq_wgmma_kernel, dkv_wgmma_kernel).  The FMA
// design reaches ~2% of the bf16 peak: fp32 tiles copied by plain loads, a
// barrier on each side of every tile, P and dS round-tripped through
// shared memory.  The tensor-core kernels instead:
//   * run every product as wgmma (one warpgroup, 64 rows, a block; fp32
//     accumulate): forward S = Q K^T (m64n64) and O += P V (m64nHD), dQ
//     S = Q K^T and dP = dO V^T (m64n64) and dQ += dS K (m64nHD), dK/dV
//     S^T = K Q^T and dP^T = V dO^T (m64nBQ), dV += P^T dO and dK += dS^T
//     Q (m64nHD).  Operands come from shared memory in the swizzled
//     layouts described below (V, K, dO and Q of the second products read
//     transposed), P and dS from registers: an accumulator of one product
//     is the A operand of the next once rounded to bf16, so nothing goes
//     back to shared memory;
//   * stage bf16 tiles through cp.async rings, two tiles ahead (forward and
//     dQ: 4 stages of K and V; dK/dV: 3 of Q, dO, lse and delta), one
//     barrier a tile; rows past the end arrive as zeros (source size 0);
//   * pipeline the forward and dQ one tile apart: with P (dS) of tile j - 1
//     in registers, the score products of tile j and O += P V (dQ += dS K)
//     of tile j - 1 are issued together, and the softmax (dS) of tile j
//     runs while the second is in flight;
//   * keep the online softmax (m, l, alpha), and dQ's lse and delta, in
//     registers and take exp as one ex2.approx of an FMA (z log2(e) - m
//     log2(e));
//   * test the mask only in tiles where some pair of a warp's 16 rows does
//     not attend, and the softcap only when there is one: both are
//     template flags chosen per tile, since a test in the common tile (if
//     converted per element) costs more than the products (forward 0.131
//     against 0.080 ms, dK/dV 0.188 against 0.130 ms at GPT-2 small's
//     shape on an H100 SXM, tests/_flash_variants.py);
//   * under causal masking start the longest q tiles first (blockIdx.z
//     reversed); dQ keeps its sum in fp32 registers across the key tiles;
//     dK/dV blocks own 64 keys of one KV head and keep dK and dV in fp32
//     registers across the q tiles (64 rows; 32 at hd 128 and 256) of
//     every head of the group;
//   * at hd 256 (gemma2): the forward's and dQ's m64n256 accumulators take
//     128 registers a thread, so their K and V tiles hold 32 keys (the
//     score products m64n32, the four-stage ring 128 KB); dK and dV
//     together would take 256, past the 255 a thread may have, so each key
//     tile gets two blocks that each sum half of the head dims (m64n128)
//     and both recompute S^T and dP^T (1.5 times the operations of one
//     block).
//   TMA and a producer warp would replace the cp.async rings; they are not
//   used yet.
// Accuracy contract of the bf16 route: P (forward, and dV's product) and
// dS (dQ's and dK's products) are rounded to bf16 once; every other sum is
// fp32.  With A an output element's absolute sum in fp32 (o: sum_j p_ij
// |v_jd|; dq: scale sum_j |ds_ij| |k_jd|; dv: sum_i p_ij |do_id|; dk:
// scale sum_i |ds_ij| |q_id|), rounding P or dS moves the fp32 element by
// less than 2^-8 A (bf16 keeps 8 significant bits); the kernel's and the
// plain version's roundings of the element into bf16 then land at most
// one bf16 ulp apart where |x| ~ A, and add at most one ulp (<= 2^-8 A)
// where terms cancel: every element lies within 2^-7 A of the plain
// version.  dq's A also counts dS's own fp32 rounding, 2^-8 p_ij sum_e
// |do_ie| |v_je| beside |ds_ij|: dP = dO V^T is summed here in another
// order than in the plain version, and where dP - delta cancels (the
// first key of a causal row) the two dS differ by all of themselves
// (kernels/flash_attention.py).  chip_smoke.py holds every bf16 case to
// it and logs the share beyond 2^-9 A.
// The C entry points return cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a head dim without an instance) and never
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_attn {
namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;     // 16 x 16: tx the column, ty the row
constexpr float kNegInf = -1e30f; // the reference's masked-score sentinel
constexpr float kMinL = 1e-30f;   // floor of the softmax denominator

struct Args {
  const void* q;        // (B, H, Sq, hd) of T
  const void* k;        // (B, Hkv, Sk, hd) of T
  const void* v;        // (B, Hkv, Sk, hd) of T
  const void* dout;     // (B, H, Sq, hd) of T (backward)
  const float* lse_in;  // (B, H, Sq) (backward)
  const float* delta;   // (B, H, Sq) (backward)
  void* o;              // forward: o, and lse below
  float* lse;
  void* dq;             // dQ
  void* dk;             // dK/dV
  void* dv;
  int B, H, Hkv, Sq, Sk;
  int causal;
  long long window, q_offset;
  float scale, softcap;  // softcap 0: none
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

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__host__ __device__ __forceinline__ int n_tiles(int n, int tile) {
  return (n + tile - 1) / tile;
}

// The key-tile band of query rows [r0, r1] and the q-tile band of keys
// [c0, c1], tiles of `tile` rows (inclusive; the reference's _kv_band and
// _q_band).
__device__ __forceinline__ void key_band(const Args& a, long long r0,
                                         long long r1, int tile, int* lo,
                                         int* hi) {
  long long h = (a.Sk + tile - 1) / tile - 1;
  if (a.causal) {
    const long long c = floor_div(r1 + a.q_offset, tile);
    h = c < h ? c : h;
  }
  const long long l = floor_div(r0 + a.q_offset - a.window + 1, tile);
  *lo = l > 0 ? (int)l : 0;
  *hi = (int)h;
}

__device__ __forceinline__ void query_band(const Args& a, long long c0,
                                           long long c1, int tile, int* lo,
                                           int* hi) {
  long long l = 0;
  if (a.causal) l = floor_div(c0 - a.q_offset, tile);
  const long long h = floor_div(c1 - 1 + a.window - a.q_offset, tile);
  const long long top = (a.Sq + tile - 1) / tile - 1;
  *lo = l > 0 ? (int)l : 0;
  *hi = (int)(h < top ? h : top);
}

// Query row r attends key c.
__device__ __forceinline__ bool attends(const Args& a, int r, int c) {
  if (r >= a.Sq || c >= a.Sk) return false;
  const long long qpos = a.q_offset + r;
  if (a.causal && c > qpos) return false;
  return c > qpos - a.window;
}

// Rows [row0, row0 + ROWS) of a (rows, HD) plane into shared memory as
// fp32 with row stride HD + 1; rows past the end read as zeros.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int g = row0 + r;
    dst[r * (HD + 1) + d] = g < rows ? to_float(src[(size_t)g * HD + d]) : 0.f;
  }
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over HD, the tiles (16 RI, HD + 1)
// and (16 RJ, HD + 1).
template <int HD, int RI, int RJ>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int tx, int ty, float (&s)[RI][RJ]) {
  constexpr int LS = HD + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[RI], bv[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = A[(ty + 16 * i) * LS + d];
#pragma unroll
    for (int j = 0; j < RJ; ++j) bv[j] = Bm[(tx + 16 * j) * LS + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// Reductions over the 16 lanes of a half warp (the 16 threads of a row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// Scaled, softcapped score and the softcap derivative 1 - t^2.
__device__ __forceinline__ float score(const Args& a, float dot,
                                       float* dcap) {
  const float s = dot * a.scale;
  if (a.softcap == 0.f) {
    *dcap = 1.f;
    return s;
  }
  const float t = tanhf(s / a.softcap);
  *dcap = 1.f - t * t;
  return a.softcap * t;
}

// ---------------------------------------------------------------------------
// The FMA kernels' tiles: RQ query rows and RK keys a thread in a score
// tile of BQ = 16 RQ query rows and BK = 16 RK keys (thread (tx, ty) owns
// rows ty + 16 i and keys tx + 16 j).  64 x 64 up to hd 128; at hd 256 the
// four fp32 planes of (64, 257) would take 263 KB of shared memory, over
// the 227 KB a block may have, so dQ takes query tiles of 32 rows and
// dK/dV blocks own 32 keys (the forward's three planes fit at 64).

// forward: grid (q tiles, H, B)

template <typename T, int HD, int RQ, int RK>
__global__ void __launch_bounds__(kThreads) forward_kernel(const Args a) {
  constexpr int LS = HD + 1, ND = HD / 16, BQ = 16 * RQ, BK = 16 * RK;
  constexpr int PS = BK + 1;  // padded row stride of a (BQ, BK) tile
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BQ * LS;
  float* sv = sk + BK * LS;
  float* sp = sv + BK * LS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * BQ;
  const size_t qrow = ((size_t)b * a.H + h) * a.Sq;
  const size_t krow = ((size_t)b * a.Hkv + hk) * a.Sk;
  const T* k = static_cast<const T*>(a.k) + krow * HD;
  const T* v = static_cast<const T*>(a.v) + krow * HD;
  load_tile<T, HD, BQ>(sq, static_cast<const T*>(a.q) + qrow * HD, q0, a.Sq);

  float m[RQ], l[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[i][d] = 0.f;
  }
  int lo, hi;
  key_band(a, (long long)q0, (long long)min(a.Sq, q0 + BQ) - 1, BK, &lo,
           &hi);
  for (int j = lo; j <= hi; ++j) {
    __syncthreads();  // the previous tile's sk, sv and sp are read
    load_tile<T, HD, BK>(sk, k, j * BK, a.Sk);
    load_tile<T, HD, BK>(sv, v, j * BK, a.Sk);
    __syncthreads();
    float s[RQ][RK];
    tile_dot<HD>(sq, sk, tx, ty, s);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = q0 + ty + 16 * i;
      bool ok[RK];
      float rmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        float dcap;
        const float z = score(a, s[i][jj], &dcap);
        ok[jj] = attends(a, r, j * BK + tx + 16 * jj);
        s[i][jj] = ok[jj] ? z : kNegInf;
        rmax = fmaxf(rmax, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        sp[(ty + 16 * i) * PS + tx + 16 * jj] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < ND; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) vv[d] = sv[c * LS + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = sp[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int d = 0; d < ND; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
      }
    }
  }
  T* o = static_cast<T*>(a.o) + qrow * HD;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.Sq) continue;
    const float lf = fmaxf(l[i], kMinL);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      o[(size_t)r * HD + tx + 16 * d] = from_float<T>(acc[i][d] / lf);
    if (tx == 0) a.lse[qrow + r] = m[i] + logf(lf);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (q tiles, H, B)

template <typename T, int HD, int RQ, int RK>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  constexpr int LS = HD + 1, ND = HD / 16, BQ = 16 * RQ, BK = 16 * RK;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + BQ * LS;
  float* sk = sdo + BQ * LS;
  float* sv = sk + BK * LS;
  float* sds = sv + BK * LS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * BQ;
  const size_t qrow = ((size_t)b * a.H + h) * a.Sq;
  const size_t krow = ((size_t)b * a.Hkv + hk) * a.Sk;
  const T* k = static_cast<const T*>(a.k) + krow * HD;
  const T* v = static_cast<const T*>(a.v) + krow * HD;
  load_tile<T, HD, BQ>(sq, static_cast<const T*>(a.q) + qrow * HD, q0, a.Sq);
  load_tile<T, HD, BQ>(sdo, static_cast<const T*>(a.dout) + qrow * HD, q0,
                       a.Sq);
  float lse[RQ], delta[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    lse[i] = r < a.Sq ? a.lse_in[qrow + r] : 0.f;
    delta[i] = r < a.Sq ? a.delta[qrow + r] : 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[i][d] = 0.f;
  }
  int lo, hi;
  key_band(a, (long long)q0, (long long)min(a.Sq, q0 + BQ) - 1, BK, &lo,
           &hi);
  for (int j = lo; j <= hi; ++j) {
    __syncthreads();
    load_tile<T, HD, BK>(sk, k, j * BK, a.Sk);
    load_tile<T, HD, BK>(sv, v, j * BK, a.Sk);
    __syncthreads();
    float s[RQ][RK], dp[RQ][RK];
    tile_dot<HD>(sq, sk, tx, ty, s);
    tile_dot<HD>(sdo, sv, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        float dcap;
        const float z = score(a, s[i][jj], &dcap);
        const bool ok = attends(a, r, j * BK + tx + 16 * jj);
        const float p = ok ? expf(z - lse[i]) : 0.f;
        float ds = p * (dp[i][jj] - delta[i]);
        if (a.softcap != 0.f) ds *= dcap;
        sds[(ty + 16 * i) * PS + tx + 16 * jj] = ds;
      }
    }
    __syncthreads();
    float t[RQ][ND];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int d = 0; d < ND; ++d) t[i][d] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kv[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) kv[d] = sk[c * LS + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float ds = sds[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int d = 0; d < ND; ++d) t[i][d] = fmaf(ds, kv[d], t[i][d]);
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int d = 0; d < ND; ++d) acc[i][d] += t[i][d] * a.scale;
  }
  T* dq = static_cast<T*>(a.dq) + qrow * HD;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      dq[(size_t)r * HD + tx + 16 * d] = from_float<T>(acc[i][d]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid (key tiles, Hkv, B)

template <typename T, int HD, int RQ, int RK>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Args a) {
  constexpr int LS = HD + 1, ND = HD / 16, BQ = 16 * RQ, BK = 16 * RK;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + BK * LS;
  float* sq = sv + BK * LS;
  float* sdo = sq + BQ * LS;
  float* sp = sdo + BQ * LS;
  float* sds = sp + BQ * PS;
  float* slse = sds + BQ * PS;
  float* sdelta = slse + BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int k0 = kt * BK;
  const size_t krow = ((size_t)b * a.Hkv + hk) * a.Sk;
  load_tile<T, HD, BK>(sk, static_cast<const T*>(a.k) + krow * HD, k0, a.Sk);
  load_tile<T, HD, BK>(sv, static_cast<const T*>(a.v) + krow * HD, k0, a.Sk);
  // thread rows ty + 16 c are keys of the block; columns tx + 16 d
  float dk[RK][ND], dv[RK][ND];
#pragma unroll
  for (int c = 0; c < RK; ++c)
#pragma unroll
    for (int d = 0; d < ND; ++d) dk[c][d] = dv[c][d] = 0.f;
  int lo, hi;
  query_band(a, (long long)k0, (long long)min(a.Sk, k0 + BK) - 1, BQ, &lo,
             &hi);
  for (int g = 0; g < G; ++g) {
    const size_t qrow = ((size_t)b * a.H + hk * G + g) * a.Sq;
    const T* q = static_cast<const T*>(a.q) + qrow * HD;
    const T* dout = static_cast<const T*>(a.dout) + qrow * HD;
    for (int i = lo; i <= hi; ++i) {
      const int q0 = i * BQ;
      __syncthreads();
      load_tile<T, HD, BQ>(sq, q, q0, a.Sq);
      load_tile<T, HD, BQ>(sdo, dout, q0, a.Sq);
      if (threadIdx.x < BQ) {
        const int r = q0 + threadIdx.x;
        slse[threadIdx.x] = r < a.Sq ? a.lse_in[qrow + r] : 0.f;
        sdelta[threadIdx.x] = r < a.Sq ? a.delta[qrow + r] : 0.f;
      }
      __syncthreads();
      // score tile: rows ty + 16 ii are queries, columns tx + 16 jj keys
      float s[RQ][RK], dp[RQ][RK];
      tile_dot<HD>(sq, sk, tx, ty, s);
      tile_dot<HD>(sdo, sv, tx, ty, dp);
#pragma unroll
      for (int ii = 0; ii < RQ; ++ii) {
        const int rl = ty + 16 * ii;
#pragma unroll
        for (int jj = 0; jj < RK; ++jj) {
          float dcap;
          const float z = score(a, s[ii][jj], &dcap);
          const bool ok = attends(a, q0 + rl, k0 + tx + 16 * jj);
          const float p = ok ? expf(z - slse[rl]) : 0.f;
          float ds = p * (dp[ii][jj] - sdelta[rl]);
          if (a.softcap != 0.f) ds *= dcap;
          sp[rl * PS + tx + 16 * jj] = p;
          sds[rl * PS + tx + 16 * jj] = ds;
        }
      }
      __syncthreads();
      float t[RK][ND];
#pragma unroll
      for (int c = 0; c < RK; ++c)
#pragma unroll
        for (int d = 0; d < ND; ++d) t[c][d] = 0.f;
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float dov[ND], qv[ND];
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          dov[d] = sdo[r * LS + tx + 16 * d];
          qv[d] = sq[r * LS + tx + 16 * d];
        }
#pragma unroll
        for (int c = 0; c < RK; ++c) {
          const float p = sp[r * PS + ty + 16 * c];
          const float ds = sds[r * PS + ty + 16 * c];
#pragma unroll
          for (int d = 0; d < ND; ++d) {
            dv[c][d] = fmaf(p, dov[d], dv[c][d]);
            t[c][d] = fmaf(ds, qv[d], t[c][d]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < RK; ++c)
#pragma unroll
        for (int d = 0; d < ND; ++d) dk[c][d] += t[c][d] * a.scale;
    }
  }
  T* dkp = static_cast<T*>(a.dk) + krow * HD;
  T* dvp = static_cast<T*>(a.dv) + krow * HD;
#pragma unroll
  for (int c = 0; c < RK; ++c) {
    const int kr = k0 + ty + 16 * c;
    if (kr >= a.Sk) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      dkp[(size_t)kr * HD + tx + 16 * d] = from_float<T>(dk[c][d]);
      dvp[(size_t)kr * HD + tx + 16 * d] = from_float<T>(dv[c][d]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: the forward and dK/dV on the tensor cores
//
// wgmma (warpgroup products, bf16 operands, fp32 accumulate) on tiles that
// cp.async rings stage in shared memory in the swizzled layouts wgmma
// reads without bank conflicts: a (rows, HD) tile is cut into atoms of
// kSw-byte rows (128 bytes, 64 columns, at hd 64, 128 and 256; 64 bytes at
// hd 32), atom after atom, and within an atom the 16-byte piece c of row r
// sits at piece c ^ (r % 8) (128-byte swizzle; c ^ (r / 2 % 4) for 64
// bytes).  Read along its columns (K-major: Q and K in S = Q K^T, K and V
// with Q and dO in S^T = K Q^T and dP^T = V dO^T) a descriptor steps 32
// bytes per 16 columns within an atom and 8 kSw bytes per 8 rows (SBO);
// read along its rows (MN-major, transposed: V in O += P V, dO and Q in
// dV += P^T dO and dK += dS^T Q) it steps 16 kSw bytes per 16 rows, 8 kSw
// per 8 rows (SBO) and one atom (rows kSw bytes, LBO) per 64 columns.

constexpr int kKeys = 64;  // keys of a dK/dV block

// Keys of a forward or dQ K/V tile: 64, and 32 at hd 256, where the
// m64n256 accumulator (O, dQ) already takes 128 registers a thread and a
// four-stage ring of 64-key K and V tiles would take 256 KB.
template <int HD>
__host__ __device__ constexpr int key_tile() {
  return HD == 256 ? 32 : 64;
}
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; with ok false the 16 bytes are zeros
// (source size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes, zeros with ok false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// This thread's copies but the newest N groups have landed, and are
// visible to the tensor cores' (async proxy) reads once every thread has
// passed the next barrier.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x on the special-function unit, one instruction (relative error below
// 2^-22; subnormal results flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to bf16 once, x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Bytes of an atom row of the swizzled layout, and the swizzle of row r.
template <int HD>
__host__ __device__ constexpr int sw_bytes() {
  return HD == 32 ? 64 : 128;
}

template <int HD>
__device__ __forceinline__ int swz(int r) {
  return HD == 32 ? (r >> 1) & 3 : r & 7;
}

// Rows [row0, row0 + ROWS) of a (rows, HD) bf16 plane into a tile of the
// swizzled layout, by NT threads; rows past the end are zeros.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const bf16* src, int row0,
                                          int rows) {
  constexpr int kChunks = HD / 8;  // 16-byte pieces of a row
  constexpr int S = sw_bytes<HD>(), kPer = S / 16;
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * kChunks; e += NT) {
    const int r = e / kChunks, c = e % kChunks;
    const int g = row0 + r;
    const bool ok = g < rows;
    cp_async16(dst + (c / kPer) * ROWS * S + r * S +
                   ((c % kPer ^ swz<HD>(r)) << 4),
               src + (size_t)(ok ? g : 0) * HD + c * 8, ok);
  }
}

// The descriptor of a swizzled tile at p with leading byte offset lbo.
template <int HD>
__device__ __forceinline__ uint64_t desc(const unsigned char* p,
                                         uint32_t lbo) {
  constexpr int S = sw_bytes<HD>();
  constexpr uint64_t kType = S == 128 ? 1 : 2;  // 128- or 64-byte swizzle
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(8 * S >> 4) << 32) |
         (kType << 62);
}

// Depth step kk (16 columns) of a (ROWS, HD) tile read K-major, and (16
// rows) of one read MN-major.
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* t, int kk) {
  constexpr int S = sw_bytes<HD>();
  return desc<HD>(t + kk * 32 / S * ROWS * S + kk * 32 % S, 16);
}

template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* t,
                                            int kk) {
  constexpr int S = sw_bytes<HD>();
  return desc<HD>(t + kk * 16 * S, ROWS * S);
}

// d (m64n32) += A B (scale_d 0: d = A B), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n64) += A B (scale_d 0: d = A B), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n32) += A B, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n64) += A B, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n128) += A B, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64n256) += A B, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The products for N = 32, 64 (S = A B, dispatching wgmma_ss_n*) and 32, 64,
// 128, 256 (wgmma_rs_n*): the accumulator holds N / 2 floats a thread.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// Registers that wgmma reads (A fragments, accumulators) were last written
// by other instructions: order them before the next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Close the wgmmas issued since the last commit into a group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N groups are in flight (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the registers of d at this point of the program: after a
// wgmma_wait, reads of an accumulator cannot move above the wait; before
// wgmma_fence, writes to a wgmma operand cannot move below it.
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void hold(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The A fragment of depth step kk (16 columns of an accumulator whose n8
// tile n sits at c[4 n .. 4 n + 3]), each value rounded to bf16 once.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&r)[4],
                                         const float (&c)[R], int kk) {
  r[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  r[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  r[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  r[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// Query rows [r0, r0 + nr) against keys [c0, c0 + nc): kAll when every
// pair attends (the tile needs no mask), kNone when none does.
enum Cover { kNone = 0, kSome = 1, kAll = 2 };
__device__ __forceinline__ int cover(const Args& a, long long r0, int nr,
                                     long long c0, int nc) {
  const long long p0 = a.q_offset + r0, p1 = p0 + nr - 1;  // positions
  const long long c1 = c0 + nc - 1;
  if (r0 >= a.Sq || c0 >= a.Sk) return kNone;
  if (a.causal && c0 > p1) return kNone;
  if (c1 <= p0 - a.window) return kNone;
  const bool all = r0 + nr <= a.Sq && c1 < a.Sk && (!a.causal || c1 <= p0) &&
                   c0 > p1 - a.window;
  return all ? kAll : kSome;
}

// The masked, softcapped scores of one key tile in place, the running max
// m and sum l of this thread's two rows (rq and rq + 8) and their rescale
// alpha; s[i] becomes p = exp(z - m) (0 where masked: the where guard).
// MASKED: some pair of the warp's 16 rows and the tile does not attend;
// CAP: a softcap.  Both are uniform over a tile, so the common case (a
// tile inside the band, no softcap) carries neither test nor tanh.
template <bool MASKED, bool CAP, int N>
__device__ __forceinline__ void online_softmax(const Args& a, float (&s)[N],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int rq,
                                               int c0) {
  const int lane = threadIdx.x % 32;
  uint32_t ok = 0xffffffffu;  // bit i: s[i] attends
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float z = s[i] * a.scale;
    if constexpr (CAP) z = a.softcap * tanhf(z / a.softcap);
    if constexpr (MASKED) {
      if (!attends(a, rq + (i >> 1 & 1) * 8,
                   c0 + (i >> 2) * 8 + 2 * (lane % 4) + (i & 1))) {
        ok &= ~(1u << i);
        z = kNegInf;
      }
    }
    s[i] = z;
    mx[i >> 1 & 1] = fmaxf(mx[i >> 1 & 1], z);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    alpha[hh] = fast_exp2((m[hh] - mx[hh]) * kLog2e);
    m[hh] = mx[hh];
    l[hh] *= alpha[hh];
  }
  const float mb[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float p = fast_exp2(fmaf(s[i], kLog2e, -mb[i >> 1 & 1]));
    if constexpr (MASKED) p = (ok >> i) & 1u ? p : 0.f;
    s[i] = p;
    l[i >> 1 & 1] += p;
  }
}

// forward: grid (H, B, q tiles of 64 rows), the longest tiles first under
// causal masking; one warpgroup a block.  K and V tiles arrive through a
// four-stage ring, two tiles ahead, and the products are pipelined one
// tile apart: with P of tile j - 1 in registers, S = Q K_j^T and O += P
// V_{j-1} go to the tensor cores together and the softmax of tile j runs
// while the second is in flight.
template <int HD>
__global__ void __launch_bounds__(128) forward_wgmma_kernel(const Args a) {
  constexpr int NT = 128, BM = 64, kStages = 4, BN = key_tile<HD>();
  constexpr int kTile = BN * HD * 2;  // bytes of one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sq = smem_raw;
  unsigned char* skv = sq + BM * HD * 2;  // stage s: K at 2 s tiles, V next
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * BM;
  const size_t qrow = ((size_t)b * a.H + h) * a.Sq;
  const size_t krow = ((size_t)b * a.Hkv + hk) * a.Sk;
  const bf16* kg = static_cast<const bf16*>(a.k) + krow * HD;
  const bf16* vg = static_cast<const bf16*>(a.v) + krow * HD;
  int lo, hi;
  key_band(a, q0, (long long)min(a.Sq, q0 + BM) - 1, BN, &lo, &hi);
  auto load_tile = [&](int j) {
    unsigned char* t = skv + (j - lo) % kStages * 2 * kTile;
    load_rows<HD, BN, NT>(t, kg, j * BN, a.Sk);
    load_rows<HD, BN, NT>(t + kTile, vg, j * BN, a.Sk);
  };
  auto stage_k = [&](int j) { return skv + (j - lo) % kStages * 2 * kTile; };

  // this thread's accumulator rows: w0 + lane / 4 (s[4 n], s[4 n + 1]) and
  // + 8 (s[4 n + 2], s[4 n + 3]); columns 8 n + 2 (lane % 4) + {0, 1}
  const int w0 = q0 + warp * 16;
  const int rq = w0 + lane / 4;
  float o[HD / 2], s[BN / 2], m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  load_rows<HD, BM, NT>(sq, static_cast<const bf16*>(a.q) + qrow * HD, q0,
                        a.Sq);
  if (lo <= hi) load_tile(lo);
  cp_async_commit();
  if (lo < hi) load_tile(lo + 1);
  cp_async_commit();
  for (int j = lo; j <= hi; ++j) {
    cp_async_wait<1>();
    __syncthreads();  // tile j landed; every warp is done with tile j - 2
    if (j + 2 <= hi) load_tile(j + 2);
    cp_async_commit();
    const unsigned char* sk = stage_k(j);
    hold(s);
    hold(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BN>(s, desc_k<HD, BM>(sq, kk), desc_k<HD, BN>(sk, kk),
                      kk > 0);
    wgmma_commit();
    if (j > lo) {
      const unsigned char* sv = stage_k(j - 1) + kTile;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<HD>(o, pa[kk], desc_mn<HD, BN>(sv, kk));
    }
    wgmma_commit();
    wgmma_wait<1>();  // S of tile j; O += P V of tile j - 1 may run on
    hold(s);
    const int c0 = j * BN;
    const bool full = cover(a, w0, 16, c0, BN) == kAll;
    if (a.softcap != 0.f) {
      if (full) online_softmax<false, true>(a, s, m, l, alpha, rq, c0);
      else online_softmax<true, true>(a, s, m, l, alpha, rq, c0);
    } else {
      if (full) online_softmax<false, false>(a, s, m, l, alpha, rq, c0);
      else online_softmax<true, false>(a, s, m, l, alpha, rq, c0);
    }
    wgmma_wait<0>();
    hold(o);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[i >> 1 & 1];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      acc_to_a(pa[kk], s, kk);
      hold(pa[kk]);
    }
  }
  if (lo <= hi) {  // O += P V of the last tile
    const unsigned char* sv = stage_k(hi) + kTile;
    hold(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<HD>(o, pa[kk], desc_mn<HD, BN>(sv, kk));
    wgmma_commit();
    wgmma_wait<0>();
    hold(o);
  }
  cp_async_wait<0>();

  bf16* og = static_cast<bf16*>(a.o) + qrow * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int r = rq + hh * 8;
    if (r >= a.Sq) continue;
    const float lf = fmaxf(l[hh], kMinL);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int c = n * 8 + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(og + (size_t)r * HD + c) =
          pack_bf16(o[4 * n + 2 * hh] / lf, o[4 * n + 2 * hh + 1] / lf);
    }
    if (lane % 4 == 0) a.lse[qrow + r] = m[hh] + logf(lf);
  }
}

// P^T = exp(z^T - lse) and dS^T = P^T (dP^T - delta) (times dcap under a
// softcap) in place of S^T and dP^T: this thread's rows are keys rk and rk
// + 8, its columns queries q0 + 8 n + 2 (lane % 4) + {0, 1}.  MASKED and
// CAP as in online_softmax.
template <bool MASKED, bool CAP, int N>
__device__ __forceinline__ void probs_t(const Args& a, float (&s)[N],
                                        float (&dp)[N], const float* slse,
                                        const float* sdelta, int q0,
                                        int rk) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int qc = (i >> 2) * 8 + 2 * (lane % 4) + (i & 1);
    float z = s[i] * a.scale, dcap = 1.f;
    if constexpr (CAP) {
      const float t = tanhf(z / a.softcap);
      z = a.softcap * t;
      dcap = 1.f - t * t;
    }
    float p = fast_exp2(fmaf(z, kLog2e, -slse[qc] * kLog2e));
    if constexpr (MASKED)
      p = attends(a, q0 + qc, rk + (i >> 1 & 1) * 8) ? p : 0.f;
    float ds = p * (dp[i] - sdelta[qc]);
    if constexpr (CAP) ds *= dcap;
    s[i] = p;
    dp[i] = ds;
  }
}

// dK/dV: grid (Hkv, B, key tiles of 64 x HD / HO column blocks); one
// warpgroup, its 64 keys the M rows of every product.  The block walks the
// q tiles of BQ rows of every query head of its group, fed by a
// three-stage cp.async ring (Q, dO, lse, delta): S^T = K Q^T and dP^T = V
// dO^T (m64nBQ, over all HD), then dV += P^T dO and dK += dS^T Q (m64nHO,
// dO and Q MN-major) with P^T and dS^T rounded to bf16 once, the dK and
// dV sums in fp32 registers throughout.  HO, the head dims whose dK and
// dV the block sums, is HD up to hd 128; at hd 256 two m64n256 fp32
// accumulators would take 256 registers a thread, past the 255 a thread
// may have, so each block sums half the columns (HO 128) and the two
// blocks of a key tile both recompute P^T and dS^T.
template <int HD, int BQ, int HO>
__global__ void __launch_bounds__(128) dkv_wgmma_kernel(const Args a) {
  constexpr int NT = 128, NH = HD / HO;
  constexpr int kKV = kKeys * HD * 2, kQ = BQ * HD * 2;  // tile bytes
  constexpr int kAtomCols = sw_bytes<HD>() / 2;  // columns of one atom
  // Q, dO, lse and delta; a multiple of the swizzle's 1024-byte period
  constexpr int kStage = (2 * kQ + 2 * BQ * 4 + 1023) / 1024 * 1024;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sk = smem_raw;
  unsigned char* sv = sk + kKV;
  unsigned char* stages = sv + kKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hk = blockIdx.x, b = blockIdx.y, kt = blockIdx.z / NH;
  const int col0 = blockIdx.z % NH * HO;  // this block's dK, dV columns
  const int G = a.H / a.Hkv;
  const int k0 = kt * kKeys;
  const size_t krow = ((size_t)b * a.Hkv + hk) * a.Sk;
  int lo, hi;
  query_band(a, k0, (long long)min(a.Sk, k0 + kKeys) - 1, BQ, &lo, &hi);
  const int nq = hi >= lo ? hi - lo + 1 : 0;
  const int total = G * nq;

  auto stage_load = [&](int st, int t) {
    const int g = t / nq, i = lo + t % nq;
    const size_t qrow = ((size_t)b * a.H + hk * G + g) * a.Sq;
    const int q0 = i * BQ;
    unsigned char* base = stages + st * kStage;
    load_rows<HD, BQ, NT>(base, static_cast<const bf16*>(a.q) + qrow * HD,
                          q0, a.Sq);
    load_rows<HD, BQ, NT>(base + kQ,
                          static_cast<const bf16*>(a.dout) + qrow * HD, q0,
                          a.Sq);
    float* rows = reinterpret_cast<float*>(base + 2 * kQ);
    for (int e = threadIdx.x; e < 2 * BQ; e += NT) {
      const int r = q0 + e % BQ;
      const bool ok = r < a.Sq;
      const float* src = e < BQ ? a.lse_in : a.delta;
      cp_async4(rows + e, src + (ok ? qrow + r : 0), ok);
    }
  };

  load_rows<HD, kKeys, NT>(sk, static_cast<const bf16*>(a.k) + krow * HD,
                           k0, a.Sk);
  load_rows<HD, kKeys, NT>(sv, static_cast<const bf16*>(a.v) + krow * HD,
                           k0, a.Sk);
  if (total > 0) stage_load(0, 0);
  cp_async_commit();
  if (total > 1) stage_load(1, 1);
  cp_async_commit();

  // this thread's accumulator rows are keys kw + lane / 4 (+ 8); the
  // columns of S^T and dP^T are queries 8 n + 2 (lane % 4) + {0, 1}, those
  // of dK and dV head dims
  const int kw = k0 + warp * 16;
  const int rk = kw + lane / 4;
  float dk[HO / 2], dv[HO / 2];
#pragma unroll
  for (int i = 0; i < HO / 2; ++i) dk[i] = dv[i] = 0.f;
  // byte offset of column col0 in a Q or dO tile: its atom's start
  const int col_off = col0 / kAtomCols * BQ * sw_bytes<HD>();

  for (int t = 0; t < total; ++t) {
    const int st = t % 3;
    cp_async_wait<1>();
    __syncthreads();  // stage st landed; every warp is done with t - 1
    if (t + 2 < total) stage_load((t + 2) % 3, t + 2);
    cp_async_commit();
    const int q0 = (lo + t % nq) * BQ;
    if (cover(a, q0, BQ, k0, kKeys) == kNone) continue;  // block-uniform
    const unsigned char* sq = stages + st * kStage;
    const unsigned char* sdo = sq + kQ;
    const float* slse = reinterpret_cast<const float*>(sq + 2 * kQ);
    const float* sdelta = slse + BQ;

    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<BQ>(s, desc_k<HD, kKeys>(sk, kk), desc_k<HD, BQ>(sq, kk),
                      kk > 0);
      wgmma_ss<BQ>(dp, desc_k<HD, kKeys>(sv, kk),
                      desc_k<HD, BQ>(sdo, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);
    hold(dp);

    // P^T = exp(z^T - lse), dS^T = P^T (dP^T - delta) (x dcap), in place
    const bool full = cover(a, q0, BQ, kw, 16) == kAll;
    if (a.softcap != 0.f) {
      if (full) probs_t<false, true>(a, s, dp, slse, sdelta, q0, rk);
      else probs_t<true, true>(a, s, dp, slse, sdelta, q0, rk);
    } else {
      if (full) probs_t<false, false>(a, s, dp, slse, sdelta, q0, rk);
      else probs_t<true, false>(a, s, dp, slse, sdelta, q0, rk);
    }

    // dV += P^T dO and dK += dS^T Q: dO and Q MN-major
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a(pa[kk], s, kk);
      acc_to_a(da[kk], dp, kk);
      hold(pa[kk]);
      hold(da[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<HO>(dv, pa[kk], desc_mn<HD, BQ>(sdo + col_off, kk));
      wgmma_rs<HO>(dk, da[kk], desc_mn<HD, BQ>(sq + col_off, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(dv);
    hold(dk);
  }
  cp_async_wait<0>();

  bf16* dkg = static_cast<bf16*>(a.dk) + krow * HD;
  bf16* dvg = static_cast<bf16*>(a.dv) + krow * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rk + hh * 8;
    if (r >= a.Sk) continue;
#pragma unroll
    for (int n = 0; n < HO / 8; ++n) {
      const size_t at = (size_t)r * HD + col0 + n * 8 + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(dkg + at) = pack_bf16(
          dk[4 * n + 2 * hh] * a.scale, dk[4 * n + 2 * hh + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvg + at) =
          pack_bf16(dv[4 * n + 2 * hh], dv[4 * n + 2 * hh + 1]);
    }
  }
}

// P = exp(z - lse) and dS = P (dP - delta) (times dcap under a softcap) in
// place of dP, in the forward's row layout: this thread's rows are rq and
// rq + 8 (lse log2(e) in lb, delta in dl), its columns keys c0 + 8 n + 2
// (lane % 4) + {0, 1}.  MASKED and CAP as in online_softmax.
template <bool MASKED, bool CAP, int N>
__device__ __forceinline__ void probs(const Args& a, const float (&s)[N],
                                      float (&dp)[N], const float (&lb)[2],
                                      const float (&dl)[2], int rq, int c0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int hh = i >> 1 & 1;
    float z = s[i] * a.scale, dcap = 1.f;
    if constexpr (CAP) {
      const float t = tanhf(z / a.softcap);
      z = a.softcap * t;
      dcap = 1.f - t * t;
    }
    float p = fast_exp2(fmaf(z, kLog2e, -lb[hh]));
    if constexpr (MASKED)
      p = attends(a, rq + hh * 8, c0 + (i >> 2) * 8 + 2 * (lane % 4) + (i & 1))
              ? p
              : 0.f;
    float ds = p * (dp[i] - dl[hh]);
    if constexpr (CAP) ds *= dcap;
    dp[i] = ds;
  }
}

// dQ: grid (H, B, q tiles of 64 rows), the longest tiles first under causal
// masking; one warpgroup a block, Q and dO staged once.  K and V tiles
// arrive through a four-stage ring, two tiles ahead, and the products are
// pipelined one tile apart as in the forward: with dS of tile j - 1 in
// registers, S = Q K_j^T and dP = dO V_j^T (m64n64, K-major) go to the
// tensor cores with dQ += dS K_{j-1} (m64nHD, K read MN-major), and dS of
// tile j is formed while the last is in flight.  dS is rounded to bf16
// once; the dQ sum stays in fp32 registers and takes the scale at the end.
template <int HD>
__global__ void __launch_bounds__(128) dq_wgmma_kernel(const Args a) {
  constexpr int NT = 128, BM = 64, kStages = 4, BN = key_tile<HD>();
  constexpr int kTile = BN * HD * 2;  // bytes of one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sq = smem_raw;
  unsigned char* sdo = sq + BM * HD * 2;
  unsigned char* skv = sdo + BM * HD * 2;  // stage s: K at 2 s tiles, V next
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * BM;
  const size_t qrow = ((size_t)b * a.H + h) * a.Sq;
  const size_t krow = ((size_t)b * a.Hkv + hk) * a.Sk;
  const bf16* kg = static_cast<const bf16*>(a.k) + krow * HD;
  const bf16* vg = static_cast<const bf16*>(a.v) + krow * HD;
  int lo, hi;
  key_band(a, q0, (long long)min(a.Sq, q0 + BM) - 1, BN, &lo, &hi);
  auto stage_k = [&](int j) { return skv + (j - lo) % kStages * 2 * kTile; };
  auto load_tile = [&](int j) {
    unsigned char* t = stage_k(j);
    load_rows<HD, BN, NT>(t, kg, j * BN, a.Sk);
    load_rows<HD, BN, NT>(t + kTile, vg, j * BN, a.Sk);
  };

  // this thread's rows: w0 + lane / 4 and + 8, as in the forward
  const int w0 = q0 + warp * 16;
  const int rq = w0 + lane / 4;
  float lb[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rq + hh * 8;
    lb[hh] = r < a.Sq ? a.lse_in[qrow + r] * kLog2e : 0.f;
    dl[hh] = r < a.Sq ? a.delta[qrow + r] : 0.f;
  }
  float dq[HD / 2], s[BN / 2], dp[BN / 2];
  uint32_t da[BN / 16][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  load_rows<HD, BM, NT>(sq, static_cast<const bf16*>(a.q) + qrow * HD, q0,
                        a.Sq);
  load_rows<HD, BM, NT>(sdo, static_cast<const bf16*>(a.dout) + qrow * HD,
                        q0, a.Sq);
  if (lo <= hi) load_tile(lo);
  cp_async_commit();
  if (lo < hi) load_tile(lo + 1);
  cp_async_commit();
  for (int j = lo; j <= hi; ++j) {
    cp_async_wait<1>();
    __syncthreads();  // tile j landed; every warp is done with tile j - 2
    if (j + 2 <= hi) load_tile(j + 2);
    cp_async_commit();
    const unsigned char* sk = stage_k(j);
    hold(s);
    hold(dp);
    hold(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<BN>(s, desc_k<HD, BM>(sq, kk), desc_k<HD, BN>(sk, kk),
                      kk > 0);
      wgmma_ss<BN>(dp, desc_k<HD, BM>(sdo, kk),
                      desc_k<HD, BN>(sk + kTile, kk), kk > 0);
    }
    wgmma_commit();
    if (j > lo) {
      const unsigned char* skp = stage_k(j - 1);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<HD>(dq, da[kk], desc_mn<HD, BN>(skp, kk));
    }
    wgmma_commit();
    wgmma_wait<1>();  // S and dP of tile j; dQ += dS K of tile j - 1 runs on
    hold(s);
    hold(dp);
    const int c0 = j * BN;
    const bool full = cover(a, w0, 16, c0, BN) == kAll;
    if (a.softcap != 0.f) {
      if (full) probs<false, true>(a, s, dp, lb, dl, rq, c0);
      else probs<true, true>(a, s, dp, lb, dl, rq, c0);
    } else {
      if (full) probs<false, false>(a, s, dp, lb, dl, rq, c0);
      else probs<true, false>(a, s, dp, lb, dl, rq, c0);
    }
    wgmma_wait<0>();
    hold(dq);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      acc_to_a(da[kk], dp, kk);
      hold(da[kk]);
    }
  }
  if (lo <= hi) {  // dQ += dS K of the last tile
    const unsigned char* sk = stage_k(hi);
    hold(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<HD>(dq, da[kk], desc_mn<HD, BN>(sk, kk));
    wgmma_commit();
    wgmma_wait<0>();
    hold(dq);
  }
  cp_async_wait<0>();

  bf16* dqg = static_cast<bf16*>(a.dq) + qrow * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rq + hh * 8;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)r * HD + n * 8 +
                                   2 * (lane % 4)) =
          pack_bf16(dq[4 * n + 2 * hh] * a.scale,
                    dq[4 * n + 2 * hh + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// host side

enum Which { kForward = 0, kDq = 1, kDkv = 2 };

// fp32: the FMA kernels' score tiles, (RQ, RK) per thread (see the
// kernels): 64 x 64, and at hd 256 32 query rows for dQ and 32 keys for
// dK/dV, so that their shared memory stays within a block's 227 KB.
template <int HD, Which W>
struct FmaTiles {
  static constexpr int RQ = W == kDq && HD == 256 ? 2 : 4;
  static constexpr int RK = W == kDkv && HD == 256 ? 2 : 4;
  static constexpr int BQ = 16 * RQ, BK = 16 * RK;
  // bytes of shared memory: the fp32 planes of rows padded to HD + 1, the
  // (BQ, BK + 1) tiles of p or dS, and dK/dV's lse and delta rows
  static constexpr size_t kSmem =
      sizeof(float) *
      ((W == kForward ? BQ + 2 * BK : 2 * BQ + 2 * BK) * (HD + 1) +
       (W == kDkv ? 2 : 1) * BQ * (BK + 1) + (W == kDkv ? 2 * BQ : 0));
};

// bf16: the tensor-core kernels, one warpgroup a block.  The forward and
// dQ own q tiles of 64 rows and walk a four-stage K/V ring of key_tile<HD>
// keys (dQ also keeps its dO tile); dK/dV walks q tiles of 64 rows (32 at
// hd 128 and 256, where dK and dV take twice the registers) through a
// three-stage ring, and at hd 256 each key tile has two blocks, one for
// each half of the head dims.
template <int HD>
cudaError_t launch_tc(Which w, const Args& a, cudaStream_t stream) {
  void (*kern)(Args);
  size_t smem;
  long long tiles;
  int heads;
  if (w != kDkv) {
    kern = w == kForward ? forward_wgmma_kernel<HD> : dq_wgmma_kernel<HD>;
    smem = (size_t)((w == kForward ? 64 : 128) + 4 * 2 * key_tile<HD>()) *
           HD * 2;
    tiles = (a.Sq + 63) / 64;
    heads = a.H;
  } else {
    constexpr int BQ = HD >= 128 ? 32 : 64, HO = HD == 256 ? 128 : HD;
    kern = dkv_wgmma_kernel<HD, BQ, HO>;
    smem = (size_t)2 * kKeys * HD * 2 +
           3 * ((2 * BQ * HD * 2 + 2 * BQ * 4 + 1023) / 1024 * 1024);
    tiles = (long long)(a.Sk + kKeys - 1) / kKeys * (HD / HO);
    heads = a.Hkv;
  }
  if (tiles > 65535 || a.B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (tiles == 0 || a.B == 0) return cudaSuccess;
  kern<<<dim3(heads, a.B, (unsigned)tiles), 128, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD, Which W>
cudaError_t launch_fma(const Args& a, cudaStream_t stream) {
  using F = FmaTiles<HD, W>;
  void (*kern)(Args);
  if constexpr (W == kForward) kern = forward_kernel<T, HD, F::RQ, F::RK>;
  else if constexpr (W == kDq) kern = dq_kernel<T, HD, F::RQ, F::RK>;
  else kern = dkv_kernel<T, HD, F::RQ, F::RK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = W == kDkv ? n_tiles(a.Sk, F::BK) : n_tiles(a.Sq, F::BQ);
  const dim3 grid(tiles, W == kDkv ? a.Hkv : a.H, a.B);
  if (tiles == 0 || a.B == 0) return cudaSuccess;
  kern<<<grid, kThreads, F::kSmem, stream>>>(a);
  return cudaGetLastError();
}

// fp32: the FMA kernels; bf16: the tensor-core kernels.
template <typename T, int HD>
cudaError_t launch(Which w, const Args& a, cudaStream_t stream) {
  if constexpr (sizeof(T) == sizeof(bf16)) {
    return launch_tc<HD>(w, a, stream);
  } else {
    switch (w) {
      case kForward: return launch_fma<T, HD, kForward>(a, stream);
      case kDq: return launch_fma<T, HD, kDq>(a, stream);
      default: return launch_fma<T, HD, kDkv>(a, stream);
    }
  }
}

template <typename T>
cudaError_t dispatch(Which w, const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(w, a, stream);
    case 64: return launch<T, 64>(w, a, stream);
    case 128: return launch<T, 128>(w, a, stream);
    case 256: return launch<T, 256>(w, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which w, Args& a, int B, int H, int Hkv, int Sq, int Sk, int hd,
        int is_bf16, int causal, long long window, long long q_offset,
        float scale, float softcap, void* stream) {
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  a.softcap = softcap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<bf16>(w, a, hd, s)
                       : dispatch<float>(w, a, hd, s));
}

}  // namespace
}  // namespace flash_attn

extern "C" {

// o (B, H, Sq, hd) in q's dtype and lse (B, H, Sq) fp32.
int flash_forward_launch(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int Hkv, int Sq, int Sk,
                         int hd, int is_bf16, int causal, long long window,
                         long long q_offset, float scale, float softcap,
                         void* stream) {
  flash_attn::Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  return flash_attn::run(flash_attn::kForward, a, B, H, Hkv, Sq, Sk, hd,
                         is_bf16, causal, window, q_offset, scale, softcap,
                         stream);
}

// dq like q, from the forward's lse and delta = rowsum(do * o).
int flash_backward_dq_launch(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, int B, int H,
                             int Hkv, int Sq, int Sk, int hd, int is_bf16,
                             int causal, long long window, long long q_offset,
                             float scale, float softcap, void* stream) {
  flash_attn::Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dq = dq;
  return flash_attn::run(flash_attn::kDq, a, B, H, Hkv, Sq, Sk, hd, is_bf16,
                         causal, window, q_offset, scale, softcap, stream);
}

// dk like k and dv like v, each summed over its GQA group.
int flash_backward_dkv_launch(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, int B,
                              int H, int Hkv, int Sq, int Sk, int hd,
                              int is_bf16, int causal, long long window,
                              long long q_offset, float scale, float softcap,
                              void* stream) {
  flash_attn::Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return flash_attn::run(flash_attn::kDkv, a, B, H, Hkv, Sq, Sk, hd, is_bf16,
                         causal, window, q_offset, scale, softcap, stream);
}

}  // extern "C"
