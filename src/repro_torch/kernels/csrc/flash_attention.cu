// Training-path flash attention for Hopper (sm_90a): the forward and the
// two backward kernels, dQ and dK/dV.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   forward_kernel  _forward (pallas_call :198, body _fwd_kernel :111)
//   dq_kernel       _backward's dQ (pallas_call :333, body _dq_kernel :239)
//   dkv_kernel      _backward's dK/dV (pallas_call :374, body _dkv_kernel
//                   :268), summed over the GQA group
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
// the ~295 where the bf16 tensor cores stop being the limit.  This first
// version computes on the fp32 FMA units; wgmma and TMA are a later PR's
// work.  Design:
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
//   * the forward's row max and row sum reduce over the 16 threads of a
//     row by shuffles (the 16 lanes of a half warp);
//   * sequence lengths need not divide the tile: rows and keys past the
//     end load as zeros and are masked.
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
constexpr int kTile = 64;         // query rows and keys of one tile
constexpr int kPS = kTile + 1;    // padded row stride of a (64, 64) tile
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

__host__ __device__ __forceinline__ int n_tiles(int n) {
  return (n + kTile - 1) / kTile;
}

// Inclusive key tiles [lo, hi] that q tile i attends (the reference's
// _kv_band, the last row clipped to Sq).
__device__ __forceinline__ void kv_band(const Args& a, int i, int* lo,
                                        int* hi) {
  const long long last = (long long)min(a.Sq, (i + 1) * kTile) - 1;
  long long h = n_tiles(a.Sk) - 1;
  if (a.causal) {
    const long long c = floor_div(last + a.q_offset, kTile);
    h = c < h ? c : h;
  }
  const long long l =
      floor_div((long long)i * kTile + a.q_offset - a.window + 1, kTile);
  *lo = l > 0 ? (int)l : 0;
  *hi = (int)h;
}

// Inclusive q tiles [lo, hi] that attend key tile j (the reference's
// _q_band, the last key clipped to Sk).
__device__ __forceinline__ void q_band(const Args& a, int j, int* lo,
                                       int* hi) {
  const long long last = (long long)min(a.Sk, (j + 1) * kTile) - 1;
  long long l = 0;
  if (a.causal) l = floor_div((long long)j * kTile - a.q_offset, kTile);
  long long h = floor_div(last - 1 + a.window - a.q_offset, kTile);
  const long long top = n_tiles(a.Sq) - 1;
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

// Rows [row0, row0 + 64) of a (rows, HD) plane into shared memory as fp32
// with row stride HD + 1; rows past the end read as zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int g = row0 + r;
    dst[r * (HD + 1) + d] = g < rows ? to_float(src[(size_t)g * HD + d]) : 0.f;
  }
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over HD, both tiles (64, HD + 1).
template <int HD>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int tx, int ty, float s[4][4]) {
  constexpr int LS = HD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ty + 16 * i) * LS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * LS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
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
// forward: grid (q tiles, H, B)

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) forward_kernel(const Args a) {
  constexpr int LS = HD + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTile * LS;
  float* sv = sk + kTile * LS;
  float* sp = sv + kTile * LS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * kTile;
  const size_t qrow = ((size_t)b * a.H + h) * a.Sq;
  const size_t krow = ((size_t)b * a.Hkv + hk) * a.Sk;
  const T* k = static_cast<const T*>(a.k) + krow * HD;
  const T* v = static_cast<const T*>(a.v) + krow * HD;
  load_tile<T, HD>(sq, static_cast<const T*>(a.q) + qrow * HD, q0, a.Sq);

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[i][d] = 0.f;
  }
  int lo, hi;
  kv_band(a, qt, &lo, &hi);
  for (int j = lo; j <= hi; ++j) {
    __syncthreads();  // the previous tile's sk, sv and sp are read
    load_tile<T, HD>(sk, k, j * kTile, a.Sk);
    load_tile<T, HD>(sv, v, j * kTile, a.Sk);
    __syncthreads();
    float s[4][4];
    tile_dot<HD>(sq, sk, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      bool ok[4];
      float rmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float dcap;
        const float z = score(a, s[i][jj], &dcap);
        ok[jj] = attends(a, r, j * kTile + tx + 16 * jj);
        s[i][jj] = ok[jj] ? z : kNegInf;
        rmax = fmaxf(rmax, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        sp[(ty + 16 * i) * kPS + tx + 16 * jj] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < ND; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float vv[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) vv[d] = sv[c * LS + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty + 16 * i) * kPS + c];
#pragma unroll
        for (int d = 0; d < ND; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
      }
    }
  }
  T* o = static_cast<T*>(a.o) + qrow * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  constexpr int LS = HD + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kTile * LS;
  float* sk = sdo + kTile * LS;
  float* sv = sk + kTile * LS;
  float* sds = sv + kTile * LS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * kTile;
  const size_t qrow = ((size_t)b * a.H + h) * a.Sq;
  const size_t krow = ((size_t)b * a.Hkv + hk) * a.Sk;
  const T* k = static_cast<const T*>(a.k) + krow * HD;
  const T* v = static_cast<const T*>(a.v) + krow * HD;
  load_tile<T, HD>(sq, static_cast<const T*>(a.q) + qrow * HD, q0, a.Sq);
  load_tile<T, HD>(sdo, static_cast<const T*>(a.dout) + qrow * HD, q0, a.Sq);
  float lse[4], delta[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse[i] = r < a.Sq ? a.lse_in[qrow + r] : 0.f;
    delta[i] = r < a.Sq ? a.delta[qrow + r] : 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[i][d] = 0.f;
  }
  int lo, hi;
  kv_band(a, qt, &lo, &hi);
  for (int j = lo; j <= hi; ++j) {
    __syncthreads();
    load_tile<T, HD>(sk, k, j * kTile, a.Sk);
    load_tile<T, HD>(sv, v, j * kTile, a.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(sq, sk, tx, ty, s);
    tile_dot<HD>(sdo, sv, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float dcap;
        const float z = score(a, s[i][jj], &dcap);
        const bool ok = attends(a, r, j * kTile + tx + 16 * jj);
        const float p = ok ? expf(z - lse[i]) : 0.f;
        float ds = p * (dp[i][jj] - delta[i]);
        if (a.softcap != 0.f) ds *= dcap;
        sds[(ty + 16 * i) * kPS + tx + 16 * jj] = ds;
      }
    }
    __syncthreads();
    float t[4][ND];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int d = 0; d < ND; ++d) t[i][d] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float kv[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) kv[d] = sk[c * LS + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sds[(ty + 16 * i) * kPS + c];
#pragma unroll
        for (int d = 0; d < ND; ++d) t[i][d] = fmaf(ds, kv[d], t[i][d]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int d = 0; d < ND; ++d) acc[i][d] += t[i][d] * a.scale;
  }
  T* dq = static_cast<T*>(a.dq) + qrow * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.Sq) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      dq[(size_t)r * HD + tx + 16 * d] = from_float<T>(acc[i][d]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid (key tiles, Hkv, B)

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Args a) {
  constexpr int LS = HD + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kTile * LS;
  float* sq = sv + kTile * LS;
  float* sdo = sq + kTile * LS;
  float* sp = sdo + kTile * LS;
  float* sds = sp + kTile * kPS;
  float* slse = sds + kTile * kPS;
  float* sdelta = slse + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int k0 = kt * kTile;
  const size_t krow = ((size_t)b * a.Hkv + hk) * a.Sk;
  load_tile<T, HD>(sk, static_cast<const T*>(a.k) + krow * HD, k0, a.Sk);
  load_tile<T, HD>(sv, static_cast<const T*>(a.v) + krow * HD, k0, a.Sk);
  // thread rows ty + 16 i are keys of the tile; columns tx + 16 d
  float dk[4][ND], dv[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < ND; ++d) dk[i][d] = dv[i][d] = 0.f;
  int lo, hi;
  q_band(a, kt, &lo, &hi);
  for (int g = 0; g < G; ++g) {
    const size_t qrow = ((size_t)b * a.H + hk * G + g) * a.Sq;
    const T* q = static_cast<const T*>(a.q) + qrow * HD;
    const T* dout = static_cast<const T*>(a.dout) + qrow * HD;
    for (int i = lo; i <= hi; ++i) {
      const int q0 = i * kTile;
      __syncthreads();
      load_tile<T, HD>(sq, q, q0, a.Sq);
      load_tile<T, HD>(sdo, dout, q0, a.Sq);
      if (threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        slse[threadIdx.x] = r < a.Sq ? a.lse_in[qrow + r] : 0.f;
        sdelta[threadIdx.x] = r < a.Sq ? a.delta[qrow + r] : 0.f;
      }
      __syncthreads();
      // score tile: rows ty + 16 ii are queries, columns tx + 16 jj keys
      float s[4][4], dp[4][4];
      tile_dot<HD>(sq, sk, tx, ty, s);
      tile_dot<HD>(sdo, sv, tx, ty, dp);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int rl = ty + 16 * ii;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float dcap;
          const float z = score(a, s[ii][jj], &dcap);
          const bool ok = attends(a, q0 + rl, k0 + tx + 16 * jj);
          const float p = ok ? expf(z - slse[rl]) : 0.f;
          float ds = p * (dp[ii][jj] - sdelta[rl]);
          if (a.softcap != 0.f) ds *= dcap;
          sp[rl * kPS + tx + 16 * jj] = p;
          sds[rl * kPS + tx + 16 * jj] = ds;
        }
      }
      __syncthreads();
      float t[4][ND];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int d = 0; d < ND; ++d) t[c][d] = 0.f;
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float dov[ND], qv[ND];
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          dov[d] = sdo[r * LS + tx + 16 * d];
          qv[d] = sq[r * LS + tx + 16 * d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = sp[r * kPS + ty + 16 * c];
          const float ds = sds[r * kPS + ty + 16 * c];
#pragma unroll
          for (int d = 0; d < ND; ++d) {
            dv[c][d] = fmaf(p, dov[d], dv[c][d]);
            t[c][d] = fmaf(ds, qv[d], t[c][d]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int d = 0; d < ND; ++d) dk[c][d] += t[c][d] * a.scale;
    }
  }
  T* dkp = static_cast<T*>(a.dk) + krow * HD;
  T* dvp = static_cast<T*>(a.dv) + krow * HD;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
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
// host side

enum Which { kForward = 0, kDq = 1, kDkv = 2 };

template <int HD>
size_t smem_bytes(Which w) {
  const size_t plane = (size_t)kTile * (HD + 1), tile = (size_t)kTile * kPS;
  switch (w) {
    case kForward: return sizeof(float) * (3 * plane + tile);
    case kDq: return sizeof(float) * (4 * plane + tile);
    default: return sizeof(float) * (4 * plane + 2 * tile + 2 * kTile);
  }
}

template <typename T, int HD>
cudaError_t launch(Which w, const Args& a, cudaStream_t stream) {
  void (*kern)(Args) = w == kForward ? forward_kernel<T, HD>
                       : w == kDq    ? dq_kernel<T, HD>
                                     : dkv_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>(w);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = w == kDkv ? n_tiles(a.Sk) : n_tiles(a.Sq);
  const dim3 grid(tiles, w == kDkv ? a.Hkv : a.H, a.B);
  if (tiles == 0 || a.B == 0) return cudaSuccess;
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(Which w, const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(w, a, stream);
    case 64: return launch<T, 64>(w, a, stream);
    case 128: return launch<T, 128>(w, a, stream);
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
