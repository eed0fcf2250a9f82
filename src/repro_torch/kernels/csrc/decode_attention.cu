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
// Bound: device-memory bytes.  Each query token reads the K/V rows of its
// slot that can be valid once and does 4 flops per cache element, far below
// the ~20 flops per byte where the card's fp32 units would limit.  Until the
// ring wraps (0 <= pos < C) a row s > pos holds absolute position s - C < 0,
// always masked, so the loop ends at min(C, pos + 1): a skipped row would
// only add p = exp(-1e30 - m) = 0.  Design:
//   * one thread block per (slot, kv-head) serves all G query heads of the
//     group, so each K/V byte is read from device memory once;
//   * the TPU's sequential page axis becomes a loop inside the block: the
//     block's 8 warps are cut into "workers" of LPK lanes, one cache row per
//     worker per step, each lane loading a contiguous slice of the row
//     (16-byte loads where the head's register budget allows it), and each
//     worker keeps its own running (m, l, acc) per query head;
//   * kUnroll rows per worker are loaded before any is used, to keep loads
//     in flight;
//   * workers merge with the same rescale the online softmax uses,
//     exp(m_w - M): first by shuffles inside a warp, then across warps in
//     shared memory.  A worker that saw only masked rows holds m = -1e30
//     and is weighted exp(-1e30 - M) = 0, as the Pallas kernel's later
//     pages wipe an all-masked page.
// Launch checks stay with the caller: the C entry point returns
// cudaGetLastError() after the launch and never synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;  // the reference's masked-score sentinel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round through T and back: the one rounding of an int8 dequant into the
// compute dtype.
template <typename T> __device__ __forceinline__ float round_through(float x) {
  return to_float(from_float<T>(x));
}

// One load of B bytes (4, 8 or 16) as a plain word type.
template <int B> struct Word;
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// Lane layout of one cache row of HD elements of KV: LPK lanes per row,
// EPL contiguous elements per lane, read in NLD loads of LB bytes.
template <typename KV, int HD, int GMAX> struct Layout {
  static constexpr int kVec = 16 / sizeof(KV);        // elements per 16 B
  // small head groups take 16-byte loads; large ones spread the row over a
  // whole warp so the per-lane (GMAX x EPL) accumulators fit in registers
  static constexpr int LPK = GMAX <= 2 ? (HD / kVec < 32 ? HD / kVec : 32) : 32;
  static constexpr int EPL = HD / LPK;
  static constexpr int ROW_BYTES = EPL * sizeof(KV);
  static constexpr int LB = ROW_BYTES < 16 ? ROW_BYTES : 16;
  static constexpr int NLD = ROW_BYTES / LB;
  static constexpr int KPW = 32 / LPK;                // rows per warp step
  static constexpr int NWORK = kWarps * KPW;          // workers per block
  using W = typename Word<LB>::T;
};

template <typename QT, typename KV, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const QT* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ positions,
                        QT* __restrict__ out, int H, int Hkv, int C,
                        float scale, int window, float softcap) {
  using L = Layout<KV, HD, GMAX>;
  using W = typename L::W;
  constexpr bool kQuant = sizeof(KV) == 1;
  extern __shared__ float smem[];

  const int G = H / Hkv;
  const int n = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / L::LPK;                      // row slot in the warp
  const int li = lane % L::LPK;                       // lane within the row
  const int worker = warp * L::KPW + sub;
  const int pos = positions[n];
  // rows that can be valid (a negative position masks every row: walk them
  // all, as the reference's softmax does)
  const int n_rows = pos >= 0 && pos < C ? pos + 1 : C;

  // this lane's slice of every query head of the group, in fp32
  float qf[GMAX][L::EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int e = 0; e < L::EPL; ++e) {
      qf[g][e] = g < G ? to_float(q[((size_t)n * H + hk * G + g) * HD +
                                    li * L::EPL + e])
                       : 0.f;
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

  const size_t row_stride = (size_t)Hkv * HD;         // elements per ring entry
  const KV* kbase = k + (size_t)n * C * row_stride + (size_t)hk * HD + li * L::EPL;
  const KV* vbase = v + (size_t)n * C * row_stride + (size_t)hk * HD + li * L::EPL;

  for (int t0 = 0; t0 < n_rows; t0 += L::NWORK * kUnroll) {
    W kw[kUnroll][L::NLD], vw[kUnroll][L::NLD];
    float ksc[kUnroll], vsc[kUnroll];
    // issue every load of the step before using any of them
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * L::NWORK + worker;
      if (t < n_rows) {
        const W* kp = reinterpret_cast<const W*>(kbase + t * row_stride);
        const W* vp = reinterpret_cast<const W*>(vbase + t * row_stride);
#pragma unroll
        for (int i = 0; i < L::NLD; ++i) {
          kw[u][i] = kp[i];
          vw[u][i] = vp[i];
        }
        if (kQuant) {
          ksc[u] = k_scale[(size_t)n * C + t];
          vsc[u] = v_scale[(size_t)n * C + t];
        }
      } else {
#pragma unroll
        for (int i = 0; i < L::NLD; ++i) {
          kw[u][i] = W{};
          vw[u][i] = W{};
        }
        ksc[u] = 0.f;
        vsc[u] = 0.f;
      }
    }

    float s[kUnroll][GMAX];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * L::NWORK + worker;
      const KV* ke = reinterpret_cast<const KV*>(kw[u]);
      float kf[L::EPL];
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) {
        kf[e] = kQuant ? round_through<QT>(to_float(ke[e]) * ksc[u])
                       : to_float(ke[e]);
      }
      bool valid = false;
      if (t < n_rows) {
        int r = (pos - t) % C;                        // floor-mod, as jnp.mod
        if (r < 0) r += C;
        const int abs_pos = pos - r;
        valid = abs_pos >= 0 && abs_pos > pos - window;
      }
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
        float sc = d * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        // a row past the rows walked is no entry at all: -inf, so p = 0
        s[u][g] = t < n_rows ? (valid ? sc : kNegInf) : -INFINITY;
      }
    }

#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) continue;
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, s[u][g]);
      const float alpha = expf(m[g] - m_new);
      float p[kUnroll];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = expf(s[u][g] - m_new);
        psum += p[u];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const KV* ve = reinterpret_cast<const KV*>(vw[u]);
          const float vf = kQuant ? round_through<QT>(to_float(ve[e]) * vsc[u])
                                  : to_float(ve[e]);
          a = fmaf(p[u], vf, a);
        }
        acc[g][e] = a;
      }
      m[g] = m_new;
    }
  }

  // merge the workers of one warp (lanes li of every row slot pair up)
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) continue;
#pragma unroll
    for (int off = L::LPK; off < 32; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], m_o);
      const float a = expf(m[g] - M);
      const float b = expf(m_o - M);
      l[g] = l[g] * a + l_o * b;
#pragma unroll
      for (int e = 0; e < L::EPL; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + acc_o * b;
      }
      m[g] = M;
    }
  }

  // then the warps, through shared memory: [warp][g] m, l and acc[HD]
  float* sm_m = smem;
  float* sm_l = smem + kWarps * G;
  float* sm_acc = smem + 2 * kWarps * G;
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
        sm_acc[(warp * G + g) * HD + li * L::EPL + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * G + g] - M);
      lsum += sm_l[w * G + g] * c;
      a += sm_acc[(w * G + g) * HD + d] * c;
    }
    out[((size_t)n * H + hk * G + g) * HD + d] =
        from_float<QT>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename QT, typename KV, int HD, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* pos, void* out,
                   int N, int H, int Hkv, int C, float scale, int window,
                   float softcap, cudaStream_t stream) {
  auto kern = decode_attention_kernel<QT, KV, HD, GMAX>;
  const int G = H / Hkv;
  const size_t smem = (size_t)kWarps * G * (HD + 2) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<N * Hkv, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, pos, static_cast<QT*>(out), H, Hkv,
      C, scale, window, softcap);
  return cudaGetLastError();
}

template <typename QT, typename KV, int HD>
cudaError_t by_group(int G, const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* pos,
                     void* out, int N, int H, int Hkv, int C, float scale,
                     int window, float softcap, cudaStream_t st) {
  if (G == 1) return launch<QT, KV, HD, 1>(q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
  if (G == 2) return launch<QT, KV, HD, 2>(q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
  if (G <= 4) return launch<QT, KV, HD, 4>(q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
  if (G <= 8) return launch<QT, KV, HD, 8>(q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
  return cudaErrorInvalidValue;
}

template <typename QT, typename KV>
cudaError_t by_head_dim(int hd, int G, const void* q, const void* k,
                        const void* v, const float* ks, const float* vs,
                        const int* pos, void* out, int N, int H, int Hkv,
                        int C, float scale, int window, float softcap,
                        cudaStream_t st) {
  if (hd == 64) return by_group<QT, KV, 64>(G, q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
  if (hd == 128) return by_group<QT, KV, 128>(G, q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
  if (hd == 256) return by_group<QT, KV, 256>(G, q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Tensors are contiguous:
// q/out (N, H, hd); k/v (N, C, Hkv, hd); k_scale/v_scale (N, C) fp32 or
// null; positions (N,) int32.  q_bf16: 1 for bf16 q/out, 0 for fp32.
// kv_int8: 1 for an int8 cache with scales, 0 for a cache in q's dtype.
// window: 1 << 30 for global attention; softcap <= 0: none.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* positions, void* out, int N, int H,
    int Hkv, int C, int hd, int q_bf16, int kv_int8, float scale, int window,
    float softcap, void* stream) {
  if (N <= 0 || C <= 0 || Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (kv_int8)
      return by_head_dim<__nv_bfloat16, int8_t>(hd, G, q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
    return by_head_dim<__nv_bfloat16, __nv_bfloat16>(hd, G, q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
  }
  if (kv_int8)
    return by_head_dim<float, int8_t>(hd, G, q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
  return by_head_dim<float, float>(hd, G, q, k, v, ks, vs, pos, out, N, H, Hkv, C, scale, window, softcap, st);
}
