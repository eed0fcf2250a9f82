// Fused optimizer-engine kernels for Hopper (sm_90a): the Sophia step, the
// Hessian EMA, the Sophia step with the refresh fused in, AdamW, the
// AdaHessian step with and without its refresh, Lion, SignGD and SGD, each
// one streaming pass over a flat parameter shard.
//
// Replaces the TPU kernels of src/repro/kernels/sophia_update.py:
//   sophia_step_kernel     sophia_fused_block (pallas_call :72, body
//                          _sophia_kernel :47), row 2
//   hessian_ema_kernel     hessian_ema_block (:105, body _hess_ema_kernel
//                          :84), row 3
//   sophia_refresh_kernel  sophia_refresh_fused_block (:157, body
//                          _sophia_refresh_kernel :115), row 4
//   adamw_kernel           adamw_fused_block (:243, body _adamw_kernel
//                          :218), row 6
//   adahessian_refresh_kernel  adahessian_refresh_fused_block (:202, body
//                          _adahessian_refresh_kernel :170), row 5
//   adahessian_kernel      adahessian_fused_block (:277, body
//                          _adahessian_kernel :255), row 7
//   lion_kernel            lion_fused_block (:306, body _lion_kernel :288),
//                          row 8
//   signgd_kernel          signgd_fused_block (:333, body _signgd_kernel
//                          :317), row 9
//   sgd_kernel             sgd_fused_block (:356, body _sgd_kernel :344),
//                          row 10
//
// The function, as the plain versions compute it (kernels/ref.py), in fp32
// with p, m and h (AdamW's v) in their stored dtype P or S (fp32 or bf16),
// g and e in fp32:
//   sophia:  m' = b1 m + (1-b1) g;  raw = m' / max(gamma h, eps);
//            u = clip(raw, +-rho);  p' = p (1 - lr wd) - lr u;
//            nclip[i / block] counts |raw| >= rho
//   ema:     h' = b2 h + (1-b2) e',  e' = B e, squared when `square`
//   refresh: h_new = flag ? round_S(b2 h + (1-b2) B e) : h, then the sophia
//            step reading h_new (the rounding through S before the step
//            reads h is what makes the one sweep equal the two-pass path)
//   adamw:   m' as above; v' = b2 v + (1-b2) g g;
//            u = (m' / bc1) / (sqrt(v' / bc2) + eps); p' as above
//   adahessian: the adamw step reading v as it is (no v'); its refresh
//            first v_new = flag ? round_S(b2 v + (1-b2) (B e)^2) : v
//   lion:    u = sign(b1 m + (1-b1) g) from the OLD m; m' = b2 m + (1-b2) g;
//            p' as above
//   signgd:  m' = b1 m + (1-b1) g; p' = p (1 - lr wd) - lr sign(m')
//   sgd:     m' = mu m + g; p' = p - lr m' (no weight decay)
// sign is jnp.sign's: (0 < x) - (x < 0), so +-0 gives 0, and NaN at NaN.
// Every operation rounds where the plain version's PyTorch operation
// rounds: the IEEE intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn) keep nvcc from contracting a*b + c into an FMA, clamps pass
// NaN through as PyTorch's do, and stores round to bf16 with
// __float2bfloat16_rn.  So on the card a kernel and its plain version
// agree bit for bit.  The step-dependent scalars (lr, B, bc1, bc2) come in
// a small fp32 device array, the counterpart of the reference's SMEM
// scalar operand; 1 - lr wd is rounded as the plain version rounds it.
//
// Bound: bytes.  A few fp32 operations per element against 12-32 bytes
// (each input read once, each output written once): at GPT-2 small's
// shard, n = 124,518,400 with fp32 state, 24 / 12 / 32 / 28 bytes per
// element for sophia / ema / refresh / adamw, 0.89 / 0.45 / 1.19 / 1.04 ms
// at 3.35 TB/s; 32 / 24 / 20 bytes for the adahessian refresh / the
// adahessian step / lion, signgd and sgd, 1.19 / 0.89 / 0.74 ms.
// Design: one streaming pass at 16 bytes a thread: each thread loads 4
// fp32 values (float4) or 8 bf16 (uint4) of every operand, and 8 values
// of each operand when any operand is bf16.  The TPU's 128k-element VMEM
// blocks are not copied: a CUDA block streams one contiguous span of up to
// 16 tiles of 256 threads x 8 or 4 values, inside one reference block, so
// thousands of blocks cover the 132 SMs several times over.  The clip
// count of a span is summed in registers, reduced by warp shuffles and
// shared memory, and added with one integer atomicAdd per CUDA block into
// nclip[reference block] (integer atomics are exact in any order).
// Outputs are written out of place, like the plain version's.
// The C entry points return cudaGetLastError() after the launch and never
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sophia_update {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kTilesPerBlock = 16;   // tiles of kThreads x VEC per span

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// x rounded through storage type T (fp32: itself)
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int VEC>
__device__ __forceinline__ void load(const float* __restrict__ src,
                                     long long i, float (&x)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + i + k);
    x[k] = v.x;
    x[k + 1] = v.y;
    x[k + 2] = v.z;
    x[k + 3] = v.w;
  }
}

template <int VEC>
__device__ __forceinline__ void load(const bf16* __restrict__ src,
                                     long long i, float (&x)[VEC]) {
  static_assert(VEC == 8, "a bf16 operand streams 8 values a thread");
  const uint4 v = *reinterpret_cast<const uint4*>(src + i);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(b[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* __restrict__ dst, long long i,
                                      const float (&x)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; k += 4)
    *reinterpret_cast<float4*>(dst + i + k) =
        make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
}

template <int VEC>
__device__ __forceinline__ void store(bf16* __restrict__ dst, long long i,
                                      const float (&x)[VEC]) {
  static_assert(VEC == 8, "a bf16 operand streams 8 values a thread");
  uint4 v;
  bf16* b = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = __float2bfloat16_rn(x[k]);
  *reinterpret_cast<uint4*>(dst + i) = v;
}

// PyTorch's clamp_min / clamp on CUDA: NaN passes through
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

struct SophiaHp {
  float b1, omb1, gamma, eps, wd, rho;
};

struct AdamHp {
  float b1, omb1, b2, omb2, eps, wd;
};

// Lion, SignGD and SGD (b1 is SGD's momentum; the others unused there)
struct MomentumHp {
  float b1, omb1, b2, omb2, wd;
};

enum MomentumRule { kLion = 0, kSignGD = 1, kSgd = 2 };

// 1 - lr wd, with lr wd rounded first (the plain version's two operations)
__device__ __forceinline__ float decay_of(float lr, float wd) {
  return __fsub_rn(1.0f, __fmul_rn(lr, wd));
}

// jnp.sign: 1, -1, 0 at +-0, NaN at NaN (torch.sign gives 0 there)
__device__ __forceinline__ float sign_of(float x) {
  return isnan(x) ? x : (float)((0.0f < x) - (x < 0.0f));
}

// the Adam-shaped update of AdamW and AdaHessian from m' and the second
// moment: p (1 - lr wd) - lr (m' / bc1) / (sqrt(v / bc2) + eps)
__device__ __forceinline__ float adam_update(float p, float mn, float v,
                                             float lr, float decay,
                                             float bc1, float bc2,
                                             float eps) {
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps);
  const float u = __fdiv_rn(__fdiv_rn(mn, bc1), den);
  return __fsub_rn(__fmul_rn(p, decay), __fmul_rn(lr, u));
}

// one Lion / SignGD / SGD element: returns p' and replaces m by m'
template <int RULE>
__device__ __forceinline__ float momentum_elem(float p, float& m, float g,
                                               float lr, float decay,
                                               const MomentumHp& hp) {
  if constexpr (RULE == kLion) {
    const float u =
        sign_of(__fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, g)));
    m = __fadd_rn(__fmul_rn(hp.b2, m), __fmul_rn(hp.omb2, g));
    return __fsub_rn(__fmul_rn(p, decay), __fmul_rn(lr, u));
  } else if constexpr (RULE == kSignGD) {
    m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, g));
    return __fsub_rn(__fmul_rn(p, decay), __fmul_rn(lr, sign_of(m)));
  } else {
    m = __fadd_rn(__fmul_rn(hp.b1, m), g);
    return __fsub_rn(p, __fmul_rn(lr, m));
  }
}

// one Sophia element: returns p', writes m' and adds the clip to cnt
__device__ __forceinline__ float sophia_elem(float p, float m, float h,
                                             float g, float lr, float decay,
                                             const SophiaHp& hp, float& m_out,
                                             int& cnt) {
  const float mn = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, g));
  const float den = clamp_min_nan(__fmul_rn(hp.gamma, h), hp.eps);
  const float raw = __fdiv_rn(mn, den);
  const float u = clamp_nan(raw, -hp.rho, hp.rho);
  cnt += fabsf(raw) >= hp.rho;
  m_out = mn;
  return __fsub_rn(__fmul_rn(p, decay), __fmul_rn(lr, u));
}

// the span of CUDA block blockIdx.x: [start, end) inside one reference
// block (rb); `span` and `block` are multiples of VEC
struct Span {
  long long start, end, rb;
};

__device__ __forceinline__ Span span_of(int block, int splits, int span) {
  Span s;
  s.rb = blockIdx.x / splits;
  const int part = blockIdx.x % splits;
  const long long base = s.rb * block;
  s.start = base + (long long)part * span;
  const long long stop = s.start + span;
  s.end = stop < base + block ? stop : base + block;
  return s;
}

// the CUDA block's clip count added once into nclip[rb]
__device__ __forceinline__ void flush_count(int cnt, int* nclip,
                                            long long rb) {
  __shared__ int warp_sum[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    if (total) atomicAdd(nclip + rb, total);
  }
}

template <typename P, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
sophia_step_kernel(const P* __restrict__ p, const S* __restrict__ m,
                   const S* __restrict__ h, const float* __restrict__ g,
                   const float* __restrict__ sc, P* __restrict__ p_out,
                   S* __restrict__ m_out, int* __restrict__ nclip, int block,
                   int splits, int span, SophiaHp hp) {
  const Span s = span_of(block, splits, span);
  const float lr = sc[0];
  const float decay = decay_of(lr, hp.wd);
  int cnt = 0;
  for (long long i = s.start + (long long)threadIdx.x * VEC; i < s.end;
       i += (long long)kThreads * VEC) {
    float vp[VEC], vm[VEC], vh[VEC], vg[VEC];
    load<VEC>(p, i, vp);
    load<VEC>(m, i, vm);
    load<VEC>(h, i, vh);
    load<VEC>(g, i, vg);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      vp[k] = sophia_elem(vp[k], vm[k], vh[k], vg[k], lr, decay, hp, vm[k],
                          cnt);
    store<VEC>(p_out, i, vp);
    store<VEC>(m_out, i, vm);
  }
  flush_count(cnt, nclip, s.rb);
}

template <typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
hessian_ema_kernel(const S* __restrict__ h, const float* __restrict__ e,
                   const float* __restrict__ sc, S* __restrict__ h_out,
                   int block, int splits, int span, int square, float b2,
                   float omb2) {
  const Span s = span_of(block, splits, span);
  const float scale = sc[0];
  for (long long i = s.start + (long long)threadIdx.x * VEC; i < s.end;
       i += (long long)kThreads * VEC) {
    float vh[VEC], ve[VEC];
    load<VEC>(h, i, vh);
    load<VEC>(e, i, ve);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float es = __fmul_rn(scale, ve[k]);
      if (square) es = __fmul_rn(es, es);
      vh[k] = __fadd_rn(__fmul_rn(b2, vh[k]), __fmul_rn(omb2, es));
    }
    store<VEC>(h_out, i, vh);
  }
}

template <typename P, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
sophia_refresh_kernel(const P* __restrict__ p, const S* __restrict__ m,
                      const S* __restrict__ h, const float* __restrict__ g,
                      const float* __restrict__ e,
                      const float* __restrict__ sc, P* __restrict__ p_out,
                      S* __restrict__ m_out, S* __restrict__ h_out,
                      int* __restrict__ nclip, int block, int splits,
                      int span, int flag, SophiaHp hp, float b2,
                      float omb2) {
  const Span s = span_of(block, splits, span);
  const float lr = sc[0];
  const float scale = sc[1];
  const float decay = decay_of(lr, hp.wd);
  int cnt = 0;
  for (long long i = s.start + (long long)threadIdx.x * VEC; i < s.end;
       i += (long long)kThreads * VEC) {
    float vp[VEC], vm[VEC], vh[VEC], vg[VEC];
    load<VEC>(p, i, vp);
    load<VEC>(m, i, vm);
    load<VEC>(h, i, vh);
    load<VEC>(g, i, vg);
    if (flag) {
      float ve[VEC];
      load<VEC>(e, i, ve);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        vh[k] = round_to<S>(__fadd_rn(__fmul_rn(b2, vh[k]),
                                      __fmul_rn(omb2,
                                                __fmul_rn(scale, ve[k]))));
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      vp[k] = sophia_elem(vp[k], vm[k], vh[k], vg[k], lr, decay, hp, vm[k],
                          cnt);
    store<VEC>(p_out, i, vp);
    store<VEC>(m_out, i, vm);
    store<VEC>(h_out, i, vh);
  }
  flush_count(cnt, nclip, s.rb);
}

template <typename P, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const P* __restrict__ p, const S* __restrict__ m,
             const S* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ sc, P* __restrict__ p_out,
             S* __restrict__ m_out, S* __restrict__ v_out, int block,
             int splits, int span, AdamHp hp) {
  const Span s = span_of(block, splits, span);
  const float lr = sc[0];
  const float bc1 = sc[1];
  const float bc2 = sc[2];
  const float decay = decay_of(lr, hp.wd);
  for (long long i = s.start + (long long)threadIdx.x * VEC; i < s.end;
       i += (long long)kThreads * VEC) {
    float vp[VEC], vm[VEC], vv[VEC], vg[VEC];
    load<VEC>(p, i, vp);
    load<VEC>(m, i, vm);
    load<VEC>(v, i, vv);
    load<VEC>(g, i, vg);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float gk = vg[k];
      const float mn = __fadd_rn(__fmul_rn(hp.b1, vm[k]),
                                 __fmul_rn(hp.omb1, gk));
      const float vn = __fadd_rn(__fmul_rn(hp.b2, vv[k]),
                                 __fmul_rn(hp.omb2, __fmul_rn(gk, gk)));
      vp[k] = adam_update(vp[k], mn, vn, lr, decay, bc1, bc2, hp.eps);
      vm[k] = mn;
      vv[k] = vn;
    }
    store<VEC>(p_out, i, vp);
    store<VEC>(m_out, i, vm);
    store<VEC>(v_out, i, vv);
  }
}

template <typename P, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
adahessian_kernel(const P* __restrict__ p, const S* __restrict__ m,
                  const S* __restrict__ v, const float* __restrict__ g,
                  const float* __restrict__ sc, P* __restrict__ p_out,
                  S* __restrict__ m_out, int block, int splits, int span,
                  AdamHp hp) {
  const Span s = span_of(block, splits, span);
  const float lr = sc[0];
  const float bc1 = sc[1];
  const float bc2 = sc[2];
  const float decay = decay_of(lr, hp.wd);
  for (long long i = s.start + (long long)threadIdx.x * VEC; i < s.end;
       i += (long long)kThreads * VEC) {
    float vp[VEC], vm[VEC], vv[VEC], vg[VEC];
    load<VEC>(p, i, vp);
    load<VEC>(m, i, vm);
    load<VEC>(v, i, vv);
    load<VEC>(g, i, vg);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      vm[k] = __fadd_rn(__fmul_rn(hp.b1, vm[k]), __fmul_rn(hp.omb1, vg[k]));
      vp[k] = adam_update(vp[k], vm[k], vv[k], lr, decay, bc1, bc2, hp.eps);
    }
    store<VEC>(p_out, i, vp);
    store<VEC>(m_out, i, vm);
  }
}

template <typename P, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
adahessian_refresh_kernel(const P* __restrict__ p, const S* __restrict__ m,
                          const S* __restrict__ v,
                          const float* __restrict__ g,
                          const float* __restrict__ e,
                          const float* __restrict__ sc,
                          P* __restrict__ p_out, S* __restrict__ m_out,
                          S* __restrict__ v_out, int block, int splits,
                          int span, int flag, AdamHp hp) {
  const Span s = span_of(block, splits, span);
  const float lr = sc[0];
  const float scale = sc[1];
  const float bc1 = sc[2];
  const float bc2 = sc[3];
  const float decay = decay_of(lr, hp.wd);
  for (long long i = s.start + (long long)threadIdx.x * VEC; i < s.end;
       i += (long long)kThreads * VEC) {
    float vp[VEC], vm[VEC], vv[VEC], vg[VEC];
    load<VEC>(p, i, vp);
    load<VEC>(m, i, vm);
    load<VEC>(v, i, vv);
    load<VEC>(g, i, vg);
    if (flag) {
      float ve[VEC];
      load<VEC>(e, i, ve);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float es = __fmul_rn(scale, ve[k]);
        vv[k] = round_to<S>(__fadd_rn(__fmul_rn(hp.b2, vv[k]),
                                      __fmul_rn(hp.omb2, __fmul_rn(es, es))));
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      vm[k] = __fadd_rn(__fmul_rn(hp.b1, vm[k]), __fmul_rn(hp.omb1, vg[k]));
      vp[k] = adam_update(vp[k], vm[k], vv[k], lr, decay, bc1, bc2, hp.eps);
    }
    store<VEC>(p_out, i, vp);
    store<VEC>(m_out, i, vm);
    store<VEC>(v_out, i, vv);
  }
}

// Lion, SignGD and SGD: p, m and g in, p' and m' out
template <int RULE, typename P, typename S, int VEC>
__device__ __forceinline__ void momentum_sweep(
    const P* __restrict__ p, const S* __restrict__ m,
    const float* __restrict__ g, const float* __restrict__ sc,
    P* __restrict__ p_out, S* __restrict__ m_out, int block, int splits,
    int span, const MomentumHp& hp) {
  const Span s = span_of(block, splits, span);
  const float lr = sc[0];
  const float decay = decay_of(lr, hp.wd);
  for (long long i = s.start + (long long)threadIdx.x * VEC; i < s.end;
       i += (long long)kThreads * VEC) {
    float vp[VEC], vm[VEC], vg[VEC];
    load<VEC>(p, i, vp);
    load<VEC>(m, i, vm);
    load<VEC>(g, i, vg);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      vp[k] = momentum_elem<RULE>(vp[k], vm[k], vg[k], lr, decay, hp);
    store<VEC>(p_out, i, vp);
    store<VEC>(m_out, i, vm);
  }
}

#define SU_MOMENTUM_KERNEL(NAME, RULE)                                       \
  template <typename P, typename S, int VEC>                                 \
  __global__ void __launch_bounds__(kThreads)                                \
      NAME(const P* __restrict__ p, const S* __restrict__ m,                 \
           const float* __restrict__ g, const float* __restrict__ sc,        \
           P* __restrict__ p_out, S* __restrict__ m_out, int block,          \
           int splits, int span, MomentumHp hp) {                            \
    momentum_sweep<RULE, P, S, VEC>(p, m, g, sc, p_out, m_out, block,        \
                                    splits, span, hp);                       \
  }

SU_MOMENTUM_KERNEL(lion_kernel, kLion)
SU_MOMENTUM_KERNEL(signgd_kernel, kSignGD)
SU_MOMENTUM_KERNEL(sgd_kernel, kSgd)

// launch geometry: `splits` CUDA blocks per reference block, each over a
// span of up to kTilesPerBlock tiles (a multiple of vec)
struct Grid {
  long long blocks;
  int splits, span;
};

inline Grid grid_of(long long n, int block, int vec) {
  Grid gr;
  const int per = kThreads * vec * kTilesPerBlock;
  gr.splits = block / per > 1 ? block / per : 1;
  const int sp = (block + gr.splits - 1) / gr.splits;
  gr.span = (sp + vec - 1) / vec * vec;
  gr.blocks = (n / block) * gr.splits;
  return gr;
}

template <typename P, typename S>
int sophia_step_typed(const void* p, const void* m, const void* h,
                      const void* g, const void* sc, void* p_out,
                      void* m_out, void* nclip, long long n, int block,
                      SophiaHp hp, cudaStream_t stream) {
  constexpr int VEC = (sizeof(P) == 2 || sizeof(S) == 2) ? 8 : 4;
  const Grid gr = grid_of(n, block, VEC);
  if (gr.blocks > 0)
    sophia_step_kernel<P, S, VEC><<<(unsigned)gr.blocks, kThreads, 0,
                                    stream>>>(
        (const P*)p, (const S*)m, (const S*)h, (const float*)g,
        (const float*)sc, (P*)p_out, (S*)m_out, (int*)nclip, block,
        gr.splits, gr.span, hp);
  return (int)cudaGetLastError();
}

template <typename S>
int hessian_ema_typed(const void* h, const void* e, const void* sc,
                      void* h_out, long long n, int block, int square,
                      float b2, float omb2, cudaStream_t stream) {
  constexpr int VEC = sizeof(S) == 2 ? 8 : 4;
  const Grid gr = grid_of(n, block, VEC);
  if (gr.blocks > 0)
    hessian_ema_kernel<S, VEC><<<(unsigned)gr.blocks, kThreads, 0, stream>>>(
        (const S*)h, (const float*)e, (const float*)sc, (S*)h_out, block,
        gr.splits, gr.span, square, b2, omb2);
  return (int)cudaGetLastError();
}

template <typename P, typename S>
int sophia_refresh_typed(const void* p, const void* m, const void* h,
                         const void* g, const void* e, const void* sc,
                         void* p_out, void* m_out, void* h_out, void* nclip,
                         long long n, int block, int flag, SophiaHp hp,
                         float b2, float omb2, cudaStream_t stream) {
  constexpr int VEC = (sizeof(P) == 2 || sizeof(S) == 2) ? 8 : 4;
  const Grid gr = grid_of(n, block, VEC);
  if (gr.blocks > 0)
    sophia_refresh_kernel<P, S, VEC><<<(unsigned)gr.blocks, kThreads, 0,
                                       stream>>>(
        (const P*)p, (const S*)m, (const S*)h, (const float*)g,
        (const float*)e, (const float*)sc, (P*)p_out, (S*)m_out, (S*)h_out,
        (int*)nclip, block, gr.splits, gr.span, flag, hp, b2, omb2);
  return (int)cudaGetLastError();
}

template <typename P, typename S>
int adamw_typed(const void* p, const void* m, const void* v, const void* g,
                const void* sc, void* p_out, void* m_out, void* v_out,
                long long n, int block, AdamHp hp, cudaStream_t stream) {
  constexpr int VEC = (sizeof(P) == 2 || sizeof(S) == 2) ? 8 : 4;
  const Grid gr = grid_of(n, block, VEC);
  if (gr.blocks > 0)
    adamw_kernel<P, S, VEC><<<(unsigned)gr.blocks, kThreads, 0, stream>>>(
        (const P*)p, (const S*)m, (const S*)v, (const float*)g,
        (const float*)sc, (P*)p_out, (S*)m_out, (S*)v_out, block, gr.splits,
        gr.span, hp);
  return (int)cudaGetLastError();
}

template <typename P, typename S>
int adahessian_typed(const void* p, const void* m, const void* v,
                     const void* g, const void* sc, void* p_out, void* m_out,
                     long long n, int block, AdamHp hp, cudaStream_t stream) {
  constexpr int VEC = (sizeof(P) == 2 || sizeof(S) == 2) ? 8 : 4;
  const Grid gr = grid_of(n, block, VEC);
  if (gr.blocks > 0)
    adahessian_kernel<P, S, VEC><<<(unsigned)gr.blocks, kThreads, 0,
                                   stream>>>(
        (const P*)p, (const S*)m, (const S*)v, (const float*)g,
        (const float*)sc, (P*)p_out, (S*)m_out, block, gr.splits, gr.span,
        hp);
  return (int)cudaGetLastError();
}

template <typename P, typename S>
int adahessian_refresh_typed(const void* p, const void* m, const void* v,
                             const void* g, const void* e, const void* sc,
                             void* p_out, void* m_out, void* v_out,
                             long long n, int block, int flag, AdamHp hp,
                             cudaStream_t stream) {
  constexpr int VEC = (sizeof(P) == 2 || sizeof(S) == 2) ? 8 : 4;
  const Grid gr = grid_of(n, block, VEC);
  if (gr.blocks > 0)
    adahessian_refresh_kernel<P, S, VEC><<<(unsigned)gr.blocks, kThreads, 0,
                                           stream>>>(
        (const P*)p, (const S*)m, (const S*)v, (const float*)g,
        (const float*)e, (const float*)sc, (P*)p_out, (S*)m_out, (S*)v_out,
        block, gr.splits, gr.span, flag, hp);
  return (int)cudaGetLastError();
}

#define SU_MOMENTUM_TYPED(NAME, KERNEL)                                      \
  template <typename P, typename S>                                          \
  int NAME(const void* p, const void* m, const void* g, const void* sc,      \
           void* p_out, void* m_out, long long n, int block, MomentumHp hp,  \
           cudaStream_t stream) {                                            \
    constexpr int VEC = (sizeof(P) == 2 || sizeof(S) == 2) ? 8 : 4;          \
    const Grid gr = grid_of(n, block, VEC);                                  \
    if (gr.blocks > 0)                                                       \
      KERNEL<P, S, VEC><<<(unsigned)gr.blocks, kThreads, 0, stream>>>(       \
          (const P*)p, (const S*)m, (const float*)g, (const float*)sc,       \
          (P*)p_out, (S*)m_out, block, gr.splits, gr.span, hp);              \
    return (int)cudaGetLastError();                                          \
  }

SU_MOMENTUM_TYPED(lion_typed, lion_kernel)
SU_MOMENTUM_TYPED(signgd_typed, signgd_kernel)
SU_MOMENTUM_TYPED(sgd_typed, sgd_kernel)

}  // namespace sophia_update

using namespace sophia_update;

// p_bf16 / s_bf16 select the instance: p in {fp32, bf16} x state in
// {fp32, bf16}
#define SU_DISPATCH(FN, ...)                                      \
  (p_bf16 ? (s_bf16 ? FN<bf16, bf16>(__VA_ARGS__)                 \
                    : FN<bf16, float>(__VA_ARGS__))               \
          : (s_bf16 ? FN<float, bf16>(__VA_ARGS__)                \
                    : FN<float, float>(__VA_ARGS__)))

extern "C" {

int sophia_step_launch(const void* p, const void* m, const void* h,
                       const void* g, const void* sc, void* p_out,
                       void* m_out, void* nclip, long long n, int block,
                       int p_bf16, int s_bf16, float b1, float omb1,
                       float gamma, float eps, float wd, float rho,
                       void* stream) {
  const SophiaHp hp{b1, omb1, gamma, eps, wd, rho};
  return SU_DISPATCH(sophia_step_typed, p, m, h, g, sc, p_out, m_out, nclip,
                     n, block, hp, (cudaStream_t)stream);
}

int hessian_ema_launch(const void* h, const void* e, const void* sc,
                       void* h_out, long long n, int block, int s_bf16,
                       int square, float b2, float omb2, void* stream) {
  return s_bf16 ? hessian_ema_typed<bf16>(h, e, sc, h_out, n, block, square,
                                          b2, omb2, (cudaStream_t)stream)
                : hessian_ema_typed<float>(h, e, sc, h_out, n, block, square,
                                           b2, omb2, (cudaStream_t)stream);
}

int sophia_refresh_launch(const void* p, const void* m, const void* h,
                          const void* g, const void* e, const void* sc,
                          void* p_out, void* m_out, void* h_out, void* nclip,
                          long long n, int block, int p_bf16, int s_bf16,
                          int flag, float b1, float omb1, float b2,
                          float omb2, float gamma, float eps, float wd,
                          float rho, void* stream) {
  const SophiaHp hp{b1, omb1, gamma, eps, wd, rho};
  return SU_DISPATCH(sophia_refresh_typed, p, m, h, g, e, sc, p_out, m_out,
                     h_out, nclip, n, block, flag, hp, b2, omb2,
                     (cudaStream_t)stream);
}

int adamw_launch(const void* p, const void* m, const void* v, const void* g,
                 const void* sc, void* p_out, void* m_out, void* v_out,
                 long long n, int block, int p_bf16, int s_bf16, float b1,
                 float omb1, float b2, float omb2, float eps, float wd,
                 void* stream) {
  const AdamHp hp{b1, omb1, b2, omb2, eps, wd};
  return SU_DISPATCH(adamw_typed, p, m, v, g, sc, p_out, m_out, v_out, n,
                     block, hp, (cudaStream_t)stream);
}

int adahessian_step_launch(const void* p, const void* m, const void* v,
                           const void* g, const void* sc, void* p_out,
                           void* m_out, long long n, int block, int p_bf16,
                           int s_bf16, float b1, float omb1, float b2,
                           float omb2, float eps, float wd, void* stream) {
  const AdamHp hp{b1, omb1, b2, omb2, eps, wd};
  return SU_DISPATCH(adahessian_typed, p, m, v, g, sc, p_out, m_out, n,
                     block, hp, (cudaStream_t)stream);
}

int adahessian_refresh_launch(const void* p, const void* m, const void* v,
                              const void* g, const void* e, const void* sc,
                              void* p_out, void* m_out, void* v_out,
                              long long n, int block, int p_bf16, int s_bf16,
                              int flag, float b1, float omb1, float b2,
                              float omb2, float eps, float wd,
                              void* stream) {
  const AdamHp hp{b1, omb1, b2, omb2, eps, wd};
  return SU_DISPATCH(adahessian_refresh_typed, p, m, v, g, e, sc, p_out,
                     m_out, v_out, n, block, flag, hp, (cudaStream_t)stream);
}

// lion: (b1, omb1, b2, omb2, wd); signgd: (b1, omb1, -, -, wd); sgd: (mu,
// -, -, -, 0)
#define SU_MOMENTUM_LAUNCH(NAME, TYPED)                                      \
  int NAME(const void* p, const void* m, const void* g, const void* sc,      \
           void* p_out, void* m_out, long long n, int block, int p_bf16,     \
           int s_bf16, float b1, float omb1, float b2, float omb2, float wd, \
           void* stream) {                                                   \
    const MomentumHp hp{b1, omb1, b2, omb2, wd};                             \
    return SU_DISPATCH(TYPED, p, m, g, sc, p_out, m_out, n, block, hp,       \
                       (cudaStream_t)stream);                                \
  }

SU_MOMENTUM_LAUNCH(lion_launch, lion_typed)
SU_MOMENTUM_LAUNCH(signgd_launch, signgd_typed)
SU_MOMENTUM_LAUNCH(sgd_launch, sgd_typed)

}  // extern "C"
