// Variants of the bf16-h CE forward's kernel, kept for
// tests/_ce_forward_compare.py (the package does not build them).  Each
// section (its first line names it) replaces csrc/fused_ce.cu's text from
// its line "// ---- the forward's feed, products and kernel" to the prep
// kernels; everything above that line (the walk, the fold) is shared.

// ==== variant cooperative
// The kernel before the producer warp: 256 threads, the two consumer
// warpgroups sharing the ring, each one's first thread refilling its half
// of a released stage (h_n's boxes or W's), so warp 0 of each warpgroup
// waits on every stage's empty barrier.
constexpr int kFwdThreads = 256;  // two warpgroups
constexpr int kFwdRing = 3;       // 128-deep stages
constexpr int kFwdK = 2 * kWgBK;  // k of a stage: two promotions
constexpr int kFwdHBox = 128;     // rows of h_n's TMA box
// a stage: h_n 128 x 128 and W 128 x 128, each two 64-deep halves
constexpr int kFwdStageBytes = 4 * kTileBytes;
// the ring, 1024 bytes to align it, its full and empty barriers
constexpr int kFwdSmem = kFwdRing * kFwdStageBytes + 1024 + 2 * kFwdRing * 8;

// A position in the walk: unit u (f), vocab tile v, stage kb of the tile;
// and the ring slot it loads into.
struct FwdCursor {
  FwdUnit f;
  int u, v, kb, stage;
  uint32_t phase;
};

__device__ __forceinline__ void fwd_start(FwdCursor& c, const FwdPlan& p) {
  c.u = blockIdx.x;
  c.f = fwd_unit(p, c.u);
  c.v = c.f.v0;
  c.kb = c.stage = 0;
  c.phase = 0;
}

// The next stage of the walk: the next 128 of k, tile or unit.
__device__ __forceinline__ void fwd_advance(FwdCursor& c, const FwdPlan& p) {
  if (++c.stage == kFwdRing) {
    c.stage = 0;
    c.phase ^= 1;
  }
  if (++c.kb < p.nk) return;
  c.kb = 0;
  if (++c.v < c.f.v1) return;
  c.u += gridDim.x;
  c.f = fwd_unit(p, c.u);
  c.v = c.f.v0;
}

// A loader (warpgroup g's first thread): its half of the stage at cursor c
// (g 0: h_n's two boxes, g 1: W's) into the stage's ring slot once every
// warp has released the slot, then the next position.  Nothing past the
// walk's end.
template <bool B_MN>
__device__ __forceinline__ void fwd_load(FwdCursor& c, const FwdPlan& p,
                                         const Maps& maps, int units,
                                         unsigned char* ring, uint64_t* full,
                                         uint64_t* empty, int g) {
  if (c.u >= units) return;
  mbar_wait(&empty[c.stage], c.phase ^ 1);
  unsigned char* st = ring + c.stage * kFwdStageBytes;
  uint64_t* bar = &full[c.stage];
  mbar_expect_tx(bar, 2 * kTileBytes);
  const int k0 = c.kb * kFwdK;
  if (g == 0) {
    load_tile<false>(st, &maps.a_hi, bar, c.f.m0, k0);
    load_tile<false>(st + kTileBytes, &maps.a_hi, bar, c.f.m0, k0 + kWgBK);
  } else {
    unsigned char* sb = st + 2 * kTileBytes;
    load_tile<B_MN>(sb, &maps.b_hi, bar, c.v * kWgBN, k0);
    load_tile<B_MN>(sb + kTileBytes, &maps.b_hi, bar, c.v * kWgBN,
                    k0 + kWgBK);
  }
  fwd_advance(c, p);
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
      mbar_init(&full[s], 2);   // each loader's expect_tx, then the bytes
      mbar_init(&empty[s], 8);  // lane 0 of every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int units = p.n_rt * p.k;
  const int g = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int q = lane % 4;
  const int rl = 64 * g + 16 * warp + lane / 4;  // the thread's first row
  const bool loader = threadIdx.x % 128 == 0;
  FwdCursor c;
  fwd_start(c, p);
  if (loader)
    for (int s = 0; s < kFwdRing; ++s)
      fwd_load<B_MN>(c, p, maps, units, ring, full, empty, g);

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
          if (loader) fwd_load<B_MN>(c, p, maps, units, ring, full, empty, g);
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
      if (loader) fwd_load<B_MN>(c, p, maps, units, ring, full, empty, g);
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


// ==== variant pingpong
// The ping-pong with a producer warp: warpgroup 2 gives its registers to
// the consumers (setmaxnreg) and its first thread keeps one ring of
// kFwdRing 128-deep stages full in the order the consumers take them;
// consumer warpgroup g owns rows 64 g.. of every 128 x 128 tile (a stage:
// its 64 rows of h_n and the whole W tile, 48 KB), and the two run their
// products in turns (two mbarriers), so that one folds a tile while the
// other's wgmmas run.
// kFwdParts 1: one part, the wgmmas waited for before each promotion;
// 2 (the compare script's pingpong_2part): two parts alternate as in the
// committed kernel.
constexpr int kFwdParts = 1;
constexpr int kFwdThreads = 384;  // two consumer warpgroups, one producer
constexpr int kFwdRing = 4;       // 128-deep stages (a power of two)
constexpr int kFwdK = 2 * kWgBK;  // k of a stage: two promotions
constexpr int kFwdHBox = 64;      // rows of h_n's TMA box: a warpgroup's
constexpr int kFwdHBytes = kTileBytes / 2;  // h_n's 64 x 64 box
// a stage: h_n 64 x 128 and W 128 x 128, each two 64-deep halves
constexpr int kFwdStageBytes = 2 * kFwdHBytes + 2 * kTileBytes;
// the ring, 1024 bytes to align it, its full and empty barriers and the
// two turn barriers
constexpr int kFwdSmem =
    kFwdRing * kFwdStageBytes + 1024 + (2 * kFwdRing + 2) * 8;
constexpr int kFwdConsumerRegs = 240, kFwdProducerRegs = 24;  // 2 x 128 x
                                                              // 240 + 128 x
                                                              // 24 <= 64 K

// The producer: every stage of the block's walk in the consumers' order
// (per tile: warpgroup 0's nk stages, then warpgroup 1's), each into slot
// pos % kFwdRing once its last reader has released it.
template <bool B_MN>
__device__ __forceinline__ void fwd_produce(const Maps& maps,
                                            const FwdPlan& p, int units,
                                            unsigned char* ring,
                                            uint64_t* full,
                                            uint64_t* empty) {
  uint32_t pos = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const FwdUnit f = fwd_unit(p, u);
    for (int v = f.v0; v < f.v1; ++v)
      for (int half = 0; half < 2; ++half)
        for (int kb = 0; kb < p.nk; ++kb, ++pos) {
          const int s = pos % kFwdRing;
          mbar_wait(&empty[s], ((pos / kFwdRing) & 1) ^ 1);
          unsigned char* st = ring + s * kFwdStageBytes;
          uint64_t* bar = &full[s];
          mbar_expect_tx(bar, kFwdStageBytes);
          const int k0 = kb * kFwdK, r0 = f.m0 + 64 * half;
          tma_load(st, &maps.a_hi, bar, k0, r0);
          tma_load(st + kFwdHBytes, &maps.a_hi, bar, k0 + kWgBK, r0);
          unsigned char* sb = st + 2 * kFwdHBytes;
          load_tile<B_MN>(sb, &maps.b_hi, bar, v * kWgBN, k0);
          load_tile<B_MN>(sb + kTileBytes, &maps.b_hi, bar, v * kWgBN,
                          k0 + kWgBK);
        }
  }
}

// The four m64n128k16 wgmmas of 64-deep half h of a stage into d (d = the
// half's product), one commit group: h_n's half 8 KB on (512 in a
// descriptor's address field), W's 16 KB (1024).
template <bool B_MN>
__device__ __forceinline__ void issue_half(float (&d)[64], uint64_t da,
                                           uint64_t db, int h) {
  hold(d);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kWgBK / 16; ++s)
    wgmma_n128<0, B_MN>(d, da + 512 * h + 2 * s,
                        db + 1024 * h + (B_MN ? 128 : 2) * s, s > 0);
  wgmma_commit();
}

__device__ __forceinline__ void promote(float (&acc)[64], float (&d)[64]) {
  hold(d);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

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
  uint64_t* turn = empty + kFwdRing;  // warpgroup g waits on turn[g]
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdRing; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx, then the bytes
      mbar_init(&empty[s], 4);  // lane 0 of each warp of its warpgroup
    }
    mbar_init(&turn[0], 4);
    mbar_init(&turn[1], 4);
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
  float acc[64], part0[64], part1[64];  // part1 unused with one part
#pragma unroll
  for (int i = 0; i < 64; ++i) part0[i] = part1[i] = 0.0f;
  // this warpgroup's next stage in the walk: per tile, warpgroup 0's nk
  // stages, then warpgroup 1's
  uint32_t pos = g * p.nk;
  int turns = 0;
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
      // warpgroup 0's turn i follows warpgroup 1's turn i - 1 (a fresh
      // barrier's phase before the first counts as completed: parity 1),
      // warpgroup 1's turn i follows warpgroup 0's turn i.  The turns also
      // keep each full wait at most one phase behind its slot.
      mbar_wait(&turn[g], g == 0 ? (turns & 1) ^ 1 : turns & 1);
      int prev = 0;
      for (int kb = 0; kb < p.nk; ++kb, ++pos) {
        const int s = pos % kFwdRing;
        mbar_wait(&full[s], (pos / kFwdRing) & 1);
        unsigned char* st = ring + s * kFwdStageBytes;
        const uint64_t da = wg_desc_k<false>(st, 0);
        const uint64_t db = wg_desc_k<B_MN>(st + 2 * kFwdHBytes, 0);
        if constexpr (kFwdParts == 2) {
          issue_half<B_MN>(part0, da, db, 0);
          if (kb > 0) {
            wgmma_wait<1>();
            promote(acc, part1);
            if (lane == 0) mbar_arrive(&empty[prev]);
          }
          issue_half<B_MN>(part1, da, db, 1);
          if (kb == p.nk - 1 && lane == 0) mbar_arrive(&turn[g ^ 1]);
          wgmma_wait<1>();
          promote(acc, part0);
          prev = s;
        } else {
          issue_half<B_MN>(part0, da, db, 0);
          wgmma_wait<0>();
          promote(acc, part0);
          issue_half<B_MN>(part0, da, db, 1);
          if (kb == p.nk - 1 && lane == 0) mbar_arrive(&turn[g ^ 1]);
          wgmma_wait<0>();
          promote(acc, part0);
          if (lane == 0) mbar_arrive(&empty[s]);
        }
      }
      if constexpr (kFwdParts == 2) {
        wgmma_wait<0>();
        promote(acc, part1);
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      pos += p.nk;  // the other warpgroup's stages of the tile
      ++turns;
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


