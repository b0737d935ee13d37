// The epilogue every MX GEMM kernel stores through (mx_store), and the
// serial K chain of the fused GEMM's decode-height (M <= 16) 2:4 and ABFT
// rows: masked operand staging through shared memory, the 2:4 weight
// staging and the hooked register MAC chain (sweep_k_variant), which keeps
// them bitwise equal to the dense decode tile (csrc/decode_tile.cuh).
//
// A is (M, K) row-major, B is (K, N) row-major (the JAX layout: w is
// (d_in, d_out), read as stored, no transpose).  Ragged M/N/K edges are
// masked at the load (zero fill) and at the store, so no padded copies are
// made.  A and B may have different types (TA, TB): each is read from global
// memory in its own width (an int8 or fp8 weight moves 1 byte per element)
// and widened in registers on its way into shared memory, to the staging
// type S, which is also the accumulator's.  S is float for every pair but
// int8 x int8, where it is int: the products then sum in an exact int32 MAC
// over the whole K loop (|sum| <= K * 127^2, under 2^31 for K < 133,143),
// as JAX's dot_f32 takes its int32 MAC.
#pragma once

#include <type_traits>

#include "common.cuh"

// A payload element widened to the staging / accumulator type S.
template <typename S, typename T>
__device__ __forceinline__ S widen(T x) {
  if constexpr (std::is_same<S, int>::value)
    return static_cast<int>(x);  // int8 into the exact int32 MAC
  else
    return to_f32(x);
}

__device__ __forceinline__ float mac(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mac(int a, int b, int c) { return a * b + c; }

// The single write-back of one output element (gm, gn) of the MX GEMM: the
// dequant scales and the epilogue applied to the finished accumulator y
// (and the gate's, with GATE) in f32, in the order of kernels/mx_matmul.py's
// Epilogue.  Each step rounds on its own (__fmul_rn / __fadd_rn are never
// contracted into an FMA), so every kernel that stores through it -- the
// dense decode and prefill tiles, the 2:4 and ABFT variants -- turns the
// same accumulator into the same bits.  R: any argument struct with these
// fields (csrc/mx_matmul.cu Args, csrc/mx_matmul.cuh GemmArgs).
template <bool GATE, typename R>
__device__ __forceinline__ void mx_store(const R& r, float y, float gate, int gm, int gn) {
  if (r.a_scale != nullptr) {
    const float as = r.a_scale[gm];
    y = __fmul_rn(y, as);
    gate = __fmul_rn(gate, as);
  }
  if (r.b_scale != nullptr) y = __fmul_rn(y, r.b_scale[gn]);
  if (r.bias != nullptr) y = __fadd_rn(y, load_dt(r.bias, r.bias_dt, gn));
  if constexpr (GATE) {
    if (r.bg_scale != nullptr) gate = __fmul_rn(gate, r.bg_scale[gn]);
    y = __fmul_rn(silu_f(gate), y);
  } else {
    y = activation_f(y, r.act);
  }
  const int64_t o = (int64_t)gm * r.N + gn;
  if (r.res != nullptr) y = __fadd_rn(y, load_dt(r.res, r.res_dt, o));
  if (r.has_scale) y = __fmul_rn(y, r.out_scale);
  store_dt(r.out, r.out_dt, o, y);
}

template <int BM, int BN, int BK, int TM, int TN>
struct TileCfg {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kTX = BN / TN;  // threads along n
  static constexpr int kAPer = (BM * BK + kThreads - 1) / kThreads;
  static constexpr int kBPer = (BK * BN + kThreads - 1) / kThreads;
  static_assert(BM % TM == 0 && BN % TN == 0, "tile must divide");
};

// Global -> registers for one K step: A elements walk k fastest and B
// elements walk n fastest, so neighbouring threads read neighbouring
// addresses of one row.
template <typename Cfg, int BM, int BK, typename S, typename T>
__device__ __forceinline__ void load_a(S (&ra)[Cfg::kAPer], const T* __restrict__ A,
                                       int M, int K, int m0, int k0) {
#pragma unroll
  for (int r = 0; r < Cfg::kAPer; ++r) {
    const int e = threadIdx.x + r * Cfg::kThreads;
    const int m = e / BK, k = e % BK;
    const int gm = m0 + m, gk = k0 + k;
    ra[r] = (e < BM * BK && gm < M && gk < K) ? widen<S>(A[(int64_t)gm * K + gk]) : S(0);
  }
}

template <typename Cfg, int BN, int BK, typename S, typename T>
__device__ __forceinline__ void load_b(S (&rb)[Cfg::kBPer], const T* __restrict__ B,
                                       int N, int K, int n0, int k0) {
#pragma unroll
  for (int r = 0; r < Cfg::kBPer; ++r) {
    const int e = threadIdx.x + r * Cfg::kThreads;
    const int k = e / BN, n = e % BN;
    const int gk = k0 + k, gn = n0 + n;
    rb[r] = (e < BK * BN && gk < K && gn < N) ? widen<S>(B[(int64_t)gk * N + gn]) : S(0);
  }
}

// Registers -> shared memory.  A is stored transposed (As[k][m], one pad
// column against bank conflicts) so the FMA loop reads a column of A and a
// row of B at the same k.
template <typename Cfg, int BM, int BK, typename S>
__device__ __forceinline__ void store_a(S (*As)[BM + 1], const S (&ra)[Cfg::kAPer]) {
#pragma unroll
  for (int r = 0; r < Cfg::kAPer; ++r) {
    const int e = threadIdx.x + r * Cfg::kThreads;
    if (e < BM * BK) As[e % BK][e / BK] = ra[r];
  }
}

template <typename Cfg, int BN, int BK, typename S>
__device__ __forceinline__ void store_b(S (*Bs)[BN], const S (&rb)[Cfg::kBPer]) {
#pragma unroll
  for (int r = 0; r < Cfg::kBPer; ++r) {
    const int e = threadIdx.x + r * Cfg::kThreads;
    if (e < BK * BN) Bs[e / BN][e % BN] = rb[r];
  }
}

// One staged K step of MACs into the thread's (TM x TN) register tile.
// Thread (tx, ty) owns rows ty*TM + i and columns tx + j*TX: neighbouring
// threads read neighbouring B columns (no bank conflicts) and write
// neighbouring output columns (coalesced stores).
template <typename Cfg, int BM, int BN, int BK, int TM, int TN, bool GATE, typename S>
__device__ __forceinline__ void fma_tile(S (&acc)[TM][TN], S (&accg)[TM][TN],
                                         S (*As)[BM + 1], S (*Bs)[BN], S (*Bgs)[BN], int tx,
                                         int ty) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    S av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = As[k][ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx + j * Cfg::kTX];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = mac(av[i], bv[j], acc[i][j]);
    if constexpr (GATE) {
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bgs[k][tx + j * Cfg::kTX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) accg[i][j] = mac(av[i], bv[j], accg[i][j]);
    }
  }
}

// The B operand's staging for one K step, 2:4 sparse (stage 1c / 5c): the
// step's BK/2 payload rows of the (K/2, N) payload, read in the payload's
// own width, and its BK/8 rows of the (K/8, N) uint8 metadata, expanded
// into the same dense (BK x BN) shared tile with kernels/sparse.expand_24's
// compare-select rule: dense row 8b + 4h + j = (i0 == j ? p[4b + 2h] : 0) +
// (i1 == j ? p[4b + 2h + 1] : 0), nibble h of metadata byte b holding
// (i0, i1).  The widened values are those the dense kernel stages from
// expand_24's weight, so fma_tile runs unchanged and the product is
// bitwise the dense kernel's.  One work item is (metadata byte, column):
// 1 byte and 4 payload values in, 8 dense rows out; neighbouring threads
// take neighbouring columns.  K % 8 == 0 (the wrapper checks); rows past K
// expand from zero payload.
template <typename Cfg, int BN, int BK>
struct Sparse24 {
  static_assert(BK % 8 == 0, "a 2:4 K step must cover whole metadata bytes");
  static constexpr int kItems = (BK / 8) * BN;
  static constexpr int kPer = (kItems + Cfg::kThreads - 1) / Cfg::kThreads;
};

template <typename Cfg, int BN, int BK, typename S, typename T>
__device__ __forceinline__ void load_b24(uint8_t (&m)[Sparse24<Cfg, BN, BK>::kPer],
                                         S (&p)[Sparse24<Cfg, BN, BK>::kPer][4],
                                         const T* __restrict__ P,
                                         const uint8_t* __restrict__ Mt, int N, int K,
                                         int n0, int k0) {
  using Sp = Sparse24<Cfg, BN, BK>;
#pragma unroll
  for (int r = 0; r < Sp::kPer; ++r) {
    const int e = threadIdx.x + r * Cfg::kThreads;
    const int gb = k0 / 8 + e / BN, gn = n0 + e % BN;
    const bool ok = e < Sp::kItems && gb < K / 8 && gn < N;
    m[r] = ok ? Mt[(int64_t)gb * N + gn] : 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[r][q] = ok ? widen<S>(P[((int64_t)gb * 4 + q) * N + gn]) : S(0);
  }
}

template <typename Cfg, int BN, int BK, typename S>
__device__ __forceinline__ void store_b24(S (*Bs)[BN],
                                          const uint8_t (&m)[Sparse24<Cfg, BN, BK>::kPer],
                                          const S (&p)[Sparse24<Cfg, BN, BK>::kPer][4]) {
  using Sp = Sparse24<Cfg, BN, BK>;
#pragma unroll
  for (int r = 0; r < Sp::kPer; ++r) {
    const int e = threadIdx.x + r * Cfg::kThreads;
    if (e >= Sp::kItems) continue;
    const int b = e / BN, n = e % BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nib = h ? (m[r] >> 4) : (m[r] & 0xF);
      const int i0 = nib & 3, i1 = (nib >> 2) & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Bs[8 * b + 4 * h + j][n] =
            (i0 == j ? p[r][2 * h] : S(0)) + (i1 == j ? p[r][2 * h + 1] : S(0));
    }
  }
}

// What runs beside each staged K step's MACs: nothing (NoHook), or the
// ABFT checksums (abft_tile.cuh).  Both K loops take it: gemm_tile.cuh's
// passes the staged tiles, prefill_tile.cuh's the staged slot.
struct NoHook {
  template <typename... Staged>
  __device__ __forceinline__ void step(Staged...) {}
};

// The whole K loop of one (BM x BN) output tile of the 2:4 and ABFT
// variants at decode height (csrc/mx_matmul.cuh): the register accumulators
// (type S) are zeroed (the C-tile reset) and never reloaded; A (type TA)
// and B and the gate weight Bg (type TB) -- dense or, with SPARSE, their
// 2:4 payloads with metadata Bm / Bgm -- stage through shared memory one BK
// step at a time, the next step's operands fetched into registers while the
// current step's MACs run; `hook.step` (NoHook, or the ABFT checksums of
// abft_tile.cuh) sees each staged step after its MACs (all threads call
// it).  A is read for rows < M, B for columns < N.
template <typename S, typename TA, typename TB, int BM, int BN, int BK, int TM, int TN,
          bool GATE, bool SPARSE, typename Hook>
__device__ __forceinline__ void sweep_k_variant(S (&acc)[TM][TN], S (&accg)[TM][TN],
                                        S (*As)[BM + 1], S (*Bs)[BN], S (*Bgs)[BN],
                                        const TA* __restrict__ A, const TB* __restrict__ B,
                                        const TB* __restrict__ Bg,
                                        const uint8_t* __restrict__ Bm,
                                        const uint8_t* __restrict__ Bgm, Hook& hook, int M,
                                        int N, int K, int m0, int n0, int tx, int ty) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  using Sp = Sparse24<Cfg, BN, SPARSE ? BK : 8>;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = accg[i][j] = S(0);

  S ra[Cfg::kAPer];
  S rb[SPARSE ? 1 : Cfg::kBPer], rg[SPARSE ? 1 : Cfg::kBPer];  // dense B, gate
  uint8_t mb[Sp::kPer], mg[Sp::kPer];                            // 2:4 B, gate
  S pb[Sp::kPer][4], pg[Sp::kPer][4];
  auto load = [&](int k0) {  // global -> registers
    load_a<Cfg, BM, BK>(ra, A, M, K, m0, k0);
    if constexpr (SPARSE) {
      load_b24<Cfg, BN, BK>(mb, pb, B, Bm, N, K, n0, k0);
      if constexpr (GATE) load_b24<Cfg, BN, BK>(mg, pg, Bg, Bgm, N, K, n0, k0);
    } else {
      load_b<Cfg, BN, BK>(rb, B, N, K, n0, k0);
      if constexpr (GATE) load_b<Cfg, BN, BK>(rg, Bg, N, K, n0, k0);
    }
  };
  auto store = [&]() {  // registers -> shared memory
    store_a<Cfg, BM, BK>(As, ra);
    if constexpr (SPARSE) {
      store_b24<Cfg, BN, BK>(Bs, mb, pb);
      if constexpr (GATE) store_b24<Cfg, BN, BK>(Bgs, mg, pg);
    } else {
      store_b<Cfg, BN, BK>(Bs, rb);
      if constexpr (GATE) store_b<Cfg, BN, BK>(Bgs, rg);
    }
  };
  const int nk = (K + BK - 1) / BK;
  load(0);
  store();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) load((kt + 1) * BK);  // the next step's operands in flight during the FMAs
    fma_tile<Cfg, BM, BN, BK, TM, TN, GATE>(acc, accg, As, Bs, Bgs, tx, ty);
    hook.step(As, Bs);
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }
}
