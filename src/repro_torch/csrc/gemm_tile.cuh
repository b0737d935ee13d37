// The (BM x BN) output-tile machinery shared by the MX, grouped and baseline GEMMs:
// masked operand staging through shared memory, and the register MAC chain.
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

// The whole K loop of one (BM x BN) output tile, shared by the MX GEMM and
// the grouped GEMM: the register accumulators (type S) are zeroed (the
// C-tile reset) and never reloaded; A (type TA) and B and the gate weight Bg
// when GATE (type TB) stage through shared memory one BK step at a time,
// the next step's operands fetched into registers while the current step's
// MACs run.  A is read for rows < M, B for columns < N.  Ends after a
// barrier, so the caller may stage another sweep into the same shared
// memory at once.
template <typename S, typename TA, typename TB, int BM, int BN, int BK, int TM, int TN,
          bool GATE>
__device__ __forceinline__ void sweep_k(S (&acc)[TM][TN], S (&accg)[TM][TN],
                                        S (*As)[BM + 1], S (*Bs)[BN], S (*Bgs)[BN],
                                        const TA* __restrict__ A, const TB* __restrict__ B,
                                        const TB* __restrict__ Bg, int M, int N, int K,
                                        int m0, int n0, int tx, int ty) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = accg[i][j] = S(0);

  S ra[Cfg::kAPer], rb[Cfg::kBPer], rg[Cfg::kBPer];  // rg: gate weight
  const int nk = (K + BK - 1) / BK;
  load_a<Cfg, BM, BK>(ra, A, M, K, m0, 0);
  load_b<Cfg, BN, BK>(rb, B, N, K, n0, 0);
  if constexpr (GATE) load_b<Cfg, BN, BK>(rg, Bg, N, K, n0, 0);
  store_a<Cfg, BM, BK>(As, ra);
  store_b<Cfg, BN, BK>(Bs, rb);
  if constexpr (GATE) store_b<Cfg, BN, BK>(Bgs, rg);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) {  // next K step's operands in flight during this step's FMAs
      const int k0 = (kt + 1) * BK;
      load_a<Cfg, BM, BK>(ra, A, M, K, m0, k0);
      load_b<Cfg, BN, BK>(rb, B, N, K, n0, k0);
      if constexpr (GATE) load_b<Cfg, BN, BK>(rg, Bg, N, K, n0, k0);
    }
    fma_tile<Cfg, BM, BN, BK, TM, TN, GATE>(acc, accg, As, Bs, Bgs, tx, ty);
    __syncthreads();
    if (more) {
      store_a<Cfg, BM, BK>(As, ra);
      store_b<Cfg, BN, BK>(Bs, rb);
      if constexpr (GATE) store_b<Cfg, BN, BK>(Bgs, rg);
      __syncthreads();
    }
  }
}
