// The (BM x BN) output-tile machinery shared by the MX, grouped and baseline GEMMs:
// masked operand staging through shared memory, and the register FMA chain.
//
// A is (M, K) row-major, B is (K, N) row-major (the JAX layout: w is
// (d_in, d_out), read as stored, no transpose).  Ragged M/N/K edges are
// masked at the load (zero fill) and at the store, so no padded copies are
// made.  Operands are widened to f32 on their way into shared memory; the
// products accumulate in f32 registers.
#pragma once

#include "common.cuh"

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
template <typename Cfg, int BM, int BK, typename T>
__device__ __forceinline__ void load_a(float (&ra)[Cfg::kAPer], const T* __restrict__ A,
                                       int M, int K, int m0, int k0) {
#pragma unroll
  for (int r = 0; r < Cfg::kAPer; ++r) {
    const int e = threadIdx.x + r * Cfg::kThreads;
    const int m = e / BK, k = e % BK;
    const int gm = m0 + m, gk = k0 + k;
    ra[r] = (e < BM * BK && gm < M && gk < K) ? to_f32(A[(int64_t)gm * K + gk]) : 0.0f;
  }
}

template <typename Cfg, int BN, int BK, typename T>
__device__ __forceinline__ void load_b(float (&rb)[Cfg::kBPer], const T* __restrict__ B,
                                       int N, int K, int n0, int k0) {
#pragma unroll
  for (int r = 0; r < Cfg::kBPer; ++r) {
    const int e = threadIdx.x + r * Cfg::kThreads;
    const int k = e / BN, n = e % BN;
    const int gk = k0 + k, gn = n0 + n;
    rb[r] = (e < BK * BN && gk < K && gn < N) ? to_f32(B[(int64_t)gk * N + gn]) : 0.0f;
  }
}

// Registers -> shared memory.  A is stored transposed (As[k][m], one pad
// column against bank conflicts) so the FMA loop reads a column of A and a
// row of B at the same k.
template <typename Cfg, int BM, int BK>
__device__ __forceinline__ void store_a(float (*As)[BM + 1], const float (&ra)[Cfg::kAPer]) {
#pragma unroll
  for (int r = 0; r < Cfg::kAPer; ++r) {
    const int e = threadIdx.x + r * Cfg::kThreads;
    if (e < BM * BK) As[e % BK][e / BK] = ra[r];
  }
}

template <typename Cfg, int BN, int BK>
__device__ __forceinline__ void store_b(float (*Bs)[BN], const float (&rb)[Cfg::kBPer]) {
#pragma unroll
  for (int r = 0; r < Cfg::kBPer; ++r) {
    const int e = threadIdx.x + r * Cfg::kThreads;
    if (e < BK * BN) Bs[e / BN][e % BN] = rb[r];
  }
}

// One staged K step of FMAs into the thread's (TM x TN) register tile.
// Thread (tx, ty) owns rows ty*TM + i and columns tx + j*TX: neighbouring
// threads read neighbouring B columns (no bank conflicts) and write
// neighbouring output columns (coalesced stores).
template <typename Cfg, int BM, int BN, int BK, int TM, int TN, bool GATE>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN], float (&accg)[TM][TN],
                                         float (*As)[BM + 1], float (*Bs)[BN],
                                         float (*Bgs)[BN], int tx, int ty) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = As[k][ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx + j * Cfg::kTX];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    if constexpr (GATE) {
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bgs[k][tx + j * Cfg::kTX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) accg[i][j] = fmaf(av[i], bv[j], accg[i][j]);
    }
  }
}

// The whole K loop of one (BM x BN) output tile, shared by the MX GEMM and
// the grouped GEMM: the f32 register accumulators are zeroed (the C-tile
// reset) and never reloaded; A and B (and the gate weight Bg when GATE)
// stage through shared memory one BK step at a time, the next step's
// operands fetched into registers while the current step's FMAs run.  A is
// read for rows < M, B for columns < N.  Ends after a barrier, so the
// caller may stage another sweep into the same shared memory at once.
template <typename T, int BM, int BN, int BK, int TM, int TN, bool GATE>
__device__ __forceinline__ void sweep_k(float (&acc)[TM][TN], float (&accg)[TM][TN],
                                        float (*As)[BM + 1], float (*Bs)[BN],
                                        float (*Bgs)[BN], const T* __restrict__ A,
                                        const T* __restrict__ B, const T* __restrict__ Bg,
                                        int M, int N, int K, int m0, int n0, int tx,
                                        int ty) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = accg[i][j] = 0.0f;

  float ra[Cfg::kAPer], rb[Cfg::kBPer], rg[Cfg::kBPer];  // rg: gate weight
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
