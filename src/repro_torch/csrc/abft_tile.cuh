// ABFT checksums of one (BM x BN) output tile (stages 1d / 5d), ported from
// repro/kernels/mx_matmul.py abft_accumulate / abft_inject / abft_verify.
//
// Beside the register accumulator the CTA keeps, in shared memory, the
// column checksum ccol[BN] and the row checksum crow[BM] of the tile (and
// for float pairs the |a|/|b| checksums acol / arow, the scale of
// legitimate rounding).  Each staged K step adds colsum(As) . Bs and
// As . rowsum(Bs) -- summed first, multiplied second, so their rounding and
// any corruption of the main MAC chain are independent of it.  At the
// single store the fault operands (if any) corrupt the finished
// accumulator, the accumulator's column and row sums are reduced across the
// CTA and compared, and the tile's flag is the CTA-wide OR.  The main
// accumulator's MAC chain is untouched, so ABFT on is bitwise ABFT off.
//
// int8 x int8 (S = int) compares exactly in unsigned, wrapping 32-bit
// arithmetic: JAX's int32 sums wrap, and signed overflow is undefined in
// C++.  Every other pair compares |sum - checksum| > rtol * |.|-checksum +
// atol, in f32.
//
// AbftHook serves gemm_tile.cuh's loop (the fused GEMM's decode-height
// rows); AbftPrefillHook the tensor-core prefill tile of prefill_tile.cuh
// (every pair at M > 16, and the grouped GEMM at every height), whose CTA
// tile is gemm_tile's or the grouped flag map's.
#pragma once

#include <type_traits>

#include "prefill_tile.cuh"  // and gemm_tile.cuh

template <typename S>
using CheckT = typename std::conditional<std::is_same<S, int>::value, unsigned, float>::type;

template <typename S, int BM, int BN, int BK, int TM, int TN>
struct AbftSmem {
  using C = CheckT<S>;
  static constexpr bool kExact = std::is_same<S, int>::value;
  C ccol[BN], crow[BM];                            // the checksums
  float acol[kExact ? 1 : BN], arow[kExact ? 1 : BM];  // |a| / |b| checksums
  C colA[BK], rowB[BK];                            // this step's colsum(As), rowsum(Bs)
  float colAa[kExact ? 1 : BK], rowBa[kExact ? 1 : BK];
  C colpart[BM / TM][BN], rowpart[BN / TN][BM];    // the accumulator's partial sums
};

template <typename Cfg, typename S, int BM, int BN, int BK, int TM, int TN>
struct AbftHook {
  using Sm = AbftSmem<S, BM, BN, BK, TM, TN>;
  using C = CheckT<S>;
  static constexpr bool kExact = Sm::kExact;
  Sm& sm;

  __device__ __forceinline__ explicit AbftHook(Sm& s) : sm(s) {}

  // zero the checksums; the sweep's first barrier orders this before use
  __device__ __forceinline__ void reset() {
    for (int i = threadIdx.x; i < BN; i += Cfg::kThreads) {
      sm.ccol[i] = C(0);
      if constexpr (!kExact) sm.acol[i] = 0.0f;
    }
    for (int i = threadIdx.x; i < BM; i += Cfg::kThreads) {
      sm.crow[i] = C(0);
      if constexpr (!kExact) sm.arow[i] = 0.0f;
    }
  }

  // one staged K step: ccol += colsum(As) . Bs, crow += As . rowsum(Bs)
  __device__ __forceinline__ void step(S (*As)[BM + 1], S (*Bs)[BN]) {
    for (int k = threadIdx.x; k < BK; k += Cfg::kThreads) {
      C ca = C(0), rb = C(0);
      float caa = 0.0f, rba = 0.0f;
      for (int m = 0; m < BM; ++m) {
        ca += C(As[k][m]);
        if constexpr (!kExact) caa += fabsf(As[k][m]);
      }
      for (int n = 0; n < BN; ++n) {
        rb += C(Bs[k][n]);
        if constexpr (!kExact) rba += fabsf(Bs[k][n]);
      }
      sm.colA[k] = ca;
      sm.rowB[k] = rb;
      if constexpr (!kExact) {
        sm.colAa[k] = caa;
        sm.rowBa[k] = rba;
      }
    }
    __syncthreads();
    for (int n = threadIdx.x; n < BN; n += Cfg::kThreads) {
      C s = sm.ccol[n];
      float sa = 0.0f;
      for (int k = 0; k < BK; ++k) {
        s += sm.colA[k] * C(Bs[k][n]);
        if constexpr (!kExact) sa += sm.colAa[k] * fabsf(Bs[k][n]);
      }
      sm.ccol[n] = s;
      if constexpr (!kExact) sm.acol[n] += sa;
    }
    for (int m = threadIdx.x; m < BM; m += Cfg::kThreads) {
      C s = sm.crow[m];
      float sa = 0.0f;
      for (int k = 0; k < BK; ++k) {
        s += C(As[k][m]) * sm.rowB[k];
        if constexpr (!kExact) sa += fabsf(As[k][m]) * sm.rowBa[k];
      }
      sm.crow[m] = s;
      if constexpr (!kExact) sm.arow[m] += sa;
    }
  }

  // The fault operand of this tile: delta added to accumulator element
  // (row, col) of the tile, as an integer for the int32 MAC.
  __device__ __forceinline__ void inject(S (&acc)[TM][TN], float delta, int row, int col,
                                         int tx, int ty) {
    if (delta == 0.0f || row / TM != ty || col % Cfg::kTX != tx) return;
    const int i = row % TM, j = col / Cfg::kTX;
#pragma unroll
    for (int ii = 0; ii < TM; ++ii)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj)
        if (ii == i && jj == j) {
          if constexpr (kExact)
            acc[ii][jj] = static_cast<int>(static_cast<unsigned>(acc[ii][jj]) +
                                           static_cast<unsigned>(static_cast<int>(delta)));
          else
            acc[ii][jj] += delta;
        }
  }

  // The tile's verdict (1 = corrupt), the same in every thread.
  __device__ __forceinline__ int verify(const S (&acc)[TM][TN], float rtol, float atol,
                                        int tx, int ty) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      C s = C(0);
#pragma unroll
      for (int i = 0; i < TM; ++i) s += C(acc[i][j]);
      sm.colpart[ty][tx + j * Cfg::kTX] = s;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      C s = C(0);
#pragma unroll
      for (int j = 0; j < TN; ++j) s += C(acc[i][j]);
      sm.rowpart[tx][ty * TM + i] = s;
    }
    __syncthreads();
    int bad = 0;
    for (int n = threadIdx.x; n < BN; n += Cfg::kThreads) {
      C s = C(0);
      for (int t = 0; t < BM / TM; ++t) s += sm.colpart[t][n];
      if constexpr (kExact)
        bad |= s != sm.ccol[n];
      else
        bad |= fabsf(s - sm.ccol[n]) > rtol * sm.acol[n] + atol;
    }
    for (int m = threadIdx.x; m < BM; m += Cfg::kThreads) {
      C s = C(0);
      for (int t = 0; t < BN / TN; ++t) s += sm.rowpart[t][m];
      if constexpr (kExact)
        bad |= s != sm.crow[m];
      else
        bad |= fabsf(s - sm.crow[m]) > rtol * sm.arow[m] + atol;
    }
    return __syncthreads_or(bad);
  }
};

// The same checksums over the prefill tile's staged operands (Cfg:
// PrefillCfg): A's BM rows of BK and B's BK rows of BN as staged in A's
// type T (a narrow weight already widened, or its raw rows under
// kRegWiden), to f32 as they are summed -- or, for int8 x int8 (an int32
// tile), exactly in wrapping unsigned 32-bit sums, as AbftHook; the
// finished tile (after the fold of every K part) is Cs, in the
// accumulator's type.  The CTA tile is gemm_tile's (BM x BN) and the
// launch has split 1, so one CTA owns one flag.
template <typename Cfg, typename T, int BM, int BN>
struct AbftPrefillHook {
  using AccT = typename Cfg::AccT;
  using C = CheckT<AccT>;
  static constexpr bool kExact = std::is_same<AccT, int>::value;
  static constexpr int BK = Cfg::kBK, TH = Cfg::kThreads, CS = Cfg::kCStride;
  struct Sm {
    C ccol[BN], crow[BM];  // the checksums
    C colA[BK], rowB[BK];  // this step's colsum(A), rowsum(B)
    float acol[kExact ? 1 : BN], arow[kExact ? 1 : BM];  // |.|-checksums
    float colAa[kExact ? 1 : BK], rowBa[kExact ? 1 : BK];
  };
  Sm& sm;

  __device__ __forceinline__ explicit AbftPrefillHook(Sm& s) : sm(s) {}

  template <typename V>
  __device__ __forceinline__ static C as_c(V x) {
    if constexpr (kExact)
      return static_cast<C>(static_cast<int>(x));
    else
      return to_f32(x);
  }
  __device__ __forceinline__ static C at_a(const unsigned char* slot, int m, int k) {
    return as_c(*reinterpret_cast<const T*>(slot + m * Cfg::kAStride + k * Cfg::kE));
  }
  __device__ __forceinline__ static C at_b(const unsigned char* slot, int k, int n) {
    if constexpr (Cfg::kRegWiden)  // the raw narrow weight: the same value, unwidened
      return as_c(*reinterpret_cast<const typename Cfg::WeightT*>(
          slot + Cfg::raw_off(0) + k * Cfg::kPRow + n));
    return as_c(
        *reinterpret_cast<const T*>(slot + Cfg::b_off(0) + k * Cfg::kBStride + n * Cfg::kE));
  }
  __device__ __forceinline__ static float mag(C x) {
    if constexpr (kExact)
      return 0.0f;
    else
      return fabsf(x);
  }

  // zero the checksums; the ring's first barrier orders this before use
  __device__ __forceinline__ void reset() {
    for (int i = threadIdx.x; i < BN; i += TH) {
      sm.ccol[i] = C(0);
      if constexpr (!kExact) sm.acol[i] = 0.0f;
    }
    for (int i = threadIdx.x; i < BM; i += TH) {
      sm.crow[i] = C(0);
      if constexpr (!kExact) sm.arow[i] = 0.0f;
    }
  }

  // one staged K step: ccol += colsum(A) . B, crow += A . rowsum(B)
  __device__ __forceinline__ void step(const unsigned char* slot) {
    for (int k = threadIdx.x; k < BK; k += TH) {
      C ca = C(0), rb = C(0);
      float caa = 0.0f, rba = 0.0f;
      for (int m = 0; m < BM; ++m) {
        const C x = at_a(slot, m, k);
        ca += x;
        caa += mag(x);
      }
      for (int n = 0; n < BN; ++n) {
        const C x = at_b(slot, k, n);
        rb += x;
        rba += mag(x);
      }
      sm.colA[k] = ca;
      sm.rowB[k] = rb;
      if constexpr (!kExact) {
        sm.colAa[k] = caa;
        sm.rowBa[k] = rba;
      }
    }
    __syncthreads();
    for (int n = threadIdx.x; n < BN; n += TH) {
      C s = sm.ccol[n];
      float sa = 0.0f;
      for (int k = 0; k < BK; ++k) {
        const C x = at_b(slot, k, n);
        s += sm.colA[k] * x;
        if constexpr (!kExact) sa += sm.colAa[k] * mag(x);
      }
      sm.ccol[n] = s;
      if constexpr (!kExact) sm.acol[n] += sa;
    }
    for (int m = threadIdx.x; m < BM; m += TH) {
      C s = sm.crow[m];
      float sa = 0.0f;
      for (int k = 0; k < BK; ++k) {
        const C x = at_a(slot, m, k);
        s += x * sm.rowB[k];
        if constexpr (!kExact) sa += mag(x) * sm.rowBa[k];
      }
      sm.crow[m] = s;
      if constexpr (!kExact) sm.arow[m] += sa;
    }
  }

  // The fault operand of this tile: delta added to element (row, col) of
  // the finished tile (as an integer, wrapping, for the int32 tile).
  __device__ __forceinline__ void inject(AccT* Cs, float delta, int row, int col) {
    if (threadIdx.x == 0 && delta != 0.0f) {
      AccT& x = Cs[row * CS + col];
      if constexpr (kExact)
        x = static_cast<int>(static_cast<unsigned>(x) +
                             static_cast<unsigned>(static_cast<int>(delta)));
      else
        x += delta;
    }
    __syncthreads();
  }

  // The tile's verdict (1 = corrupt), the same in every thread.
  __device__ __forceinline__ int verify(const AccT* Cs, float rtol, float atol) {
    int bad = 0;
    for (int n = threadIdx.x; n < BN; n += TH) {
      C s = C(0);
      for (int m = 0; m < BM; ++m) s += static_cast<C>(Cs[m * CS + n]);
      if constexpr (kExact)
        bad |= s != sm.ccol[n];
      else
        bad |= fabsf(s - sm.ccol[n]) > rtol * sm.acol[n] + atol;
    }
    for (int m = threadIdx.x; m < BM; m += TH) {
      C s = C(0);
      for (int n = 0; n < BN; ++n) s += static_cast<C>(Cs[m * CS + n]);
      if constexpr (kExact)
        bad |= s != sm.crow[m];
      else
        bad |= fabsf(s - sm.crow[m]) > rtol * sm.arow[m] + atol;
    }
    return __syncthreads_or(bad);
  }
};
