// ABFT checksums of the MX GEMM's output tiles (stages 1d / 5d), ported
// from repro/kernels/mx_matmul.py abft_accumulate / abft_inject /
// abft_verify.
//
// Beside the register accumulator the CTA keeps the column checksum ccol
// and the row checksum crow of each flag tile (and for float pairs the
// |a|/|b| checksums acol / arow, the scale of legitimate rounding).  Each
// staged K step adds colsum(A) . B and A . rowsum(B) -- summed first,
// multiplied second, so their rounding and any corruption of the main MAC
// chain are independent of it.  At the single store the fault operands
// (if any) corrupt the finished accumulator, the accumulator's column and
// row sums are reduced across the CTA and compared, and each flag tile's
// flag is the OR over its columns and rows.  The main accumulator's MAC
// chain is untouched, so ABFT on is bitwise ABFT off.
//
// int8 x int8 (S = int) compares exactly in unsigned, wrapping 32-bit
// arithmetic: JAX's int32 sums wrap, and signed overflow is undefined in
// C++.  Every other pair compares |sum - checksum| > rtol * |.|-checksum +
// atol, in f32.
//
// AbftDecodeHook serves decode_tile.cuh's loop (the fused GEMM's
// decode-height rows); AbftPrefillHook the tensor-core prefill tile of
// prefill_tile.cuh (every pair at M > 16, and the grouped GEMM at every
// height), whose CTA tile is gemm_tile's or the grouped flag map's.
#pragma once

#include <type_traits>

#include "prefill_tile.cuh"  // and decode_tile.cuh, gemm_tile.cuh

template <typename S>
using CheckT = typename std::conditional<std::is_same<S, int>::value, unsigned, float>::type;

// The checksums over decode_tile.cuh's staged slots.  The flag map's grid
// at M <= 16 is gemm_tile's 16 x 16: one row of flag tiles, so a CTA (all M
// rows, bn columns, bn a multiple of 16) owns the bn / 16 flag tiles of its
// columns.  The checksums run on warps of their own, the H threads past the
// computing threads' last warp (decode_hook0), beside the MACs of the same
// staged step: the MAC loop leaves most issue slots of its SM idle (its
// serial chains wait on shared-memory reads), and these warps take them.
// A step's work, with one barrier of the hook warps alone (named barrier
// 1), every operand read 16 (or, for colsum(A) . B, 4 elements') bytes at
// a time: first colsum(A)[k] (a thread per 16 bytes of K) and
// rowsum(B)[t][k] of each flag tile t (a thread per (t, k), its 16 columns
// read in an order rotated by k against bank conflicts) into the scratch
// after the ring, then each hook thread's share of the products -- columns
// 4cg .. 4cg + 3 over K rows cs, cs + S1, ... for colsum(A) . B, item (m,
// t) over the 16-byte chunks rs, rs + S2, ... of A's row m for
// A . rowsum(B) -- into its own registers across the whole loop.  Rows
// past K are zero in the slot, so every pass runs over all bk rows.  At
// the store the partial checksums and the accumulator's column sums (per
// thread's TM rows) and row sums (16 neighbouring lanes, by shuffles) meet
// in the scratch.  A fault in a row past M (the plain version's padding
// row) corrupts its column's sum.
template <typename S, typename TA, typename TB, int TM>
struct AbftDecodeHook {
  using C = CheckT<S>;
  static constexpr bool kExact = std::is_same<S, int>::value;
  static constexpr int kCols = kDecodeFlagCols;
  static constexpr int kVA = 16 / sizeof(TA);  // A elements per 16-byte read
  static constexpr int kCV = 4;                // columns per thread of colsum(A) . B
  unsigned char* sm;  // the scratch after the ring
  int nt, q, H, cg, cs, S1, ri, rs, S2;  // q: the thread's rank among the H hook threads
  C ccol[kCV] = {}, crow = C(0);
  float acol[kCV] = {}, arow = 0.0f;

  __device__ __forceinline__ AbftDecodeHook(const DecodeShape& d, unsigned char* scratch)
      : sm(scratch), nt(d.bn / kCols) {
    const int hook0 = decode_hook0(d, TM), R = d.M * nt, G = d.bn / kCV;
    q = static_cast<int>(threadIdx.x) - hook0;  // < 0: a computing thread
    H = blockDim.x - hook0;
    S1 = H / G;
    S2 = H / R;
    cg = q < 0 ? 0 : q % G;
    cs = q < 0 ? S1 : q / G;  // >= S1: no share of colsum(A) . B
    ri = q < 0 ? 0 : q % R;
    rs = q < 0 ? S2 : q / R;  // >= S2: no share of A . rowsum(B)
  }

  __device__ __forceinline__ static float mag(C x) {
    if constexpr (kExact)
      return 0.0f;
    else
      return fabsf(x);
  }
  // element j of a 16-byte vector of T, as a checksum term
  template <typename T>
  __device__ __forceinline__ static C elem(const uint4& v, int j) {
    return static_cast<C>(widen_vec<S, T>(v, j));
  }
  // B's 4 elements from p (4 * sizeof(TB) bytes) in the low words of a vector
  __device__ __forceinline__ static uint4 b4(const unsigned char* p) {
    if constexpr (sizeof(TB) == 4) {
      return *reinterpret_cast<const uint4*>(p);
    } else if constexpr (sizeof(TB) == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      return make_uint4(v.x, v.y, 0u, 0u);
    } else {
      return make_uint4(*reinterpret_cast<const unsigned*>(p), 0u, 0u, 0u);
    }
  }

  // one staged K step: ccol += colsum(A) . B, crow += A . rowsum(B) (the
  // hook threads; the computing threads go straight on)
  __device__ __forceinline__ void step(const unsigned char* slot, const DecodeSlot& L,
                                       const DecodeShape& d, int) {
    constexpr int eb = sizeof(TB), kNV = kCols * eb / 16;  // vectors per flag tile row
    if (q < 0) return;
    const int bk = d.bk, brow = d.bn * eb;
    C* colA = reinterpret_cast<C*>(sm);
    float* colAa = reinterpret_cast<float*>(sm) + bk;
    C* rowB = reinterpret_cast<C*>(sm) + 2 * bk;
    float* rowBa = reinterpret_cast<float*>(sm) + (2 + nt) * bk;
    const unsigned char* B = slot + L.a_bytes;
    for (int i = q; i < bk / kVA; i += H) {  // colsum(A) of K rows i*kVA ..
      C s[kVA] = {};
      float sa[kVA] = {};
      for (int m = 0; m < d.M; ++m) {
        const uint4 v = *reinterpret_cast<const uint4*>(slot + m * L.a_stride + i * 16);
#pragma unroll
        for (int j = 0; j < kVA; ++j) {
          const C x = elem<TA>(v, j);
          s[j] += x;
          sa[j] += mag(x);
        }
      }
#pragma unroll
      for (int j = 0; j < kVA; ++j) {
        colA[i * kVA + j] = s[j];
        if constexpr (!kExact) colAa[i * kVA + j] = sa[j];
      }
    }
    for (int e = q; e < nt * bk; e += H) {  // rowsum(B) of flag tile t at K row k
      const int t = e / bk, k = e - t * bk;
      const unsigned char* row = B + k * brow + t * kCols * eb;
      C s[4] = {};
      float sa[4] = {};
#pragma unroll
      for (int v = 0; v < kNV; ++v) {
        const uint4 x = *reinterpret_cast<const uint4*>(row + ((v + k) % kNV) * 16);
#pragma unroll
        for (int j = 0; j < 16 / eb; ++j) {
          const C y = elem<TB>(x, j);
          s[j & 3] += y;
          sa[j & 3] += mag(y);
        }
      }
      rowB[e] = (s[0] + s[1]) + (s[2] + s[3]);
      if constexpr (!kExact) rowBa[e] = (sa[0] + sa[1]) + (sa[2] + sa[3]);
    }
    asm volatile("bar.sync 1, %0;" ::"r"(H) : "memory");  // the hook warps alone
    if (cs < S1) {
      for (int k = cs; k < bk; k += S1) {
        const uint4 v = b4(B + k * brow + cg * kCV * eb);
        const C ca = colA[k];
        float caa = 0.0f;
        if constexpr (!kExact) caa = colAa[k];
#pragma unroll
        for (int j = 0; j < kCV; ++j) {
          const C w = elem<TB>(v, j);
          ccol[j] += ca * w;
          if constexpr (!kExact) acol[j] += caa * mag(w);
        }
      }
    }
    if (rs < S2) {
      const int m = ri / nt, t = ri - m * nt;
      const C* rb = rowB + t * bk;
      const float* rba = rowBa + t * bk;
      for (int i = rs; i < bk / kVA; i += S2) {
        const uint4 v = *reinterpret_cast<const uint4*>(slot + m * L.a_stride + i * 16);
#pragma unroll
        for (int j = 0; j < kVA; ++j) {
          const C x = elem<TA>(v, j);
          crow += x * rb[i * kVA + j];
          if constexpr (!kExact) arow += mag(x) * rba[i * kVA + j];
        }
      }
    }
  }

  // After the K loop, with the finished accumulators of thread (column c,
  // rows r0 .. r0 + TM - 1): the fault operands of the CTA's flag tiles
  // (delta added to element (row, col) of a tile, as an integer for the
  // int32 MAC), then the compare, and the flags of the tiles within N.
  // Every thread calls it.
  template <typename R>
  __device__ __forceinline__ void finish(S (&acc)[TM], const DecodeShape& d, const R& r,
                                         int n0, int c, int r0) {
    const int tid = threadIdx.x, T = blockDim.x, R_ = d.M * nt, G = d.M / TM;
    const int tile0 = n0 / kCols, gn = (d.N + kCols - 1) / kCols;
    const bool computes = r0 < d.M;
    __syncthreads();  // every thread is done with the last step's scratch
    C* cpart = reinterpret_cast<C*>(sm);                 // [S1][bn], S1 * bn <= 4 H
    float* apart = reinterpret_cast<float*>(sm) + 4 * T;  // [S1][bn]
    C* rpart = reinterpret_cast<C*>(sm) + 8 * T;         // [S2][M * nt]
    float* rapart = reinterpret_cast<float*>(sm) + 9 * T;
    C* colpart = reinterpret_cast<C*>(sm) + 10 * T;      // [M / TM][bn]
    C* rowpart = colpart + d.M * d.bn;                   // [M][nt]
    int* bad = reinterpret_cast<int*>(rowpart + d.M * nt);  // [nt]
    if (cs < S1) {
#pragma unroll
      for (int j = 0; j < kCV; ++j) {
        cpart[cs * d.bn + cg * kCV + j] = ccol[j];
        apart[cs * d.bn + cg * kCV + j] = acol[j];
      }
    }
    if (rs < S2) {
      rpart[q] = crow;
      rapart[q] = arow;
    }
    C pad = C(0);  // a fault in a row past M
    const int g = tile0 + c / kCols;
    if (r.fault_delta != nullptr && computes && g < gn) {
      const float delta = r.fault_delta[g];
      const int row = r.fault_row[g];
      if (delta != 0.0f && r.fault_col[g] == c % kCols) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
          if (row == r0 + i) {
            if constexpr (kExact)
              acc[i] = static_cast<int>(static_cast<unsigned>(acc[i]) +
                                        static_cast<unsigned>(static_cast<int>(delta)));
            else
              acc[i] += delta;
          }
        if (row >= d.M && r0 == 0) pad = kExact ? C(static_cast<int>(delta)) : C(delta);
      }
    }
    C csum = pad;
#pragma unroll
    for (int i = 0; i < TM; ++i) csum += static_cast<C>(acc[i]);
    if (computes) colpart[tid] = csum;  // tid = (r0 / TM) * bn + c
#pragma unroll
    for (int i = 0; i < TM; ++i) {  // a flag tile's 16 columns are 16 neighbouring lanes
      C v = computes ? static_cast<C>(acc[i]) : C(0);
#pragma unroll
      for (int o = kCols / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, kCols);
      if (computes && c % kCols == 0) rowpart[(r0 + i) * nt + c / kCols] = v;
    }
    for (int t = tid; t < nt; t += T) bad[t] = 0;
    __syncthreads();
    for (int n = tid; n < d.bn; n += T) {
      C s = C(0), a = C(0);
      float sa = 0.0f;
      for (int j = 0; j < S1; ++j) {
        s += cpart[j * d.bn + n];
        sa += apart[j * d.bn + n];
      }
      for (int j = 0; j < G; ++j) a += colpart[j * d.bn + n];
      bool wrong;
      if constexpr (kExact)
        wrong = a != s;
      else
        wrong = fabsf(a - s) > r.rtol * sa + r.atol;
      if (wrong) atomicOr(&bad[n / kCols], 1);
    }
    for (int e = tid; e < R_; e += T) {
      C s = C(0);
      float sa = 0.0f;
      for (int j = 0; j < S2; ++j) {
        s += rpart[j * R_ + e];
        sa += rapart[j * R_ + e];
      }
      const C a = rowpart[e];
      bool wrong;
      if constexpr (kExact)
        wrong = a != s;
      else
        wrong = fabsf(a - s) > r.rtol * sa + r.atol;
      if (wrong) atomicOr(&bad[e % nt], 1);
    }
    __syncthreads();
    for (int t = tid; t < nt; t += T)
      if (tile0 + t < gn) r.flags[tile0 + t] = bad[t];
  }
};

// The same checksums over the prefill tile's staged operands (Cfg:
// PrefillCfg): A's BM rows of BK and B's BK rows of BN as staged in A's
// type T (a narrow weight already widened, or its raw rows under
// kRegWiden), to f32 as they are summed -- or, for int8 x int8 (an int32
// tile), exactly in wrapping unsigned 32-bit sums, as AbftDecodeHook; the
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
