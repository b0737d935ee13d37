// Grouped (ragged) MX GEMM for Hopper (sm_90a): every expert of an MoE
// layer in one launch.  The kernel body of its 2:4 sparse variant
// (mx_grouped_matmul_sparse.cu, 5c) and its per-expert ABFT variant
// (mx_grouped_matmul_abft.cu, 5d): the dense kernel of mx_grouped_matmul.cu
// (5a / 5b) with gemm_tile.cuh's sweep_k_variant.
//
// What it computes and how (one CTA per output tile walking the groups that
// own its rows, each group's whole K loop and store, exact zeros past the
// last group, int64 weight offsets): see mx_grouped_matmul.cu.
//
// The tile is chosen in Python (kernels/_build.grouped_tile, by the mean
// rows per group T / G) and passed in, as for mx_matmul.cuh.
#pragma once

#include "mx_matmul.cuh"

// Every launch argument past the template parameters.
struct GroupedArgs {
  const void *x, *w, *wg;           // x (T, K); w, w_gate (G, K, N) or payloads (G, K/2, N)
  const uint8_t *w_meta, *wg_meta;  // 2:4 metadata (G, K/8, N)
  const float *a_scale, *b_scale, *bg_scale;
  const int* sizes;
  void* out;
  int out_dt, T, N, K, G, act;
  const float* fault_delta;         // (row_tiles, col_tiles) or null
  const int *fault_row, *fault_col;
  int* flags;                       // (row_tiles, col_tiles), ABFT only
  float rtol, atol;
};

template <int MODE, typename S, typename TA, typename TB, int BM, int BN, int BK, int TM,
          int TN, bool GATE>
__global__ void __launch_bounds__(TileCfg<BM, BN, BK, TM, TN>::kThreads)
grouped_kernel(const GroupedArgs r) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  constexpr bool kSparse = MODE == kSparseB;
  using Abft = AbftHook<Cfg, S, BM, BN, BK, TM, TN>;
  __shared__ S As[BK][BM + 1];
  __shared__ S Bs[BK][BN];
  __shared__ S Bgs[GATE ? BK : 1][BN];
  __shared__ typename std::conditional<MODE == kAbftB, typename Abft::Sm, char>::type ck;

  const int tx = threadIdx.x % Cfg::kTX, ty = threadIdx.x / Cfg::kTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Trows = r.T, N = r.N, K = r.K;
  const int m1 = min(m0 + BM, Trows);
  // one expert's weight elements: dense (K, N), or the (K/2, N) payload and
  // (K/8, N) metadata of a sparse expert
  const int64_t wn = MODE == kSparseB ? (int64_t)(K / 2) * N : (int64_t)K * N;
  const int64_t mn = (int64_t)(K / 8) * N;
  const TA* X = static_cast<const TA*>(r.x);
  const TB* W = static_cast<const TB*>(r.w);
  const TB* Wg = static_cast<const TB*>(r.wg);
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  int flag = 0;  // the OR of this tile's group visits' verdicts

  int64_t cum = 0;  // rows owned by groups [0, g)
  for (int g = 0; g < r.G; ++g) {
    const int s = (int)min(cum, (int64_t)Trows);
    cum += max(r.sizes[g], 0);
    const int e = (int)min(cum, (int64_t)Trows);
    if (e <= m0 || s >= m1 || s == e) continue;  // no rows of this tile

    S acc[TM][TN], accg[TM][TN];  // this group's inter-k buffer(s)
    const TB* B = W + g * wn;
    const TB* Bg = GATE ? Wg + g * wn : nullptr;
    const uint8_t* Bm = kSparse ? r.w_meta + g * mn : nullptr;
    const uint8_t* Bgm = kSparse && GATE ? r.wg_meta + g * mn : nullptr;
    if constexpr (MODE == kAbftB) {
      // this group's visit: its own checksums, verified at its store
      Abft hook(ck);
      hook.reset();
      sweep_k_variant<S, TA, TB, BM, BN, BK, TM, TN, GATE, kSparse>(
          acc, accg, As, Bs, Bgs, X, B, Bg, Bm, Bgm, hook, e, N, K, m0, n0, tx, ty);
      if (r.fault_delta != nullptr)
        hook.inject(acc, r.fault_delta[tile], r.fault_row[tile], r.fault_col[tile], tx, ty);
      flag |= hook.verify(acc, r.rtol, r.atol, tx, ty);
    } else {
      NoHook hook;
      sweep_k_variant<S, TA, TB, BM, BN, BK, TM, TN, GATE, kSparse>(
          acc, accg, As, Bs, Bgs, X, B, Bg, Bm, Bgm, hook, e, N, K, m0, n0, tx, ty);
    }
    // the single write-back of the rows group g owns, this group's dequant
    // scales and the epilogue applied in registers
    const float* bs = r.b_scale != nullptr ? r.b_scale + (int64_t)g * N : nullptr;
    const float* bgs = r.bg_scale != nullptr ? r.bg_scale + (int64_t)g * N : nullptr;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
      if (gm < s || gm >= e) continue;
      const float as = r.a_scale != nullptr ? r.a_scale[gm] : 1.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + j * Cfg::kTX;
        if (gn >= N) continue;
        float y = static_cast<float>(acc[i][j]);
        if (r.a_scale != nullptr) y *= as;
        if (bs != nullptr) y *= bs[gn];
        if constexpr (GATE) {
          float gate = static_cast<float>(accg[i][j]);
          if (r.a_scale != nullptr) gate *= as;
          if (bgs != nullptr) gate *= bgs[gn];
          y = silu_f(gate) * y;
        } else {
          y = activation_f(y, r.act);
        }
        store_dt(r.out, r.out_dt, (int64_t)gm * N + gn, y);
      }
    }
  }
  if constexpr (MODE == kAbftB) {
    if (threadIdx.x == 0) r.flags[tile] = flag;  // 0 for a tile no group covers
  }

  // rows no group owns: exact zeros
  const int tail = (int)min(cum, (int64_t)Trows);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm < tail || gm >= Trows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * Cfg::kTX;
      if (gn < N) store_dt(r.out, r.out_dt, (int64_t)gm * N + gn, 0.0f);
    }
  }
}

template <int MODE, typename S, typename TA, typename TB, int BM, int BN, int BK, int TM,
          int TN>
static void grouped_launch(const GroupedArgs& r, cudaStream_t stream) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  dim3 grid((r.N + BN - 1) / BN, (r.T + BM - 1) / BM);
  if (r.act == kSwiglu)
    grouped_kernel<MODE, S, TA, TB, BM, BN, BK, TM, TN, true>
        <<<grid, Cfg::kThreads, 0, stream>>>(r);
  else
    grouped_kernel<MODE, S, TA, TB, BM, BN, BK, TM, TN, false>
        <<<grid, Cfg::kThreads, 0, stream>>>(r);
}

// The tiles of kernels/_build.grouped_tile, by the mean rows per group
// (the rows one expert's weights are streamed for): decode (bytes bound,
// one thread per column over 8 rows), middle, an expert-major prefill
// chunk (FLOP bound).
template <int MODE, typename S, typename TA, typename TB>
static int grouped_dispatch(const GroupedArgs& r, int bm, int bn, int bk, cudaStream_t s) {
  if (bm == 8 && bn == 128 && bk == 32)
    grouped_launch<MODE, S, TA, TB, 8, 128, 32, 8, 1>(r, s);
  else if (bm == 32 && bn == 64 && bk == 16)
    grouped_launch<MODE, S, TA, TB, 32, 64, 16, 2, 4>(r, s);
  else if (bm == 64 && bn == 64 && bk == 16)
    grouped_launch<MODE, S, TA, TB, 64, 64, 16, 4, 4>(r, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

#define REPRO_GROUPED_PAIR(MODE, ADT, BDT, S, TA, TB) \
  if (x_dt == ADT && w_dt == BDT) return grouped_dispatch<MODE, S, TA, TB>(r, bm, bn, bk, s);
