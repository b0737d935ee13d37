// Grouped (ragged) MX GEMM for Hopper (sm_90a): every expert of an MoE
// layer in one launch.  The kernel body of the per-expert ABFT variant's
// "simt" route (mx_grouped_matmul_abft.cu, 5d; int8 x int8 and e4m3 x
// e4m3): the dense "simt" kernel of mx_grouped_matmul.cu with gemm_tile.cuh's
// sweep_k_variant and the AbftHook.  Every other pair, and the 2:4 variant,
// run the "mma" route (grouped_mma.cuh).
//
// What it computes and how (one CTA per output tile walking the groups that
// own its rows, each group's whole K loop and store, exact zeros past the
// last group, int64 weight offsets): see mx_grouped_matmul.cu.
//
// The tile is chosen in Python (kernels/_build.grouped_tile, by the mean
// rows per group T / G) and passed in, as for mx_matmul.cuh.
#pragma once

#include "grouped_mma.cuh"  // GroupedArgs, the "mma" route; abft_tile.cuh, gemm_tile.cuh

template <typename S, typename TA, typename TB, int BM, int BN, int BK, int TM, int TN,
          bool GATE>
__global__ void __launch_bounds__(TileCfg<BM, BN, BK, TM, TN>::kThreads)
grouped_abft_kernel(const GroupedArgs r) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  using Abft = AbftHook<Cfg, S, BM, BN, BK, TM, TN>;
  __shared__ S As[BK][BM + 1];
  __shared__ S Bs[BK][BN];
  __shared__ S Bgs[GATE ? BK : 1][BN];
  __shared__ typename Abft::Sm ck;

  const int tx = threadIdx.x % Cfg::kTX, ty = threadIdx.x / Cfg::kTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int Trows = r.T, N = r.N, K = r.K;
  const int m1 = min(m0 + BM, Trows);
  const int64_t wn = (int64_t)K * N;  // one expert's weight elements
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
    // this group's visit: its own checksums, verified at its store
    Abft hook(ck);
    hook.reset();
    sweep_k_variant<S, TA, TB, BM, BN, BK, TM, TN, GATE, false>(
        acc, accg, As, Bs, Bgs, X, B, Bg, nullptr, nullptr, hook, e, N, K, m0, n0, tx, ty);
    if (r.fault_delta != nullptr)
      hook.inject(acc, r.fault_delta[tile], r.fault_row[tile], r.fault_col[tile], tx, ty);
    flag |= hook.verify(acc, r.rtol, r.atol, tx, ty);
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
  if (threadIdx.x == 0) r.flags[tile] = flag;  // 0 for a tile no group covers

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

template <typename S, typename TA, typename TB, int BM, int BN, int BK, int TM, int TN>
static void grouped_launch(const GroupedArgs& r, cudaStream_t stream) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  dim3 grid((r.N + BN - 1) / BN, (r.T + BM - 1) / BM);
  if (r.act == kSwiglu)
    grouped_abft_kernel<S, TA, TB, BM, BN, BK, TM, TN, true>
        <<<grid, Cfg::kThreads, 0, stream>>>(r);
  else
    grouped_abft_kernel<S, TA, TB, BM, BN, BK, TM, TN, false>
        <<<grid, Cfg::kThreads, 0, stream>>>(r);
}

// The "simt" tiles of kernels/_build.grouped_tile (GROUPED_SIMT_TILES), by
// the mean rows per group (the rows one expert's weights are streamed for):
// decode (one thread per column over 8 rows), middle, an expert-major
// prefill chunk.
template <typename S, typename TA, typename TB>
static int grouped_dispatch(const GroupedArgs& r, int bm, int bn, int bk, cudaStream_t s) {
  if (bm == 8 && bn == 128 && bk == 32)
    grouped_launch<S, TA, TB, 8, 128, 32, 8, 1>(r, s);
  else if (bm == 32 && bn == 64 && bk == 16)
    grouped_launch<S, TA, TB, 32, 64, 16, 2, 4>(r, s);
  else if (bm == 64 && bn == 64 && bk == 16)
    grouped_launch<S, TA, TB, 64, 64, 16, 4, 4>(r, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}
