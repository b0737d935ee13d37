// The grouped (ragged) MX GEMM on the tensor cores, for Hopper (sm_90a): the
// kernel body of the dense (csrc/mx_grouped_matmul.cu), 2:4 sparse
// (mx_grouped_matmul_sparse.cu) and ABFT (mx_grouped_matmul_abft.cu)
// launches (kernels/_build.grouped_tile): f32 x f32, bf16 x bf16, bf16 x
// int8 / e4m3 with the weight widened to bf16, and int8 x int8 and e4m3 x
// e4m3 in their own byte (the s8 MMA; e4m3 widened to f16 in registers)
// (the 2:4 variant: its pairs, f32, bf16, bf16 x int8).
//
// One CTA per (BM x BN) output tile: it reads the
// group sizes itself (no host sync; a negative size counts as 0, the running
// sum is clamped to T) and, for every non-empty group that owns rows of its
// tile, runs prefill_tile.cuh's K loop -- the same ring, MMAs, K parts and
// fold or cluster sum as the fused GEMM's prefill tile -- over
//   * the tile's rows of x up to the group's end (rows past it zero filled),
//   * that expert's weight (w + g * wn, int64: kimi-k2's stack passes 2^31
//     elements) and, for 2:4, its payload and metadata,
// with the accumulators zeroed per visit, then stores only the group's rows
// through mx_store with the group's scales (b_scale + g * N).  Rows at or
// past sum(sizes) are stored as exact zeros.  Each output row is written by
// one visit.
//
// Bits: K is cut into parts by K alone (kernels/_build.prefill_parts with the
// pair's bk), each part summed from zero and the parts summed in rank order,
// so an output element's bits depend on K and the pair only: the dense, 2:4
// and ABFT grouped launches are bitwise equal, and so is the fused GEMM's
// tensor-core tile on one expert's rows and weight columns, which is how
// core/ops.py's ABFT recovery recomputes a flagged tile.
//
// ABFT: the CTA tile is the flag map's (split 1, one CTA per flag); every
// visit resets the checksums, accumulates them over the staged operands,
// takes the tile's fault operand and verifies its finished tile; the
// verdicts are OR-ed into the tile's flag (0 for a tile no group covers).
#pragma once

#include "abft_tile.cuh"  // prefill_tile.cuh, gemm_tile.cuh's mx_store

constexpr int kGroupedDense = 0, kGroupedSparse = 1, kGroupedAbft = 2;

// Every launch argument past the template parameters (both routes).
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

// What mx_store reads for one group's rows: its scales, no bias, residual or
// output scale.
struct GroupEpi {
  const float *a_scale, *b_scale, *bg_scale;
  const void* bias;
  int bias_dt;
  const void* res;
  int res_dt;
  void* out;
  int out_dt, N, act, has_scale;
  float out_scale;
};

template <int MODE, typename T, typename TB, int BM, int BN, bool GATE>
__global__ void __launch_bounds__(PrefillCfg<T, BM, BN, GATE, MODE == kGroupedSparse,
                                             TB>::kThreads)
grouped_mma_kernel(const PrefillShape d0, const GroupedArgs r) {
  constexpr bool kSparse = MODE == kGroupedSparse;
  using Cfg = PrefillCfg<T, BM, BN, GATE, kSparse, TB>;
  using Hook = AbftPrefillHook<Cfg, T, BM, BN>;
  __shared__ typename std::conditional<MODE == kGroupedAbft, typename Hook::Sm, char>::type ck;
  const int m0 = pf_tile_m() * BM, n0 = pf_tile_n() * BN;
  const int Trows = r.T, N = r.N;
  const int m1 = min(m0 + BM, Trows);
  // one expert's weight elements: dense (K, N), or the (K/2, N) payload and
  // (K/8, N) metadata of a 2:4 expert
  const int64_t wn = (kSparse ? static_cast<int64_t>(r.K / 2) : r.K) * static_cast<int64_t>(N);
  const int64_t mn = static_cast<int64_t>(r.K / 8) * N;
  const TB* W = static_cast<const TB*>(r.w);
  const TB* Wg = static_cast<const TB*>(r.wg);
  const int tile = pf_tile_m() * gridDim.y + pf_tile_n();  // the (row_tiles, col_tiles) map
  int flag = 0;  // the OR of this tile's visits' verdicts

  int64_t cum = 0;  // rows owned by groups [0, g)
  for (int g = 0; g < r.G; ++g) {
    const int s = static_cast<int>(min(cum, static_cast<int64_t>(Trows)));
    cum += max(r.sizes[g], 0);
    const int e = static_cast<int>(min(cum, static_cast<int64_t>(Trows)));
    if (e <= m0 || s >= m1 || s == e) continue;  // no rows of this tile

    PrefillShape d = d0;
    d.M = e;  // the tile's rows past the group's end are zero filled
    d.b = W + g * wn;
    d.bg = GATE ? Wg + g * wn : nullptr;
    if constexpr (kSparse) {
      d.bmeta = r.w_meta + g * mn;
      d.bgmeta = GATE ? r.wg_meta + g * mn : nullptr;
    }
    const GroupEpi ep{r.a_scale,
                      r.b_scale != nullptr ? r.b_scale + static_cast<int64_t>(g) * N : nullptr,
                      r.bg_scale != nullptr ? r.bg_scale + static_cast<int64_t>(g) * N : nullptr,
                      nullptr, 0, nullptr, 0, r.out, r.out_dt, N, r.act, 0, 0.0f};
    const typename Cfg::AccT* Cs;
    if constexpr (MODE == kGroupedAbft) {
      Hook hook(ck);
      hook.reset();
      auto* C = prefill_sweep<T, BM, BN, GATE, false, TB>(d, hook);
      if (r.fault_delta != nullptr)
        hook.inject(C, r.fault_delta[tile], r.fault_row[tile], r.fault_col[tile]);
      flag |= hook.verify(C, r.rtol, r.atol);
      Cs = C;
    } else {
      NoHook hook;
      Cs = prefill_sweep<T, BM, BN, GATE, kSparse, TB>(d, hook);
    }
    prefill_store<Cfg, BM, BN, GATE>(ep, d, Cs, s);  // the group's rows only
    __syncthreads();  // Cs and the ring are free for the next visit
  }
  if constexpr (MODE == kGroupedAbft) {
    if (threadIdx.x == 0) r.flags[tile] = flag;
  }

  // rows no group owns: exact zeros (the first CTA of a cluster stores them)
  const int tail = static_cast<int>(min(cum, static_cast<int64_t>(Trows)));
  if (blockIdx.z == 0 && tail < m1) {
    for (int q = threadIdx.x; q < BM * BN; q += Cfg::kThreads) {
      const int gm = m0 + q / BN, gn = n0 + q % BN;
      if (gm >= tail && gm < Trows && gn < N)
        store_dt(r.out, r.out_dt, static_cast<int64_t>(gm) * N + gn, 0.0f);
    }
  }
}

template <int MODE, typename T, typename TB, int BM, int BN>
static int grouped_mma_gate(const PrefillShape& d, const GroupedArgs& r, cudaStream_t s) {
  constexpr bool kSparse = MODE == kGroupedSparse;
  if (r.act == kSwiglu)
    return prefill_launch<grouped_mma_kernel<MODE, T, TB, BM, BN, true>,
                          PrefillCfg<T, BM, BN, true, kSparse, TB>, kSparse>(d, s, true, d, r);
  return prefill_launch<grouped_mma_kernel<MODE, T, TB, BM, BN, false>,
                        PrefillCfg<T, BM, BN, false, kSparse, TB>, kSparse>(d, s, true, d, r);
}

// The CTA tiles of kernels/_build.GROUPED_TILES (the dense and 2:4 launches)
// and GROUPED_ABFT_TILES (the ABFT launch: the flag map's tiles).  Any
// other tile, or a pair a source does not list, returns
// cudaErrorInvalidValue; prefill_check refuses what the loop does not take.
template <int MODE>
static int grouped_mma_dispatch(const PrefillShape& d, const GroupedArgs& r, int x_dt,
                                int w_dt, int bm, int bn, cudaStream_t s) {
  auto tiles = [&](auto t, auto tb) -> int {
    using T = decltype(t);
    using TB = decltype(tb);
    if (bm == 32 && bn == 64) return grouped_mma_gate<MODE, T, TB, 32, 64>(d, r, s);
    if (bm == 64 && bn == 64) return grouped_mma_gate<MODE, T, TB, 64, 64>(d, r, s);
    if constexpr (MODE == kGroupedAbft) {
      if (bm == 16 && bn == 64) return grouped_mma_gate<MODE, T, TB, 16, 64>(d, r, s);
    } else {
      if (bm == 16 && bn == 128) return grouped_mma_gate<MODE, T, TB, 16, 128>(d, r, s);
      if (bm == 64 && bn == 128) return grouped_mma_gate<MODE, T, TB, 64, 128>(d, r, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (x_dt == kF32 && w_dt == kF32) return tiles(float(), float());
  if (x_dt == kBF16 && w_dt == kBF16) return tiles(__nv_bfloat16(), __nv_bfloat16());
  if (x_dt == kBF16 && w_dt == kI8) return tiles(__nv_bfloat16(), int8_t());
  if constexpr (MODE != kGroupedSparse) {
    if (x_dt == kBF16 && w_dt == kF8) return tiles(__nv_bfloat16(), __nv_fp8_e4m3());
    if (x_dt == kI8 && w_dt == kI8) return tiles(int8_t(), int8_t());
    if (x_dt == kF8 && w_dt == kF8) return tiles(__nv_fp8_e4m3(), __nv_fp8_e4m3());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch of a source's "mma" entry: the tile of kernels/_build.grouped_tile
// -- (bm, bn) CTA tile, `stages` ring slots, K cut into `parts` parts,
// `split` CTAs per cluster (1 or parts) -- and the copy widths va / vb / vm
// (bytes) of x's, the weights' and the metadata's rows.
template <int MODE>
static int grouped_mma_run(const GroupedArgs& r, int x_dt, int w_dt, int bm, int bn,
                           int stages, int split, int parts, int va, int vb, int vm,
                           void* stream) {
  const PrefillShape d{r.x, r.w, r.act == kSwiglu ? r.wg : nullptr, r.w_meta,
                       r.act == kSwiglu ? r.wg_meta : nullptr, r.T, r.N, r.K, stages,
                       split, parts, va, vb, vm};
  const int err = grouped_mma_dispatch<MODE>(d, r, x_dt, w_dt, bm, bn,
                                             static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
