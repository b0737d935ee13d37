// MX GEMM with the fused epilogue, for Hopper (sm_90a): the kernel body of
// its 2:4 sparse variant (mx_matmul_sparse.cu, stage 1c) and its ABFT
// variant (mx_matmul_abft.cu, checksums and the per-tile flag map, stage
// 1d), each source built by its own nvcc, all in parallel.  It is the
// dense kernel of mx_matmul.cu (stages 1a / 1b) with, for ABFT, the verify
// at the store, on one of two K loops:
//   * every pair at M > 16 (the *_prefill_launch entries; 2:4 only for its
//     pairs): the dense kernel's tensor-core loop, prefill_tile.cuh, the
//     2:4 payloads expanded (and a narrow weight widened) into the same
//     staged B tile, int8 x int8 and e4m3 x e4m3 in their own byte; the
//     dense and 2:4 kernels share the tile of kernels/_build.prefill_tile,
//     the ABFT kernel runs gemm_tile's CTA tile with split 1 (one CTA per
//     flag), folding the same K parts in the same order, so all three are
//     bitwise equal;
//   * the decode-height rows (M <= 16) of the 2:4 and ABFT variants:
//     gemm_tile.cuh's sweep_k_variant with the tile of
//     kernels/_build.gemm_tile, the serial K chain of the dense decode tile.
//
// What it computes and how (the inter-k register accumulator, one store
// with the fused epilogue, the operand pairs and scales): see mx_matmul.cu.
//
// Both tiles are chosen in Python and passed in: gemm_tile gives the ABFT
// flag map's grid, the fault operands' grid, abft_rtol and the plain
// version's tiling.  A tile outside the instantiated set returns
// cudaErrorInvalidValue.
#pragma once

#include "abft_tile.cuh"

enum GemmMode : int { kSparseB = 1, kAbftB = 2 };

// Every launch argument past the template parameters.
struct GemmArgs {
  const void *a, *b, *bg;             // A (M, K); B, B_gate (K, N) or 2:4 payloads (K/2, N)
  const uint8_t *b_meta, *bg_meta;    // 2:4 metadata (K/8, N)
  const float *a_scale, *b_scale, *bg_scale;
  const void* bias;
  int bias_dt;
  const void* res;
  int res_dt;
  void* out;
  int out_dt, M, N, K, act, has_scale;
  float out_scale;
  const float* fault_delta;           // (grid_m, grid_n) or null
  const int *fault_row, *fault_col;
  int* flags;                         // (grid_m, grid_n), ABFT only
  float rtol, atol;
};

template <int MODE, typename S, typename TA, typename TB, int BM, int BN, int BK, int TM,
          int TN, bool GATE>
__global__ void __launch_bounds__(TileCfg<BM, BN, BK, TM, TN>::kThreads)
mx_matmul_kernel(const GemmArgs r) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  constexpr bool kSparse = MODE == kSparseB;
  using Abft = AbftHook<Cfg, S, BM, BN, BK, TM, TN>;
  __shared__ S As[BK][BM + 1];
  __shared__ S Bs[BK][BN];
  __shared__ S Bgs[GATE ? BK : 1][BN];
  __shared__ typename std::conditional<MODE == kAbftB, typename Abft::Sm, char>::type ck;

  const int tx = threadIdx.x % Cfg::kTX, ty = threadIdx.x / Cfg::kTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  S acc[TM][TN], accg[TM][TN];  // the inter-k buffer(s)
  const TA* A = static_cast<const TA*>(r.a);
  const TB* B = static_cast<const TB*>(r.b);
  const TB* Bg = static_cast<const TB*>(r.bg);
  if constexpr (MODE == kAbftB) {
    Abft hook(ck);
    hook.reset();
    sweep_k_variant<S, TA, TB, BM, BN, BK, TM, TN, GATE, kSparse>(
        acc, accg, As, Bs, Bgs, A, B, Bg, r.b_meta, r.bg_meta, hook, r.M, r.N, r.K, m0, n0,
        tx, ty);
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (r.fault_delta != nullptr)
      hook.inject(acc, r.fault_delta[tile], r.fault_row[tile], r.fault_col[tile], tx, ty);
    const int bad = hook.verify(acc, r.rtol, r.atol, tx, ty);
    if (threadIdx.x == 0) r.flags[tile] = bad;
  } else {
    NoHook hook;
    sweep_k_variant<S, TA, TB, BM, BN, BK, TM, TN, GATE, kSparse>(
        acc, accg, As, Bs, Bgs, A, B, Bg, r.b_meta, r.bg_meta, hook, r.M, r.N, r.K, m0, n0,
        tx, ty);
  }

  // the single write-back, dequant scales and epilogue applied in registers
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= r.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * Cfg::kTX;
      if (gn < r.N)
        mx_store<GATE>(r, static_cast<float>(acc[i][j]), static_cast<float>(accg[i][j]), gm,
                       gn);
    }
  }
}

template <int MODE, typename S, typename TA, typename TB, int BM, int BN, int BK, int TM,
          int TN>
static void launch(const GemmArgs& r, cudaStream_t stream) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  dim3 grid((r.N + BN - 1) / BN, (r.M + BM - 1) / BM);
  if (r.act == kSwiglu)
    mx_matmul_kernel<MODE, S, TA, TB, BM, BN, BK, TM, TN, true>
        <<<grid, Cfg::kThreads, 0, stream>>>(r);
  else
    mx_matmul_kernel<MODE, S, TA, TB, BM, BN, BK, TM, TN, false>
        <<<grid, Cfg::kThreads, 0, stream>>>(r);
}

// The tile of kernels/_build.gemm_tile at decode height (M <= 16: the
// only rows this loop serves; every pair's M > 16 rows take the
// *_prefill_launch entries).
template <int MODE, typename S, typename TA, typename TB>
static int dispatch(const GemmArgs& r, int bm, int bn, int bk, cudaStream_t s) {
  if (bm != 16 || bn != 16 || bk != 128 || r.M > 16) return static_cast<int>(cudaErrorInvalidValue);
  launch<MODE, S, TA, TB, 16, 16, 128, 1, 1>(r, s);
  return 0;
}

// One operand pair of a source's dispatch_pair (each .cu lists the pairs
// it instantiates; any other returns cudaErrorInvalidValue).
#define REPRO_GEMM_PAIR(MODE, ADT, BDT, S, TA, TB) \
  if (a_dt == ADT && b_dt == BDT) return dispatch<MODE, S, TA, TB>(r, bm, bn, bk, s);

// The tensor-core prefill tile (bf16 or f32 A, M > 16): the 2:4 variant on the
// dense kernel's tile and split, the ABFT variant on gemm_tile's CTA tile
// with split 1 (its checksums over the staged tiles, the verify over the
// finished tile in shared memory).
template <int MODE, typename T, typename TB, int BM, int BN, bool GATE>
__global__ void __launch_bounds__(PrefillCfg<T, BM, BN, GATE, MODE == kSparseB, TB>::kThreads)
mx_matmul_prefill_kernel(const PrefillShape d, const GemmArgs r) {
  constexpr bool kSparse = MODE == kSparseB;
  using Cfg = PrefillCfg<T, BM, BN, GATE, kSparse, TB>;
  typename Cfg::AccT* Cs;
  if constexpr (MODE == kAbftB) {
    using Hook = AbftPrefillHook<Cfg, T, BM, BN>;
    __shared__ typename Hook::Sm ck;
    Hook hook(ck);
    hook.reset();
    Cs = prefill_sweep<T, BM, BN, GATE, false, TB>(d, hook);
    const int tile = pf_tile_m() * gridDim.y + pf_tile_n();  // the (grid_m, grid_n) map
    if (r.fault_delta != nullptr)
      hook.inject(Cs, r.fault_delta[tile], r.fault_row[tile], r.fault_col[tile]);
    const int bad = hook.verify(Cs, r.rtol, r.atol);
    if (threadIdx.x == 0) r.flags[tile] = bad;
  } else {
    NoHook hook;
    Cs = prefill_sweep<T, BM, BN, GATE, kSparse, TB>(d, hook);
  }
  prefill_store<Cfg, BM, BN, GATE>(r, d, Cs);
}

template <int MODE, typename T, typename TB, int BM, int BN>
static int prefill_gate(const PrefillShape& d, const GemmArgs& r, cudaStream_t s) {
  constexpr bool kSparse = MODE == kSparseB;
  if (r.act == kSwiglu)
    return prefill_launch<mx_matmul_prefill_kernel<MODE, T, TB, BM, BN, true>,
                          PrefillCfg<T, BM, BN, true, kSparse, TB>, kSparse>(d, s, true, d, r);
  return prefill_launch<mx_matmul_prefill_kernel<MODE, T, TB, BM, BN, false>,
                        PrefillCfg<T, BM, BN, false, kSparse, TB>, kSparse>(d, s, true, d, r);
}

// The CTA tiles of kernels/_build.prefill_tile: the 2:4 kernel takes every
// one of PREFILL_TILES, the ABFT kernel gemm_tile's (32 x 64, 64 x 64).
// The pairs: f32, bf16, and bf16 with an int8 (2:4 and ABFT) or e4m3 (ABFT)
// weight widened to bf16 in shared memory; int8 x int8 and e4m3 x e4m3
// (ABFT) in their own byte.
template <int MODE>
static int prefill_dispatch(const PrefillShape& d, const GemmArgs& r, int a_dt, int b_dt,
                            int bm, int bn, cudaStream_t s) {
  auto tiles = [&](auto t, auto tb) -> int {
    using T = decltype(t);
    using TB = decltype(tb);
    if (bm == 32 && bn == 64) return prefill_gate<MODE, T, TB, 32, 64>(d, r, s);
    if (bm == 64 && bn == 64) return prefill_gate<MODE, T, TB, 64, 64>(d, r, s);
    if constexpr (MODE == kSparseB)
      if (bm == 64 && bn == 128) return prefill_gate<MODE, T, TB, 64, 128>(d, r, s);
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (a_dt == kF32 && b_dt == kF32) return tiles(float(), float());
  if (a_dt == kBF16 && b_dt == kBF16) return tiles(__nv_bfloat16(), __nv_bfloat16());
  if (a_dt == kBF16 && b_dt == kI8) return tiles(__nv_bfloat16(), int8_t());
  if constexpr (MODE == kAbftB) {
    if (a_dt == kBF16 && b_dt == kF8) return tiles(__nv_bfloat16(), __nv_fp8_e4m3());
    if (a_dt == kI8 && b_dt == kI8) return tiles(int8_t(), int8_t());
    if (a_dt == kF8 && b_dt == kF8) return tiles(__nv_fp8_e4m3(), __nv_fp8_e4m3());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
