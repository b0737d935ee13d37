// MX GEMM with the fused epilogue, for Hopper (sm_90a): the kernel body of
// its 2:4 sparse variant (mx_matmul_sparse.cu, stage 1c) and its ABFT
// variant (mx_matmul_abft.cu, checksums and the per-tile flag map, stage
// 1d), each source built by its own nvcc, all in parallel.  It is the
// dense kernel of mx_matmul.cu (stages 1a / 1b) with the K loop of
// gemm_tile.cuh's sweep_k_variant and, for ABFT, the verify at the store.
//
// What it computes and how (the inter-k register accumulator, one store
// with the fused epilogue, the operand pairs and scales): see mx_matmul.cu.
//
// The tile is chosen in Python (kernels/_build.gemm_tile, by M) and passed
// in: the same table gives the ABFT flag map's grid, the fault operands'
// grid, abft_rtol and the plain version's tiling.  A tile outside the
// instantiated set returns cudaErrorInvalidValue.
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

// The tiles of kernels/_build.gemm_tile: decode (M <= 16: HBM-bound weight
// streaming, narrow tiles for more CTAs), a prefill chunk (M <= 64:
// FMA-bound, half-height tiles), larger M.
template <int MODE, typename S, typename TA, typename TB>
static int dispatch(const GemmArgs& r, int bm, int bn, int bk, cudaStream_t s) {
  if (bm == 16 && bn == 16 && bk == 128)
    launch<MODE, S, TA, TB, 16, 16, 128, 1, 1>(r, s);
  else if (bm == 32 && bn == 64 && bk == 16)
    launch<MODE, S, TA, TB, 32, 64, 16, 2, 4>(r, s);
  else if (bm == 64 && bn == 64 && bk == 16)
    launch<MODE, S, TA, TB, 64, 64, 16, 4, 4>(r, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// One operand pair of a source's dispatch_pair (each .cu lists the pairs
// it instantiates; any other returns cudaErrorInvalidValue).
#define REPRO_GEMM_PAIR(MODE, ADT, BDT, S, TA, TB) \
  if (a_dt == ADT && b_dt == BDT) return dispatch<MODE, S, TA, TB>(r, bm, bn, bk, s);
