// MX GEMM with the fused epilogue, for Hopper (sm_90a): the kernel bodies of
// its 2:4 sparse variant (mx_matmul_sparse.cu, stage 1c) and its ABFT
// variant (mx_matmul_abft.cu, checksums and the per-tile flag map, stage
// 1d), each source built by its own nvcc, all in parallel.  Each is the
// dense kernel of mx_matmul.cu (stages 1a / 1b) with, for ABFT, the verify
// at the store, on the dense kernel's two K loops:
//   * the decode-height rows (M <= 16; the *_launch entries): decode_tile.cuh's
//     weight-streaming ring with the tile of kernels/_build.decode_tile
//     (variant "sparse" or "abft"), the 2:4 payloads and metadata copied
//     raw and expanded in registers, the ABFT checksums beside the dense
//     chain (abft_tile.cuh AbftDecodeHook) over gemm_tile's 16-column flag
//     tiles; both bitwise the dense decode tile;
//   * every pair at M > 16 (the *_prefill_launch entries; 2:4 only for its
//     pairs): the dense kernel's tensor-core loop, prefill_tile.cuh, the
//     2:4 payloads expanded (and a narrow weight widened) into the same
//     staged B tile, int8 x int8 and e4m3 x e4m3 in their own byte; the
//     dense and 2:4 kernels share the tile of kernels/_build.prefill_tile,
//     the ABFT kernel runs gemm_tile's CTA tile with split 1 (one CTA per
//     flag), folding the same K parts in the same order, so all three are
//     bitwise equal.
//
// What it computes and how (the inter-k register accumulator, one store
// with the fused epilogue, the operand pairs and scales): see mx_matmul.cu.
//
// Both tiles are chosen in Python and passed in; gemm_tile gives the ABFT
// flag map's grid, the fault operands' grid, abft_rtol and the plain
// version's tiling.  A tile outside the instantiated set returns
// cudaErrorInvalidValue.
#pragma once

#include "abft_tile.cuh"

enum GemmMode : int { kSparseB = 1, kAbftB = 2 };

// Every launch argument past the operands (DecodeShape / PrefillShape).
struct GemmArgs {
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

// The decode tile (M <= 16; csrc/decode_tile.cuh): thread (column c, rows
// r0 .. r0 + TM - 1) of a CTA that owns bn columns and all M rows; the 2:4
// variant streams the payloads and metadata, the ABFT variant keeps the
// checksums of its flag tiles beside the dense chain and writes their
// flags before the store.
template <int MODE, typename S, typename TA, typename TB, int TM, bool GATE>
__global__ void __launch_bounds__(kDecodeMaxThreads)
mx_matmul_decode_variant_kernel(const DecodeShape d, const GemmArgs r) {
  const int c = threadIdx.x % d.bn, r0 = threadIdx.x / d.bn * TM;
  const int n0 = blockIdx.x * d.bn;
  S acc[TM], accg[TM];  // the inter-k buffer(s)
  NoChunk none;
  if constexpr (MODE == kAbftB) {
    extern __shared__ __align__(16) unsigned char decode_ring[];  // the ring, then the scratch
    const DecodeSlot L = decode_slot<TA, TB, GATE, kDecodeAbft>(d);
    AbftDecodeHook<S, TA, TB, TM> hook(d, decode_ring + d.stages * L.bytes);
    decode_sweep<S, TA, TB, TM, GATE, kDecodeAbft>(acc, accg, d, n0, c, r0, none, hook);
    hook.finish(acc, d, r, n0, c, r0);
  } else {
    NoHook hook;
    decode_sweep<S, TA, TB, TM, GATE, kDecodeSparse>(acc, accg, d, n0, c, r0, none, hook);
  }
  if (r0 >= d.M || n0 + c >= d.N) return;  // a copy-only thread, or past N
#pragma unroll
  for (int i = 0; i < TM; ++i)
    mx_store<GATE>(r, static_cast<float>(acc[i]), static_cast<float>(accg[i]), r0 + i, n0 + c);
}

template <int MODE, typename S, typename TA, typename TB, int TM>
static int decode_variant_gate(const DecodeShape& d, const GemmArgs& r, cudaStream_t s) {
  constexpr int kVar = MODE == kSparseB ? kDecodeSparse : kDecodeAbft;
  if (r.act == kSwiglu)
    return decode_launch<TA, TB, TM, true, kVar>(
        mx_matmul_decode_variant_kernel<MODE, S, TA, TB, TM, true>, d, s, r);
  return decode_launch<TA, TB, TM, false, kVar>(
      mx_matmul_decode_variant_kernel<MODE, S, TA, TB, TM, false>, d, s, r);
}

// The decode tile of kernels/_build.decode_tile (its tm: 1, 2 or 4 rows per
// thread); any other tile returns cudaErrorInvalidValue (decode_check).
template <int MODE, typename S, typename TA, typename TB>
static int decode_variant_dispatch(const DecodeShape& d, const GemmArgs& r, int tm,
                                   cudaStream_t s) {
  switch (tm) {
    case 1: return decode_variant_gate<MODE, S, TA, TB, 1>(d, r, s);
    case 2: return decode_variant_gate<MODE, S, TA, TB, 2>(d, r, s);
    case 4: return decode_variant_gate<MODE, S, TA, TB, 4>(d, r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
