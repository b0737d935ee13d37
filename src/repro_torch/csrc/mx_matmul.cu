// MX GEMM with the fused epilogue, for Hopper (sm_90a): dense B (stages 1a
// and 1b).  The 2:4 sparse (1c) and ABFT (1d) variants are
// mx_matmul_sparse.cu and mx_matmul_abft.cu (kernel bodies mx_matmul.cuh),
// on the same two loops.
//
// Replaces the TPU kernel repro/kernels/mx_matmul.py::mx_matmul_fused
// (_fused_kernel): D = epilogue(A @ B [, A @ B_gate]), with quantized
// operands' dequant scales (stage 1b).
//
// The paper's inter-k buffer: one CTA owns one output tile and keeps its
// accumulators in registers for the WHOLE K loop (zeroed at k = 0 -- the
// C-tile reset -- never reloaded, never stored before the end); the
// epilogue is applied in registers and the tile is stored ONCE
// (gemm_tile.cuh's mx_store).  swiglu carries a second accumulator for the
// gate weight.  Epilogue order (repro/kernels/mx_matmul.py L345-366):
// acc * a_scale[m] * b_scale[n] -> bias -> activation, or
// silu(accg * a_scale[m] * bg_scale[n]) * acc -> residual -> out_scale -> cast.
//
// Operand pairs (A, B): (f32, f32), (bf16, bf16), and the quantized ones
// core/precision.NAMED_POLICIES produce: (bf16, int8) "int8", (bf16, fp8)
// "fp8", (int8, int8) "int8_all" / "int8_tensor", (fp8, fp8) "fp8_all".
// Each operand is read in its own width; float pairs accumulate in f32,
// int8 x int8 in exact int32 sums over the whole K loop, widened once at
// the store.  Scales are per row of A (M, 1) and per column of B (1, N),
// constant along K, so they apply once, at the store, to the finished
// accumulator.
//
// Two loops, each tile chosen in Python:
//   * decode (M <= 16; mx_matmul_decode_launch, tile from
//     kernels/_build.decode_tile): HBM-bytes bound weight streaming, the K
//     loop of decode_tile.cuh -- a ring of 16-byte cp.async stages, one
//     barrier per K step, no padding rows, narrow weights kept narrow in
//     shared memory.  Its header says what bounds it and what it does
//     about it.  Threads own (TM rows x 1 column) with TM in {1, 2, 4}.
//   * prefill, every pair (M > 16; mx_matmul_prefill_launch, tile from
//     kernels/_build.prefill_tile): the tensor-core loop of prefill_tile.cuh
//     -- mma.sync (3xTF32 for f32, bf16 with f32 sums; an int8 or e4m3
//     weight beside bf16 copied in its own width and widened to bf16 in
//     shared memory, exactly; int8 x int8 on the s8 m16n8k32 MMA and e4m3 x
//     e4m3 widened exactly to f16 in registers, both operands copied in
//     their own width), a ring of 16-byte
//     cp.async stages, K split across a thread-block cluster (a small grid)
//     or folded part by part in one CTA (a large one), the tile stored once
//     from shared memory.  At M = 64 the weight's bytes and the operations
//     are of one size (f32 K = 8192, N = 2048: 0.020 ms of bytes, 0.013 ms
//     of 3xTF32 products at 495 TFLOP/s), from M = 256 on the products
//     bound it.  Its header says what its design does about it; the times
//     beside the bounds are in PERF.md section 6.
#include "prefill_tile.cuh"  // and decode_tile.cuh, gemm_tile.cuh

REPRO_EXPORT_ERROR_STRING

// The launch arguments past the operands, passed through unchanged.
struct Args {
  const float *a_scale, *b_scale, *bg_scale;
  const void* bias;
  int bias_dt;
  const void* res;
  int res_dt;
  void* out;
  int out_dt, M, N, K, act, has_scale;
  float out_scale;
};

// The decode tile: thread (column c, rows r0 .. r0 + TM - 1) of a CTA that
// owns bn columns and all M rows.
template <typename S, typename TA, typename TB, int TM, bool GATE>
__global__ void __launch_bounds__(kDecodeMaxThreads)
mx_matmul_decode_kernel(const DecodeShape d, const Args r) {
  const int c = threadIdx.x % d.bn, r0 = threadIdx.x / d.bn * TM;
  const int n0 = blockIdx.x * d.bn;
  S acc[TM], accg[TM];  // the inter-k buffer(s)
  NoChunk none;
  NoHook hook;
  decode_sweep<S, TA, TB, TM, GATE, kDecodeDense>(acc, accg, d, n0, c, r0, none, hook);
  if (r0 >= d.M || n0 + c >= d.N) return;  // a copy-only thread, or past N
#pragma unroll
  for (int i = 0; i < TM; ++i)
    mx_store<GATE>(r, static_cast<float>(acc[i]), static_cast<float>(accg[i]), r0 + i, n0 + c);
}

// The tensor-core prefill tile (csrc/prefill_tile.cuh): this CTA's K part(s),
// then the single write-back from shared memory.
template <typename T, typename TB, int BM, int BN, bool GATE>
__device__ __forceinline__ void prefill_body(const PrefillShape& d, const Args& r) {
  NoHook hook;
  const auto* Cs = prefill_sweep<T, BM, BN, GATE, false, TB>(d, hook);
  prefill_store<PrefillCfg<T, BM, BN, GATE, false, TB>, BM, BN, GATE>(r, d, Cs);
}

template <typename T, typename TB, int BM, int BN, bool GATE>
__global__ void __launch_bounds__(PrefillCfg<T, BM, BN, GATE, false, TB>::kThreads)
mx_matmul_prefill_kernel(const PrefillShape d, const Args r) {
  prefill_body<T, TB, BM, BN, GATE>(d, r);
}

// The same, two CTAs per SM (PrefillCfg::kTwoPerSm).
template <typename T, typename TB, int BM, int BN, bool GATE>
__global__ void __launch_bounds__(PrefillCfg<T, BM, BN, GATE, false, TB>::kThreads, 2)
mx_matmul_prefill_kernel_2(const PrefillShape d, const Args r) {
  prefill_body<T, TB, BM, BN, GATE>(d, r);
}

template <typename T, typename TB, int BM, int BN>
static int prefill_gate(const PrefillShape& d, const Args& r, cudaStream_t s) {
  using Cfg = PrefillCfg<T, BM, BN, false, false, TB>;
  if (r.act == kSwiglu)
    return prefill_launch<mx_matmul_prefill_kernel<T, TB, BM, BN, true>,
                          PrefillCfg<T, BM, BN, true, false, TB>, false>(d, s, true, d, r);
  if constexpr (Cfg::kTwoPerSm)
    return prefill_launch<mx_matmul_prefill_kernel_2<T, TB, BM, BN, false>, Cfg, false>(
        d, s, true, d, r);
  else
    return prefill_launch<mx_matmul_prefill_kernel<T, TB, BM, BN, false>, Cfg, false>(
        d, s, true, d, r);
}

// The CTA tiles of kernels/_build.PREFILL_TILES.
template <typename T, typename TB>
static int prefill_dispatch(const PrefillShape& d, const Args& r, int bm, int bn,
                            cudaStream_t s) {
  if (bm == 32 && bn == 64) return prefill_gate<T, TB, 32, 64>(d, r, s);
  if (bm == 64 && bn == 64) return prefill_gate<T, TB, 64, 64>(d, r, s);
  if (bm == 64 && bn == 128) return prefill_gate<T, TB, 64, 128>(d, r, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename S, typename TA, typename TB, int TM>
static int decode_gate(const DecodeShape& d, const Args& r, cudaStream_t s) {
  if (r.act == kSwiglu)
    return decode_launch<TA, TB, TM, true, kDecodeDense>(
        mx_matmul_decode_kernel<S, TA, TB, TM, true>, d, s, r);
  return decode_launch<TA, TB, TM, false, kDecodeDense>(
      mx_matmul_decode_kernel<S, TA, TB, TM, false>, d, s, r);
}

template <typename S, typename TA, typename TB>
static int decode_dispatch(const DecodeShape& d, const Args& r, int tm, cudaStream_t s) {
  switch (tm) {
    case 1: return decode_gate<S, TA, TB, 1>(d, r, s);
    case 2: return decode_gate<S, TA, TB, 2>(d, r, s);
    case 4: return decode_gate<S, TA, TB, 4>(d, r, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The decode rows (M <= 16).  a (M, K) of dtype a_dt; b, b_gate (K, N) of
// dtype b_dt, one of the pairs above; row-major, contiguous.  a_scale (M,),
// b_scale / bg_scale (N,) f32 or null.  bias (N,), residual (M, N), out
// (M, N): their own dtypes; null when absent.  The tile of
// kernels/_build.decode_tile -- bn columns per CTA, bk K rows per ring
// stage, tm rows per thread, `stages` ring slots, `threads` per CTA (those
// past M / tm * bn only copy) -- and the copy widths va
// / vb (bytes) of A's and B's rows (kernels/_build.copy_width).  A tile or
// width that decode_check refuses returns cudaErrorInvalidValue.
extern "C" int mx_matmul_decode_launch(const void* a, const void* b, const void* b_gate,
                                       const void* a_scale, const void* b_scale,
                                       const void* bg_scale, const void* bias, int bias_dt,
                                       const void* residual, int res_dt, void* out,
                                       int out_dt, int M, int N, int K, int a_dt, int b_dt,
                                       int act, int has_scale, float out_scale, int bn,
                                       int bk, int tm, int stages, int threads, int va,
                                       int vb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args r{static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
               static_cast<const float*>(bg_scale), bias, bias_dt, residual, res_dt, out,
               out_dt, M, N, K, act, has_scale, out_scale};
  const DecodeShape d{a, b, act == kSwiglu ? b_gate : nullptr, M, N, K, bn, bk, stages,
                      threads, va, vb, nullptr, nullptr, 0};
  const int err = with_pair(a_dt, b_dt, [&](auto s_, auto ta, auto tb) {
    return decode_dispatch<decltype(s_), decltype(ta), decltype(tb)>(d, r, tm, s);
  });
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core prefill tile (f32 x f32, bf16 x bf16, bf16 x int8 / e4m3
// with the weight widened to bf16 in shared memory, int8 x int8 and e4m3 x
// e4m3 in their own byte): as mx_matmul_decode_launch, with the tile of
// kernels/_build.prefill_tile --
// (bm, bn) CTA tile, `stages` ring slots, K cut into `parts` parts, `split`
// CTAs per cluster (1 or parts) -- and the copy widths va / vb (bytes) of
// A's and B's rows (kernels/_build.copy_width).  A pair, tile or width that
// prefill_check refuses returns cudaErrorInvalidValue.
extern "C" int mx_matmul_prefill_launch(const void* a, const void* b, const void* b_gate,
                                        const void* a_scale, const void* b_scale,
                                        const void* bg_scale, const void* bias, int bias_dt,
                                        const void* residual, int res_dt, void* out,
                                        int out_dt, int M, int N, int K, int a_dt, int b_dt,
                                        int act, int has_scale, float out_scale, int bm,
                                        int bn, int stages, int split, int parts, int va,
                                        int vb, int vm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args r{static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
               static_cast<const float*>(bg_scale), bias, bias_dt, residual, res_dt, out,
               out_dt, M, N, K, act, has_scale, out_scale};
  const PrefillShape d{a, b, act == kSwiglu ? b_gate : nullptr, nullptr, nullptr, M, N, K,
                       stages, split, parts, va, vb, vm};
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (a_dt == kF32 && b_dt == kF32)
    err = prefill_dispatch<float, float>(d, r, bm, bn, s);
  else if (a_dt == kBF16 && b_dt == kBF16)
    err = prefill_dispatch<__nv_bfloat16, __nv_bfloat16>(d, r, bm, bn, s);
  else if (a_dt == kBF16 && b_dt == kI8)
    err = prefill_dispatch<__nv_bfloat16, int8_t>(d, r, bm, bn, s);
  else if (a_dt == kBF16 && b_dt == kF8)
    err = prefill_dispatch<__nv_bfloat16, __nv_fp8_e4m3>(d, r, bm, bn, s);
  else if (a_dt == kI8 && b_dt == kI8)
    err = prefill_dispatch<int8_t, int8_t>(d, r, bm, bn, s);
  else if (a_dt == kF8 && b_dt == kF8)
    err = prefill_dispatch<__nv_fp8_e4m3, __nv_fp8_e4m3>(d, r, bm, bn, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
