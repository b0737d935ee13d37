// MX GEMM with the fused epilogue, for Hopper (sm_90a): dense B (stages 1a
// and 1b).  The 2:4 sparse (1c) and ABFT (1d) variants are
// mx_matmul_sparse.cu and mx_matmul_abft.cu (kernel body mx_matmul.cuh).
//
// Replaces the TPU kernel repro/kernels/mx_matmul.py::mx_matmul_fused
// (_fused_kernel): D = epilogue(A @ B [, A @ B_gate]), with quantized
// operands' dequant scales (stage 1b).
//
// The paper's inter-k buffer: one CTA owns one (BM x BN) output tile and
// keeps its accumulators in registers for the WHOLE K loop (zeroed at
// k = 0 -- the C-tile reset -- never reloaded); A and B tiles stage through
// shared memory, the next K step's operands are fetched into registers
// while the current step's MACs run; the epilogue is applied in registers
// and the tile is stored ONCE.  swiglu carries a second accumulator for
// the gate weight.  Epilogue order (repro/kernels/mx_matmul.py L345-366):
// acc * a_scale[m] * b_scale[n] -> bias -> activation, or
// silu(accg * a_scale[m] * bg_scale[n]) * acc -> residual -> out_scale -> cast.
//
// Operand pairs (A, B): (f32, f32), (bf16, bf16), and the quantized ones
// core/precision.NAMED_POLICIES produce: (bf16, int8) "int8", (bf16, fp8)
// "fp8", (int8, int8) "int8_all" / "int8_tensor", (fp8, fp8) "fp8_all".
// Each operand is read in its own width and widened in registers; float
// pairs accumulate in f32, int8 x int8 in an exact int32 MAC over the
// whole K loop, widened once at the store.  Scales are per row of A (M, 1)
// and per column of B (1, N), constant along K, so they apply once, at the
// store, to the finished accumulator.
//
// What bounds it on the H100: at decode (M = slots, e.g. 8) the GEMM reads
// the whole weight for a handful of rows -- HBM bytes bound (3.35 TB/s),
// and an int8 / fp8 weight halves or quarters those bytes.  The small-M
// tile (BM = 16, BK = 128) keeps one K step of weight in flight per CTA,
// and narrow BN = 16 tiles spread the weight over more CTAs (128 for
// N = 2048); a narrow weight is still read one byte per thread per load,
// far from the bound.  At prefill (M = chunk) it is FLOP bound: the MACs
// run on the CUDA cores (67 TFLOP/s f32 outside the tensor cores), in
// 2 x 4 (M <= 64) or 4 x 4 register tiles per thread over 32 x 64 or 64 x 64
// CTA tiles.  Tensor cores (wgmma), TMA, vector loads and warp
// specialisation are left to later work.
#include "gemm_tile.cuh"

REPRO_EXPORT_ERROR_STRING

template <typename S, typename TA, typename TB, int BM, int BN, int BK, int TM, int TN,
          bool GATE>
__global__ void __launch_bounds__(TileCfg<BM, BN, BK, TM, TN>::kThreads)
mx_matmul_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                 const TB* __restrict__ Bg, const float* __restrict__ a_scale,
                 const float* __restrict__ b_scale, const float* __restrict__ bg_scale,
                 const void* __restrict__ bias, int bias_dt, const void* __restrict__ res,
                 int res_dt, void* __restrict__ out, int out_dt, int M, int N, int K, int act,
                 int has_scale, float out_scale) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  __shared__ S As[BK][BM + 1];
  __shared__ S Bs[BK][BN];
  __shared__ S Bgs[GATE ? BK : 1][BN];

  const int tx = threadIdx.x % Cfg::kTX, ty = threadIdx.x / Cfg::kTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  S acc[TM][TN], accg[TM][TN];  // the inter-k buffer(s)
  sweep_k<S, TA, TB, BM, BN, BK, TM, TN, GATE>(acc, accg, As, Bs, Bgs, A, B, Bg, M, N, K, m0,
                                               n0, tx, ty);

  // the single write-back, dequant scales and epilogue applied in registers
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
    const float as = a_scale != nullptr ? a_scale[gm] : 1.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * Cfg::kTX;
      if (gn >= N) continue;
      float y = static_cast<float>(acc[i][j]);
      if (a_scale != nullptr) y *= as;
      if (b_scale != nullptr) y *= b_scale[gn];
      if (bias != nullptr) y += load_dt(bias, bias_dt, gn);
      if constexpr (GATE) {
        float gate = static_cast<float>(accg[i][j]);
        if (a_scale != nullptr) gate *= as;
        if (bg_scale != nullptr) gate *= bg_scale[gn];
        y = silu_f(gate) * y;
      } else {
        y = activation_f(y, act);
      }
      const int64_t o = (int64_t)gm * N + gn;
      if (res != nullptr) y += load_dt(res, res_dt, o);
      if (has_scale) y *= out_scale;
      store_dt(out, out_dt, o, y);
    }
  }
}

// The launch arguments past the operand pointers, passed through unchanged.
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

template <typename S, typename TA, typename TB, int BM, int BN, int BK, int TM, int TN>
static void launch(const void* a, const void* b, const void* bg, const Args& r,
                   cudaStream_t stream) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  dim3 grid((r.N + BN - 1) / BN, (r.M + BM - 1) / BM);
  const TA* A = static_cast<const TA*>(a);
  const TB* B = static_cast<const TB*>(b);
  if (r.act == kSwiglu)
    mx_matmul_kernel<S, TA, TB, BM, BN, BK, TM, TN, true>
        <<<grid, Cfg::kThreads, 0, stream>>>(
            A, B, static_cast<const TB*>(bg), r.a_scale, r.b_scale, r.bg_scale, r.bias,
            r.bias_dt, r.res, r.res_dt, r.out, r.out_dt, r.M, r.N, r.K, r.act, r.has_scale,
            r.out_scale);
  else
    mx_matmul_kernel<S, TA, TB, BM, BN, BK, TM, TN, false>
        <<<grid, Cfg::kThreads, 0, stream>>>(
            A, B, nullptr, r.a_scale, r.b_scale, nullptr, r.bias, r.bias_dt, r.res,
            r.res_dt, r.out, r.out_dt, r.M, r.N, r.K, r.act, r.has_scale, r.out_scale);
}

// The tiles of kernels/_build.gemm_tile (the one tile rule: the caller
// passes the tile, and no other is instantiated): decode (M <= 16:
// HBM-bound weight streaming, narrow tiles for more CTAs), a prefill chunk
// (M <= 64: FMA-bound, half-height tiles), larger M.
template <typename S, typename TA, typename TB>
static int dispatch(const void* a, const void* b, const void* bg, const Args& r, int bm,
                    int bn, int bk, cudaStream_t s) {
  if (bm == 16 && bn == 16 && bk == 128)
    launch<S, TA, TB, 16, 16, 128, 1, 1>(a, b, bg, r, s);
  else if (bm == 32 && bn == 64 && bk == 16)
    launch<S, TA, TB, 32, 64, 16, 2, 4>(a, b, bg, r, s);
  else if (bm == 64 && bn == 64 && bk == 16)
    launch<S, TA, TB, 64, 64, 16, 4, 4>(a, b, bg, r, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// a (M, K) of dtype a_dt; b, b_gate (K, N) of dtype b_dt, one of the pairs
// above; row-major, contiguous.  a_scale (M,), b_scale / bg_scale (N,) f32
// or null.  bias (N,), residual (M, N), out (M, N): their own dtypes; null
// when absent.  (bm, bn, bk): the tile, one of `dispatch`'s.  An unsupported
// pair or tile returns cudaErrorInvalidValue.
extern "C" int mx_matmul_fused_launch(const void* a, const void* b, const void* b_gate,
                                      const void* a_scale, const void* b_scale,
                                      const void* bg_scale, const void* bias, int bias_dt,
                                      const void* residual, int res_dt, void* out,
                                      int out_dt, int M, int N, int K, int a_dt, int b_dt,
                                      int act, int has_scale, float out_scale, int bm,
                                      int bn, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args r{static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
               static_cast<const float*>(bg_scale), bias, bias_dt, residual, res_dt, out,
               out_dt, M, N, K, act, has_scale, out_scale};
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (a_dt == kF32 && b_dt == kF32)
    err = dispatch<float, float, float>(a, b, b_gate, r, bm, bn, bk, s);
  else if (a_dt == kBF16 && b_dt == kBF16)
    err = dispatch<float, __nv_bfloat16, __nv_bfloat16>(a, b, b_gate, r, bm, bn, bk, s);
  else if (a_dt == kBF16 && b_dt == kI8)
    err = dispatch<float, __nv_bfloat16, int8_t>(a, b, b_gate, r, bm, bn, bk, s);
  else if (a_dt == kBF16 && b_dt == kF8)
    err = dispatch<float, __nv_bfloat16, __nv_fp8_e4m3>(a, b, b_gate, r, bm, bn, bk, s);
  else if (a_dt == kI8 && b_dt == kI8)
    err = dispatch<int, int8_t, int8_t>(a, b, b_gate, r, bm, bn, bk, s);
  else if (a_dt == kF8 && b_dt == kF8)
    err = dispatch<float, __nv_fp8_e4m3, __nv_fp8_e4m3>(a, b, b_gate, r, bm, bn, bk, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
