// MX GEMM with the fused epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mx_matmul.py::mx_matmul_fused
// (_fused_kernel): D = epilogue(A @ B [, A @ B_gate]).
//
// The paper's inter-k buffer: one CTA owns one (BM x BN) output tile and
// keeps its f32 accumulators in registers for the WHOLE K loop (zeroed at
// k = 0 -- the C-tile reset -- never reloaded); A and B tiles stage through
// shared memory, the next K step's operands are fetched into registers
// while the current step's FMAs run; the epilogue is applied in registers
// and the tile is stored ONCE.  swiglu carries a second accumulator for
// the gate weight.  Epilogue order (repro/kernels/mx_matmul.apply_epilogue
// L178-196): bias -> activation, or silu(gate) * (acc + bias) -> residual
// -> out_scale -> cast.
//
// What bounds it on the H100: at decode (M = slots, e.g. 8) the GEMM reads
// the whole weight for a handful of rows -- HBM bytes bound (3.35 TB/s).
// The small-M tile (BM = 16, BK = 128) keeps 8 KB of weight per K step in
// flight per CTA, and narrow BN = 16 tiles spread the weight over more CTAs
// (128 for N = 2048).  At prefill (M = chunk) it is f32 FLOP bound: the
// FMAs run on the CUDA cores (67 TFLOP/s f32 outside the tensor cores), in
// 2 x 4 (M <= 64) or 4 x 4 register tiles per thread over 32 x 64 or 64 x 64
// CTA tiles.  Tensor cores (wgmma), TMA and warp
// specialisation are left to later work.
#include "gemm_tile.cuh"

REPRO_EXPORT_ERROR_STRING

template <typename T, int BM, int BN, int BK, int TM, int TN, bool GATE>
__global__ void __launch_bounds__(TileCfg<BM, BN, BK, TM, TN>::kThreads)
mx_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                 const T* __restrict__ Bg, const void* __restrict__ bias, int bias_dt,
                 const void* __restrict__ res, int res_dt, void* __restrict__ out,
                 int out_dt, int M, int N, int K, int act, int has_scale,
                 float out_scale) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  __shared__ float Bgs[GATE ? BK : 1][BN];

  const int tx = threadIdx.x % Cfg::kTX, ty = threadIdx.x / Cfg::kTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN], accg[TM][TN];  // the inter-k buffer(s)
  sweep_k<T, BM, BN, BK, TM, TN, GATE>(acc, accg, As, Bs, Bgs, A, B, Bg, M, N, K, m0, n0,
                                       tx, ty);

  // the single write-back, epilogue applied in registers
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * Cfg::kTX;
      if (gn >= N) continue;
      float y = acc[i][j];
      if (bias != nullptr) y += load_dt(bias, bias_dt, gn);
      if constexpr (GATE)
        y = silu_f(accg[i][j]) * y;
      else
        y = activation_f(y, act);
      const int64_t o = (int64_t)gm * N + gn;
      if (res != nullptr) y += load_dt(res, res_dt, o);
      if (has_scale) y *= out_scale;
      store_dt(out, out_dt, o, y);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
static void launch(const void* a, const void* b, const void* bg, const void* bias,
                   int bias_dt, const void* res, int res_dt, void* out, int out_dt,
                   int M, int N, int K, int act, int has_scale, float out_scale,
                   cudaStream_t stream) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  if (act == kSwiglu)
    mx_matmul_kernel<T, BM, BN, BK, TM, TN, true><<<grid, Cfg::kThreads, 0, stream>>>(
        A, B, static_cast<const T*>(bg), bias, bias_dt, res, res_dt, out, out_dt, M, N, K,
        act, has_scale, out_scale);
  else
    mx_matmul_kernel<T, BM, BN, BK, TM, TN, false><<<grid, Cfg::kThreads, 0, stream>>>(
        A, B, nullptr, bias, bias_dt, res, res_dt, out, out_dt, M, N, K, act, has_scale,
        out_scale);
}

template <typename T>
static void dispatch(const void* a, const void* b, const void* bg, const void* bias,
                     int bias_dt, const void* res, int res_dt, void* out, int out_dt,
                     int M, int N, int K, int act, int has_scale, float out_scale,
                     cudaStream_t s) {
  if (M <= 16)  // decode: HBM-bound weight streaming, narrow tiles for more CTAs
    launch<T, 16, 16, 128, 1, 1>(a, b, bg, bias, bias_dt, res, res_dt, out, out_dt, M, N,
                                 K, act, has_scale, out_scale, s);
  else if (M <= 64)  // a prefill chunk: f32 FMA-bound, half-height tiles
    launch<T, 32, 64, 16, 2, 4>(a, b, bg, bias, bias_dt, res, res_dt, out, out_dt, M, N, K,
                                act, has_scale, out_scale, s);
  else
    launch<T, 64, 64, 16, 4, 4>(a, b, bg, bias, bias_dt, res, res_dt, out, out_dt, M, N, K,
                                act, has_scale, out_scale, s);
}

// a, b, b_gate: operand dtype `in_dt` (f32 or bf16), row-major, contiguous.
// bias (N,), residual (M, N), out (M, N): their own dtypes; null when absent.
extern "C" int mx_matmul_fused_launch(const void* a, const void* b, const void* b_gate,
                                      const void* bias, int bias_dt, const void* residual,
                                      int res_dt, void* out, int out_dt, int M, int N, int K,
                                      int in_dt, int act, int has_scale, float out_scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dt == kBF16)
    dispatch<__nv_bfloat16>(a, b, b_gate, bias, bias_dt, residual, res_dt, out, out_dt, M,
                            N, K, act, has_scale, out_scale, s);
  else
    dispatch<float>(a, b, b_gate, bias, bias_dt, residual, res_dt, out, out_dt, M, N, K,
                    act, has_scale, out_scale, s);
  return static_cast<int>(cudaGetLastError());
}
