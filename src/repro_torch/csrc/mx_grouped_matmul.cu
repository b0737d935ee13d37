// Grouped (ragged) MX GEMM for Hopper (sm_90a): every expert of an MoE
// layer in one launch; dense experts (stages 5a and 5b).  The 2:4 sparse
// (5c) and ABFT (5d) variants are mx_grouped_matmul_sparse.cu and
// mx_grouped_matmul_abft.cu (kernel body mx_grouped_matmul.cuh).
//
// Replaces the TPU kernel repro/kernels/mx_grouped_matmul.py::
// mx_grouped_matmul (_grouped_kernel): out[t] = act(x[t] @ w[g(t)]) for rows
// sorted by group, group g owning the next sizes[g] rows; swiglu gates with
// a second weight set, silu(x @ w_gate[g]) * (x @ w[g]).  Rows at or past
// sum(sizes) are written as exact zeros.
//
// Quantized experts (stage 5b): x and w take the operand pairs of
// mx_matmul.cu -- (f32, f32), (bf16, bf16), (bf16, int8), (bf16, fp8),
// (int8, int8) in an exact int32 MAC, (fp8, fp8) -- with per-row a_scale
// (T,) and per-expert per-column b_scale / bg_scale (G, N), applied at the
// store of each group's rows in JAX's order (acc * a_scale[t] * b_scale[g, n],
// the gate likewise with bg_scale, then the activation).  A row tile that
// straddles groups applies each group's own scales to that group's rows.
//
// The TPU kernel steers its DMAs with per-slot (group, row tile) maps from
// scalar prefetch and visits a straddled row tile once per group, merging
// the visits in VMEM.  Here the grid is static, one CTA per (BM x BN)
// output tile, and the CTA reads the group sizes itself: a running sum over
// them gives each group's rows (clamped to T, as make_group_metadata clamps
// to the padded rows, so oversubscribed sizes drop rows that do not exist;
// a negative size counts as 0).  For every non-empty group that overlaps its
// rows the CTA runs the whole K loop over that expert's weights with f32
// accumulators in registers (the paper's inter-k buffer, zeroed per group),
// applies the epilogue in registers and stores only the rows the group
// owns; rows past the last group are stored as zeros.  Each output row is
// written once, by one CTA: the TPU kernel's first-writer merge has nothing
// left to do.  Empty groups cost one step of the scan and no weight bytes.
//
// Weight offsets are int64: kimi-k2's (384, 7168, 2048) expert stack holds
// 5.64 G elements, past int32.
//
// What bounds it on the H100: at decode (8 rows per expert) every expert's
// weights are streamed for a handful of rows -- HBM bytes bound (3.35 TB/s).
// That tile keeps one thread per output column over all 8 rows (8 FMAs per
// staged weight element, so shared memory is not the limit) and 128-column
// CTAs, 2048 of them for grok's up projection.  An int8 / fp8 expert stack
// moves a quarter of the f32 bytes, still one byte per thread per load, far
// from that bound.  At an expert-major prefill
// chunk (128 rows per expert) it is f32 FLOP bound on the CUDA cores (67
// TFLOP/s), on the MX GEMM's 4 x 4 register tiles.  Tensor cores (wgmma),
// TMA and a persistent group-aware schedule are left to later work.
#include "gemm_tile.cuh"

REPRO_EXPORT_ERROR_STRING

template <typename S, typename TA, typename TB, int BM, int BN, int BK, int TM, int TN,
          bool GATE>
__global__ void __launch_bounds__(TileCfg<BM, BN, BK, TM, TN>::kThreads)
grouped_kernel(const TA* __restrict__ X, const TB* __restrict__ W, const TB* __restrict__ Wg,
               const float* __restrict__ a_scale, const float* __restrict__ b_scale,
               const float* __restrict__ bg_scale, const int* __restrict__ sizes,
               void* __restrict__ out, int out_dt, int Trows, int N, int K, int G, int act) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  __shared__ S As[BK][BM + 1];
  __shared__ S Bs[BK][BN];
  __shared__ S Bgs[GATE ? BK : 1][BN];

  const int tx = threadIdx.x % Cfg::kTX, ty = threadIdx.x / Cfg::kTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int m1 = min(m0 + BM, Trows);
  const int64_t kn = (int64_t)K * N;

  int64_t cum = 0;  // rows owned by groups [0, g)
  for (int g = 0; g < G; ++g) {
    const int s = (int)min(cum, (int64_t)Trows);
    cum += max(sizes[g], 0);
    const int e = (int)min(cum, (int64_t)Trows);
    if (e <= m0 || s >= m1 || s == e) continue;  // no rows of this tile

    S acc[TM][TN], accg[TM][TN];  // this group's inter-k buffer(s)
    sweep_k<S, TA, TB, BM, BN, BK, TM, TN, GATE>(acc, accg, As, Bs, Bgs, X, W + g * kn,
                                                 GATE ? Wg + g * kn : nullptr, e, N, K, m0,
                                                 n0, tx, ty);
    // the single write-back of the rows group g owns, this group's dequant
    // scales and the epilogue applied in registers
    const float* bs = b_scale != nullptr ? b_scale + (int64_t)g * N : nullptr;
    const float* bgs = bg_scale != nullptr ? bg_scale + (int64_t)g * N : nullptr;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
      if (gm < s || gm >= e) continue;
      const float as = a_scale != nullptr ? a_scale[gm] : 1.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + j * Cfg::kTX;
        if (gn >= N) continue;
        float y = static_cast<float>(acc[i][j]);
        if (a_scale != nullptr) y *= as;
        if (bs != nullptr) y *= bs[gn];
        if constexpr (GATE) {
          float gate = static_cast<float>(accg[i][j]);
          if (a_scale != nullptr) gate *= as;
          if (bgs != nullptr) gate *= bgs[gn];
          y = silu_f(gate) * y;
        } else {
          y = activation_f(y, act);
        }
        store_dt(out, out_dt, (int64_t)gm * N + gn, y);
      }
    }
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
      if (gn < N) store_dt(out, out_dt, (int64_t)gm * N + gn, 0.0f);
    }
  }
}

// The launch arguments past the operand pointers, passed through unchanged.
struct Args {
  const float *a_scale, *b_scale, *bg_scale;
  const int* sizes;
  void* out;
  int out_dt, T, N, K, G, act;
};

template <typename S, typename TA, typename TB, int BM, int BN, int BK, int TM, int TN>
static void launch(const void* x, const void* w, const void* wg, const Args& r,
                   cudaStream_t stream) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  dim3 grid((r.N + BN - 1) / BN, (r.T + BM - 1) / BM);
  const TA* X = static_cast<const TA*>(x);
  const TB* W = static_cast<const TB*>(w);
  if (r.act == kSwiglu)
    grouped_kernel<S, TA, TB, BM, BN, BK, TM, TN, true><<<grid, Cfg::kThreads, 0, stream>>>(
        X, W, static_cast<const TB*>(wg), r.a_scale, r.b_scale, r.bg_scale, r.sizes, r.out,
        r.out_dt, r.T, r.N, r.K, r.G, r.act);
  else
    grouped_kernel<S, TA, TB, BM, BN, BK, TM, TN, false><<<grid, Cfg::kThreads, 0, stream>>>(
        X, W, nullptr, r.a_scale, r.b_scale, nullptr, r.sizes, r.out, r.out_dt, r.T, r.N,
        r.K, r.G, r.act);
}

// The tiles of kernels/_build.grouped_tile, which follows the mean rows per
// group, T / G, as the JAX dispatch plans for max(T // G, 1): the rows one
// expert's weights are streamed for.  The caller passes the tile.
template <typename S, typename TA, typename TB>
static int dispatch(const void* x, const void* w, const void* wg, const Args& r, int bm,
                    int bn, int bk, cudaStream_t s) {
  if (bm == 8 && bn == 128 && bk == 32)  // decode: bytes bound, a thread per column
    launch<S, TA, TB, 8, 128, 32, 8, 1>(x, w, wg, r, s);
  else if (bm == 32 && bn == 64 && bk == 16)
    launch<S, TA, TB, 32, 64, 16, 2, 4>(x, w, wg, r, s);
  else if (bm == 64 && bn == 64 && bk == 16)  // an expert-major prefill chunk
    launch<S, TA, TB, 64, 64, 16, 4, 4>(x, w, wg, r, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// x (T, K) of dtype x_dt; w / w_gate (G, K, N) of dtype w_dt, one of the
// pairs above; row-major, contiguous.  a_scale (T,), b_scale / bg_scale
// (G, N) f32 or null; sizes (G,) int32 on the device; out (T, N) in
// `out_dt`.  w_gate is null unless act == kSwiglu.  (bm, bn, bk): the tile.
// An unsupported pair or tile returns cudaErrorInvalidValue.
extern "C" int mx_grouped_matmul_launch(const void* x, const void* w, const void* w_gate,
                                        const void* a_scale, const void* b_scale,
                                        const void* bg_scale, const void* sizes, void* out,
                                        int out_dt, int T_, int N, int K, int G, int x_dt,
                                        int w_dt, int act, int bm, int bn, int bk,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args r{static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
               static_cast<const float*>(bg_scale), static_cast<const int*>(sizes), out,
               out_dt, T_, N, K, G, act};
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (x_dt == kF32 && w_dt == kF32)
    err = dispatch<float, float, float>(x, w, w_gate, r, bm, bn, bk, s);
  else if (x_dt == kBF16 && w_dt == kBF16)
    err = dispatch<float, __nv_bfloat16, __nv_bfloat16>(x, w, w_gate, r, bm, bn, bk, s);
  else if (x_dt == kBF16 && w_dt == kI8)
    err = dispatch<float, __nv_bfloat16, int8_t>(x, w, w_gate, r, bm, bn, bk, s);
  else if (x_dt == kBF16 && w_dt == kF8)
    err = dispatch<float, __nv_bfloat16, __nv_fp8_e4m3>(x, w, w_gate, r, bm, bn, bk, s);
  else if (x_dt == kI8 && w_dt == kI8)
    err = dispatch<int, int8_t, int8_t>(x, w, w_gate, r, bm, bn, bk, s);
  else if (x_dt == kF8 && w_dt == kF8)
    err = dispatch<float, __nv_fp8_e4m3, __nv_fp8_e4m3>(x, w, w_gate, r, bm, bn, bk, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
