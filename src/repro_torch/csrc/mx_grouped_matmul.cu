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
// rows the CTA runs the whole K loop over that expert's weights (the
// paper's inter-k buffer, zeroed per group), applies the epilogue and
// stores only the rows the group owns; rows past the last group are stored
// as zeros.  Each output row is written once, by one CTA: the TPU kernel's
// first-writer merge has nothing left to do.  Empty groups cost one step of
// the scan and no weight bytes.  Weight offsets are int64: kimi-k2's (384,
// 7168, 2048) expert stack holds 5.64 G elements, past int32.
//
// Two K loops, one per operand pair (kernels/_build.grouped_tile's route,
// read by the launcher and by core/ops.py's ABFT recovery):
//   * "mma" -- f32, bf16, bf16 x int8 / e4m3 (mx_grouped_matmul_mma_launch,
//     csrc/grouped_mma.cuh): the fused GEMM's tensor-core prefill loop
//     (csrc/prefill_tile.cuh) per group visit;
//   * "simt" -- int8 x int8 in an exact int32 MAC and e4m3 x e4m3
//     (mx_grouped_matmul_launch, below): gemm_tile.cuh's sweep_k with one
//     thread per column over 8 rows (8 x 128 CTA tiles) at decode, 2 x 4 or
//     4 x 4 register tiles above.
//
// What bounds it on the H100: at grok-1's widths every regime is bytes
// bound.  Its decode step streams each expert's weight for 8 rows (an MoE's
// capacity floor): the down projection, K = 32768, N = 6144, is 6.44 GB in
// f32 (1.93 ms at 3.35 TB/s) for 3.2 GFLOP; even an expert-major prefill
// chunk of 128 rows per expert in bf16 is 412 GFLOP (0.42 ms at 989 TFLOP/s)
// on 3.22 GB of weight (0.96 ms).  The kernel is a weight stream with
// arithmetic inside.  The "simt" loop it replaces for the float pairs kept
// one K step in flight per CTA, widened bf16 element by element and moved
// an int8 or e4m3 weight one byte per thread per load: 2.0 TB/s in f32 at
// decode, 0.38 in bf16, and (bf16, int8) slower than f32.  The "mma" route
// instead streams the weight in its own width through a ring of 16-byte
// cp.async.cg copies (a copies-only loop moves 2.45-2.98 TB/s at grok's decode
// down projection, so TMA was not built), multiplies on the tensor cores
// (mma.sync: bf16 m16n8k16, f32 as 3xTF32, an int8 or e4m3 weight widened to
// bf16 exactly, in registers on the 16-row tile), and fills the card at
// decode height with 16-row tiles over two groups (each expert streamed
// once) and K split across a cluster of CTAs where the grid is small.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6;
// tools/grouped_variants.py): grok's decode down projection f32 2.42 ms
// against bmm's 3.02 (was 3.17), bf16 1.17 against 1.07 (was 8.57), (bf16,
// int8) 0.75 (was 8.58); its prefill down projection f32 11.0 ms against
// bmm's 9.7 (was 21.9), bf16 2.43 against 1.08 (was 37.3).  What bounds it
// now: the bytes at decode height (2.7-3.0 TB/s in f32 and bf16), the
// 3xTF32 products in an f32 prefill chunk, the copies in a bf16 one.
#include "grouped_mma.cuh"  // the "mma" route; gemm_tile.cuh

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

// The "simt" route (int8 x int8, e4m3 x e4m3).  x (T, K) of dtype x_dt;
// w / w_gate (G, K, N) of dtype w_dt; row-major, contiguous.  a_scale (T,),
// b_scale / bg_scale (G, N) f32 or null; sizes (G,) int32 on the device;
// out (T, N) in `out_dt`.  w_gate is null unless act == kSwiglu.  (bm, bn,
// bk): the tile.  Any other pair or tile returns cudaErrorInvalidValue.
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
  if (x_dt == kI8 && w_dt == kI8)
    err = dispatch<int, int8_t, int8_t>(x, w, w_gate, r, bm, bn, bk, s);
  else if (x_dt == kF8 && w_dt == kF8)
    err = dispatch<float, __nv_fp8_e4m3, __nv_fp8_e4m3>(x, w, w_gate, r, bm, bn, bk, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The "mma" route (f32, bf16, bf16 x int8 / e4m3; csrc/grouped_mma.cuh): as
// mx_grouped_matmul_launch, with the tile of kernels/_build.grouped_tile --
// (bm, bn) CTA tile, `stages` ring slots, K cut into `parts` parts, `split`
// CTAs per cluster -- and the copy widths va / vb (bytes) of x's and the
// weights' rows.  A pair, tile or width the loop refuses returns
// cudaErrorInvalidValue.
extern "C" int mx_grouped_matmul_mma_launch(const void* x, const void* w, const void* w_gate,
                                            const void* a_scale, const void* b_scale,
                                            const void* bg_scale, const void* sizes, void* out,
                                            int out_dt, int T_, int N, int K, int G, int x_dt,
                                            int w_dt, int act, int bm, int bn, int stages,
                                            int split, int parts, int va, int vb, int vm,
                                            void* stream) {
  const GroupedArgs r{x, w, w_gate, nullptr, nullptr, static_cast<const float*>(a_scale),
                      static_cast<const float*>(b_scale), static_cast<const float*>(bg_scale),
                      static_cast<const int*>(sizes), out, out_dt, T_, N, K, G, act,
                      nullptr, nullptr, nullptr, nullptr, 0.0f, 0.0f};
  return grouped_mma_run<kGroupedDense>(r, x_dt, w_dt, bm, bn, stages, split, parts, va, vb,
                                        vm, stream);
}
