// Grouped (ragged) MX GEMM for Hopper (sm_90a): every expert of an MoE
// layer in one launch; dense experts (stages 5a and 5b).  The 2:4 sparse
// (5c) and ABFT (5d) variants are mx_grouped_matmul_sparse.cu and
// mx_grouped_matmul_abft.cu (kernel body grouped_mma.cuh).
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
// One K loop for every operand pair (kernels/_build.grouped_tile's tile,
// read by the launcher and by core/ops.py's ABFT recovery): the fused GEMM's
// tensor-core prefill loop (csrc/prefill_tile.cuh) per group visit
// (csrc/grouped_mma.cuh) -- f32 as 3xTF32, bf16, bf16 x int8 / e4m3 with the
// weight widened to bf16, int8 x int8 on the s8 m16n8k32 MMA (exact int32
// sums) and e4m3 x e4m3 widened exactly to f16 in registers.
//
// What bounds it on the H100: at grok-1's widths every regime is bytes
// bound.  Its decode step streams each expert's weight for 8 rows (an MoE's
// capacity floor): the down projection, K = 32768, N = 6144, is 6.44 GB in
// f32 (1.93 ms at 3.35 TB/s) for 3.2 GFLOP; even an expert-major prefill
// chunk of 128 rows per expert in bf16 is 412 GFLOP (0.42 ms at 989 TFLOP/s)
// on 3.22 GB of weight (0.96 ms).  The kernel is a weight stream with
// arithmetic inside.  The CUDA-core loop it replaces for the float pairs kept
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
// 3xTF32 products in an f32 prefill chunk, the copies in a bf16 one.  The
// 8-bit pairs' times are in PERF.md section 6.
#include "grouped_mma.cuh"

REPRO_EXPORT_ERROR_STRING

// x (T, K) of dtype x_dt; w / w_gate (G, K, N) of dtype w_dt (a pair of
// kernels/_build.GEMM_PAIRS); row-major, contiguous.  a_scale (T,),
// b_scale / bg_scale (G, N) f32 or null; sizes (G,) int32 on the device;
// out (T, N) in `out_dt`.  w_gate is null unless act == kSwiglu.  The tile
// of kernels/_build.grouped_tile -- (bm, bn) CTA tile, `stages` ring slots,
// K cut into `parts` parts, `split` CTAs per cluster -- and the copy widths
// va / vb (bytes) of x's and the weights' rows.  A pair, tile or width the
// loop refuses returns cudaErrorInvalidValue.
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
