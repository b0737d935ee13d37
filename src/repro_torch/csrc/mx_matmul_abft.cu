// MX GEMM with ABFT checksums (stage 1d), for Hopper (sm_90a): the kernel
// bodies are mx_matmul.cuh's, with abft_tile.cuh's hooks.
//
// Replaces the abft path of repro/kernels/mx_matmul.py::mx_matmul_fused
// (abft_accumulate / abft_inject / abft_verify): the checksum row and
// column of each output tile grow at every staged K step beside the
// register accumulator and are compared with the finished tile's sums at
// the single store, which writes the tile's entry of the (grid_m, grid_n)
// int32 flag map (gemm_tile's tiles); optional per-tile fault operands
// corrupt the finished accumulator first.  The output is bitwise the
// dense kernel's.  Pairs: every dense pair (2:4 weights are expanded
// before a checksummed launch, as in JAX).
//
// At decode height (M <= 16, mx_matmul_abft_launch) the dense decode
// tile's weight-streaming ring (decode_tile.cuh, kDecodeAbft) with
// AbftDecodeHook over each staged slot: a CTA of bn columns (a multiple of
// 16) owns bn / 16 flag tiles.  At M > 16 every pair takes the dense
// kernel's tensor-core loop (prefill_tile.cuh) on gemm_tile's CTA tile
// with split 1, folding the same K parts in the same order as the dense
// kernel (so on is bitwise off), the checksums over the staged tiles (in
// A's type: an int8 or e4m3 weight widened; int8 x int8 exact, in wrapping
// 32-bit sums) and the verify over the finished tile in shared memory
// (mx_matmul_abft_prefill_launch).
//
// What it costs on the H100: per K step two reductions over the staged
// tiles, (M + bn) * bk extra MACs (doubled for the float |.|-checksums) and
// one more barrier; (1 / M + 1 / 16) of the main product's MACs.
#include "mx_matmul.cuh"

REPRO_EXPORT_ERROR_STRING

// As mx_matmul_decode_launch's operands (M <= 16, the tile of
// kernels/_build.decode_tile, variant "abft", and the copy widths va / vb),
// plus flags (1, ceil(N / 16)) int32, the fault operands fault_delta (f32) /
// fault_row / fault_col (int32) of the same shape or null, and the float
// compare's rtol / atol.  A pair, tile or width that decode_check refuses
// returns cudaErrorInvalidValue.
extern "C" int mx_matmul_abft_launch(const void* a, const void* b, const void* b_gate,
                                     const void* a_scale, const void* b_scale,
                                     const void* bg_scale, const void* bias, int bias_dt,
                                     const void* residual, int res_dt, void* out, int out_dt,
                                     int M, int N, int K, int a_dt, int b_dt, int act,
                                     int has_scale, float out_scale, int bn, int bk, int tm,
                                     int stages, int threads, int va, int vb, void* flags,
                                     const void* fault_delta, const void* fault_row,
                                     const void* fault_col, float rtol, float atol,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GemmArgs r{static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
                   static_cast<const float*>(bg_scale), bias, bias_dt, residual, res_dt, out,
                   out_dt, M, N, K, act, has_scale, out_scale,
                   static_cast<const float*>(fault_delta), static_cast<const int*>(fault_row),
                   static_cast<const int*>(fault_col), static_cast<int*>(flags), rtol, atol};
  const DecodeShape d{a, b, act == kSwiglu ? b_gate : nullptr, M, N, K, bn, bk, stages,
                      threads, va, vb, nullptr, nullptr, 0};
  const int err = with_pair(a_dt, b_dt, [&](auto s_, auto ta, auto tb) {
    return decode_variant_dispatch<kAbftB, decltype(s_), decltype(ta), decltype(tb)>(d, r, tm,
                                                                                    s);
  });
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core prefill tile (M > 16): as mx_matmul_abft_launch,
// with the tile of kernels/_build.prefill_tile (bm, bn: gemm_tile's; stages;
// split 1; parts) and the copy widths va / vb.
extern "C" int mx_matmul_abft_prefill_launch(
    const void* a, const void* b, const void* b_gate, const void* a_scale, const void* b_scale,
    const void* bg_scale, const void* bias, int bias_dt, const void* residual, int res_dt,
    void* out, int out_dt, int M, int N, int K, int a_dt, int b_dt, int act, int has_scale,
    float out_scale, int bm, int bn, int stages, int split, int parts, int va, int vb, int vm,
    void* flags, const void* fault_delta, const void* fault_row, const void* fault_col,
    float rtol, float atol, void* stream) {
  const GemmArgs r{static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
                   static_cast<const float*>(bg_scale), bias, bias_dt, residual, res_dt, out,
                   out_dt, M, N, K, act, has_scale, out_scale,
                   static_cast<const float*>(fault_delta), static_cast<const int*>(fault_row),
                   static_cast<const int*>(fault_col), static_cast<int*>(flags), rtol, atol};
  if (split != 1) return static_cast<int>(cudaErrorInvalidValue);  // one CTA per flag
  const PrefillShape d{a, b, act == kSwiglu ? b_gate : nullptr, nullptr, nullptr, M, N, K,
                       stages, split, parts, va, vb, vm};
  const int err = prefill_dispatch<kAbftB>(d, r, a_dt, b_dt, bm, bn,
                                           static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
