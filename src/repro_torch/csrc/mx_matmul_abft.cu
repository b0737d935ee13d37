// MX GEMM with ABFT checksums (stage 1d), for Hopper (sm_90a): the kernel
// body is mx_matmul.cuh with the AbftHook of abft_tile.cuh.
//
// Replaces the abft path of repro/kernels/mx_matmul.py::mx_matmul_fused
// (abft_accumulate / abft_inject / abft_verify): the checksum row and
// column of each output tile live in shared memory beside the register
// accumulator, grow at every staged K step, and are compared with the
// finished tile's sums at the single store, which writes the tile's entry
// of the (grid_m, grid_n) int32 flag map; optional per-tile fault operands
// corrupt the finished accumulator first.  The output is bitwise the dense
// kernel's.  Pairs: every dense pair (2:4 weights are expanded before a
// checksummed launch, as in JAX).
//
// At M > 16 every pair takes the dense kernel's tensor-core loop
// (prefill_tile.cuh) on gemm_tile's CTA tile with split 1, folding the same
// K parts in the same order as the dense kernel (so on is bitwise off), the
// checksums over the staged tiles (in A's type: an int8 or e4m3 weight
// widened; int8 x int8 exact, in wrapping 32-bit sums) and the verify over
// the finished tile in shared memory (mx_matmul_abft_prefill_launch).  The
// decode-height rows keep gemm_tile.cuh's serial chain
// (mx_matmul_abft_launch).
//
// What it costs on the H100: per K step two reductions over the staged
// tiles and (BM + BN) * BK extra MACs in shared memory, with two more
// barriers; (1 / BM + 1 / BN) of the tile's MACs, doubled for the float
// |.|-checksums.
#include "mx_matmul.cuh"

REPRO_EXPORT_ERROR_STRING

static int dispatch_pair(const GemmArgs& r, int a_dt, int b_dt, int bm, int bn, int bk,
                         cudaStream_t s) {
  REPRO_GEMM_PAIR(kAbftB, kF32, kF32, float, float, float)
  REPRO_GEMM_PAIR(kAbftB, kBF16, kBF16, float, __nv_bfloat16, __nv_bfloat16)
  REPRO_GEMM_PAIR(kAbftB, kBF16, kI8, float, __nv_bfloat16, int8_t)
  REPRO_GEMM_PAIR(kAbftB, kBF16, kF8, float, __nv_bfloat16, __nv_fp8_e4m3)
  REPRO_GEMM_PAIR(kAbftB, kI8, kI8, int, int8_t, int8_t)
  REPRO_GEMM_PAIR(kAbftB, kF8, kF8, float, __nv_fp8_e4m3, __nv_fp8_e4m3)
  return static_cast<int>(cudaErrorInvalidValue);
}

// As mx_matmul_decode_launch's operands, plus flags (grid_m, grid_n) int32, the fault
// operands fault_delta (f32) / fault_row / fault_col (int32) of the same
// shape or null, and the float compare's rtol / atol; the tile of
// kernels/_build.gemm_tile at decode height, (16, 16, 128), M <= 16.
extern "C" int mx_matmul_abft_launch(const void* a, const void* b, const void* b_gate,
                                     const void* a_scale, const void* b_scale,
                                     const void* bg_scale, const void* bias, int bias_dt,
                                     const void* residual, int res_dt, void* out, int out_dt,
                                     int M, int N, int K, int a_dt, int b_dt, int act,
                                     int has_scale, float out_scale, int bm, int bn, int bk,
                                     void* flags, const void* fault_delta,
                                     const void* fault_row, const void* fault_col,
                                     float rtol, float atol, void* stream) {
  const GemmArgs r{a, b, b_gate, nullptr, nullptr, static_cast<const float*>(a_scale),
                   static_cast<const float*>(b_scale), static_cast<const float*>(bg_scale),
                   bias, bias_dt, residual, res_dt, out, out_dt, M, N, K, act, has_scale,
                   out_scale, static_cast<const float*>(fault_delta),
                   static_cast<const int*>(fault_row), static_cast<const int*>(fault_col),
                   static_cast<int*>(flags), rtol, atol};
  const int err = dispatch_pair(r, a_dt, b_dt, bm, bn, bk,
                                        static_cast<cudaStream_t>(stream));
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
  const GemmArgs r{a, b, b_gate, nullptr, nullptr, static_cast<const float*>(a_scale),
                   static_cast<const float*>(b_scale), static_cast<const float*>(bg_scale),
                   bias, bias_dt, residual, res_dt, out, out_dt, M, N, K, act, has_scale,
                   out_scale, static_cast<const float*>(fault_delta),
                   static_cast<const int*>(fault_row), static_cast<const int*>(fault_col),
                   static_cast<int*>(flags), rtol, atol};
  if (split != 1) return static_cast<int>(cudaErrorInvalidValue);  // one CTA per flag
  const PrefillShape d{a, b, act == kSwiglu ? b_gate : nullptr, nullptr, nullptr, M, N, K,
                       stages, split, parts, va, vb, vm};
  const int err = prefill_dispatch<kAbftB>(d, r, a_dt, b_dt, bm, bn,
                                           static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
