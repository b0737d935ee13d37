// Grouped MX GEMM with per-expert ABFT checksums (stage 5d), for Hopper
// (sm_90a): the kernel body is mx_grouped_matmul.cuh with the AbftHook.
//
// Replaces the abft path of repro/kernels/mx_grouped_matmul.py::
// mx_grouped_matmul: every group visit of a tile resets the checksums,
// accumulates them against that expert's weights and verifies its finished
// accumulator; the verdicts are OR-ed into the tile's one flag of the
// (row_tiles, col_tiles) int32 map.  A tile that no group covers stores
// zeros and flag 0.  The fault operands of a tile apply at every visit.
// The output is bitwise the dense grouped kernel's.  Pairs: every dense
// pair.
#include "mx_grouped_matmul.cuh"

REPRO_EXPORT_ERROR_STRING

static int dispatch_pair(const GroupedArgs& r, int x_dt, int w_dt, int bm, int bn, int bk,
                         cudaStream_t s) {
  REPRO_GROUPED_PAIR(kAbftB, kF32, kF32, float, float, float)
  REPRO_GROUPED_PAIR(kAbftB, kBF16, kBF16, float, __nv_bfloat16, __nv_bfloat16)
  REPRO_GROUPED_PAIR(kAbftB, kBF16, kI8, float, __nv_bfloat16, int8_t)
  REPRO_GROUPED_PAIR(kAbftB, kBF16, kF8, float, __nv_bfloat16, __nv_fp8_e4m3)
  REPRO_GROUPED_PAIR(kAbftB, kI8, kI8, int, int8_t, int8_t)
  REPRO_GROUPED_PAIR(kAbftB, kF8, kF8, float, __nv_fp8_e4m3, __nv_fp8_e4m3)
  return static_cast<int>(cudaErrorInvalidValue);
}

// As mx_grouped_matmul_launch, plus flags (row_tiles, col_tiles) int32,
// the fault operands of the same shape or null, and rtol / atol.
extern "C" int mx_grouped_matmul_abft_launch(
    const void* x, const void* w, const void* w_gate, const void* a_scale,
    const void* b_scale, const void* bg_scale, const void* sizes, void* out, int out_dt,
    int T_, int N, int K, int G, int x_dt, int w_dt, int act, int bm, int bn, int bk,
    void* flags, const void* fault_delta, const void* fault_row, const void* fault_col,
    float rtol, float atol, void* stream) {
  const GroupedArgs r{x, w, w_gate, nullptr, nullptr, static_cast<const float*>(a_scale),
                      static_cast<const float*>(b_scale), static_cast<const float*>(bg_scale),
                      static_cast<const int*>(sizes), out, out_dt, T_, N, K, G, act,
                      static_cast<const float*>(fault_delta),
                      static_cast<const int*>(fault_row), static_cast<const int*>(fault_col),
                      static_cast<int*>(flags), rtol, atol};
  const int err = dispatch_pair(r, x_dt, w_dt, bm, bn, bk, static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
