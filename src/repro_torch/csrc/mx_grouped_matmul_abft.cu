// Grouped MX GEMM with per-expert ABFT checksums (stage 5d), for Hopper
// (sm_90a): the kernel body is grouped_mma.cuh with the AbftPrefillHook.
//
// Replaces the abft path of repro/kernels/mx_grouped_matmul.py::
// mx_grouped_matmul: every group visit of a tile resets the checksums,
// accumulates them against that expert's weights and verifies its finished
// accumulator; the verdicts are OR-ed into the tile's one flag of the
// (row_tiles, col_tiles) int32 map.  A tile that no group covers stores
// zeros and flag 0.  The fault operands of a tile apply at every visit.
// The output is bitwise the dense grouped kernel's.  Pairs: every dense
// pair, on the flag map's CTA tile, split 1 (int8 x int8 compared exactly
// in wrapping 32-bit sums).
#include "grouped_mma.cuh"

REPRO_EXPORT_ERROR_STRING

// x, w, w_gate, scales, sizes, out and the tile as
// mx_grouped_matmul_mma_launch, plus flags (row_tiles, col_tiles) int32, the
// fault operands of the same shape or null, and rtol / atol; the CTA tile is
// the flag map's, split 1.
extern "C" int mx_grouped_matmul_abft_mma_launch(
    const void* x, const void* w, const void* w_gate, const void* a_scale,
    const void* b_scale, const void* bg_scale, const void* sizes, void* out, int out_dt,
    int T_, int N, int K, int G, int x_dt, int w_dt, int act, int bm, int bn, int stages,
    int split, int parts, int va, int vb, int vm, void* flags, const void* fault_delta,
    const void* fault_row, const void* fault_col, float rtol, float atol, void* stream) {
  const GroupedArgs r{x, w, w_gate, nullptr, nullptr, static_cast<const float*>(a_scale),
                      static_cast<const float*>(b_scale), static_cast<const float*>(bg_scale),
                      static_cast<const int*>(sizes), out, out_dt, T_, N, K, G, act,
                      static_cast<const float*>(fault_delta),
                      static_cast<const int*>(fault_row), static_cast<const int*>(fault_col),
                      static_cast<int*>(flags), rtol, atol};
  if (split != 1) return static_cast<int>(cudaErrorInvalidValue);  // one CTA per flag
  return grouped_mma_run<kGroupedAbft>(r, x_dt, w_dt, bm, bn, stages, split, parts, va, vb,
                                       vm, stream);
}
