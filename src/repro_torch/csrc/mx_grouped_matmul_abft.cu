// Grouped MX GEMM with per-expert ABFT checksums (stage 5d), for Hopper
// (sm_90a): the kernel body is grouped_mma.cuh with the AbftPrefillHook
// ("mma" route) or mx_grouped_matmul.cuh with the AbftHook ("simt").
//
// Replaces the abft path of repro/kernels/mx_grouped_matmul.py::
// mx_grouped_matmul: every group visit of a tile resets the checksums,
// accumulates them against that expert's weights and verifies its finished
// accumulator; the verdicts are OR-ed into the tile's one flag of the
// (row_tiles, col_tiles) int32 map.  A tile that no group covers stores
// zeros and flag 0.  The fault operands of a tile apply at every visit.
// The output is bitwise the dense grouped kernel's.  Pairs: every dense
// pair, on its route: the "mma" route (f32, bf16, bf16 x int8 / e4m3;
// csrc/grouped_mma.cuh with AbftPrefillHook) on the flag map's CTA tile,
// split 1; the "simt" route (int8 x int8, e4m3 x e4m3; mx_grouped_matmul.cuh
// with AbftHook).
#include "mx_grouped_matmul.cuh"

REPRO_EXPORT_ERROR_STRING

static int dispatch_pair(const GroupedArgs& r, int x_dt, int w_dt, int bm, int bn, int bk,
                         cudaStream_t s) {
  if (x_dt == kI8 && w_dt == kI8) return grouped_dispatch<int, int8_t, int8_t>(r, bm, bn, bk, s);
  if (x_dt == kF8 && w_dt == kF8)
    return grouped_dispatch<float, __nv_fp8_e4m3, __nv_fp8_e4m3>(r, bm, bn, bk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The "simt" route: as mx_grouped_matmul_launch, plus flags (row_tiles,
// col_tiles) int32, the fault operands of the same shape or null, and
// rtol / atol.
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

// The "mma" route (f32, bf16, bf16 x int8 / e4m3; csrc/grouped_mma.cuh): as
// mx_grouped_matmul_abft_launch, with the tile and copy widths of
// mx_grouped_matmul_mma_launch; the CTA tile is the flag map's, split 1.
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
