// Grouped MX GEMM with 2:4 sparse experts (stage 5c), for Hopper (sm_90a):
// the kernel body is grouped_mma.cuh with prefill_tile.cuh's 2:4 expansion
// (pf_expand).
//
// Replaces the b_sparse path of repro/kernels/mx_grouped_matmul.py::
// mx_grouped_matmul: each expert's payload (G, K/2, N) and metadata
// (G, K/8, N), indexed with int64 offsets (kimi-k2's stacks pass 2^31
// elements), expand in shared memory at every staged K step into the tile
// the dense kernel stages, so the output is bitwise the dense grouped
// kernel's on the expanded stack.  Pairs: (f32, f32), (bf16, bf16),
// (bf16, int8), all on the tensor cores.  Bound at decode: the compressed
// expert bytes.
#include "grouped_mma.cuh"

REPRO_EXPORT_ERROR_STRING

// x (T, K); w / w_gate the (G, K/2, N) payloads and w_meta / wg_meta their
// (G, K/8, N) metadata (K % 8 == 0); the rest as mx_grouped_matmul_mma_launch
// (vm: the copy width of the metadata rows).  A pair, tile or width the loop
// refuses returns cudaErrorInvalidValue.
extern "C" int mx_grouped_matmul_sparse_mma_launch(
    const void* x, const void* w, const void* w_gate, const void* w_meta,
    const void* wg_meta, const void* a_scale, const void* b_scale, const void* bg_scale,
    const void* sizes, void* out, int out_dt, int T_, int N, int K, int G, int x_dt,
    int w_dt, int act, int bm, int bn, int stages, int split, int parts, int va, int vb,
    int vm, void* stream) {
  const GroupedArgs r{x, w, w_gate, static_cast<const uint8_t*>(w_meta),
                      static_cast<const uint8_t*>(wg_meta),
                      static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
                      static_cast<const float*>(bg_scale), static_cast<const int*>(sizes),
                      out, out_dt, T_, N, K, G, act, nullptr, nullptr, nullptr, nullptr,
                      0.0f, 0.0f};
  return grouped_mma_run<kGroupedSparse>(r, x_dt, w_dt, bm, bn, stages, split, parts, va, vb,
                                         vm, stream);
}
