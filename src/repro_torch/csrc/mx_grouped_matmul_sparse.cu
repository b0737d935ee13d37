// Grouped MX GEMM with 2:4 sparse experts (stage 5c), for Hopper (sm_90a):
// the kernel body is mx_grouped_matmul.cuh with the 2:4 staging (load_b24 / store_b24).
//
// Replaces the b_sparse path of repro/kernels/mx_grouped_matmul.py::
// mx_grouped_matmul: each expert's payload (G, K/2, N) and metadata
// (G, K/8, N), indexed with int64 offsets (kimi-k2's stacks pass 2^31
// elements), expand in shared memory at every staged K step, so the output
// is bitwise the dense grouped kernel's on the expanded stack.  Pairs:
// (f32, f32), (bf16, bf16), (bf16, int8).  Bound at decode: the compressed
// expert bytes.
#include "mx_grouped_matmul.cuh"

REPRO_EXPORT_ERROR_STRING

static int dispatch_pair(const GroupedArgs& r, int x_dt, int w_dt, int bm, int bn, int bk,
                         cudaStream_t s) {
  REPRO_GROUPED_PAIR(kSparseB, kF32, kF32, float, float, float)
  REPRO_GROUPED_PAIR(kSparseB, kBF16, kBF16, float, __nv_bfloat16, __nv_bfloat16)
  REPRO_GROUPED_PAIR(kSparseB, kBF16, kI8, float, __nv_bfloat16, int8_t)
  return static_cast<int>(cudaErrorInvalidValue);
}

// As mx_grouped_matmul_launch, with w / w_gate the (G, K/2, N) payloads and
// w_meta / wg_meta their (G, K/8, N) metadata; K % 8 == 0.
extern "C" int mx_grouped_matmul_sparse_launch(
    const void* x, const void* w, const void* w_gate, const void* w_meta,
    const void* wg_meta, const void* a_scale, const void* b_scale, const void* bg_scale,
    const void* sizes, void* out, int out_dt, int T_, int N, int K, int G, int x_dt,
    int w_dt, int act, int bm, int bn, int bk, void* stream) {
  const GroupedArgs r{x, w, w_gate, static_cast<const uint8_t*>(w_meta),
                      static_cast<const uint8_t*>(wg_meta),
                      static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
                      static_cast<const float*>(bg_scale), static_cast<const int*>(sizes),
                      out, out_dt, T_, N, K, G, act, nullptr, nullptr, nullptr, nullptr,
                      0.0f, 0.0f};
  const int err = dispatch_pair(r, x_dt, w_dt, bm, bn, bk, static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
