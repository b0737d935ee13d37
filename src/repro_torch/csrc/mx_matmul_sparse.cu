// MX GEMM with a 2:4 sparse B (stage 1c), for Hopper (sm_90a): the kernel
// bodies are mx_matmul.cuh's.
//
// Replaces the b_sparse path of repro/kernels/mx_matmul.py::mx_matmul_fused:
// B and B_gate arrive as 2:4 payloads (K/2, N) with uint8 metadata (K/8, N)
// each (kernels/sparse.compress_24), so device memory streams only the
// compressed weight, and the product is bitwise that of the dense kernel
// on expand_24(payload, meta).  The pairs are those the sparse policies
// produce: (f32, f32) and (bf16, bf16) for "sparse24", (bf16, int8) for
// "sparse24_int8".
//
// At decode height (M <= 16, mx_matmul_sparse_launch) the dense decode
// tile's weight-streaming ring (decode_tile.cuh, kDecodeSparse): each slot
// holds A's rows, the payload's bk/2 rows and the metadata's bk/8 rows,
// copied raw by cp.async, and each thread expands its column's weights in
// registers as its MACs take them, in the dense chain's order.  At M > 16
// every pair takes the dense kernel's tensor-core loop (prefill_tile.cuh)
// on the same tile and split, the payload and metadata copied raw into the
// ring by cp.async and expanded in shared memory (an int8 payload widened
// to bf16) before the MMAs (mx_matmul_sparse_prefill_launch).
//
// What bounds it on the H100: at decode the weight bytes, now
// itemsize / 2 + 1/8 per dense element (0.53x of f32 dense, 0.16x with
// int8); the decode tile's MAC chain runs every dense K row, so the loop's
// time is that of the dense decode tile's chain, not half of it.
#include "mx_matmul.cuh"

REPRO_EXPORT_ERROR_STRING

// As mx_matmul_decode_launch's operands, with b / b_gate the (K/2, N) payloads and
// b_meta / bg_meta their (K/8, N) metadata; K % 8 == 0; M <= 16.  The tile
// of kernels/_build.decode_tile (variant "sparse") and the copy widths va /
// vb / vm (bytes) of A's, the payloads' and the metadata's rows
// (kernels/_build.copy_width).  A pair, tile or width that decode_check
// refuses returns cudaErrorInvalidValue.
extern "C" int mx_matmul_sparse_launch(const void* a, const void* b, const void* b_gate,
                                       const void* b_meta, const void* bg_meta,
                                       const void* a_scale, const void* b_scale,
                                       const void* bg_scale, const void* bias, int bias_dt,
                                       const void* residual, int res_dt, void* out,
                                       int out_dt, int M, int N, int K, int a_dt, int b_dt,
                                       int act, int has_scale, float out_scale, int bn,
                                       int bk, int tm, int stages, int threads, int va,
                                       int vb, int vm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GemmArgs r{static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
                   static_cast<const float*>(bg_scale), bias, bias_dt, residual, res_dt, out,
                   out_dt, M, N, K, act, has_scale, out_scale, nullptr, nullptr, nullptr,
                   nullptr, 0.0f, 0.0f};
  const bool gated = act == kSwiglu;
  const DecodeShape d{a, b, gated ? b_gate : nullptr, M, N, K, bn, bk, stages, threads, va, vb,
                      static_cast<const uint8_t*>(b_meta),
                      gated ? static_cast<const uint8_t*>(bg_meta) : nullptr, vm};
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (a_dt == kF32 && b_dt == kF32)
    err = decode_variant_dispatch<kSparseB, float, float, float>(d, r, tm, s);
  else if (a_dt == kBF16 && b_dt == kBF16)
    err = decode_variant_dispatch<kSparseB, float, __nv_bfloat16, __nv_bfloat16>(d, r, tm, s);
  else if (a_dt == kBF16 && b_dt == kI8)
    err = decode_variant_dispatch<kSparseB, float, __nv_bfloat16, int8_t>(d, r, tm, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core prefill tile (M > 16): as
// mx_matmul_sparse_launch, with the tile of kernels/_build.prefill_tile
// (bm, bn, stages, split, parts) and the copy widths va / vb / vm of A's,
// the payloads' and the metadata's rows.
extern "C" int mx_matmul_sparse_prefill_launch(
    const void* a, const void* b, const void* b_gate, const void* b_meta, const void* bg_meta,
    const void* a_scale, const void* b_scale, const void* bg_scale, const void* bias,
    int bias_dt, const void* residual, int res_dt, void* out, int out_dt, int M, int N, int K,
    int a_dt, int b_dt, int act, int has_scale, float out_scale, int bm, int bn, int stages,
    int split, int parts, int va, int vb, int vm, void* stream) {
  const GemmArgs r{static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
                   static_cast<const float*>(bg_scale), bias, bias_dt, residual, res_dt, out,
                   out_dt, M, N, K, act, has_scale, out_scale, nullptr, nullptr, nullptr,
                   nullptr, 0.0f, 0.0f};
  const bool gated = act == kSwiglu;
  const PrefillShape d{a, b, gated ? b_gate : nullptr, static_cast<const uint8_t*>(b_meta),
                       gated ? static_cast<const uint8_t*>(bg_meta) : nullptr, M, N, K,
                       stages, split, parts, va, vb, vm};
  const int err = prefill_dispatch<kSparseB>(d, r, a_dt, b_dt, bm, bn,
                                             static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
