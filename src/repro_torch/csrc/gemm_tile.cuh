// The pieces every MX GEMM kernel shares: the MAC of the serial K chain
// (mac), the epilogue every kernel stores through (mx_store), the operand
// pairs' dispatch (with_pair), and the hook a K loop runs beside each
// staged step when it keeps no checksums (NoHook).
//
// S, the accumulator's type, is float for every operand pair but int8 x
// int8, where it is int: the products then sum in an exact int32 MAC over
// the whole K loop (|sum| <= K * 127^2, under 2^31 for K < 133,143), as
// JAX's dot_f32 takes its int32 MAC.
#pragma once

#include "common.cuh"

__device__ __forceinline__ float mac(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mac(int a, int b, int c) { return a * b + c; }

// The single write-back of one output element (gm, gn) of the MX GEMM: the
// dequant scales and the epilogue applied to the finished accumulator y
// (and the gate's, with GATE) in f32, in the order of kernels/mx_matmul.py's
// Epilogue.  Each step rounds on its own (__fmul_rn / __fadd_rn are never
// contracted into an FMA), so every kernel that stores through it -- the
// dense decode and prefill tiles, the 2:4 and ABFT variants -- turns the
// same accumulator into the same bits.  R: any argument struct with these
// fields (csrc/mx_matmul.cu Args, csrc/mx_matmul.cuh GemmArgs).
template <bool GATE, typename R>
__device__ __forceinline__ void mx_store(const R& r, float y, float gate, int gm, int gn) {
  if (r.a_scale != nullptr) {
    const float as = r.a_scale[gm];
    y = __fmul_rn(y, as);
    gate = __fmul_rn(gate, as);
  }
  if (r.b_scale != nullptr) y = __fmul_rn(y, r.b_scale[gn]);
  if (r.bias != nullptr) y = __fadd_rn(y, load_dt(r.bias, r.bias_dt, gn));
  if constexpr (GATE) {
    if (r.bg_scale != nullptr) gate = __fmul_rn(gate, r.bg_scale[gn]);
    y = __fmul_rn(silu_f(gate), y);
  } else {
    y = activation_f(y, r.act);
  }
  const int64_t o = (int64_t)gm * r.N + gn;
  if (r.res != nullptr) y = __fadd_rn(y, load_dt(r.res, r.res_dt, o));
  if (r.has_scale) y = __fmul_rn(y, r.out_scale);
  store_dt(r.out, r.out_dt, o, y);
}

// The operand pair's instantiation: F(S, TA, TB) for the pair (a_dt, b_dt)
// -- the accumulator's type S, A's TA, B's TB -- and cudaErrorInvalidValue
// for any other: the dense pairs of every GEMM kernel.
template <typename F>
static int with_pair(int a_dt, int b_dt, F f) {
  if (a_dt == kF32 && b_dt == kF32) return f(float(), float(), float());
  if (a_dt == kBF16 && b_dt == kBF16) return f(float(), __nv_bfloat16(), __nv_bfloat16());
  if (a_dt == kBF16 && b_dt == kI8) return f(float(), __nv_bfloat16(), int8_t());
  if (a_dt == kBF16 && b_dt == kF8) return f(float(), __nv_bfloat16(), __nv_fp8_e4m3());
  if (a_dt == kI8 && b_dt == kI8) return f(int(), int8_t(), int8_t());
  if (a_dt == kF8 && b_dt == kF8) return f(float(), __nv_fp8_e4m3(), __nv_fp8_e4m3());
  return static_cast<int>(cudaErrorInvalidValue);
}

// What runs beside each staged K step's MACs: nothing (NoHook), or the
// ABFT checksums (abft_tile.cuh).  Every K loop takes it: decode_tile.cuh's
// and prefill_tile.cuh's pass the staged slot.
struct NoHook {
  template <typename... Staged>
  __device__ __forceinline__ void step(Staged...) {}
};
