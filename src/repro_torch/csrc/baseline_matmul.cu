// Baseline (non-MX) GEMM for Hopper (sm_90a): the paper's comparison.
//
// Replaces the TPU kernel repro/kernels/baseline_matmul.py::baseline_matmul
// (_baseline_kernel): the same tiles, operand staging and K loops as
// csrc/mx_matmul.cu, but WITHOUT inter-k buffering.  The partial sum of
// every bk-wide K chunk is computed in registers and then added into the
// output tile in global memory, in the OUTPUT dtype: each chunk reads the
// tile back (ld.global.cg), adds the f32 partial, rounds to the output
// dtype and writes it again (st.global.cg) -- the (K/bk) * M * N reads and
// writes of Table I ref. 1) that MX removes.  The first chunk starts from
// zero (the C-tile reset) and so reads nothing.  The inline-PTX accesses
// are `volatile`, so the compiler cannot keep the tile in registers across
// chunks; the output lines stay in the 50 MB L2 between chunks, which is
// where the H100 puts this traffic.
//
// Decode rows (M <= 16; baseline_matmul_decode_launch) run decode_tile.cuh's
// weight-streaming loop with the MX kernel's tile (kernels/_build.decode_tile),
// the partial zeroed at every bk-wide chunk (bk a multiple of 128, so each
// chunk ends on one of the loop's 64-row MAC blocks).  M > 16 runs the MX
// kernel's tensor-core loop (prefill_tile.cuh): its staging, ring and MMAs
// (kernels/_build.prefill_tile, variant "baseline"), each bk-wide chunk's
// partial starting from zero in the MMA accumulators and then added into
// the output tile (bk a multiple of 128, which every staged K step
// divides).  Where the MX kernel splits K across a cluster, the baseline
// keeps one CTA per tile and walks all of K -- K-split partials added into
// the output by several CTAs would race -- and takes the smaller tile that
// fills the card instead; elsewhere it takes the MX kernel's tile.  So the
// A/B of the paper compares kernels that differ in where the partial sums
// live (and, on small grids, in how the card is filled).
//
// What bounds it: the same as the MX kernel (HBM bytes and the serial K
// chain at decode, the weight's bytes and the tensor-core products at
// prefill) plus the output round trips, which grow with K / bk.
#include "prefill_tile.cuh"  // and decode_tile.cuh

REPRO_EXPORT_ERROR_STRING

__device__ __forceinline__ float ld_cg(const void* p, int dt, int64_t i) {
  if (dt == kBF16) {
    unsigned short u;
    const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(p) + i;
    asm volatile("ld.global.cg.b16 %0, [%1];" : "=h"(u) : "l"(q));
    return __bfloat162float(__ushort_as_bfloat16(u));
  }
  float v;
  const float* q = reinterpret_cast<const float*>(p) + i;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(q));
  return v;
}

__device__ __forceinline__ void st_cg(void* p, int dt, int64_t i, float v) {
  if (dt == kBF16) {
    unsigned short u = __bfloat16_as_ushort(__float2bfloat16(v));
    __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(p) + i;
    asm volatile("st.global.cg.b16 [%0], %1;" ::"l"(q), "h"(u) : "memory");
    return;
  }
  float* q = reinterpret_cast<float*>(p) + i;
  asm volatile("st.global.cg.f32 [%0], %1;" ::"l"(q), "f"(v) : "memory");
}

// The prefill tile: prefill_tile.cuh's ring and MMAs over all of K, the
// partial flushed into the output after every bk-wide chunk of K, in K
// order; each thread owns the same output elements in every chunk.
template <typename T, int BM, int BN>
__device__ __forceinline__ void baseline_prefill_body(const PrefillShape& d, void* out,
                                                      int out_dt, int bk) {
  using Cfg = PrefillCfg<T, BM, BN, false, false>;
  extern __shared__ __align__(128) unsigned char pf_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / Cfg::kWarpsN) * Cfg::kWM, wn0 = (warp % Cfg::kWarpsN) * 32;
  const int m0 = pf_tile_m() * BM, n0 = pf_tile_n() * BN;
  const int steps = prefill_steps(d.K, Cfg::kBK), g = lane >> 2, c = lane & 3;
  Acc<Cfg> part, unused;  // one chunk's partial sum only
  pf_zero<Cfg>(part);
  pf_ring<T, BM, BN, false, false, T>(d, pf_smem, m0, n0, 0, steps,
                                   [&](const unsigned char* slot, int kt) {
    pf_mma_stage<T, BM, BN, false, false>(part, unused, slot, wm0, wn0, lane);
    const int k_end = (kt + 1) * Cfg::kBK;
    if (k_end % bk != 0 && kt + 1 < steps) return;
    const bool first = k_end <= bk;  // chunk done: read-modify-write the tile
#pragma unroll
    for (int mt = 0; mt < Cfg::kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // one row of the thread's: its loads, then its stores
        const int gm = m0 + wm0 + mt * 16 + g + 8 * h;
        const int64_t row = static_cast<int64_t>(gm) * d.N;
        float prev[Cfg::kNT][2];
#pragma unroll
        for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int gn = n0 + wn0 + nt * 8 + 2 * c + j;
            prev[nt][j] = first || gm >= d.M || gn >= d.N ? 0.0f : ld_cg(out, out_dt, row + gn);
          }
#pragma unroll
        for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int gn = n0 + wn0 + nt * 8 + 2 * c + j;
            if (gm < d.M && gn < d.N)
              st_cg(out, out_dt, row + gn, prev[nt][j] + part[mt][nt][2 * h + j]);
            part[mt][nt][2 * h + j] = 0.0f;
          }
      }
  });
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(PrefillCfg<T, BM, BN, false, false>::kThreads)
baseline_prefill_kernel(const PrefillShape d, void* out, int out_dt, int bk) {
  baseline_prefill_body<T, BM, BN>(d, out, out_dt, bk);
}

// The same, two CTAs per SM (PrefillCfg::kTwoPerSm), as the MX kernel's.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(PrefillCfg<T, BM, BN, false, false>::kThreads, 2)
baseline_prefill_kernel_2(const PrefillShape d, void* out, int out_dt, int bk) {
  baseline_prefill_body<T, BM, BN>(d, out, out_dt, bk);
}

template <typename T, int BM, int BN>
static int prefill_tile_launch(const PrefillShape& d, void* out, int out_dt, int bk,
                               cudaStream_t s) {
  using Cfg = PrefillCfg<T, BM, BN, false, false>;
  if constexpr (Cfg::kTwoPerSm)
    return prefill_launch<baseline_prefill_kernel_2<T, BM, BN>, Cfg, false>(d, s, false, d,
                                                                             out, out_dt, bk);
  else
    return prefill_launch<baseline_prefill_kernel<T, BM, BN>, Cfg, false>(d, s, false, d, out,
                                                                           out_dt, bk);
}

// The MX kernel's CTA tiles (kernels/_build.PREFILL_TILES).
template <typename T>
static int prefill_dispatch(const PrefillShape& d, void* out, int out_dt, int bk, int bm,
                            int bn, cudaStream_t s) {
  if (bm == 32 && bn == 64) return prefill_tile_launch<T, 32, 64>(d, out, out_dt, bk, s);
  if (bm == 64 && bn == 64) return prefill_tile_launch<T, 64, 64>(d, out, out_dt, bk, s);
  if (bm == 64 && bn == 128) return prefill_tile_launch<T, 64, 128>(d, out, out_dt, bk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The decode tile: decode_tile.cuh's loop, the partial flushed into the
// output after every bk-wide chunk of K, in K order.
template <typename T, int TM>
__global__ void __launch_bounds__(kDecodeMaxThreads)
baseline_decode_kernel(const DecodeShape d, void* out, int out_dt, int bk) {
  const int c = threadIdx.x % d.bn, r0 = threadIdx.x / d.bn * TM;
  const int gn = blockIdx.x * d.bn + c;
  float part[TM], unused[TM];  // one chunk's partial sum only
  auto flush = [&](int k_end) {  // after each MAC block
    if (k_end % bk != 0 && k_end < d.K) return;
    const bool first = k_end <= bk;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (gn < d.N) {  // (copy-only threads run no MAC block, so never get here)
        const int64_t o = (int64_t)(r0 + i) * d.N + gn;
        const float prev = first ? 0.0f : ld_cg(out, out_dt, o);
        st_cg(out, out_dt, o, prev + part[i]);
      }
      part[i] = 0.0f;
    }
  };
  NoHook hook;
  decode_sweep<float, T, T, TM, false, kDecodeDense>(part, unused, d, blockIdx.x * d.bn, c, r0,
                                                     flush, hook);
}

template <typename T>
static int decode_dispatch(const DecodeShape& d, void* out, int out_dt, int bk, int tm,
                           cudaStream_t s) {
  switch (tm) {
    case 1:
      return decode_launch<T, T, 1, false, kDecodeDense>(baseline_decode_kernel<T, 1>, d,
                                                           s, out, out_dt, bk);
    case 2:
      return decode_launch<T, T, 2, false, kDecodeDense>(baseline_decode_kernel<T, 2>, d,
                                                           s, out, out_dt, bk);
    case 4:
      return decode_launch<T, T, 4, false, kDecodeDense>(baseline_decode_kernel<T, 4>, d,
                                                           s, out, out_dt, bk);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a (M, K), b (K, N): dtype in_dt, row-major, contiguous; out (M, N) out_dt.
// bk: the read-modify-write chunk, a multiple of 128 (every staged K step
// divides 128).  M > 16 (the decode rows take baseline_matmul_decode_launch),
// with the tile of kernels/_build.prefill_tile (variant "baseline": one CTA
// per (bm, bn) tile, `stages` ring slots) and the copy widths va / vb.
extern "C" int baseline_matmul_launch(const void* a, const void* b, void* out, int out_dt,
                                      int M, int N, int K, int in_dt, int bk, int bm, int bn,
                                      int stages, int va, int vb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bk % 128) return static_cast<int>(cudaErrorInvalidValue);  // KERNEL_BK
  const PrefillShape d{a, b, nullptr, nullptr, nullptr, M, N, K, stages, 1, 1, va, vb, 16};
  const int err = in_dt == kBF16
                      ? prefill_dispatch<__nv_bfloat16>(d, out, out_dt, bk, bm, bn, s)
                      : prefill_dispatch<float>(d, out, out_dt, bk, bm, bn, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The decode rows (M <= 16): as baseline_matmul_launch, with the tile of
// kernels/_build.decode_tile (bn, bks K rows per ring stage, tm, stages,
// threads) and
// the copy widths va / vb (kernels/_build.copy_width).
extern "C" int baseline_matmul_decode_launch(const void* a, const void* b, void* out,
                                             int out_dt, int M, int N, int K, int in_dt,
                                             int bk, int bn, int bks, int tm, int stages,
                                             int threads, int va, int vb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bk % 128) return static_cast<int>(cudaErrorInvalidValue);  // KERNEL_BK
  const DecodeShape d{a, b, nullptr, M, N, K, bn, bks, stages, threads, va, vb, nullptr, nullptr,
                      0};
  const int err = in_dt == kBF16
                      ? decode_dispatch<__nv_bfloat16>(d, out, out_dt, bk, tm, s)
                      : decode_dispatch<float>(d, out, out_dt, bk, tm, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
