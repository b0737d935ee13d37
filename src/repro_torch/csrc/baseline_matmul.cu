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
// chunk ends on one of the loop's 64-row MAC blocks); M > 16 runs
// gemm_tile.cuh's tiles, picked by M as
// kernels/_build.gemm_tile picks them.  So the A/B of the paper compares
// two kernels that differ only in where the partial sums live.
//
// What bounds it: the same as the MX kernel (HBM bytes and the serial K
// chain at decode, f32 FMAs at prefill) plus the output round trips, which
// grow with K / bk.
#include "decode_tile.cuh"

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

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(TileCfg<BM, BN, BK, TM, TN>::kThreads)
baseline_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, void* out,
                       int out_dt, int M, int N, int K, int bk) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tx = threadIdx.x % Cfg::kTX, ty = threadIdx.x / Cfg::kTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float part[TM][TN], unused[TM][TN];  // one chunk's partial sum only
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;

  float ra[Cfg::kAPer], rb[Cfg::kBPer];
  const int nk = (K + BK - 1) / BK;
  load_a<Cfg, BM, BK>(ra, A, M, K, m0, 0);
  load_b<Cfg, BN, BK>(rb, B, N, K, n0, 0);
  store_a<Cfg, BM, BK>(As, ra);
  store_b<Cfg, BN, BK>(Bs, rb);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) {
      const int k0 = (kt + 1) * BK;
      load_a<Cfg, BM, BK>(ra, A, M, K, m0, k0);
      load_b<Cfg, BN, BK>(rb, B, N, K, n0, k0);
    }
    fma_tile<Cfg, BM, BN, BK, TM, TN, false>(part, unused, As, Bs, Bs, tx, ty);
    const int k_end = (kt + 1) * BK;
    if (k_end % bk == 0 || !more) {  // chunk done: read-modify-write the tile
      const bool first = k_end <= bk;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int gm = m0 + ty * TM + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int gn = n0 + tx + j * Cfg::kTX;
          if (gm < M && gn < N) {
            const int64_t o = (int64_t)gm * N + gn;
            const float prev = first ? 0.0f : ld_cg(out, out_dt, o);
            st_cg(out, out_dt, o, prev + part[i][j]);
          }
          part[i][j] = 0.0f;
        }
      }
    }
    __syncthreads();
    if (more) {
      store_a<Cfg, BM, BK>(As, ra);
      store_b<Cfg, BN, BK>(Bs, rb);
      __syncthreads();
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
static void launch(const void* a, const void* b, void* out, int out_dt, int M, int N,
                   int K, int bk, cudaStream_t stream) {
  using Cfg = TileCfg<BM, BN, BK, TM, TN>;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  baseline_matmul_kernel<T, BM, BN, BK, TM, TN><<<grid, Cfg::kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out, out_dt, M, N, K, bk);
}

template <typename T>
static int dispatch(const void* a, const void* b, void* out, int out_dt, int M, int N,
                    int K, int bk, cudaStream_t s) {
  if (M <= 16)  // the decode rows: baseline_matmul_decode_launch
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 64)  // the prefill tiles of csrc/mx_matmul.cu
    launch<T, 32, 64, 16, 2, 4>(a, b, out, out_dt, M, N, K, bk, s);
  else
    launch<T, 64, 64, 16, 4, 4>(a, b, out, out_dt, M, N, K, bk, s);
  return 0;
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
  decode_sweep<float, T, T, TM, false>(part, unused, d, blockIdx.x * d.bn, c, r0, flush);
}

template <typename T>
static int decode_dispatch(const DecodeShape& d, void* out, int out_dt, int bk, int tm,
                           cudaStream_t s) {
  switch (tm) {
    case 1: return decode_launch<T, T, 1, false>(baseline_decode_kernel<T, 1>, d, s, out,
                                                 out_dt, bk);
    case 2: return decode_launch<T, T, 2, false>(baseline_decode_kernel<T, 2>, d, s, out,
                                                 out_dt, bk);
    case 4: return decode_launch<T, T, 4, false>(baseline_decode_kernel<T, 4>, d, s, out,
                                                 out_dt, bk);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a (M, K), b (K, N): dtype in_dt, row-major, contiguous; out (M, N) out_dt.
// bk: the read-modify-write chunk, a multiple of 128 (every tile's K step
// divides 128).  M > 16 (the decode rows take baseline_matmul_decode_launch).
extern "C" int baseline_matmul_launch(const void* a, const void* b, void* out, int out_dt,
                                      int M, int N, int K, int in_dt, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = in_dt == kBF16
                      ? dispatch<__nv_bfloat16>(a, b, out, out_dt, M, N, K, bk, s)
                      : dispatch<float>(a, b, out, out_dt, M, N, K, bk, s);
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
  const DecodeShape d{a, b, nullptr, M, N, K, bn, bks, stages, threads, va, vb};
  const int err = in_dt == kBF16
                      ? decode_dispatch<__nv_bfloat16>(d, out, out_dt, bk, tm, s)
                      : decode_dispatch<float>(d, out, out_dt, bk, tm, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
