// Baseline (non-MX) GEMM for Hopper (sm_90a): the paper's comparison.
//
// Replaces the TPU kernel repro/kernels/baseline_matmul.py::baseline_matmul
// (_baseline_kernel): the same (m, n) tiling and operand staging as
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
// What bounds it: the same as the MX kernel (HBM bytes at decode, f32 FMAs
// at prefill) plus the output round trips, which grow with K / bk.
#include "gemm_tile.cuh"

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
static void dispatch(const void* a, const void* b, void* out, int out_dt, int M, int N,
                     int K, int bk, cudaStream_t s) {
  if (M <= 16)  // the same tiles as csrc/mx_matmul.cu
    launch<T, 16, 16, 128, 1, 1>(a, b, out, out_dt, M, N, K, bk, s);
  else if (M <= 64)
    launch<T, 32, 64, 16, 2, 4>(a, b, out, out_dt, M, N, K, bk, s);
  else
    launch<T, 64, 64, 16, 4, 4>(a, b, out, out_dt, M, N, K, bk, s);
}

// a (M, K), b (K, N): dtype in_dt, row-major, contiguous; out (M, N) out_dt.
// bk: the read-modify-write chunk, a multiple of 128 (every tile's K step
// divides 128).
extern "C" int baseline_matmul_launch(const void* a, const void* b, void* out, int out_dt,
                                      int M, int N, int K, int in_dt, int bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dt == kBF16)
    dispatch<__nv_bfloat16>(a, b, out, out_dt, M, N, K, bk, s);
  else
    dispatch<float>(a, b, out, out_dt, M, N, K, bk, s);
  return static_cast<int>(cudaGetLastError());
}
