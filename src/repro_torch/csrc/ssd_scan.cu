// Chunked Mamba-2 SSD scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel): h_t = exp(a_log_t) h_{t-1} + b_t^T x_t, y_t = c_t h_t, for
// every (sequence, head) of the batched layout models/ssm.py::ssd_chunked
// uses -- x (B, L, H, P), a_log (B, L, H) f32, b and c (B, L, G, S) read per
// group (head h reads group h / (H / G), so the repeat to H heads is never
// built), y (B, L, H, P) -- in ONE launch.
//
// One CTA per (sequence, head) walks the chunks of Q rows in order (the
// TPU grid's sequential "arbitrary" axis becomes a loop inside the block).
// Per chunk, in f32:
//   acum = cumsum(a_log)                         (inclusive, one warp)
//   M    = (C B^T) * exp(acum_t - acum_s), s <= t (0 above the diagonal)
//   y    = M X + exp(acum) * (C h)
//   h    = exp(acum_Q) h + (B * exp(acum_Q - acum))^T X
// The (S, P) f32 state h is the MX accumulator with time as the reduction
// axis: it is zeroed before chunk 0 (the C-tile reset), lives in shared
// memory across the whole chunk loop and is never written to device
// memory.  The ragged last chunk is masked on load -- rows past L read
// a_log = 0, b = c = x = 0, exactly JAX's padding -- and its dead rows are
// not stored.  The decay is masked BEFORE the exp: above the diagonal
// acum_t - acum_s is positive and exp could overflow to inf (inf * 0 =
// NaN).
//
// The four products run as 16 x 16 thread tiles, each thread holding 8 x 8,
// 8 x 4, 4 x 8 or 4 x 4 outputs in registers -- the micro tile is picked
// per product from its rows and columns, so a 64-wide product does no
// work for columns it does not have -- and reading its A and B operands
// from shared memory (rows padded to S + 1 / Q + 1 floats so no warp reads
// one bank twice).  A chunk's x, b and c come in as 16-byte vectors where
// the rows allow it.
//
// What bounds it on the H100: f32 FLOPs.  The function needs, per chunk
// of q rows and head, q (q + 1) (S + P) operations for the lower triangle
// of C B^T and of M X (the mask zeroes the rest) and 4 q S P for C h and the
// state update, against q (2P + 2S + 1) * 4 bytes: at q = 128, P = S = 64
// that is 4.2 MFLOP for 132 KB, about 32 FLOP per byte, above the f32
// CUDA-core ridge (67 TFLOP/s / 3.35 TB/s = 20).  This kernel computes the
// two Q x Q squares whole (6.3 MFLOP, half of their tiles past the
// diagonal); skipping those tiles is later work.  The tiles keep every
// operand on chip: one read of x, a_log, b, c and one write of y.  Shared memory is the limit on occupancy: Q = 128, P = S = 64 needs
// 183 KB (x, b, c, the Q x Q decay product, the state), so one CTA per SM.
// Tensor cores (3xTF32 or wgmma) are later work.
#include <type_traits>

#include "common.cuh"

REPRO_EXPORT_ERROR_STRING

constexpr int kTile = 16;                    // threads per tile side
constexpr int kThreads = kTile * kTile;      // 256
constexpr int kMicro = 8;                    // outputs per thread per side
constexpr int kMaxDim = kTile * kMicro;      // Q, P and S are at most 128
constexpr size_t kMaxSmem = 232448;          // dynamic shared memory a block can use

// acc[i][j] += sum_{k < K} A(r_i, k) * B(k, c_j) with r_i = ty + 16 i
// (i < MI, r_i < R) and c_j = tx + 16 j (j < MJ, c_j < C), where A(r, k) =
// A[r * ar + k * ak] and B(k, c) = B[k * bk + c * bc] live in shared
// memory.  Out-of-range rows and columns read 0.
template <int MI, int MJ>
__device__ __forceinline__ void tile_mac(float (&acc)[kMicro][kMicro], const float* A, int ar,
                                         int ak, const float* B, int bk, int bc, int R,
                                         int C, int K, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[MI], b[MJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = ty + kTile * i;
      a[i] = r < R ? A[r * ar + k * ak] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int c = tx + kTile * j;
      b[j] = c < C ? B[k * bk + c * bc] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int M>
struct Micro {
  static constexpr int value = M;
};

// Calls f(Micro<MI>, Micro<MJ>) with the micro tile that covers an R x C
// product: 8 rows (columns) up to 128, 4 up to 64.
template <typename F>
__device__ __forceinline__ void with_micro(int R, int C, F&& f) {
  if (R > 4 * kTile) {
    if (C > 4 * kTile) f(Micro<8>{}, Micro<8>{});
    else f(Micro<8>{}, Micro<4>{});
  } else {
    if (C > 4 * kTile) f(Micro<4>{}, Micro<8>{});
    else f(Micro<4>{}, Micro<4>{});
  }
}

// acc += A B over shared memory, with the micro tile for R x C.
__device__ __forceinline__ void mac(float (&acc)[kMicro][kMicro], const float* A, int ar,
                                    int ak, const float* B, int bk, int bc, int R, int C,
                                    int K, int ty, int tx) {
  with_micro(R, C, [&](auto mi, auto mj) {
    tile_mac<decltype(mi)::value, decltype(mj)::value>(acc, A, ar, ak, B, bk, bc, R, C, K,
                                                       ty, tx);
  });
}

__device__ __forceinline__ void zero(float (&acc)[kMicro][kMicro]) {
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
}

// Dynamic shared memory of one CTA, as ssd_scan_kernel lays it out.
static size_t smem_bytes(int Q, int P, int S) {
  return sizeof(float) * ((size_t)Q * P + 2 * (size_t)Q * (S + 1) + (size_t)Q * (Q + 1) +
                          (size_t)S * P + (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ alog,
                const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y, int L,
                int H, int G, int P, int S, int Q, int vec) {
  extern __shared__ float smem[];
  const int Sp = S + 1, Qp = Q + 1;
  float* xs = smem;             // (Q, P) this chunk's x
  float* bs = xs + Q * P;       // (Q, S + 1) b, then b * exp(acum_Q - acum_s)
  float* cs = bs + Q * Sp;      // (Q, S + 1) c
  float* ms = cs + Q * Sp;      // (Q, Q + 1) the masked decay product
  float* hs = ms + Q * Qp;      // (S, P) the carried state
  float* acum = hs + S * P;     // (Q,) inclusive cumsum of a_log

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % kTile, ty = tid / kTile;
  const int64_t xrow = (int64_t)H * P;  // x / y elements between time steps
  const int64_t brow = (int64_t)G * S;  // b / c elements between time steps
  const T* xb = x + (int64_t)b * L * xrow + (int64_t)h * P;
  T* yb = y + (int64_t)b * L * xrow + (int64_t)h * P;
  const T* bb = bm + (int64_t)b * L * brow + (int64_t)g * S;
  const T* cb = cm + (int64_t)b * L * brow + (int64_t)g * S;
  const float* ab = alog + (int64_t)b * L * H + h;

  for (int e = tid; e < S * P; e += kThreads) hs[e] = 0.0f;  // chunk-0 reset

  float acc[kMicro][kMicro];
  const int nchunks = (L + Q - 1) / Q;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * Q;
    __syncthreads();  // the previous chunk's readers of xs / bs / cs / ms are done
    bool loaded = false;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {  // f32 rows of whole 16-byte vectors (the launcher checked)
        const int P4 = P / 4, S4 = S / 4;
        const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int e = tid; e < Q * P4; e += kThreads) {
          const int t = e / P4, p = (e % P4) * 4;
          *reinterpret_cast<float4*>(xs + t * P + p) =
              t0 + t < L ? *reinterpret_cast<const float4*>(xb + (int64_t)(t0 + t) * xrow + p)
                         : z;
        }
        for (int e = tid; e < Q * S4; e += kThreads) {
          const int t = e / S4, n = (e % S4) * 4;
          const bool live = t0 + t < L;  // padding: b = c = 0 past L
          const float4 vb =
              live ? *reinterpret_cast<const float4*>(bb + (int64_t)(t0 + t) * brow + n) : z;
          const float4 vc =
              live ? *reinterpret_cast<const float4*>(cb + (int64_t)(t0 + t) * brow + n) : z;
          float* bd = bs + t * Sp + n;  // padded rows: no 16-byte stores
          float* cd = cs + t * Sp + n;
          bd[0] = vb.x, bd[1] = vb.y, bd[2] = vb.z, bd[3] = vb.w;
          cd[0] = vc.x, cd[1] = vc.y, cd[2] = vc.z, cd[3] = vc.w;
        }
        loaded = true;
      }
    }
    if (!loaded) {
      for (int e = tid; e < Q * P; e += kThreads) {
        const int t = e / P, p = e % P;
        xs[e] = t0 + t < L ? to_f32(xb[(int64_t)(t0 + t) * xrow + p]) : 0.0f;
      }
      for (int e = tid; e < Q * S; e += kThreads) {
        const int t = e / S, n = e % S;
        const bool live = t0 + t < L;  // padding: b = c = 0 past L
        bs[t * Sp + n] = live ? to_f32(bb[(int64_t)(t0 + t) * brow + n]) : 0.0f;
        cs[t * Sp + n] = live ? to_f32(cb[(int64_t)(t0 + t) * brow + n]) : 0.0f;
      }
    }
    if (tid < 32) {  // warp 0: inclusive scan of a_log (0 past L)
      const int per = (Q + 31) / 32, base = tid * per;
      float run = 0.0f;
      for (int k = 0; k < per; ++k) {
        const int t = base + k;
        if (t < Q) {
          run += t0 + t < L ? ab[(int64_t)(t0 + t) * H] : 0.0f;
          acum[t] = run;
        }
      }
      float incl = run;  // scan of the lanes' totals
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float before = incl - run;
      for (int k = 0; k < per; ++k)
        if (base + k < Q) acum[base + k] += before;
    }
    __syncthreads();

    // (1) ms = (C B^T) * decay, masked before the exp
    zero(acc);
    mac(acc, cs, Sp, 1, bs, 1, Sp, Q, Q, S, ty, tx);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int t = ty + kTile * i;
      if (kTile * i >= Q || t >= Q) continue;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int s = tx + kTile * j;
        if (kTile * j < Q && s < Q)
          ms[t * Qp + s] = s <= t ? acc[i][j] * expf(acum[t] - acum[s]) : 0.0f;
      }
    }
    __syncthreads();

    // (2) y = exp(acum) * (C h) + ms X, stored for the live rows
    const float alast = acum[Q - 1];
    zero(acc);
    mac(acc, cs, Sp, 1, hs, P, 1, Q, P, S, ty, tx);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int t = ty + kTile * i;
      const float e = (kTile * i < Q && t < Q) ? expf(acum[t]) : 0.0f;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] *= e;
    }
    mac(acc, ms, Qp, 1, xs, P, 1, Q, P, Q, ty, tx);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int t = ty + kTile * i;
      if (kTile * i >= Q || t >= Q || t0 + t >= L) continue;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int p = tx + kTile * j;
        if (kTile * j < P && p < P) from_f32(yb + (int64_t)(t0 + t) * xrow + p, acc[i][j]);
      }
    }
    // b's rows scaled for (3); (1) was its last reader
    for (int e = tid; e < Q * S; e += kThreads) {
      const int s = e / S, n = e % S;
      bs[s * Sp + n] *= expf(alast - acum[s]);
    }
    __syncthreads();  // (2)'s reads of hs are done, the scaled bs is visible

    // (3) h = exp(acum_Q) h + (B w)^T X, each thread on its own elements
    zero(acc);
    mac(acc, bs, 1, Sp, xs, P, 1, S, P, Q, ty, tx);
    const float keep = expf(alast);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int n = ty + kTile * i;
      if (kTile * i >= S || n >= S) continue;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int p = tx + kTile * j;
        if (kTile * j < P && p < P) hs[n * P + p] = fmaf(keep, hs[n * P + p], acc[i][j]);
      }
    }
  }
}

// x (B, L, H, P) and y of dtype dt (f32 or bf16); a_log (B, L, H) f32; b and
// c (B, L, G, S) of dtype dt; every tensor contiguous.  Q is the chunk.
// Refused with cudaErrorInvalidValue: Q, P or S past the thread tiles'
// 128, or buffers past the shared memory a block can use.
extern "C" int ssd_scan_launch(const void* x, const void* alog, const void* bm, const void* cm,
                               void* y, int B, int L, int H, int G, int P, int S, int Q, int dt,
                               void* stream) {
  if (Q < 1 || Q > kMaxDim || P < 1 || P > kMaxDim || S < 1 || S > kMaxDim || G < 1 ||
      H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Q, P, S);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = dt == kF32 && P % 4 == 0 && S % 4 == 0 && aligned(x) && aligned(bm) &&
                  aligned(cm);
  auto run = [&](auto tag) -> int {
    using T = decltype(tag);
    auto kern = ssd_scan_kernel<T>;
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<B * H, kThreads, smem, s>>>(static_cast<const T*>(x), static_cast<const float*>(alog),
                                       static_cast<const T*>(bm), static_cast<const T*>(cm),
                                       static_cast<T*>(y), L, H, G, P, S, Q, vec);
    return static_cast<int>(cudaGetLastError());
  };
  if (dt == kF32) return run(float{});
  if (dt == kBF16) return run(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}
