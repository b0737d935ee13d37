// Flash attention for Hopper (sm_90a), MX pattern on the KV axis.
//
// Replaces the TPU kernel repro/kernels/mx_flash_attention.py::
// mx_flash_attention (_flash_kernel): per head, q (Lq, d) and k, v (Lk, d)
// give softmax(q k^T / sqrt(d)) v, with the right padding masked (kpos <
// Lk) and an optional top-left causal mask (qpos >= kpos, no q offset).
// The port runs every (q tile, head, batch) of the model's (B, S, H, d)
// tensors in ONE launch; query head h reads kv head h / (H / Hkv), so the
// GQA repeat of K and V is never built.  f32 or bf16 q, k, v and output;
// d up to 128 (zamba2's shared block has d = 80).
//
// One CTA per 64 query rows walks the KV tiles of 64 rows in order (the TPU
// grid's sequential kv axis becomes a loop inside the block).  The online
// softmax statistics (m, l) and the (64 x d) output accumulator stay in f32
// registers across the walk -- the paper's inter-k buffer with K := the KV
// sequence -- and the output tile is stored once, acc / max(l, 1e-30).  A
// masked score is -inf before the running max; a row whose tile is masked
// throughout keeps m = -inf and contributes exactly 0.  Under the causal
// mask a KV tile wholly above the diagonal of the tile's last live query
// row would leave m unchanged, scale by exactly 1 and add p = 0, so it is
// not read at all.  The probabilities are rounded to v's dtype before the
// PV product and summed unrounded into l, as the TPU kernel does.
//
// 16 x 16 threads: thread (ty, tx) holds query rows ty + 16 i (i < 4), key
// columns tx + 16 j (j < 4) of the score tile and output columns tx + 16 c
// (c < DC = ceil(d / 16), a template argument: d = 80 keeps 5 columns, not
// 8) of the accumulator; a row's 16 threads are one half-warp, so its max
// and sum reduce with shuffles.  Operands sit in shared memory with rows
// padded to d + 1 (K, Q) and 65 (P) floats.
//
// What bounds it on the H100: at the shapes it serves (Lq = Lk = 512, d =
// 64 or 80) f32 FLOPs -- 4 Lq Lk d per head, halved by the causal skip,
// against 4 (Lq + 2 Lk) d bytes -- on the CUDA cores; wgmma tiles and TMA
// staging are later work.
#include "common.cuh"

REPRO_EXPORT_ERROR_STRING

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;  // 256
constexpr int kBQ = 64;                   // query rows per CTA
constexpr int kBK = 64;                   // key rows per tile
constexpr int kRows = kBQ / kTile;        // 4 query rows per thread
constexpr int kCols = kBK / kTile;        // 4 key columns per thread
constexpr int kMaxD = 128;               // DC <= 8 output columns per thread

__device__ __forceinline__ float round_as(float p, float) { return p; }
__device__ __forceinline__ float round_as(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

// Dynamic shared memory of one CTA: Q and K tiles (padded rows), the V tile
// and the (64 x 65) probability tile: 113 KB at d = 128.
static size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (d + 1) + (size_t)kBK * d +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Lq, int Lk, int H,
                       int Hkv, int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int dp = d + 1, pp = kBK + 1;
  float* qs = smem;             // (BQ, d + 1)
  float* ks = qs + kBQ * dp;    // (BK, d + 1)
  float* vs = ks + kBK * dp;    // (BK, d)
  float* ps = vs + kBK * d;     // (BQ, BK + 1) probabilities

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % kTile, ty = tid / kTile;
  const int64_t qrow = (int64_t)H * d, krow = (int64_t)Hkv * d;
  const T* qb = q + (int64_t)b * Lq * qrow + (int64_t)h * d;
  T* ob = out + (int64_t)b * Lq * qrow + (int64_t)h * d;
  const T* kb = k + (int64_t)b * Lk * krow + (int64_t)hk * d;
  const T* vb = v + (int64_t)b * Lk * krow + (int64_t)hk * d;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e % d;
    qs[r * dp + c] = q0 + r < Lq ? to_f32(qb[(int64_t)(q0 + r) * qrow + c]) : 0.0f;
  }
  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  int nk = (Lk + kBK - 1) / kBK;
  if (causal) {  // tiles past the last live row's diagonal contribute nothing
    const int qlast = min(q0 + kBQ, Lq) - 1;
    nk = min(nk, qlast / kBK + 1);
  }
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBK;
    const int kn = min(kBK, Lk - k0);
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d, c = e % d;
      const bool live = r < kn;
      ks[r * dp + c] = live ? to_f32(kb[(int64_t)(k0 + r) * krow + c]) : 0.0f;
      vs[r * d + c] = live ? to_f32(vb[(int64_t)(k0 + r) * krow + c]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) s[i][jj] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + kTile * i) * dp + c];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) bk[jj] = ks[(tx + kTile * jj) * dp + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) s[i][jj] = fmaf(a[i], bk[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTile * i, qpos = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const int kpos = k0 + tx + kTile * jj;
        const bool keep = kpos < Lk && (!causal || qpos >= kpos);
        s[i][jj] = keep ? s[i][jj] * scale : -INFINITY;  // masked before the max
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = kTile / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float p = expf(s[i][jj] - m_safe);  // masked: exp(-inf) = 0
        sum += p;
        ps[r * pp + tx + kTile * jj] = round_as(p, T{});
      }
#pragma unroll
      for (int off = kTile / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float a[kRows], bv[DC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = ps[(ty + kTile * i) * pp + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + kTile * c;
        bv[c] = col < d ? vs[kk * d + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(a[i], bv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + kTile * i;
    if (q0 + r >= Lq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + kTile * c;
      // the single store
      if (col < d) from_f32(ob + (int64_t)(q0 + r) * qrow + col, acc[i][c] * inv);
    }
  }
}

// q (B, Lq, H, d), k and v (B, Lk, Hkv, d), out (B, Lq, H, d), all of dtype
// dt (f32 or bf16) and contiguous.  Refused with cudaErrorInvalidValue: d
// past the accumulator's 128 columns, H not a multiple of Hkv, no keys.
extern "C" int mx_flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                         int B, int Lq, int Lk, int H, int Hkv, int d,
                                         int causal, int dt, float scale, void* stream) {
  if (d < 1 || d > kMaxD || Hkv < 1 || H % Hkv != 0 || Lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  auto launch = [&](auto kern, auto tag) -> int {
    using T = decltype(tag);
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(out), Lq, Lk,
                                      H, Hkv, d, scale, causal);
    return static_cast<int>(cudaGetLastError());
  };
  auto run = [&](auto tag) -> int {  // DC = ceil(d / 16) output columns per thread
    using T = decltype(tag);
    switch ((d + kTile - 1) / kTile) {
      case 1: return launch(flash_attention_kernel<T, 1>, tag);
      case 2: return launch(flash_attention_kernel<T, 2>, tag);
      case 3: return launch(flash_attention_kernel<T, 3>, tag);
      case 4: return launch(flash_attention_kernel<T, 4>, tag);
      case 5: return launch(flash_attention_kernel<T, 5>, tag);
      case 6: return launch(flash_attention_kernel<T, 6>, tag);
      case 7: return launch(flash_attention_kernel<T, 7>, tag);
      default: return launch(flash_attention_kernel<T, 8>, tag);
    }
  };
  if (dt == kF32) return run(float{});
  if (dt == kBF16) return run(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}
