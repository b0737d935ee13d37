// Paged split-KV flash decode for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mx_flash_decode.py::mx_flash_decode
// (_decode_kernel): one query token per slot attends over that slot's KV
// cache pages, with GQA (G = H / Hkv query rows per kv head).
//
// One CTA per (slot, kv head).  The CTA reads its slot's length and page
// ids from `lengths` / `page_table` itself (the Pallas scalar prefetch),
// streams each live page's (ps x d) K and V rows for its kv head through
// shared memory, and keeps the online-softmax statistics (m, l) and the
// (G x d) output accumulator in f32 across the page walk -- the split-KV
// form of the paper's inter-k buffer.  Positions >= length are masked to
// -inf BEFORE the running max, so stale rows of a recycled page (and the
// dump page that pads the table) never contribute; pages wholly past the
// length contribute exactly nothing in the TPU kernel and are not read at
// all here.  The output row is stored once; a zero-length (free) slot
// stores exact zeros.
//
// What bounds it on the H100: HBM bytes -- each live K/V row is read once
// (2 * len * d * 4 bytes per slot and kv head in f32) against 4 * G * d
// FLOPs per row.  The design reads every row with neighbouring threads on
// neighbouring addresses and keeps all reuse (G query rows per K/V row)
// on chip.  With B * Hkv CTAs (64 at 8 slots x 8 kv heads) the card is far
// from full at decode batch sizes; splitting the page walk across CTAs is
// later work.
#include "common.cuh"

REPRO_EXPORT_ERROR_STRING

constexpr int kThreads = 128;
constexpr int kAccPer = 16;  // G * d <= kThreads * kAccPer

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out, int H, int Hkv,
                    int G, int d, int ps, int W, float scale) {
  extern __shared__ float smem[];
  const int Gd = G * d;
  float* qs = smem;                 // (G, d)
  float* ks = qs + Gd;              // (ps, d + 1): padded rows
  float* vs = ks + ps * (d + 1);    // (ps, d)
  float* ss = vs + ps * d;          // (G, ps) scores, then probabilities
  float* ms = ss + G * ps;          // (G,) running max
  float* ls = ms + G;               // (G,) running normaliser
  float* al = ls + G;               // (G,) rescale of this page

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int len = lengths[b];
  const int64_t qoff = ((int64_t)b * H + (int64_t)h * G) * d;  // heads h*G.. are contiguous

  for (int e = tid; e < Gd; e += kThreads) qs[e] = to_f32(q[qoff + e]);
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = -INFINITY;
    ls[g] = 0.0f;
  }
  float acc[kAccPer];
#pragma unroll
  for (int r = 0; r < kAccPer; ++r) acc[r] = 0.0f;

  const int npages = min((len + ps - 1) / ps, W);
  for (int j = 0; j < npages; ++j) {
    const int64_t pid = table[(int64_t)b * W + j];
    __syncthreads();  // the previous page's rows and probabilities are consumed
    for (int e = tid; e < ps * d; e += kThreads) {
      const int r = e / d, c = e % d;
      const int64_t src = ((pid * ps + r) * Hkv + h) * d + c;
      ks[r * (d + 1) + c] = to_f32(kp[src]);
      vs[r * d + c] = to_f32(vp[src]);
    }
    __syncthreads();
    for (int e = tid; e < G * ps; e += kThreads) {
      const int g = e / ps, r = e % ps;
      float s = -INFINITY;
      if (j * ps + r < len) {  // mask by position before the running max
        float dot = 0.0f;
        for (int c = 0; c < d; ++c) dot = fmaf(qs[g * d + c], ks[r * (d + 1) + c], dot);
        s = dot * scale;
      }
      ss[e] = s;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      const float m_prev = ms[g];
      float mx = -INFINITY;
      for (int r = 0; r < ps; ++r) mx = fmaxf(mx, ss[g * ps + r]);
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
      float sum = 0.0f;
      for (int r = 0; r < ps; ++r) {
        const float p = expf(ss[g * ps + r] - m_safe);  // masked: exp(-inf) = 0
        ss[g * ps + r] = p;
        sum += p;
      }
      ls[g] = ls[g] * alpha + sum;
      ms[g] = m_new;
      al[g] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAccPer; ++r) {
      const int e = tid + r * kThreads;
      if (e < Gd) {
        const int g = e / d, c = e % d;
        float a = acc[r] * al[g];
        for (int rr = 0; rr < ps; ++rr) a = fmaf(ss[g * ps + rr], vs[rr * d + c], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();  // ls is visible to every thread (also when no page is live)
#pragma unroll
  for (int r = 0; r < kAccPer; ++r) {
    const int e = tid + r * kThreads;
    if (e < Gd) {
      const int g = e / d;
      from_f32(out + qoff + e, acc[r] / fmaxf(ls[g], 1e-30f));  // the single store
    }
  }
}

// q (B, H, d); k_pages / v_pages (P, ps, Hkv, d); page_table (B, W) int32;
// lengths (B,) int32; out (B, H, d).  q, pages and out share dtype `dt`.
extern "C" int mx_flash_decode_launch(const void* q, const void* kp, const void* vp,
                                      const void* table, const void* lengths, void* out,
                                      int B, int H, int Hkv, int d, int ps, int W, int dt,
                                      float scale, void* stream) {
  const int G = H / Hkv;
  if (G * d > kThreads * kAccPer) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * ((size_t)G * d + (size_t)ps * (d + 1) + (size_t)ps * d +
                       (size_t)G * ps + 3 * (size_t)G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  if (dt == kBF16) {
    auto kern = flash_decode_kernel<__nv_bfloat16>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<B * Hkv, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), tb, ln, static_cast<__nv_bfloat16*>(out), H,
        Hkv, G, d, ps, W, scale);
  } else {
    auto kern = flash_decode_kernel<float>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<B * Hkv, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(kp),
        static_cast<const float*>(vp), tb, ln, static_cast<float*>(out), H, Hkv, G, d, ps,
        W, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
