// Paged split-KV flash decode and speculative verify for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/mx_flash_decode.py:
//   - mx_flash_decode (_decode_kernel): one query token per slot attends
//     over that slot's KV cache pages, with GQA (G = H / Hkv query rows per
//     kv head);
//   - mx_flash_verify (_verify_kernel): S = k+1 query rows per slot (the
//     speculative window), row r attending positions <= len - S + r, in one
//     launch.
// Both take f32 or bf16 queries and f32, bf16, int8 or fp8 (e4m3) pages.
// A quantized (int8 or fp8) cache passes per-row f32 scale pages
// (P, ps, Hkv), steered by the same page table; each staged K/V row is
// widened and multiplied by its scale before the dots, as the TPU kernel
// does.
//
// One CTA per (slot, kv head).  The CTA reads its slot's length and page
// ids from `lengths` / `page_table` itself (the Pallas scalar prefetch),
// streams each live page's (ps x d) K and V rows for its kv head through
// shared memory, and keeps the online-softmax statistics (m, l) and the
// output accumulator in f32 across the page walk -- the split-KV form of
// the paper's inter-k buffer.  Positions past a row's last visible
// position are masked to -inf BEFORE the running max, so stale rows of a
// recycled page, rejected drafts and the dump page that pads the table
// never contribute; pages wholly past the length contribute exactly
// nothing in the TPU kernel and are not read at all here.  Each output
// row is stored once; a zero-length (free) slot stores exact zeros.
//
// Decode keeps its (G x d) accumulator in registers, at most
// kThreads * kAccPer floats.  Verify's accumulator is (S*G x d): 5 * 4 * 64
// = 1,280 floats for llama3.2-1b at k = 4, 16 * 9 * 128 = 18,432 for
// llama3-405b at k = 8, past any register budget.  So verify keeps q and
// the accumulator in shared memory (dynamic, up to the 227 KB a block can
// use); its wrapper raises, naming that limit, on a shape that does not
// fit.  At S = 1 verify runs decode's arithmetic in decode's order, so the
// two agree bitwise.
//
// What bounds them on the H100: HBM bytes -- each live K/V row is read
// once (2 * len * d * sizeof(page) bytes per slot and kv head, plus 2 * len
// * 4 bytes of scales for int8 / fp8) against 4 * S * G * d FLOPs per row.  The
// design reads every row with neighbouring threads on neighbouring
// addresses and keeps all reuse (S * G query rows per K/V row) on chip.
// With B * Hkv CTAs (64 at 8 slots x 8 kv heads) the card is far from full
// at decode batch sizes; splitting the page walk across CTAs, wgmma and
// TMA are later work.
#include "common.cuh"

REPRO_EXPORT_ERROR_STRING

constexpr int kThreads = 128;
constexpr int kAccPer = 16;  // decode: G * d <= kThreads * kAccPer
constexpr int kVerifyThreads = 256;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block can use (227 KB)

// One page's K and V rows of kv head h, staged into shared memory as f32
// and dequantized by their scales when the cache carries them.  ks rows
// are padded to d + 1 floats so the score loop reads no bank twice.
template <typename TP>
__device__ __forceinline__ void stage_page(const TP* __restrict__ kp, const TP* __restrict__ vp,
                                           const float* __restrict__ ksc,
                                           const float* __restrict__ vsc, int64_t pid, int h,
                                           int Hkv, int d, int ps, float* ks, float* vs,
                                           int tid, int nthreads) {
  for (int e = tid; e < ps * d; e += nthreads) {
    const int r = e / d, c = e % d;
    const int64_t row = (pid * ps + r) * Hkv + h;
    float kv = to_f32(kp[row * d + c]);
    float vv = to_f32(vp[row * d + c]);
    if (ksc != nullptr) {  // int8 / fp8 pages: dequant on the way into the dots
      kv *= ksc[row];
      vv *= vsc[row];
    }
    ks[r * (d + 1) + c] = kv;
    vs[r * d + c] = vv;
  }
}

// Online-softmax update of `rows` query rows over one page's (rows, ps)
// scores in ss: new running max, rescale factor al of the old statistics,
// probabilities written back into ss.
__device__ __forceinline__ void softmax_page(float* ss, float* ms, float* ls, float* al,
                                             int rows, int ps, int tid, int nthreads) {
  for (int g = tid; g < rows; g += nthreads) {
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
}

template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                    const TP* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc, const int* __restrict__ table,
                    const int* __restrict__ lengths, TQ* __restrict__ out, int H, int Hkv,
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
    stage_page(kp, vp, ksc, vsc, pid, h, Hkv, d, ps, ks, vs, tid, kThreads);
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
    softmax_page(ss, ms, ls, al, G, ps, tid, kThreads);
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

// Query row `row` = s * G + g of a CTA is window row s of query head
// h * G + g; its visible positions end at len - S + s.
template <typename TQ, typename TP>
__global__ void __launch_bounds__(kVerifyThreads)
flash_verify_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                    const TP* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc, const int* __restrict__ table,
                    const int* __restrict__ lengths, TQ* __restrict__ out, int S, int H,
                    int Hkv, int G, int d, int ps, int W, float scale) {
  extern __shared__ float smem[];
  const int R = S * G;
  const int Rd = R * d;
  float* qs = smem;                 // (R, d) query rows
  float* acc = qs + Rd;             // (R, d) output accumulator
  float* ks = acc + Rd;             // (ps, d + 1): padded rows
  float* vs = ks + ps * (d + 1);    // (ps, d)
  float* ss = vs + ps * d;          // (R, ps) scores, then probabilities
  float* ms = ss + R * ps;          // (R,) running max
  float* ls = ms + R;               // (R,) running normaliser
  float* al = ls + R;               // (R,) rescale of this page

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int len = lengths[b];
  const int last = len - S;  // window row s sees positions <= last + s

  for (int e = tid; e < Rd; e += kVerifyThreads) {
    const int row = e / d, c = e % d;
    const int s = row / G, g = row % G;
    qs[e] = to_f32(q[(((int64_t)b * S + s) * H + (int64_t)h * G + g) * d + c]);
    acc[e] = 0.0f;
  }
  for (int g = tid; g < R; g += kVerifyThreads) {
    ms[g] = -INFINITY;
    ls[g] = 0.0f;
  }

  const int npages = min((len + ps - 1) / ps, W);
  for (int j = 0; j < npages; ++j) {
    const int64_t pid = table[(int64_t)b * W + j];
    __syncthreads();
    stage_page(kp, vp, ksc, vsc, pid, h, Hkv, d, ps, ks, vs, tid, kVerifyThreads);
    __syncthreads();
    for (int e = tid; e < R * ps; e += kVerifyThreads) {
      const int row = e / ps, r = e % ps;
      float s = -INFINITY;
      if (j * ps + r <= last + row / G) {  // causal within the window, before the max
        float dot = 0.0f;
        for (int c = 0; c < d; ++c) dot = fmaf(qs[row * d + c], ks[r * (d + 1) + c], dot);
        s = dot * scale;
      }
      ss[e] = s;
    }
    __syncthreads();
    softmax_page(ss, ms, ls, al, R, ps, tid, kVerifyThreads);
    __syncthreads();
    for (int e = tid; e < Rd; e += kVerifyThreads) {
      const int row = e / d, c = e % d;
      float a = acc[e] * al[row];
      for (int rr = 0; rr < ps; ++rr) a = fmaf(ss[row * ps + rr], vs[rr * d + c], a);
      acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < Rd; e += kVerifyThreads) {
    const int row = e / d, c = e % d;
    const int s = row / G, g = row % G;
    from_f32(out + (((int64_t)b * S + s) * H + (int64_t)h * G + g) * d + c,
             acc[e] / fmaxf(ls[row], 1e-30f));  // the single store
  }
}

// Calls f(TQ{}, TP{}) for the query/output dtype code dq and the page
// dtype code dp.
template <typename F>
static int with_types(int dq, int dp, F&& f) {
  if (dq == kF32) {
    if (dp == kF32) return f(float{}, float{});
    if (dp == kBF16) return f(float{}, __nv_bfloat16{});
    if (dp == kI8) return f(float{}, int8_t{});
    if (dp == kF8) return f(float{}, __nv_fp8_e4m3{});
  } else if (dq == kBF16) {
    if (dp == kF32) return f(__nv_bfloat16{}, float{});
    if (dp == kBF16) return f(__nv_bfloat16{}, __nv_bfloat16{});
    if (dp == kI8) return f(__nv_bfloat16{}, int8_t{});
    if (dp == kF8) return f(__nv_bfloat16{}, __nv_fp8_e4m3{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename K>
static int prepare(K kern, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024)
    return static_cast<int>(
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  return 0;
}

// q (B, H, d) of dtype dq; k_pages / v_pages (P, ps, Hkv, d) of dtype dp;
// k_scale / v_scale (P, ps, Hkv) f32 or null (required for int8 / fp8 pages);
// page_table (B, W) int32; lengths (B,) int32; out (B, H, d) of dtype dq.
extern "C" int mx_flash_decode_launch(const void* q, const void* kp, const void* vp,
                                      const void* ksc, const void* vsc, const void* table,
                                      const void* lengths, void* out, int B, int H, int Hkv,
                                      int d, int ps, int W, int dq, int dp, float scale,
                                      void* stream) {
  const int G = H / Hkv;
  if (G * d > kThreads * kAccPer) return static_cast<int>(cudaErrorInvalidValue);
  if ((dp == kI8 || dp == kF8) && (ksc == nullptr || vsc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * ((size_t)G * d + (size_t)ps * (d + 1) + (size_t)ps * d +
                       (size_t)G * ps + 3 * (size_t)G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dq, dp, [&](auto tq, auto tp) -> int {
    using TQ = decltype(tq);
    using TP = decltype(tp);
    auto kern = flash_decode_kernel<TQ, TP>;
    if (int err = prepare(kern, smem)) return err;
    kern<<<B * Hkv, kThreads, smem, s>>>(
        static_cast<const TQ*>(q), static_cast<const TP*>(kp), static_cast<const TP*>(vp),
        static_cast<const float*>(ksc), static_cast<const float*>(vsc),
        static_cast<const int*>(table), static_cast<const int*>(lengths),
        static_cast<TQ*>(out), H, Hkv, G, d, ps, W, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

// The largest (G * d) decode's register accumulator holds.
extern "C" size_t mx_flash_decode_max_group_width() { return kThreads * kAccPer; }

// The dynamic shared memory a block can use; verify refuses a shape past it.
extern "C" size_t mx_flash_max_smem_bytes() { return kMaxSmem; }

// Dynamic shared memory of one verify CTA, as flash_verify_kernel lays it
// out: q and the accumulator (S*G, d), one page's K (padded rows) and V, the
// (S*G, ps) scores and (m, l, alpha).
extern "C" size_t mx_flash_verify_smem_bytes(int S, int G, int d, int ps) {
  const size_t R = (size_t)S * G;
  return sizeof(float) *
         (2 * R * d + (size_t)ps * (d + 1) + (size_t)ps * d + R * ps + 3 * R);
}

// q (B, S, H, d) of dtype dq; pages, scales, page_table and lengths as in
// decode (lengths count the window); out (B, S, H, d) of dtype dq.
extern "C" int mx_flash_verify_launch(const void* q, const void* kp, const void* vp,
                                      const void* ksc, const void* vsc, const void* table,
                                      const void* lengths, void* out, int B, int S, int H,
                                      int Hkv, int d, int ps, int W, int dq, int dp,
                                      float scale, void* stream) {
  const int G = H / Hkv;
  if ((dp == kI8 || dp == kF8) && (ksc == nullptr || vsc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mx_flash_verify_smem_bytes(S, G, d, ps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dq, dp, [&](auto tq, auto tp) -> int {
    using TQ = decltype(tq);
    using TP = decltype(tp);
    auto kern = flash_verify_kernel<TQ, TP>;
    if (int err = prepare(kern, smem)) return err;
    kern<<<B * Hkv, kVerifyThreads, smem, s>>>(
        static_cast<const TQ*>(q), static_cast<const TP*>(kp), static_cast<const TP*>(vp),
        static_cast<const float*>(ksc), static_cast<const float*>(vsc),
        static_cast<const int*>(table), static_cast<const int*>(lengths),
        static_cast<TQ*>(out), S, H, Hkv, G, d, ps, W, scale);
    return static_cast<int>(cudaGetLastError());
  });
}
