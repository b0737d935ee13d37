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
// Decode: one CTA per (slot, kv head).  The CTA reads its slot's length
// and page ids from `lengths` / `page_table` itself (the Pallas scalar
// prefetch), streams each live page's (ps x d) K and V rows for its kv head
// through shared memory, and keeps the online-softmax statistics (m, l) and
// the output accumulator in f32 across the page walk -- the split-KV form
// of the paper's inter-k buffer.  Positions past a row's last visible
// position are masked to -inf BEFORE the running max, so stale rows of a
// recycled page, rejected drafts and the dump page that pads the table
// never contribute; pages wholly past the length contribute exactly
// nothing in the TPU kernel and are not read at all here.  Each output
// row is stored once; a zero-length (free) slot stores exact zeros.
// Decode keeps its (G x d) accumulator in registers, at most
// kThreads * kAccPer floats.
//
// Verify: one CTA per (slot, kv head, window row), each of decode's shape
// (G query rows): 320 CTAs at 8 slots, 8 kv heads and S = 5, where one CTA
// per (slot, kv head) left 68 of the 132 SMs idle.  Its S CTAs read the
// same K/V rows, the repeats from L2.  Every output row runs decode's
// arithmetic in decode's order, so at S = 1 verify equals decode bit for
// bit; a split of the page walk across CTAs would change that order and is
// not done.  The slot's page ids are read once and every live page's K and
// V rows (and scale rows) go out as 16-byte cp.async copies into a ring
// that holds the whole window when it fits (a slot of 165 positions at
// d = 64 in f32 is 84 KB), else chunks of half the ring, the next in flight
// under this one; one warp per query row keeps its scores, statistics and
// accumulator (in registers) and syncs by warp, the block only when a chunk
// has landed and when its slots are free.  The ring always fits at some
// depth, so S no longer bounds the window: the wrapper raises, naming the
// 227 KB a block can use, only when two pages of the slot do not fit.
//
// What bounds them on the H100: HBM bytes -- each live K/V row is read
// once (2 * len * d * sizeof(page) bytes per slot and kv head, plus 2 * len
// * 4 bytes of scales for int8 / fp8) against 4 * S * G * d FLOPs per row.
// At decode batch sizes the bytes are a few MB, so latency bounds both:
// every output's dot and PV chains are serial (the order that keeps verify
// at S = 1 equal to decode), and a CTA waits on its pages' round trip.
// Decode (64 CTAs at 8 slots x 8 kv heads, one page in flight) keeps the
// design of the port's first slice; splitting its page walk is later work.
#include <algorithm>
#include <type_traits>

#include "mma.cuh"  // cp.async copies

REPRO_EXPORT_ERROR_STRING

constexpr int kThreads = 128;
constexpr int kAccPer = 16;  // decode: G * d <= kThreads * kAccPer
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

// ---------------------------------------------------------------------------
// verify: one CTA per (slot, kv head, window row)
// ---------------------------------------------------------------------------

constexpr int kVerifyMaxWarps = 16;   // one warp per query row; more rows loop
constexpr int kVerifyMaxRows = 2;     // query rows per warp: G <= 32
constexpr int kVerifyMaxCols = 8;     // output columns per lane: d <= 256
constexpr int kVerifyMaxSlots = 32;   // pages on chip per CTA (one lane each)
#ifndef VERIFY_RING_KB  // the ring's budget before chunking (tools/attention_variants.py)
#define VERIFY_RING_KB 100
#endif
constexpr size_t kVerifyRingBytes = VERIFY_RING_KB * 1024;

// Bytes between staged K (or V) rows: a row's d elements rounded up to an
// odd number of 16-byte chunks, so the 16-byte reads of 8 lanes at 8
// neighbouring rows fall on 8 different groups of banks.
__host__ __device__ inline int verify_row_bytes(int d, int elt) {
  const int n16 = (d * elt + 15) / 16;
  return 16 * (n16 | 1);
}

// Floats between the f32 query rows: d rounded up to whole 16-float reads
// (the widest a 16-byte page read is matched with, int8 and e4m3).
__host__ __device__ inline int verify_q_stride(int d) { return (d + 15) / 16 * 16; }

// The dynamic shared memory of a verify CTA: the G query rows in f32, a
// ring of `slots` page slots (K rows, V rows, and with scales their K and V
// scale rows), and one score row of slots * ps per query row.
struct VerifyLayout {
  int row, page, q, scores;
  size_t bytes;
};

__host__ __device__ inline VerifyLayout verify_layout(int G, int d, int ps, int elt,
                                                      bool scaled, int slots) {
  VerifyLayout L;
  L.row = verify_row_bytes(d, elt);
  L.page = (2 * ps * L.row + (scaled ? 8 * ps : 0) + 15) / 16 * 16;
  L.q = G * verify_q_stride(d) * 4;
  L.scores = slots * ps;
  L.bytes = (size_t)L.q + (size_t)slots * L.page + (size_t)G * L.scores * 4;
  return L;
}

// The ring's depth for a table of W pages: as many slots as fit the budget,
// at least 2, at most 32 and no more than the table holds.
static int verify_slots(int G, int d, int ps, int elt, bool scaled, int W) {
  const VerifyLayout one = verify_layout(G, d, ps, elt, scaled, 1);
  const size_t per = one.bytes - one.q;
  const size_t fit = kVerifyRingBytes > (size_t)one.q ? (kVerifyRingBytes - one.q) / per : 0;
  const int slots = static_cast<int>(std::min<size_t>(std::max<size_t>(fit, 2), kVerifyMaxSlots));
  return std::min(slots, std::max(W, 2));
}

// Element i of a 16-byte read of page values, widened to f32 exactly as
// to_f32 widens it (i a constant once unrolled: register bit operations).
template <typename TP>
__device__ __forceinline__ float page_elem(const uint4& raw, int i) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (sizeof(TP) == 4) {
    return __uint_as_float(w[i]);
  } else if constexpr (sizeof(TP) == 2) {  // bf16: its bits are an f32's top half
    return __uint_as_float(((w[i / 2] >> (16 * (i % 2))) & 0xFFFFu) << 16);
  } else {
    const unsigned char byte = static_cast<unsigned char>(w[i / 4] >> (8 * (i % 4)));
    if constexpr (std::is_same<TP, int8_t>::value) {
      return to_f32(static_cast<int8_t>(byte));
    } else {  // e4m3
      TP x;
      x.__x = byte;
      return to_f32(x);
    }
  }
}

// CTA (slot b, kv head h, window row s): query heads h*G .. h*G + G - 1 at
// window row s, visible positions < lengths[b] - S + s + 1.  Each output
// row runs decode's arithmetic in decode's order (the same serial dot, page
// max, serial page sum, l * alpha + sum, acc * alpha then the serial PV
// chain), so at S = 1 verify equals flash_decode_kernel bit for bit; pages
// wholly past a row's last position are not read (they contribute exactly
// nothing).  The slot's live pages are copied with cp.async into a ring of
// `slots` pages -- the whole window at once when it fits, else chunks of
// half the ring, the next chunk in flight under this one's arithmetic --
// and each query row is one warp's: its scores (lanes over positions, four
// independent dot chains per lane), its page statistics (lanes over pages:
// a prefix max, then each page's serial sum), its l and its accumulator
// (lanes over columns, in registers) sync by warp; the block syncs only
// when a chunk has landed and when its slots are free.
template <typename TQ, typename TP>
__global__ void __launch_bounds__(32 * kVerifyMaxWarps)
flash_verify_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                    const TP* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc, const int* __restrict__ table,
                    const int* __restrict__ lengths, TQ* __restrict__ out, int S, int H,
                    int Hkv, int G, int d, int ps, int W, float scale, int slots, int vw) {
  extern __shared__ __align__(16) unsigned char vsmem[];
  constexpr int E = sizeof(TP), VE = 16 / E;  // page elements per 16-byte read
  constexpr unsigned kAll = 0xffffffffu;
  const bool scaled = ksc != nullptr;
  const VerifyLayout L = verify_layout(G, d, ps, E, scaled, slots);
  const int qstride = verify_q_stride(d);
  float* qs = reinterpret_cast<float*>(vsmem);            // (G, d) query rows
  unsigned char* ring = vsmem + L.q;                      // slots x (K, V, scales)
  float* sbuf = reinterpret_cast<float*>(ring + (size_t)slots * L.page);  // (G, slots*ps)

  const int s = blockIdx.x % S, bh = blockIdx.x / S, h = bh % Hkv, b = bh / Hkv;
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len_s = lengths[b] - S + s + 1;  // window row s sees positions < len_s
  const int npages = len_s > 0 ? min((len_s + ps - 1) / ps, W) : 0;
  const int* tb = table + (int64_t)b * W;
  const int64_t qoff = (((int64_t)b * S + s) * H + (int64_t)h * G) * d;  // heads h*G.. contiguous
  const int64_t kvrow = (int64_t)Hkv * d * E;  // bytes between a page's rows of one kv head

  for (int e = threadIdx.x; e < G * d; e += blockDim.x)
    qs[(e / d) * qstride + e % d] = to_f32(q[qoff + e]);

  // pages per chunk: the whole window when it fits the ring, else half of it
  const int ch = npages <= slots ? slots : slots / 2;
  const int nch = (npages + ch - 1) / ch;
  auto fetch = [&](int ci) {  // chunk ci's pages into ring half ci % 2
    const int p0 = ci * ch, p1 = min(npages, p0 + ch);
    for (int p = p0; p < p1; ++p) {
      unsigned char* slot = ring + (size_t)((ci % 2) * ch + p - p0) * L.page;
      const int64_t row0 = (int64_t)tb[p] * ps * Hkv + h;  // (pid * ps + 0) * Hkv + h
      copy_rows_v(vw, slot, L.row, reinterpret_cast<const unsigned char*>(kp) + row0 * d * E,
                  kvrow, d * E, ps, ps, threadIdx.x, blockDim.x);
      copy_rows_v(vw, slot + ps * L.row, L.row,
                  reinterpret_cast<const unsigned char*>(vp) + row0 * d * E, kvrow, d * E, ps,
                  ps, threadIdx.x, blockDim.x);
      if (scaled)
        for (int r = threadIdx.x; r < 2 * ps; r += blockDim.x) {
          const float* src = (r < ps ? ksc : vsc) + row0 + (int64_t)(r % ps) * Hkv;
          copy_chunk<4>(slot + 2 * ps * L.row + 4 * r,
                        reinterpret_cast<const unsigned char*>(src), true);
        }
    }
  };

  float m[kVerifyMaxRows], l[kVerifyMaxRows], acc[kVerifyMaxRows][kVerifyMaxCols];
#pragma unroll
  for (int rr = 0; rr < kVerifyMaxRows; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.0f;
#pragma unroll
    for (int i = 0; i < kVerifyMaxCols; ++i) acc[rr][i] = 0.0f;
  }

  if (nch > 0) {
    fetch(0);
    cp_async_commit();
  }
  for (int ci = 0; ci < nch; ++ci) {
    if (ci + 1 < nch) {
      fetch(ci + 1);
      cp_async_commit();
      cp_async_wait(1);
    } else {
      cp_async_wait(0);
    }
    __syncthreads();  // chunk ci (and q) landed for every thread
    const int p0 = ci * ch, np = min(npages - p0, ch), npos = np * ps;
    const unsigned char* base = ring + (size_t)((ci % 2) * ch) * L.page;
#pragma unroll
    for (int rr = 0; rr < kVerifyMaxRows; ++rr) {
      const int g = warp + rr * nwarps;
      if (g >= G) break;
      const float* qrow = qs + g * qstride;
      float* sb = sbuf + g * L.scores;
      // scores: lanes over positions, decode's serial dot over c
      for (int t0 = 0; t0 < npos; t0 += 128) {
        float dot[4], ksv[4];
        const unsigned char* kr[4];
        bool live[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + lane + 32 * u, pg = t / ps, r = t - pg * ps;
          live[u] = t < npos && (p0 + pg) * ps + r < len_s;  // masked before the max
          const unsigned char* slot = base + (size_t)(live[u] ? pg : 0) * L.page;
          kr[u] = slot + r * L.row;
          ksv[u] = scaled && live[u] ? reinterpret_cast<const float*>(slot + 2 * ps * L.row)[r]
                                     : 1.0f;
          dot[u] = 0.0f;
        }
        // VE columns from c0 on, n of them live: one 16-byte read per position
        auto step = [&](int c0, int n) {
          float qv[VE];
#pragma unroll
          for (int i = 0; i < VE; i += 4) {  // q rows are 16-byte aligned
            const float4 x = *reinterpret_cast<const float4*>(qrow + c0 + i);
            qv[i] = x.x;
            qv[i + 1] = x.y;
            qv[i + 2] = x.z;
            qv[i + 3] = x.w;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (!live[u]) continue;
            const uint4 raw = *reinterpret_cast<const uint4*>(kr[u] + c0 * E);
#pragma unroll
            for (int i = 0; i < VE; ++i) {
              if (i < n) {
                float kv = page_elem<TP>(raw, i);
                if (scaled) kv *= ksv[u];  // dequant as decode stages it
                dot[u] = fmaf(qv[i], kv, dot[u]);
              }
            }
          }
        };
        int c0 = 0;
        for (; c0 + VE <= d; c0 += VE) step(c0, VE);
        if (c0 < d) step(c0, d - c0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + lane + 32 * u;
          if (t < npos) sb[t] = live[u] ? dot[u] * scale : -INFINITY;
        }
      }
      __syncwarp();
      // page statistics, lane j for page j: max, running max, rescale
      float pm = -INFINITY;
      if (lane < np)
        for (int r = 0; r < ps; ++r) pm = fmaxf(pm, sb[lane * ps + r]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {  // prefix max over pages (exact)
        const float y = __shfl_up_sync(kAll, pm, off);
        if (lane >= off) pm = fmaxf(pm, y);
      }
      const float m_new = fmaxf(m[rr], pm);
      float m_prev = __shfl_up_sync(kAll, m_new, 1);
      if (lane == 0) m_prev = m[rr];
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
      // probabilities, lanes over positions
      for (int t0 = 0; t0 < npos; t0 += 32) {
        const int t = t0 + lane;
        const float ms = __shfl_sync(kAll, m_safe, min(t, npos - 1) / ps);
        if (t < npos) sb[t] = expf(sb[t] - ms);  // masked: exp(-inf) = 0
      }
      __syncwarp();
      float sum = 0.0f;  // each page's serial sum, in position order
      if (lane < np)
        for (int r = 0; r < ps; ++r) sum += sb[lane * ps + r];
      for (int j = 0; j < np; ++j) {
        const float a = __shfl_sync(kAll, alpha, j), sj = __shfl_sync(kAll, sum, j);
        l[rr] = l[rr] * a + sj;
      }
      m[rr] = __shfl_sync(kAll, m_new, np - 1);
      // acc = acc * alpha, then the serial PV chain, page by page
      for (int j = 0; j < np; ++j) {
        const float a = __shfl_sync(kAll, alpha, j);
        const unsigned char* vrow = base + (size_t)j * L.page + ps * L.row;
        const float* vs = reinterpret_cast<const float*>(base + (size_t)j * L.page +
                                                         2 * ps * L.row) + ps;
        const float* pj = sb + j * ps;
#pragma unroll
        for (int i = 0; i < kVerifyMaxCols; ++i) {
          const int c = lane + 32 * i;
          if (c < d) {
            float x = acc[rr][i] * a;
            for (int r = 0; r < ps; ++r) {
              float vv = to_f32(reinterpret_cast<const TP*>(vrow + r * L.row)[c]);
              if (scaled) vv *= vs[r];
              x = fmaf(pj[r], vv, x);
            }
            acc[rr][i] = x;
          }
        }
      }
      __syncwarp();  // the score row is consumed before the next chunk's
    }
    __syncthreads();  // chunk ci's slots are free for chunk ci + 2
  }
#pragma unroll
  for (int rr = 0; rr < kVerifyMaxRows; ++rr) {
    const int g = warp + rr * nwarps;
    if (g >= G) break;
    const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < kVerifyMaxCols; ++i) {
      const int c = lane + 32 * i;
      if (c < d) from_f32(out + qoff + (int64_t)g * d + c, acc[rr][i] / den);  // the single store
    }
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

static int page_bytes(int dp) { return dp == kF32 ? 4 : dp == kBF16 ? 2 : 1; }

// Dynamic shared memory of one verify CTA for G query rows of d, pages of
// ps rows of dtype code dp (with scale pages when `scaled`) and a table of W
// pages, as flash_verify_kernel lays it out (the window row count S does not
// enter: each CTA holds one window row).
extern "C" size_t mx_flash_verify_smem_bytes(int G, int d, int ps, int dp, int scaled, int W) {
  const int elt = page_bytes(dp);
  return verify_layout(G, d, ps, elt, scaled, verify_slots(G, d, ps, elt, scaled, W)).bytes;
}

// The largest group (query rows per kv head) and head dim verify takes.
extern "C" size_t mx_flash_verify_max_group() { return kVerifyMaxWarps * kVerifyMaxRows; }
extern "C" size_t mx_flash_verify_max_dim() { return 32 * kVerifyMaxCols; }

// q (B, S, H, d) of dtype dq; pages, scales, page_table and lengths as in
// decode (lengths count the window); out (B, S, H, d) of dtype dq.  Grid
// B * Hkv * S, min(G, 16) warps.
extern "C" int mx_flash_verify_launch(const void* q, const void* kp, const void* vp,
                                      const void* ksc, const void* vsc, const void* table,
                                      const void* lengths, void* out, int B, int S, int H,
                                      int Hkv, int d, int ps, int W, int dq, int dp,
                                      float scale, void* stream) {
  const int G = H / Hkv;
  if ((dp == kI8 || dp == kF8) && (ksc == nullptr || vsc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (G < 1 || G > kVerifyMaxWarps * kVerifyMaxRows || d < 1 || d > 32 * kVerifyMaxCols ||
      S < 1 || ps < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = page_bytes(dp);
  const bool scaled = ksc != nullptr;
  const int slots = verify_slots(G, d, ps, elt, scaled, W);
  const size_t smem = verify_layout(G, d, ps, elt, scaled, slots).bytes;
  const int vw = copy_width(d * elt, {kp, vp});
  const int warps = std::min(G, kVerifyMaxWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_types(dq, dp, [&](auto tq, auto tp) -> int {
    using TQ = decltype(tq);
    using TP = decltype(tp);
    auto kern = flash_verify_kernel<TQ, TP>;
    if (int err = prepare(kern, smem)) return err;
    kern<<<B * Hkv * S, 32 * warps, smem, s>>>(
        static_cast<const TQ*>(q), static_cast<const TP*>(kp), static_cast<const TP*>(vp),
        static_cast<const float*>(ksc), static_cast<const float*>(vsc),
        static_cast<const int*>(table), static_cast<const int*>(lengths),
        static_cast<TQ*>(out), S, H, Hkv, G, d, ps, W, scale, slots, vw);
    return static_cast<int>(cudaGetLastError());
  });
}
