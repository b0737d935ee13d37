// Paged split-KV flash decode and speculative verify for Hopper (sm_90a):
// one kernel, the page walk split into spans across a thread-block cluster.
//
// Replaces the TPU kernels of repro/kernels/mx_flash_decode.py:
//   - mx_flash_decode (_decode_kernel): one query token per slot attends
//     over that slot's KV cache pages, with GQA (G = H / Hkv query rows per
//     kv head);
//   - mx_flash_verify (_verify_kernel): S = k+1 query rows per slot (the
//     speculative window), row r attending positions <= len - S + r, in one
//     launch.
// Decode is verify at S = 1 (JAX's docstring calls verify the widening of
// the same kernel): one kernel body and one launcher serve both, so verify
// at S = 1 equals decode bit for bit by construction.  Both take f32 or
// bf16 queries and f32, bf16, int8 or fp8 (e4m3) pages.  A quantized
// (int8 or fp8) cache passes per-row f32 scale pages (P, ps, Hkv), steered
// by the same page table; each staged K/V row is widened and multiplied by
// its scale before the dots, as the TPU kernel does.
//
// The split.  A slot's positions are cut into spans of `span_pages` pages
// (kernels/_build.decode_span: a constant of the page size, the head dim and
// the page dtype).  One cluster of C CTAs (1 <= C <= 8, a portable cluster)
// serves one (slot, kv head, window row): in round j, rank r computes the
// `group` consecutive spans from (j * C + r) * group on.  A span's partial
// (m, l, acc) for each of the G query rows is computed from zero in a fixed
// order: each dot in four chains over d (the elements of a 16-byte read by
// their index mod 4) summed as (0 + 1) + (2 + 3), the span's max, p =
// exp(s - m) and its sum (each lane over its positions in order, then a
// butterfly of shuffles, whose every lane ends with the same bits), then PV
// in two chains per column (each page's even and odd rows, each in order)
// summed at the end.  Each rank writes its partials into rank 0's shared
// memory (distributed shared memory), and rank 0 folds them into its
// running (m, l, acc) in span order: partials never go to device memory,
// and the output row is stored once, acc / max(l, 1e-30) -- the paper's
// single write-back applied to the split.  Every partial is a function of
// its span's positions alone and the fold runs in span order, so the
// output's bits depend only on the positions, the page size and the page
// dtype: not on the batch, the table width W, the grid, the cluster size or
// the group.
//
// Each CTA keeps its rounds in flight through a ring of `ring` slots of
// 16-byte cp.async copies (the next rounds' pages land under this round's
// arithmetic) and gives each query row to one warp (scores: lanes over
// positions, up to four positions of four chains each per lane; PV: lanes
// over columns, in registers; the chains give the serial arithmetic of a
// warp the independent instructions its latency needs).  The partials are
// double buffered, so a round needs one cluster barrier, split into arrive
// (after the round's partials are written) and wait (before the next are
// written), with the next round's first span between; a cluster of one CTA
// (a large grid) needs none: each warp folds its rows' partial as it
// finishes a span.
// Positions past a row's last visible position are masked to -inf before
// the max, so stale rows of a recycled page, rejected drafts and the dump
// page that pads the table never contribute; pages wholly past the length
// are not read; a span with no visible position is skipped by the fold; a
// zero-length (free) slot stores exact zeros.
//
// What bounds it on the H100: HBM bytes -- each live K/V row is read once
// (2 * len * d * sizeof(page) bytes per slot and kv head, plus 2 * len * 4
// bytes of scales for int8 / fp8) against 4 * S * G * d FLOPs per row, far
// below the tensor cores' ridge, so the CUDA cores do the arithmetic.  The
// kernel this replaces walked a slot's pages in order in one CTA per (slot,
// kv head), one page on chip at a time behind four barriers: 64 CTAs at
// llama's decode shape and a latency of a round trip per page.  Spans put
// C CTAs on each slot, and the ring keeps a CTA's next spans in flight.
#include <algorithm>
#include <type_traits>

#include <cooperative_groups.h>

#include "mma.cuh"  // cp.async copies

namespace cg = cooperative_groups;

REPRO_EXPORT_ERROR_STRING

constexpr int kMaxWarps = 16;    // one warp per query row; more rows loop
constexpr int kMaxRows = 2;      // query rows per warp: G <= 32
constexpr int kMaxCols = 8;      // output columns per lane: d <= 256
constexpr int kMaxCluster = 8;   // a portable cluster
constexpr int kMaxRing = 4;      // span slots per CTA
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block can use (227 KB)

// Bytes between staged K (or V) rows: a row's d elements rounded up to an
// odd number of 16-byte chunks, so the 16-byte reads of 8 lanes at 8
// neighbouring rows fall on 8 different groups of banks.
__host__ __device__ inline int split_row_bytes(int d, int elt) {
  const int n16 = (d * elt + 15) / 16;
  return 16 * (n16 | 1);
}

// Floats between the f32 query rows: d rounded up to whole 16-float reads
// (the widest a 16-byte page read is matched with, int8 and e4m3).
__host__ __device__ inline int split_q_stride(int d) { return (d + 15) / 16 * 16; }

// The dynamic shared memory of a CTA: the G query rows in f32, a ring of
// `ring` slots of `group` spans (each `span_pages` pages of K rows, V rows
// and, with scales, their K and V scale rows), one score row per query row,
// two buffers of the cluster's partials (m, l, acc[d] per span and query row;
// the ranks write theirs into rank 0's), rank 0's running (m, l, acc) per
// query row, the CTA's own partials of a round, staged as its warps finish
// them, and the page ids of the CTA's spans for a table of W pages.
struct SplitLayout {
  int row, page, span, npos, part, ids;
  size_t q, ring, scores, parts, staged, bytes;
};

__host__ __device__ inline SplitLayout split_layout(int G, int d, int ps, int elt,
                                                    bool scaled, int span_pages, int group,
                                                    int ring, int cluster, int W) {
  SplitLayout L;
  L.row = split_row_bytes(d, elt);
  L.page = (2 * ps * L.row + (scaled ? 8 * ps : 0) + 15) / 16 * 16;
  L.span = span_pages * L.page;
  L.npos = span_pages * ps;
  L.part = d + 2;  // floats per partial row: m, l, acc
  L.q = (size_t)G * split_q_stride(d) * 4;
  L.ring = (size_t)ring * group * L.span;
  L.scores = (size_t)G * L.npos * 4;
  // partials, rank 0's running rows, this CTA's staged partials
  L.parts = (2 * (size_t)cluster * group + 1) * G * L.part * 4;
  L.staged = (size_t)group * G * L.part * 4;
  const int spans = (W + span_pages - 1) / span_pages;
  L.ids = (spans + cluster * group - 1) / (cluster * group) * group * span_pages;
  L.bytes = L.q + L.ring + L.scores + L.parts + L.staged + ((size_t)L.ids * 4 + 15) / 16 * 16;
  return L;
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

// The cluster barrier in its two halves (every thread of every CTA of the
// cluster calls them, alternately): arrive publishes this CTA's shared
// memory writes, wait returns once every CTA has arrived and sees theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (C, B * Hkv * S), clusters of (C, 1, 1): cluster (slot b, kv head h,
// window row s) serves query heads h*G .. h*G + G - 1 at window row s,
// visible positions < lengths[b] - S + s + 1; rank r computes spans r,
// r + C, ...; rank 0 folds them in span order and stores the rows.
template <typename TQ, typename TP, int NC, bool SCALED>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_split_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                   const TP* __restrict__ vp, const float* __restrict__ ksc,
                   const float* __restrict__ vsc, const int* __restrict__ table,
                   const int* __restrict__ lengths, TQ* __restrict__ out, int S, int H,
                   int Hkv, int G, int d, int ps, int W, float scale, int span_pages,
                   int group, int ring_slots, int vw) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = sizeof(TP), VE = 16 / E;  // page elements per 16-byte read
  constexpr unsigned kAll = 0xffffffffu;
  constexpr bool scaled = SCALED;  // int8 / fp8 pages (or scales given with float pages)
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  const SplitLayout L =
      split_layout(G, d, ps, E, scaled, span_pages, group, ring_slots, C, W);
  const int qstride = split_q_stride(d);
  float* qs = reinterpret_cast<float*>(smem);                    // (G, d) query rows
  unsigned char* ring = smem + L.q;                              // ring x span slots
  float* sbuf = reinterpret_cast<float*>(ring + L.ring);         // (G, npos) scores
  float* part = reinterpret_cast<float*>(ring + L.ring + L.scores);  // [2][C][group][G][d + 2]
  float* part0 = cl.map_shared_rank(part, 0);  // rank 0's, where every rank writes
  float* stg = reinterpret_cast<float*>(ring + L.ring + L.scores + L.parts);  // [group][G][d + 2]
  int* sid = reinterpret_cast<int*>(stg + (size_t)group * G * L.part);  // page ids
  const int s = blockIdx.y % S, bh = blockIdx.y / S, h = bh % Hkv, b = bh / Hkv;
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len_s = lengths[b] - S + s + 1;  // window row s sees positions < len_s
  const int npages = len_s > 0 ? min((len_s + ps - 1) / ps, W) : 0;
  const int nspans = (npages + span_pages - 1) / span_pages;
  const int per_round = C * group;  // spans a round of the cluster computes
  const int nrounds = (nspans + per_round - 1) / per_round;
  const int gpages = group * span_pages;  // pages a CTA copies per round
  const int* tb = table + (int64_t)b * W;
  const int64_t qoff = (((int64_t)b * S + s) * H + (int64_t)h * G) * d;  // heads h*G.. contiguous
  const int64_t kvrow = (int64_t)Hkv * d * E;  // bytes between a page's rows of one kv head

  for (int e = threadIdx.x; e < G * d; e += blockDim.x)
    qs[(e / d) * qstride + e % d] = to_f32(q[qoff + e]);
  // the page ids of this rank's spans, read once: round j's at j * gpages
  for (int k = threadIdx.x; k < nrounds * gpages; k += blockDim.x) {
    const int p = ((k / gpages) * C + rank) * gpages + k % gpages;
    sid[k] = p < npages ? tb[p] : 0;
  }
  __syncthreads();

  // round j's spans of this rank (`group` of them, consecutive) into ring
  // slot j % ring_slots
  auto fetch = [&](int j) {
    const int p0 = (j * C + rank) * gpages;
    if (j >= nrounds || p0 >= npages) return;
    const int p1 = min(npages, p0 + gpages);
    unsigned char* slot = ring + (size_t)(j % ring_slots) * group * L.span;
    for (int p = p0; p < p1; ++p) {
      unsigned char* pg = slot + (size_t)(p - p0) * L.page;
      const int64_t row0 = (int64_t)sid[j * gpages + p - p0] * ps * Hkv + h;
      copy_rows_v(vw, pg, L.row, reinterpret_cast<const unsigned char*>(kp) + row0 * d * E,
                  kvrow, d * E, ps, ps, threadIdx.x, blockDim.x);
      copy_rows_v(vw, pg + ps * L.row, L.row,
                  reinterpret_cast<const unsigned char*>(vp) + row0 * d * E, kvrow, d * E, ps,
                  ps, threadIdx.x, blockDim.x);
      if (scaled)
        for (int r = threadIdx.x; r < 2 * ps; r += blockDim.x) {
          const float* src = (r < ps ? ksc : vsc) + row0 + (int64_t)(r % ps) * Hkv;
          copy_chunk<4>(pg + 2 * ps * L.row + 4 * r,
                        reinterpret_cast<const unsigned char*>(src), true);
        }
    }
  };

  // rank 0's running (m, l, acc) per query row, in its shared memory
  float* run = part + 2 * (size_t)per_round * G * L.part;
  for (int e = threadIdx.x; e < G * L.part; e += blockDim.x)
    run[e] = e % L.part == 0 ? -INFINITY : 0.0f;
  // fold one span's partial (m_i, l_i, acc_i(c) for the lane's columns c)
  // into query row g's running row; a partial with m_i = -inf (no visible
  // position, or no span) is skipped
  auto merge = [&](int g, float mi, float li, auto acc_i) {
    if (mi == -INFINITY) return;
    float* rg = run + (size_t)g * L.part;
    const float m = rg[0], l = rg[1];
    const float m_new = fmaxf(m, mi);
    const float a = m == -INFINITY ? 0.0f : expf(m - m_new);
    const float bq = expf(mi - m_new);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) rg[2 + c] = fmaf(acc_i(i, c), bq, rg[2 + c] * a);
    }
    __syncwarp();
    if (lane == 0) {
      rg[0] = m_new;
      rg[1] = fmaf(li, bq, l * a);
    }
    __syncwarp();
  };
  // rank 0 folds round j's partials (every rank's group, in rank order:
  // span order) from its own shared memory
  auto fold = [&](int j) {
    const float* buf = part + (size_t)(j & 1) * per_round * G * L.part;
    for (int g = warp; g < G; g += nwarps)
      for (int k = 0; k < per_round; ++k) {
        const float* pr = buf + ((size_t)k * G + g) * L.part;
        merge(g, pr[0], pr[1], [&](int, int c) { return pr[2 + c]; });
      }
  };
  // a cluster of one CTA folds each span as its warps finish it: no barrier
#ifdef FLASH_SPLIT_TIMING_NO_CLUSTER
  const bool alone = true;  // every CTA folds only its own spans (timing only)
#else
  const bool alone = C == 1;
#endif
  if (nrounds > 0 && !alone) cluster_arrive();  // waited on before the first write to rank 0
  for (int j = 0; j < ring_slots - 1; ++j) {
    fetch(j);
    cp_async_commit();
  }
  for (int j = 0; j < nrounds; ++j) {
    if (ring_slots == 1) {
      __syncthreads();  // the one slot is consumed
      fetch(j);
      cp_async_commit();
    }
    cp_async_wait(ring_slots >= 2 ? ring_slots - 2 : 0);
    __syncthreads();  // round j's span (and q) landed for every thread; slot j - 1 is free
    if (ring_slots >= 2) {
      fetch(j + ring_slots - 1);
      cp_async_commit();
    }
    for (int k = 0; k < group; ++k) {
      const int sp = (j * C + rank) * group + k;
      const int p0 = sp * span_pages, np = sp < nspans ? min(npages - p0, span_pages) : 0;
      const int npos = np * ps, pos0 = p0 * ps;
      const unsigned char* base = ring + ((size_t)(j % ring_slots) * group + k) * L.span;
      for (int g = warp; g < G; g += nwarps) {
        float pa[NC];  // this span's acc of row g, in registers
#pragma unroll
        for (int i = 0; i < NC; ++i) pa[i] = 0.0f;
        float* st = stg + ((size_t)k * G + g) * L.part;  // staged in this CTA
#ifdef FLASH_SPLIT_TIMING_NO_MATH
        const bool empty = true;  // timing only: no arithmetic
#else
        const bool empty = npos == 0;
#endif
        if (empty) {
          if (lane == 0) st[0] = -INFINITY;  // no span: skipped by the fold
          continue;
        }
        const float* qrow = qs + g * qstride;
        float* sb = sbuf + g * L.npos;
        // scores: lanes over positions; each dot in four chains (the elements
        // of a 16-byte read by their index mod 4), summed in a fixed order
        for (int t0 = 0; t0 < npos; t0 += 128) {
          float dot[4][4], ksv[4];
          const unsigned char* kr[4];
          bool live[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = t0 + lane + 32 * u, pg = t / ps, r = t - pg * ps;
            live[u] = t < npos && pos0 + t < len_s;  // masked before the max
            const unsigned char* page = base + (size_t)(live[u] ? pg : 0) * L.page;
            kr[u] = page + r * L.row;
            ksv[u] = scaled && live[u] ? reinterpret_cast<const float*>(page + 2 * ps * L.row)[r]
                                       : 1.0f;
#pragma unroll
            for (int k = 0; k < 4; ++k) dot[u][k] = 0.0f;
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
                  if (scaled) kv *= ksv[u];  // dequant on the way into the dot
                  dot[u][i & 3] = fmaf(qv[i], kv, dot[u][i & 3]);
                }
              }
            }
          };
          int c0 = 0;
#pragma unroll 4
          for (; c0 + VE <= d; c0 += VE) step(c0, VE);
          if (c0 < d) step(c0, d - c0);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = t0 + lane + 32 * u;
            if (t < npos)
              sb[t] = live[u] ? ((dot[u][0] + dot[u][1]) + (dot[u][2] + dot[u][3])) * scale
                              : -INFINITY;
          }
        }
        __syncwarp();
        // the span's max (exact in any order), then p and its sum: each lane
        // over its positions in order, then a butterfly (every lane the same bits)
        float mx = -INFINITY;
        for (int t = lane; t < npos; t += 32) mx = fmaxf(mx, sb[t]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
        const float m_safe = isfinite(mx) ? mx : 0.0f;
        float sum = 0.0f;
        for (int t = lane; t < npos; t += 32) {
          const float p = expf(sb[t] - m_safe);  // masked: exp(-inf) = 0
          sb[t] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kAll, sum, off);
        __syncwarp();
        // PV, lanes over columns: two chains per column (a page's even and odd
        // rows, each in order), summed at the end
        float odd[NC];
#pragma unroll
        for (int i = 0; i < NC; ++i) odd[i] = 0.0f;
        for (int jj = 0; jj < np; ++jj) {
          const unsigned char* vrow = base + (size_t)jj * L.page + ps * L.row;
          const float* vs =
              reinterpret_cast<const float*>(base + (size_t)jj * L.page + 2 * ps * L.row) + ps;
          const float* pj = sb + jj * ps;
#pragma unroll 2
          for (int r = 0; r < ps; r += 2) {
            const bool two = r + 1 < ps;
            const float p0 = pj[r], p1 = two ? pj[r + 1] : 0.0f;
            const TP* v0 = reinterpret_cast<const TP*>(vrow + r * L.row);
            const TP* v1 = reinterpret_cast<const TP*>(vrow + (two ? r + 1 : r) * L.row);
            float s0 = 1.0f, s1 = 1.0f;
            if constexpr (SCALED) {
              s0 = vs[r];
              s1 = vs[two ? r + 1 : r];
            }
#pragma unroll
            for (int i = 0; i < NC; ++i) {
              const int c = lane + 32 * i;
              if (c < d) {
                float a0 = to_f32(v0[c]), a1 = to_f32(v1[c]);
                if constexpr (SCALED) {
                  a0 *= s0;
                  a1 *= s1;
                }
                pa[i] = fmaf(p0, a0, pa[i]);
                odd[i] = fmaf(p1, a1, odd[i]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = lane + 32 * i;
          if (c < d) st[2 + c] = pa[i] + odd[i];
        }
        if (lane == 0) {
          st[0] = mx;
          st[1] = sum;
        }
        __syncwarp();  // the score row is consumed and the partial staged
      }
    }
    // publish the round's partials, each warp its own rows', in span order
    __syncwarp();
    if (alone) {
      for (int g = warp; g < G; g += nwarps)
        for (int k = 0; k < group; ++k) {
          const float* st = stg + ((size_t)k * G + g) * L.part;
          merge(g, st[0], st[1], [&](int, int c) { return st[2 + c]; });
        }
      continue;
    }
    // every CTA of the cluster runs (j = 0), or round j - 1's partials are
    // written and rank 0 has folded round j - 2's, whose buffer is next
    cluster_wait();
    if (rank == 0 && j > 0) fold(j - 1);
    float* mine = part0 + ((size_t)(j & 1) * C + rank) * group * G * L.part;  // in rank 0's
    for (int g = warp; g < G; g += nwarps)
      for (int k = 0; k < group; ++k) {
        const float* st = stg + ((size_t)k * G + g) * L.part;
        float* pr = mine + ((size_t)k * G + g) * L.part;
        for (int e = lane; e < d + 2; e += 32) pr[e] = st[e];
      }
    cluster_arrive();
  }
  if (nrounds > 0 && !alone) {
    cluster_wait();  // the last round's partials are in rank 0's shared memory
    if (rank == 0) fold(nrounds - 1);
  }
  if (rank != 0) return;
  __syncthreads();  // the running rows (zero for a free slot) are visible
  for (int g = warp; g < G; g += nwarps) {
    const float* rg = run + (size_t)g * L.part;
    const float den = fmaxf(rg[1], 1e-30f);
    for (int c = lane; c < d; c += 32)
      from_f32(out + qoff + (int64_t)g * d + c, rg[2 + c] / den);  // the single store
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

static int page_bytes(int dp) { return dp == kF32 ? 4 : dp == kBF16 ? 2 : 1; }

// The dynamic shared memory a block can use; a launch past it is refused.
extern "C" size_t mx_flash_max_smem_bytes() { return kMaxSmem; }

// The largest group (query rows per kv head) and head dim the kernel takes.
extern "C" size_t mx_flash_verify_max_group() { return kMaxWarps * kMaxRows; }
extern "C" size_t mx_flash_verify_max_dim() { return 32 * kMaxCols; }

// Dynamic shared memory of one CTA for G query rows of d, pages of ps rows
// of dtype code dp (with scale pages when `scaled`), spans of span_pages
// pages, a ring of `ring` span slots, a cluster of `cluster` CTAs and a
// table of W pages, as flash_split_kernel lays it out
// (kernels/_build.decode_split_smem mirrors it).
extern "C" size_t mx_flash_split_smem_bytes(int G, int d, int ps, int dp, int scaled,
                                            int span_pages, int group, int ring, int cluster,
                                            int W) {
  return split_layout(G, d, ps, page_bytes(dp), scaled, span_pages, group, ring, cluster, W)
      .bytes;
}

// One launch of flash_split_kernel<TQ, TP, NC, SCALED>: grid (cluster,
// pairs), clusters of (cluster, 1, 1); the opt-in to the full dynamic shared
// memory is set once per instantiation.
template <typename TQ, typename TP, int NC, bool SCALED>
static int split_launch(int cluster, int pairs, int warps, size_t smem, void* stream,
                        const void* q, const void* kp, const void* vp, const void* ksc,
                        const void* vsc, const void* table, const void* lengths, void* out,
                        int S, int H, int Hkv, int G, int d, int ps, int W, float scale,
                        int span_pages, int group, int ring, int vw) {
  auto kern = flash_split_kernel<TQ, TP, NC, SCALED>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, pairs);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), S, H, Hkv, G, d, ps, W, scale,
      span_pages, group, ring, vw));
}

// q (B, S, H, d) of dtype dq (decode: S = 1); k_pages / v_pages (P, ps,
// Hkv, d) of dtype dp; k_scale / v_scale (P, ps, Hkv) f32 or null (required
// for int8 / fp8 pages); page_table (B, W) int32; lengths (B,) int32 (they
// count the window); out like q.  span_pages, ring and cluster come from
// kernels/_build.decode_split; a split the kernel cannot take (a group past
// 32 rows, d past 256, a cluster past 8, a ring past 4 slots, shared memory
// past 227 KB) is refused with cudaErrorInvalidValue.  Grid (cluster,
// B * Hkv * S), min(G, 16) warps; the kernel is instantiated per pair of
// dtypes, columns per lane (d <= 64, 128, 256) and scales.
extern "C" int mx_flash_paged_launch(const void* q, const void* kp, const void* vp,
                                     const void* ksc, const void* vsc, const void* table,
                                     const void* lengths, void* out, int B, int S, int H,
                                     int Hkv, int d, int ps, int W, int dq, int dp,
                                     float scale, int span_pages, int group, int ring,
                                     int cluster, void* stream) {
  const int G = H / Hkv;
  if ((dp == kI8 || dp == kF8) && (ksc == nullptr || vsc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (G < 1 || G > kMaxWarps * kMaxRows || d < 1 || d > 32 * kMaxCols || S < 1 || ps < 1 ||
      W < 1 || span_pages < 1 || group < 1 || ring < 1 || ring > kMaxRing || cluster < 1 ||
      cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = page_bytes(dp);
  const bool scaled = ksc != nullptr;
  const size_t smem =
      split_layout(G, d, ps, elt, scaled, span_pages, group, ring, cluster, W).bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int vw = copy_width(d * elt, {kp, vp});
  const int warps = std::min(G, kMaxWarps);
  return with_types(dq, dp, [&](auto tq, auto tp) -> int {
    using TQ = decltype(tq);
    using TP = decltype(tp);
    auto pick = [&](auto nc, auto sc) -> int {
      return split_launch<TQ, TP, decltype(nc)::value, decltype(sc)::value>(
          cluster, B * Hkv * S, warps, smem, stream, q, kp, vp, ksc, vsc, table, lengths, out,
          S, H, Hkv, G, d, ps, W, scale, span_pages, group, ring, vw);
    };
    auto by_scale = [&](auto nc) -> int {
      if constexpr (sizeof(TP) == 1) {  // int8 / fp8 pages always carry scales
        return pick(nc, std::true_type{});
      } else {
        return scaled ? pick(nc, std::true_type{}) : pick(nc, std::false_type{});
      }
    };
    if (d <= 64) return by_scale(std::integral_constant<int, 2>{});
    if (d <= 128) return by_scale(std::integral_constant<int, 4>{});
    return by_scale(std::integral_constant<int, kMaxCols>{});
  });
}
