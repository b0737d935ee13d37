// Chunked Mamba-2 SSD scan for Hopper (sm_90a), its products on the tensor
// cores.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel): h_t = exp(a_log_t) h_{t-1} + b_t^T x_t, y_t = c_t h_t, for
// every (sequence, head) of the batched layout models/ssm.py::ssd_chunked
// uses -- x (B, L, H, P), a_log (B, L, H) f32, b and c (B, L, G, S) read per
// group (head h reads group h / (H / G), so the repeat to H heads is never
// built), y (B, L, H, P) -- in ONE launch.
//
// One CTA of 8 warps per (sequence, head) walks the chunks of Q rows in
// order (the TPU grid's sequential "arbitrary" axis becomes a loop inside
// the block).  Per chunk, in f32:
//   acum = cumsum(a_log)                         (inclusive, one warp)
//   M    = (C B^T) * exp(acum_t - acum_s), s <= t (0 above the diagonal)
//   y    = exp(acum) * (C h) + M X
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
// The four products run as mma.sync m16n8k8 TF32 products into f32
// (csrc/mma.cuh).  An f32 operand is split into a TF32 high part (its top
// 19 bits) and the remainder, and a product takes three MMAs (lo*hi +
// hi*lo + hi*hi, 3xTF32, within about 2^-19 of f32: the route of
// csrc/prefill_tile.cuh and csrc/mx_flash_attention.cu, with the split by
// a mask and a subtraction in place of two conversions).  A bf16 value is exact in TF32, so a bf16
// input (x, b, c) needs no remainder: C B^T takes one MMA, and the three
// products with an f32 operand (the masked decay product, the state, b
// scaled by the decay) take two -- every value after the widening stays
// f32, as in JAX's _ssd_kernel, where bf16 MMAs would round M, h and the
// scaled b to bf16 (or need the same split, two bf16 MMAs, at half the
// K depth's instructions saved).  Warps own 16 rows of t; warp w takes row
// block w (w < 4) or 11 - w, so the two warps of each scheduler partition
// carry equal shares of the triangles.  A warp first computes C h for its
// rows, then walks the 16-column blocks of s up to its diagonal (the blocks
// above it are zero after the mask): each block's C B^T tile, its decay in
// registers, and at once its share of M X, the tile fed as the A operand
// straight from its accumulators (the lane holding columns 2c and 2c + 1
// of an n8 tile feeds them as k indices c and c + 4 and reads X rows 2c and
// 2c + 1 for them: the same sum), so the (Q, Q) product never touches
// shared memory.  The C B^T tile runs in eight accumulator chains (by the
// parity of the k step, the hi*hi products apart from the cross terms),
// summed in a fixed order.  P's n8 tiles are a compile-time count (P
// padded with zero columns to 8, 16, 32, 64 or 128), so every loop over
// them is one basic block whose loads and products interleave.  The
// state update is split over the warps by (16 rows of S) x (32 columns of
// P).  The next chunk's x, b, c and a_log come in as 16-byte cp.async
// copies (narrower where a row or a base needs it) under this chunk's
// products whenever two chunks fit in shared memory.  Rows are padded so
// every fragment read of a warp falls on 32 different banks (x, b, c rows
// 16 bytes past a multiple of 128; h rows 8 floats past a multiple of 32);
// Q, P and S are padded with zeros to the MMAs' shapes in shared memory.
//
// What bounds it on the H100: operations.  The function needs, per chunk
// of q rows and head, q (q + 1) (S + P) operations for the lower triangles
// of C B^T and of M X and 4 q S P for C h and the state update, against
// q (2P + 2S + 1) * 4 bytes: at q = 128, P = S = 64 that is 4.2 MFLOP for
// 132 KB, about 32 FLOP per byte.  On the tensor cores (three TF32 products
// at 495 TFLOP/s) zamba2's 8 x 80 heads at L = 512 need 0.065 ms, its bytes
// 0.050 ms.  The kernel it replaces ran all four products as FFMAs on the
// CUDA cores, both Q x Q squares whole, with the (Q, Q) product in shared
// memory and each chunk's loads behind a barrier.
#include <type_traits>

#include "mma.cuh"

REPRO_EXPORT_ERROR_STRING

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDim = 128;         // Q, P and S are at most 128
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block can use

// P's n8 tiles as the kernel instantiates them: ceil(P / 8) rounded up to a
// power of two (1 to 16).
__host__ __device__ inline int ssd_p_tiles(int P) {
  int n = 1;
  while (n * 8 < P) n *= 2;
  return n;
}

// Bytes between staged x / b / c rows: `cols` columns rounded up to 16
// bytes past a multiple of 128.
__host__ __device__ inline int ssd_row_bytes(int cols, int elt) {
  return (cols * elt + 111) / 128 * 128 + 16;
}

struct SsdLayout {
  int q16, xrow, brow, hrow;
  size_t stage, bytes;
};

// A chunk slot per stage (x rows of P padded to its n8 tiles, b and c rows
// of S padded to 8, a_log), then the state h (S padded to 16 rows of P's
// tiles, 8 floats past a multiple of 32 apart) and acum, exp(acum) and
// exp(acum_Q - acum).  kernels/_build.ssd_smem mirrors it.
__host__ __device__ inline SsdLayout ssd_layout(int Q, int P, int S, int elt, int stages) {
  SsdLayout L;
  const int pc = 8 * ssd_p_tiles(P);
  L.q16 = (Q + 15) / 16 * 16;
  L.xrow = ssd_row_bytes(pc, elt);
  L.brow = ssd_row_bytes((S + 7) / 8 * 8, elt);
  L.hrow = (pc + 23) / 32 * 32 + 8;
  L.stage = (size_t)L.q16 * (L.xrow + 2 * L.brow) + (size_t)L.q16 * 4;
  L.bytes = stages * L.stage + (size_t)(S + 15) / 16 * 16 * L.hrow * 4 + 3 * (size_t)L.q16 * 4;
  return L;
}

template <typename T>
__device__ __forceinline__ float ld_elem(const unsigned char* row, int col) {
  return to_f32(reinterpret_cast<const T*>(row)[col]);
}

// An operand value as its TF32 high part (the top 19 bits) and the
// remainder (exact in f32; the MMA reads its top 19 bits); a bf16 input is
// exact in TF32 and has none (EXACT).
template <bool EXACT>
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & (EXACT ? 0xffffffffu : 0xffffe000u);
  lo = EXACT ? 0u : __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b over the parts that exist: 3xTF32 when both operands carry a
// remainder, two MMAs when one is exact, one when both are.
template <bool AEXACT, bool BEXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  if constexpr (!AEXACT) mma_tf32(d, al, bh);
  if constexpr (!BEXACT) mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// grid (B * H); x (B, L, H, P), a_log (B, L, H), b / c (B, L, G, S), y like
// x; NPT = ssd_p_tiles(P)
template <typename T, int NPT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ alog,
                const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y, int L,
                int H, int G, int P, int S, int Q, int stages, int vx, int vb) {
  constexpr bool kBF = !std::is_same<T, float>::value;  // inputs exact in TF32
  constexpr int E = sizeof(T);
  constexpr int UN = NPT < 4 ? NPT : 4;  // n8 tiles per unit of the state update
  extern __shared__ __align__(16) unsigned char smem[];
  const SsdLayout Lo = ssd_layout(Q, P, S, E, stages);
  const int Q16 = Lo.q16, XR = Lo.xrow, BR = Lo.brow, HR = Lo.hrow;
  float* hs = reinterpret_cast<float*>(smem + stages * Lo.stage);  // (S16, HR) the state
  const int S16 = (S + 15) / 16 * 16;
  float* acum = hs + S16 * HR;  // (Q16,) inclusive cumsum of a_log
  float* ea = acum + Q16;       // exp(acum)
  float* wq = ea + Q16;         // exp(acum_Q - acum)
  const int NS = (S + 7) / 8, NQ = Q16 / 8;  // k8 steps over S and over Q

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int gi = h / (H / G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, c = lane & 3;
  const int64_t xrow = (int64_t)H * P;  // x / y elements between time steps
  const int64_t brow = (int64_t)G * S;  // b / c elements between time steps
  const unsigned char* xb =
      reinterpret_cast<const unsigned char*>(x + (int64_t)b * L * xrow + (int64_t)h * P);
  T* yb = y + (int64_t)b * L * xrow + (int64_t)h * P;
  const unsigned char* bb =
      reinterpret_cast<const unsigned char*>(bm + (int64_t)b * L * brow + (int64_t)gi * S);
  const unsigned char* cb =
      reinterpret_cast<const unsigned char*>(cm + (int64_t)b * L * brow + (int64_t)gi * S);
  const float* ab = alog + (int64_t)b * L * H + h;

  // zero the padding columns of every slot (the copies never write them) and
  // the state (the chunk-0 reset)
  const int xpad = 8 * NPT - P, bpad = NS * 8 - S;
  for (int st = 0; st < stages; ++st) {
    unsigned char* slot = smem + st * Lo.stage;
    for (int e = threadIdx.x; e < Q16 * xpad; e += kThreads)
      from_f32(reinterpret_cast<T*>(slot + (e / xpad) * XR + (P + e % xpad) * E), 0.0f);
    for (int e = threadIdx.x; e < 2 * Q16 * bpad; e += kThreads) {
      const int r = e / bpad;  // rows of b, then rows of c
      from_f32(reinterpret_cast<T*>(slot + Q16 * XR + r * BR + (S + e % bpad) * E), 0.0f);
    }
  }
  for (int e = threadIdx.x; e < S16 * HR; e += kThreads) hs[e] = 0.0f;

  const int nchunks = (L + Q - 1) / Q;
  auto fetch = [&](int ch) {  // chunk ch into slot ch % stages; rows past L zero
    unsigned char* slot = smem + (ch % stages) * Lo.stage;
    const int t0 = ch * Q, live = min(Q, L - t0);
    copy_rows_v(vx, slot, XR, xb + t0 * xrow * E, xrow * E, P * E, Q16, live, threadIdx.x,
                kThreads);
    copy_rows_v(vb, slot + Q16 * XR, BR, bb + t0 * brow * E, brow * E, S * E, Q16, live,
                threadIdx.x, kThreads);
    copy_rows_v(vb, slot + Q16 * (XR + BR), BR, cb + t0 * brow * E, brow * E, S * E, Q16,
                live, threadIdx.x, kThreads);
    unsigned char* as = slot + Q16 * (XR + 2 * BR);
    for (int t = threadIdx.x; t < Q16; t += kThreads)
      copy_chunk<4>(as + 4 * t,
                    reinterpret_cast<const unsigned char*>(t < live ? ab + (int64_t)(t0 + t) * H
                                                                    : ab),
                    t < live);
  };

  // warp w's row block of the Q x Q triangles: w, or 11 - w past 4 (equal
  // shares per scheduler partition at 8 blocks)
  const int blk = warp < 4 ? warp : 11 - warp;
  const int t0w = 16 * blk;

  if (stages == 2) {
    fetch(0);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    if (stages == 1) {
      __syncthreads();  // the previous chunk's readers of the slot are done
      fetch(ch);
      cp_async_commit();
    }
    cp_async_wait(0);
    __syncthreads();  // chunk ch landed; the previous chunk (and its state update) is done
    if (stages == 2 && ch + 1 < nchunks) {
      fetch(ch + 1);
      cp_async_commit();
    }
    const unsigned char* slot = smem + (ch % stages) * Lo.stage;
    const unsigned char* xs = slot;
    const unsigned char* bs = slot + Q16 * XR;
    const unsigned char* cs = bs + Q16 * BR;
    const float* as = reinterpret_cast<const float*>(cs + Q16 * BR);
    const int t0 = ch * Q, live = min(Q, L - t0);

    if (warp == 0) {  // inclusive scan of a_log (0 past L), exp(acum), exp(acum_Q - acum)
      const int per = (Q16 + 31) / 32, base = lane * per;
      float run = 0.0f;
      for (int k = 0; k < per; ++k) {
        const int t = base + k;
        if (t < Q16) {
          run += as[t];
          acum[t] = run;
        }
      }
      float incl = run;  // scan of the lanes' totals
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float before = incl - run;
      const float alast = __shfl_sync(0xffffffffu, incl, 31);
      for (int k = 0; k < per; ++k) {
        const int t = base + k;
        if (t < Q16) {
          const float a = acum[t] + before;
          acum[t] = a;
          ea[t] = expf(a);
          wq[t] = expf(alast - a);
        }
      }
    }
    __syncthreads();

    if (t0w < Q16) {
      const unsigned char* c0 = cs + (t0w + g) * BR;
      const unsigned char* c8 = c0 + 8 * BR;
      auto c_frag = [&](int k, unsigned (&ah)[4], unsigned (&al)[4]) {  // C rows, k step k
        const int n0 = 8 * k;
        split<kBF>(ld_elem<T>(c0, n0 + c), ah[0], al[0]);
        split<kBF>(ld_elem<T>(c8, n0 + c), ah[1], al[1]);
        split<kBF>(ld_elem<T>(c0, n0 + c + 4), ah[2], al[2]);
        split<kBF>(ld_elem<T>(c8, n0 + c + 4), ah[3], al[3]);
      };
      // (1) y = exp(acum_t) (C h) for the warp's 16 rows
      float yacc[NPT][4];
#pragma unroll
      for (int nt = 0; nt < NPT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < NS; ++k) {
        unsigned ah[4], al[4];
        c_frag(k, ah, al);
        const float* h0 = hs + (8 * k + c) * HR + g;
#pragma unroll
        for (int nt = 0; nt < NPT; ++nt) {
          unsigned bh[2], bl[2];  // h: f32 in both routes
          split<false>(h0[8 * nt], bh[0], bl[0]);
          split<false>(h0[4 * HR + 8 * nt], bh[1], bl[1]);
          mma3<kBF, false>(yacc[nt], ah, al, bh, bl);
        }
      }
      const int r0 = t0w + g, r1 = r0 + 8;
      {
        const float e0 = ea[r0], e1 = ea[r1];
#pragma unroll
        for (int nt = 0; nt < NPT; ++nt) {
          yacc[nt][0] *= e0;
          yacc[nt][1] *= e0;
          yacc[nt][2] *= e1;
          yacc[nt][3] *= e1;
        }
      }
      // (2) per 16-column block sb of s up to the diagonal: its C B^T tile,
      // the decay masked before the exp, then y += M X over its 16 values of
      // s (k index c <- s 2c, c + 4 <- 2c + 1)
      const float a0 = acum[r0], a1 = acum[r1];
      for (int sb = 0; sb <= blk; ++sb) {
        // the tile's two n8 tiles in eight independent accumulator chains:
        // by the parity of the k step, and the hi*hi products apart from
        // the two cross terms (summed in a fixed order after the loop)
        float gacc[2][2][4], gsm[2][2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) gacc[h2][j][e] = gsm[h2][j][e] = 0.0f;
        auto g_step = [&](int k, auto par) {
          constexpr int h2 = decltype(par)::value;
          unsigned ah[4], al[4];
          c_frag(k, ah, al);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const unsigned char* brw = bs + (16 * sb + 8 * j + g) * BR;
            unsigned bh[2], bl[2];
            split<kBF>(ld_elem<T>(brw, 8 * k + c), bh[0], bl[0]);
            split<kBF>(ld_elem<T>(brw, 8 * k + c + 4), bh[1], bl[1]);
            if constexpr (!kBF) {
              mma_tf32(gsm[h2][j], al, bh);
              mma_tf32(gsm[h2][j], ah, bl);
            }
            mma_tf32(gacc[h2][j], ah, bh);
          }
        };
        int k = 0;
        for (; k + 1 < NS; k += 2) {
          g_step(k, std::integral_constant<int, 0>{});
          g_step(k + 1, std::integral_constant<int, 1>{});
        }
        if (k < NS) g_step(k, std::integral_constant<int, 0>{});
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            gacc[0][j][e] = (gacc[0][j][e] + gacc[1][j][e]) + (gsm[0][j][e] + gsm[1][j][e]);
        auto& gt = gacc[0];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int s0 = 16 * sb + 8 * j + 2 * c;
          const float as0 = acum[s0], as1 = acum[s0 + 1];
          gt[j][0] = s0 <= r0 ? gt[j][0] * expf(a0 - as0) : 0.0f;
          gt[j][1] = s0 + 1 <= r0 ? gt[j][1] * expf(a0 - as1) : 0.0f;
          gt[j][2] = s0 <= r1 ? gt[j][2] * expf(a1 - as0) : 0.0f;
          gt[j][3] = s0 + 1 <= r1 ? gt[j][3] * expf(a1 - as1) : 0.0f;
          unsigned ah[4], al[4];
          split<false>(gt[j][0], ah[0], al[0]);
          split<false>(gt[j][2], ah[1], al[1]);
          split<false>(gt[j][1], ah[2], al[2]);
          split<false>(gt[j][3], ah[3], al[3]);
          const unsigned char* x0 = xs + s0 * XR;
          const unsigned char* x1 = x0 + XR;
#pragma unroll
          for (int nt = 0; nt < NPT; ++nt) {
            unsigned bh[2], bl[2];
            split<kBF>(ld_elem<T>(x0, 8 * nt + g), bh[0], bl[0]);
            split<kBF>(ld_elem<T>(x1, 8 * nt + g), bh[1], bl[1]);
            mma3<false, kBF>(yacc[nt], ah, al, bh, bl);
          }
        }
      }
      // the live rows of y, stored once
#pragma unroll
      for (int nt = 0; nt < NPT; ++nt) {
        const int p = 8 * nt + 2 * c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? r0 : r1, pc = p + (e & 1);
          if (t < live && pc < P) from_f32(yb + (int64_t)(t0 + t) * xrow + pc, yacc[nt][e]);
        }
      }
    }
    __syncthreads();  // every read of the state h is done

    // (3) h = exp(acum_Q) h + (B w)^T X, w = exp(acum_Q - acum): units of
    // 16 rows of S x UN n8 tiles of P over the warps; k index c <- t 2c,
    // c + 4 <- 2c + 1 on both operands
    const float keep = ea[Q16 - 1];
    constexpr int ngrp = NPT / UN;
    const int units = (S16 / 16) * ngrp;
    for (int u = warp; u < units; u += kWarps) {
      const int rb = u / ngrp, nt0 = UN * (u % ngrp);
      const int n0 = 16 * rb + g, n1 = n0 + 8;
      const bool l0 = n0 < NS * 8, l1 = n1 < NS * 8;  // b's columns past S8 do not exist
      float acc[UN][4];
#pragma unroll
      for (int i = 0; i < UN; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < NQ; ++k) {
        const int ta = 8 * k + 2 * c;
        const unsigned char* b0 = bs + ta * BR;
        const unsigned char* b1 = b0 + BR;
        const float w0 = wq[ta], w1 = wq[ta + 1];
        unsigned ah[4], al[4];
        split<false>(l0 ? ld_elem<T>(b0, n0) * w0 : 0.0f, ah[0], al[0]);
        split<false>(l1 ? ld_elem<T>(b0, n1) * w0 : 0.0f, ah[1], al[1]);
        split<false>(l0 ? ld_elem<T>(b1, n0) * w1 : 0.0f, ah[2], al[2]);
        split<false>(l1 ? ld_elem<T>(b1, n1) * w1 : 0.0f, ah[3], al[3]);
        const unsigned char* x0 = xs + ta * XR;
        const unsigned char* x1 = x0 + XR;
#pragma unroll
        for (int i = 0; i < UN; ++i) {
          unsigned bh[2], bl[2];
          split<kBF>(ld_elem<T>(x0, 8 * (nt0 + i) + g), bh[0], bl[0]);
          split<kBF>(ld_elem<T>(x1, 8 * (nt0 + i) + g), bh[1], bl[1]);
          mma3<false, kBF>(acc[i], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int i = 0; i < UN; ++i) {
        const int p = 8 * (nt0 + i) + 2 * c;
        float* h0 = hs + n0 * HR + p;
        float* h1 = hs + n1 * HR + p;
        h0[0] = fmaf(keep, h0[0], acc[i][0]);
        h0[1] = fmaf(keep, h0[1], acc[i][1]);
        h1[0] = fmaf(keep, h1[0], acc[i][2]);
        h1[1] = fmaf(keep, h1[1], acc[i][3]);
      }
    }
  }
}

static int dt_bytes(int dt) { return dt == kF32 ? 4 : 2; }

// Dynamic shared memory of one CTA at `stages` chunk slots, as
// ssd_scan_kernel lays it out.
extern "C" size_t ssd_scan_smem_bytes(int Q, int P, int S, int dt, int stages) {
  return ssd_layout(Q, P, S, dt_bytes(dt), stages).bytes;
}

template <typename T, int NPT>
static int ssd_run(const void* x, const void* alog, const void* bm, const void* cm, void* y,
                   int B, int L, int H, int G, int P, int S, int Q, int stages, size_t smem,
                   int vx, int vb, cudaStream_t s) {
  auto kern = ssd_scan_kernel<T, NPT>;
  static bool opted = false;  // per instantiation
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  kern<<<B * H, kThreads, smem, s>>>(static_cast<const T*>(x), static_cast<const float*>(alog),
                                     static_cast<const T*>(bm), static_cast<const T*>(cm),
                                     static_cast<T*>(y), L, H, G, P, S, Q, stages, vx, vb);
  return static_cast<int>(cudaGetLastError());
}

// x (B, L, H, P) and y of dtype dt (f32 or bf16); a_log (B, L, H) f32; b and
// c (B, L, G, S) of dtype dt; every tensor contiguous.  Q is the chunk,
// `stages` the chunk slots (kernels/_build.ssd_tile: 2, the next chunk in
// flight, where two fit).  Refused with cudaErrorInvalidValue: Q, P or S
// past 128, stages not 1 or 2, or the slots past the shared memory a block
// can use.
extern "C" int ssd_scan_launch(const void* x, const void* alog, const void* bm, const void* cm,
                               void* y, int B, int L, int H, int G, int P, int S, int Q, int dt,
                               int stages, void* stream) {
  if (Q < 1 || Q > kMaxDim || P < 1 || P > kMaxDim || S < 1 || S > kMaxDim || G < 1 ||
      H % G != 0 || (dt != kF32 && dt != kBF16) || stages < 1 || stages > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = dt_bytes(dt);
  const size_t smem = ssd_layout(Q, P, S, e, stages).bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int vx = copy_width(P * e, {x}), vb = copy_width(S * e, {bm, cm});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tag) -> int {
    using T = decltype(tag);
    auto go = [&](auto npt) {
      return ssd_run<T, decltype(npt)::value>(x, alog, bm, cm, y, B, L, H, G, P, S, Q, stages,
                                              smem, vx, vb, s);
    };
    switch (ssd_p_tiles(P)) {
      case 1: return go(std::integral_constant<int, 1>{});
      case 2: return go(std::integral_constant<int, 2>{});
      case 4: return go(std::integral_constant<int, 4>{});
      case 8: return go(std::integral_constant<int, 8>{});
      default: return go(std::integral_constant<int, 16>{});
    }
  };
  if (dt == kF32) return run(float{});
  return run(__nv_bfloat16{});
}
