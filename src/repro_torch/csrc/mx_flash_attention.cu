// Flash attention for Hopper (sm_90a) on the tensor cores, MX pattern on the
// KV axis.
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
// What bounds it on the H100: operations.  A head does 4 Lq Lk d of them
// (halved by the causal mask) on 4 (Lq + 2 Lk) d bytes, about 40 per byte
// at L = 512, d = 80: zamba2's shared block (B = 8, H = 32, L = 512) is
// 10.74 GFLOP, 0.160 ms at the CUDA cores' 67 TFLOP/s in f32, 0.065 ms as
// three TF32 products at 495, and its bf16 bytes take 0.025 ms at 3.35
// TB/s.  The kernel it replaces ran both products as FMAs on the CUDA
// cores (16 x 16 threads over padded shared-memory rows), staged K and V
// element by element behind a barrier with no copy in flight, and passed
// the probability tile through shared memory: three barriers per KV tile;
// in bf16 it widened everything to f32 and never reached the tensor cores.
// This kernel instead:
//   * runs both products as mma.sync on the tensor cores (csrc/mma.cuh):
//     bf16 as m16n8k16 into f32 accumulators (the products of bf16 values
//     are exact in f32, so S is JAX's f32 score up to summation order);
//     f32 as 3xTF32 (each operand split into a TF32 high part and its TF32
//     remainder, lo*hi + hi*lo + hi*hi), about f32's accuracy, the route the
//     prefill tile proved (csrc/prefill_tile.cuh); each k8 step's three
//     products are summed from zero and added to S or the output tile with
//     rounding FADDs (mma_3xtf32): the MMAs' own accumulation truncates;
//   * CTA: NW warps own 16 query rows each (64 or 128 rows); Q is copied
//     once (bf16: loaded once into A fragments, f32: split per KV tile from
//     shared memory); K and V tiles of 64 rows come through a ring of
//     `stages` slots of 16-byte cp.async copies, so the next tile's copy
//     runs under this tile's products, with ONE block barrier per KV tile;
//   * keeps the online softmax in registers: each lane holds rows g and
//     g + 8 of its warp's 16 (g = lane / 4) in the accumulator layout; the
//     row max goes through two quad shuffles, the row sum stays per lane
//     and is reduced once at the end (the rescale alpha is the row's);
//     the S accumulators become the A fragments of the PV product in place
//     (no probability tile in shared memory).  For TF32's m16n8k8 the lane
//     holding score columns 2c and 2c + 1 feeds them as the product's k
//     indices c and c + 4, and reads V rows 2c and 2c + 1 for them: the sum
//     over k is the same sum;
//   * keeps the probabilities in f32 precision for the PV product, as JAX
//     does (its kernel widens v to f32, so `p.astype(v.dtype)` leaves p in
//     f32): f32 as 3xTF32; bf16 splits p into hi = bf16(p) and lo =
//     bf16(p - hi) and runs two m16n8k16 products against V, which is exact
//     in bf16, so p enters with about 16 significant bits -- a relative
//     error near 2^-17 per probability, far below the one bf16 rounding of
//     the output (2^-9), which is where the output's error sits;
//   * runs the softmax on the unscaled scores, p = 2^(s c - m c) with c =
//     scale * log2(e): one FFMA and one SFU exp2 per score (ex2.approx, a
//     relative error below 2^-22), and rescales the accumulators only when
//     a row max of the warp moved;
//   * masks only on the tile that needs it (the causal diagonal, the ragged
//     last tile): a masked score is -inf before the running max, a row
//     masked throughout keeps m = -inf and gives exactly 0; under the causal
//     mask KV tiles wholly above the diagonal of the tile's last live row
//     are not read (they would leave m unchanged, scale by exactly 1 and
//     add p = 0), a warp whose 16 rows all lie above a tile skips it, and
//     in bf16, on the diagonal, a warp skips the key n8 tiles above its
//     last row;
//   * launches the heaviest q tiles (the last, under the causal mask) first;
//   * pads d with zeros in shared memory up to DP = ceil(d / 16) * 16 (the
//     MMAs' K step and the output's pairs of n8 tiles), and stores each
//     output row once, acc / max(l, 1e-30).
// Rows are padded in shared memory (f32 by 16 bytes, bf16 by 16) so a
// warp's fragment reads and ldmatrix rows fall on 32 different banks.  Two
// macros, never set by the package's build, cut parts of the loop for
// timing only (tools/attention_variants.py; wrong results):
// FLASH_TIMING_NO_PRODUCTS (the ring and the softmax without the MMAs) and
// FLASH_TIMING_NO_COPIES (no copies once the ring is primed).
#include <type_traits>

#include "mma.cuh"

REPRO_EXPORT_ERROR_STRING

constexpr int kBK = 64;     // key rows per KV tile
constexpr int kMaxD = 128;  // DP <= 128: 16 n8 tiles of output per lane
constexpr int kMaxStages = 3;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block can use (227 KB)

template <typename T, int DP, int NW>
struct Flash {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBQ = 16 * NW;  // query rows per CTA
  static constexpr int kThreads = 32 * NW;
  // bytes per staged row: d padded to DP, plus 16 bytes against bank conflicts
  static constexpr int kStride = kF32 ? (DP + 4) * 4 : (DP + 8) * 2;
  static constexpr int kQBytes = kBQ * kStride;
  static constexpr int kTileBytes = kBK * kStride;  // one K or V tile
  static constexpr int kNT = DP / 8;                // n8 tiles of the output
  static constexpr int kST = kBK / 8;               // n8 tiles of the scores
  // bf16 up to d = 80 fits 128 registers a thread: 4 CTAs of 4 warps (or 2
  // of 8) on an SM, where the 130 the compiler would take leave 3 (or 1)
  static constexpr int kMinBlocks = !kF32 && DP <= 80 ? 16 / NW : 1;
  static_assert(DP % 16 == 0 && DP <= kMaxD && kStride % 16 == 0, "a tile of this kernel");
};

// Dynamic shared memory of one CTA: Q's BQ = 16 * warps rows and `stages`
// (K, V) tiles of 64 rows, each row d padded to a multiple of 16 plus 16
// bytes.
static size_t flash_smem(int d, int dt, int warps, int stages) {
  const int dp = (d + 15) / 16 * 16;
  const size_t stride = dt == kF32 ? (dp + 4) * 4 : (dp + 8) * 2;
  return stride * (16 * (size_t)warps + 2 * (size_t)stages * kBK);
}

// 2^x by the SFU (ex2.approx.ftz: relative error below 2^-22, a result
// below 2^-126 flushed to 0, 2^-inf = 0)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x as its bf16 rounding hi and the bf16 rounding of the rest, for a pair
// of neighbouring values packed as an m16n8k16 A register (low half first)
__device__ __forceinline__ void split_bf16x2(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// grid (B * H, ceil(Lq / BQ)); q (B, Lq, H, d), k and v (B, Lk, Hkv, d)
template <typename T, int DP, int NW>
__global__ void __launch_bounds__(32 * NW, (Flash<T, DP, NW>::kMinBlocks))
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Lq, int Lk, int H,
                       int Hkv, int d, float scale, int causal, int stages, int vw) {
  using F = Flash<T, DP, NW>;
  constexpr int E = sizeof(T), SW = F::kStride / 4, NT = F::kNT, ST = F::kST;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;                 // (BQ, DP) query rows
  unsigned char* ring = smem + F::kQBytes;  // slot s: K tile, then V tile

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F::kBQ;  // the heaviest q tiles first
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, c = lane & 3;
  const int r0 = q0 + 16 * warp;  // the warp's first query row
  const float c2 = scale * 1.4426950408889634f;  // scale * log2(e)
  const int rb = d * E;           // bytes of one row
  const int64_t qrow = (int64_t)H * rb, krow = (int64_t)Hkv * rb;
  const unsigned char* qb =
      reinterpret_cast<const unsigned char*>(q) + ((int64_t)b * Lq + q0) * qrow + (int64_t)h * rb;
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k) + (int64_t)b * Lk * krow + (int64_t)hk * rb;
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v) + (int64_t)b * Lk * krow + (int64_t)hk * rb;

  int nk = (Lk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (min(q0 + F::kBQ, Lq) - 1) / kBK + 1);  // past the diagonal: nothing

  if (DP > d) {  // the padding columns d .. DP stay zero; the copies never write them
    const int rows = F::kBQ + 2 * stages * kBK, pad = DP - d;
    for (int e = threadIdx.x; e < rows * pad; e += F::kThreads) {
      const int r = e / pad, col = d + e % pad;
      unsigned char* p = smem + r * F::kStride + col * E;
      if constexpr (F::kF32) *reinterpret_cast<float*>(p) = 0.0f;
      else *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16(0.0f);
    }
  }
  auto fetch = [&](int j) {  // KV tile j into slot j % stages
    unsigned char* ks = ring + (j % stages) * 2 * F::kTileBytes;
    const int k0 = j * kBK;
    copy_rows_v(vw, ks, F::kStride, kb + k0 * krow, krow, rb, kBK, Lk - k0, threadIdx.x,
                F::kThreads);
    copy_rows_v(vw, ks + F::kTileBytes, F::kStride, vb + k0 * krow, krow, rb, kBK, Lk - k0,
                threadIdx.x, F::kThreads);
  };
  copy_rows_v(vw, qs, F::kStride, qb, qrow, rb, F::kBQ, Lq - q0, threadIdx.x, F::kThreads);
  for (int j = 0; j < stages - 1; ++j) {  // Q rides in the first group
    if (j < nk) fetch(j);
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // rows g, g + 8
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  unsigned qf[F::kF32 ? 1 : DP / 16][4];  // bf16: Q's A fragments, loaded once

  for (int j = 0; j < nk; ++j) {
    cp_async_wait(stages - 2);  // tile j (and Q) landed for this thread
    __syncthreads();            // ... for all; slot (j - 1) % stages is consumed
#ifndef FLASH_TIMING_NO_COPIES
    if (j + stages - 1 < nk) fetch(j + stages - 1);
#endif
    cp_async_commit();
    if constexpr (!F::kF32) {
      if (j == 0) {
#pragma unroll
        for (int t = 0; t < DP / 16; ++t)
          ldsm_x4(qf[t], qs + (16 * warp + (lane & 15)) * F::kStride + (16 * t + (lane >> 4) * 8) * 2);
      }
    }
    const int k0 = j * kBK;
    if (r0 >= Lq || (causal && k0 > r0 + 15)) continue;  // no live row of the warp sees the tile
    const unsigned char* Ks = ring + (j % stages) * 2 * F::kTileBytes;
    const unsigned char* Vs = Ks + F::kTileBytes;
    // key n8 tiles with a column some row of the warp sees: on the causal
    // diagonal and the ragged last tile the rest are skipped (p = 0 there)
    int nlive = min(ST, (Lk - k0 + 7) / 8);
    if (causal) nlive = min(nlive, (r0 + 15 - k0) / 8 + 1);

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float s[ST][4];
#pragma unroll
    for (int jt = 0; jt < ST; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jt][e] = 0.0f;
#ifndef FLASH_TIMING_NO_PRODUCTS
    // PART: on a partial tile, stop at the warp's last live key n8 tile; a
    // full tile runs the loops without that branch (one basic block, so the
    // loads and splits of every n8 tile interleave).  bf16 only: f32's
    // 3xTF32 loops are long enough that a second copy of them costs more
    // than the skipped products save (its masked scores still give p = 0)
    auto qk = [&](auto part) {
      constexpr bool PART = decltype(part)::value;
      if constexpr (F::kF32) {
        const float* Q = reinterpret_cast<const float*>(qs) + (16 * warp + g) * SW + c;
        const float* K = reinterpret_cast<const float*>(Ks) + g * SW + c;
#pragma unroll 2
        for (int kk = 0; kk < DP; kk += 8) {
          unsigned ah[4], al[4];
          split_tf32(Q[kk], ah[0], al[0]);
          split_tf32(Q[8 * SW + kk], ah[1], al[1]);
          split_tf32(Q[kk + 4], ah[2], al[2]);
          split_tf32(Q[8 * SW + kk + 4], ah[3], al[3]);
#pragma unroll
          for (int jt = 0; jt < ST; ++jt) {
            if (PART && jt >= nlive) break;
            unsigned bh[2], bl[2];
            split_tf32(K[8 * jt * SW + kk], bh[0], bl[0]);
            split_tf32(K[8 * jt * SW + kk + 4], bh[1], bl[1]);
            mma_3xtf32(s[jt], ah, al, bh, bl);
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < DP / 16; ++t)
#pragma unroll
          for (int jp = 0; jp < ST / 2; ++jp) {  // key n8 tiles 2 jp and 2 jp + 1
            if (PART && 2 * jp >= nlive) break;
            unsigned r[4];
            ldsm_x4(r, Ks + (16 * jp + (lane & 7) + (lane >> 4) * 8) * F::kStride +
                           (16 * t + ((lane >> 3) & 1) * 8) * 2);
            const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            mma_bf16(s[2 * jp], qf[t], b0);
            mma_bf16(s[2 * jp + 1], qf[t], b1);
          }
      }
    };
    if (F::kF32 || nlive == ST) qk(std::false_type{});
    else if constexpr (!F::kF32) qk(std::true_type{});
#endif

    // mask (only where the tile needs it), then the online softmax on the
    // unscaled scores: m is their running max, p = 2^(s c - m c) with c =
    // scale * log2(e) = exp((s - m) * scale), one FFMA and one exp2 each
    if (k0 + kBK > Lk || (causal && k0 + kBK - 1 > r0)) {
#pragma unroll
      for (int jt = 0; jt < ST; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * jt + 2 * c + (e & 1), qpos = r0 + g + 8 * (e >> 1);
          const bool keep = kpos < Lk && (!causal || qpos >= kpos);
          if (!keep) s[jt][e] = -INFINITY;  // masked before the max
        }
    }
    float mx[2] = {-INFINITY, -INFINITY}, ms[2], alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int jt = 0; jt < ST; ++jt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[jt][0], s[jt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[jt][2], s[jt][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      ms[i] = isfinite(m_new) ? m_new * c2 : 0.0f;
      alpha[i] = m_new == m[i] ? 1.0f : isfinite(m[i]) ? exp2_sfu(fmaf(m[i], c2, -ms[i])) : 0.0f;
      m[i] = m_new;
    }
#pragma unroll
    for (int jt = 0; jt < ST; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[jt][e] = exp2_sfu(fmaf(s[jt][e], c2, -ms[e >> 1]));  // masked: 2^-inf = 0
        sum[e >> 1] += s[jt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];  // this lane's columns
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {  // a row max moved
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] *= alpha[0];
        acc[nt][1] *= alpha[0];
        acc[nt][2] *= alpha[1];
        acc[nt][3] *= alpha[1];
      }
    }

    // acc += P V, p in f32 precision
#ifndef FLASH_TIMING_NO_PRODUCTS
    auto pv = [&](auto part) {
      constexpr bool PART = decltype(part)::value;
      if constexpr (F::kF32) {
        const float* V = reinterpret_cast<const float*>(Vs) + 2 * c * SW + g;
#pragma unroll
        for (int t = 0; t < ST; ++t) {  // keys 8t .. 8t + 7: k index c <- 2c, c + 4 <- 2c + 1
          if (PART && t >= nlive) break;
          unsigned ah[4], al[4];
          split_tf32(s[t][0], ah[0], al[0]);
          split_tf32(s[t][2], ah[1], al[1]);
          split_tf32(s[t][1], ah[2], al[2]);
          split_tf32(s[t][3], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            unsigned bh[2], bl[2];
            split_tf32(V[8 * t * SW + 8 * nt], bh[0], bl[0]);
            split_tf32(V[(8 * t + 1) * SW + 8 * nt], bh[1], bl[1]);
            mma_3xtf32(acc[nt], ah, al, bh, bl);
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < ST / 2; ++t) {  // keys 16t .. 16t + 15
          if (PART && 2 * t >= nlive) break;
          unsigned ahi[4], alo[4];
          split_bf16x2(s[2 * t][0], s[2 * t][1], ahi[0], alo[0]);
          split_bf16x2(s[2 * t][2], s[2 * t][3], ahi[1], alo[1]);
          split_bf16x2(s[2 * t + 1][0], s[2 * t + 1][1], ahi[2], alo[2]);
          split_bf16x2(s[2 * t + 1][2], s[2 * t + 1][3], ahi[3], alo[3]);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            unsigned r[4];
            ldsm_x4_t(r, Vs + (16 * t + (lane & 7) + ((lane >> 3) & 1) * 8) * F::kStride +
                             (16 * np + (lane >> 4) * 8) * 2);
            const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            mma_bf16(acc[2 * np], alo, b0);
            mma_bf16(acc[2 * np], ahi, b0);
            mma_bf16(acc[2 * np + 1], alo, b1);
            mma_bf16(acc[2 * np + 1], ahi, b1);
          }
        }
      }
    };
    if (F::kF32 || nlive == ST) pv(std::false_type{});
    else if constexpr (!F::kF32) pv(std::true_type{});
#endif
  }
  cp_async_wait(0);  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the row's sum over its quad
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // d even and out aligned: every output row starts on a pair
  const bool pairs = d % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * E) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= Lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (((int64_t)b * Lq + row) * H + h) * d;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * c;  // the single store, a pair at a time when it can
      const float y0 = acc[nt][2 * i] / den, y1 = acc[nt][2 * i + 1] / den;
      if (pairs && col + 1 < d) {
        if constexpr (F::kF32) *reinterpret_cast<float2*>(o + col) = make_float2(y0, y1);
        else *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(y0, y1);
      } else {
        if (col < d) from_f32(o + col, y0);
        if (col + 1 < d) from_f32(o + col + 1, y1);
      }
    }
  }
}

template <typename T, int DP, int NW>
static int flash_launch(const void* q, const void* k, const void* v, void* out, int B, int Lq,
                        int Lk, int H, int Hkv, int d, int causal, float scale, int stages,
                        int vw, cudaStream_t s) {
  auto kern = flash_attention_kernel<T, DP, NW>;
  const size_t smem = flash_smem(d, std::is_same<T, float>::value ? kF32 : kBF16, NW, stages);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H, (Lq + 16 * NW - 1) / (16 * NW));
  kern<<<grid, 32 * NW, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(out), Lq, Lk, H,
                                   Hkv, d, scale, causal, stages, vw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NW>
static int flash_dispatch(int dp, const void* q, const void* k, const void* v, void* out,
                          int B, int Lq, int Lk, int H, int Hkv, int d, int causal, float scale,
                          int stages, int vw, cudaStream_t s) {
#define REPRO_FLASH_CASE(DP) \
  case DP: return flash_launch<T, DP, NW>(q, k, v, out, B, Lq, Lk, H, Hkv, d, causal, scale, stages, vw, s);
  switch (dp) {
    REPRO_FLASH_CASE(16) REPRO_FLASH_CASE(32) REPRO_FLASH_CASE(48) REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80) REPRO_FLASH_CASE(96) REPRO_FLASH_CASE(112) REPRO_FLASH_CASE(128)
  }
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}


// q (B, Lq, H, d), k and v (B, Lk, Hkv, d), out (B, Lq, H, d), all of dtype
// dt (f32 or bf16) and contiguous; `warps` (4 or 8) warps of 16 query rows
// per CTA, a ring of `stages` (2 or 3) KV tiles.  Refused with
// cudaErrorInvalidValue: d past 128, H not a multiple of Hkv, no keys, a
// tile past the shared memory a block can use.
extern "C" int mx_flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                         int B, int Lq, int Lk, int H, int Hkv, int d,
                                         int causal, int dt, float scale, int warps, int stages,
                                         void* stream) {
  if (d < 1 || d > kMaxD || (warps != 4 && warps != 8) || stages < 2 || stages > kMaxStages ||
      (dt != kF32 && dt != kBF16) || flash_smem(d, dt, warps, stages) > kMaxSmem || Hkv < 1 ||
      H % Hkv != 0 || Lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vw = copy_width(d * (dt == kF32 ? 4 : 2), {q, k, v});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (d + 15) / 16 * 16;
  if (dt == kF32)
    return warps == 4 ? flash_dispatch<float, 4>(dp, q, k, v, out, B, Lq, Lk, H, Hkv, d, causal,
                                                 scale, stages, vw, s)
                      : flash_dispatch<float, 8>(dp, q, k, v, out, B, Lq, Lk, H, Hkv, d, causal,
                                                 scale, stages, vw, s);
  return warps == 4 ? flash_dispatch<__nv_bfloat16, 4>(dp, q, k, v, out, B, Lq, Lk, H, Hkv, d,
                                                       causal, scale, stages, vw, s)
                    : flash_dispatch<__nv_bfloat16, 8>(dp, q, k, v, out, B, Lq, Lk, H, Hkv, d,
                                                       causal, scale, stages, vw, s);
}
