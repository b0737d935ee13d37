// The prefill tile (M > 16 rows) of the dense MX GEMM (csrc/mx_matmul.cu),
// of its 2:4 and ABFT variants (csrc/mx_matmul.cuh) and of the baseline GEMM
// (csrc/baseline_matmul.cu): one tensor-core K loop for Hopper (sm_90a).
// Each replaces the M > 16 rows of its TPU kernel
// (repro/kernels/mx_matmul.py::mx_matmul_fused, baseline_matmul.py).
//
// What bounds it on the H100: a prefill GEMM does 2 * M * N * K operations
// on a weight it reads once, so at M = 64 the weight's bytes and the
// operations are of one size (f32 K = 8192, N = 2048: 64 MB, 0.020 ms at
// 3.35 TB/s; 2.1 GFLOP, 0.032 ms at the CUDA cores' 67 TFLOP/s, 0.013 ms as
// three TF32 products at 495), and from M = 256 on the operations bound it.
// The tile it replaces (gemm_tile.cuh's sweep_k) ran every MAC on the CUDA
// cores, widened each operand element by element through registers, kept one
// K step in flight and gave 64 CTAs at M = 64, N = 2048.  This loop instead:
//   * multiplies on the tensor cores with mma.sync: bf16 x bf16 as
//     m16n8k16 products into f32 accumulators (the products are exact, the
//     sums f32), and so bf16 x int8 and bf16 x e4m3, the weight copied in
//     its own width and widened to bf16 in shared memory (exactly: every
//     int8 and e4m3 value is a bf16 value), the scales applied at the store;
//     f32 x f32 as 3xTF32 -- each operand split into a TF32 high
//     part and its TF32 remainder, three m16n8k8 products per step (lo*hi,
//     hi*lo, hi*hi) into f32 accumulators, about f32's accuracy (one TF32
//     product keeps three digits and would miss the 1e-4 * max|ref| gate);
//   * fills a ring of `stages` shared-memory slots with 16-byte cp.async.cg
//     copies (commit / wait groups, one barrier per K step), each operand in
//     its own width: A as (BM x 128 bytes of K) rows, B as (BK x BN) rows in
//     the JAX layout ((K, N) row-major, no transposed copy of any weight);
//     fragments are read with ldmatrix (bf16; .trans for B) or 32-bit loads
//     (f32), the staged rows padded by 16 or 32 bytes so a warp's reads fall
//     on 32 different banks;
//   * fills the card by splitting K: the K steps are cut into `parts` equal
//     parts, a number that depends on K alone (kernels/_build.prefill_parts),
//     each part's partial sum starting from zero.  A small grid runs one CTA
//     per part in a thread-block cluster of `parts` CTAs (split == parts): the
//     partials meet in distributed shared memory and are summed in rank order
//     by the CTAs of the cluster, each finishing BM / split rows; a large
//     grid runs one CTA per tile that walks all parts and folds each finished
//     partial into a shared-memory total (split == 1).  Both sum
//     ((p0 + p1) + p2) + ... in the same order, with no atomics, so an output
//     element's bits depend on K and the operand pair only, not on the tile,
//     the split or M: the dense, 2:4 and ABFT kernels (whose CTA tiles and
//     splits differ) and a recomputed ABFT tile are bitwise equal;
//   * stores through shared memory: the finished tile is summed into Cs and
//     every element goes through gemm_tile.cuh's mx_store (the epilogue's
//     roundings unchanged), neighbouring threads on neighbouring columns;
//   * zero fills ragged and misaligned M / N / K edges in the copies
//     themselves (kernels/_build.copy_width: 16, 8, 4 bytes by cp.async, 2,
//     1 by plain loads), with no padded operand copies.
// The tile (BM, BN, stages, split, parts) and the copy widths are chosen in
// Python (kernels/_build.prefill_tile / copy_width) and checked by
// prefill_check.  Four macros, never set by the package's build, change
// the loop for timing only (tools/prefill_variants.py,
// tools/grouped_variants.py; other results): PREFILL_TIMING_NO_PRODUCTS
// (the ring without the MMAs), PREFILL_TIMING_NO_COPIES (no copies once the
// ring is primed), PREFILL_TIMING_ONE_TF32 (one TF32 product per f32
// step, not three) and PREFILL_TIMING_MMA_ACC (f32 accumulated in the MMAs,
// truncating, as before pf_3xtf32); PREFILL_TIMING_B_IN_SMEM widens a 16-row
// tile's narrow weight in the shared-memory pass (right results; the A/B
// against widening in registers).
//
// The route, per pair: mma.sync for f32 (3xTF32), bf16 and the widened
// pairs alike, and for int8 x int8 and e4m3 x e4m3 the m16n8k32 operand
// layout: both operands copied in their own byte width (128 K per
// stage), A's fragments by ldmatrix, B's -- 4 consecutive K rows of one
// column per register, which the (K, N) weight does not hold -- by four
// 32-bit reads of a 4 x 4 byte block per register quad and a byte
// transpose in registers (b_frags_8bit; the staged rows padded by 32
// bytes and each lane's four reads rotated, so a warp's reads fall on 32
// banks).  int8 x int8 runs the s8 MMA (IMMA), its exact int32 sums folded
// as int32 and widened to f32 only at mx_store.  e4m3 x e4m3: the card has
// no e4m3 mma.sync of its own (sm_90 lowers it to conversions and f16
// HMMAs: no QMMA in the SASS, tools/e4m3_mma_probe.py), so the fragments
// are widened to f16 in registers, exactly (cvt.rn.f16x2.e4m3x2), for two
// m16n8k16 f16 products per k32 step, the k32 product summed from zero and
// added to the f32 accumulator with rounding FADDs, as pf_3xtf32 does (the
// MMAs' own f32 accumulation truncates).  wgmma, the route to the tensor
// cores' full rate and to native e4m3 products, takes B from shared memory
// K-major for TF32 and 8-bit types, so the weight would need a transposing
// pass per stage; it is not built yet (ROADMAP, queue 2).  A transposing
// pass into K-major slots, read by ldmatrix, timed 1.2-2.4x slower than the
// transpose in registers (PERF.md section 6).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6;
// tools/prefill_variants.py for the variants): f32 M = 64, K = 8192,
// N = 2048 + residual 0.098 ms against addmm's 0.062, bf16 0.032 against
// 0.023; f32 at M = 2048 about 1.3x matmul, bf16 about 5x.  What bounds it
// now: in f32 the mma.sync TF32 rate (the products alone take 0.073 of
// 0.095 ms at M = 64, one TF32 product instead of three 0.068); in bf16 the
// copies (a loop of copies alone takes as long as the whole: 0.9-1.1 TB/s
// from HBM at M = 64; at M = 2048, 3.4 TB/s of L2 traffic, about 26 GB/s
// per SM, since each 64 x 128 tile re-reads its A rows and B columns).
#pragma once

#include <cooperative_groups.h>

#include "decode_tile.cuh"  // is_pow2; gemm_tile.cuh's mx_store
#include "mma.cuh"  // copy_chunk, cp_async_*, split_tf32, mma_tf32 / mma_bf16, ldsm_x4(_t)

namespace cg = cooperative_groups;

constexpr int kPrefillMaxSmem = 232448;  // 227 KB, the opt-in per-CTA maximum
constexpr int kPrefillMaxStages = 8;
constexpr int kPrefillMaxParts = 8;  // a portable cluster

// Everything the loop needs: A (M, K); B, Bg (K, N) dense, or their 2:4
// payloads (K/2, N) with uint8 metadata (K/8, N); the tile; the copy widths
// in bytes of A's, B's and the metadata's rows.
struct PrefillShape {
  const void *a, *b, *bg;
  const uint8_t *bmeta, *bgmeta;
  int M, N, K;
  int stages, split, parts, va, vb, vm;
};

// Per A type: the K rows of one 128-byte staged A row, and the
// accumulator's type (int8 x int8: exact int32 sums).
template <typename T>
struct MmaOf;
template <>
struct MmaOf<float> {  // 3xTF32, m16n8k8
  static constexpr int kBK = 32;
  using Acc = float;
};
template <>
struct MmaOf<__nv_bfloat16> {  // m16n8k16
  static constexpr int kBK = 64;
  using Acc = float;
};
template <>
struct MmaOf<int8_t> {  // m16n8k32 s8
  static constexpr int kBK = 128;
  using Acc = int;
};
template <>
struct MmaOf<__nv_fp8_e4m3> {  // m16n8k32 e4m3
  static constexpr int kBK = 128;
  using Acc = float;
};

// The layout of one (BM x BN) tile: 2 x (BN / 32) warps of (BM / 2) x 32
// outputs each (MT m16 tiles by 4 n8 tiles), or for BM = 16 (the grouped
// GEMM's decode-height tile, csrc/grouped_mma.cuh) one row of BN / 32 warps
// of 16 x 32; one ring slot holds A's BM
// rows, B's (and the gate's) BK rows in A's type T and, for 2:4 or a
// narrower weight type TB (int8 or e4m3 beside bf16 A), the raw rows they
// are expanded or widened from; Cs holds the finished tile in the
// accumulator's type (f32, or int32 for int8 x int8), and the gate's.
template <typename T, int BM, int BN, bool GATE, bool SPARSE, typename TB = T>
struct PrefillCfg {
  using WeightT = TB;
  using AccT = typename MmaOf<T>::Acc;
  static constexpr int kBK = MmaOf<T>::kBK;  // 128 bytes of each A row per stage
  static constexpr int kE = sizeof(T), kEB = sizeof(TB);
  static constexpr bool kWiden = !std::is_same<T, TB>::value;
  // int8 x int8 and e4m3 x e4m3: both operands staged in their own byte
  static constexpr bool kByte = sizeof(T) == 1;
  static_assert(!kByte || (!kWiden && !SPARSE), "8-bit pairs: same type, dense");
  // On the one-warp-row tile (BM = 16) a narrow dense weight is widened in
  // registers as its B fragments are built (b_frags_widen): no widened copy
  // in shared memory, no widening pass and barrier per step.  Its raw rows
  // are padded by 16 bytes, so a warp's four-row reads fall on 32 banks.
  // The wider tiles widen in a shared-memory pass (pf_widen), which each of
  // their two warp rows then reads; 2:4 weights expand in that pass
  // (pf_expand) on every tile.
#ifdef PREFILL_TIMING_B_IN_SMEM
  static constexpr bool kRegWiden = false;
#else
  static constexpr bool kRegWiden = kWiden && !SPARSE && BM == 16;
#endif
  // B fragments built in registers from 32-bit row reads (b_frags_widen,
  // b_frags_8bit): tile nt's column j is the warp's column 4j + nt.
  static constexpr bool kInterleaved = kRegWiden || kByte;
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kWarpsM = BM == 16 ? 1 : 2;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  // The ungated f32 64 x 128 tile: two CTAs fit an SM's shared memory, and
  // the dense MX and baseline kernels ask __launch_bounds__ for two, which
  // holds their registers to 128 (pf_3xtf32's fresh fragments take them to
  // 138-140).
  static constexpr bool kTwoPerSm =
      std::is_same<T, float>::value && !GATE && !SPARSE && BM == 64 && BN == 128;
  static constexpr int kWM = BM / kWarpsM, kMT = kWM / 16, kNT = 4;
  static constexpr int kAStride = kBK * kE + 16;  // bytes per staged A row (128 + 16)
  // bytes per staged B row: 8-bit rows padded by 32 bytes, so four rows 4
  // apart (b_frags_8bit) start 8 banks apart
  static constexpr int kBStride = kByte ? BN + 32 : (BN + 8) * kE;
  static constexpr int kABytes = BM * kAStride;
  static constexpr int kBBytes = kBK * kBStride;
  static constexpr int kPRow = BN * kEB + (kRegWiden ? 16 : 0);  // a raw weight or 2:4 payload row
  static constexpr int kRawBytes = SPARSE  ? (kBK / 2) * kPRow + (kBK / 8) * BN
                                   : kWiden ? kBK * kPRow
                                            : 0;
  static constexpr int kMats = GATE ? 2 : 1;
  static constexpr int kBSlot = kRegWiden ? 0 : kBBytes;  // the staged B tile in A's type
  static constexpr int kSlot = kABytes + kMats * (kBSlot + kRawBytes);
  static constexpr int kCStride = BN + 8;  // f32 words per Cs row
  static constexpr int kCBytes = BM * kCStride * 4 * kMats;
  static_assert((BM == 16 || BM % 32 == 0) && BM <= 128 && (BN == 64 || BN == 128),
                "a tile of csrc/prefill_tile.cuh");  // kernels/_build.PREFILL_TILES, GROUPED_TILES
  static_assert(kABytes % 16 == 0 && kBBytes % 16 == 0 && kRawBytes % 16 == 0, "16-byte rows");

  __host__ __device__ static constexpr int b_off(int mat) { return kABytes + mat * kBSlot; }
  __host__ __device__ static constexpr int raw_off(int mat) {
    return kABytes + kMats * kBSlot + mat * kRawBytes;
  }
};

__host__ __device__ inline int prefill_steps(int K, int bk) { return (K + bk - 1) / bk; }

// The grid walks M fastest: (tiles_m, tiles_n, split), so the CTAs resident
// at once share a band of B's columns (kept in L2) instead of streaming all
// of B once per row of tiles.
__device__ __forceinline__ int pf_tile_m() { return blockIdx.x; }
__device__ __forceinline__ int pf_tile_n() { return blockIdx.y; }

// The first K step of part p of `parts` equal parts.
__host__ __device__ inline int part_begin(int p, int steps, int parts) {
  return static_cast<int>(static_cast<int64_t>(p) * steps / parts);
}

// Dynamic shared memory of a launch: the ring and Cs, which aliases the ring
// unless a CTA folds several parts (split == 1 < parts) while the ring runs.
template <typename Cfg>
__host__ __device__ inline int prefill_smem(const PrefillShape& d, bool epilogue = true) {
  const int ring = d.stages * Cfg::kSlot;
  if (!epilogue) return ring;
  if (d.split == 1 && d.parts > 1) return ring + Cfg::kCBytes;
  return ring > Cfg::kCBytes ? ring : Cfg::kCBytes;
}

// The launcher's check of a tile chosen in Python: cudaErrorInvalidValue
// (as an int) for anything the loop does not take, else 0.
template <typename Cfg, bool SPARSE>
static int prefill_check(const PrefillShape& d, int static_smem, bool epilogue = true) {
  auto aligned = [](const void* p, int v) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % v == 0;
  };
  auto width_ok = [](int v, int64_t row_bytes) {
    return is_pow2(v) && v <= 16 && row_bytes % v == 0;
  };
  const int steps = prefill_steps(d.K, Cfg::kBK);
  const bool ok =
      d.M >= 1 && d.N >= 1 && d.K >= 1 && d.stages >= 2 && d.stages <= kPrefillMaxStages &&
      is_pow2(d.parts) && d.parts <= kPrefillMaxParts && steps % d.parts == 0 &&
      (d.split == 1 || d.split == d.parts) && (d.split == 1 || epilogue) &&
      width_ok(d.va, static_cast<int64_t>(d.K) * Cfg::kE) &&
      width_ok(d.vb, static_cast<int64_t>(d.N) * Cfg::kEB) && aligned(d.a, d.va) &&
      aligned(d.b, d.vb) && aligned(d.bg, d.vb) &&
      (!SPARSE || (d.K % 8 == 0 && width_ok(d.vm, d.N) && aligned(d.bmeta, d.vm) &&
                   aligned(d.bgmeta, d.vm))) &&
      prefill_smem<Cfg>(d, epilogue) + static_smem <= kPrefillMaxSmem;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// copies: global -> one ring slot
// ---------------------------------------------------------------------------

// ROWS rows of WIDTH bytes (a multiple of V) from a row-major operand of
// rows_total rows of row_bytes, from row r0 and byte col0 on, into rows
// `stride` bytes apart; chunks past rows_total or row_bytes are zero filled.
template <int V, int ROWS, int WIDTH, int THREADS>
__device__ __forceinline__ void pf_copy(unsigned char* dst, int stride, const void* src,
                                        int64_t row_bytes, int r0, int rows_total,
                                        int64_t col0) {
  constexpr int kPer = WIDTH / V;
  const unsigned char* S = static_cast<const unsigned char*>(src);
  const int64_t cols_left = row_bytes - col0;
#pragma unroll 4
  for (int q = threadIdx.x; q < ROWS * kPer; q += THREADS) {
    const int r = q / kPer, o = (q % kPer) * V;
    const bool ok = r0 + r < rows_total && o < cols_left;
    copy_chunk<V>(dst + r * stride + o, ok ? S + (r0 + r) * row_bytes + col0 + o : S, ok);
  }
}

template <int ROWS, int WIDTH, int THREADS>
__device__ __forceinline__ void pf_copy_v(int v, unsigned char* dst, int stride,
                                          const void* src, int64_t row_bytes, int r0,
                                          int rows_total, int64_t col0) {
  switch (v) {
    case 16: pf_copy<16, ROWS, WIDTH, THREADS>(dst, stride, src, row_bytes, r0, rows_total, col0); break;
    case 8: pf_copy<8, ROWS, WIDTH, THREADS>(dst, stride, src, row_bytes, r0, rows_total, col0); break;
    case 4: pf_copy<4, ROWS, WIDTH, THREADS>(dst, stride, src, row_bytes, r0, rows_total, col0); break;
    case 2: pf_copy<2, ROWS, WIDTH, THREADS>(dst, stride, src, row_bytes, r0, rows_total, col0); break;
    default: pf_copy<1, ROWS, WIDTH, THREADS>(dst, stride, src, row_bytes, r0, rows_total, col0);
  }
}

// The copies of K step kt into one slot: A's BM rows, and B's (and the
// gate's) BK rows, raw when their type is narrower than A's, or their
// BK / 2 payload and BK / 8 metadata rows.
template <typename T, int BM, int BN, bool GATE, bool SPARSE, typename TB = T>
__device__ __forceinline__ void pf_issue(unsigned char* slot, const PrefillShape& d, int m0,
                                         int n0, int kt) {
  using Cfg = PrefillCfg<T, BM, BN, GATE, SPARSE, TB>;
  constexpr int E = Cfg::kE, EB = Cfg::kEB, BK = Cfg::kBK, TH = Cfg::kThreads;
  const int k0 = kt * BK;
  pf_copy_v<BM, BK * E, TH>(d.va, slot, Cfg::kAStride, d.a, static_cast<int64_t>(d.K) * E, m0,
                            d.M, static_cast<int64_t>(k0) * E);
  const int64_t brow = static_cast<int64_t>(d.N) * EB, bcol = static_cast<int64_t>(n0) * EB;
#pragma unroll
  for (int mat = 0; mat < Cfg::kMats; ++mat) {
    const void* B = mat ? d.bg : d.b;
    if constexpr (SPARSE) {
      unsigned char* raw = slot + Cfg::raw_off(mat);
      pf_copy_v<BK / 2, BN * EB, TH>(d.vb, raw, Cfg::kPRow, B, brow, k0 / 2, d.K / 2, bcol);
      pf_copy_v<BK / 8, BN, TH>(d.vm, raw + (BK / 2) * Cfg::kPRow, BN, mat ? d.bgmeta : d.bmeta,
                                d.N, k0 / 8, d.K / 8, n0);
    } else if constexpr (Cfg::kWiden) {
      pf_copy_v<BK, BN * EB, TH>(d.vb, slot + Cfg::raw_off(mat), Cfg::kPRow, B, brow, k0, d.K,
                                 bcol);
    } else {
      pf_copy_v<BK, BN * E, TH>(d.vb, slot + Cfg::b_off(mat), Cfg::kBStride, B, brow, k0, d.K,
                                bcol);
    }
  }
}

// The 2:4 expansion of one staged step (stage 1c), in shared memory: each
// (metadata byte b, column n) expands 4 payload values into dense rows
// 8b .. 8b + 7 by kernels/sparse.expand_24's compare-select rule, dense row
// 8b + 4h + j = (i0 == j ? p[4b + 2h] : 0) + (i1 == j ? p[4b + 2h + 1] : 0),
// nibble h of the byte holding (i0, i1), widened to A's type as the dense
// kernel widens (exactly).  The dense tile holds exactly the values the
// dense kernel stages from expand_24's weight, so the MMAs that follow give
// the dense kernel's bits.
template <typename Cfg, typename T, typename TB, int BN>
__device__ __forceinline__ void pf_expand(unsigned char* bdst, const unsigned char* raw) {
  constexpr int BK = Cfg::kBK, kItems = (BK / 8) * BN / Cfg::kThreads;
  static_assert((BK / 8) * BN % Cfg::kThreads == 0, "whole items per thread");
  const TB* P = reinterpret_cast<const TB*>(raw);
  const uint8_t* Mt = raw + (BK / 2) * Cfg::kPRow;
  int mb[kItems];  // every item's reads first, so their latencies overlap
  float p[kItems][4];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * Cfg::kThreads, b = e / BN, n = e % BN;
    mb[i] = Mt[b * BN + n];
#pragma unroll
    for (int q = 0; q < 4; ++q) p[i][q] = to_f32(P[(4 * b + q) * BN + n]);
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * Cfg::kThreads, b = e / BN, n = e % BN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nib = h ? mb[i] >> 4 : mb[i] & 0xF;
      const int i0 = nib & 3, i1 = (nib >> 2) & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        from_f32(reinterpret_cast<T*>(bdst + (8 * b + 4 * h + j) * Cfg::kBStride) + n,
                 (i0 == j ? p[i][2 * h] : 0.0f) + (i1 == j ? p[i][2 * h + 1] : 0.0f));
    }
  }
}

// Four narrow weights (the bytes of w, byte j the j-th) as the bits of four
// f32 values, exactly: every int8 and every finite e4m3 value is a bf16
// value whose f32 form has its low 16 bits zero, so the bf16 is the f32's
// high half (pack_bf16x2).  Integer and bit operations only, no conversion
// instructions (which issue at a quarter of the ALU rate):
//   int8: byte j, offset to u = x + 128, is placed under the exponent of
//     2^23 (0x4B0000uu is 2^23 + u), and 2^23 + 128 is subtracted;
//   e4m3: sign to bit 31, exponent and mantissa to bits 20..26 (an f32 of
//     exponent e - 127, or an f32 subnormal for e4m3's), times 2^120.
__device__ __forceinline__ void widen4_f32(uint32_t w, int8_t, uint32_t (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)) -
                           8388736.0f);
}

__device__ __forceinline__ void widen4_f32(uint32_t w, __nv_fp8_e4m3, uint32_t (&f)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t t = __byte_perm(w, 0u, 0x0444 + (j << 12));  // byte j on top
    f[j] = __float_as_uint(
        __uint_as_float((t & 0x80000000u) | ((t & 0x7F000000u) >> 4)) * 0x1p120f);
  }
}

// The high halves of two f32 values, a's low: two bf16 in one word.
__device__ __forceinline__ uint32_t pack_bf16x2(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

template <typename TB>
__device__ __forceinline__ uint2 widen4_bf16(uint32_t w) {
  uint32_t f[4];
  widen4_f32(w, TB(), f);
  return make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
}

// A narrow weight's staged rows (int8, or e4m3) widened into A's type
// (bf16), exactly (widen4_bf16).  Four weights per item: one 32-bit
// shared-memory read, one 64-bit write; every thread reads all its items
// first (the loop is unrolled), so their latencies overlap.
template <typename Cfg, typename T, typename TB, int BN>
__device__ __forceinline__ void pf_widen(unsigned char* bdst, const unsigned char* raw) {
  static_assert(sizeof(TB) == 1 && std::is_same<T, __nv_bfloat16>::value,
                "a byte weight widened to bf16");
  constexpr int kQuads = BN / 4, kItems = Cfg::kBK * kQuads / Cfg::kThreads;
  static_assert(Cfg::kBK * kQuads % Cfg::kThreads == 0, "whole items per thread");
  uint32_t w[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * Cfg::kThreads, k = e / kQuads, n = (e % kQuads) * 4;
    w[i] = *reinterpret_cast<const uint32_t*>(raw + k * BN + n);
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = threadIdx.x + i * Cfg::kThreads, k = e / kQuads, n = (e % kQuads) * 4;
    *reinterpret_cast<uint2*>(bdst + k * Cfg::kBStride + n * 2) = widen4_bf16<TB>(w[i]);
  }
}

// ---------------------------------------------------------------------------
// tensor-core products of one staged step
// ---------------------------------------------------------------------------

// The accumulators of one warp: acc[mt][nt] is the m16 x n8 MMA tile at
// rows wm0 + 16 mt, columns wn0 + 8 nt; lane (g, c) = (lane / 4, lane % 4)
// holds its rows g and g + 8, columns 2c and 2c + 1.
template <typename Cfg>
using Acc = typename Cfg::AccT[Cfg::kMT][Cfg::kNT][4];

// One B operand's fragments for k sub-step kk (bf16: ldmatrix.trans of two
// n8 tiles at a time).
template <typename Cfg>
__device__ __forceinline__ void b_frags_bf16(unsigned (&b)[Cfg::kNT][2],
                                             const unsigned char* Bs, int kk, int wn0,
                                             int lane) {
#pragma unroll
  for (int np = 0; np < Cfg::kNT / 2; ++np) {
    unsigned r[4];
    ldsm_x4_t(r, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * Cfg::kBStride +
                     (wn0 + np * 16 + (lane >> 4) * 8) * 2);
    b[2 * np][0] = r[0];
    b[2 * np][1] = r[1];
    b[2 * np + 1][0] = r[2];
    b[2 * np + 1][1] = r[3];
  }
}

// f32 B fragments for k sub-step kk, split into TF32 high and low parts.
template <typename Cfg>
__device__ __forceinline__ void b_frags_tf32(unsigned (&bh)[Cfg::kNT][2],
                                             unsigned (&bl)[Cfg::kNT][2],
                                             const unsigned char* Bs, int kk, int wn0,
                                             int lane) {
  const float* B = reinterpret_cast<const float*>(Bs);
  constexpr int S = Cfg::kBStride / 4;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int nt = 0; nt < Cfg::kNT; ++nt) {
    const float* q = B + (kk + c) * S + wn0 + nt * 8 + g;
    split_tf32(q[0], bh[nt][0], bl[nt][0]);
    split_tf32(q[4 * S], bh[nt][1], bl[nt][1]);
  }
}

// A narrow weight's B fragments for k sub-step kk, widened to bf16 in
// registers (PrefillCfg::kRegWiden).  The warp's four n8 tiles interleave
// its 32 columns: tile nt's column j is the warp's column 4j + nt, so lane
// (g, c) reads one 32-bit word (columns 4g .. 4g + 3, one per tile) from
// each of its four K rows 2c, 2c + 1, 2c + 8, 2c + 9 (pf_to_tile stores by
// the same map).  The products are those of the widened shared-memory
// tile's, element by element.
template <typename Cfg>
__device__ __forceinline__ void b_frags_widen(unsigned (&b)[Cfg::kNT][2],
                                              const unsigned char* raw, int kk, int wn0,
                                              int lane) {
  using TB = typename Cfg::WeightT;
  const int g = lane >> 2, c = lane & 3;
  const unsigned char* p = raw + (kk + 2 * c) * Cfg::kPRow + wn0 + 4 * g;
  uint32_t f[4][4];  // [k row 2c, 2c + 1, 2c + 8, 2c + 9][tile]: widened bits
#pragma unroll
  for (int r = 0; r < 4; ++r)
    widen4_f32(*reinterpret_cast<const uint32_t*>(p + ((r & 1) + 8 * (r >> 1)) * Cfg::kPRow),
               TB(), f[r]);
#pragma unroll
  for (int nt = 0; nt < Cfg::kNT; ++nt) {
    b[nt][0] = pack_bf16x2(f[0][nt], f[1][nt]);
    b[nt][1] = pack_bf16x2(f[2][nt], f[3][nt]);
  }
}

// The 4 x 4 bytes of four 32-bit words (w[q]: row q) transposed: word j
// holds byte j of every row, row q in byte q.
__device__ __forceinline__ void byte_transpose4(uint32_t (&r)[4], const uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  r[0] = __byte_perm(t0, t1, 0x5410);
  r[1] = __byte_perm(t0, t1, 0x7632);
  r[2] = __byte_perm(t2, t3, 0x5410);
  r[3] = __byte_perm(t2, t3, 0x7632);
}

// An 8-bit B operand's fragments for the k32 sub-step at byte kk: the m16n8k32
// MMA wants K rows 4c .. 4c + 3 (b[nt][0]) and 16 + 4c .. (b[nt][1]) of
// column g in one register each, and the slot holds (K, N) rows.  Lane
// (g, c) reads the 32-bit word of columns 4g .. 4g + 3 (tile nt's column g
// is the warp's column 4g + nt, as b_frags_widen) from each of its four K
// rows and transposes the 4 x 4 bytes with byte permutes.  The four reads
// are rotated by c (read q is row 4c + ((q + c) & 3)), so with rows
// kBStride = BN + 32 bytes apart the warp's 32 words of one read fall on
// 32 banks; a funnel shift by 8c bytes undoes the rotation.
template <typename Cfg>
__device__ __forceinline__ void b_frags_8bit(unsigned (&b)[Cfg::kNT][2],
                                             const unsigned char* Bs, int kk, int wn0,
                                             int lane) {
  const int g = lane >> 2, c = lane & 3;
  const unsigned char* p = Bs + (kk + 4 * c) * Cfg::kBStride + wn0 + 4 * g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = *reinterpret_cast<const uint32_t*>(p + (16 * h + ((q + c) & 3)) * Cfg::kBStride);
    uint32_t r[4];
    byte_transpose4(r, w);
#pragma unroll
    for (int nt = 0; nt < Cfg::kNT; ++nt) b[nt][h] = __funnelshift_l(r[nt], r[nt], 8 * c);
  }
}

// acc += a b for one k32 step of 8-bit operands.  int8: the MMA's exact
// int32 sums.  e4m3: the k32 product as two f16 m16n8k16 products of the
// exactly widened operands (ah / bh: the fragments as f16 pairs,
// pf_f16_frags), summed by the tensor cores from zero, then added to acc
// with rounding FADDs (the MMAs' f32 accumulation truncates: csrc/mma.cuh
// mma_3xtf32).
__device__ __forceinline__ void pf_mma8(int (&acc)[4], const unsigned (&a)[4],
                                        const unsigned (&b)[2], const unsigned (&)[8],
                                        const unsigned (&)[4]) {
  mma_s8(acc, a, b);
}

__device__ __forceinline__ void pf_mma8(float (&acc)[4], const unsigned (&)[4],
                                        const unsigned (&)[2], const unsigned (&ah)[8],
                                        const unsigned (&bh)[4]) {
  float t[4];
  const unsigned a0[4] = {ah[0], ah[1], ah[2], ah[3]}, a1[4] = {ah[4], ah[5], ah[6], ah[7]};
  const unsigned b0[2] = {bh[0], bh[1]}, b1[2] = {bh[2], bh[3]};
  mma_f16_zero(t, a0, b0);
  mma_f16(t, a1, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// The f16 operands of an e4m3 k32 step's two m16n8k16 products, from the
// 8-bit fragments (a register's bytes 0, 1 are the lower f16 pair, bytes 2,
// 3 the upper, in A and B alike: the first product takes K 4c .. 4c + 3,
// the second 16 + 4c .., every K once).  Called for int8 too, where nothing
// reads them (dead code for the compiler).
__device__ __forceinline__ void pf_f16_frags(unsigned (&ah)[8], const unsigned (&a)[4]) {
  ah[0] = e4m3x2_f16x2(a[0]);
  ah[1] = e4m3x2_f16x2(a[1]);
  ah[2] = e4m3x2_f16x2(a[0] >> 16);
  ah[3] = e4m3x2_f16x2(a[1] >> 16);
  ah[4] = e4m3x2_f16x2(a[2]);
  ah[5] = e4m3x2_f16x2(a[3]);
  ah[6] = e4m3x2_f16x2(a[2] >> 16);
  ah[7] = e4m3x2_f16x2(a[3] >> 16);
}

__device__ __forceinline__ void pf_f16_frags(unsigned (&bh)[4], const unsigned (&b)[2]) {
  bh[0] = e4m3x2_f16x2(b[0]);
  bh[1] = e4m3x2_f16x2(b[0] >> 16);
  bh[2] = e4m3x2_f16x2(b[1]);
  bh[3] = e4m3x2_f16x2(b[1] >> 16);
}

// acc += a b in 3xTF32 for one k8 step: lo*hi, hi*lo, hi*hi summed by the
// tensor cores into a fresh fragment, then added to acc with rounding
// FADDs.  The tensor cores' f32 accumulation truncates: a K loop that kept
// acc in the MMAs lost bits at every step (tools/accumulation_witness.py,
// M = 2048, K = 768-1536: 5.4e-6 relative RMS from the f64 product, against
// 3.5-7.0e-7 for cuBLAS f32 and 8e-8 for the three products summed
// exactly).
__device__ __forceinline__ void pf_3xtf32(float (&acc)[4], const unsigned (&ah)[4],
                                          const unsigned (&al)[4], const unsigned (&bh)[2],
                                          const unsigned (&bl)[2]) {
#if defined(PREFILL_TIMING_MMA_ACC)
  mma_tf32(acc, al, bh);
  mma_tf32(acc, ah, bl);
  mma_tf32(acc, ah, bh);
#else
  float t[4];
#ifdef PREFILL_TIMING_ONE_TF32
  mma_tf32_zero(t, ah, bh);
#else
  mma_tf32_zero(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
#endif
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
#endif
}

// The MMAs of one staged K step into acc (and accg with GATE).  Every
// output element takes the same sequence of products whatever its tile:
// the k sub-steps in order, and for f32 lo*hi, hi*lo, hi*hi at each,
// summed apart and then added to acc (pf_3xtf32).
template <typename T, int BM, int BN, bool GATE, bool SPARSE, typename TB = T>
__device__ __forceinline__ void pf_mma_stage(
    Acc<PrefillCfg<T, BM, BN, GATE, SPARSE, TB>>& acc,
    Acc<PrefillCfg<T, BM, BN, GATE, SPARSE, TB>>& accg, const unsigned char* slot, int wm0,
    int wn0, int lane) {
  using Cfg = PrefillCfg<T, BM, BN, GATE, SPARSE, TB>;
  constexpr int MT = Cfg::kMT, NT = Cfg::kNT;
  const unsigned char* Bs = slot + Cfg::b_off(0);
  const unsigned char* Bgs = slot + Cfg::b_off(GATE ? 1 : 0);
  if constexpr (std::is_same<T, float>::value) {
    const float* A = reinterpret_cast<const float*>(slot);
    constexpr int S = Cfg::kAStride / 4;
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int kk = 0; kk < Cfg::kBK; kk += 8) {
      unsigned ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p = A + (wm0 + mt * 16 + g) * S + kk + c;
        split_tf32(p[0], ah[mt][0], al[mt][0]);
        split_tf32(p[8 * S], ah[mt][1], al[mt][1]);
        split_tf32(p[4], ah[mt][2], al[mt][2]);
        split_tf32(p[8 * S + 4], ah[mt][3], al[mt][3]);
      }
      unsigned bh[NT][2], bl[NT][2];
      b_frags_tf32<Cfg>(bh, bl, Bs, kk, wn0, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) pf_3xtf32(acc[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
      if constexpr (GATE) {
        b_frags_tf32<Cfg>(bh, bl, Bgs, kk, wn0, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            pf_3xtf32(accg[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
      }
    }
  } else if constexpr (Cfg::kByte) {
#pragma unroll
    for (int kk = 0; kk < Cfg::kBK; kk += 32) {
      unsigned a[MT][4], ah[MT][8];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldsm_x4(a[mt], slot + (wm0 + mt * 16 + (lane & 15)) * Cfg::kAStride + kk +
                           (lane >> 4) * 16);
        pf_f16_frags(ah[mt], a[mt]);
      }
      unsigned b[NT][2], bh[NT][4];
      b_frags_8bit<Cfg>(b, Bs, kk, wn0, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) pf_f16_frags(bh[nt], b[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) pf_mma8(acc[mt][nt], a[mt], b[nt], ah[mt], bh[nt]);
      if constexpr (GATE) {
        b_frags_8bit<Cfg>(b, Bgs, kk, wn0, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) pf_f16_frags(bh[nt], b[nt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) pf_mma8(accg[mt][nt], a[mt], b[nt], ah[mt], bh[nt]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < Cfg::kBK; kk += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], slot + (wm0 + mt * 16 + (lane & 15)) * Cfg::kAStride +
                           (kk + (lane >> 4) * 8) * 2);
      unsigned b[NT][2];
      if constexpr (Cfg::kRegWiden)
        b_frags_widen<Cfg>(b, slot + Cfg::raw_off(0), kk, wn0, lane);
      else
        b_frags_bf16<Cfg>(b, Bs, kk, wn0, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      if constexpr (GATE) {
        if constexpr (Cfg::kRegWiden)
          b_frags_widen<Cfg>(b, slot + Cfg::raw_off(1), kk, wn0, lane);
        else
          b_frags_bf16<Cfg>(b, Bgs, kk, wn0, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(accg[mt][nt], a[mt], b[nt]);
      }
    }
  }
}

template <typename Cfg>
__device__ __forceinline__ void pf_zero(Acc<Cfg>& acc) {
#pragma unroll
  for (int mt = 0; mt < Cfg::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
}

// A warp's accumulators into the tile C (row stride kCStride, the
// accumulator's type): copied (first) or added to the total there (total +
// partial).  Each thread touches only its own elements (tile nt's column j
// is the warp's column 8 nt + j, or 4 j + nt under kInterleaved).
template <typename Cfg>
__device__ __forceinline__ void pf_to_tile(typename Cfg::AccT* C, const Acc<Cfg>& acc, int wm0,
                                           int wn0, int lane, bool first) {
  const int g = lane >> 2, c = lane & 3;
  if constexpr (Cfg::kInterleaved) {
#pragma unroll
    for (int mt = 0; mt < Cfg::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          typename Cfg::AccT* p = C + (wm0 + mt * 16 + g + 8 * (i >> 1)) * Cfg::kCStride +
                                  wn0 + 4 * (2 * c + (i & 1)) + nt;
          *p = first ? acc[mt][nt][i] : *p + acc[mt][nt][i];
        }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < Cfg::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        typename Cfg::AccT* q =
            C + (wm0 + mt * 16 + g + 8 * h) * Cfg::kCStride + wn0 + nt * 8 + 2 * c;
        if constexpr (std::is_same<typename Cfg::AccT, float>::value) {
          float2* p = reinterpret_cast<float2*>(q);
          float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          if (!first) {
            const float2 t = *p;
            v = make_float2(t.x + v.x, t.y + v.y);
          }
          *p = v;
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) q[j] = first ? acc[mt][nt][2 * h + j] : q[j] + acc[mt][nt][2 * h + j];
        }
      }
}

// ---------------------------------------------------------------------------
// the K loop
// ---------------------------------------------------------------------------

// The ring over K steps s0 .. s1 - 1 of one tile: primed with stages - 1
// steps, then each step waits for its slot, passes ONE barrier (its slot
// has landed for every thread, and every thread is done with the slot the
// next copies overwrite), issues the copies of the step stages - 1 ahead,
// expands a 2:4 slot or widens a narrow weight's (and passes a second
// barrier) and runs body(slot, kt).
// One group is committed per step, empty or not, so the wait count is
// constant.  Ends after the last copies landed and a barrier, so the
// caller may reuse the ring's shared memory.
template <typename T, int BM, int BN, bool GATE, bool SPARSE, typename TB, typename Body>
__device__ __forceinline__ void pf_ring(const PrefillShape& d, unsigned char* smem, int m0,
                                        int n0, int s0, int s1, Body&& body) {
  using Cfg = PrefillCfg<T, BM, BN, GATE, SPARSE, TB>;
  for (int s = 0; s < d.stages - 1; ++s) {
    if (s0 + s < s1)
      pf_issue<T, BM, BN, GATE, SPARSE, TB>(smem + s * Cfg::kSlot, d, m0, n0, s0 + s);
    cp_async_commit();
  }
  for (int kt = s0; kt < s1; ++kt) {
    cp_async_wait(d.stages - 2);
    __syncthreads();
    const int nx = kt + d.stages - 1;
#ifndef PREFILL_TIMING_NO_COPIES
    if (nx < s1)
      pf_issue<T, BM, BN, GATE, SPARSE, TB>(smem + ((nx - s0) % d.stages) * Cfg::kSlot, d, m0,
                                            n0, nx);
#endif
    cp_async_commit();
    unsigned char* slot = smem + ((kt - s0) % d.stages) * Cfg::kSlot;
    if constexpr (SPARSE || (Cfg::kWiden && !Cfg::kRegWiden)) {
#pragma unroll
      for (int mat = 0; mat < Cfg::kMats; ++mat) {
        if constexpr (SPARSE)
          pf_expand<Cfg, T, TB, BN>(slot + Cfg::b_off(mat), slot + Cfg::raw_off(mat));
        else
          pf_widen<Cfg, T, TB, BN>(slot + Cfg::b_off(mat), slot + Cfg::raw_off(mat));
      }
      __syncthreads();
    }
    body(slot, kt);
  }
  cp_async_wait(0);
  __syncthreads();
}

// The whole K loop of an MX tile (dense, 2:4 or ABFT): this CTA's part
// (split == parts, a cluster) or all parts, each finished part folded into
// the total in Cs (split == 1).  `hook.step(slot)` sees every staged step
// after its MMAs (all threads call it; NoHook, or abft_tile.cuh's
// AbftPrefillHook).  Returns Cs, the finished tile in the accumulator's
// type (the gate's follows at Cs + BM * kCStride), complete for every
// thread of the CTA.
template <typename T, int BM, int BN, bool GATE, bool SPARSE, typename TB = T,
          typename Hook>
__device__ __forceinline__ typename PrefillCfg<T, BM, BN, GATE, SPARSE, TB>::AccT* prefill_sweep(
    const PrefillShape& d, Hook& hook) {
  using Cfg = PrefillCfg<T, BM, BN, GATE, SPARSE, TB>;
  extern __shared__ __align__(128) unsigned char pf_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / Cfg::kWarpsN) * Cfg::kWM, wn0 = (warp % Cfg::kWarpsN) * 32;
  const int m0 = pf_tile_m() * BM, n0 = pf_tile_n() * BN;
  const int steps = prefill_steps(d.K, Cfg::kBK);
  const int p0 = d.split > 1 ? static_cast<int>(blockIdx.z) : 0;
  const int p1 = d.split > 1 ? p0 + 1 : d.parts;
  const bool fold = p1 - p0 > 1;
  using AccT = typename Cfg::AccT;
  AccT* Cs = reinterpret_cast<AccT*>(pf_smem + (fold ? d.stages * Cfg::kSlot : 0));
  AccT* Cg = Cs + BM * Cfg::kCStride;
  Acc<Cfg> acc, accg;  // the partial sums of the current part
  pf_zero<Cfg>(acc);
  pf_zero<Cfg>(accg);
  int p = p0, pend = part_begin(p0 + 1, steps, d.parts);
  pf_ring<T, BM, BN, GATE, SPARSE, TB>(
      d, pf_smem, m0, n0, part_begin(p0, steps, d.parts), part_begin(p1, steps, d.parts),
      [&](const unsigned char* slot, int kt) {
#ifndef PREFILL_TIMING_NO_PRODUCTS
        pf_mma_stage<T, BM, BN, GATE, SPARSE, TB>(acc, accg, slot, wm0, wn0, lane);
#endif
        hook.step(slot);
        if (fold && kt + 1 == pend) {  // a part is finished: total (+)= partial
          pf_to_tile<Cfg>(Cs, acc, wm0, wn0, lane, p == p0);
          pf_zero<Cfg>(acc);
          if constexpr (GATE) {
            pf_to_tile<Cfg>(Cg, accg, wm0, wn0, lane, p == p0);
            pf_zero<Cfg>(accg);
          }
          ++p;
          pend = part_begin(p + 1, steps, d.parts);
        }
      });
  if (!fold) {  // the one part's partial (Cs over the drained ring)
    pf_to_tile<Cfg>(Cs, acc, wm0, wn0, lane, true);
    if constexpr (GATE) pf_to_tile<Cfg>(Cg, accg, wm0, wn0, lane, true);
  }
  __syncthreads();
  return Cs;
}

// The single write-back of an MX tile through mx_store: one CTA stores its
// tile from Cs (split == 1); in a cluster (split == parts) rank r sums rows
// r * BM / split onward of every rank's partial, in rank order, through
// distributed shared memory, and stores them.  Neighbouring threads store
// neighbouring columns.  Only rows row0 .. d.M - 1 are stored (the grouped
// GEMM stores one group's rows per visit).  An int32 tile (int8 x int8) is
// summed as int32 and widened to f32 only here, at mx_store.
template <typename Cfg, int BM, int BN, bool GATE, typename R>
__device__ __forceinline__ void prefill_store(const R& r, const PrefillShape& d,
                                              const typename Cfg::AccT* Cs, int row0 = 0) {
  using AccT = typename Cfg::AccT;
  const int m0 = pf_tile_m() * BM, n0 = pf_tile_n() * BN;
  constexpr int CS = Cfg::kCStride, GOFF = BM * Cfg::kCStride;
  if (d.split == 1) {
    for (int e = threadIdx.x; e < BM * BN; e += Cfg::kThreads) {
      const int m = e / BN, n = e % BN, gm = m0 + m, gn = n0 + n;
      if (gm >= row0 && gm < d.M && gn < d.N)
        mx_store<GATE>(r, static_cast<float>(Cs[m * CS + n]),
                       GATE ? static_cast<float>(Cs[GOFF + m * CS + n]) : 0.0f, gm, gn);
    }
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every rank's partial is in its Cs
  const AccT* src[kPrefillMaxParts];
#pragma unroll
  for (int q = 0; q < kPrefillMaxParts; ++q)
    src[q] = q < d.split ? cl.map_shared_rank(Cs, q) : Cs;
  const int rows = BM / d.split, r0 = static_cast<int>(cl.block_rank()) * rows;
  for (int e = threadIdx.x; e < rows * BN; e += Cfg::kThreads) {
    const int m = r0 + e / BN, n = e % BN, gm = m0 + m, gn = n0 + n;
    if (gm < row0 || gm >= d.M || gn >= d.N) continue;
    const int o = m * CS + n;
    AccT y = src[0][o], g = GATE ? src[0][GOFF + o] : AccT(0);
#pragma unroll
    for (int q = 1; q < kPrefillMaxParts; ++q)
      if (q < d.split) {
        y = y + src[q][o];
        if constexpr (GATE) g = g + src[q][GOFF + o];
      }
    mx_store<GATE>(r, static_cast<float>(y), static_cast<float>(g), gm, gn);
  }
  cl.sync();  // no CTA leaves while its shared memory is read
}

// Launch one prefill kernel instantiation with the tile d (after
// prefill_check): grid (M / BM, N / BN, split), clusters of (1, 1, split).
// The opt-in to the full dynamic shared memory (less the kernel's static
// shared memory) is set once per kernel.
template <auto Kernel, typename Cfg, bool SPARSE, typename... KArgs>
static int prefill_launch(const PrefillShape& d, cudaStream_t s, bool epilogue,
                          KArgs... args) {
  static int static_smem = -1;  // per kernel
  if (static_smem < 0) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, Kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kPrefillMaxSmem - static_cast<int>(fa.sharedSizeBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    static_smem = static_cast<int>(fa.sharedSizeBytes);
  }
  const int bad = prefill_check<Cfg, SPARSE>(d, static_smem, epilogue);
  if (bad) return bad;
  const int bm = Cfg::kWarpsM * Cfg::kWM, bn = 32 * Cfg::kWarpsN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d.M + bm - 1) / bm, (d.N + bn - 1) / bn, d.split);
  cfg.blockDim = dim3(Cfg::kThreads);
  cfg.dynamicSmemBytes = prefill_smem<Cfg>(d, epilogue);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = d.split;
  cfg.attrs = attr;
  cfg.numAttrs = d.split > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, Kernel, args...));
}
