// The decode tile (M <= 16 rows) of the MX GEMM -- dense (csrc/mx_matmul.cu),
// 2:4 sparse (csrc/mx_matmul_sparse.cu) and ABFT (csrc/mx_matmul_abft.cu)
// -- and of the baseline GEMM (csrc/baseline_matmul.cu): one
// weight-streaming K loop for Hopper (sm_90a).  They replace the decode
// path of their TPU kernels (repro/kernels/mx_matmul.py::mx_matmul_fused,
// its b_sparse and abft paths, baseline_matmul.py).
//
// What bounds it on the H100: a decode GEMM reads the whole weight for a
// handful of rows, so the bytes bound it (3.35 TB/s; f32 M=8 K=8192 N=2048:
// 64 MB, 0.020 ms), and every output's K chain is serial (one FMA after
// another, 4 cycles each: 8192 take 0.017 ms).  With about 124 outputs per
// SM at M = 8, N = 2048, a scheduler holds one warp, so nothing hides that
// warp's shared-memory read latency: the MAC loop takes several times the
// chain's 4 cycles per K row, and the ring's copies share the SM's
// load/store path with it (PERF.md §6).  The earlier (16 x 16 x 128) tile
// held one 8 KB K step per CTA in flight (about 1 MB across the card, where
// 3.35 TB/s at about 1 us of latency needs 2-3 MB), ran half its threads on
// padding rows at M = 8, took two barriers per K step and moved a narrow
// weight one byte per thread per load.  This loop instead:
//   * keeps a ring of `stages` shared-memory stages full with 16-byte
//     cp.async.cg copies (commit / wait groups): a copy carries 4 f32, 8
//     bf16 or 16 int8 / fp8 weights; the weight stays in its own width in
//     shared memory (a narrow weight buys deeper K steps for the same bytes)
//     and is widened to f32, or to int32 for int8 x int8, as the MAC reads
//     it.  kernels/_build.decode_tile sizes the ring to keep >= 32 KB of
//     weight in flight per SM;
//   * one barrier per K step: the wait for stage kt, a barrier, the copies
//     of stage kt + stages - 1 into the slot stage kt - 1 left, the MACs;
//   * no padding rows: a CTA owns `bn` columns and the M rows that exist;
//     thread (r, c) owns column c and rows r*TM .. r*TM + TM - 1 (TM divides
//     M), the A values a shared-memory broadcast read 16 bytes along k at a
//     time, the weight read once per thread per k; a CTA holds at least 256
//     threads, and those past the outputs only issue copies;
//   * every output keeps its serial K chain, acc = mac(a[k], b[k], acc) for
//     k = 0 .. K-1 in order, whatever the tile: so the 2:4 and ABFT
//     variants, and any other tile of the dense one, are bitwise equal;
//   * ragged and misaligned operands in the same kernel: a row of A or B
//     whose bytes or base address are not 16-byte aligned is copied in the
//     widest of 8, 4 (cp.async.ca), 2 or 1 bytes (plain loads) that divides
//     both; chunks past K or N are zero filled (a zero product leaves every
//     accumulator as it was).
// The 2:4 variant (kDecodeSparse) stages the weight as it travels: each
// slot holds the payload's bk/2 rows of bn columns in the weight's own
// width and the metadata's bk/8 rows of bn bytes, both copied raw, and a
// thread expands its column's 8 dense weights per metadata byte in
// registers (expand_24's compare-selects) as its MACs take them: no
// expansion pass through shared memory, and the device reads
// itemsize / 2 + 1/8 bytes per dense weight.  It keeps the dense chain, the
// pruned weights' zero products included: skipping them would halve the
// MACs, but would turn a dense NaN (inf x 0) into a finite value (and a
// -0.0 sum into +0.0).  Rows past K expand from zero-filled payload and
// metadata to zeros.
// The ABFT variant (kDecodeAbft) runs the dense loop, and beside it warps
// of their own (past the computing ones) keep abft_tile.cuh's
// AbftDecodeHook checksums of each staged step, their scratch after the
// ring.
// The tile (bn, bk, TM, stages, threads) and the copy widths are chosen in
// Python (kernels/_build.decode_tile / copy_width) and checked by
// decode_check.
#pragma once

#include <type_traits>

#include "gemm_tile.cuh"  // common.cuh, mac, NoHook
#include "mma.cuh"        // copy_chunk, cp_async_*

constexpr int kDecodeMaxM = 16;
constexpr int kDecodeMaxThreads = 512;
constexpr int kDecodeMaxStages = 8;
constexpr int kDecodeMaxSmem = 232448;  // 227 KB, the opt-in per-CTA maximum
constexpr int kDecodeSub = 64;  // K rows per MAC block; the baseline's round trips, every
                                // bk (a multiple of 128) rows, fall on block ends
constexpr int kDecodeFlagCols = 16;  // an ABFT flag tile's columns (_build.gemm_tile, M <= 16)

// The loop's variants: the dense weight, the 2:4 payload with its
// metadata, the dense weight with the ABFT checksums beside the MACs.
enum DecodeVariant : int { kDecodeDense = 0, kDecodeSparse = 1, kDecodeAbft = 2 };

// Everything the loop needs: operands (A (M, K), B / Bg (K, N), row-major;
// for kDecodeSparse B / Bg the (K/2, N) payloads and bm / bgm their (K/8,
// N) uint8 metadata), the tile and the copy widths in bytes (vm: the
// metadata's rows).
struct DecodeShape {
  const void *a, *b, *bg;
  int M, N, K;
  int bn, bk, stages, threads, va, vb;
  const uint8_t *bm, *bgm;
  int vm;
};

// The byte layout of one ring slot: A's M rows (bk elements, padded by 16
// bytes so rows fall on different banks), then the weight's panel -- B's bk
// rows of bn columns, or its payload's bk/2 rows and then its metadata's
// bk/8 rows (p_bytes the payload's part) -- then the gate weight's.
struct DecodeSlot {
  int a_stride, a_bytes, p_bytes, b_bytes, bytes;
};

template <typename TA, typename TB, bool GATE, int VAR = kDecodeDense>
__host__ __device__ inline DecodeSlot decode_slot(const DecodeShape& d) {
  constexpr bool kSparse = VAR == kDecodeSparse;
  DecodeSlot s;
  s.a_stride = d.bk * static_cast<int>(sizeof(TA)) + 16;
  s.a_bytes = d.M * s.a_stride;
  s.p_bytes = (kSparse ? d.bk / 2 : d.bk) * d.bn * static_cast<int>(sizeof(TB));
  s.b_bytes = s.p_bytes + (kSparse ? d.bk / 8 * d.bn : 0);
  s.bytes = s.a_bytes + s.b_bytes * (GATE ? 2 : 1);
  return s;
}

// The ABFT scratch after the ring, in 4-byte words: during the loop a
// staged step's colsum(A) and rowsum(B) per flag tile (and their
// |.|-sums), bk each; after it the hook threads' partial checksums (4
// columns' and 1 row item's each, with their |.|-sums) and the
// accumulator's sums (abft_tile.cuh AbftDecodeHook).
__host__ __device__ inline int decode_abft_bytes(const DecodeShape& d) {
  const int nt = d.bn / kDecodeFlagCols;
  const int loop = d.bk * (2 + 2 * nt);
  const int fin = 10 * d.threads + d.M * d.bn + d.M * nt + nt;
  return 4 * (loop > fin ? loop : fin);
}

// The first thread of the ABFT checksums' warps: past the computing
// threads, on a warp boundary.
__host__ __device__ inline int decode_hook0(const DecodeShape& d, int tm) {
  return (d.M / tm * d.bn + 31) / 32 * 32;
}

// The dynamic shared memory of a launch: the ring, and after it the ABFT
// scratch.
template <typename TA, typename TB, bool GATE, int VAR>
__host__ __device__ inline int64_t decode_smem(const DecodeShape& d) {
  return static_cast<int64_t>(d.stages) * decode_slot<TA, TB, GATE, VAR>(d).bytes +
         (VAR == kDecodeAbft ? decode_abft_bytes(d) : 0);
}

static inline bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// The launcher's check of a tile chosen in Python: cudaErrorInvalidValue
// (as an int) for anything the loop does not take, else 0.
template <typename TA, typename TB, int TM, bool GATE, int VAR = kDecodeDense>
static int decode_check(const DecodeShape& d) {
  const int ea = sizeof(TA), eb = sizeof(TB);
  auto aligned = [](const void* p, int v) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % v == 0;
  };
  auto width_ok = [](int v, int64_t row_bytes) {
    return is_pow2(v) && v <= 16 && row_bytes % v == 0;
  };
  bool ok =
      d.M >= 1 && d.M <= kDecodeMaxM && d.M % TM == 0 && is_pow2(d.bn) && d.bn <= 64 &&
      d.bn * eb % 16 == 0 && is_pow2(d.bk) && d.bk >= kDecodeSub && d.bk <= 512 &&
      d.bk * ea % 16 == 0 && d.stages >= 2 && d.stages <= kDecodeMaxStages &&
      d.threads >= d.M / TM * d.bn && d.threads <= kDecodeMaxThreads &&
      width_ok(d.va, static_cast<int64_t>(d.K) * ea) &&
      width_ok(d.vb, static_cast<int64_t>(d.N) * eb) && aligned(d.a, d.va) &&
      aligned(d.b, d.vb) && aligned(d.bg, d.vb) &&
      decode_smem<TA, TB, GATE, VAR>(d) <= kDecodeMaxSmem;
  if constexpr (VAR == kDecodeSparse)  // whole metadata bytes; a metadata row per copy
    ok = ok && d.K % 8 == 0 && d.bm != nullptr && (d.bgm != nullptr) == GATE &&
         width_ok(d.vm, d.N) && d.vm <= d.bn && aligned(d.bm, d.vm) && aligned(d.bgm, d.vm);
  if constexpr (VAR == kDecodeAbft)  // whole flag tiles; the checksums' own whole warps
    ok = ok && d.bn % kDecodeFlagCols == 0 && d.threads % 32 == 0 &&
         d.threads - decode_hook0(d, TM) >= 64;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// widening: a payload element to the MAC type S (exact for every type)
// ---------------------------------------------------------------------------

// int8 -> f32 without I2F (a quarter-rate conversion): 0x4B400000 is
// 1.5 * 2^23, whose mantissa takes a signed 8-bit offset exactly
__device__ __forceinline__ float s8_to_f32(int s) {
  return __int_as_float(0x4B400000 + s) - 12582912.0f;
}

// e4m3 -> f32 by moving its 7 magnitude bits under the f32 exponent (bias
// 127 - 7 = 120, subnormals included) and the sign to bit 31; S.1111.111 is
// e4m3's only NaN.  `s` is the byte sign-extended.
__device__ __forceinline__ float e4m3_to_f32(int s) {
  const float f = __uint_as_float((static_cast<unsigned>(s) << 20) & 0x87F00000u) * 0x1p120f;
  return (s & 0x7F) == 0x7F ? __uint_as_float(0x7FC00000u) : f;
}

// Element j of a 16-byte vector of TA read from shared memory, widened.
template <typename S, typename T>
__device__ __forceinline__ S widen_vec(const uint4& v, int j) {
  const unsigned w = (&v.x)[j * static_cast<int>(sizeof(T)) / 4];
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(w);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __uint_as_float(j & 1 ? w & 0xFFFF0000u : w << 16);
  } else {
    const int s = static_cast<int>(w << (24 - 8 * (j & 3))) >> 24;  // sign-extended byte
    if constexpr (std::is_same<S, int>::value)
      return s;  // int8 into the exact int32 MAC
    else if constexpr (std::is_same<T, int8_t>::value)
      return s8_to_f32(s);
    else
      return e4m3_to_f32(s);
  }
}

// A weight element as it sits in shared memory (its own width) and widened.
template <typename T>
using RawOf = typename std::conditional<
    sizeof(T) == 4, float,
    typename std::conditional<sizeof(T) == 2, uint16_t, int8_t>::type>::type;

template <typename S, typename T>
__device__ __forceinline__ S widen_raw(RawOf<T> x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  } else if constexpr (std::is_same<S, int>::value) {
    return x;  // int8 into the exact int32 MAC
  } else if constexpr (std::is_same<T, int8_t>::value) {
    return s8_to_f32(x);
  } else {
    return e4m3_to_f32(x);
  }
}

// The copies of K step `k0` into one slot, in V-byte chunks spread over the
// CTA's threads, neighbouring threads on neighbouring chunks of a row (the
// chunks per row are a power of two, so shifts index them).  A: its M rows
// of bk elements.  B (and the gate weight): bk rows of bn columns.  A chunk
// past K or N is zero filled.
template <typename TA, int V>
__device__ __forceinline__ void copy_a(unsigned char* slot, const DecodeSlot& L,
                                       const DecodeShape& d, int k0) {
  constexpr int ea = sizeof(TA);
  const int per_row = d.bk * ea / V, sh = __ffs(per_row) - 1;
  const int64_t row = static_cast<int64_t>(d.K) * ea;     // A's row bytes
  const int64_t left = row - static_cast<int64_t>(k0) * ea;  // of them from k0 on
  const unsigned char* A = static_cast<const unsigned char*>(d.a) + static_cast<int64_t>(k0) * ea;
  for (int q = threadIdx.x; q < d.M * per_row; q += blockDim.x) {
    const int m = q >> sh, o = (q & (per_row - 1)) * V;
    const bool ok = o < left;
    copy_chunk<V>(slot + m * L.a_stride + o, A + m * row + (ok ? o : 0), ok);
  }
}

template <typename TB, bool GATE, int V>
__device__ __forceinline__ void copy_b(unsigned char* slot, const DecodeSlot& L,
                                       const DecodeShape& d, int k0, int n0) {
  constexpr int eb = sizeof(TB);
  const int brow = d.bn * eb, per_row = brow / V, sh = __ffs(per_row) - 1;
  const int64_t row = static_cast<int64_t>(d.N) * eb;  // B's row bytes
  const int64_t col = static_cast<int64_t>(n0) * eb;
  const int64_t base = static_cast<int64_t>(k0) * row + col;
  const int rows_left = d.K - k0;
  const int64_t cols_left = row - col;
  const unsigned char* B = static_cast<const unsigned char*>(d.b) + base;
  unsigned char* dst0 = slot + L.a_bytes;
  for (int q = threadIdx.x; q < d.bk * per_row; q += blockDim.x) {
    const int r = q >> sh, o = (q & (per_row - 1)) * V;
    const bool ok = r < rows_left && o < cols_left;
    const int64_t g = ok ? r * row + o : 0;
    unsigned char* dst = dst0 + r * brow + o;
    copy_chunk<V>(dst, B + g, ok);
    if constexpr (GATE)
      copy_chunk<V>(dst + L.b_bytes, static_cast<const unsigned char*>(d.bg) + base + g, ok);
  }
}

// The 2:4 weight's panels of a K step: `rows` rows of `bytes` bytes (the
// payload's bk/2 rows of bn columns, or the metadata's bk/8 rows) from row
// r0 and byte `col` on of a matrix whose rows hold `row` bytes, into dst0
// (the gate weight's at dst0 + gate), as copy_b's.  (copy_b and copy_a
// keep their own bodies: folding them into this one moved the dense
// decode tile's times either way on an H100.)
template <bool GATE, int V>
__device__ __forceinline__ void copy_panel(unsigned char* dst0, int gate, const void* src,
                                           const void* src_g, int rows, int bytes, int64_t row,
                                           int r0, int64_t col, int rows_left) {
  const int per_row = bytes / V, sh = __ffs(per_row) - 1;
  const int64_t base = static_cast<int64_t>(r0) * row + col;
  const int64_t cols_left = row - col;
  const unsigned char* B = static_cast<const unsigned char*>(src) + base;
  for (int q = threadIdx.x; q < rows * per_row; q += blockDim.x) {
    const int r = q >> sh, o = (q & (per_row - 1)) * V;
    const bool ok = r < rows_left && o < cols_left;
    const int64_t g = ok ? r * row + o : 0;
    unsigned char* dst = dst0 + r * bytes + o;
    copy_chunk<V>(dst, B + g, ok);
    if constexpr (GATE)
      copy_chunk<V>(dst + gate, static_cast<const unsigned char*>(src_g) + base + g, ok);
  }
}

template <bool GATE>
__device__ __forceinline__ void copy_panel_v(int v, unsigned char* dst, int gate,
                                             const void* src, const void* src_g, int rows,
                                             int bytes, int64_t row, int r0, int64_t col,
                                             int rows_left) {
  switch (v) {
    case 16: copy_panel<GATE, 16>(dst, gate, src, src_g, rows, bytes, row, r0, col, rows_left); break;
    case 8: copy_panel<GATE, 8>(dst, gate, src, src_g, rows, bytes, row, r0, col, rows_left); break;
    case 4: copy_panel<GATE, 4>(dst, gate, src, src_g, rows, bytes, row, r0, col, rows_left); break;
    case 2: copy_panel<GATE, 2>(dst, gate, src, src_g, rows, bytes, row, r0, col, rows_left); break;
    default: copy_panel<GATE, 1>(dst, gate, src, src_g, rows, bytes, row, r0, col, rows_left);
  }
}

template <typename TA, typename TB, bool GATE, int VAR>
__device__ __forceinline__ void issue_stage(unsigned char* slot, const DecodeSlot& L,
                                            const DecodeShape& d, int k0, int n0) {
  switch (d.va) {
    case 16: copy_a<TA, 16>(slot, L, d, k0); break;
    case 8: copy_a<TA, 8>(slot, L, d, k0); break;
    case 4: copy_a<TA, 4>(slot, L, d, k0); break;
    case 2: copy_a<TA, 2>(slot, L, d, k0); break;
    default: copy_a<TA, 1>(slot, L, d, k0);
  }
  if constexpr (VAR == kDecodeSparse) {  // the payload's bk/2 rows, the metadata's bk/8
    constexpr int eb = sizeof(TB);
    unsigned char* w = slot + L.a_bytes;
    const int64_t col = static_cast<int64_t>(n0) * eb, row = static_cast<int64_t>(d.N) * eb;
    copy_panel_v<GATE>(d.vb, w, L.b_bytes, d.b, d.bg, d.bk / 2, d.bn * eb, row, k0 / 2, col,
                       (d.K - k0) / 2);
    copy_panel_v<GATE>(d.vm, w + L.p_bytes, L.b_bytes, d.bm, d.bgm, d.bk / 8, d.bn, d.N,
                       k0 / 8, n0, (d.K - k0) / 8);
  } else {
    switch (d.vb) {
      case 16: copy_b<TB, GATE, 16>(slot, L, d, k0, n0); break;
      case 8: copy_b<TB, GATE, 8>(slot, L, d, k0, n0); break;
      case 4: copy_b<TB, GATE, 4>(slot, L, d, k0, n0); break;
      case 2: copy_b<TB, GATE, 2>(slot, L, d, k0, n0); break;
      default: copy_b<TB, GATE, 1>(slot, L, d, k0, n0);
    }
  }
}

// The MACs of one staged K step for thread (column c, rows r0 .. r0+TM-1),
// in blocks of kDecodeSub rows; `chunk(k_end)` runs after each block that
// holds rows < K (the baseline's round trip).  Each group of KV rows reads
// its TM A vectors (16 bytes, a shared-memory broadcast) and its KV weights
// (and gate weights) of column c, in their own width, and widens them as
// the MACs take them; the block's trip count is a constant, so the
// unrolled groups' reads issue ahead of their MACs.
template <typename S, typename TA, typename TB, int TM, bool GATE, typename Chunk>
__device__ __forceinline__ void mac_stage(S (&acc)[TM], S (&accg)[TM],
                                          const unsigned char* slot, const DecodeSlot& L,
                                          const DecodeShape& d, int k0, int c, int r0,
                                          Chunk& chunk) {
  constexpr int KV = 16 / sizeof(TA);  // A elements per 16-byte read
  constexpr int eb = sizeof(TB);
  const int brow = d.bn * eb;  // bytes per staged B row
  const unsigned char* As = slot + r0 * L.a_stride;
  const unsigned char* Bs = slot + L.a_bytes + c * eb;
  for (int kb = 0; kb < d.bk && k0 + kb < d.K; kb += kDecodeSub) {
    const unsigned char* ap = As + kb * static_cast<int>(sizeof(TA));
    const unsigned char* bp = Bs + kb * brow;
#pragma unroll 4
    for (int g = 0; g < kDecodeSub / KV; ++g) {
      uint4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const uint4*>(ap + i * L.a_stride + g * 16);
#pragma unroll
      for (int j = 0; j < KV; ++j) {
        const unsigned char* p = bp + (g * KV + j) * brow;
        const S w = widen_raw<S, TB>(*reinterpret_cast<const RawOf<TB>*>(p));
        S wg = S(0);
        if constexpr (GATE) wg = widen_raw<S, TB>(*reinterpret_cast<const RawOf<TB>*>(p + L.b_bytes));
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const S x = widen_vec<S, TA>(av[i], j);
          acc[i] = mac(x, w, acc[i]);
          if constexpr (GATE) accg[i] = mac(x, wg, accg[i]);
        }
      }
    }
    chunk(k0 + kb + kDecodeSub);
  }
}

// Row 4h + j of a metadata byte's 8 dense weights, widened to f32:
// kernels/sparse.expand_24's (i0 == j ? p[2h] : 0) + (i1 == j ? p[2h + 1] :
// 0), nibble h of byte m holding (i0, i1).  An add, so a kept -0.0 reads
// back +0.0, as expand_24's does; the pair sums in f32, which is
// expand_24's value wherever the two indices differ (a nibble naming one
// row twice, which compress_24 never writes, sums a bf16 or int8 pair
// without its rounding or wrap).
template <typename TB>
__device__ __forceinline__ float expand_row(const RawOf<TB> (&p)[4], int m, int h, int j) {
  const int nib = m >> (4 * h), i0 = nib & 3, i1 = (nib >> 2) & 3;
  return (i0 == j ? widen_raw<float, TB>(p[2 * h]) : 0.0f) +
         (i1 == j ? widen_raw<float, TB>(p[2 * h + 1]) : 0.0f);
}

// One metadata byte's operands of thread (column c, rows r0 ..): its TM
// rows' 8 A elements, the byte and its 4 payload values (and the gate
// weight's).
template <typename TA, typename TB, int TM, bool GATE>
struct Unit24 {
  static constexpr int kRA = 8 * sizeof(TA) / 16;  // A reads per metadata byte
  uint4 av[TM][kRA];
  int m, mg;
  RawOf<TB> p[4], pg[4];

  __device__ __forceinline__ void load(const unsigned char* As, int a_stride,
                                       const unsigned char* P, const unsigned char* Mt, int prow,
                                       int bn, int gate, int u) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int r = 0; r < kRA; ++r)
        av[i][r] = *reinterpret_cast<const uint4*>(As + i * a_stride + (u * kRA + r) * 16);
    m = Mt[u * bn];
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = *reinterpret_cast<const RawOf<TB>*>(P + (4 * u + q) * prow);
    if constexpr (GATE) {
      mg = Mt[gate + u * bn];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pg[q] = *reinterpret_cast<const RawOf<TB>*>(P + gate + (4 * u + q) * prow);
    }
  }
};

// The MACs of one staged K step of the 2:4 variant, in the dense chain's
// order: per metadata byte (8 K rows) the thread reads its TM rows' A
// vectors, its column's metadata byte and 4 payload values (and the gate
// weight's), expands its 8 dense weights in registers and runs the 8 rows'
// MACs; 4 bytes unrolled, so their reads issue ahead of the chain (an
// unroll of 2 or 8, a lookup table of the nibbles' byte permutes and a
// software-pipelined read of the next byte all timed slower on the H100).
template <typename S, typename TA, typename TB, int TM, bool GATE>
__device__ __forceinline__ void mac_stage_24(S (&acc)[TM], S (&accg)[TM],
                                             const unsigned char* slot, const DecodeSlot& L,
                                             const DecodeShape& d, int k0, int c, int r0) {
  static_assert(std::is_same<S, float>::value, "the 2:4 pairs accumulate in f32");
  constexpr int KV = 16 / sizeof(TA);  // A elements per 16-byte read
  static_assert(8 % KV == 0, "a metadata byte's rows are whole A reads");
  constexpr int eb = sizeof(TB);
  using U = Unit24<TA, TB, TM, GATE>;
  const int prow = d.bn * eb;  // bytes per staged payload row
  const unsigned char* As = slot + r0 * L.a_stride;
  const unsigned char* P = slot + L.a_bytes + c * eb;
  const unsigned char* Mt = slot + L.a_bytes + L.p_bytes + c;
  // the MAC blocks of kDecodeSub rows that hold rows < K, as the dense loop's
  const int rows = min(d.bk, (d.K - k0 + kDecodeSub - 1) / kDecodeSub * kDecodeSub);
#pragma unroll 4
  for (int u = 0; u < rows / 8; ++u) {
    U x;
    x.load(As, L.a_stride, P, Mt, prow, d.bn, L.b_bytes, u);
    float w[8], wg[8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[4 * h + j] = expand_row<TB>(x.p, x.m, h, j);
        if constexpr (GATE) wg[4 * h + j] = expand_row<TB>(x.pg, x.mg, h, j);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const S a = widen_vec<S, TA>(x.av[i][j / KV], j % KV);
        acc[i] = mac(a, w[j], acc[i]);
        if constexpr (GATE) accg[i] = mac(a, wg[j], accg[i]);
      }
  }
}

// The whole K loop of one CTA's (M x bn) tile: the accumulators (type S)
// are zeroed (the C-tile reset) and stay in registers; the ring is primed
// with stages - 1 K steps, then each K step waits for its stage, passes ONE
// barrier (its stage has landed for every thread, and every thread is done
// with the slot the next copies overwrite), issues the copies of the step
// stages - 1 ahead and runs its MACs; in the ABFT variant `hook.step`
// (abft_tile.cuh's checksums) sees each staged step after them (all
// threads call it).  One group is committed per step, empty or not, so the
// wait count is constant.
template <typename S, typename TA, typename TB, int TM, bool GATE, int VAR, typename Chunk,
          typename Hook>
__device__ __forceinline__ void decode_sweep(S (&acc)[TM], S (&accg)[TM], const DecodeShape& d,
                                             int n0, int c, int r0, Chunk& chunk, Hook& hook) {
  // (the 2:4 MACs and the hook are compile-time branches of this exact
  // shape: a loop with a named slot pointer and the hook call outside them
  // ran the dense bf16 swiglu row slower on an H100, same bits)
  extern __shared__ __align__(16) unsigned char decode_ring[];  // the ring, then ABFT's scratch
  const DecodeSlot L = decode_slot<TA, TB, GATE, VAR>(d);
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = accg[i] = S(0);
  const int nk = (d.K + d.bk - 1) / d.bk;
  const bool computes = threadIdx.x < d.M / TM * d.bn;  // the rest only copy
  for (int s = 0; s < d.stages - 1; ++s) {
    if (s < nk) issue_stage<TA, TB, GATE, VAR>(decode_ring + s * L.bytes, L, d, s * d.bk, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait(d.stages - 2);
    __syncthreads();
    const int nx = kt + d.stages - 1;
    if (nx < nk)
      issue_stage<TA, TB, GATE, VAR>(decode_ring + (nx % d.stages) * L.bytes, L, d, nx * d.bk,
                                     n0);
    cp_async_commit();
    if (computes) {
      if constexpr (VAR == kDecodeSparse)
        mac_stage_24<S, TA, TB, TM, GATE>(acc, accg, decode_ring + (kt % d.stages) * L.bytes,
                                          L, d, kt * d.bk, c, r0);
      else
        mac_stage<S, TA, TB, TM, GATE>(acc, accg, decode_ring + (kt % d.stages) * L.bytes, L,
                                       d, kt * d.bk, c, r0, chunk);
    }
    if constexpr (VAR == kDecodeAbft)
      hook.step(decode_ring + (kt % d.stages) * L.bytes, L, d, kt * d.bk);
  }
  cp_async_wait(0);
}

// No round trip: the MX GEMM's accumulators never leave the registers.
struct NoChunk {
  __device__ __forceinline__ void operator()(int) const {}
};

// Launch one decode kernel instantiation with the tile d (after
// decode_check); the opt-in to the full dynamic shared memory is set once
// per (TA, TB, TM, GATE, VAR), which names one kernel within a source.
template <typename TA, typename TB, int TM, bool GATE, int VAR, typename Kernel,
          typename... KArgs>
static int decode_launch(Kernel kernel, const DecodeShape& d, cudaStream_t s, KArgs... args) {
  const int bad = decode_check<TA, TB, TM, GATE, VAR>(d);
  if (bad) return bad;
  static bool opted = false;  // per instantiation
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDecodeMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  const int smem = static_cast<int>(decode_smem<TA, TB, GATE, VAR>(d));
  const dim3 grid((d.N + d.bn - 1) / d.bn);
  kernel<<<grid, d.threads, smem, s>>>(d, args...);
  return 0;
}
