// The Hopper (sm_90a) primitives shared by the port's tensor-core and
// streaming kernels: 16-byte (and narrower) cp.async copies into shared
// memory with their commit / wait groups, ldmatrix fragment loads, and the
// mma.sync products -- m16n8k16 bf16 and m16n8k8 TF32 into f32, with the
// split of an f32 value into a TF32 high part and its TF32 remainder for
// 3xTF32 (hi*hi + hi*lo + lo*hi, about f32's accuracy when the products
// are added to a long sum with rounding: csrc/prefill_tile.cuh pf_3xtf32),
// the m16n8k16 f16 products (e4m3 widened exactly to f16) and the s8
// m16n8k32 product into exact int32 sums.
// Included by the decode tile (csrc/decode_tile.cuh), the prefill tile
// (csrc/prefill_tile.cuh), the flash attention (csrc/mx_flash_attention.cu)
// and the paged decode / verify (csrc/mx_flash_decode.cu).
#pragma once

#include <initializer_list>

#include "common.cuh"

// ---------------------------------------------------------------------------
// copies: global -> shared, V bytes (zero filled when !ok)
// ---------------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const unsigned char* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? V : 0;  // bytes read; the rest of the V is zero filled
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else if constexpr (V == 8 || V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(V),
                 "r"(n)
                 : "memory");
  } else if constexpr (V == 2) {  // below cp.async's 4 bytes: a plain load and store
    *reinterpret_cast<uint16_t*>(dst) = ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
  } else {
    *dst = ok ? *src : 0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's committed groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// `rows` rows of `row_bytes` (a multiple of V) from src, `src_stride` bytes
// apart, into rows `dst_stride` bytes apart, spread over `nthreads` threads
// from thread `tid`; rows from `live` on are zero filled.
template <int V>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_stride,
                                          const unsigned char* src, int64_t src_stride,
                                          int row_bytes, int rows, int live, int tid,
                                          int nthreads) {
  const int per = row_bytes / V;  // chunks per row; thread t starts at chunk t
  const int dr = nthreads / per, dc = nthreads - dr * per;
  int r = tid / per, c = tid - r * per;
  while (r < rows) {
    const bool ok = r < live;
    const int o = c * V;
    copy_chunk<V>(dst + r * dst_stride + o, ok ? src + r * src_stride + o : src, ok);
    r += dr;  // the next chunk, nthreads on, without a division
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// copy_rows at a copy width v (16, 8, 4 or 2 bytes) chosen at run time
__device__ __forceinline__ void copy_rows_v(int v, unsigned char* dst, int dst_stride,
                                            const void* src, int64_t src_stride, int row_bytes,
                                            int rows, int live, int tid, int nthreads) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  switch (v) {
    case 16: copy_rows<16>(dst, dst_stride, s, src_stride, row_bytes, rows, live, tid, nthreads); break;
    case 8: copy_rows<8>(dst, dst_stride, s, src_stride, row_bytes, rows, live, tid, nthreads); break;
    case 4: copy_rows<4>(dst, dst_stride, s, src_stride, row_bytes, rows, live, tid, nthreads); break;
    default: copy_rows<2>(dst, dst_stride, s, src_stride, row_bytes, rows, live, tid, nthreads);
  }
}

// The widest copy (16, 8, 4 or 2 bytes) that divides a row of row_bytes and
// the addresses of every base pointer given.
__host__ inline int copy_width(int row_bytes, std::initializer_list<const void*> bases) {
  int v = 16;
  auto fits = [&](int w) {
    if (row_bytes % w) return false;
    for (const void* p : bases)
      if (p != nullptr && reinterpret_cast<uintptr_t>(p) % w) return false;
    return true;
  };
  while (v > 2 && !fits(v)) v /= 2;
  return v;
}

// ---------------------------------------------------------------------------
// tensor-core fragments and products
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi its TF32 rounding, lo the TF32 rounding of the rest
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, from a zero accumulator (no register to clear)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// d += a b in 3xTF32 for one k8 step (a = ah + al, b = bh + bl): lo*hi,
// hi*lo and hi*hi summed by the tensor cores from zero, then added to d with
// rounding FADDs.  The MMAs' own f32 accumulation truncates, so a running
// sum kept in it loses bits at every step (csrc/prefill_tile.cuh
// pf_3xtf32, tools/accumulation_witness.py).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  float t[4];
  mma_tf32_zero(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, from zero, f16 operands (two per register)
__device__ __forceinline__ void mma_f16_zero(float (&d)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const unsigned (&a)[4],
                                        const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b over 32 K of int8 (four per register): exact int32 sums, which
// wrap as the int32 MAC of JAX's dot_f32 would (|sum| <= K * 127^2 stays
// below 2^31 for K < 133,143, checked where the launch is built)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The two e4m3 in the low 16 bits of v as two f16 (the low byte in the low
// half): exact, since every e4m3 value (|x| <= 448, down to 2^-9) is an f16
// value.
__device__ __forceinline__ unsigned e4m3x2_f16x2(unsigned v) {
  unsigned r;
  const unsigned short h = static_cast<unsigned short>(v);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(r) : "h"(h));
  return r;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
