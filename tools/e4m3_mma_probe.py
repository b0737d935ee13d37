"""What sm_90a makes of the e4m3 tensor-core product, on the card (one JSON
line):

    PYTHONPATH=src python tools/e4m3_mma_probe.py

A bring-up tool, not part of the package.  It compiles one small standalone
program (one nvcc for sm_90a, into `build/e4m3_mma_probe/`) that holds two
routes of an e4m3 x e4m3 k32 step into f32, each summed from zero:

  "e4m3": mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32;
  "f16":  the route csrc/prefill_tile.cuh runs (pf_f16_frags, pf_mma8):
          every operand register widened exactly to f16 pairs by
          cvt.rn.f16x2.e4m3x2, then two m16n8k16 f16 MMAs.

It prints, per route: the HMMA, QMMA, IMMA and F2FP instructions of its
timing kernel's SASS (cuobjdump); the max distance over one m16 x n8 x k32
tile of random finite e4m3 values from their f64 product (exact in f64: 32
products of 4-bit mantissas), relative to max|ref|; and the time of a loop
of 8192 k32 steps, 4 independent ones per thread in flight, unrolled
twice, on 8 CTAs of 4 warps per SM (CUDA events, the best of 5 windows),
with the tensor operations per second that makes.  The card's name and
power limit (nvidia-smi) go beside the numbers.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "e4m3_mma_probe"

SOURCE = r'''
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cmath>

__device__ __forceinline__ unsigned cvt_f16x2(unsigned v) {  // two e4m3 -> two f16, exact
  unsigned r;
  const unsigned short h = static_cast<unsigned short>(v);
  asm volatile("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(r) : "h"(h));
  return r;
}

// t = a b over one k32 step, from zero: the e4m3 mma.sync
__device__ __forceinline__ void step_e4m3(float (&t)[4], const unsigned (&a)[4],
                                          const unsigned (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
               : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
                 "f"(0.0f));
}

__device__ __forceinline__ void mma_f16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                        unsigned a3, unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// t = a b over one k32 step, from zero: the fragments widened to f16 pairs
// (bytes 0, 1 of a register the lower pair, bytes 2, 3 the upper) for two
// m16n8k16 products that take every K once
__device__ __forceinline__ void step_f16(float (&t)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  for (int i = 0; i < 4; ++i) t[i] = 0.0f;
  mma_f16(t, cvt_f16x2(a[0]), cvt_f16x2(a[1]), cvt_f16x2(a[0] >> 16), cvt_f16x2(a[1] >> 16),
          cvt_f16x2(b[0]), cvt_f16x2(b[0] >> 16));
  mma_f16(t, cvt_f16x2(a[2]), cvt_f16x2(a[3]), cvt_f16x2(a[2] >> 16), cvt_f16x2(a[3] >> 16),
          cvt_f16x2(b[1]), cvt_f16x2(b[1] >> 16));
}

// Lane (g, c)'s m16n8k32 fragments of A (16 x 32 row-major bytes) and of B
// (8 columns of 32 K bytes each, column-major)
__device__ __forceinline__ void frags(unsigned (&a)[4], unsigned (&b)[2], const uint8_t* A,
                                      const uint8_t* Bt, int lane) {
  const int g = lane >> 2, c = lane & 3;
  auto w = [](const uint8_t* p) { return *reinterpret_cast<const unsigned*>(p); };
  a[0] = w(A + g * 32 + 4 * c);
  a[1] = w(A + (g + 8) * 32 + 4 * c);
  a[2] = w(A + g * 32 + 16 + 4 * c);
  a[3] = w(A + (g + 8) * 32 + 16 + 4 * c);
  b[0] = w(Bt + g * 32 + 4 * c);
  b[1] = w(Bt + g * 32 + 16 + 4 * c);
}

template <bool E4M3>
__global__ void tile_kernel(const uint8_t* A, const uint8_t* Bt, float* D) {
  const int lane = threadIdx.x, g = lane >> 2, c = lane & 3;
  unsigned a[4], b[2];
  frags(a, b, A, Bt, lane);
  float t[4];
  if (E4M3) step_e4m3(t, a, b); else step_f16(t, a, b);
  D[g * 8 + 2 * c] = t[0];
  D[g * 8 + 2 * c + 1] = t[1];
  D[(g + 8) * 8 + 2 * c] = t[2];
  D[(g + 8) * 8 + 2 * c + 1] = t[3];
}

constexpr int kIndep = 4;  // independent k32 steps per thread in flight

template <bool E4M3>
__global__ void loop_kernel(const uint8_t* A, const uint8_t* Bt, float* out, int iters) {
  const int lane = threadIdx.x & 31;
  unsigned a[kIndep][4], b[kIndep][2];
  for (int j = 0; j < kIndep; ++j) frags(a[j], b[j], A + 512 * j, Bt + 256 * j, lane);
  float acc[kIndep][4] = {};
#pragma unroll 2  // both routes' loops unrolled alike
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kIndep; ++j) {
      float t[4];
      if (E4M3) step_e4m3(t, a[j], b[j]); else step_f16(t, a[j], b[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += t[i];
    }
  }
  float s = 0.0f;
  for (int j = 0; j < kIndep; ++j)
    for (int i = 0; i < 4; ++i) s += acc[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

static double e4m3_value(uint8_t v) {
  const int s = v >> 7, e = (v >> 3) & 15, m = v & 7;
  const double x = e ? std::ldexp(1.0 + m / 8.0, e - 7) : std::ldexp(m / 8.0, -6);
  return s ? -x : x;
}

static uint8_t finite_e4m3(unsigned& st) {
  for (;;) {
    st = st * 1664525u + 1013904223u;
    const uint8_t v = static_cast<uint8_t>(st >> 24);
    if ((v & 0x7F) != 0x7F) return v;  // 0x7F, 0xFF: NaN
  }
}

template <bool E4M3>
static float time_loop(const uint8_t* A, const uint8_t* Bt, float* out, int blocks, int iters) {
  loop_kernel<E4M3><<<blocks, 128>>>(A, Bt, out, iters);
  cudaDeviceSynchronize();
  cudaEvent_t s0, s1;
  cudaEventCreate(&s0);
  cudaEventCreate(&s1);
  float best = 1e30f;
  for (int w = 0; w < 5; ++w) {
    cudaEventRecord(s0);
    loop_kernel<E4M3><<<blocks, 128>>>(A, Bt, out, iters);
    cudaEventRecord(s1);
    cudaEventSynchronize(s1);
    float ms;
    cudaEventElapsedTime(&ms, s0, s1);
    if (ms < best) best = ms;
  }
  return best;
}

int main() {
  const int n = 512 * kIndep;
  uint8_t hA[n], hB[n];
  unsigned st = 12345u;
  for (int i = 0; i < n; ++i) hA[i] = finite_e4m3(st);
  for (int i = 0; i < n; ++i) hB[i] = finite_e4m3(st);
  double ref[128], refmax = 0.0;
  for (int m = 0; m < 16; ++m)
    for (int j = 0; j < 8; ++j) {
      double s = 0.0;
      for (int k = 0; k < 32; ++k) s += e4m3_value(hA[m * 32 + k]) * e4m3_value(hB[j * 32 + k]);
      ref[m * 8 + j] = s;
      refmax = std::fmax(refmax, std::fabs(s));
    }
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = 8 * sms, iters = 8192;
  uint8_t *A, *Bt;
  float *D, *out;
  cudaMalloc(&A, n);
  cudaMalloc(&Bt, n);
  cudaMalloc(&D, 128 * sizeof(float));
  cudaMalloc(&out, blocks * 128 * sizeof(float));
  cudaMemcpy(A, hA, n, cudaMemcpyHostToDevice);
  cudaMemcpy(Bt, hB, n, cudaMemcpyHostToDevice);
  printf("{\"sms\": %d, \"blocks\": %d, \"threads\": 128, \"iters\": %d, \"indep\": %d, "
         "\"routes\": {", sms, blocks, iters, kIndep);
  for (int r = 0; r < 2; ++r) {
    float hD[128];
    if (r == 0) tile_kernel<true><<<1, 32>>>(A, Bt, D); else tile_kernel<false><<<1, 32>>>(A, Bt, D);
    cudaMemcpy(hD, D, sizeof(hD), cudaMemcpyDeviceToHost);
    double err = 0.0;
    for (int i = 0; i < 128; ++i) err = std::fmax(err, std::fabs(hD[i] - ref[i]));
    const float ms = r == 0 ? time_loop<true>(A, Bt, out, blocks, iters)
                            : time_loop<false>(A, Bt, out, blocks, iters);
    const double ops = 2.0 * 16 * 8 * 32 * (blocks * 4.0) * kIndep * iters;
    printf("%s\"%s\": {\"max_err_rel\": %.6e, \"ms\": %.5f, \"tops\": %.2f}", r ? ", " : "",
           r == 0 ? "e4m3" : "f16", err / refmax, ms, ops / (ms * 1e-3) / 1e12);
  }
  const cudaError_t e = cudaGetLastError();
  printf("}, \"cuda\": \"%s\"}\n", cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
'''

SASS_OPS = ("HMMA", "QMMA", "IMMA", "F2FP")


def sass_counts(cuobjdump: str, binary: Path) -> dict:
    """Per timing kernel (loop_kernel<true>: "e4m3", <false>: "f16"), its
    SASS_OPS instruction counts."""
    text = subprocess.run([cuobjdump, "-sass", str(binary)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            name = (("e4m3" if "ILb1E" in fn else "f16") if "loop_kernel" in fn else None)
            if name:
                out[name] = dict.fromkeys(SASS_OPS, 0)
        elif name and "*/" in line:
            op = line.split("*/")[1].split()
            op = op[0] if op and not op[0].startswith("@") else (op[1] if len(op) > 1 else "")
            for k in SASS_OPS:
                out[name][k] += op.startswith(k)
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    nvcc = _build._nvcc()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    src, binary = OUT / "probe.cu", OUT / "probe"
    src.write_text(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-o", str(binary), str(src)], check=True)
    run = subprocess.run([str(binary)], capture_output=True, text=True, check=True).stdout
    result = json.loads(run.strip().splitlines()[-1])
    result["sass"] = sass_counts(str(Path(nvcc).with_name("cuobjdump")), binary)
    result["device"] = smi
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
