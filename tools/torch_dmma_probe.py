#!/usr/bin/env python3
"""The float64 tensor-core instructions (`mma.sync ... .f64`) on the card.

    python3 tools/torch_dmma_probe.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit. It compiles a small CUDA program (nvcc, sm_90a, into
build/probes/) and prints, for each float64 shape ptxas takes on sm_90a
(m8n8k4, m16n8k4, m16n8k8, m16n8k16):

  * how it rounds c + a₀b₀ + … + a_{K−1}b_{K−1}: over 20,000 draws of
    inputs of mixed magnitude with a cancelling c, how often its result
    equals an in-order chain of fused multiply-adds, the reverse chain,
    the long-double sum rounded once, and unfused products summed in
    order. K1 (csrc/riccati_backward.cu) sums its products in the order
    of its plain twin's batched products; this is what tells which
    shapes keep that order;
  * its cycles per instruction on one warp with 1 and 8 independent
    accumulators, and with 4 warps (8 each) and 16 warps (4 each) of one
    block, and the multiply-adds per cycle per SM that makes.

The card's name and power limit come first; the last line is one JSON
object with the same figures. Imports nothing of JAX.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cuda_runtime.h>
template <int K> struct Frag;
template <> struct Frag<4> {
  static __device__ void mma(double (&c)[4], const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};
template <> struct Frag<8> {
  static __device__ void mma(double (&c)[4], const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};
template <> struct Frag<16> {
  static __device__ void mma(double (&c)[4], const double* a, const double* b) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
          "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};
struct M8 {
  static __device__ void mma(double (&c)[2], double a, double b) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
        : "+d"(c[0]), "+d"(c[1]) : "d"(a), "d"(b));
  }
};
// trial r: row 0 of A = A[r*K ..], column 0 of B = B[r*K ..], c = C[r]
template <int K>
__global__ void round_k(const double* A, const double* B, const double* C, double* out, int trials) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  for (int r = 0; r < trials; ++r) {
    double a[K / 2], b[K / 4], c[4] = {g == 0 ? C[r] : 0.0, 0, 0, 0};
    // A frag: a[2i + h] = A[g + 8h][t + 4i]; B frag: b[i] = B[t + 4i][g]
    for (int i = 0; i < K / 4; ++i) {
      a[2 * i] = g == 0 ? A[r * K + t + 4 * i] : 0.0;
      a[2 * i + 1] = 0.0;
      b[i] = g == 0 ? B[r * K + t + 4 * i] : 0.0;
    }
    Frag<K>::mma(c, a, b);
    if (lane == 0) out[r] = c[0];
  }
}
__global__ void round_m8(const double* A, const double* B, const double* C, double* out, int trials) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  for (int r = 0; r < trials; ++r) {
    double c[2] = {g == 0 ? C[r] : 0.0, 0};
    M8::mma(c, g == 0 ? A[r * 4 + t] : 0.0, g == 0 ? B[r * 4 + t] : 0.0);
    if (lane == 0) out[r] = c[0];
  }
}
template <int K, int CH>
__global__ void thr(double* out, long long* cyc, int iters) {
  double c[CH][4], a[K / 2], b[K / 4];
  for (int i = 0; i < CH; ++i) for (int j = 0; j < 4; ++j) c[i][j] = threadIdx.x;
  for (int i = 0; i < K / 2; ++i) a[i] = 1.0000001 + i * 1e-9;
  for (int i = 0; i < K / 4; ++i) b[i] = 0.9999999;
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < CH; ++i) Frag<K>::mma(c[i], a, b);
  long long t1 = clock64();
  double s = 0; for (int i = 0; i < CH; ++i) s += c[i][0] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
template <int CH>
__global__ void thr_m8(double* out, long long* cyc, int iters) {
  double c[CH][2];
  for (int i = 0; i < CH; ++i) c[i][0] = c[i][1] = threadIdx.x;
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < CH; ++i) M8::mma(c[i], 1.0000001, 0.9999999);
  long long t1 = clock64();
  double s = 0; for (int i = 0; i < CH; ++i) s += c[i][0] + c[i][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
double urand() { return rand() / (double)RAND_MAX; }
template <class F> void rounding(const char* name, int K, F launch) {
  const int T = 20000;
  double *hA = new double[T * K], *hB = new double[T * K], *hC = new double[T], *hO = new double[T];
  for (int i = 0; i < T * K; ++i) { hA[i] = (urand() - 0.5) * pow(10.0, 8 * urand() - 4); hB[i] = (urand() - 0.5) * pow(10.0, 8 * urand() - 4); }
  for (int r = 0; r < T; ++r) { double s = 0; for (int k = 0; k < K; ++k) s += hA[r * K + k] * hB[r * K + k]; hC[r] = -s * (1 + 1e-12 * (urand() - 0.5)); }
  double *A, *B, *C, *O; cudaMalloc(&A, 8 * T * K); cudaMalloc(&B, 8 * T * K); cudaMalloc(&C, 8 * T); cudaMalloc(&O, 8 * T);
  cudaMemcpy(A, hA, 8 * T * K, cudaMemcpyHostToDevice); cudaMemcpy(B, hB, 8 * T * K, cudaMemcpyHostToDevice); cudaMemcpy(C, hC, 8 * T, cudaMemcpyHostToDevice);
  launch(A, B, C, O, T);
  cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(hO, O, 8 * T, cudaMemcpyDeviceToHost);
  int fwd = 0, rev = 0, exact = 0, sep = 0;
  for (int r = 0; r < T; ++r) {
    double f = hC[r]; for (int k = 0; k < K; ++k) f = fma(hA[r * K + k], hB[r * K + k], f);
    double v = hC[r]; for (int k = K - 1; k >= 0; --k) v = fma(hA[r * K + k], hB[r * K + k], v);
    long double x = hC[r]; for (int k = 0; k < K; ++k) x += (long double)hA[r * K + k] * hB[r * K + k];
    double sp = hC[r]; for (int k = 0; k < K; ++k) sp = sp + hA[r * K + k] * hB[r * K + k];
    fwd += hO[r] == f; rev += hO[r] == v; exact += hO[r] == (double)x; sep += hO[r] == sp;
  }
  printf("%s rounding (%s): equal to in-order FMA chain %d/%d, reverse chain %d, long-double sum %d, unfused in order %d\n",
         name, cudaGetErrorString(e), fwd, T, rev, exact, sep);
}
template <int K, int CH> void throughput(int blocks, int warps) {
  double* o; long long* c; cudaMalloc(&o, 8 * blocks * warps * 32); cudaMalloc(&c, 8 * blocks);
  const int iters = 256;
  thr<K, CH><<<blocks, warps * 32>>>(o, c, iters); thr<K, CH><<<blocks, warps * 32>>>(o, c, iters);
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) {
    printf("m16n8k%d: %d warp(s), %d chain(s): %s\n", K, warps, CH, cudaGetErrorString(e));
    return;
  }
  long long h; cudaMemcpy(&h, c, 8, cudaMemcpyDeviceToHost);
  const double per = h / double(iters * CH);
  printf("m16n8k%d: %d warp(s), %d chain(s): %.2f cycles per instruction per warp, %.1f FMA/cycle/SM\n",
         K, warps, CH, per, warps * 16.0 * 8 * K / per);
}
template <int CH> void throughput_m8(int warps) {
  double* o; long long* c; cudaMalloc(&o, 8 * warps * 32); cudaMalloc(&c, 8);
  const int iters = 256;
  thr_m8<CH><<<1, warps * 32>>>(o, c, iters); thr_m8<CH><<<1, warps * 32>>>(o, c, iters);
  cudaDeviceSynchronize();
  long long h; cudaMemcpy(&h, c, 8, cudaMemcpyDeviceToHost);
  const double per = h / double(iters * CH);
  printf("m8n8k4: %d warp(s), %d chain(s): %.2f cycles per instruction per warp, %.1f FMA/cycle/SM\n",
         warps, CH, per, warps * 8.0 * 8 * 4 / per);
}
int main() {
  rounding("m8n8k4", 4, [](double* A, double* B, double* C, double* O, int T) { round_m8<<<1, 32>>>(A, B, C, O, T); });
  rounding("m16n8k4", 4, [](double* A, double* B, double* C, double* O, int T) { round_k<4><<<1, 32>>>(A, B, C, O, T); });
  rounding("m16n8k8", 8, [](double* A, double* B, double* C, double* O, int T) { round_k<8><<<1, 32>>>(A, B, C, O, T); });
  rounding("m16n8k16", 16, [](double* A, double* B, double* C, double* O, int T) { round_k<16><<<1, 32>>>(A, B, C, O, T); });
  throughput_m8<1>(1); throughput_m8<8>(1); throughput_m8<8>(4); throughput_m8<4>(16);
  // 16 warps of 8 accumulators each exceed the registers of an SM: 4 each
  throughput<4, 1>(1, 1); throughput<4, 8>(1, 1); throughput<4, 8>(1, 4); throughput<4, 4>(1, 16);
  throughput<8, 1>(1, 1); throughput<8, 8>(1, 1); throughput<8, 8>(1, 4); throughput<8, 4>(1, 16);
  throughput<16, 1>(1, 1); throughput<16, 8>(1, 1); throughput<16, 8>(1, 4); throughput<16, 4>(1, 16);
  return 0;
}
"""


def main():
    from srbd_horizon_tpu_torch.kernels.build import nvcc_path

    out_dir = ROOT / "build" / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, exe = out_dir / "dmma_probe.cu", out_dir / "dmma_probe"
    src.write_text(SOURCE)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", str(exe), str(src)],
                   check=True)
    text = subprocess.run([str(exe)], capture_output=True, text=True,
                          check=True).stdout
    print(text, end="", flush=True)
    rounding, rate = {}, {}
    for m in re.finditer(r"^(m\d+n8k\d+) rounding \((.*?)\): equal to in-order "
                         r"FMA chain (\d+)/(\d+), reverse chain (\d+), "
                         r"long-double sum (\d+), unfused in order (\d+)$",
                         text, re.M):
        rounding[m.group(1)] = dict(
            status=m.group(2), draws=int(m.group(4)),
            fma_chain_in_order=int(m.group(3)), fma_chain_reversed=int(m.group(5)),
            exact_then_rounded=int(m.group(6)), unfused_in_order=int(m.group(7)))
    for m in re.finditer(r"^(m\d+n8k\d+): (\d+) warp\(s\), (\d+) chain\(s\): "
                         r"([\d.]+) cycles per instruction per warp, "
                         r"([\d.]+) FMA/cycle/SM$", text, re.M):
        rate[f"{m.group(1)} warps={m.group(2)} chains={m.group(3)}"] = dict(
            cycles_per_instruction=float(m.group(4)),
            fma_per_cycle_per_sm=float(m.group(5)))
    if not rounding or not rate:
        sys.exit("torch_dmma_probe: no result parsed")
    print(json.dumps({"rounding": rounding, "rate": rate}))


if __name__ == "__main__":
    main()
