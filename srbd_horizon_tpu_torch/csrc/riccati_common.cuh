// Device routines shared by the Riccati kernels: K1's blocksparse sweep
// (riccati_backward.cu) and K12's associative scan (riccati_associative.cu).
//
// The one-warp FP64 tensor-core tiles (mma.sync m16n8k4 f64, dmma.cuh)
// every dense product of a K1 node runs on, and the two gain solves: K2,
// the block-Schur SPD inverse of `lm_spd_inverse`, and the Cholesky factor
// and its substitutions. Everything here was K1's and compiles for K1 to
// the code it had; K12 takes the inverse and the Cholesky routine as they
// are, so its solves round as K1's do.

#pragma once

#include <cuda_runtime.h>

#include "dmma.cuh"

namespace {

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// ---- the compile-time shapes of K1 and K12 ----
// kernels/riccati.py::KERNEL_SHAPES holds the same sizes in the same order
// (tests/test_torch_riccati_shapes.py reads them from here): nx, nu, the
// terminal rows nt and the sizes of the row sets. `min_blocks` is K1's
// launch bound (blocks an SM); K12 does not read it.

struct SrbdShape {          // build_srbd_problem
  static constexpr int nx = 37, nu = 24, nt = 15, n_rx = 22, n_ru = 18,
                       n_gx = 34, n_gu = 42, n_b = 3, n_uc = 24;
  static constexpr int min_blocks = 4;
};

struct IsrbdAlShape {       // the AL inner OCP of build_isrbd_problem
  static constexpr int nx = 37, nu = 30, nt = 101, n_rx = 19, n_ru = 37,
                       n_gx = 60, n_gu = 103, n_b = 9, n_uc = 18;
  static constexpr int min_blocks = 3;
};

struct LipShape {           // build_lip_problem
  static constexpr int nx = 30, nu = 15, nt = 10, n_rx = 18, n_ru = 15,
                       n_gx = 32, n_gu = 18, n_b = 6, n_uc = 15;
  static constexpr int min_blocks = 4;
};

struct QuadShape {          // build_srbd_problem on the point-feet quadruped
  static constexpr int nx = 37, nu = 24, nt = 15, n_rx = 22, n_ru = 18,
                       n_gx = 30, n_gu = 42, n_b = 3, n_uc = 24;
  static constexpr int min_blocks = 4;
};

struct QuadAlShape {        // the AL inner OCP of build_isrbd_problem on it
  static constexpr int nx = 37, nu = 30, nt = 97, n_rx = 19, n_ru = 37,
                       n_gx = 56, n_gu = 103, n_b = 9, n_uc = 18;
  static constexpr int min_blocks = 3;
};

struct PointFeetShape {     // build_srbd_problem on the point-feet biped
  static constexpr int nx = 25, nu = 12, nt = 15, n_rx = 16, n_ru = 12,
                       n_gx = 24, n_gu = 24, n_b = 3, n_uc = 12;
  static constexpr int min_blocks = 4;
};

// build_srbd_problem under RK2 or RK4 (the two steps share a shape): every
// row of B is live
struct SrbdRkShape {        // the Kangaroo
  static constexpr int nx = 37, nu = 24, nt = 15, n_rx = 22, n_ru = 37,
                       n_gx = 34, n_gu = 42, n_b = 3, n_uc = 24;
  static constexpr int min_blocks = 4;
};

struct QuadRkShape {        // the point-feet quadruped
  static constexpr int nx = 37, nu = 24, nt = 15, n_rx = 22, n_ru = 37,
                       n_gx = 30, n_gu = 42, n_b = 3, n_uc = 24;
  static constexpr int min_blocks = 4;
};

struct PointFeetRkShape {   // the point-feet biped
  static constexpr int nx = 25, nu = 12, nt = 15, n_rx = 16, n_ru = 25,
                       n_gx = 24, n_gu = 24, n_b = 3, n_uc = 12;
  static constexpr int min_blocks = 4;
};

// build_lip_problem at the other topologies and steps: under RK2 and RK4
// (which share a shape) every row of B is live
struct LipRkShape {         // the Kangaroo's line feet under RK
  static constexpr int nx = 30, nu = 15, nt = 10, n_rx = 18, n_ru = 30,
                       n_gx = 32, n_gu = 18, n_b = 6, n_uc = 15;
  static constexpr int min_blocks = 4;
};

struct LipQuadShape {       // the point-feet quadruped
  static constexpr int nx = 30, nu = 15, nt = 10, n_rx = 18, n_ru = 15,
                       n_gx = 28, n_gu = 18, n_b = 6, n_uc = 15;
  static constexpr int min_blocks = 4;
};

struct LipQuadRkShape {     // the point-feet quadruped under RK
  static constexpr int nx = 30, nu = 15, nt = 10, n_rx = 18, n_ru = 30,
                       n_gx = 28, n_gu = 18, n_b = 6, n_uc = 15;
  static constexpr int min_blocks = 4;
};

struct LipPointFeetShape {  // the point-feet biped
  static constexpr int nx = 18, nu = 9, nt = 10, n_rx = 12, n_ru = 9,
                       n_gx = 22, n_gu = 12, n_b = 6, n_uc = 9;
  static constexpr int min_blocks = 4;
};

struct LipPointFeetRkShape {  // the point-feet biped under RK
  static constexpr int nx = 18, nu = 9, nt = 10, n_rx = 12, n_ru = 18,
                       n_gx = 22, n_gu = 12, n_b = 6, n_uc = 9;
  static constexpr int min_blocks = 4;
};

// The square-feet biped (contact_model=4, nc=8): build_srbd_problem
// (nx=61, nu=48) and build_lip_problem (nx=54, nu=27), each under Euler
// and under RK (which share a shape). A block takes 96,964-226,244 B of
// shared memory (riccati_backward.cu's Layout): one or two an SM.
struct SquareFeetShape {
  static constexpr int nx = 61, nu = 48, nt = 15, n_rx = 34, n_ru = 30,
                       n_gx = 54, n_gu = 78, n_b = 3, n_uc = 48;
  static constexpr int min_blocks = 1;
};

struct SquareFeetRkShape {
  static constexpr int nx = 61, nu = 48, nt = 15, n_rx = 34, n_ru = 61,
                       n_gx = 54, n_gu = 78, n_b = 3, n_uc = 48;
  static constexpr int min_blocks = 1;
};

struct LipSquareFeetShape {
  static constexpr int nx = 54, nu = 27, nt = 10, n_rx = 30, n_ru = 27,
                       n_gx = 52, n_gu = 30, n_b = 6, n_uc = 27;
  static constexpr int min_blocks = 1;
};

struct LipSquareFeetRkShape {
  static constexpr int nx = 54, nu = 27, nt = 10, n_rx = 30, n_ru = 54,
                       n_gx = 52, n_gu = 30, n_b = 6, n_uc = 27;
  static constexpr int min_blocks = 1;
};

// The line-feet quadruped (contact_model=2 on four legs, nc=8): the square
// feet's nx and nu, four fewer rows of G (its relative-velocity rows are 8,
// not 12). A block takes 158,328 B (collapsed, float32 tensors) to
// 224,244 B (RK, float64), the LIP's 96,068 to 131,368 B
// (riccati_backward.cu's Layout).
struct LineFeetQuadShape {
  static constexpr int nx = 61, nu = 48, nt = 15, n_rx = 34, n_ru = 30,
                       n_gx = 50, n_gu = 78, n_b = 3, n_uc = 48;
  static constexpr int min_blocks = 1;
};

struct LineFeetQuadRkShape {
  static constexpr int nx = 61, nu = 48, nt = 15, n_rx = 34, n_ru = 61,
                       n_gx = 50, n_gu = 78, n_b = 3, n_uc = 48;
  static constexpr int min_blocks = 1;
};

struct LipLineFeetQuadShape {
  static constexpr int nx = 54, nu = 27, nt = 10, n_rx = 30, n_ru = 27,
                       n_gx = 48, n_gu = 30, n_b = 6, n_uc = 27;
  static constexpr int min_blocks = 1;
};

struct LipLineFeetQuadRkShape {
  static constexpr int nx = 54, nu = 27, nt = 10, n_rx = 30, n_ru = 54,
                       n_gx = 48, n_gu = 30, n_b = 6, n_uc = 27;
  static constexpr int min_blocks = 1;
};

// Float64 workspace of the block-Schur inverse of an n×n matrix.
__host__ __device__ constexpr int inv_work(int n) {
  return n <= 3 ? 0
                : (n / 2) * (n - n / 2) * 2 + (n - n / 2) * (n - n / 2) +
                      cmax(inv_work(n / 2), inv_work(n - n / 2));
}

template <typename T>
__device__ __forceinline__ double wide(T v) {
  return static_cast<double>(v);
}

// Σ_k f(k) over a compile-time depth, in order of k (the twin's order).
template <int K, class F>
__device__ __forceinline__ double dot(F f) {
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) s += f(k);
  return s;
}

// A tile's accumulators: c[p] is the tile of product p. A node's Q terms
// each add two products, which stay apart until the twin adds them, in
// the twin's order: with Quu's conditioning the gains feel the order of
// every sum.
struct Acc {
  double c[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
};

// acc.c[P] += A·B over a compile-time depth K on one warp, four at a time
// on the FP64 tensor cores, in order of depth: a(i, k) is A's row i at
// depth k, fed for this lane's rows i0 and i1, b(k) its B column. Past
// the depth both operands are zero (read at K−1, then replaced), so a
// non-finite value there cannot leak in.
template <int K, int P = 0, class FA, class FB>
__device__ __forceinline__ void mma_seg(Acc& acc, FA a, int i0, int i1, FB b) {
  const int t = threadIdx.x & 3;
  constexpr int full = K / 4 * 4;
#pragma unroll
  for (int k0 = 0; k0 < full; k0 += 4)
    dmma_m16n8k4(acc.c[P], a(i0, k0 + t), a(i1, k0 + t), b(k0 + t));
  if constexpr (full < K) {
    const bool in = full + t < K;
    const int k = in ? full + t : K - 1;
    const double a0 = a(i0, k), a1 = a(i1, k), bv = b(k);
    dmma_m16n8k4(acc.c[P], in ? a0 : 0.0, in ? a1 : 0.0, in ? bv : 0.0);
  }
}

template <int M, int N>
struct Tiles {
  static constexpr int cols = (N + 7) / 8, count = (M + 15) / 16 * cols;
};

// One 16×8 tile (`item`, row-major over the tiles) of an M×N product on
// one warp. tile_acc: body(acc, ia0, ia1, jb) accumulates it, where ia0
// and ia1 are the A rows g and g + 8 of the tile and jb the B column this
// lane feeds (each clamped into the matrix: the rows and columns past the
// edge are computed and dropped). tile_store: epi(i, j, v, w) takes each
// element inside the matrix, v of product 0 and w of product 1.
template <int M, int N, class Body>
__device__ __forceinline__ void tile_acc(int item, Acc& acc, Body body) {
  const int g = (threadIdx.x & 31) >> 2;
  const int r = item / Tiles<M, N>::cols * 16 + g;
  body(acc, imin(r, M - 1), imin(r + 8, M - 1),
       imin(item % Tiles<M, N>::cols * 8 + g, N - 1));
}

template <int M, int N, class Epi>
__device__ __forceinline__ void tile_store(int item, const Acc& acc, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int i = item / Tiles<M, N>::cols * 16 + (lane >> 2);
  const int j = item % Tiles<M, N>::cols * 8 + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (i + 8 * h < M) {
      if (j < N) epi(i + 8 * h, j, acc.c[0][2 * h], acc.c[1][2 * h]);
      if (j + 1 < N)
        epi(i + 8 * h, j + 1, acc.c[0][2 * h + 1], acc.c[1][2 * h + 1]);
    }
}

// Every tile of an M×N product, and of a second P×Q one, on the calling
// warp alone: all accumulated before any is stored, so that no tile's
// loads wait behind another's stores.
template <int M, int N, int P, int Q, class Body1, class Epi1, class Body2,
          class Epi2>
__device__ __forceinline__ void warp_tiles(Body1 body1, Epi1 epi1, Body2 body2,
                                           Epi2 epi2) {
  constexpr int c1 = Tiles<M, N>::count, c2 = Tiles<P, Q>::count;
  Acc acc[c1 + c2 > 0 ? c1 + c2 : 1];
#pragma unroll
  for (int item = 0; item < c1; ++item) tile_acc<M, N>(item, acc[item], body1);
#pragma unroll
  for (int item = 0; item < c2; ++item)
    tile_acc<P, Q>(item, acc[c1 + item], body2);
#pragma unroll
  for (int item = 0; item < c1; ++item) tile_store<M, N>(item, acc[item], epi1);
#pragma unroll
  for (int item = 0; item < c2; ++item)
    tile_store<P, Q>(item, acc[c1 + item], epi2);
}

template <int M, int N, class Body, class Epi>
__device__ __forceinline__ void warp_tiles(Body body, Epi epi) {
  warp_tiles<M, N, 0, 0>(body, epi, body, epi);
}

// B = ½(B + Bᵀ) for the N×N block at B (leading dim LD), by `ranks`
// threads of which this is `rank`: every value read before any is written.
template <int N, int LD, int Ranks>
__device__ __forceinline__ void symmetrize(double* B, int rank) {
  constexpr int iters = (N * N + Ranks - 1) / Ranks;
  double v[iters];
#pragma unroll
  for (int it = 0; it < iters; ++it) {
    const int e = rank + it * Ranks, i = e / N, j = e % N;
    v[it] = e < N * N && i < j ? 0.5 * (B[i * LD + j] + B[j * LD + i]) : 0.0;
  }
#pragma unroll
  for (int it = 0; it < iters; ++it) {
    const int e = rank + it * Ranks, i = e / N, j = e % N;
    if (e < N * N && i < j) {
      B[i * LD + j] = v[it];
      B[j * LD + i] = v[it];
    }
  }
}

// ---- K2: the block-Schur SPD inverse on one warp ----

// Entry (r, c) of the closed-form inverse of an n×n block, n ≤ 3, as
// `_lm_inv2`/`_lm_inv3` form it (adjugate over the determinant). Every
// product is rounded before it is added, as the twin's elementwise
// operations round it: contracted into a fused multiply-add, the leaves
// move the gains by ~5e-10 relative at Quu's conditioning.
template <int N, int LDA>
__device__ __forceinline__ double inv_closed_entry(const double* A, int r,
                                                   int c) {
  if constexpr (N == 1) {
    return 1.0 / A[0];
  } else if constexpr (N == 2) {
    const double a = A[0], b = A[1], cc = A[LDA], d = A[LDA + 1];
    const double det = __dsub_rn(__dmul_rn(a, d), __dmul_rn(b, cc));
    const double num = r == 0 ? (c == 0 ? d : -b) : (c == 0 ? -cc : a);
    return num / det;
  } else {
    // adj[r][c] = A[c+1][r+1]·A[c+2][r+2] − A[c+1][r+2]·A[c+2][r+1]
    // (indices mod 3), the cofactor products `_lm_inv3` writes out
    auto a = [&](int i, int j) { return A[(i % 3) * LDA + (j % 3)]; };
    auto cof = [](double w, double x, double y, double z) {   // w·x − y·z
      return __dsub_rn(__dmul_rn(w, x), __dmul_rn(y, z));
    };
    const double c00 = cof(a(1, 1), a(2, 2), a(1, 2), a(2, 1));
    const double c10 = cof(a(1, 2), a(2, 0), a(1, 0), a(2, 2));
    const double c20 = cof(a(1, 0), a(2, 1), a(1, 1), a(2, 0));
    const double det = __dadd_rn(
        __dadd_rn(__dmul_rn(A[0], c00), __dmul_rn(A[1], c10)),
        __dmul_rn(A[2], c20));
    const double adj =
        cof(a(c + 1, r + 1), a(c + 2, r + 2), a(c + 1, r + 2), a(c + 2, r + 1));
    return adj / det;
  }
}

// out = A⁻¹ for SPD A (N×N, leading dims LDA/LDO) on the calling warp:
//   iA11 = A11⁻¹,  T1 = iA11 A12,  T2 = A21 iA11,  S = A22 − A21 T1,
//   iS = S⁻¹,  B12 = −T1 iS,  B11 = iA11 − B12 T2,  B21 = B12ᵀ,
//   out = ½(B + Bᵀ),
// with k = N/2 and closed forms at N ≤ 3, as `lm_spd_inverse` does it.
// `work` holds inv_work(N) doubles.
template <int N, int LDA, int LDO>
__device__ __forceinline__ void spd_inverse_warp(const double* A, double* out,
                                                 double* work) {
  const int lane = threadIdx.x & 31;
  if constexpr (N <= 3) {
    if (lane < N * N)
      out[lane / N * LDO + lane % N] =
          inv_closed_entry<N, LDA>(A, lane / N, lane % N);
    __syncwarp();
  } else {
    constexpr int k = N / 2, m = N - k;
    const double* A12 = A + k;
    const double* A21 = A + k * LDA;
    const double* A22 = A21 + k;
    double* T1 = work;         // k×m
    double* S = T1 + k * m;    // m×m
    double* T2 = S + m * m;    // m×k
    double* next = T2 + m * k;
    double* O11 = out;
    double* O12 = out + k;
    double* O21 = out + k * LDO;
    double* O22 = O21 + k;
    spd_inverse_warp<k, LDA, LDO>(A, O11, next);
    warp_tiles<k, m, m, k>(
        [&](Acc& c, int ia0, int ia1, int jb) {
          mma_seg<k>(c, [&](int ia, int l) { return O11[ia * LDO + l]; },
                     ia0, ia1, [&](int l) { return A12[l * LDA + jb]; });
        },
        [&](int i, int j, double v, double) { T1[i * m + j] = v; },
        [&](Acc& c, int ia0, int ia1, int jb) {
          mma_seg<k>(c, [&](int ia, int l) { return A21[ia * LDA + l]; },
                     ia0, ia1, [&](int l) { return O11[l * LDO + jb]; });
        },
        [&](int i, int j, double v, double) { T2[i * k + j] = v; });
    __syncwarp();
    warp_tiles<m, m>(
        [&](Acc& c, int ia0, int ia1, int jb) {
          mma_seg<k>(c, [&](int ia, int l) { return A21[ia * LDA + l]; },
                     ia0, ia1, [&](int l) { return T1[l * m + jb]; });
        },
        [&](int i, int j, double v, double) {
          S[i * m + j] = A22[i * LDA + j] - v;
        });
    __syncwarp();
    spd_inverse_warp<m, m, LDO>(S, O22, next);
    // B12 = −T1 iS, and B21 = B12ᵀ beside it
    warp_tiles<k, m>(
        [&](Acc& c, int ia0, int ia1, int jb) {
          mma_seg<m>(c, [&](int ia, int l) { return T1[ia * m + l]; },
                     ia0, ia1, [&](int l) { return O22[l * LDO + jb]; });
        },
        [&](int i, int j, double v, double) {
          O12[i * LDO + j] = -v;
          O21[j * LDO + i] = -v;
        });
    __syncwarp();
    warp_tiles<k, k>(
        [&](Acc& c, int ia0, int ia1, int jb) {
          mma_seg<m>(c, [&](int ia, int l) { return O12[ia * LDO + l]; },
                     ia0, ia1, [&](int l) { return T2[l * k + jb]; });
        },
        [&](int i, int j, double v, double) {
          O11[i * LDO + j] = O11[i * LDO + j] - v;
        });
    __syncwarp();
    // out = ½(out + outᵀ): the B12/B21 blocks are each other's transpose,
    // and an iS of more than 3 rows was symmetrized at its own level, so
    // only B11 (and a closed-form iS) change; the rest would come out
    // bit for bit as they are
    symmetrize<k, LDO, 32>(O11, lane);
    if constexpr (m <= 3) symmetrize<m, LDO, 32>(O22, lane);
    __syncwarp();
  }
}

// L (lower, row-major, N×N) with A = L Lᵀ for SPD A (leading dim N) on the
// calling warp, N ≤ 64: column j at a time, the lane of row i ≥ j (rows
// lane and lane + 32) forms s = A[i][j] − Σ_{k<j} L[i][k] L[j][k] in order
// of k; row j's s is the pivot, L[j][j] = √s, and L[i][j] = s / L[j][j]
// below it. A pivot that is not positive, or NaN, makes the whole lower
// triangle NaN.
template <int N>
__device__ __forceinline__ void cholesky_warp(const double* A, double* L) {
  static_assert(N <= 64, "up to two rows a lane");
  constexpr int R = (N + 31) / 32;                 // rows a lane
  const int lane = threadIdx.x & 31;
  bool bad = false;
  for (int j = 0; j < N; ++j) {
    double s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      s[r] = 0.0;
      if (i >= j && i < N) {
        s[r] = A[i * N + j];
        for (int k = 0; k < j; ++k) s[r] -= L[i * N + k] * L[j * N + k];
      }
    }
    double pivot = __shfl_sync(0xffffffffu, s[0], j & 31);
    if constexpr (R > 1) {
      const double p1 = __shfl_sync(0xffffffffu, s[1], j & 31);
      pivot = j < 32 ? pivot : p1;
    }
    bad |= !(pivot > 0.0);
    const double dj = sqrt(pivot);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      if (i < N) L[i * N + j] = i < j ? 0.0 : i == j ? dj : s[r] / dj;
    }
    __syncwarp();
  }
  if (bad) {
    for (int e = lane; e < N * N; e += 32)
      if (e % N <= e / N) L[e] = __longlong_as_double(0x7ff8000000000000LL);
    __syncwarp();
  }
}

// x ← A⁻¹ x from A's factor L (cholesky_warp) for one right-hand side of
// the calling thread, in place in shared memory (entry i at x[i·ld]):
// L y = x, then Lᵀ x = y, each in order of row.
template <int N>
__device__ __forceinline__ void cholesky_solve(const double* L, double* x,
                                               int ld) {
  for (int i = 0; i < N; ++i) {
    double s = x[i * ld];
    for (int k = 0; k < i; ++k) s -= L[i * N + k] * x[k * ld];
    x[i * ld] = s / L[i * N + i];
  }
  for (int i = N - 1; i >= 0; --i) {
    double s = x[i * ld];
    for (int k = i + 1; k < N; ++k) s -= L[k * N + i] * x[k * ld];
    x[i * ld] = s / L[i * N + i];
  }
}


}  // namespace
