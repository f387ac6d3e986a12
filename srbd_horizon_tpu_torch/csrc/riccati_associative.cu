// K12 — the backward value recursion of the MS-DDP solve as an associative
// scan (`riccati_mode="associative"`), then the gains.
//
// Replaces: `MSDDP._backward_associative`
// (srbd_horizon_tpu/solvers/msddp.py:1250-1387), which XLA fused on the TPU
// (the JAX package wrote no Pallas kernel for it). Plain twin:
// `kernels/riccati_associative.py::riccati_associative_plain`. Per member,
// from the sliced linearization K1 reads (Sx = (A − I)[rx], Bs = B[ru][:, uc],
// the residual rows gx/gu, ρ, d, Jt, rt):
//   1. elements, a (member, node) a block: the Gauss–Newton quadratics,
//      R̃ = luu + μI solved against [lu | lux | Bᵀ] (K2's block-Schur
//      inverse or K1's Cholesky routine, riccati_common.cuh), then
//          A_e = A − B R̃⁻¹lux    J = lxx − luxᵀR̃⁻¹lux   η = lx − luxᵀR̃⁻¹lu
//          b = d − B R̃⁻¹lu       C = B R̃⁻¹Bᵀ
//      and the terminal element (0, 0, 0, Vx_T = 2Jtᵀrt, Vxx_T = 2JtᵀJt);
//   2. the suffix scan: JAX's `lax.associative_scan(..., reverse=True)`
//      tree of 34 combines for ns = 20 (its odd/even recursion,
//      `kernels/riccati_associative.py::scan_plan`), a combine a block,
//      every combine whose operands are ready in one launch: the tree's
//      dependency depth is 6 (10, 6, 4, 5, 6 and 3 combines). A combine
//      (e₁ earlier, e₂ later) solves (I + C₁J₂) M = [A₁ | C₁ | b₁ − C₁η₂]
//      by Gaussian elimination with partial pivoting (LAPACK's getrf
//      choice of pivot: the first largest |entry|) and back substitution,
//      then forms
//          A = A₂MA₁   b = A₂Mb + b₂   C = (A₂MC₁)A₂ᵀ + C₂
//          η = MA₁ᵀ(η₂ + J₂b₁) + η₁    J = A₁ᵀ(J₂MA₁) + J₁;
//   3. gains, a (member, node) a block, from V at n+1 (the suffix's J, η):
//          Qu = lu + BᵀVx_d   Qux = lux + Bᵀ(V A)   Quu = R̃ + Bᵀ(V B)
//          [k K] = −Quu⁻¹[Qu Qux]   (the same gain solve as 1)
//      and ΔV₁ = Σₙ kᵀQu, ΔV₂ = ½ Σₙ kᵀQuu k, summed over the nodes in
//      order by the member's last block to finish.
// One launch a phase and one a scan stage: 8 a sweep at ns = 20.
//
// Instantiations (`with_instance`): K1's nine shapes, with both gain
// solves at the seven SRBD and LIP ones (the point-feet biped, and each
// SRBD topology under RK2/RK4, whose two steps share K1's shape) and with
// the Cholesky solve alone at the two isrbd-AL shapes (the AL solver
// always asks its inner solver for Cholesky). The AL shapes' element and
// gain blocks are the largest (~117 KB and ~84 KB of shared memory): nu =
// 30 and the 103 Gauss–Newton rows of u, with a terminal stack of 101 / 97
// rows. Under RK every row of B is live (n_ru = nx), which only widens the
// staged Bs; the combine depends on nx alone.
//
// The dense A = I + Sx at rx and B = Bs at (ru, uc) are never formed: every
// product with them runs over the live rows and columns only, where the
// twin's dense products add exact zeros.
//
// Precision: float64 on chip for float32 and float64 tensors alike, as K1;
// the elements live in a float64 workspace the wrapper allocates. Sums run
// in another order than the twin's (CPU BLAS) and the pivoted solve is not
// LAPACK's blocked one, so the two agree to rounding amplified by the
// conditioning of R̃, Quu and (I + C₁J₂), not bit for bit.
//
// What bounds it on an H100: the float64 arithmetic of the combines. At
// nx = 37 a combine is ~17·nx³ ≈ 0.86 MFLOP (six nx³ products, the
// elimination of nx rows across 3nx+1 columns, 2nx+1 substitutions); the
// 34 of a member take ~29 MFLOP against ~1.4 MFLOP of the sequential sweep
// (K1), and each moves three 33 KB records through device memory.
// chip_smoke.py computes the bound from its own inputs. At B=1 the 20
// dependent nodes of K1 become 6 dependent stages here; at fleet sizes the
// scan's 20× more arithmetic sets the time.
//
// Design: plain FMA loops a thread an output, the blocks' operands staged
// in shared memory in float64 (the element and gain blocks reuse K1's
// one-warp inverse and Cholesky factor on the FP64 tensor cores). A simple
// kernel first: no tensor-core tiles in the combines yet.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

#include "riccati_common.cuh"

namespace {

constexpr int kThreads = 128;            // element and gain blocks
constexpr int kCombineThreads = 256;
constexpr int kUnknownShape = -2;        // kernels/riccati_associative.py
constexpr int kSmemExceeded = -1;

// the gain solve (kernels/riccati_associative.py::QUU_SOLVERS)
enum class Solve { kSchur, kCholesky };

// The shape structs are K1's (riccati_common.cuh); the combine kernel is
// templated on nx, so the shapes of one nx share it (37: six shapes;
// 25: the point-feet biped's two; 30: the LIP).

// One element's float64 record in the workspace: A, C, J (nx×nx), b, η.
template <int nx>
struct Elem {
  static constexpr int A = 0, C = nx * nx, J = 2 * nx * nx, b = 3 * nx * nx,
                       eta = b + nx, size = eta + nx;
};

// A (member, node)'s float64 gain record, written by phase 1 for phase 3:
// lu, lux, R̃ = luu + μI.
template <class S>
struct GainRec {
  static constexpr int lu = 0, lux = S::nu, Rt = lux + S::nu * S::nx,
                       size = Rt + S::nu * S::nu;
};

// The row table (rx | ru | gx | gu | bx | bu | uc, as RiccatiRows.packed),
// then each input's position in uc, each state row's in rx and in ru (or
// −1), in shared memory.
template <class S>
struct Rows {
  static constexpr int n_table = S::n_rx + S::n_ru + S::n_gx + S::n_gu +
                                 2 * S::n_b + S::n_uc;
  static constexpr int ru = S::n_rx, gx = ru + S::n_ru, gu = gx + S::n_gx,
                       bx = gu + S::n_gu, bu = bx + S::n_b, uc = bu + S::n_b,
                       upos = uc + S::n_uc, rpos = upos + S::nu,
                       qpos = rpos + S::nx, count = qpos + S::nx;
};

template <class S>
__device__ void load_rows(int* r, const int* __restrict__ table, int tid,
                          int threads) {
  using R = Rows<S>;
  for (int e = tid; e < R::n_table; e += threads) r[e] = table[e];
  for (int e = tid; e < S::nu; e += threads) r[R::upos + e] = -1;
  for (int e = tid; e < 2 * S::nx; e += threads) r[R::rpos + e] = -1;
  __syncthreads();
  for (int e = tid; e < S::n_uc; e += threads) r[R::upos + r[R::uc + e]] = e;
  for (int e = tid; e < S::n_rx; e += threads) r[R::rpos + r[e]] = e;
  for (int e = tid; e < S::n_ru; e += threads) r[R::qpos + r[R::ru + e]] = e;
  __syncthreads();
}

// B[x][u] of the dense B from Bs at (ru, uc): zero off the live rows and
// columns.
template <class S>
__device__ __forceinline__ double b_at(const double* Bs, const int* r, int x,
                                       int u) {
  const int q = r[Rows<S>::qpos + x], c = r[Rows<S>::upos + u];
  return (q < 0 || c < 0) ? 0.0 : Bs[q * S::n_uc + c];
}

// ---- phase 1: the elements ----

template <class S>
struct ElemSmem {
  static constexpr int nx = S::nx, nu = S::nu, W = 1 + 2 * nx;
  static constexpr int Sx = 0, Bs = Sx + S::n_rx * nx,
                       Jxp = Bs + S::n_ru * S::n_uc, Jup = Jxp + S::n_gx * nx,
                       rxp = Jup + S::n_gu * nu, rup = rxp + S::n_gx,
                       d = rup + S::n_gu, lx = d + nx, lu = lx + nx,
                       lxx = lu + nu, Rt = lxx + nx * nx, lux = Rt + nu * nu,
                       F = lux + nu * nx, work = F + nu * nu,
                       sol = work + inv_work(nu), doubles = sol + nu * W;
  static_assert(S::nt * nx + S::nt <= doubles, "terminal staging");
  static constexpr int bytes = doubles * 8 + Rows<S>::count * 4;
};

template <typename T>
__device__ void stage(double* dst, const T* __restrict__ src, int count,
                      int tid, int threads) {
  for (int e = tid; e < count; e += threads) dst[e] = wide(src[e]);
}

template <class S, typename T, Solve G>
__global__ void __launch_bounds__(kThreads)
element_kernel(const T* __restrict__ Sx, const T* __restrict__ Bs,
               const T* __restrict__ Jxp, const T* __restrict__ Jup,
               const T* __restrict__ rho, const T* __restrict__ d,
               const T* __restrict__ Jt, const T* __restrict__ rt,
               const int* __restrict__ table, int B, int ns, int nr, double mu,
               double* __restrict__ elems, double* __restrict__ gains,
               unsigned* __restrict__ counters) {
  using L = ElemSmem<S>;
  using E = Elem<S::nx>;
  using R = Rows<S>;
  constexpr int nx = S::nx, nu = S::nu, W = L::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const sm = reinterpret_cast<double*>(smem_raw);
  int* const r = reinterpret_cast<int*>(sm + L::doubles);
  const int tid = threadIdx.x;
  const int n = blockIdx.x;
  const size_t b = blockIdx.y;
  double* const e = elems + (static_cast<size_t>(n) * B + b) * E::size;

  if (n == ns) {
    // the terminal element (0, 0, 0, 2Jtᵀrt, 2JtᵀJt)
    constexpr int nt = S::nt;
    double* const jt = sm;
    double* const rtv = sm + nt * nx;
    stage(jt, Jt + b * nt * nx, nt * nx, tid, kThreads);
    stage(rtv, rt + b * nt, nt, tid, kThreads);
    if (tid == 0) counters[b] = 0u;
    __syncthreads();
    for (int i = tid; i < 2 * nx * nx + nx; i += kThreads) e[i] = 0.0;
    for (int i = tid; i < nx; i += kThreads) {
      double s = 0.0;
      for (int q = 0; q < nt; ++q) s += jt[q * nx + i] * rtv[q];
      e[E::b + i] = 0.0;
      e[E::eta + i] = 2.0 * s;
    }
    for (int o = tid; o < nx * nx; o += kThreads) {
      const int i = o / nx, j = o % nx;
      double s = 0.0;
      for (int q = 0; q < nt; ++q) s += jt[q * nx + i] * jt[q * nx + j];
      e[E::J + o] = 2.0 * s;
    }
    return;
  }

  const size_t bn = b * ns + n;
  load_rows<S>(r, table, tid, kThreads);
  stage(sm + L::Sx, Sx + bn * S::n_rx * nx, S::n_rx * nx, tid, kThreads);
  stage(sm + L::Bs, Bs + bn * S::n_ru * S::n_uc, S::n_ru * S::n_uc, tid,
        kThreads);
  stage(sm + L::Jxp, Jxp + bn * S::n_gx * nx, S::n_gx * nx, tid, kThreads);
  stage(sm + L::Jup, Jup + bn * S::n_gu * nu, S::n_gu * nu, tid, kThreads);
  stage(sm + L::d, d + bn * nx, nx, tid, kThreads);
  for (int q = tid; q < S::n_gx; q += kThreads)
    sm[L::rxp + q] = wide(rho[bn * nr + r[R::gx + q]]);
  for (int q = tid; q < S::n_gu; q += kThreads)
    sm[L::rup + q] = wide(rho[bn * nr + r[R::gu + q]]);
  __syncthreads();

  const double* sSx = sm + L::Sx;
  const double* sBs = sm + L::Bs;
  const double* jx = sm + L::Jxp;
  const double* ju = sm + L::Jup;
  double* const lx = sm + L::lx;
  double* const lu = sm + L::lu;
  double* const lxx = sm + L::lxx;
  double* const Rt = sm + L::Rt;
  double* const lux = sm + L::lux;
  double* const F = sm + L::F;
  double* const sol = sm + L::sol;

  // the Gauss–Newton quadratics, and R̃ = luu + μI
  for (int i = tid; i < nx + nu; i += kThreads) {
    double s = 0.0;
    if (i < nx) {
      for (int q = 0; q < S::n_gx; ++q) s += jx[q * nx + i] * sm[L::rxp + q];
      lx[i] = 2.0 * s;
    } else {
      const int u = i - nx;
      for (int q = 0; q < S::n_gu; ++q) s += ju[q * nu + u] * sm[L::rup + q];
      lu[u] = 2.0 * s;
    }
  }
  for (int o = tid; o < nx * nx + nu * nu + nu * nx; o += kThreads) {
    double s = 0.0;
    if (o < nx * nx) {
      const int i = o / nx, j = o % nx;
      for (int q = 0; q < S::n_gx; ++q) s += jx[q * nx + i] * jx[q * nx + j];
      lxx[o] = 2.0 * s;
    } else if (o < nx * nx + nu * nu) {
      const int p = o - nx * nx, i = p / nu, j = p % nu;
      for (int q = 0; q < S::n_gu; ++q) s += ju[q * nu + i] * ju[q * nu + j];
      Rt[p] = 2.0 * s + (i == j ? mu : 0.0);
    } else {
      const int p = o - nx * nx - nu * nu, u = p / nx, x = p % nx;
      for (int q = 0; q < S::n_b; ++q)
        s += ju[r[R::bu + q] * nu + u] * jx[r[R::bx + q] * nx + x];
      lux[p] = 2.0 * s;
    }
  }
  __syncthreads();

  // sol = R̃⁻¹ [lu | lux | Bᵀ]  (nu × W)
  auto rhs = [&](int u, int c) {
    return c == 0 ? lu[u] : c <= nx ? lux[u * nx + c - 1]
                                    : b_at<S>(sBs, r, c - 1 - nx, u);
  };
  if constexpr (G == Solve::kSchur) {
    if (tid < 32) spd_inverse_warp<nu, nu, nu>(Rt, F, sm + L::work);
    __syncthreads();
    for (int o = tid; o < nu * W; o += kThreads) {
      const int i = o / W, c = o % W;
      double s = 0.0;
      for (int u = 0; u < nu; ++u) s += F[i * nu + u] * rhs(u, c);
      sol[o] = s;
    }
  } else {
    if (tid < 32) cholesky_warp<nu>(Rt, F);
    __syncthreads();
    for (int c = tid; c < W; c += kThreads) {
      for (int u = 0; u < nu; ++u) sol[u * W + c] = rhs(u, c);
      cholesky_solve<nu>(F, sol + c, W);
    }
  }
  __syncthreads();

  // the element: A − B R̃⁻¹lux, C = B R̃⁻¹Bᵀ, lxx − luxᵀR̃⁻¹lux, then b, η
  for (int o = tid; o < 3 * nx * nx; o += kThreads) {
    const int m = o / (nx * nx), p = o % (nx * nx), i = p / nx, j = p % nx;
    double s = 0.0;
    if (m < 2) {          // B row i over the live inputs
      const int q = r[R::qpos + i];
      if (q >= 0)
        for (int c = 0; c < S::n_uc; ++c)
          s += sBs[q * S::n_uc + c] *
               sol[r[R::uc + c] * W + (m == 0 ? 1 + j : 1 + nx + j)];
      if (m == 0) {
        const int rr = r[R::rpos + i];
        const double a = (i == j ? 1.0 : 0.0) +
                         (rr >= 0 ? sSx[rr * nx + j] : 0.0);
        e[E::A + p] = a - s;
      } else {
        e[E::C + p] = s;
      }
    } else {
      for (int u = 0; u < nu; ++u) s += lux[u * nx + i] * sol[u * W + 1 + j];
      e[E::J + p] = lxx[p] - s;
    }
  }
  for (int i = tid; i < 2 * nx; i += kThreads) {
    double s = 0.0;
    if (i < nx) {
      const int q = r[R::qpos + i];
      if (q >= 0)
        for (int c = 0; c < S::n_uc; ++c)
          s += sBs[q * S::n_uc + c] * sol[r[R::uc + c] * W];
      e[E::b + i] = sm[L::d + i] - s;
    } else {
      const int x = i - nx;
      for (int u = 0; u < nu; ++u) s += lux[u * nx + x] * sol[u * W];
      e[E::eta + x] = lx[x] - s;
    }
  }
  double* const g = gains + bn * GainRec<S>::size;
  for (int o = tid; o < GainRec<S>::size; o += kThreads)
    g[o] = o < nu ? lu[o] : o < nu + nu * nx ? lux[o - nu] : Rt[o - nu - nu * nx];
}

// ---- phase 2: one combine a block ----

template <int nx>
struct CombineSmem {
  static constexpr int Wa = 3 * nx + 1;          // [I + C₁J₂ | A₁ | C₁ | b₁ − C₁η₂]
  static constexpr int aug = 0, J2 = aug + nx * Wa, A2 = J2 + nx * nx,
                       T1 = A2 + nx * nx, P = T1 + nx * nx, eta2 = P + nx * nx,
                       b1 = eta2 + nx, w = b1 + nx, doubles = w + nx;
  static constexpr int bytes = doubles * 8 + 8;  // + the pivot's row
};

template <int nx>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(double* __restrict__ elems, const int* __restrict__ plan,
               int B) {
  using L = CombineSmem<nx>;
  using E = Elem<nx>;
  constexpr int Wa = L::Wa, nt = kCombineThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const sm = reinterpret_cast<double*>(smem_raw);
  int* const piv = reinterpret_cast<int*>(sm + L::doubles);
  double* const a = sm + L::aug;
  double* const J2 = sm + L::J2;
  double* const A2 = sm + L::A2;
  double* const T1 = sm + L::T1;
  double* const P = sm + L::P;
  double* const eta2 = sm + L::eta2;
  double* const b1 = sm + L::b1;
  double* const w = sm + L::w;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t b = blockIdx.y;
  const int* c = plan + 3 * blockIdx.x;         // out, earlier, later
  double* const eo = elems + (static_cast<size_t>(c[0]) * B + b) * E::size;
  const double* const e1 = elems + (static_cast<size_t>(c[1]) * B + b) * E::size;
  const double* const e2 = elems + (static_cast<size_t>(c[2]) * B + b) * E::size;

  for (int o = tid; o < nx * nx; o += nt) {
    const int i = o / nx, j = o % nx;
    J2[o] = e2[E::J + o];
    A2[o] = e2[E::A + o];
    a[i * Wa + nx + j] = e1[E::A + o];
    a[i * Wa + 2 * nx + j] = e1[E::C + o];
  }
  for (int i = tid; i < nx; i += nt) {
    eta2[i] = e2[E::eta + i];
    b1[i] = e1[E::b + i];
  }
  __syncthreads();
  // I + C₁J₂ and b₁ − C₁η₂
  for (int o = tid; o < nx * nx + nx; o += nt) {
    const int i = o / nx, j = o % nx;
    const double* c1 = a + i * Wa + 2 * nx;
    double s = 0.0;
    if (i < nx) {
      for (int k = 0; k < nx; ++k) s += c1[k] * J2[k * nx + j];
      a[i * Wa + j] = (i == j ? 1.0 : 0.0) + s;
    } else {
      const double* c1r = a + j * Wa + 2 * nx;
      for (int k = 0; k < nx; ++k) s += c1r[k] * eta2[k];
      a[j * Wa + 3 * nx] = b1[j] - s;
    }
  }
  __syncthreads();

  // Gaussian elimination with partial pivoting across all Wa columns
  for (int k = 0; k < nx; ++k) {
    if (tid < 32) {
      double best = -1.0;
      int at = k;
      for (int i = k + lane; i < nx; i += 32) {
        const double v = fabs(a[i * Wa + k]);
        if (v > best) {
          best = v;
          at = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, at, off);
        if (ob > best || (ob == best && oa < at)) {
          best = ob;
          at = oa;
        }
      }
      if (lane == 0) *piv = at;
    }
    __syncthreads();
    const int p = *piv;
    if (p != k)
      for (int j = k + tid; j < Wa; j += nt) {
        const double t = a[k * Wa + j];
        a[k * Wa + j] = a[p * Wa + j];
        a[p * Wa + j] = t;
      }
    __syncthreads();
    const double rinv = 1.0 / a[k * Wa + k];
    const int rows = nx - 1 - k, cols = Wa - 1 - k;
    for (int o = tid; o < rows * cols; o += nt) {
      const int i = k + 1 + o / cols, j = k + 1 + o % cols;
      a[i * Wa + j] -= (a[i * Wa + k] * rinv) * a[k * Wa + j];
    }
    __syncthreads();
  }
  // back substitution, a thread a right-hand side, in place
  for (int col = nx + tid; col < Wa; col += nt)
    for (int i = nx - 1; i >= 0; --i) {
      double s = a[i * Wa + col];
      for (int j = i + 1; j < nx; ++j) s -= a[i * Wa + j] * a[j * Wa + col];
      a[i * Wa + col] = s / a[i * Wa + i];
    }
  __syncthreads();

  // M = [MA₁ | MC₁ | Mb] in a's columns nx … 3nx
  const double* M = a + nx;
  for (int o = tid; o < 3 * nx * nx + 2 * nx; o += nt) {
    double s = 0.0;
    if (o < 3 * nx * nx) {
      const int m = o / (nx * nx), p = o % (nx * nx), i = p / nx, j = p % nx;
      if (m == 0) {                       // A = A₂MA₁
        for (int k = 0; k < nx; ++k) s += A2[i * nx + k] * M[k * Wa + j];
        eo[E::A + p] = s;
      } else if (m == 1) {                // J₂MA₁
        for (int k = 0; k < nx; ++k) s += J2[i * nx + k] * M[k * Wa + j];
        T1[p] = s;
      } else {                            // A₂MC₁
        for (int k = 0; k < nx; ++k) s += A2[i * nx + k] * M[k * Wa + nx + j];
        P[p] = s;
      }
    } else if (o < 3 * nx * nx + nx) {    // b = A₂Mb + b₂
      const int i = o - 3 * nx * nx;
      for (int k = 0; k < nx; ++k) s += A2[i * nx + k] * M[k * Wa + 2 * nx];
      eo[E::b + i] = s + e2[E::b + i];
    } else {                              // η₂ + J₂b₁
      const int i = o - 3 * nx * nx - nx;
      for (int k = 0; k < nx; ++k) s += J2[i * nx + k] * b1[k];
      w[i] = eta2[i] + s;
    }
  }
  __syncthreads();
  for (int o = tid; o < nx * nx; o += nt) J2[o] = e1[E::A + o];   // A₁
  __syncthreads();
  const double* A1 = J2;
  for (int o = tid; o < 2 * nx * nx + nx; o += nt) {
    double s = 0.0;
    if (o < nx * nx) {                    // C = (A₂MC₁)A₂ᵀ + C₂
      const int i = o / nx, j = o % nx;
      for (int k = 0; k < nx; ++k) s += P[i * nx + k] * A2[j * nx + k];
      eo[E::C + o] = s + e2[E::C + o];
    } else if (o < 2 * nx * nx) {         // J = A₁ᵀ(J₂MA₁) + J₁
      const int p = o - nx * nx, i = p / nx, j = p % nx;
      for (int k = 0; k < nx; ++k) s += A1[k * nx + i] * T1[k * nx + j];
      eo[E::J + p] = s + e1[E::J + p];
    } else {                              // η = MA₁ᵀw + η₁
      const int i = o - 2 * nx * nx;
      for (int k = 0; k < nx; ++k) s += M[k * Wa + i] * w[k];
      eo[E::eta + i] = s + e1[E::eta + i];
    }
  }
}

// ---- phase 3: the gains ----

template <class S>
struct GainSmem {
  static constexpr int nx = S::nx, nu = S::nu, Wk = 1 + nx;
  static constexpr int Sx = 0, Bs = Sx + S::n_rx * nx,
                       d = Bs + S::n_ru * S::n_uc, V = d + nx, v = V + nx * nx,
                       Qu = v + nx, Qux = Qu + nu, Quu = Qux + nu * nx,
                       Vxd = Quu + nu * nu, VA = Vxd + nx, VB = VA + nx * nx,
                       F = VB + nx * nu, work = F + nu * nu,
                       kK = work + inv_work(nu), red = kK + nu * Wk,
                       doubles = red + 2;
  static constexpr int bytes = doubles * 8 + Rows<S>::count * 4 + 4;
};

template <class S, typename T, Solve G>
__global__ void __launch_bounds__(kThreads)
gain_kernel(const T* __restrict__ Sx, const T* __restrict__ Bs,
            const T* __restrict__ d, const int* __restrict__ table, int B,
            int ns, const double* __restrict__ elems,
            const double* __restrict__ gains, const int* __restrict__ suffix,
            double* __restrict__ terms, unsigned* __restrict__ counters,
            T* __restrict__ ks, T* __restrict__ Ks, T* __restrict__ dV1,
            T* __restrict__ dV2) {
  using L = GainSmem<S>;
  using E = Elem<S::nx>;
  using R = Rows<S>;
  constexpr int nx = S::nx, nu = S::nu, Wk = L::Wk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const sm = reinterpret_cast<double*>(smem_raw);
  int* const r = reinterpret_cast<int*>(sm + L::doubles);
  int* const last = r + R::count;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.x;
  const size_t b = blockIdx.y;
  const size_t bn = b * ns + n;
  const double* const ev =
      elems + (static_cast<size_t>(suffix[n + 1]) * B + b) * E::size;
  const double* const g = gains + bn * GainRec<S>::size;

  load_rows<S>(r, table, tid, kThreads);
  stage(sm + L::Sx, Sx + bn * S::n_rx * nx, S::n_rx * nx, tid, kThreads);
  stage(sm + L::Bs, Bs + bn * S::n_ru * S::n_uc, S::n_ru * S::n_uc, tid,
        kThreads);
  stage(sm + L::d, d + bn * nx, nx, tid, kThreads);
  for (int o = tid; o < nx * nx; o += kThreads) sm[L::V + o] = ev[E::J + o];
  for (int i = tid; i < nx; i += kThreads) sm[L::v + i] = ev[E::eta + i];
  for (int o = tid; o < GainRec<S>::size; o += kThreads)
    sm[L::Qu + o] = g[o];                       // lu, lux, R̃ in Qu, Qux, Quu
  __syncthreads();
  const double* V = sm + L::V;
  const double* sSx = sm + L::Sx;
  const double* sBs = sm + L::Bs;
  double* const Qu = sm + L::Qu;
  double* const Qux = sm + L::Qux;
  double* const Quu = sm + L::Quu;
  double* const Vxd = sm + L::Vxd;
  double* const VA = sm + L::VA;
  double* const VB = sm + L::VB;
  double* const F = sm + L::F;
  double* const kK = sm + L::kK;

  // Vx_d = Vx + Vxx d;  V A = V + V[:, rx] Sx;  V B = V[:, ru] Bs
  for (int o = tid; o < nx + nx * nx + nx * nu; o += kThreads) {
    double s = 0.0;
    if (o < nx) {
      for (int j = 0; j < nx; ++j) s += V[o * nx + j] * sm[L::d + j];
      Vxd[o] = sm[L::v + o] + s;
    } else if (o < nx + nx * nx) {
      const int p = o - nx, i = p / nx, j = p % nx;
      for (int q = 0; q < S::n_rx; ++q)
        s += V[i * nx + r[q]] * sSx[q * nx + j];
      VA[p] = V[p] + s;
    } else {
      const int p = o - nx - nx * nx, i = p / nu, u = p % nu;
      const int cu = r[R::upos + u];
      if (cu >= 0)
        for (int q = 0; q < S::n_ru; ++q)
          s += V[i * nx + r[R::ru + q]] * sBs[q * S::n_uc + cu];
      VB[p] = s;
    }
  }
  __syncthreads();
  // Qu = lu + BᵀVx_d, Qux = lux + Bᵀ(V A), Quu = R̃ + Bᵀ(V B), in place
  for (int o = tid; o < nu + nu * nx + nu * nu; o += kThreads) {
    const int u = o < nu ? o : o < nu + nu * nx ? (o - nu) / nx
                                                : (o - nu - nu * nx) / nu;
    const int cu = r[R::upos + u];
    double s = 0.0;
    if (cu >= 0)
      for (int q = 0; q < S::n_ru; ++q) {
        const int x = r[R::ru + q];
        const double bq = sBs[q * S::n_uc + cu];
        s += bq * (o < nu ? Vxd[x]
                   : o < nu + nu * nx ? VA[x * nx + (o - nu) % nx]
                                      : VB[x * nu + (o - nu - nu * nx) % nu]);
      }
    Qu[o] += s;                                  // Qu, Qux, Quu contiguous
  }
  __syncthreads();

  // [k K] = −Quu⁻¹ [Qu Qux]
  T* const ks_g = ks + bn * nu;
  T* const Ks_g = Ks + bn * nu * nx;
  if constexpr (G == Solve::kSchur) {
    if (warp == 0) spd_inverse_warp<nu, nu, nu>(Quu, F, sm + L::work);
    __syncthreads();
    for (int o = tid; o < nu * Wk; o += kThreads) {
      const int i = o / Wk, c = o % Wk;
      double s = 0.0;
      for (int u = 0; u < nu; ++u)
        s += F[i * nu + u] * (c == 0 ? Qu[u] : Qux[u * nx + c - 1]);
      kK[o] = -s;
    }
  } else {
    if (warp == 0) cholesky_warp<nu>(Quu, F);
    __syncthreads();
    for (int c = tid; c < Wk; c += kThreads) {
      for (int u = 0; u < nu; ++u)
        kK[u * Wk + c] = c == 0 ? Qu[u] : Qux[u * nx + c - 1];
      cholesky_solve<nu>(F, kK + c, Wk);
      for (int u = 0; u < nu; ++u) kK[u * Wk + c] = -kK[u * Wk + c];
    }
  }
  __syncthreads();
  for (int o = tid; o < nu * Wk; o += kThreads) {
    const int i = o / Wk, c = o % Wk;
    if (c == 0)
      ks_g[i] = static_cast<T>(kK[o]);
    else
      Ks_g[i * nx + c - 1] = static_cast<T>(kK[o]);
  }
  // this node's kᵀQu and kᵀQuu k, then ΔV₁, ΔV₂ by the member's last block
  if (warp == 0) {
    double t1 = 0.0, t2 = 0.0;
    for (int u = lane; u < nu; u += 32) {
      double q = 0.0;
      for (int v2 = 0; v2 < nu; ++v2) q += Quu[u * nu + v2] * kK[v2 * Wk];
      t1 += kK[u * Wk] * Qu[u];
      t2 += kK[u * Wk] * q;
    }
    for (int off = 16; off > 0; off >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, off);
      t2 += __shfl_xor_sync(0xffffffffu, t2, off);
    }
    if (lane == 0) {
      terms[2 * bn] = t1;
      terms[2 * bn + 1] = t2;
      __threadfence();
      *last = atomicAdd(counters + b, 1u) == static_cast<unsigned>(ns - 1);
    }
  }
  __syncthreads();
  if (*last && tid == 0) {
    __threadfence();
    const volatile double* tv = terms + 2 * b * ns;
    double s1 = 0.0, s2 = 0.0;
    for (int m = 0; m < ns; ++m) {
      s1 += tv[2 * m];
      s2 += tv[2 * m + 1];
    }
    dV1[b] = static_cast<T>(s1);
    dV2[b] = static_cast<T>(0.5 * s2);
  }
}

template <class Kernel>
int opt_in(Kernel kernel, int bytes) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > limit) return kSmemExceeded;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <class S, typename T, Solve G>
int launch(const void* Sx, const void* Bs, const void* Jxp, const void* Jup,
           const void* rho, const void* d, const void* Jt, const void* rt,
           const void* rows, int B, int ns, int nr, double mu,
           const int* plan, const int* stage_counts, int n_stages,
           const int* suffix, double* elems, double* gains, double* terms,
           unsigned* counters, void* ks, void* Ks, void* dV1, void* dV2,
           void* stream) {
  if (B == 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double mu_t = static_cast<double>(static_cast<T>(mu));  // as the twin rounds it
  int err = opt_in(element_kernel<S, T, G>, ElemSmem<S>::bytes);
  if (err != 0) return err;
  element_kernel<S, T, G><<<dim3(ns + 1, B), kThreads, ElemSmem<S>::bytes,
                            st>>>(
      static_cast<const T*>(Sx), static_cast<const T*>(Bs),
      static_cast<const T*>(Jxp), static_cast<const T*>(Jup),
      static_cast<const T*>(rho), static_cast<const T*>(d),
      static_cast<const T*>(Jt), static_cast<const T*>(rt),
      static_cast<const int*>(rows), B, ns, nr, mu_t, elems, gains, counters);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  constexpr int cbytes = CombineSmem<S::nx>::bytes;
  err = opt_in(combine_kernel<S::nx>, cbytes);
  if (err != 0) return err;
  int off = 0;
  for (int s = 0; s < n_stages; ++s) {
    combine_kernel<S::nx><<<dim3(stage_counts[s], B), kCombineThreads, cbytes,
                            st>>>(elems, plan + 3 * off, B);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    off += stage_counts[s];
  }
  err = opt_in(gain_kernel<S, T, G>, GainSmem<S>::bytes);
  if (err != 0) return err;
  gain_kernel<S, T, G><<<dim3(ns, B), kThreads, GainSmem<S>::bytes, st>>>(
      static_cast<const T*>(Sx), static_cast<const T*>(Bs),
      static_cast<const T*>(d), static_cast<const int*>(rows), B, ns, elems,
      gains, suffix, terms, counters, static_cast<T*>(ks),
      static_cast<T*>(Ks), static_cast<T*>(dV1), static_cast<T*>(dV2));
  return static_cast<int>(cudaGetLastError());
}

template <class S>
bool matches(const int* dims) {
  const int want[9] = {S::nx,   S::nu,   S::nt,   S::n_rx, S::n_ru,
                       S::n_gx, S::n_gu, S::n_b,  S::n_uc};
  for (int i = 0; i < 9; ++i)
    if (dims[i] != want[i]) return false;
  return true;
}

template <class Shape, Solve GG>
struct Inst {
  using S = Shape;
  static constexpr Solve G = GG;
};

// fn(Inst<...>{}) for instantiation `inst`, in the order of
// kernels/riccati_associative.py::KERNEL_INSTANCES; kUnknownShape else
template <class Fn>
int with_instance(int inst, Fn fn) {
  switch (inst) {
    case 0: return fn(Inst<SrbdShape, Solve::kSchur>{});
    case 1: return fn(Inst<SrbdShape, Solve::kCholesky>{});
    case 2: return fn(Inst<LipShape, Solve::kSchur>{});
    case 3: return fn(Inst<LipShape, Solve::kCholesky>{});
    case 4: return fn(Inst<QuadShape, Solve::kSchur>{});
    case 5: return fn(Inst<QuadShape, Solve::kCholesky>{});
    case 6: return fn(Inst<IsrbdAlShape, Solve::kCholesky>{});
    case 7: return fn(Inst<QuadAlShape, Solve::kCholesky>{});
    case 8: return fn(Inst<PointFeetShape, Solve::kSchur>{});
    case 9: return fn(Inst<PointFeetShape, Solve::kCholesky>{});
    case 10: return fn(Inst<SrbdRkShape, Solve::kSchur>{});
    case 11: return fn(Inst<SrbdRkShape, Solve::kCholesky>{});
    case 12: return fn(Inst<QuadRkShape, Solve::kSchur>{});
    case 13: return fn(Inst<QuadRkShape, Solve::kCholesky>{});
    case 14: return fn(Inst<PointFeetRkShape, Solve::kSchur>{});
    case 15: return fn(Inst<PointFeetRkShape, Solve::kCholesky>{});
    default: return kUnknownShape;
  }
}

template <class Kernel>
int blocks_of(Kernel kernel, int threads, int bytes, int* out) {
  const int err = opt_in(kernel, bytes);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, threads, bytes));
}

}  // namespace

// `inst` indexes KERNEL_INSTANCES; the sizes must be its shape's, or the
// call returns kUnknownShape and launches nothing. `plan` (device) holds the
// scan's combines (out, earlier, later) stage after stage, `stage_counts`
// (host) the combines of each stage, `suffix` (device) the slot of each
// node's suffix element; `elems`, `gains`, `terms` and `counters` are the
// float64 and counter workspaces (kernels/riccati_associative.py sizes them).
#define ASSOC_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(                                                        \
      int inst, const void* Sx, const void* Bs, const void* Jxp,              \
      const void* Jup, const void* rho, const void* d, const void* Jt,        \
      const void* rt, const void* rows, int B, int ns, int nx, int nu,        \
      int nr, int nt, int n_rx, int n_ru, int n_gx, int n_gu, int n_b,        \
      int n_uc, double mu, const void* plan, const int* stage_counts,         \
      int n_stages, const void* suffix, void* elems, void* gains,             \
      void* terms, void* counters, void* ks, void* Ks, void* dV1, void* dV2,  \
      void* stream) {                                                         \
    const int dims[9] = {nx, nu, nt, n_rx, n_ru, n_gx, n_gu, n_b, n_uc};      \
    return with_instance(inst, [&](auto in) {                                 \
      using I = decltype(in);                                                 \
      if (!matches<typename I::S>(dims)) return kUnknownShape;                \
      return launch<typename I::S, T, I::G>(                                  \
          Sx, Bs, Jxp, Jup, rho, d, Jt, rt, rows, B, ns, nr, mu,              \
          static_cast<const int*>(plan), stage_counts, n_stages,              \
          static_cast<const int*>(suffix), static_cast<double*>(elems),       \
          static_cast<double*>(gains), static_cast<double*>(terms),           \
          static_cast<unsigned*>(counters), ks, Ks, dV1, dV2, stream);        \
    });                                                                       \
  }

ASSOC_ENTRY(riccati_associative_f32, float)
ASSOC_ENTRY(riccati_associative_f64, double)

// Shared memory bytes a block of each phase takes (element, combine, gain),
// and blocks of each resident on one SM, into out[0..5], for instantiation
// `inst` and float32 (f64 = 0) or float64 tensors.
extern "C" int riccati_associative_occupancy(int inst, int f64, int* out) {
  return with_instance(inst, [&](auto in) {
    using I = decltype(in);
    using S = typename I::S;
    out[0] = ElemSmem<S>::bytes;
    out[1] = CombineSmem<S::nx>::bytes;
    out[2] = GainSmem<S>::bytes;
    int err = f64 ? blocks_of(element_kernel<S, double, I::G>, kThreads,
                              out[0], out + 3)
                  : blocks_of(element_kernel<S, float, I::G>, kThreads,
                              out[0], out + 3);
    if (err == 0)
      err = blocks_of(combine_kernel<S::nx>, kCombineThreads, out[1], out + 4);
    if (err == 0)
      err = f64 ? blocks_of(gain_kernel<S, double, I::G>, kThreads, out[2],
                            out + 5)
                : blocks_of(gain_kernel<S, float, I::G>, kThreads, out[2],
                            out + 5);
    return err;
  });
}
