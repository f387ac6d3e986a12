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
//          η = MA₁ᵀ(η₂ + J₂b₁) + η₁    J = (A₁ᵀJ₂)MA₁ + J₁;
//   3. gains, a (member, node) a block, from V at n+1 (the suffix's J, η):
//          Qu = lu + BᵀVx_d   Qux = lux + Bᵀ(V A)   Quu = R̃ + Bᵀ(V B)
//          [k K] = −Quu⁻¹[Qu Qux]   (the same gain solve as 1)
//      and ΔV₁ = Σₙ kᵀQu, ΔV₂ = ½ Σₙ kᵀQuu k, summed over the nodes in
//      order by the member's last block to finish.
// One launch a phase and one a scan stage: 8 a sweep at ns = 20.
//
// Instantiations (`with_instance`): K1's fourteen shapes, with both gain
// solves at the six SRBD and six LIP ones (each topology — the Kangaroo,
// the point-feet quadruped, the point-feet biped — under Euler and under
// RK2/RK4, whose two steps share K1's shape) and with the Cholesky solve
// alone at the two isrbd-AL shapes (the AL solver always asks its inner
// solver for Cholesky). The AL shapes' element and
// gain blocks are the largest (~84 KB and ~60 KB of shared memory): nu =
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
// dependent nodes of K1 become 6 dependent stages here, each one combine's
// latency; at fleet sizes the scan's 20× more arithmetic sets the time.
//
// Design. Every matrix product and Gram runs on the FP64 tensor cores
// (mma.sync m16n8k4 through riccati_common.cuh's `mma_seg`/`Tiles`, K1's
// tile routine), each output rounded in order of depth as a scalar FMA
// loop rounds it; the tiles are padded in registers (rows and columns past
// the edge clamped and dropped, depth past the end zero), never in shared
// memory; the tiles of the products a phase forms together are shared out
// over the block's warps, two a warp at a time. The combine (256 threads,
// built for three blocks an SM) stages its operands with cp.async into
// rows whose stride is 4 mod 8 doubles (`lead`: a fragment's 16 lanes of
// a half-warp hit 16 banks, whichever way round it is read), forms
// I + C₁J₂ and A₁ᵀJ₂ together, then eliminates [I + C₁J₂ | A₁ | C₁ |
// b₁ − C₁η₂] as a blocked right-looking LU with partial pivoting: a panel
// of kPanel columns is factored by one warp in registers (the pivot by a
// warp reduction and a ballot, the row swap and the pivot's row by
// shuffles), its swaps and its unit-triangular solve applied to the
// columns right of it a thread a column, and the trailing rows updated on
// the tensor cores, warp 0 first updating the next panel's columns and
// factoring it while the other warps update the rest: two block barriers
// a panel. Every entry receives the unblocked elimination's fused
// multiply-adds in its order, so the pivots and factors are those of the
// column-by-column elimination. The back substitution is blocked the same
// way: a thread a right-hand side solves a kBlock-row diagonal block (the
// pivots' reciprocals kept from the factorization), the rows above are
// updated on the tensor cores. Shared memory: the augmented matrix and
// three nx×nx buffers — J₂ (then A₂MC₁), A₂ and A₁ᵀJ₂ — 74,740 B at
// nx = 37. The element and gain blocks (128 threads) form their Grams and
// products on the same tiles and keep K1's gain solves: K2's one-warp
// inverse then a product on the tensor cores, or the Cholesky factor and
// its substitutions a thread a column; the inverse or factor, its
// workspace and the solution take the place of operands already
// consumed, so that four blocks share an SM at the nx = 37 SRBD shapes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include <cuda_runtime.h>
#include <stddef.h>

#include "riccati_common.cuh"

namespace {

constexpr int kThreads = 128;            // element and gain blocks
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 256;
constexpr int kCombineWarps = kCombineThreads / 32;
constexpr int kCombineBlocks = 3;        // combine blocks an SM it is built for
constexpr int kPanel = 6;                // the elimination's panel width
constexpr int kBlock = 8;                // the substitution's block of rows
constexpr int kUnknownShape = -2;        // kernels/riccati_associative.py
constexpr int kSmemExceeded = -1;

// the gain solve (kernels/riccati_associative.py::QUU_SOLVERS)
enum class Solve { kSchur, kCholesky };

// The shape structs are K1's (riccati_common.cuh); the combine kernel is
// templated on nx, so the shapes of one nx share it (37: six shapes;
// 25: the point-feet biped's two SRBD shapes; 30: the four LIP shapes of
// the Kangaroo and the quadruped; 18: the point-feet biped's two LIP
// shapes, whose 18 rows take three panels and a last substitution block of
// two rows).

// A row stride of at least n doubles that is 4 mod 8: the 16 lanes of a
// half-warp then read a tensor-core fragment (4 rows × 4 columns, either
// way round) from 16 different banks.
__host__ __device__ constexpr int lead(int n) { return n + (12 - n % 8) % 8; }

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

// ---- the tensor-core tiles of a block ----

// Which accumulator of an Acc a tile takes (compile-time, for generic
// lambdas).
template <int V>
struct Slot {
  static constexpr int value = V;
};

// Tile `item` of an M×N product of depth K into acc.c[P] on the calling
// warp: a(i, k) is the left factor's row i at depth k, b(k, j) the right
// factor's column j.
template <int M, int N, int K, int P, class FA, class FB>
__device__ __forceinline__ void tile_mma(int item, Acc& acc, FA a, FB b) {
  tile_acc<M, N>(item, acc, [&](Acc& c, int ia0, int ia1, int jb) {
    mma_seg<K, P>(c, a, ia0, ia1, [&](int k) { return b(k, jb); });
  });
}

// Each element inside the matrix of tile `item` from acc.c[P]: epi(i, j, v).
template <int M, int N, int P, class Epi>
__device__ __forceinline__ void tile_put(int item, const Acc& acc, Epi epi) {
  tile_store<M, N>(item, acc, [&](int i, int j, double v0, double v1) {
    epi(i, j, P == 0 ? v0 : v1);
  });
}

// The calling lane's four entries of tile `item` of an M×N product, in
// its accumulator's order: f(r, i, j) for r = 0 … 3 (i and j may lie past
// the edge).
template <int M, int N, class F>
__device__ __forceinline__ void tile_each(int item, F f) {
  const int lane = threadIdx.x & 31;
  const int i = item / Tiles<M, N>::cols * 16 + (lane >> 2);
  const int j = item % Tiles<M, N>::cols * 8 + 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 4; ++r) f(r, i + 8 * (r >> 1), j + (r & 1));
}

// `count` tiles (of one or more products, numbered by the caller) shared
// out over the block's Warps warps, this one `warp`, two a warp at a time:
// job(item, Slot<P>{}, acc) accumulates a tile into acc.c[P] and
// put(item, Slot<P>{}, acc) stores it.
template <int Warps, class Job, class Put>
__device__ __forceinline__ void block_jobs(int warp, int count, Job job,
                                           Put put) {
  for (int item = warp; item < count; item += 2 * Warps) {
    const int item2 = item + Warps;
    Acc acc;
    job(item, Slot<0>{}, acc);
    if (item2 < count) job(item2, Slot<1>{}, acc);
    put(item, Slot<0>{}, acc);
    if (item2 < count) put(item2, Slot<1>{}, acc);
  }
}

// One M×N product of depth K on the block's warps: epi(i, j, v).
template <int M, int N, int K, int Warps, class FA, class FB, class Epi>
__device__ __forceinline__ void block_mma(int warp, FA a, FB b, Epi epi) {
  block_jobs<Warps>(
      warp, Tiles<M, N>::count,
      [&](int item, auto slot, Acc& acc) {
        tile_mma<M, N, K, decltype(slot)::value>(item, acc, a, b);
      },
      [&](int item, auto slot, const Acc& acc) {
        tile_put<M, N, decltype(slot)::value>(item, acc, epi);
      });
}

// ---- phase 1: the elements ----

// The staged operands and quadratics, then a region that holds the
// residual rows (Jx, Ju, their ρ) until their Grams are formed and then
// R̃'s inverse or factor F with the solution sol (K2's workspace where sol
// goes, before it is written).
template <class S, Solve G>
struct ElemSmem {
  static constexpr int nx = S::nx, nu = S::nu, W = 1 + 2 * nx;
  static constexpr int schur = G == Solve::kSchur;
  static constexpr int Sx = 0, Bs = Sx + S::n_rx * nx,
                       d = Bs + S::n_ru * S::n_uc, lx = d + nx, lu = lx + nx,
                       lxx = lu + nu, Rt = lxx + nx * nx, lux = Rt + nu * nu,
                       Jxp = lux + nu * nx, Jup = Jxp + S::n_gx * nx,
                       rxp = Jup + S::n_gu * nu, rup = rxp + S::n_gx,
                       F = Jxp, work = F + nu * nu, sol = work,
                       doubles = Jxp + cmax(S::n_gx * nx + S::n_gu * nu +
                                                S::n_gx + S::n_gu,
                                            nu * nu + cmax(schur * inv_work(nu),
                                                           nu * W));
  static constexpr int bytes = doubles * 8 + Rows<S>::count * 4;
  static_assert(S::nt * nx + S::nt <= doubles, "terminal staging");
};

// Blocks an SM the element kernel's registers are held to (the minimum of
// `element_kernel_bounded`'s launch bound): none, the compiler's choice
// (`element_kernel`), but at the nx = 30 LIP shapes of the quadruped and of
// RK, where that choice kept values in local memory (8 B of spill around a
// division's slow path with the Cholesky gains, a 32 B stack frame with the
// block-Schur ones); held to four blocks (104 registers on an H100's
// ptxas), nothing goes to local memory. (Naming a minimum of one is not
// the same as naming none: ptxas then takes more registers.)
template <class S>
constexpr int kElemMinBlocks = 0;
template <>
constexpr int kElemMinBlocks<LipRkShape> = 4;
template <>
constexpr int kElemMinBlocks<LipQuadShape> = 4;
template <>
constexpr int kElemMinBlocks<LipQuadRkShape> = 4;

template <typename T>
__device__ void stage(double* dst, const T* __restrict__ src, int count,
                      int tid, int threads) {
  for (int e = tid; e < count; e += threads) dst[e] = wide(src[e]);
}

template <class S, typename T, Solve G>
__device__ __forceinline__ void element_body(
    const T* __restrict__ Sx, const T* __restrict__ Bs,
    const T* __restrict__ Jxp, const T* __restrict__ Jup,
    const T* __restrict__ rho, const T* __restrict__ d,
    const T* __restrict__ Jt, const T* __restrict__ rt,
    const int* __restrict__ table, int B, int ns, int nr, double mu,
    double* __restrict__ elems, double* __restrict__ gains,
    unsigned* __restrict__ counters) {
  using L = ElemSmem<S, G>;
  using E = Elem<S::nx>;
  using R = Rows<S>;
  constexpr int nx = S::nx, nu = S::nu, W = L::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const sm = reinterpret_cast<double*>(smem_raw);
  int* const r = reinterpret_cast<int*>(sm + L::doubles);
  const int tid = threadIdx.x, warp = tid >> 5;
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
    for (int i = tid; i < 2 * nx * nx; i += kThreads) e[i] = 0.0;
    for (int i = tid; i < nx; i += kThreads) {
      double s = 0.0;
      for (int q = 0; q < nt; ++q) s += jt[q * nx + i] * rtv[q];
      e[E::b + i] = 0.0;
      e[E::eta + i] = 2.0 * s;
    }
    block_mma<nx, nx, nt, kWarps>(
        warp, [&](int i, int q) { return jt[q * nx + i]; },
        [&](int q, int j) { return jt[q * nx + j]; },
        [&](int i, int j, double v) { e[E::J + i * nx + j] = 2.0 * v; });
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

  // the Gauss–Newton quadratics: lx, lu a thread an entry; lxx = 2JxᵀJx,
  // R̃ = 2JuᵀJu + μI and lux = 2Ju[bu]ᵀJx[bx] on the tensor cores
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
  {
    constexpr int c0 = Tiles<nx, nx>::count, c1 = Tiles<nu, nu>::count,
                  c2 = Tiles<nu, nx>::count;
    auto a0 = [&](int i, int q) { return jx[q * nx + i]; };
    auto b0 = [&](int q, int j) { return jx[q * nx + j]; };
    auto a1 = [&](int i, int q) { return ju[q * nu + i]; };
    auto b1 = [&](int q, int j) { return ju[q * nu + j]; };
    auto a2 = [&](int u, int q) { return ju[r[R::bu + q] * nu + u]; };
    auto b2 = [&](int q, int x) { return jx[r[R::bx + q] * nx + x]; };
    block_jobs<kWarps>(
        warp, c0 + c1 + c2,
        [&](int item, auto slot, Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_mma<nx, nx, S::n_gx, P>(item, acc, a0, b0);
          else if (item < c0 + c1)
            tile_mma<nu, nu, S::n_gu, P>(item - c0, acc, a1, b1);
          else
            tile_mma<nu, nx, S::n_b, P>(item - c0 - c1, acc, a2, b2);
        },
        [&](int item, auto slot, const Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_put<nx, nx, P>(item, acc, [&](int i, int j, double v) {
              lxx[i * nx + j] = 2.0 * v;
            });
          else if (item < c0 + c1)
            tile_put<nu, nu, P>(item - c0, acc, [&](int i, int j, double v) {
              Rt[i * nu + j] = 2.0 * v + (i == j ? mu : 0.0);
            });
          else
            tile_put<nu, nx, P>(item - c0 - c1, acc,
                                [&](int u, int x, double v) {
                                  lux[u * nx + x] = 2.0 * v;
                                });
        });
  }
  __syncthreads();

  // sol = R̃⁻¹ [lu | lux | Bᵀ]  (nu × W)
  auto rhs = [&](int u, int c) {
    return c == 0 ? lu[u] : c <= nx ? lux[u * nx + c - 1]
                                    : b_at<S>(sBs, r, c - 1 - nx, u);
  };
  if constexpr (G == Solve::kSchur) {
    if (warp == 0) spd_inverse_warp<nu, nu, nu>(Rt, F, sm + L::work);
    __syncthreads();
    block_mma<nu, W, nu, kWarps>(
        warp, [&](int i, int u) { return F[i * nu + u]; }, rhs,
        [&](int i, int c, double v) { sol[i * W + c] = v; });
  } else {
    if (warp == 0) cholesky_warp<nu>(Rt, F);
    __syncthreads();
    for (int c = tid; c < W; c += kThreads) {
      for (int u = 0; u < nu; ++u) sol[u * W + c] = rhs(u, c);
      cholesky_solve<nu>(F, sol + c, W);
    }
  }
  __syncthreads();

  // the element on the tensor cores: A − B R̃⁻¹lux, C = B R̃⁻¹Bᵀ (over the
  // live inputs; B's dead rows give exact zeros), lxx − luxᵀR̃⁻¹lux; then
  // b and η a thread an entry
  {
    constexpr int c0 = Tiles<nx, nx>::count;
    auto bl = [&](int i, int c) {
      const int q = r[R::qpos + i];
      return q >= 0 ? sBs[q * S::n_uc + c] : 0.0;
    };
    auto bA = [&](int c, int j) { return sol[r[R::uc + c] * W + 1 + j]; };
    auto bC = [&](int c, int j) { return sol[r[R::uc + c] * W + 1 + nx + j]; };
    auto aJ = [&](int i, int u) { return lux[u * nx + i]; };
    auto bJ = [&](int u, int j) { return sol[u * W + 1 + j]; };
    block_jobs<kWarps>(
        warp, 3 * c0,
        [&](int item, auto slot, Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_mma<nx, nx, S::n_uc, P>(item, acc, bl, bA);
          else if (item < 2 * c0)
            tile_mma<nx, nx, S::n_uc, P>(item - c0, acc, bl, bC);
          else
            tile_mma<nx, nx, nu, P>(item - 2 * c0, acc, aJ, bJ);
        },
        [&](int item, auto slot, const Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_put<nx, nx, P>(item, acc, [&](int i, int j, double v) {
              const int rr = r[R::rpos + i];
              const double a = (i == j ? 1.0 : 0.0) +
                               (rr >= 0 ? sSx[rr * nx + j] : 0.0);
              e[E::A + i * nx + j] = a - v;
            });
          else if (item < 2 * c0)
            tile_put<nx, nx, P>(item - c0, acc, [&](int i, int j, double v) {
              e[E::C + i * nx + j] = v;
            });
          else
            tile_put<nx, nx, P>(item - 2 * c0, acc,
                                [&](int i, int j, double v) {
                                  e[E::J + i * nx + j] = lxx[i * nx + j] - v;
                                });
        });
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

#define ELEMENT_PARAMS                                                        \
  const T *__restrict__ Sx, const T *__restrict__ Bs,                         \
      const T *__restrict__ Jxp, const T *__restrict__ Jup,                   \
      const T *__restrict__ rho, const T *__restrict__ d,                     \
      const T *__restrict__ Jt, const T *__restrict__ rt,                     \
      const int *__restrict__ table, int B, int ns, int nr, double mu,        \
      double *__restrict__ elems, double *__restrict__ gains,                 \
      unsigned *__restrict__ counters
#define ELEMENT_ARGS \
  Sx, Bs, Jxp, Jup, rho, d, Jt, rt, table, B, ns, nr, mu, elems, gains, counters

// phase 1's kernel: a (member, node) a block, registers at the compiler's
// choice, or held to kElemMinBlocks<S> blocks an SM (`element_entry`)
template <class S, typename T, Solve G>
__global__ void __launch_bounds__(kThreads) element_kernel(ELEMENT_PARAMS) {
  element_body<S, T, G>(ELEMENT_ARGS);
}

template <class S, typename T, Solve G>
__global__ void __launch_bounds__(kThreads, (kElemMinBlocks<S>))
    element_kernel_bounded(ELEMENT_PARAMS) {
  element_body<S, T, G>(ELEMENT_ARGS);
}

template <class S, typename T, Solve G>
constexpr auto element_entry() {
  if constexpr (kElemMinBlocks<S> > 0)
    return element_kernel_bounded<S, T, G>;
  else
    return element_kernel<S, T, G>;
}

// ---- phase 2: one combine a block ----

// The augmented matrix [I + C₁J₂ | A₁ | C₁ | b₁ − C₁η₂] (nx × Wa, stride LA),
// J₂ (later A₂MC₁) in X, A₂ in Y, A₁ᵀJ₂ in Z (stride L each), then w =
// η₂ + J₂b₁, b₁, η₂, the pivots' reciprocals and the pivot rows (int).
template <int nx>
struct CombineSmem {
  static constexpr int Wa = 3 * nx + 1, L = lead(nx), LA = lead(Wa);
  static constexpr int aug = 0, X = aug + nx * LA, Y = X + nx * L,
                       Z = Y + nx * L, w = Z + nx * L, b1 = w + nx,
                       eta2 = b1 + nx, rdiag = eta2 + nx, doubles = rdiag + nx;
  static constexpr int bytes = doubles * 8 + nx * 4;
};

// a's rows of `slot` (0: lanes 0-31, 1: lanes 32-63 of the panel) — the
// panel has two only at nx > 32
template <int kSlots>
__device__ __forceinline__ double slot_of(const double (&v)[2][kPanel], int s,
                                          int c) {
  return kSlots > 1 && s ? v[1][c] : v[0][c];
}

// Factor the panel of columns k0 … k0+kb−1, rows k0 … nx−1, of `a` (row
// stride LA) on the calling warp in registers, row k0 + lane (+ 32) a
// lane. For each column in turn: the pivot is the first largest |entry|
// on or below the diagonal (LAPACK's idamax; a NaN counts as 0), found
// from the entries' bits by a warp reduction of their high words and a
// ballot (a second reduction only where high words tie); its row, read by
// every lane, is swapped with the diagonal's across the panel; the
// entries below become the multipliers (times the pivot's reciprocal, as
// the unblocked elimination forms them) and update the panel's later
// columns. The pivot rows go to piv, the reciprocals to rdiag.
template <int nx, int LA>
__device__ void factor_panel(double* a, int* piv, double* rdiag, int k0) {
  constexpr int kSlots = (nx + 31) / 32;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int kb = imin(kPanel, nx - k0);
  double v[2][kPanel];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int rw = k0 + lane + 32 * s;
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      v[s][c] = (s < kSlots && rw < nx && c < kb) ? a[rw * LA + k0 + c] : 0.0;
  }
#pragma unroll
  for (int jj = 0; jj < kPanel; ++jj) {
    if (jj >= kb) break;
    const int j = k0 + jj;        // row j is lane jj's first
    // this lane's candidate: its first largest |entry| at or below j
    unsigned long long key = 0ull;
    int slot = -1;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int rw = k0 + lane + 32 * s;
      if (rw >= j && rw < nx) {
        const double x = fabs(v[s][jj]);
        const unsigned long long k =
            x >= 0.0 ? static_cast<unsigned long long>(__double_as_longlong(x))
                     : 0ull;
        if (slot < 0 || k > key) {
          key = k;
          slot = s;
        }
      }
    }
    const unsigned hi = __reduce_max_sync(kAll, static_cast<unsigned>(key >> 32));
    unsigned m = __ballot_sync(kAll, slot >= 0 &&
                                         static_cast<unsigned>(key >> 32) == hi);
    if (__popc(m) > 1) {
      const bool in = (m >> lane) & 1u;
      const unsigned lo =
          __reduce_max_sync(kAll, in ? static_cast<unsigned>(key) : 0u);
      m = __ballot_sync(kAll, in && static_cast<unsigned>(key) == lo);
    }
    int p;
    if constexpr (kSlots == 1) {
      p = k0 + __ffs(m) - 1;
    } else {              // rows of the first slot come first
      const unsigned m0 = __ballot_sync(kAll, ((m >> lane) & 1u) && slot == 0);
      p = m0 ? k0 + __ffs(m0) - 1 : k0 + 31 + __ffs(m);
    }
    const int lp = (p - k0) & 31, sp = (p - k0) >> 5;
    double u[kPanel];     // row p: the diagonal's row after the swap
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      u[c] = __shfl_sync(kAll, slot_of<kSlots>(v, sp, c), lp);
    if (p != j) {
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        const double xj = __shfl_sync(kAll, v[0][c], jj);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int rw = k0 + lane + 32 * s;
          if (rw == j)
            v[s][c] = u[c];
          else if (rw == p)
            v[s][c] = xj;
        }
      }
    }
    const double rinv = __drcp_rn(u[jj]);
    if (lane == 0) {
      piv[j] = p;
      rdiag[j] = rinv;
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int rw = k0 + lane + 32 * s;
      if (rw > j && rw < nx) {
        const double l = v[s][jj] * rinv;
        v[s][jj] = l;
#pragma unroll
        for (int c = jj + 1; c < kPanel; ++c) v[s][c] = fma(-l, u[c], v[s][c]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int rw = k0 + lane + 32 * s;
    if (rw < nx)
#pragma unroll
      for (int c = 0; c < kPanel; ++c)
        if (c < kb) a[rw * LA + k0 + c] = v[s][c];
  }
}

// The panel k0 … k0+kb−1's row swaps, in order, and its unit lower
// triangular solve (U₁₂ = L₁₁⁻¹A₁₂) on column c.
template <int LA>
__device__ __forceinline__ void swap_and_solve(double* a, const int* piv,
                                               int k0, int kb, int c) {
  for (int jj = 0; jj < kb; ++jj) {
    const int j = k0 + jj, p = piv[j];
    if (p != j) {
      const double t = a[j * LA + c];
      a[j * LA + c] = a[p * LA + c];
      a[p * LA + c] = t;
    }
  }
  double x[kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) x[i] = i < kb ? a[(k0 + i) * LA + c] : 0.0;
#pragma unroll
  for (int i = 1; i < kPanel; ++i)
    if (i < kb) {
#pragma unroll
      for (int l = 0; l < i; ++l)
        x[i] = fma(-a[(k0 + i) * LA + k0 + l], x[l], x[i]);
      a[(k0 + i) * LA + c] = x[i];
    }
}

// The elimination's tile at rows r0 …, columns c0 … of the window rows
// < R1, columns < C1 into acc.c[P]: its entries, then − a[:, kbase …
// kbase+kb) · a[kbase … kbase+kb, :] in kb fused multiply-adds in order of
// k (zero past kb).
template <int LA, int K, int P>
__device__ __forceinline__ void elim_acc(const double* a, Acc& acc, int r0,
                                         int c0, int R1, int C1, int kbase,
                                         int kb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = r0 + g + 8 * h, j = c0 + 2 * t + q;
      acc.c[P][2 * h + q] = (i < R1 && j < C1) ? a[i * LA + j] : 0.0;
    }
  const int jb = imin(c0 + g, C1 - 1);
  mma_seg<K, P>(
      acc,
      [&](int i, int k) { return k < kb ? -a[i * LA + kbase + k] : 0.0; },
      imin(r0 + g, R1 - 1), imin(r0 + g + 8, R1 - 1),
      [&](int k) { return k < kb ? a[(kbase + k) * LA + jb] : 0.0; });
}

template <int LA, int P>
__device__ __forceinline__ void elim_put(double* a, const Acc& acc, int r0,
                                         int c0, int R1, int C1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = r0 + g + 8 * h, j = c0 + 2 * t + q;
      if (i < R1 && j < C1) a[i * LA + j] = acc.c[P][2 * h + q];
    }
}

// a[R0 … R1, C0 … C1) −= a[R0 …, kbase … kbase+kb) · a[kbase … kbase+kb,
// C0 …) on the tensor cores: the window's 16×8 tiles numbered row-major,
// this warp taking tiles first, first + stride, … two at a time.
template <int LA, int K>
__device__ __forceinline__ void elim_tiles(double* a, int R0, int R1, int C0,
                                           int C1, int kbase, int kb,
                                           int first, int stride) {
  const int ct = (C1 - C0 + 7) >> 3, count = ((R1 - R0 + 15) >> 4) * ct;
  for (int item = first; item < count; item += 2 * stride) {
    const int item2 = item + stride;
    const int r0 = R0 + item / ct * 16, c0 = C0 + item % ct * 8;
    const int r1 = R0 + item2 / ct * 16, c1 = C0 + item2 % ct * 8;
    Acc acc;
    elim_acc<LA, K, 0>(a, acc, r0, c0, R1, C1, kbase, kb);
    if (item2 < count) elim_acc<LA, K, 1>(a, acc, r1, c1, R1, C1, kbase, kb);
    elim_put<LA, 0>(a, acc, r0, c0, R1, C1);
    if (item2 < count) elim_put<LA, 1>(a, acc, r1, c1, R1, C1);
  }
}

template <int nx>
__global__ void __launch_bounds__(kCombineThreads, kCombineBlocks)
combine_kernel(double* __restrict__ elems, const int* __restrict__ plan,
               int B) {
  using L = CombineSmem<nx>;
  using E = Elem<nx>;
  constexpr int W = L::Wa, LA = L::LA, LD = L::L, nt = kCombineThreads;
  constexpr int nblk = (nx + kBlock - 1) / kBlock;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const sm = reinterpret_cast<double*>(smem_raw);
  int* const piv = reinterpret_cast<int*>(sm + L::doubles);
  double* const a = sm + L::aug;
  double* const X = sm + L::X;
  double* const Y = sm + L::Y;
  double* const Z = sm + L::Z;
  double* const w = sm + L::w;
  double* const b1 = sm + L::b1;
  double* const eta2 = sm + L::eta2;
  double* const rdiag = sm + L::rdiag;
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t b = blockIdx.y;
  const int* c = plan + 3 * blockIdx.x;         // out, earlier, later
  double* const eo = elems + (static_cast<size_t>(c[0]) * B + b) * E::size;
  const double* const e1 = elems + (static_cast<size_t>(c[1]) * B + b) * E::size;
  const double* const e2 = elems + (static_cast<size_t>(c[2]) * B + b) * E::size;
  static_assert(2 * nx <= kCombineThreads, "a thread an entry of b and η");
  // b₂ or η₁ for this thread's entry of the output's b or η, read now
  const double add = tid < nx ? e2[E::b + tid]
                     : tid < 2 * nx ? e1[E::eta + tid - nx] : 0.0;

  // J₂ → X, A₂ → Y, A₁ and C₁ → a's columns nx … 3nx−1, b₁, η₂
  for (int o = tid; o < nx * nx; o += nt) {
    const int i = o / nx, j = o % nx;
    cp_async<8>(X + i * LD + j, e2 + E::J + o);
    cp_async<8>(Y + i * LD + j, e2 + E::A + o);
    cp_async<8>(a + i * LA + nx + j, e1 + E::A + o);
    cp_async<8>(a + i * LA + 2 * nx + j, e1 + E::C + o);
  }
  for (int i = tid; i < nx; i += nt) {
    cp_async<8>(b1 + i, e1 + E::b + i);
    cp_async<8>(eta2 + i, e2 + E::eta + i);
  }
  cp_async_wait_all();
  __syncthreads();

  // I + C₁J₂ → a's columns 0 … nx−1 and A₁ᵀJ₂ → Z, their tiles together;
  // b₁ − C₁η₂ → a's column 3nx and w = η₂ + J₂b₁
  {
    constexpr int c0 = Tiles<nx, nx>::count;
    auto aG = [&](int i, int k) { return a[i * LA + 2 * nx + k]; };
    auto aS = [&](int i, int k) { return a[k * LA + nx + i]; };
    auto bJ = [&](int k, int j) { return X[k * LD + j]; };
    block_jobs<kCombineWarps>(
        warp, 2 * c0,
        [&](int item, auto slot, Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_mma<nx, nx, nx, P>(item, acc, aG, bJ);
          else
            tile_mma<nx, nx, nx, P>(item - c0, acc, aS, bJ);
        },
        [&](int item, auto slot, const Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_put<nx, nx, P>(item, acc, [&](int i, int j, double v) {
              a[i * LA + j] = (i == j ? 1.0 : 0.0) + v;
            });
          else
            tile_put<nx, nx, P>(item - c0, acc, [&](int i, int j, double v) {
              Z[i * LD + j] = v;
            });
        });
  }
  for (int o = tid; o < 2 * nx; o += nt) {
    double s = 0.0;
    if (o < nx) {
      for (int k = 0; k < nx; ++k) s += a[o * LA + 2 * nx + k] * eta2[k];
      a[o * LA + 3 * nx] = b1[o] - s;
    } else {
      const int i = o - nx;
      for (int k = 0; k < nx; ++k) s += X[i * LD + k] * b1[k];
      w[i] = eta2[i] + s;
    }
  }
  __syncthreads();

  // the blocked LU with partial pivoting across all W columns: a panel's
  // swaps and solve a thread a column, then warp 0 updates the next
  // panel's columns and factors that panel while the other warps update
  // every column right of them
  if (warp == 0) factor_panel<nx, LA>(a, piv, rdiag, 0);
  __syncthreads();
  for (int k0 = 0; k0 < nx; k0 += kPanel) {
    const int kb = imin(kPanel, nx - k0), r0 = k0 + kb;
    for (int col = r0 + tid; col < W; col += nt)
      swap_and_solve<LA>(a, piv, k0, kb, col);
    __syncthreads();
    if (r0 < nx) {
      if (warp == 0) {
        elim_tiles<LA, kPanel>(a, r0, nx, r0, r0 + kPanel, k0, kb, 0, 1);
        __syncwarp();
        factor_panel<nx, LA>(a, piv, rdiag, r0);
      } else {
        elim_tiles<LA, kPanel>(a, r0, nx, r0 + kPanel, W, k0, kb, warp - 1,
                       kCombineWarps - 1);
      }
    }
    __syncthreads();
  }

  // the back substitution U M = a[:, nx …], M in place: bottom block
  // first, a thread a right-hand side on its diagonal block, then the rows
  // above on the tensor cores
  for (int K = nblk - 1; K >= 0; --K) {
    const int r0 = K * kBlock, kb = imin(kBlock, nx - r0);
    for (int col = nx + tid; col < W; col += nt) {
      double x[kBlock];
#pragma unroll
      for (int i = 0; i < kBlock; ++i)
        x[i] = i < kb ? a[(r0 + i) * LA + col] : 0.0;
#pragma unroll
      for (int i = kBlock - 1; i >= 0; --i)
        if (i < kb) {
          double s = x[i];
#pragma unroll
          for (int l = i + 1; l < kBlock; ++l)
            if (l < kb) s = fma(-a[(r0 + i) * LA + r0 + l], x[l], s);
          x[i] = s * rdiag[r0 + i];
          a[(r0 + i) * LA + col] = x[i];
        }
    }
    __syncthreads();
    if (r0 > 0) {
      elim_tiles<LA, kBlock>(a, 0, r0, nx, W, r0, kb, warp, kCombineWarps);
      __syncthreads();
    }
  }

  // M = [MA₁ | MC₁ | Mb] in a's columns nx … 3nx: A = A₂MA₁ and J =
  // (A₁ᵀJ₂)MA₁ + J₁ to the record, A₂MC₁ → X, their tiles together (each
  // tile of J reads its J₁ before its products); b = A₂Mb + b₂ and η =
  // MA₁ᵀw + η₁
  const double* M = a + nx;
  {
    constexpr int c0 = Tiles<nx, nx>::count;
    auto aY = [&](int i, int k) { return Y[i * LD + k]; };
    auto aZ = [&](int i, int k) { return Z[i * LD + k]; };
    auto bA = [&](int k, int j) { return M[k * LA + j]; };
    auto bC = [&](int k, int j) { return M[k * LA + nx + j]; };
    double pre[2][4];
    block_jobs<kCombineWarps>(
        warp, 3 * c0,
        [&](int item, auto slot, Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0) {
            tile_mma<nx, nx, nx, P>(item, acc, aY, bA);
          } else if (item < 2 * c0) {
            tile_each<nx, nx>(item - c0, [&](int r, int i, int j) {
              pre[P][r] = i < nx && j < nx ? e1[E::J + i * nx + j] : 0.0;
            });
            tile_mma<nx, nx, nx, P>(item - c0, acc, aZ, bA);
          } else {
            tile_mma<nx, nx, nx, P>(item - 2 * c0, acc, aY, bC);
          }
        },
        [&](int item, auto slot, const Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_put<nx, nx, P>(item, acc, [&](int i, int j, double v) {
              eo[E::A + i * nx + j] = v;
            });
          else if (item < 2 * c0)
            tile_each<nx, nx>(item - c0, [&](int r, int i, int j) {
              if (i < nx && j < nx)
                eo[E::J + i * nx + j] = acc.c[P][r] + pre[P][r];
            });
          else
            tile_put<nx, nx, P>(item - 2 * c0, acc,
                                [&](int i, int j, double v) {
                                  X[i * LD + j] = v;
                                });
        });
  }
  if (tid < 2 * nx) {
    double s = 0.0;
    if (tid < nx) {
      for (int k = 0; k < nx; ++k) s += Y[tid * LD + k] * M[k * LA + 2 * nx];
      eo[E::b + tid] = s + add;
    } else {
      const int i = tid - nx;
      for (int k = 0; k < nx; ++k) s += M[k * LA + i] * w[k];
      eo[E::eta + i] = s + add;
    }
  }
  __syncthreads();
  // C = (A₂MC₁)A₂ᵀ + C₂, each tile reading its C₂ before its products
  {
    double pre[2][4];
    block_jobs<kCombineWarps>(
        warp, Tiles<nx, nx>::count,
        [&](int item, auto slot, Acc& acc) {
          constexpr int P = decltype(slot)::value;
          tile_each<nx, nx>(item, [&](int r, int i, int j) {
            pre[P][r] = i < nx && j < nx ? e2[E::C + i * nx + j] : 0.0;
          });
          tile_mma<nx, nx, nx, P>(
              item, acc, [&](int i, int k) { return X[i * LD + k]; },
              [&](int k, int j) { return Y[j * LD + k]; });
        },
        [&](int item, auto slot, const Acc& acc) {
          constexpr int P = decltype(slot)::value;
          tile_each<nx, nx>(item, [&](int r, int i, int j) {
            if (i < nx && j < nx)
              eo[E::C + i * nx + j] = acc.c[P][r] + pre[P][r];
          });
        });
  }
}

// ---- phase 3: the gains ----

// The staged operands and Q terms, then a region that holds d, V, v and
// the products V A, V B and Vx_d until the Q terms are formed and then
// Quu's inverse or factor F, K2's workspace and [k K].
template <class S, Solve G>
struct GainSmem {
  static constexpr int nx = S::nx, nu = S::nu, Wk = 1 + nx;
  static constexpr int schur = G == Solve::kSchur;
  static constexpr int Sx = 0, Bs = Sx + S::n_rx * nx,
                       Qu = Bs + S::n_ru * S::n_uc, Qux = Qu + nu,
                       Quu = Qux + nu * nx, d = Quu + nu * nu, V = d + nx,
                       v = V + nx * nx, Vxd = v + nx, VA = Vxd + nx,
                       VB = VA + nx * nx, F = d, work = F + nu * nu,
                       kK = work + schur * inv_work(nu),
                       doubles = d + cmax(3 * nx + 2 * nx * nx + nx * nu,
                                          nu * nu + schur * inv_work(nu) +
                                              nu * Wk);
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
  using L = GainSmem<S, G>;
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

  // Vx_d = Vx + Vxx d a thread an entry; V A = V + V[:, rx] Sx and
  // V B = V[:, ru] Bs on the tensor cores
  for (int o = tid; o < nx; o += kThreads) {
    double s = 0.0;
    for (int j = 0; j < nx; ++j) s += V[o * nx + j] * sm[L::d + j];
    Vxd[o] = sm[L::v + o] + s;
  }
  auto bu = [&](int q, int u) {           // Bs at input u, zero if dead
    const int cu = r[R::upos + u];
    return cu >= 0 ? sBs[q * S::n_uc + cu] : 0.0;
  };
  {
    constexpr int c0 = Tiles<nx, nx>::count, c1 = Tiles<nx, nu>::count;
    auto aA = [&](int i, int q) { return V[i * nx + r[q]]; };
    auto bA = [&](int q, int j) { return sSx[q * nx + j]; };
    auto aB = [&](int i, int q) { return V[i * nx + r[R::ru + q]]; };
    block_jobs<kWarps>(
        warp, c0 + c1,
        [&](int item, auto slot, Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_mma<nx, nx, S::n_rx, P>(item, acc, aA, bA);
          else
            tile_mma<nx, nu, S::n_ru, P>(item - c0, acc, aB, bu);
        },
        [&](int item, auto slot, const Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_put<nx, nx, P>(item, acc, [&](int i, int j, double v) {
              VA[i * nx + j] = V[i * nx + j] + v;
            });
          else
            tile_put<nx, nu, P>(item - c0, acc, [&](int i, int u, double v) {
              VB[i * nu + u] = v;
            });
        });
  }
  __syncthreads();
  // Qu = lu + BᵀVx_d a thread an entry; Qux = lux + Bᵀ(V A) and Quu = R̃ +
  // Bᵀ(V B) on the tensor cores, in place
  for (int u = tid; u < nu; u += kThreads) {
    const int cu = r[R::upos + u];
    double s = 0.0;
    if (cu >= 0)
      for (int q = 0; q < S::n_ru; ++q)
        s += sBs[q * S::n_uc + cu] * Vxd[r[R::ru + q]];
    Qu[u] += s;
  }
  {
    constexpr int c0 = Tiles<nu, nx>::count, c1 = Tiles<nu, nu>::count;
    auto aT = [&](int u, int q) { return bu(q, u); };
    auto bX = [&](int q, int j) { return VA[r[R::ru + q] * nx + j]; };
    auto bU = [&](int q, int v2) { return VB[r[R::ru + q] * nu + v2]; };
    block_jobs<kWarps>(
        warp, c0 + c1,
        [&](int item, auto slot, Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_mma<nu, nx, S::n_ru, P>(item, acc, aT, bX);
          else
            tile_mma<nu, nu, S::n_ru, P>(item - c0, acc, aT, bU);
        },
        [&](int item, auto slot, const Acc& acc) {
          constexpr int P = decltype(slot)::value;
          if (item < c0)
            tile_put<nu, nx, P>(item, acc, [&](int u, int j, double v) {
              Qux[u * nx + j] += v;
            });
          else
            tile_put<nu, nu, P>(item - c0, acc, [&](int u, int v2, double v) {
              Quu[u * nu + v2] += v;
            });
        });
  }
  __syncthreads();

  // [k K] = −Quu⁻¹ [Qu Qux]
  T* const ks_g = ks + bn * nu;
  T* const Ks_g = Ks + bn * nu * nx;
  if constexpr (G == Solve::kSchur) {
    if (warp == 0) spd_inverse_warp<nu, nu, nu>(Quu, F, sm + L::work);
    __syncthreads();
    block_mma<nu, Wk, nu, kWarps>(
        warp, [&](int i, int u) { return F[i * nu + u]; },
        [&](int u, int c) { return c == 0 ? Qu[u] : Qux[u * nx + c - 1]; },
        [&](int i, int c, double v) { kK[i * Wk + c] = -v; });
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
  constexpr auto element = element_entry<S, T, G>();
  int err = opt_in(element, ElemSmem<S, G>::bytes);
  if (err != 0) return err;
  element<<<dim3(ns + 1, B), kThreads, ElemSmem<S, G>::bytes, st>>>(
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
  err = opt_in(gain_kernel<S, T, G>, GainSmem<S, G>::bytes);
  if (err != 0) return err;
  gain_kernel<S, T, G><<<dim3(ns, B), kThreads, GainSmem<S, G>::bytes, st>>>(
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
    case 16: return fn(Inst<LipRkShape, Solve::kSchur>{});
    case 17: return fn(Inst<LipRkShape, Solve::kCholesky>{});
    case 18: return fn(Inst<LipQuadShape, Solve::kSchur>{});
    case 19: return fn(Inst<LipQuadShape, Solve::kCholesky>{});
    case 20: return fn(Inst<LipQuadRkShape, Solve::kSchur>{});
    case 21: return fn(Inst<LipQuadRkShape, Solve::kCholesky>{});
    case 22: return fn(Inst<LipPointFeetShape, Solve::kSchur>{});
    case 23: return fn(Inst<LipPointFeetShape, Solve::kCholesky>{});
    case 24: return fn(Inst<LipPointFeetRkShape, Solve::kSchur>{});
    case 25: return fn(Inst<LipPointFeetRkShape, Solve::kCholesky>{});
    default: return kUnknownShape;
  }
}

// blocks of `kernel` resident on one SM at `threads` and `bytes` of
// dynamic shared memory, into out[0]; its registers a thread and local
// (spilled) bytes a thread into out[3] and out[6]
template <class Kernel>
int blocks_of(Kernel kernel, int threads, int bytes, int* out) {
  int err = opt_in(kernel, bytes);
  if (err != 0) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, threads, bytes));
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  out[3] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return err;
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

// Shared memory bytes a block of each phase takes (element, combine, gain)
// into out[0..2], blocks of each resident on one SM into out[3..5], their
// registers a thread into out[6..8] and their local (spilled) bytes a
// thread into out[9..11], for instantiation `inst` and float32 (f64 = 0)
// or float64 tensors.
extern "C" int riccati_associative_occupancy(int inst, int f64, int* out) {
  return with_instance(inst, [&](auto in) {
    using I = decltype(in);
    using S = typename I::S;
    out[0] = ElemSmem<S, I::G>::bytes;
    out[1] = CombineSmem<S::nx>::bytes;
    out[2] = GainSmem<S, I::G>::bytes;
    int err = f64 ? blocks_of(element_entry<S, double, I::G>(), kThreads,
                              out[0], out + 3)
                  : blocks_of(element_entry<S, float, I::G>(), kThreads,
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
