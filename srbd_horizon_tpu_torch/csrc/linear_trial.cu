// K13 — the line-search trial of the linearized forward pass
// (`forward_pass="linear"`): the affine δx recursion, the true defects and
// the cost of the plan it gives, and the Armijo test, for every step size
// α of one call, in one launch.
//
// Replaces: `MSDDP._forward_linear` (srbd_horizon_tpu/solvers/msddp.py:
// 1454-1482, an associative scan of affine maps), `_true_defects` (:1484)
// and `total_cost` (:158) inside `_parallel_line_search`'s trial
// (:1507-1531), which XLA fused on the TPU (the JAX package wrote no Pallas
// kernel for them). Plain twin: `kernels/linear_trial.py::linear_trial_plain`.
// Per member and α, from δx₀ = x0 − X₀, for n = 0 … ns−1:
//     ûₙ    = Uₙ + α kₙ + Kₙ δxₙ
//     δxₙ₊₁ = (Aₙ + BₙKₙ) δxₙ + α (Bₙkₙ + dₙ)
// with x̂ₙ = Xₙ + δxₙ, then
//     D̂     = Σₙ ‖step(x̂ₙ, ûₙ) − x̂ₙ₊₁‖²               (the true defects)
//     cost  = Σₙ ‖ρ(x̂ₙ, ûₙ, pₙ)‖² + ‖ρ_N(x̂_N, p_N)‖²
//     merit = cost + ν D̂
//     exp   = −(α ΔV₁ + α² ΔV₂) + (2α − α²) ν D      (D the iterate's defects)
//     ok    = merit0 − merit ≥ β max(exp, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min.
// A = I + Sx on the rows rx and B = Bs on the rows ru and the inputs uc (the
// sliced linearization K1 reads): (A + BK)δx + αBk = δx + Sx δx +
// Bs (Kδx + αk)[uc], over the live rows only. The recursion runs in node
// order (JAX composes the maps in a scan tree and applies the prefix
// products to δx₀), so the two agree to rounding, not bit for bit.
//
// The problem's step and rows are the evaluate kernels' (`FAMILIES`, a
// policy struct each, in float64): the SRBD problem at K3's nine (topology,
// step) instances (csrc/srbd_common.cuh's node_rates, eval_stage and
// eval_terminal, srbd_evaluate's), the LIP at K11's nine
// (csrc/lip_common.cuh's warp-a-node eval_stage and eval_terminal, the
// step by `lip::step_row`) and the isrbd AL inner problem at both AL
// shapes
// (csrc/isrbd_common.cuh, isrbd_evaluate's: the RK2 step of the double
// integrator, 240 / 236 stage and 101 / 97 terminal rows). D̂ is measured in
// the problem's own step, as JAX's `_true_defects` takes `ocp.step`. The
// kernel carries float32 tensors in float64 too, as K1 and K12 do, so that
// a float32 call differs from the float64 twin by the rounding of its
// inputs and outputs only.
//
// Design: one block of eight warps a member with up to four of its α's
// (more α's take more blocks of the member), in two phases.
//   The chain. Each α takes chain warps (`chain_warps`: four for one α,
//   two each for two, one each for three or four); the other warps, at
//   least four, copy: they stage node n+2's operands — K, the live rows of
//   Sx and Bs, k, U, d and X (x0 with node 0; the member's packed parameter
//   rows with node 2) — into a ring of three node slots in shared memory
//   with cp.async while node n computes, neighbouring threads on
//   neighbouring elements, 16- or 8-byte copies where the node's run and
//   its address allow, Bs's rows at an odd stride. One block barrier a node
//   hands a slot over, so the α's share one staged copy and the chain reads
//   no operand from device memory. One warp an α (`chain_node`) keeps δx in
//   registers, two rows a lane, forms Kδx a row a lane with four partial
//   sums, then the n_rx + n_ru dot products of the live rows of Sx (against
//   δx) and Bs (against v = (Kδx + αk)[uc]), item i on lane i and item
//   63 − i past 31, then δxₙ₊₁ = δx + (Sx δx)ⱼ + (Bs v)ⱼ + α dⱼ a row a
//   lane. Two or four warps an α (`group_node`) keep δx in shared memory and
//   cut the rows of K and Sx, then those of Bs, into parts, a part a
//   thread, with a named barrier of the α's warps between the steps: one
//   warp's FP64 and conversion issue bounds a node more than latency does,
//   so one α's node runs on four SM sub-partitions. x̂ₙ and ûₙ go to Xn /
//   Un and to a record an (α, node) in shared memory.
//   The evaluation. After the chain the eight warps evaluate the records
//   node-parallel with the evaluate kernels' body: the prepass (a node's
//   rates or geometry a thread), then an (α, node) item a warp — its
//   parameters in float64, the stage rows' squares, the step and
//   ‖step(x̂ₙ, ûₙ) − x̂ₙ₊₁‖², the terminal rows last — into a sum a node;
//   warp a adds α's nodes over its lanes in a fixed order and takes the
//   Armijo test on one thread, so a call is deterministic. The
//   evaluation's scratch takes the ring's place. `Smem` states every
//   region's bytes.
//
// What bounds it on an H100: one member reads the gains, the plan, the
// sliced A and B, the defects and the parameter rows once for all its α's,
// ~2.3k values a node (~9 KB in float32; ~2.7k and the 357-value parameter
// row on the AL inner problem), and each α does ~4k FLOP of recursion,
// rates and residual rows a node; bytes bound it at fleet sizes
// (chip_smoke.py computes the bound from its inputs). At small B the
// chain's 21 dependent nodes set the time (four warps an α: the Kangaroo
// SRBD problem takes 0.0296 ms a call at B=1 and one α, of which the chain
// alone 0.0224; chip_smoke.py `--k12-versus`, an H100 at 700 W), and the
// evaluation the rest. The nx = 37
// Euler SRBD families hold three blocks an SM (75,216 B in float32 with
// four α's, 80 registers), the others two (registers, or the AL problem's
// 113 KB); at B=4096 with one α that many members a block leave the
// single-α fleet slower than one warp an (member, α) was at the LIP, the
// point-feet biped and the RK families.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "dmma.cuh"
#include "isrbd_common.cuh"
#include "lip_common.cuh"
#include "riccati_common.cuh"
#include "srbd_common.cuh"

namespace {

constexpr int kWarps = 8;             // a block: the chain warps and the copiers
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxAlphas = 4;         // α's of one member a block
constexpr int kStages = 3;            // ring slots: node n+2 streams in at n
constexpr int kUnknownShape = -2;     // a family FAMILIES does not have

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The SRBD problem at the (topology, step) instance S (srbd::KangarooShape,
// QuadShape, PointFeetShape, or one of them under `srbd::Stepped<…, Rk2 |
// Rk4>`): sizes, the sliced rows' counts (K1's shape: every input is a
// live column of B, n_ru = nx under RK), constants, parameters and
// srbd_evaluate's node evaluation.
template <class S>
struct SrbdFamily {
  static constexpr int nx = S::nx, nu = S::nu, n_rx = S::n_rx,
                       n_ru = S::n_ru, n_gx = S::n_gx, n_gu = S::n_gu,
                       n_b = 3, n_uc = S::nu, pw = srbd::Layout<S>::pw,
                       n_params = srbd::kParams, rates = srbd::kRates,
                       scratch = srbd::stage_scratch<S>(),
                       min_blocks = S::nx == 37 && S::Step::stages == 1 ? 3 : 2;
  using Consts = srbd::Consts<double>;
  template <typename T>
  using Params = srbd::Params<T>;
  static Consts consts(const double* s) { return srbd::make_consts<double>(s); }
  template <typename T>
  static Params<T> params(const void* const* p) {
    return srbd::make_params<T>(p);
  }
  __host__ __device__ static constexpr int param_dim(int t) {
    return srbd::param_dim<S>(t);
  }
  __host__ __device__ static constexpr int param_off(int t) {
    return srbd::param_off<S>(t);
  }
  __device__ static void node_rates(const double* x, const double* u,
                                    const Consts& k, double* out) {
    srbd::node_rates<S>(x, u, k, out);
  }
  __device__ static double stage(int lane, const double* x, const double* u,
                                 const double* p, const double* r,
                                 const Consts& k, double* xs,
                                 double (&step)[2]) {
    return srbd::eval_stage<S>(lane, x, u, p, r, k, xs, step);
  }
  __device__ static double terminal(int lane, const double* x,
                                    const double* p, const Consts& k) {
    return srbd::eval_terminal<S>(lane, x, p, k);
  }
};

// The LIP problem at the (topology, step) instance S (lip::KangarooShape,
// QuadShape, PointFeetShape, or one of them under `lip::Stepped<…, Rk2 |
// Rk4>`) with K1's shape K of its sliced linearization (LipShape,
// LipQuadShape, LipPointFeetShape, or their RK shapes, which RK2 and RK4
// share): lip_common.cuh's warp-a-node evaluation, whose step row is
// `lip::step_row` in the instance's step (a lane's pair through the RK
// stages in registers, no stage scratch), no prepass. The cross rows n_b
// and the live inputs n_uc are K1's.
template <class S, class K>
struct LipFamily {
  static_assert(K::nx == S::nx && K::nu == S::nu && K::nt == S::nt &&
                    K::n_rx == S::n_rx && K::n_ru == S::n_ru &&
                    K::n_gx == S::n_gx && K::n_gu == S::n_gu,
                "K1's shape is the instance's");
  static constexpr int nx = S::nx, nu = S::nu, n_rx = S::n_rx,
                       n_ru = S::n_ru, n_gx = S::n_gx, n_gu = S::n_gu,
                       n_b = K::n_b, n_uc = K::n_uc, pw = lip::Layout<S>::pw,
                       n_params = lip::kParams, rates = 0, scratch = 0,
                       min_blocks = 2;
  using Consts = lip::Consts<double>;
  template <typename T>
  using Params = lip::Params<T>;
  static Consts consts(const double* s) { return lip::make_consts<double>(s); }
  template <typename T>
  static Params<T> params(const void* const* p) {
    return lip::make_params<T>(p);
  }
  __host__ __device__ static constexpr int param_dim(int t) {
    return lip::param_dim<S>(t);
  }
  __host__ __device__ static constexpr int param_off(int t) {
    return lip::param_off<S>(t);
  }
  __device__ static void node_rates(const double*, const double*,
                                    const Consts&, double*) {}
  __device__ static double stage(int lane, const double* x, const double* u,
                                 const double* p, const double*,
                                 const Consts& k, double*, double (&step)[2]) {
    step[0] = 0.0;
    step[1] = 0.0;
    return lip::eval_stage<S>(lane, x, u, p, k, &step[0]);
  }
  __device__ static double terminal(int lane, const double* x,
                                    const double* p, const Consts& k) {
    return lip::eval_terminal<S>(lane, x, p, k);
  }
};

// The isrbd AL inner problem at the shape S (isrbd::KangarooAlShape,
// isrbd::QuadAlShape; K1's IsrbdAlShape and QuadAlShape): isrbd_evaluate's
// node evaluation (the geometry prepass, the RK2 step of the double
// integrator, the inner stage and terminal stacks), its 21 parameter
// tensors packed into one row. The rows read u right after x: a record
// holds ûₙ right after x̂ₙ.
template <class S>
struct IsrbdAlFamily {
  static constexpr int nx = S::nx, nu = S::nu, n_rx = S::n_rx,
                       n_ru = S::n_ru, n_gx = S::n_gx, n_gu = S::n_gu,
                       n_b = S::n_b, n_uc = S::n_uc, pw = S::n_par,
                       n_params = isrbd::kParams, rates = isrbd::kGeo,
                       scratch = 0, min_blocks = 2;
  using Consts = isrbd::Consts<S, double>;
  template <typename T>
  using Params = isrbd::Params<T>;
  static Consts consts(const double* s) {
    return isrbd::make_consts<S, double>(s);
  }
  template <typename T>
  static Params<T> params(const void* const* p) {
    return isrbd::make_params<T>(p);
  }
  __host__ __device__ static constexpr int param_dim(int t) {
    return isrbd::param_dim<S>(t);
  }
  __host__ __device__ static constexpr int param_off(int t) {
    return isrbd::param_off<S>(t);
  }
  __device__ static void node_rates(const double* x, const double*,
                                    const Consts& k, double* out) {
    isrbd::node_geometry<S>(x, k, out);
  }
  __device__ static double stage(int lane, const double* x, const double*,
                                 const double* p, const double* r,
                                 const Consts& k, double*, double (&step)[2]) {
    return isrbd::eval_stage<S>(lane, x, p, r, k, step);
  }
  __device__ static double terminal(int lane, const double* x,
                                    const double* p, const Consts& k) {
    return isrbd::eval_terminal<S>(lane, x, p, k);
  }
};

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The chain warps an α takes when a block holds na α's: four for one α, two
// each for two, one each for three or four; the other warps copy.
__host__ __device__ constexpr int chain_warps(int na) {
  return na == 1 ? 4 : na == 2 ? 2 : 1;
}

// How an α's W chain warps share a node out, and the α's scratch
// (doubles). W = 1: Kδx a row a lane, then the n_rx + n_ru dot products of
// the live rows of Sx (against δx) and Bs (against v = (Kδx + αk)[uc]),
// item i on lane i and item 63 − i past 31; scratch δx, v and the items.
// W > 1: step 1 the rows of K and Sx against δx, each cut into h1 parts of
// len1 columns, a (row, part) a lane; step 3 Bs's live rows against v in h3
// parts of len3 (at most four parts, as many as the rows leave the 32W
// lanes, none empty: nine inputs take three parts of three); the parts
// summed in order where they are read; scratch δx, v, step 1's parts, step
// 3's parts.
template <class F, int W>
struct ChainSplit {
  static constexpr int rows1 = F::nu + F::n_rx,
                       h1 = cmax(1, cmin(4, 32 * W / rows1)),
                       len1 = (F::nx + h1 - 1) / h1,
                       len3 = (F::n_uc + cmax(1, cmin(4, 32 * W / F::n_ru)) -
                               1) / cmax(1, cmin(4, 32 * W / F::n_ru)),
                       h3 = (F::n_uc + len3 - 1) / len3;
  static constexpr int dx = 0, v = round_up(F::nx, 2),
                       p1 = v + round_up(F::n_uc, 2),
                       p3 = p1 + round_up(cmax(F::n_rx + F::n_ru, rows1 * h1), 2),
                       size = p3 + round_up(F::n_ru * h3, 2);
};

// The chain's scratch in doubles: the largest over the α's a block holds.
template <class F>
__host__ __device__ constexpr int chain_doubles() {
  return cmax(cmax(ChainSplit<F, chain_warps(1)>::size,
                   2 * ChainSplit<F, chain_warps(2)>::size),
              cmax(3 * ChainSplit<F, chain_warps(3)>::size,
                   4 * ChainSplit<F, chain_warps(4)>::size));
}

// The block's shared memory for family F and tensors of E bytes an element
// (kernels/linear_trial.py::phase_bytes states the same). In order: the
// phase region — during the chain the ring (kStages slots of node
// operands, elements of T) and the chain warps' scratch, during the
// evaluation its scratch —, the member's packed parameter rows (T), the
// records (float64), and the row table (int) with the block's α's
// (float64). Every region starts 16-byte aligned.
template <class F, int E>
struct Smem {
  static constexpr int vec = 16 / E;              // elements in 16 bytes
  // a ring slot, in elements: K (nu × nx), the live rows of Sx (n_rx × nx)
  // and of Bs (n_ru rows of n_uc at the odd stride bs_ld), k, U, d and X
  static constexpr int bs_ld = F::n_uc | 1;
  static constexpr int K = 0, Sx = K + round_up(F::nu * F::nx, vec),
                       Bs = Sx + round_up(F::n_rx * F::nx, vec),
                       k = Bs + round_up(F::n_ru * bs_ld, vec),
                       U = k + round_up(F::nu, vec),
                       d = U + round_up(F::nu, vec),
                       X = d + round_up(F::nx, vec),
                       slot = X + round_up(F::nx, vec);
  // bytes of the ring, then of the ring and the chain's scratch (the
  // largest over the α's a block may hold: ChainSplit)
  static constexpr int ring_bytes = kStages * slot * E,
                       chain_bytes = ring_bytes + 8 * chain_doubles<F>();
  // the evaluation: a warp's parameter row in float64 and stage point (RK),
  // in doubles; a stage node's prepass values and a node's two sums are
  // F::rates and 2 doubles an (α, node)
  static constexpr int e_warp = round_up(F::pw, 2) + round_up(F::scratch, 2);
  // a node's packed parameter row (elements), an (α, node) record (x̂ then
  // û, doubles), the row table (ints: rx and ru positions of each state
  // row, uc position of each input) and the block's α's (doubles)
  static constexpr int prow = round_up(F::pw, vec),
                       rec = round_up(F::nx + F::nu, 2),
                       rows = round_up(2 * F::nx + F::nu, 4),
                       misc_bytes = 4 * rows + 8 * kMaxAlphas;
};

__host__ __device__ constexpr size_t round16(size_t v) {
  return (v + 15) / 16 * 16;
}

// The phase region's bytes at ns stage nodes and nA α's a block.
template <class F, int E>
__host__ __device__ constexpr size_t phase_region(int ns, int nA) {
  using M = Smem<F, E>;
  const size_t eval = 8 * (static_cast<size_t>(nA) * ns * F::rates +
                           2 * static_cast<size_t>(nA) * (ns + 1) +
                           kWarps * M::e_warp);
  return round16(M::chain_bytes > eval ? M::chain_bytes : eval);
}

// The block's dynamic shared memory at ns stage nodes and nA α's a block.
template <class F, int E>
__host__ __device__ constexpr size_t smem_bytes(int ns, int nA) {
  using M = Smem<F, E>;
  return phase_region<F, E>(ns, nA) +
         round16(static_cast<size_t>(ns + 1) * M::prow * E) +
         8 * static_cast<size_t>(nA) * (ns + 1) * M::rec + M::misc_bytes;
}

// The copiers (thread t of nc) start the copies of a contiguous run of
// kCount elements: 16- or 8-byte copies where the run's bytes and the
// source's address allow, else one element a copy.
template <typename T, int kCount>
__device__ __forceinline__ void stage_run(T* dst, const T* src, int t,
                                          int nc) {
  constexpr int bytes = kCount * static_cast<int>(sizeof(T));
  constexpr int V = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : sizeof(T);
  if constexpr (V > static_cast<int>(sizeof(T))) {
    if (reinterpret_cast<uintptr_t>(src) % V == 0) {
      constexpr int per = V / static_cast<int>(sizeof(T));
      for (int i = t; i < kCount / per; i += nc)
        cp_async<V>(dst + i * per, src + i * per);
      return;
    }
  }
  for (int i = t; i < kCount; i += nc) cp_async<sizeof(T)>(dst + i, src + i);
}

// The copiers start the copies of parameter tensors q … of member b's ns1
// nodes into the packed rows (row n at dst + n·prow).
template <class F, int q, typename T>
__device__ __forceinline__ void stage_params(
    T* dst, const typename F::template Params<T>& P, size_t b, int ns1,
    int t, int nc) {
  if constexpr (q < F::n_params) {
    constexpr int dim = F::param_dim(q), off = F::param_off(q);
    constexpr int prow = Smem<F, sizeof(T)>::prow;
    const T* src = P.p[q] + b * ns1 * dim;
    for (int i = t; i < ns1 * dim; i += nc) {
      const int n = i / dim;
      cp_async<sizeof(T)>(dst + n * prow + off + (i - n * dim), src + i);
    }
    stage_params<F, q + 1>(dst, P, b, ns1, t, nc);
  }
}

// The block's threads (t of nc) start node n's copies into its ring slot
// (with node 0 x0, into `x0s`; with node 2 the parameter rows) and close
// them into one group; past the terminal node the group holds only what
// n == 2 adds.
template <class F, typename T>
__device__ __forceinline__ void issue_node(
    T* ring, T* prm, T* x0s, const T* __restrict__ x0, const T* __restrict__ X,
    const T* __restrict__ U, const T* __restrict__ ks,
    const T* __restrict__ Ks, const T* __restrict__ Sx,
    const T* __restrict__ Bs, const T* __restrict__ d,
    const typename F::template Params<T>& P, size_t b, int n, int ns, int t,
    int nc) {
  using M = Smem<F, sizeof(T)>;
  constexpr int nx = F::nx, nu = F::nu, n_rx = F::n_rx, n_ru = F::n_ru,
                n_uc = F::n_uc;
  T* sl = ring + (n % kStages) * M::slot;
  if (n <= ns) {
    stage_run<T, nx>(sl + M::X, X + (b * (ns + 1) + n) * nx, t, nc);
    if (n == 0) stage_run<T, nx>(x0s, x0 + b * nx, t, nc);
  }
  if (n < ns) {
    const size_t bn = b * ns + n;
    stage_run<T, nu * nx>(sl + M::K, Ks + bn * (nu * nx), t, nc);
    stage_run<T, n_rx * nx>(sl + M::Sx, Sx + bn * (n_rx * nx), t, nc);
    const T* bs = Bs + bn * (n_ru * n_uc);
    for (int i = t; i < n_ru * n_uc; i += nc) {
      const int r = i / n_uc;
      cp_async<sizeof(T)>(sl + M::Bs + r * M::bs_ld + (i - r * n_uc), bs + i);
    }
    stage_run<T, nu>(sl + M::k, ks + bn * nu, t, nc);
    stage_run<T, nu>(sl + M::U, U + bn * nu, t, nc);
    stage_run<T, nx>(sl + M::d, d + bn * nx, t, nc);
  }
  if (n == 2) stage_params<F, 0>(prm, P, b, ns + 1, t, nc);
  cp_async_commit();
}

// Positions in the block's row table: of state row j in rx and in ru (or
// −1), of input i in uc (or −1).
template <class F>
struct RowTable {
  static constexpr int rpos = 0, qpos = F::nx, ucpos = 2 * F::nx;
  // where uc starts in the packed rows (RiccatiRows.packed)
  static constexpr int table_uc =
      F::n_rx + F::n_ru + F::n_gx + F::n_gu + 2 * F::n_b;
};

// One chain warp's node n (W = 1): x̂ₙ and ûₙ into the record and to Xn /
// Un, then δxₙ₊₁ into dxr (rows lane and lane + 32).
template <class F, typename T>
__device__ __forceinline__ void chain_node(const T* sl, const int* rows,
                                           double* cs, double* rec,
                                           double alpha, double (&dxr)[2],
                                           T* __restrict__ Xo,
                                           T* __restrict__ Uo, int lane) {
  using M = Smem<F, sizeof(T)>;
  using C = ChainSplit<F, 1>;
  using R = RowTable<F>;
  constexpr int nx = F::nx, nu = F::nu, n_rx = F::n_rx,
                n_items = F::n_rx + F::n_ru;
  double* dxs = cs + C::dx;
  double* vs = cs + C::v;
  double* part = cs + C::p1;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = lane + 32 * c;
    if (j < nx) {
      const double v = static_cast<double>(sl[M::X + j]) + dxr[c];
      rec[j] = v;
      Xo[j] = static_cast<T>(v);
      dxs[j] = dxr[c];
    }
  }
  __syncwarp();
  if (lane < nu) {               // ûᵢ = (Uᵢ + α kᵢ) + (Kδx)ᵢ, a row a lane
    const T* Kr = sl + M::K + lane * nx;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
#pragma unroll
    for (int j = 0; j + 3 < nx; j += 4) {
      s0 += static_cast<double>(Kr[j]) * dxs[j];
      s1 += static_cast<double>(Kr[j + 1]) * dxs[j + 1];
      s2 += static_cast<double>(Kr[j + 2]) * dxs[j + 2];
      s3 += static_cast<double>(Kr[j + 3]) * dxs[j + 3];
    }
#pragma unroll
    for (int j = nx / 4 * 4; j < nx; ++j)
      s0 += static_cast<double>(Kr[j]) * dxs[j];
    const double w = (s0 + s1) + (s2 + s3);
    const double ak = alpha * static_cast<double>(sl[M::k + lane]);
    const double u = (static_cast<double>(sl[M::U + lane]) + ak) + w;
    rec[nx + lane] = u;
    Uo[lane] = static_cast<T>(u);
    const int c = rows[R::ucpos + lane];
    if (c >= 0) vs[c] = w + ak;
  }
  __syncwarp();
  {   // item i: row i of Sx against δx (i < n_rx) or row i − n_rx of Bs
      // against v; lane l takes item l, and item 63 − l past 31 (a Bs row)
    const int i = lane < n_items ? lane : 0;
    const bool sx = i < n_rx;
    const T* row = sx ? sl + M::Sx + i * nx : sl + M::Bs + (i - n_rx) * M::bs_ld;
    const double* v = sx ? dxs : vs;
    const int len = sx ? nx : F::n_uc;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
#pragma unroll
    for (int y = 0; y < nx; y += 4) {
      if (y < len) s0 += static_cast<double>(row[y]) * v[y];
      if (y + 1 < len) s1 += static_cast<double>(row[y + 1]) * v[y + 1];
      if (y + 2 < len) s2 += static_cast<double>(row[y + 2]) * v[y + 2];
      if (y + 3 < len) s3 += static_cast<double>(row[y + 3]) * v[y + 3];
    }
    if (lane < n_items) part[i] = (s0 + s1) + (s2 + s3);
    if constexpr (n_items > 32) {
      const int i2 = 63 - lane;
      static_assert(n_rx <= 32, "the second items are Bs rows");
      if (i2 < n_items) {
        const T* r2 = sl + M::Bs + (i2 - n_rx) * M::bs_ld;
        double t0 = 0.0, t1 = 0.0, t2 = 0.0, t3 = 0.0;
#pragma unroll
        for (int y = 0; y + 3 < F::n_uc; y += 4) {
          t0 += static_cast<double>(r2[y]) * vs[y];
          t1 += static_cast<double>(r2[y + 1]) * vs[y + 1];
          t2 += static_cast<double>(r2[y + 2]) * vs[y + 2];
          t3 += static_cast<double>(r2[y + 3]) * vs[y + 3];
        }
#pragma unroll
        for (int y = F::n_uc / 4 * 4; y < F::n_uc; ++y)
          t0 += static_cast<double>(r2[y]) * vs[y];
        part[i2] = (t0 + t1) + (t2 + t3);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 2; ++c) {  // δxₙ₊₁ = δx + (Sx δx) + (Bs v) + α d
    const int j = lane + 32 * c;
    if (j < nx) {
      const int rr = rows[R::rpos + j], q = rows[R::qpos + j];
      double m = dxr[c];
      if (rr >= 0) m += part[rr];
      if (q >= 0) m += part[n_rx + q];
      dxr[c] = m + alpha * static_cast<double>(sl[M::d + j]);
    }
  }
}

// A barrier of the W chain warps of α a (a named barrier; a < 2 whenever
// W > 1).
template <int W>
__device__ __forceinline__ void group_sync(int a) {
  if constexpr (W == 1) {
    __syncwarp();
  } else if (a == 0) {
    asm volatile("bar.sync 1, %0;" ::"n"(32 * W) : "memory");
  } else {
    asm volatile("bar.sync 2, %0;" ::"n"(32 * W) : "memory");
  }
}

// Node n of α a on its W > 1 chain warps (g the thread's place among their
// 32W threads), δx in the α's scratch: x̂ₙ, the parts of Kδx and Sx δx, ûₙ
// and v, the parts of Bs v, δxₙ₊₁; the warps' barrier between the steps.
// x̂_N alone at the terminal node.
template <class F, int W, typename T>
__device__ __forceinline__ void group_node(const T* sl, const int* rows,
                                           double* cs, double* rec,
                                           double alpha, T* __restrict__ Xo,
                                           T* __restrict__ Uo, int a, int g,
                                           bool terminal) {
  using M = Smem<F, sizeof(T)>;
  using C = ChainSplit<F, W>;
  using R = RowTable<F>;
  constexpr int nx = F::nx, nu = F::nu, n_ru = F::n_ru, n_uc = F::n_uc;
  double* dxs = cs + C::dx;
  for (int j = g; j < nx; j += 32 * W) {           // x̂ₙ
    const double v = static_cast<double>(sl[M::X + j]) + dxs[j];
    rec[j] = v;
    Xo[j] = static_cast<T>(v);
  }
  if (terminal) return;
  if (g < C::rows1 * C::h1) {                      // Kδx, Sx δx parts
    const int row = g / C::h1, j0 = (g - row * C::h1) * C::len1;
    const T* mr = row < nu ? sl + M::K + row * nx
                           : sl + M::Sx + (row - nu) * nx;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
#pragma unroll
    for (int e = 0; e < C::len1; e += 4) {
      if (j0 + e < nx) s0 += static_cast<double>(mr[j0 + e]) * dxs[j0 + e];
      if (e + 1 < C::len1 && j0 + e + 1 < nx)
        s1 += static_cast<double>(mr[j0 + e + 1]) * dxs[j0 + e + 1];
      if (e + 2 < C::len1 && j0 + e + 2 < nx)
        s2 += static_cast<double>(mr[j0 + e + 2]) * dxs[j0 + e + 2];
      if (e + 3 < C::len1 && j0 + e + 3 < nx)
        s3 += static_cast<double>(mr[j0 + e + 3]) * dxs[j0 + e + 3];
    }
    cs[C::p1 + g] = (s0 + s1) + (s2 + s3);
  }
  group_sync<W>(a);
  if (g < nu) {                                    // ûₙ and v
    const double* part = cs + C::p1 + g * C::h1;
    double w = part[0];
#pragma unroll
    for (int q = 1; q < C::h1; ++q) w += part[q];
    const double ak = alpha * static_cast<double>(sl[M::k + g]);
    const double u = (static_cast<double>(sl[M::U + g]) + ak) + w;
    rec[nx + g] = u;
    Uo[g] = static_cast<T>(u);
    const int c = rows[R::ucpos + g];
    if (c >= 0) cs[C::v + c] = w + ak;
  }
  group_sync<W>(a);
  if (g < n_ru * C::h3) {                          // Bs v parts
    const int q = g / C::h3, c0 = (g - q * C::h3) * C::len3;
    const T* br = sl + M::Bs + q * M::bs_ld;
    const double* v = cs + C::v;
    double s0 = 0.0, s1 = 0.0;
#pragma unroll
    for (int e = 0; e < C::len3; e += 2) {
      if (c0 + e < n_uc) s0 += static_cast<double>(br[c0 + e]) * v[c0 + e];
      if (e + 1 < C::len3 && c0 + e + 1 < n_uc)
        s1 += static_cast<double>(br[c0 + e + 1]) * v[c0 + e + 1];
    }
    cs[C::p3 + g] = s0 + s1;
  }
  group_sync<W>(a);
  for (int j = g; j < nx; j += 32 * W) {           // δxₙ₊₁
    const int rr = rows[R::rpos + j], q = rows[R::qpos + j];
    double m = dxs[j];
    if (rr >= 0) {
      const double* part = cs + C::p1 + (nu + rr) * C::h1;
      double t = part[0];
#pragma unroll
      for (int k = 1; k < C::h1; ++k) t += part[k];
      m += t;
    }
    if (q >= 0) {
      const double* part = cs + C::p3 + q * C::h3;
      double t = part[0];
#pragma unroll
      for (int k = 1; k < C::h3; ++k) t += part[k];
      m += t;
    }
    dxs[j] = m + alpha * static_cast<double>(sl[M::d + j]);
  }
}

// The chain phase of a block whose α's take W chain warps each: the
// copiers (the warps past na·W) keep the ring two nodes ahead, one block
// barrier a node hands a slot over, the chain warps run their α's nodes.
template <class F, int W, typename T>
__device__ __forceinline__ void run_chain(
    T* ring, T* prm, T* x0s, double* cscr, double* recs, const int* rows,
    const double* alph, const T* __restrict__ x0, const T* __restrict__ X,
    const T* __restrict__ U, const T* __restrict__ ks,
    const T* __restrict__ Ks, const T* __restrict__ Sx,
    const T* __restrict__ Bs, const T* __restrict__ d,
    const typename F::template Params<T>& P, size_t b, int a0, int na,
    int B, int ns, int tid, T* __restrict__ Xn, T* __restrict__ Un) {
  using M = Smem<F, sizeof(T)>;
  using C = ChainSplit<F, W>;
  constexpr int nx = F::nx, nu = F::nu;
  const int ns1 = ns + 1, warp = tid / 32, lane = tid % 32;
  const bool chain = warp < na * W;
  const int t = tid - 32 * W * na, nc = kThreads - 32 * W * na;  // copier t of nc
  const int a = chain ? warp / W : 0;              // a chain warp's α
  const int g = tid - 32 * W * a;                  // … and its place there
  const double alpha = alph[a];
  const size_t mb = static_cast<size_t>(a0 + a) * B + b;
  double* cs = cscr + a * C::size;
  double dxr[2] = {0.0, 0.0};                      // W = 1: δx, two rows a lane
  for (int n = 0; n <= ns; ++n) {
    if (!chain) cp_async_wait_group<1>();          // node n has arrived
    __syncthreads();                               // … for every thread
    if (!chain) {                                  // node n + 2 streams in
      issue_node<F>(ring, prm, x0s, x0, X, U, ks, Ks, Sx, Bs, d, P, b, n + 2,
                    ns, t, nc);
      continue;
    }
    const T* sl = ring + (n % kStages) * M::slot;
    double* rec = recs + (static_cast<size_t>(a) * ns1 + n) * M::rec;
    T* Xo = Xn + (mb * ns1 + n) * nx;
    T* Uo = Un + (mb * ns + n) * nu;
    if constexpr (W == 1) {
      if (n == 0) {                                // δx₀ = x0 − X₀
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lane + 32 * c;
          if (j < nx)
            dxr[c] = static_cast<double>(x0s[j]) - static_cast<double>(sl[M::X + j]);
        }
      }
      if (n < ns) {
        chain_node<F>(sl, rows, cs, rec, alpha, dxr, Xo, Uo, lane);
      } else {                                     // x̂_N
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lane + 32 * c;
          if (j < nx) {
            const double v = static_cast<double>(sl[M::X + j]) + dxr[c];
            rec[j] = v;
            Xo[j] = static_cast<T>(v);
          }
        }
      }
    } else {
      if (n == 0) {                                // δx₀ = x0 − X₀
        for (int j = g; j < nx; j += 32 * W)
          cs[C::dx + j] =
              static_cast<double>(x0s[j]) - static_cast<double>(sl[M::X + j]);
        group_sync<W>(a);
      }
      group_node<F, W>(sl, rows, cs, rec, alpha, Xo, Uo, a, g, n == ns);
    }
  }
}

// Blocks an SM the registers are held to: the family's with float32
// tensors; two with float64 ones, whose ring and parameter rows take
// twice the bytes (two blocks an SM at most).
template <class F, typename T>
constexpr int launch_min_blocks = sizeof(T) == 4 ? F::min_blocks : 2;

template <class F, typename T>
__global__ void __launch_bounds__(kThreads, (launch_min_blocks<F, T>))
linear_trial_kernel(const T* __restrict__ x0, const T* __restrict__ X,
                    const T* __restrict__ U, const T* __restrict__ ks,
                    const T* __restrict__ Ks, const T* __restrict__ Sx,
                    const T* __restrict__ Bs, const T* __restrict__ d,
                    const int* __restrict__ table,
                    const T* __restrict__ alphas,
                    typename F::template Params<T> P,
                    const T* __restrict__ merit0, const T* __restrict__ Dsq,
                    const T* __restrict__ dV1, const T* __restrict__ dV2,
                    int B, int ns, int nA,
                    const __grid_constant__ typename F::Consts k, double nu_w,
                    double beta, double alpha_min, int evaluate,
                    T* __restrict__ Xn, T* __restrict__ Un,
                    T* __restrict__ cost_out, T* __restrict__ merit_out,
                    bool* __restrict__ ok_out) {
  using M = Smem<F, sizeof(T)>;
  using R = RowTable<F>;
  constexpr int nx = F::nx, nu = F::nu;
  static_assert(nx <= 64 && nu <= 32 && F::n_uc <= nx &&
                    F::n_rx + F::n_ru <= 64,
                "lane layout");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = (nA + kMaxAlphas - 1) / kMaxAlphas;
  const size_t b = blockIdx.x / groups;
  const int a0 = (blockIdx.x % groups) * kMaxAlphas;
  const int na = nA - a0 < kMaxAlphas ? nA - a0 : kMaxAlphas;
  const int ns1 = ns + 1;
  const size_t phase = phase_region<F, sizeof(T)>(ns, na);
  T* ring = reinterpret_cast<T*>(smem_raw);
  double* cscr = reinterpret_cast<double*>(smem_raw + M::ring_bytes);
  T* prm = reinterpret_cast<T*>(smem_raw + phase);
  double* recs = reinterpret_cast<double*>(
      smem_raw + phase + round16(static_cast<size_t>(ns1) * M::prow * sizeof(T)));
  int* rows = reinterpret_cast<int*>(recs + static_cast<size_t>(na) * ns1 * M::rec);
  double* alph = reinterpret_cast<double*>(rows + M::rows);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // x0 waits for node 0 in α 0's terminal record, which x̂_N takes last
  T* x0s = reinterpret_cast<T*>(recs + static_cast<size_t>(ns) * M::rec);
  const int nchain = 32 * chain_warps(na) * na;   // chain threads
  if (tid >= nchain) {
    issue_node<F>(ring, prm, x0s, x0, X, U, ks, Ks, Sx, Bs, d, P, b, 0, ns,
                  tid - nchain, kThreads - nchain);
    issue_node<F>(ring, prm, x0s, x0, X, U, ks, Ks, Sx, Bs, d, P, b, 1, ns,
                  tid - nchain, kThreads - nchain);
  }
  for (int e = tid; e < 2 * nx + nu; e += kThreads) rows[e] = -1;
  if (tid < na) alph[tid] = static_cast<double>(alphas[a0 + tid]);
  __syncthreads();
  for (int e = tid; e < F::n_rx; e += kThreads) rows[R::rpos + table[e]] = e;
  for (int e = tid; e < F::n_ru; e += kThreads)
    rows[R::qpos + table[F::n_rx + e]] = e;
  for (int e = tid; e < F::n_uc; e += kThreads)
    rows[R::ucpos + table[R::table_uc + e]] = e;
  switch (chain_warps(na)) {  // the chain's first barrier orders the table
    case 4:
      run_chain<F, 4>(ring, prm, x0s, cscr, recs, rows, alph, x0, X, U, ks,
                      Ks, Sx, Bs, d, P, b, a0, na, B, ns, tid, Xn, Un);
      break;
    case 2:
      run_chain<F, 2>(ring, prm, x0s, cscr, recs, rows, alph, x0, X, U, ks,
                      Ks, Sx, Bs, d, P, b, a0, na, B, ns, tid, Xn, Un);
      break;
    default:
      run_chain<F, 1>(ring, prm, x0s, cscr, recs, rows, alph, x0, X, U, ks,
                      Ks, Sx, Bs, d, P, b, a0, na, B, ns, tid, Xn, Un);
      break;
  }
  cp_async_wait_group<0>();
  __syncthreads();                                 // the ring is free
  if (!evaluate) return;

  // ---- the evaluation: its scratch takes the ring's place ----
  double* rates = reinterpret_cast<double*>(smem_raw);
  double* node_cost = rates + static_cast<size_t>(na) * ns * F::rates;
  double* node_dsq = node_cost + na * ns1;
  double* pbuf = node_dsq + na * ns1 + warp * M::e_warp;
  double* xs = pbuf + round_up(F::pw, 2);
  if constexpr (F::rates > 0) {                    // the prepass, a node a thread
    for (int it = tid; it < na * ns; it += kThreads) {
      const double* rec = recs + (static_cast<size_t>(it / ns) * ns1 + it % ns) * M::rec;
      F::node_rates(rec, rec + nx, k, rates + it * F::rates);
    }
    __syncthreads();
  }
  for (int it = warp; it < na * ns1; it += kWarps) {   // an (α, node) a warp
    const int a = it / ns1, n = it - a * ns1;
    const double* rec = recs + static_cast<size_t>(it) * M::rec;
    const T* pn = prm + n * M::prow;
    const double* p;
    if constexpr (sizeof(T) == sizeof(double)) {
      p = reinterpret_cast<const double*>(pn);
    } else {
      for (int e = lane; e < F::pw; e += 32) pbuf[e] = static_cast<double>(pn[e]);
      __syncwarp();
      p = pbuf;
    }
    double acc, dsq = 0.0;
    if (n < ns) {                                  // warp-uniform
      double step[2];
      acc = F::stage(lane, rec, rec + nx, p,
                     rates + (static_cast<size_t>(a) * ns + n) * F::rates, k,
                     xs, step);
      const double* next = rec + M::rec;           // x̂ₙ₊₁
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j < nx) {
          const double df = step[c] - next[j];
          dsq += df * df;
        }
      }
    } else {
      acc = F::terminal(lane, rec, p, k);
    }
    acc = rigid::warp_sum(acc);
    dsq = rigid::warp_sum(dsq);
    if (lane == 0) {
      node_cost[it] = acc;
      node_dsq[it] = dsq;
    }
    __syncwarp();                                  // pbuf and xs are free
  }
  __syncthreads();
  if (warp >= na) return;
  const double alpha = alph[warp];
  double c = 0.0, dd = 0.0;                        // α's stage nodes, lane by lane
  for (int n = lane; n < ns; n += 32) {
    c += node_cost[warp * ns1 + n];
    dd += node_dsq[warp * ns1 + n];
  }
  c = rigid::warp_sum(c);
  dd = rigid::warp_sum(dd);
  if (lane == 0) {
    const double cost = c + node_cost[warp * ns1 + ns];
    const double D = static_cast<double>(Dsq[b]);
    const double merit = cost + nu_w * dd;
    const double expected =
        -(alpha * static_cast<double>(dV1[b]) +
          (alpha * alpha) * static_cast<double>(dV2[b])) +
        ((2.0 * alpha - alpha * alpha) * nu_w) * D;
    const double exp_min = expected < 1e-16 ? 1e-16 : expected;  // NaN stays
    const size_t o = static_cast<size_t>(a0 + warp) * B + b;
    cost_out[o] = static_cast<T>(cost);
    merit_out[o] = static_cast<T>(merit);
    ok_out[o] = (static_cast<double>(merit0[b]) - merit >= beta * exp_min) &&
                isfinite(merit) && (alpha >= alpha_min);
  }
}

// Let a kernel take `bytes` of dynamic shared memory (above 48 KB only
// after the attribute is raised).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int blocks_a_member(int nA) { return (nA + kMaxAlphas - 1) / kMaxAlphas; }
int alphas_a_block(int nA) { return nA < kMaxAlphas ? nA : kMaxAlphas; }

template <class F, typename T>
int launch(const void* x0, const void* X, const void* U, const void* ks,
           const void* Ks, const void* Sx, const void* Bs, const void* d,
           const void* rows, const void* alphas, const void* const* params,
           const void* merit0, const void* D, const void* dV1,
           const void* dV2, int B, int ns, int nA, const double* scalars,
           double nu_w, double beta, double alpha_min, int evaluate, void* Xn,
           void* Un, void* cost, void* merit, void* ok, void* stream) {
  if (static_cast<long long>(B) * nA == 0) return 0;
  const size_t bytes = smem_bytes<F, sizeof(T)>(ns, alphas_a_block(nA));
  auto kernel = linear_trial_kernel<F, T>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>(B) * blocks_a_member(nA);
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(X),
      static_cast<const T*>(U), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(Sx),
      static_cast<const T*>(Bs), static_cast<const T*>(d),
      static_cast<const int*>(rows), static_cast<const T*>(alphas),
      F::template params<T>(params), static_cast<const T*>(merit0),
      static_cast<const T*>(D), static_cast<const T*>(dV1),
      static_cast<const T*>(dV2), B, ns, nA, F::consts(scalars), nu_w, beta,
      alpha_min, evaluate, static_cast<T*>(Xn), static_cast<T*>(Un),
      static_cast<T*>(cost), static_cast<T*>(merit), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// fn(F{}) for the family at `index` (kernels/linear_trial.py::FAMILIES)
template <class Fn>
int with_family(int index, Fn fn) {
  switch (index) {
    case 0: return fn(SrbdFamily<srbd::KangarooShape>{});
    case 1: return fn(LipFamily<lip::KangarooShape, LipShape>{});
    case 2: return fn(SrbdFamily<srbd::QuadShape>{});
    case 3: return fn(IsrbdAlFamily<isrbd::KangarooAlShape>{});
    case 4: return fn(IsrbdAlFamily<isrbd::QuadAlShape>{});
    case 5: return fn(SrbdFamily<srbd::PointFeetShape>{});
    case 6: return fn(SrbdFamily<srbd::Stepped<srbd::KangarooShape, srbd::Rk2>>{});
    case 7: return fn(SrbdFamily<srbd::Stepped<srbd::KangarooShape, srbd::Rk4>>{});
    case 8: return fn(SrbdFamily<srbd::Stepped<srbd::QuadShape, srbd::Rk2>>{});
    case 9: return fn(SrbdFamily<srbd::Stepped<srbd::QuadShape, srbd::Rk4>>{});
    case 10: return fn(SrbdFamily<srbd::Stepped<srbd::PointFeetShape, srbd::Rk2>>{});
    case 11: return fn(SrbdFamily<srbd::Stepped<srbd::PointFeetShape, srbd::Rk4>>{});
    case 12: return fn(LipFamily<lip::QuadShape, LipQuadShape>{});
    case 13: return fn(LipFamily<lip::PointFeetShape, LipPointFeetShape>{});
    case 14: return fn(LipFamily<lip::Stepped<lip::KangarooShape, lip::Rk2>, LipRkShape>{});
    case 15: return fn(LipFamily<lip::Stepped<lip::KangarooShape, lip::Rk4>, LipRkShape>{});
    case 16: return fn(LipFamily<lip::Stepped<lip::QuadShape, lip::Rk2>, LipQuadRkShape>{});
    case 17: return fn(LipFamily<lip::Stepped<lip::QuadShape, lip::Rk4>, LipQuadRkShape>{});
    case 18: return fn(LipFamily<lip::Stepped<lip::PointFeetShape, lip::Rk2>, LipPointFeetRkShape>{});
    case 19: return fn(LipFamily<lip::Stepped<lip::PointFeetShape, lip::Rk4>, LipPointFeetRkShape>{});
    default: return kUnknownShape;
  }
}

template <class F, typename T>
int occupancy(int ns, int nA, int* out) {
  auto kernel = linear_trial_kernel<F, T>;
  const size_t bytes = smem_bytes<F, sizeof(T)>(ns, alphas_a_block(nA));
  cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads,
                                                      bytes);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = static_cast<int>(bytes);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

}  // namespace

// `family` indexes FAMILIES; the sizes are the family's (the wrapper checks
// them). `scalars` holds the family's host constants (kernel_scalars).
// evaluate = 0 runs the chain alone (Xn and Un; cost, merit and ok are not
// written): chip_smoke.py times the two phases apart with it.
#define LINEAR_TRIAL_ENTRY(NAME, T)                                           \
  extern "C" int NAME(                                                        \
      int family, const void* x0, const void* X, const void* U,               \
      const void* ks, const void* Ks, const void* Sx, const void* Bs,         \
      const void* d, const void* rows, const void* alphas,                    \
      const void* const* params, const void* merit0, const void* D,           \
      const void* dV1, const void* dV2, int B, int ns, int nA,                \
      const double* scalars, double nu_w, double beta, double alpha_min,      \
      int evaluate, void* Xn, void* Un, void* cost, void* merit, void* ok,    \
      void* stream) {                                                         \
    return with_family(family, [&](auto f) {                                  \
      return launch<decltype(f), T>(x0, X, U, ks, Ks, Sx, Bs, d, rows,        \
                                    alphas, params, merit0, D, dV1, dV2, B,   \
                                    ns, nA, scalars, nu_w, beta, alpha_min,   \
                                    evaluate, Xn, Un, cost, merit, ok,        \
                                    stream);                                  \
    });                                                                       \
  }

LINEAR_TRIAL_ENTRY(linear_trial_f32, float)
LINEAR_TRIAL_ENTRY(linear_trial_f64, double)

// K13's occupancy for the family at `family`, float32 (f64 = 0) or float64
// tensors, ns stage nodes and nA step sizes a call: out[0] blocks an SM,
// out[1] dynamic shared memory bytes a block, out[2] registers a thread,
// out[3] local bytes a thread.
extern "C" int linear_trial_occupancy(int family, int f64, int ns, int nA,
                                      int* out) {
  return with_family(family, [&](auto f) {
    using F = decltype(f);
    return f64 ? occupancy<F, double>(ns, nA, out)
               : occupancy<F, float>(ns, nA, out);
  });
}
