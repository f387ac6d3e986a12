// K3 — the line-search trial of the batched MS-DDP solver on the SRBD
// problem: the rollout, its cost and the Armijo test for every step size
// α of one call, in one launch; and srbd_evaluate, the cost and the
// largest defect of a given plan, with no rollout.
//
// Replaces: `MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:1391-1410),
// a `lax.scan` over the horizon, and the trial's `total_cost`/`_stage_rho`
// (:150-165) with the Armijo test (:843-853), all of which XLA fused on the
// TPU (the JAX package wrote no Pallas kernel for them), with the SRBD
// step (Euler, RK2 or RK4 of srbd_horizon_tpu/models/srbd.py::srbd_xdot;
// `srbd::step_rows`) fused in. Plain twin:
// `kernels/rollout.py::srbd_trial_plain`. Per member and α, for
// n = 0 … ns−1:
//     uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
//     x̂ₙ₊₁ = step(x̂ₙ, uₙ) − (1 − α) dₙ
// then
//     cost  = Σₙ ‖ρ(x̂ₙ, uₙ, pₙ)‖² + ‖ρ_N(x̂_N, p_N)‖²
//     merit = cost + ν (1 − α)² D
//     exp   = −(α ΔV₁ + α² ΔV₂) + (2α − α²) ν D
//     ok    = merit0 − merit ≥ β max(exp, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min
// where ẋ is the SRBD double integrator with fSRBD accelerations and ρ the
// stacked stage residual (csrc/srbd_common.cuh holds both, shared with K4).
// A NaN `exp` stays NaN through the max (as torch.clamp and jnp.maximum
// keep it), so the comparison, and `ok`, is false. Built without
// --use_fast_math, so isfinite and NaN comparisons are exact.
//
// srbd_evaluate replaces `jax.vmap(MSDDP.total_cost)` and
// `jax.vmap(MSDDP._true_defects)` (msddp.py:1222, :1240, :1484-1490), the
// solve's starting cost and its final defect norm: per member
//     cost       = Σₙ ‖ρ(Xₙ, Uₙ, pₙ)‖² + ‖ρ_N(X_N, p_N)‖²
//     defect_max = maxₙ,ᵢ |step(Xₙ, Uₙ) − Xₙ₊₁|ᵢ   (NaN if any is NaN)
// Plain twin: `kernels/rollout.py::srbd_evaluate_plain`.
//
// Both are compiled for fifteen instances (csrc/srbd_common.cuh): the
// Kangaroo's line feet (`srbd::KangarooShape`, 73 stage rows), the
// quadruped's point feet (`srbd::QuadShape`, 69: no relative-velocity
// rows), the point-feet biped (`srbd::PointFeetShape`, 45), the
// square-feet biped (`srbd::SquareFeetShape`, 129) and the line-feet
// quadruped (`srbd::LineFeetQuadShape`, 125), each under the Euler,
// RK2 and RK4 steps. In each, every loop over rows and columns has
// a constant trip count and every offset is a constant; the contact
// topology and the step pick the instantiation at launch, and the wrappers
// refuse other sizes. Under RK2 and RK4 a node's step evaluates the rates
// 2 or 4 times (`srbd::step_rows`: each later stage point goes through the
// warp's scratch in shared memory, its geometry and contact sums on every
// lane as at x̂), so K3's chain, which sets its time, grows to match
// (0.0615 / 0.0883 ms at B=512 under RK2 / RK4 against 0.0480 under
// Euler, one α, an H100 at 700 W, chip_smoke.py phase 14); the
// evaluation's warps take the same step for the defects.
//
// What bounds K3 on an H100: one (member, α) reads the gains, the plan, the
// defects and 20 parameter values per node, ~1.0k values per node (4 KB in
// f32), and does ~2.3k FLOP of rollout and ~0.4k of residual per node. At
// B=512, ns=20 and one α that is ~42 MB (0.013 ms at 3.35 TB/s), so bytes
// bound the work; but each member is a chain of 20 dependent nodes, and at
// B ≤ 528 the card holds at most four of those chains an SM, one a warp
// scheduler, so the chain's latency sets the time: K3 takes about as long
// at B=1 as at B=512 (`k3_size_probe` in chip_smoke.py prints both). The
// first design paid several device-memory round trips per node in that chain,
// walked the gain rows with stride 37 through L1, and ran the rigid-body
// rates on one lane; it took ~10× the byte bound. This one takes ~0.048 ms
// at B=512 and ~0.046 ms at B=1 with one α on an H100 at 700 W
// (`k3_size_probe`): ~2.3 µs a node of chain, 3.6× the byte bound, spent
// about equally in the rigid-body rates, the residual rows and the rest.
//
// Design: one warp per (member, α); consecutive warps of a block are the
// α's of one member. Nothing a later node reads depends on the state, so
// while node n computes, the warp's lanes copy node n+2's K, U, k, X, d and
// parameters into a per-warp ring of three node buffers in shared memory
// with cp.async (16-byte copies for K, U and k, which start 16-byte aligned
// for every node); the chain then waits on arithmetic, not on device
// memory. K(x̂−X) reads K from shared memory, where the row
// stride 37 is free of bank conflicts, with four partial sums a row to
// shorten the dependent chain. The rigid-body rates (csrc/srbd_common.cuh)
// run on every lane in registers — R I Rᵀ, its cofactors and Iw ω need x̂
// only and run beside K(x̂−X); the contact forces and torques are summed
// one contact a lane with xor shuffles — so no lane carries them alone and
// no shared-memory round trip or warp barrier sits in the chain for them.
// At each node the lanes evaluate the 73 (69) residual rows in two passes laid
// out so that the lanes of a pass take few distinct paths
// (`stage_sq_lane`), and keep their squares in a register; the terminal
// rows follow the loop, and one warp reduction gives the cost. The sum is
// taken in another order than the plain twin's, so the two agree to
// rounding, not bit for bit.
//
// The square-feet biped (`srbd::SquareFeetShape`, nx=61, nu=48, 129
// stage rows) has more inputs than a warp has lanes: a lane takes rows
// lane and lane + 32 of K(x̂ − X) and the input rows of columns lane and
// lane + 32 (`stage_sq_lane`'s three passes), and its ring of three
// nodes of K takes 38,800-39,040 B a warp in float32 (77,536-78,032 B in
// float64), so a trial block holds `trial_warps` (member, α) warps — four,
// or two in float64 — where the other shapes hold four: one block an SM
// (kernels/rollout.py::trial_layout reckons the same). The line-feet
// quadruped (`srbd::LineFeetQuadShape`) has the same nx and nu, so the
// same lane map and ring; its three passes take 32 equality rows, not 36.
//
// srbd_evaluate, when given x0, reads it in place of X[:, 0] (the solve's
// node-0 pin, msddp.py:1221; x0's rows may lie apart, as a node of a plan
// does) and writes the pinned plan to Xpin.
//
// What bounds srbd_evaluate: one member reads its plan and 20 parameter
// values a node, ~6.7 KB in f32, and does ~0.8k FLOP a node; at B=512 that
// is ~3.4 MB, 0.001 ms at 3.35 TB/s. Its nodes do not depend on one
// another, so the card's fill and each node's latency set its time. The
// first design (one block of ns+1 warps a member, each warp loading its
// node's slices of the seven parameter tensors on its own and forming the
// node's geometry and rates on every lane, the node sums added by one
// thread) took 19× that: at B=512 more members than one wave of
// 672-thread blocks holds. This one: one block of seven warps a member,
// compiled to hold four blocks an SM in float32 (B=512 is one wave on 132
// SMs). The block stages the member's x, u and parameter rows into one
// record a node in shared memory with cp.async, neighbouring threads on
// neighbouring elements of each contiguous per-member run (coalesced, one
// element a copy), x and u first. A prepass then forms every stage node's
// rigid-body rates (R I Rᵀ, its cofactors, the contact sums, six divisions, ȯ) on one
// warp, a node a lane, where the first design ran them whole on every lane
// of every node's warp, while the parameter rows arrive; warp w then
// evaluates nodes w, w+7, w+14, the rows
// in K3's passes (`stage_sq_lane`). One warp sums the stage nodes over its
// lanes, and the terminal node last, as the twin adds the stage sum and
// the terminal sum. Blocks of 11 or 21 warps were quicker for one member
// on the card but no quicker at B=512 and slower at B=4096.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "srbd_common.cuh"
#include "dmma.cuh"

namespace {

using srbd::kRates;
using srbd::kUnknownShape;
using srbd::node_rates;
using srbd::param_dim;
using srbd::param_off;
using srbd::stage_scratch;
constexpr int kWarps = 4;           // (member, α) warps a trial block, at most
constexpr int kStages = 3;           // node buffers a warp: the ring's depth
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared memory

// Rounds of a warp's lanes over the inputs: 2 past 32 inputs.
template <class S>
constexpr int kInputRounds = (S::nu + 31) / 32;
static_assert(kInputRounds<srbd::SquareFeetShape> == 2 &&
                  kInputRounds<srbd::LineFeetQuadShape> == 2, "nu ≤ 64");

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// One node's inputs in a warp's buffer. K, U and k start 16-byte aligned
// (nu·nx and nu are multiples of 4).
template <class S, typename T>
struct NodeBuf {
  static constexpr int vec = 16 / static_cast<int>(sizeof(T));
  static constexpr int K = 0, U = S::nu * S::nx, k = U + S::nu,
                       X = k + S::nu, d = X + S::nx, p = d + S::nx;
  static constexpr int size = round_up(p + srbd::Layout<S>::pw, vec);
  static_assert(U % vec == 0 && S::nu % vec == 0, "16-byte copies");
};

// A warp's shared memory: kStages node buffers, then x̂, x̂ − X, u and the
// stage point.
template <class S, typename T>
struct TrialWarp {
  using NB = NodeBuf<S, T>;
  static constexpr int xh = kStages * NB::size, dx = xh + S::nx,
                       u = dx + S::nx, xs = u + S::nu;
  static constexpr int size = round_up(xs + stage_scratch<S>(), NB::vec);
};

// Lane e's entry of the packed parameter rows of one member: entry e of
// node n lives at base + n·stride (the same for every node, so the copies
// of a node take no branch on e).
template <typename T>
struct ParamLane {
  const T* base;
  int stride;
};

template <class S, typename T>
__device__ ParamLane<T> param_lane(const srbd::Params<T>& P, size_t b, int ns,
                                   int lane) {
  const int e = lane < srbd::Layout<S>::pw ? lane : 0;
  const T* first = srbd::param_src<S>(P, b * (ns + 1), e);
  return {first, static_cast<int>(srbd::param_src<S>(P, b * (ns + 1) + 1, e) - first)};
}

// The lanes of one warp start the copies of node n (n < ns) into `buf`, or
// of the terminal parameters (n == ns), and close them into one group; past
// the terminal node (n > ns) the group is empty.
template <class S, typename T>
__device__ void issue_node(T* buf, const T* __restrict__ Ks,
                           const T* __restrict__ U, const T* __restrict__ ks,
                           const T* __restrict__ X, const T* __restrict__ d,
                           const ParamLane<T>& pl, size_t b, int n, int ns,
                           int lane) {
  using NB = NodeBuf<S, T>;
  constexpr int vec = NB::vec;
  const size_t row = b * (ns + 1) + n;
  if (lane < srbd::Layout<S>::pw && n <= ns)
    cp_async<sizeof(T)>(buf + NB::p + lane,
                        pl.base + static_cast<size_t>(n) * pl.stride);
  if (n < ns) {
    const size_t bn = b * ns + n;
    const T* Kb = Ks + bn * (S::nu * S::nx);
    for (int c = lane; c < S::nu * S::nx / vec; c += 32)
      cp_async<16>(buf + NB::K + c * vec, Kb + c * vec);
    constexpr int half = S::nu / vec;              // U, then k, side by side
    for (int c = lane; c < 2 * half; c += 32) {
      const T* src = c < half ? U + bn * S::nu + c * vec
                              : ks + bn * S::nu + (c - half) * vec;
      cp_async<16>(buf + NB::U + c * vec, src);
    }
    for (int j = lane; j < S::nx; j += 32) {
      cp_async<sizeof(T)>(buf + NB::X + j, X + row * S::nx + j);
      cp_async<sizeof(T)>(buf + NB::d + j, d + bn * S::nx + j);
    }
  }
  cp_async_commit();
}

// The (member, α) warps a trial block of instance S holds with tensors of
// T: kWarps, or as many as fit the card's shared memory a block (the
// square-feet biped's ring of three nodes of K, 48 × 61, takes up to
// 39,040 B a warp in float32, 78,032 B in float64: four warps, or two).
template <class S, typename T>
__host__ __device__ constexpr int trial_warps() {
  constexpr size_t warp_bytes = sizeof(T) * TrialWarp<S, T>::size;
  return 4 * warp_bytes <= kMaxSmem ? 4 : 2 * warp_bytes <= kMaxSmem ? 2 : 1;
}
static_assert(kWarps == 4 && trial_warps<srbd::Stepped<srbd::SquareFeetShape,
                                                       srbd::Rk4>,
                                         double>() == 2,
              "the trial's warps a block follow from its shared memory");

template <class S, typename T>
__global__ void __launch_bounds__(32 * kWarps)
srbd_trial_kernel(const T* __restrict__ x0, const T* __restrict__ X,
                  const T* __restrict__ U, const T* __restrict__ ks,
                  const T* __restrict__ Ks, const T* __restrict__ d,
                  const T* __restrict__ alphas, srbd::Params<T> P,
                  const T* __restrict__ merit0, const T* __restrict__ Dsq,
                  const T* __restrict__ dV1, const T* __restrict__ dV2,
                  int B, int ns, int nA, srbd::Consts<T> k, T nu_w, T beta,
                  T alpha_min, T* __restrict__ Xn, T* __restrict__ Un,
                  T* __restrict__ cost_out, T* __restrict__ merit_out,
                  bool* __restrict__ ok_out) {
  using NB = NodeBuf<S, T>;
  using W = TrialWarp<S, T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long g =
      static_cast<long long>(blockIdx.x) * trial_warps<S, T>() + warp;
  if (g >= static_cast<long long>(B) * nA) return;   // whole warp leaves
  const size_t b = g / nA;
  const size_t a = g % nA;

  T* sw = reinterpret_cast<T*>(smem_raw) + warp * W::size;
  T* xh = sw + W::xh;
  T* dx = sw + W::dx;
  T* u = sw + W::u;
  const ParamLane<T> pl = param_lane<S>(P, b, ns, lane);
  for (int n = 0; n < kStages - 1; ++n)
    issue_node<S>(sw + n * NB::size, Ks, U, ks, X, d, pl, b, n, ns, lane);
  const T alpha = alphas[a];
  const T om = T(1) - alpha;
  for (int j = lane; j < S::nx; j += 32) xh[j] = x0[b * S::nx + j];

  T acc = T(0);   // this lane's share of Σ‖ρ‖²
  for (int n = 0; n < ns; ++n) {
    const T* buf = sw + (n % kStages) * NB::size;
    // node n + kStages − 1 (the terminal parameters after the last stage
    // node) streams into the ring while node n computes
    const int ahead = n + kStages - 1;
    issue_node<S>(sw + (ahead % kStages) * NB::size, Ks, U, ks, X, d, pl, b,
                  ahead, ns, lane);
    cp_async_wait_group<kStages - 1>();            // node n has arrived
    __syncwarp();
    T* Xo = Xn + ((a * B + b) * (ns + 1) + n) * S::nx;
    for (int j = lane; j < S::nx; j += 32) {
      dx[j] = xh[j] - buf[NB::X + j];
      Xo[j] = xh[j];
    }
    __syncwarp();
    // the geometry needs x̂ only: it runs beside K(x̂ − X)
    const srbd::Geometry<T> geo = srbd::geometry<S>(xh, k);
    {   // uₙ: row i of K(x̂ − X) on lane i (the lanes past nu repeat the
        // last; past 32 inputs rows lane and lane + 32), four partial sums
        // to shorten the chain
      const auto row = [&](int i) {
        const T* Kr = buf + NB::K + i * S::nx;
        T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll
        for (int j = 0; j + 3 < S::nx; j += 4) {
          s0 += Kr[j] * dx[j];
          s1 += Kr[j + 1] * dx[j + 1];
          s2 += Kr[j + 2] * dx[j + 2];
          s3 += Kr[j + 3] * dx[j + 3];
        }
#pragma unroll
        for (int j = S::nx / 4 * 4; j < S::nx; ++j) s0 += Kr[j] * dx[j];
        return (buf[NB::U + i] + alpha * buf[NB::k + i]) + ((s0 + s1) + (s2 + s3));
      };
      T* Uo = Un + ((a * B + b) * ns + n) * S::nu;
#pragma unroll
      for (int c = 0; c < kInputRounds<S>; ++c) {
        const int i0 = lane + 32 * c;
        const int i = i0 < S::nu ? i0 : S::nu - 1;
        const T ui = row(i);
        if (i0 < S::nu) {
          u[i] = ui;
          Uo[i] = ui;
        }
      }
    }
    __syncwarp();
    const srbd::Rigid<T> rig = srbd::rigid_rates<S>(xh, u, k, geo, lane);
    acc += srbd::stage_sq_lane<S>(lane, xh, u, rig, buf + NB::p, k);
    T xn[2];                                       // nx ≤ 64: two rows a lane
    srbd::step_rows<S>(xh, u, rig, k, lane, sw + W::xs, xn);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < S::nx) xn[c] -= om * buf[NB::d + j];
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < S::nx) xh[j] = xn[c];
    }
    __syncwarp();
  }
  cp_async_wait_group<0>();
  __syncwarp();
  const T* pT = sw + (ns % kStages) * NB::size + NB::p;
  T* Xo = Xn + ((a * B + b) * (ns + 1) + ns) * S::nx;
  for (int j = lane; j < S::nx; j += 32) Xo[j] = xh[j];
  if (lane < S::nt) {
    const T v = srbd::tracking_row<S>(lane, xh, pT, T(1), k);
    acc += v * v;
  }
  const T cost = srbd::warp_sum(acc);
  if (lane == 0) {
    const T D = Dsq[b];
    const T merit = cost + (nu_w * (om * om)) * D;
    const T expected = -(alpha * dV1[b] + (alpha * alpha) * dV2[b]) +
                       ((T(2) * alpha - alpha * alpha) * nu_w) * D;
    const T exp_min = expected < T(1e-16) ? T(1e-16) : expected;  // NaN stays
    const size_t o = a * B + b;
    cost_out[o] = cost;
    merit_out[o] = merit;
    ok_out[o] = (merit0[b] - merit >= beta * exp_min) && isfinite(merit) &&
                (alpha >= alpha_min);
  }
}

// ---- srbd_evaluate ----

constexpr int kEvalWarps = 7;                 // ns = 20: nodes w, w+7, w+14
constexpr int kEvalThreads = 32 * kEvalWarps;
// Blocks an SM the registers are held to: four in float32 puts the SRBD
// serving fleet (B=512, 3.9 members an SM) in one wave.
template <typename T>
struct EvalMinBlocks {
  static constexpr int value = sizeof(T) == 4 ? 4 : 2;
};

// One node's record in shared memory: x, u and the packed parameter row.
template <class S>
struct EvalNode {
  static constexpr int x = 0, u = S::nx, p = u + S::nu,
                       size = p + srbd::Layout<S>::pw;
};
// The records, the stage nodes' rates, the node sums and maxima, then each
// warp's stage point (RK2, RK4).
template <class S, typename T>
size_t evaluate_smem_bytes(int ns) {
  return sizeof(T) * ((ns + 1) * (EvalNode<S>::size + 2) + ns * kRates +
                      kEvalWarps * stage_scratch<S>());
}

// The block stages parameter tensors t … of the member's ns1 nodes (`row0`
// is its first row, b·ns1).
template <class S, int t, typename T>
__device__ __forceinline__ void stage_params(T* s, const srbd::Params<T>& P,
                                             size_t row0, int ns1, int tid) {
  if constexpr (t < srbd::kParams) {
    constexpr int dim = param_dim<S>(t);
    cp_async_rows<T, dim, kEvalThreads>(s + EvalNode<S>::p + param_off<S>(t),
                                        EvalNode<S>::size, P.p[t] + row0 * dim,
                                        0, ns1, tid);
    stage_params<S, t + 1>(s, P, row0, ns1, tid);
  }
}

// The block starts the copies of member b's nodes into their records in
// two cp.async groups: x (node 0's from x0, rows x0_stride apart, when it
// is given) and u, then the parameter rows.
template <class S, typename T>
__device__ __forceinline__ void stage_member(T* s, const T* __restrict__ X,
                                             const T* __restrict__ x0,
                                             int x0_stride,
                                             const T* __restrict__ U,
                                             const srbd::Params<T>& P,
                                             size_t b, int ns, int tid) {
  using EN = EvalNode<S>;
  const size_t row0 = b * (ns + 1);
  int from = 0;
  if (x0 != nullptr) {
    cp_async_rows<T, S::nx, kEvalThreads>(s + EN::x, EN::size,
                                          x0 + b * x0_stride, 0, 1, tid);
    from = 1;
  }
  cp_async_rows<T, S::nx, kEvalThreads>(s + EN::x, EN::size, X + row0 * S::nx,
                                        from, ns + 1, tid);
  cp_async_rows<T, S::nu, kEvalThreads>(s + EN::u, EN::size,
                                        U + b * ns * S::nu, 0, ns, tid);
  cp_async_commit();
  stage_params<S, 0>(s, P, row0, ns + 1, tid);
  cp_async_commit();
}

// One warp evaluates node n from its record and its rates: this node's
// Σ‖ρ‖² and largest |step(x, u) − X[n+1]| (stage nodes; `xs` the warp's
// stage point under RK2 and RK4), or the terminal rows' Σ, onto lane 0.
// X[n+1] comes from device memory, issued first.
template <class S, typename T>
__device__ __forceinline__ void evaluate_node(const T* rec, const T* rates,
                                              const T* __restrict__ Xnext,
                                              int n, int ns,
                                              const srbd::Consts<T>& k,
                                              int lane, T* xs, T* cost,
                                              T* dmax) {
  using EN = EvalNode<S>;
  const T* x = rec + EN::x;
  const T* u = rec + EN::u;
  const T* p = rec + EN::p;
  T acc = T(0), dm = T(0);
  if (n < ns) {                                    // warp-uniform
    T xn[2];                                       // nx ≤ 64: two rows a lane
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      xn[c] = j < S::nx ? Xnext[j] : T(0);
    }
    T step[2];
    acc = srbd::eval_stage<S>(lane, x, u, p, rates, k, xs, step);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < S::nx) dm = srbd::nan_max(dm, srbd::abs_nan(step[c] - xn[c]));
    }
  } else {
    acc = srbd::eval_terminal<S>(lane, x, p, k);
  }
  acc = srbd::warp_sum(acc);
  dm = srbd::warp_nan_max(dm);
  if (lane == 0) {
    *cost = acc;
    *dmax = dm;
  }
}

template <class S, typename T>
__global__ void __launch_bounds__(kEvalThreads, EvalMinBlocks<T>::value)
srbd_evaluate_kernel(const T* __restrict__ X, const T* __restrict__ U,
                     const T* __restrict__ x0, int x0_stride,
                     srbd::Params<T> P, int ns, srbd::Consts<T> k,
                     T* __restrict__ cost_out, T* __restrict__ dmax_out,
                     T* __restrict__ Xpin) {
  using EN = EvalNode<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int ns1 = ns + 1;
  T* rates = s + ns1 * EN::size;
  T* node_cost = rates + ns * kRates;
  T* node_dmax = node_cost + ns1;
  T* xs = node_dmax + ns1;                         // the warps' stage points
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t b = blockIdx.x;
  stage_member<S>(s, X, x0, x0_stride, U, P, b, ns, tid);
  cp_async_wait_group<1>();                        // x and u are in
  __syncthreads();
  if (Xpin != nullptr) {                           // the pinned plan, as staged
    T* out = Xpin + b * ns1 * S::nx;
    for (int i = tid; i < ns1 * S::nx; i += kEvalThreads) {
      const int n = i / S::nx;
      out[i] = s[n * EN::size + EN::x + (i - n * S::nx)];
    }
  }
  // the prepass: warp 0 forms every stage node's rates, a node a lane
  // (while the parameter rows stream in)
  if (warp == 0)
    for (int n = lane; n < ns; n += 32)
      node_rates<S>(s + n * EN::size + EN::x, s + n * EN::size + EN::u, k,
                    rates + n * kRates);
  cp_async_wait_group<0>();                        // the parameter rows too
  __syncthreads();
  for (int n = warp; n < ns1; n += kEvalWarps)
    evaluate_node<S>(s + n * EN::size, rates + n * kRates,
                     X + (b * ns1 + n + 1) * S::nx, n, ns, k, lane,
                     xs + warp * stage_scratch<S>(), node_cost + n,
                     node_dmax + n);
  __syncthreads();
  if (warp == 0) {   // the stage nodes over the lanes, then the terminal node
    T c = lane < ns ? node_cost[lane] : T(0);
    T m = lane < ns ? node_dmax[lane] : T(0);
    c = srbd::warp_sum(c);
    m = srbd::warp_nan_max(m);
    if (lane == 0) {
      cost_out[b] = c + node_cost[ns];
      dmax_out[b] = m;
    }
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

template <class S, typename T>
constexpr size_t trial_smem_bytes() {
  return sizeof(T) * trial_warps<S, T>() * TrialWarp<S, T>::size;
}

template <class S, typename T>
int launch_trial(const void* x0, const void* X, const void* U, const void* ks,
                 const void* Ks, const void* d, const void* alphas,
                 const void* const* params, const void* merit0,
                 const void* D, const void* dV1, const void* dV2, int B,
                 int ns, int nA, const double* scalars, double nu_w,
                 double beta, double alpha_min, void* Xn, void* Un,
                 void* cost, void* merit, void* ok, void* stream) {
  const long long pairs = static_cast<long long>(B) * nA;
  if (pairs == 0) return 0;
  const size_t bytes = trial_smem_bytes<S, T>();
  auto kernel = srbd_trial_kernel<S, T>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int warps = trial_warps<S, T>();
  const unsigned blocks = static_cast<unsigned>((pairs + warps - 1) / warps);
  kernel<<<blocks, 32 * warps, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(X),
      static_cast<const T*>(U), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(d),
      static_cast<const T*>(alphas), srbd::make_params<T>(params),
      static_cast<const T*>(merit0), static_cast<const T*>(D),
      static_cast<const T*>(dV1), static_cast<const T*>(dV2), B, ns, nA,
      srbd::make_consts<T>(scalars), static_cast<T>(nu_w),
      static_cast<T>(beta), static_cast<T>(alpha_min), static_cast<T*>(Xn),
      static_cast<T*>(Un), static_cast<T*>(cost), static_cast<T*>(merit),
      static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

template <class S, typename T>
int launch_evaluate(const void* X, const void* U, const void* x0,
                    int x0_stride, const void* const* params, int B, int ns,
                    const double* scalars, void* cost, void* dmax, void* Xpin,
                    void* stream) {
  if (ns + 1 > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t bytes = evaluate_smem_bytes<S, T>(ns);
  auto kernel = srbd_evaluate_kernel<S, T>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, kEvalThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      static_cast<const T*>(x0), x0_stride, srbd::make_params<T>(params), ns,
      srbd::make_consts<T>(scalars), static_cast<T*>(cost),
      static_cast<T*>(dmax), static_cast<T*>(Xpin));
  return static_cast<int>(cudaGetLastError());
}

// A kernel's occupancy with `threads` threads and `bytes` of dynamic
// shared memory a block, into out[0..3]: blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), shared memory bytes a
// block, registers a thread and local (spilled) bytes a thread
// (cudaFuncGetAttributes).
template <class Kernel>
int occupancy(Kernel kernel, int threads, size_t bytes, int* out) {
  cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                      bytes);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = static_cast<int>(bytes);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

}  // namespace

// The contact topology (nc, cm, n_legs) and the step (srbd::Euler::id,
// Rk2::id, Rk4::id) pick the compiled instance; another one returns
// kUnknownShape and launches nothing.
#define TRIAL_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(                                                        \
      const void* x0, const void* X, const void* U, const void* ks,           \
      const void* Ks, const void* d, const void* alphas,                      \
      const void* const* params, const void* merit0, const void* D,           \
      const void* dV1, const void* dV2, int B, int ns, int nc, int cm,        \
      int n_legs, int step, int nA, const double* scalars, double nu_w,       \
      double beta, double alpha_min, void* Xn, void* Un, void* cost,          \
      void* merit, void* ok, void* stream) {                                  \
    return srbd::with_topology(nc, cm, n_legs, step, [&](auto s) {            \
      return launch_trial<decltype(s), T>(                                    \
          x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1, dV2, B, ns,    \
          nA, scalars, nu_w, beta, alpha_min, Xn, Un, cost, merit, ok,        \
          stream);                                                            \
    });                                                                       \
  }

TRIAL_ENTRY(srbd_trial_f32, float)
TRIAL_ENTRY(srbd_trial_f64, double)

// x0 and Xpin are null, or x0 (B, nx, rows x0_stride elements apart)
// takes node 0's place and Xpin (B, ns+1, nx) receives the pinned plan.
#define EVALUATE_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* X, const void* U, const void* x0,           \
                      int x0_stride, const void* const* params, int B,        \
                      int ns, int nc, int cm, int n_legs, int step,           \
                      const double* scalars, void* cost, void* dmax,          \
                      void* Xpin, void* stream) {                             \
    return srbd::with_topology(nc, cm, n_legs, step, [&](auto s) {            \
      return launch_evaluate<decltype(s), T>(X, U, x0, x0_stride, params, B,  \
                                             ns, scalars, cost, dmax, Xpin,   \
                                             stream);                         \
    });                                                                       \
  }

EVALUATE_ENTRY(srbd_evaluate_f32, float)
EVALUATE_ENTRY(srbd_evaluate_f64, double)

// srbd_evaluate's occupancy for the shape at index `shape`
// (kernels/linearize.py::KERNEL_SHAPES order), float32 (f64 = 0) or
// float64 tensors and ns stage nodes: out[0] blocks an SM, out[1] warps a
// block, out[2] shared memory bytes a block, out[3] registers a thread,
// out[4] local bytes a thread.
extern "C" int srbd_evaluate_occupancy(int shape, int f64, int ns, int* out) {
  out[1] = kEvalWarps;
  return srbd::with_shape(shape, [&](auto s) {
    using S = decltype(s);
    int o[4] = {0, 0, 0, 0};
    const int e =
        f64 ? occupancy(srbd_evaluate_kernel<S, double>, kEvalThreads,
                        evaluate_smem_bytes<S, double>(ns), o)
            : occupancy(srbd_evaluate_kernel<S, float>, kEvalThreads,
                        evaluate_smem_bytes<S, float>(ns), o);
    out[0] = o[0];
    out[2] = o[1];
    out[3] = o[2];
    out[4] = o[3];
    return e;
  });
}

// K3's occupancy for the shape at index `shape` and float32 (f64 = 0) or
// float64 tensors: out[0] blocks an SM, out[1] shared memory bytes a
// block, out[2] registers a thread, out[3] local bytes a thread.
extern "C" int srbd_trial_occupancy(int shape, int f64, int* out) {
  return srbd::with_shape(shape, [&](auto s) {
    using S = decltype(s);
    return f64 ? occupancy(srbd_trial_kernel<S, double>,
                           32 * trial_warps<S, double>(),
                           trial_smem_bytes<S, double>(), out)
               : occupancy(srbd_trial_kernel<S, float>,
                           32 * trial_warps<S, float>(),
                           trial_smem_bytes<S, float>(), out);
  });
}
