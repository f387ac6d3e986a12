// K6 — the line-search trial of the batched MS-DDP solver on the isrbd AL
// inner problem: the rollout, its cost and the Armijo test for every step
// size α of one call, in one launch; and isrbd_evaluate, the cost and the
// largest defect of a given plan, with no rollout.
//
// Replaces: `MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:1391-1410),
// a `lax.scan` over the horizon, and the trial's `total_cost`/`_stage_rho`
// (:150-165) with the Armijo test (:843-853) on the AL inner OCP
// (srbd_horizon_tpu/solvers/alddp.py:215-256), all of which XLA fused on
// the TPU (the JAX package wrote no Pallas kernel for them). Plain twin:
// `kernels/isrbd_rollout.py::isrbd_trial_plain`. Per member and α, for
// n = 0 … ns−1:
//     uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
//     x̂ₙ₊₁ = rk2(x̂ₙ, uₙ) − (1 − α) dₙ        rk2: x + dt·ẋ(x + dt/2·ẋ(x,u), u)
// then
//     cost  = Σₙ ‖ρ(x̂ₙ, uₙ, pₙ)‖² + ‖ρ_N(x̂_N, p_N)‖²     (240 + 101 rows)
//     merit = cost + ν (1 − α)² D
//     exp   = −(α ΔV₁ + α² ΔV₂) + (2α − α²) ν D
//     ok    = merit0 − merit ≥ β max(exp, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min
// where ẋ is the double integrator with input accelerations and ρ, ρ_N the
// inner stage and terminal stacks (csrc/isrbd_common.cuh holds both,
// shared with K5). A NaN `exp` stays NaN through the max (as torch.clamp
// and jnp.maximum keep it), so the comparison, and `ok`, is false. Built
// without --use_fast_math, so isfinite and NaN comparisons are exact.
//
// isrbd_evaluate replaces `jax.vmap(MSDDP.total_cost)` and
// `jax.vmap(MSDDP._true_defects)` (msddp.py:1222, :1240, :1484-1490) on the
// AL inner OCP, the solve's starting cost and its final defect norm: per
// member
//     cost       = Σₙ ‖ρ(Xₙ, Uₙ, pₙ)‖² + ‖ρ_N(X_N, p_N)‖²
//     defect_max = maxₙ,ᵢ |rk2(Xₙ, Uₙ) − Xₙ₊₁|ᵢ   (NaN if any is NaN)
// Plain twin: `kernels/isrbd_rollout.py::isrbd_evaluate_plain`.
//
// Both are compiled for the shapes of csrc/isrbd_common.cuh only
// (`KangarooAlShape`, `QuadAlShape`; `K6<S>` holds each one's layouts), so
// every loop over rows, columns and parameters has a constant trip count
// and every offset is a constant; the contact topology picks the
// instantiation at launch and the wrappers refuse other sizes.
//
// What bounds K6 on an H100: one (member, α) reads per node the gains
// (30×37), the plan, the defects and the 357 parameter values, 1,601
// values (6.4 KB in f32), and does ~2.3k FLOP of gain application and
// ~2k of rows. At B=256, ns=20 and one α that is ~35 MB (~0.010 ms at
// 3.35 TB/s), so bytes bound the work; but each member is a chain of 20
// dependent nodes, and at B=256 the card holds every chain at once with a
// warp scheduler to itself, so the chain's latency sets the time
// (`k6_size_probe` in chip_smoke.py prints K6 from B=1 to B=4096). The
// first design (run-time sizes, a synchronous 21-tensor parameter loop and
// the gains read from device memory at stride 37 at every node, the
// geometry on lane 0, the 240 rows walked through one branch chain) took
// ~15 µs a node; K3's design on one warp ~4 µs.
//
// Design, K3's (csrc/srbd_rollout.cu) with the rows taken off the chain:
// two warps per (member, α), a chain warp and a rows warp, one pair a
// block. Nothing a later node reads depends on the state, so while node n
// computes, the chain warp's lanes copy node n+2's K, U, k, X, d and
// parameters into shared memory with cp.async; the chain then waits on
// arithmetic, not on device memory. K, U and k go in two-element copies
// (8 bytes in f32, 16 in f64): in f32 they start only 8-byte aligned at
// odd member-nodes (1,110 and 30 are 2 mod 4), in f64 always 16-byte
// aligned; the ring's buffers are 16-byte aligned and keep K, U and k at
// even offsets. Each lane copies the same ~12 entries of the packed
// parameter row at every node, from a source pointer and a width fixed
// once before the loop, so the copies take no per-node branch. The chain
// forms K(x̂−X) from shared memory (row stride 37, free of bank conflicts),
// one row a lane with four partial sums, then uₙ; it hands node n — x̂ₙ, uₙ
// and pₙ in slot n mod 4 — to the rows warp through an mbarrier (FULL) and
// steps on to x̂ₙ₊₁ by RK2, the quaternion rates once a node in registers.
// The rows warp forms the node's geometry (R I Rᵀ, Iw ω) in registers and
// its 240 stage rows in nine passes in which the lanes take one path
// (csrc/isrbd_common.cuh::stage_rows), keeps the squares in a register
// and releases the slot (EMPTY). The chain waits on EMPTY only before it
// copies into a slot, two nodes after the rows warp was handed it, so the
// rows run beside the chain. The rows warp
// ends with the terminal rows, one warp reduction (the cost), the merit
// and the Armijo flag. The sum is taken in another order than the plain
// twin's, so the two agree to rounding, not bit for bit. A pair takes
// 22,000 B in f32 (eight blocks an SM: B=256 at four α is one wave) and
// 43,936 B in f64; `isrbd_trial_occupancy` reports it. The handshake is
// an mbarrier in shared memory and not a named barrier: ptxas reserves all
// 16 named barriers of a block for ids known only at run time, which
// left four blocks an SM.
//
// isrbd_evaluate, when given x0, reads it in place of X[:, 0] (the solve's
// node-0 pin, msddp.py:1221; x0's rows may lie apart, as a node of a plan
// does) and writes the pinned plan to Xpin.
//
// What bounds isrbd_evaluate: one member reads its plan and the 357
// parameter values of every node, ~35 KB in f32, and does ~2.6k FLOP a
// node; at B=256 that is ~9 MB, 0.0027 ms at 3.35 TB/s. Its nodes do not
// depend on one another, and at B=256 the card holds every member at once,
// so one member's latency sets most of the time. The first design (one
// block of ns+1 warps a member, each warp loading its node's slices of the
// 21 parameter tensors on its own with plain loads and forming the node's
// geometry on every lane, the node sums added by one thread) took 8× the
// bound. This one: one block of eleven warps a member, two blocks an SM
// (B=256 is one wave on 132 SMs). The block stages the member's x, u and
// parameter rows into one record a node in shared memory with cp.async,
// neighbouring threads on neighbouring elements of each contiguous
// per-member run (coalesced, one element a copy); a record is K6's node
// (xu and the packed parameter row), x and u first. A prepass forms every
// stage node's geometry and RK2 rates (R I Rᵀ, Iw ω, ȯ at the midpoint)
// on one warp, a node a lane, while the parameter rows arrive; warp w
// then runs nodes w and w+11, the rows in K6's passes (`stage_rows`,
// `terminal_rows`) and the step. One warp sums the stage
// nodes over its lanes, and the terminal node last, as the twin adds the
// stage sum and the terminal sum. Of the layouts timed on the card, seven
// warps (three nodes each) waited longer on one member's rows, and 21 (one
// a node) spilled registers at two blocks an SM; eleven was the quickest
// at B=256 and at B=4096.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "isrbd_common.cuh"
#include "dmma.cuh"

namespace {

using isrbd::kUnknownShape;
constexpr int kPairs = 1;            // (member, α) pairs a block
constexpr int kThreads = 64 * kPairs;   // a chain warp and a rows warp a pair
constexpr int kStages = 3;           // the chain's ring of K, U, k, X, d
constexpr int kSlots = 4;            // node slots the chain hands the rows warp

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The handshake of a pair over node slot n mod kSlots: FULL — the chain
// has written node n there (its parameters, x̂ and u), EMPTY — the rows
// warp is done with node n. Each is an mbarrier that lane 0 of the
// handing warp arrives on once a node; node n is the (n / kSlots)-th use
// of its slot, so its phase has parity (n / kSlots) & 1.
struct Handshake {
  unsigned long long* bar;                        // kSlots FULL, kSlots EMPTY
  __device__ void full_arrive(int n) const { mbarrier_arrive(bar + n % kSlots); }
  __device__ void full_wait(int n) const {
    mbarrier_wait(bar + n % kSlots, (n / kSlots) & 1);
  }
  __device__ void empty_arrive(int n) const {
    mbarrier_arrive(bar + kSlots + n % kSlots);
  }
  __device__ void empty_wait(int n) const {
    mbarrier_wait(bar + kSlots + n % kSlots, (n / kSlots) & 1);
  }
};

// ---- isrbd_evaluate ----

constexpr int kEvalWarps = 11;                // ns = 20: nodes w, w+11
constexpr int kEvalThreads = 32 * kEvalWarps;
// Blocks an SM the registers are held to: two put the constrained serving
// fleet (B=256, 1.9 members an SM) in one wave.
constexpr int kEvalMinBlocks = 2;

// K6 and isrbd_evaluate at the shape S: their shared-memory layouts and
// the device code of their warps (the kernels below run K6<S>'s pieces).
template <class S>
struct K6 {
  using L = isrbd::Layout<S>;
  template <typename T>
  using Consts = isrbd::Consts<S, T>;
  static constexpr int nx = S::nx, nu = S::nu;

  // One node's inputs of the chain warp in its ring; every buffer starts
  // 16-byte aligned and K, U, k at even offsets (two-element copies).
  struct ChainBuf {
    static constexpr int K = 0, U = nu * nx, k = U + nu, X = k + nu, d = X + nx;
    static constexpr int size = round_up(d + nx, 4);
    static_assert(U % 2 == 0 && k % 2 == 0 && nu % 2 == 0, "two-element copies");
  };

  // A pair's shared memory: the chain warp's ring (from offset 0), the node
  // slots it hands to the rows warp (the parameter rows, and x̂ₙ then uₙ: an
  // xu each), x̂ − X.
  struct PairMem {
    static constexpr int par_size = round_up(L::n_par, 4),
                         pub_size = round_up(L::n_xu, 4);
    static constexpr int par = kStages * ChainBuf::size,
                         pub = par + kSlots * par_size,
                         dx = pub + kSlots * pub_size;
    static constexpr int size = round_up(dx + nx, 4);
  };

  // the pairs' memory, then a pair's FULL and EMPTY mbarriers (kSlots each)
  template <typename T>
  static constexpr size_t trial_smem_bytes() {
    return sizeof(T) * kPairs * PairMem::size +
           sizeof(unsigned long long) * kPairs * 2 * kSlots;
  }

  // The entries of the packed parameter row one lane copies at every node:
  // entry lane + 32c of node n lives at src[c] + n·dim[c].
  static constexpr int kParamSlots = (L::n_par + 31) / 32;

  template <typename T>
  struct ParamLanes {
    const T* src[kParamSlots];
    int dim[kParamSlots];
  };

  template <typename T>
  __device__ static __forceinline__ ParamLanes<T> param_lanes(const isrbd::Params<T>& P,
                                                       size_t b, int ns, int lane) {
    ParamLanes<T> pl;
  #pragma unroll
    for (int c = 0; c < kParamSlots; ++c) {
      const int e = lane + 32 * c;
      pl.src[c] = P.p[0];
      pl.dim[c] = 0;
  #pragma unroll
      for (int t = 0; t < isrbd::kParams; ++t) {
        const int off = isrbd::param_off<S>(t), dim = isrbd::param_dim<S>(t);
        if (e >= off && e < off + dim) {
          pl.src[c] = P.p[t] + b * (ns + 1) * dim + (e - off);
          pl.dim[c] = dim;
        }
      }
    }
    return pl;
  }

  // The chain warp's lanes start the copies of node n's K, U, k, X and d
  // (n < ns) into `buf` and close them into one group (empty past ns − 1).
  template <typename T>
  __device__ static __forceinline__ void issue_chain(
      T* buf, const T* __restrict__ Ks, const T* __restrict__ U,
      const T* __restrict__ ks, const T* __restrict__ X, const T* __restrict__ d,
      size_t b, int n, int ns, int lane) {
    using CB = ChainBuf;
    constexpr int two = 2 * sizeof(T);
    if (n < ns) {
      const size_t bn = b * ns + n;
      const T* Kb = Ks + bn * (nu * nx);
      constexpr int pairs = nu * nx / 2;
  #pragma unroll
      for (int i = 0; i < (pairs + 31) / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < pairs) cp_async<two>(buf + CB::K + 2 * c, Kb + 2 * c);
      }
      if (lane < nu) {                               // U on lanes 0..14, k on 15..29
        const bool isU = lane < nu / 2;
        const int c = isU ? lane : lane - nu / 2;
        cp_async<two>(buf + (isU ? CB::U : CB::k) + 2 * c,
                      (isU ? U : ks) + bn * nu + 2 * c);
      }
      const size_t row = b * (ns + 1) + n;
  #pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = lane + 32 * i;
        if (j < nx) {
          cp_async<sizeof(T)>(buf + CB::X + j, X + row * nx + j);
          cp_async<sizeof(T)>(buf + CB::d + j, d + bn * nx + j);
        }
      }
    }
    cp_async_commit();
  }

  // The lanes start the copies of node n's parameter row (n ≤ ns; the
  // terminal node's at ns) into `buf`.
  template <typename T>
  __device__ static __forceinline__ void issue_params(T* buf, const ParamLanes<T>& pl,
                                               int n, int ns, int lane) {
    if (n <= ns) {
  #pragma unroll
      for (int c = 0; c < kParamSlots; ++c)
        if (lane + 32 * c < L::n_par)
          cp_async<sizeof(T)>(buf + lane + 32 * c,
                              pl.src[c] + static_cast<size_t>(n) * pl.dim[c]);
    }
  }

  // The chain warp: uₙ and x̂ₙ₊₁ node after node. Node n lives in slot
  // n mod kSlots: x̂ₙ (written at node n − 1), uₙ and pₙ (copied two nodes
  // ahead with K, U, k, X, d). FULL(n) hands the node to the rows warp once
  // uₙ is in; before pₙ₊₂ and x̂ₙ₊₂ take a slot, EMPTY says the rows warp is
  // done with the node that held it.
  template <typename T>
  __device__ static __forceinline__ void chain_warp(
      T* pm, Handshake hs, const isrbd::Params<T>& P,
      const T* __restrict__ x0, const T* __restrict__ X, const T* __restrict__ U,
      const T* __restrict__ ks, const T* __restrict__ Ks, const T* __restrict__ d,
      int B, int ns, size_t b, size_t a, T alpha, const Consts<T>& k,
      T* __restrict__ Xn, T* __restrict__ Un, int lane) {
    using CB = ChainBuf;
    T* dx = pm + PairMem::dx;
    T* par = pm + PairMem::par;
    auto slot = [pm](int n) { return pm + PairMem::pub + (n % kSlots) * PairMem::pub_size; };
    const ParamLanes<T> pl = param_lanes(P, b, ns, lane);
    for (int n = 0; n < kStages - 1; ++n) {
      issue_params(par + (n % kSlots) * PairMem::par_size, pl, n, ns, lane);
      issue_chain(pm + n * CB::size, Ks, U, ks, X, d, b, n, ns, lane);
    }
    const T om = T(1) - alpha;
    const T hdt = T(0.5) * k.dt;
    for (int j = lane; j < nx; j += 32) slot(0)[j] = x0[b * nx + j];
    __syncwarp();
    for (int n = 0; n < ns; ++n) {
      const T* buf = pm + (n % kStages) * CB::size;
      // node n + 2 streams in while node n computes; its slot's last node
      // must be done first
      const int ahead = n + kStages - 1;
      if (ahead <= ns && ahead >= kSlots) hs.empty_wait(ahead - kSlots);
      issue_params(par + (ahead % kSlots) * PairMem::par_size, pl, ahead, ns, lane);
      issue_chain(pm + (ahead % kStages) * CB::size, Ks, U, ks, X, d, b, ahead,
                  ns, lane);
      cp_async_wait_group<kStages - 1>();            // node n has arrived
      __syncwarp();
      T* xu = slot(n);
      T* Xo = Xn + ((a * B + b) * (ns + 1) + n) * nx;
      for (int j = lane; j < nx; j += 32) {
        dx[j] = xu[j] - buf[CB::X + j];
        Xo[j] = xu[j];
      }
      __syncwarp();
      {   // uₙ: row i of K(x̂ − X) on lane i (lanes past nu repeat the last),
          // four partial sums to shorten the chain
        const int i = lane < nu ? lane : nu - 1;
        const T* Kr = buf + CB::K + i * nx;
        T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  #pragma unroll
        for (int j = 0; j + 3 < nx; j += 4) {
          s0 += Kr[j] * dx[j];
          s1 += Kr[j + 1] * dx[j + 1];
          s2 += Kr[j + 2] * dx[j + 2];
          s3 += Kr[j + 3] * dx[j + 3];
        }
  #pragma unroll
        for (int j = nx / 4 * 4; j < nx; ++j) s0 += Kr[j] * dx[j];
        const T ui = (buf[CB::U + i] + alpha * buf[CB::k + i]) + ((s0 + s1) + (s2 + s3));
        if (lane < nu) {
          xu[nx + i] = ui;
          Un[((a * B + b) * ns + n) * nu + i] = ui;
        }
      }
      __syncwarp();
      if (lane == 0) hs.full_arrive(n);              // x̂ₙ, uₙ, pₙ to the rows warp
      const isrbd::Rates<T> rt = isrbd::rates<S>(xu, hdt);
      T* next = slot(n + 1);                         // freed before pₙ₊₁ came in
  #pragma unroll
      for (int c = 0; c < 2; ++c) {                  // nx ≤ 64: two rows a lane
        const int j = lane + 32 * c;
        if (j < nx) next[j] = isrbd::step_row<S>(j, xu, rt, hdt, k.dt) - om * buf[CB::d + j];
      }
      __syncwarp();
    }
    cp_async_wait_group<0>();
    __syncwarp();
    T* Xo = Xn + ((a * B + b) * (ns + 1) + ns) * nx;
    for (int j = lane; j < nx; j += 32) Xo[j] = slot(ns)[j];
    if (lane == 0) hs.full_arrive(ns);               // x̂_N, p_N
  }

  // The rows warp: Σ‖ρ‖² of every node the chain hands over, then the
  // terminal rows, the merit and the Armijo flag.
  template <typename T>
  __device__ static __forceinline__ void rows_warp(
      const T* pm, Handshake hs, const T* __restrict__ merit0,
      const T* __restrict__ Dsq, const T* __restrict__ dV1,
      const T* __restrict__ dV2, int B, int ns, size_t b, size_t a, T alpha,
      const Consts<T>& k, T nu_w, T beta, T alpha_min,
      T* __restrict__ cost_out, T* __restrict__ merit_out,
      bool* __restrict__ ok_out, int lane) {
    const T* par = pm + PairMem::par;
    auto slot = [pm](int n) { return pm + PairMem::pub + (n % kSlots) * PairMem::pub_size; };
    T acc = T(0);   // this lane's share of Σ‖ρ‖²
    auto square = [&acc](int, T v) { acc += v * v; };
    for (int n = 0; n < ns; ++n) {
      hs.full_wait(n);                               // x̂ₙ, uₙ, pₙ are in
      const T* xu = slot(n);
      const isrbd::Geometry<T> geo = isrbd::geometry(xu, k);
      isrbd::stage_rows<false>(lane, xu, par + (n % kSlots) * PairMem::par_size,
                               geo, k, square, [](int, T) {});
      // the chain waits on this before the slot's next node, n + kSlots
      __syncwarp();
      if (lane == 0) hs.empty_arrive(n);
    }
    hs.full_wait(ns);
    isrbd::terminal_rows(lane, slot(ns), par + (ns % kSlots) * PairMem::par_size,
                         k, square);
    const T cost = isrbd::warp_sum(acc);
    if (lane == 0) {
      const T om = T(1) - alpha;
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

  // One node's record in shared memory: x and u side by side (xu), then the
  // packed parameter row.
  struct EvalNode {
    static constexpr int xu = 0, p = L::n_xu, size = p + L::n_par;
  };

  static constexpr int kGeo = isrbd::kGeo;

  // The records, the stage nodes' geometry, then the node sums and maxima.
  template <typename T>
  static size_t evaluate_smem_bytes(int ns) {
    return sizeof(T) * ((ns + 1) * (EvalNode::size + 2) + ns * kGeo);
  }

  // The block stages parameter tensors t … of the member's ns1 nodes (`row0`
  // is its first row, b·ns1).
  template <int t, typename T>
  __device__ static __forceinline__ void stage_params(T* s, const isrbd::Params<T>& P,
                                               size_t row0, int ns1, int tid) {
    if constexpr (t < isrbd::kParams) {
      constexpr int dim = isrbd::param_dim<S>(t);
      cp_async_rows<T, dim, kEvalThreads>(
          s + EvalNode::p + isrbd::param_off<S>(t), EvalNode::size,
          P.p[t] + row0 * dim, 0, ns1, tid);
      stage_params<t + 1>(s, P, row0, ns1, tid);
    }
  }

  // The block starts the copies of member b's nodes into their records in
  // two cp.async groups: x (node 0's from x0, rows x0_stride apart, when it
  // is given) and u, then the parameter rows.
  template <typename T>
  __device__ static __forceinline__ void stage_member(T* s, const T* __restrict__ X,
                                               const T* __restrict__ x0,
                                               int x0_stride,
                                               const T* __restrict__ U,
                                               const isrbd::Params<T>& P,
                                               size_t b, int ns, int tid) {
    using EN = EvalNode;
    const size_t row0 = b * (ns + 1);
    int from = 0;
    if (x0 != nullptr) {
      cp_async_rows<T, nx, kEvalThreads>(s + EN::xu, EN::size,
                                         x0 + b * x0_stride, 0, 1, tid);
      from = 1;
    }
    cp_async_rows<T, nx, kEvalThreads>(s + EN::xu, EN::size, X + row0 * nx,
                                       from, ns + 1, tid);
    cp_async_rows<T, nu, kEvalThreads>(s + EN::xu + nx, EN::size,
                                       U + b * ns * nu, 0, ns, tid);
    cp_async_commit();
    stage_params<0>(s, P, row0, ns + 1, tid);
    cp_async_commit();
  }

  // One warp evaluates node n from its record and its geometry: this node's
  // Σ‖ρ‖² and largest |rk2(x, u) − X[n+1]| (stage nodes), or the terminal
  // rows' Σ, onto lane 0. X[n+1] comes from device memory, issued first.
  template <typename T>
  __device__ static __forceinline__ void evaluate_node(const T* rec, const T* gs,
                                                const T* __restrict__ Xnext,
                                                int n, int ns,
                                                const Consts<T>& k,
                                                int lane, T* cost, T* dmax) {
    const T* xu = rec + EvalNode::xu;
    const T* p = rec + EvalNode::p;
    T acc = T(0), dm = T(0);
    if (n < ns) {                                    // warp-uniform
      T xn[2];                                       // nx ≤ 64: two rows a lane
  #pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        xn[c] = j < nx ? Xnext[j] : T(0);
      }
      T step[2];
      acc = isrbd::eval_stage<S>(lane, xu, p, gs, k, step);
  #pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j < nx) dm = isrbd::nan_max(dm, isrbd::abs_nan(step[c] - xn[c]));
      }
    } else {
      acc = isrbd::eval_terminal<S>(lane, xu, p, k);
    }
    acc = isrbd::warp_sum(acc);
    dm = isrbd::warp_nan_max(dm);
    if (lane == 0) {
      *cost = acc;
      *dmax = dm;
    }
  }
};

template <class S, typename T>
__global__ void __launch_bounds__(kThreads)
isrbd_trial_kernel(const T* __restrict__ x0, const T* __restrict__ X,
                   const T* __restrict__ U, const T* __restrict__ ks,
                   const T* __restrict__ Ks, const T* __restrict__ d,
                   const T* __restrict__ alphas, isrbd::Params<T> P,
                   const T* __restrict__ merit0, const T* __restrict__ Dsq,
                   const T* __restrict__ dV1, const T* __restrict__ dV2,
                   int B, int ns, int nA,
                   const __grid_constant__ isrbd::Consts<S, T> k, T nu_w, T beta,
                   T alpha_min, T* __restrict__ Xn, T* __restrict__ Un,
                   T* __restrict__ cost_out, T* __restrict__ merit_out,
                   bool* __restrict__ ok_out) {
  using C = K6<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<T*>(smem_raw) + kPairs * C::PairMem::size);
  if (threadIdx.x < kPairs * 2 * kSlots) mbarrier_init(bars + threadIdx.x, 1);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = warp / 2;
  const long long g = static_cast<long long>(blockIdx.x) * kPairs + pair;
  if (g >= static_cast<long long>(B) * nA) return;   // the whole pair leaves
  const size_t b = g / nA;
  const size_t a = g % nA;
  T* pm = reinterpret_cast<T*>(smem_raw) + pair * C::PairMem::size;
  const Handshake hs{bars + pair * 2 * kSlots};
  const T alpha = alphas[a];
  if (warp % 2 == 0)
    C::chain_warp(pm, hs, P, x0, X, U, ks, Ks, d, B, ns, b, a, alpha, k, Xn, Un,
               lane);
  else
    C::rows_warp(pm, hs, merit0, Dsq, dV1, dV2, B, ns, b, a, alpha, k, nu_w, beta,
              alpha_min, cost_out, merit_out, ok_out, lane);
}

template <class S, typename T>
__global__ void __launch_bounds__(kEvalThreads, kEvalMinBlocks)
isrbd_evaluate_kernel(const T* __restrict__ X, const T* __restrict__ U,
                      const T* __restrict__ x0, int x0_stride,
                      isrbd::Params<T> P, int ns,
                      const __grid_constant__ isrbd::Consts<S, T> k,
                      T* __restrict__ cost_out, T* __restrict__ dmax_out,
                      T* __restrict__ Xpin) {
  using C = K6<S>;
  using EN = typename C::EvalNode;
  constexpr int kGeo = C::kGeo, nx = C::nx;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int ns1 = ns + 1;
  T* geo = s + ns1 * EN::size;
  T* node_cost = geo + ns * kGeo;
  T* node_dmax = node_cost + ns1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t b = blockIdx.x;
  C::stage_member(s, X, x0, x0_stride, U, P, b, ns, tid);
  cp_async_wait_group<1>();                        // x and u are in
  __syncthreads();
  if (Xpin != nullptr) {                           // the pinned plan, as staged
    T* out = Xpin + b * ns1 * nx;
    for (int i = tid; i < ns1 * nx; i += kEvalThreads) {
      const int n = i / nx;
      out[i] = s[n * EN::size + EN::xu + (i - n * nx)];
    }
  }
  // the prepass: warp 0 forms every stage node's geometry, a node a lane
  // (while the parameter rows stream in)
  if (warp == 0)
    for (int n = lane; n < ns; n += 32)
      isrbd::node_geometry<S>(s + n * EN::size + EN::xu, k, geo + n * kGeo);
  cp_async_wait_group<0>();                        // the parameter rows too
  __syncthreads();
  for (int n = warp; n < ns1; n += kEvalWarps)
    C::evaluate_node(s + n * EN::size, geo + n * kGeo,
                  X + (b * ns1 + n + 1) * nx, n, ns, k, lane, node_cost + n,
                  node_dmax + n);
  __syncthreads();
  if (warp == 0) {   // the stage nodes over the lanes, then the terminal node
    T c = lane < ns ? node_cost[lane] : T(0);
    T m = lane < ns ? node_dmax[lane] : T(0);
    c = isrbd::warp_sum(c);
    m = isrbd::warp_nan_max(m);
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
int launch_trial(const void* x0, const void* X, const void* U, const void* ks,
                 const void* Ks, const void* d, const void* alphas,
                 const void* const* params, const void* merit0,
                 const void* D, const void* dV1, const void* dV2, int B,
                 int ns, int nA, const double* scalars, double nu_w,
                 double beta, double alpha_min, void* Xn, void* Un, void* cost,
                 void* merit, void* ok, void* stream) {
  const long long pairs = static_cast<long long>(B) * nA;
  if (pairs == 0) return 0;
  const size_t bytes = K6<S>::template trial_smem_bytes<T>();
  auto kernel = isrbd_trial_kernel<S, T>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((pairs + kPairs - 1) / kPairs);
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(X),
      static_cast<const T*>(U), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(d),
      static_cast<const T*>(alphas), isrbd::make_params<T>(params),
      static_cast<const T*>(merit0), static_cast<const T*>(D),
      static_cast<const T*>(dV1), static_cast<const T*>(dV2), B, ns, nA,
      isrbd::make_consts<S, T>(scalars), static_cast<T>(nu_w),
      static_cast<T>(beta), static_cast<T>(alpha_min), static_cast<T*>(Xn),
      static_cast<T*>(Un), static_cast<T*>(cost), static_cast<T*>(merit),
      static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// K6's blocks resident on one SM, ring depth, warps and shared memory a
// block, into out[0..3].
template <class S, typename T>
int trial_occupancy(int* out) {
  const size_t bytes = K6<S>::template trial_smem_bytes<T>();
  cudaError_t e = allow_smem(isrbd_trial_kernel<S, T>, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, isrbd_trial_kernel<S, T>, kThreads, bytes);
  out[1] = kStages;
  out[2] = kThreads / 32;
  out[3] = static_cast<int>(bytes);
  return static_cast<int>(e);
}

template <class S, typename T>
int launch_evaluate(const void* X, const void* U, const void* x0,
                    int x0_stride, const void* const* params, int B, int ns,
                    const double* scalars, void* cost, void* dmax, void* Xpin,
                    void* stream) {
  if (ns + 1 > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t bytes = K6<S>::template evaluate_smem_bytes<T>(ns);
  auto kernel = isrbd_evaluate_kernel<S, T>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, kEvalThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      static_cast<const T*>(x0), x0_stride, isrbd::make_params<T>(params), ns,
      isrbd::make_consts<S, T>(scalars), static_cast<T*>(cost),
      static_cast<T*>(dmax), static_cast<T*>(Xpin));
  return static_cast<int>(cudaGetLastError());
}

// isrbd_evaluate's occupancy at ns stage nodes, into out[0..4]: blocks
// resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// warps a block, shared memory bytes a block, registers a thread and
// local (spilled) bytes a thread (cudaFuncGetAttributes).
template <class S, typename T>
int evaluate_occupancy(int ns, int* out) {
  const size_t bytes = K6<S>::template evaluate_smem_bytes<T>(ns);
  auto kernel = isrbd_evaluate_kernel<S, T>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                      kEvalThreads, bytes);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = kEvalWarps;
  out[2] = static_cast<int>(bytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

}  // namespace

#define TRIAL_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(                                                        \
      const void* x0, const void* X, const void* U, const void* ks,           \
      const void* Ks, const void* d, const void* alphas,                      \
      const void* const* params, const void* merit0, const void* D,           \
      const void* dV1, const void* dV2, int B, int ns, int nc, int cm,        \
      int n_legs, int nA, const double* scalars, double nu_w, double beta,    \
      double alpha_min, void* Xn, void* Un, void* cost, void* merit,          \
      void* ok, void* stream) {                                               \
    return isrbd::with_topology(nc, cm, n_legs, [&](auto s) {                 \
      return launch_trial<decltype(s), T>(                                    \
          x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1, dV2, B, ns,    \
          nA, scalars, nu_w, beta, alpha_min, Xn, Un, cost, merit, ok,        \
          stream);                                                            \
    });                                                                       \
  }

TRIAL_ENTRY(isrbd_trial_f32, float)
TRIAL_ENTRY(isrbd_trial_f64, double)

// K6's occupancy for the shape at index `shape` (kernels/isrbd_linearize.py::
// KERNEL_SHAPES order) and float32 (f64 = 0) or float64 tensors: out[0]
// blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] the
// ring's depth, out[2] warps a block, out[3] shared memory bytes a block.
extern "C" int isrbd_trial_occupancy(int shape, int f64, int* out) {
  return isrbd::with_shape(shape, [&](auto s) {
    using S = decltype(s);
    return f64 ? trial_occupancy<S, double>(out) : trial_occupancy<S, float>(out);
  });
}

// x0 and Xpin are null, or x0 (B, nx, rows x0_stride elements apart)
// takes node 0's place and Xpin (B, ns+1, nx) receives the pinned plan.
#define EVALUATE_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* X, const void* U, const void* x0,           \
                      int x0_stride, const void* const* params, int B,        \
                      int ns, int nc, int cm, int n_legs,                     \
                      const double* scalars, void* cost, void* dmax,          \
                      void* Xpin, void* stream) {                             \
    return isrbd::with_topology(nc, cm, n_legs, [&](auto s) {                 \
      return launch_evaluate<decltype(s), T>(X, U, x0, x0_stride, params, B,  \
                                             ns, scalars, cost, dmax, Xpin,   \
                                             stream);                         \
    });                                                                       \
  }

EVALUATE_ENTRY(isrbd_evaluate_f32, float)
EVALUATE_ENTRY(isrbd_evaluate_f64, double)

// isrbd_evaluate's occupancy for the shape at index `shape` and float32
// (f64 = 0) or float64 tensors at ns stage nodes: out[0] blocks an SM,
// out[1] warps a block, out[2] shared memory bytes a block, out[3]
// registers a thread, out[4] local bytes a thread.
extern "C" int isrbd_evaluate_occupancy(int shape, int f64, int ns, int* out) {
  return isrbd::with_shape(shape, [&](auto s) {
    using S = decltype(s);
    return f64 ? evaluate_occupancy<S, double>(ns, out)
               : evaluate_occupancy<S, float>(ns, out);
  });
}
