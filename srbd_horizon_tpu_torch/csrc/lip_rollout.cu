// K11 — the line-search trial of the batched MS-DDP solver on the LIP
// problem: the rollout, its cost and the Armijo test for every step size
// α of one call, in one launch; and lip_evaluate, the cost and the largest
// defect of a given plan, with no rollout.
//
// Replaces: `MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:1391-1410),
// a `lax.scan` over the horizon, and the trial's `total_cost` (:158) with
// the Armijo test of the line search (:1494-1578), all of which XLA fused
// on the TPU (the JAX package wrote no Pallas kernel for them), with the
// LIP problem's step (Euler, RK2 or RK4 of
// srbd_horizon_tpu/models/lip.py::lip_xdot) fused in.
// Plain twin: `kernels/lip_rollout.py::lip_trial_plain`. Per member and α,
// for n = 0 … ns−1:
//     uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
//     x̂ₙ₊₁ = step(x̂ₙ, uₙ) − (1 − α) dₙ
// then
//     cost  = Σₙ ‖ρ(x̂ₙ, uₙ, pₙ)‖² + ‖ρ_N(x̂_N, p_N)‖²
//     merit = cost + ν (1 − α)² D
//     exp   = −(α ΔV₁ + α² ΔV₂) + (2α − α²) ν D
//     ok    = merit0 − merit ≥ β max(exp, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min
// where ẋ is the LIP double integrator and ρ the stacked stage residual
// (csrc/lip_common.cuh holds both, shared with K10). A NaN `exp` stays NaN
// through the max (as torch.clamp and jnp.maximum keep it), so the
// comparison, and `ok`, is false. Built without --use_fast_math, so
// isfinite and NaN comparisons are exact.
//
// lip_evaluate replaces `jax.vmap(MSDDP.total_cost)` and
// `jax.vmap(MSDDP._true_defects)` (msddp.py:1221-1240, :1484), the solve's
// starting cost and its final defect norm: per member
//     cost       = Σₙ ‖ρ(Xₙ, Uₙ, pₙ)‖² + ‖ρ_N(X_N, p_N)‖²
//     defect_max = maxₙ,ᵢ |step(Xₙ, Uₙ) − Xₙ₊₁|ᵢ   (NaN if any is NaN)
// and, given x0, node 0 pinned to x0 and the pinned plan written (the
// solve's pin, msddp.py:1221; x0's rows may lie apart). Plain twin:
// `kernels/lip_rollout.py::lip_evaluate_plain`.
//
// Both are compiled for the fifteen (topology, step) instances of
// csrc/lip_common.cuh (`lip::with_topology` picks one), so every loop over
// rows and columns has a constant trip count; the wrappers refuse other
// sizes.
//
// The square-feet biped and the line-feet quadruped
// (`lip::SquareFeetShape`, `lip::LineFeetQuadShape`: nx=54, nu=27) have
// more state rows than a warp has lanes, so their chain takes a pair a lane
// (`kPairs`, `chain_node_pairs`): lane i < nx/2 holds pair i — x̂ᵢ, x̂ᵢ₊ₙₓ/₂
// (a position and its velocity) and uᵢ, the input that drives them (nu =
// nx/2) — and forms row i of K(x̂ − X) over all nx columns, each column's
// x̂ − X shuffled from its pair's lane; the step of a pair reads only that
// pair, so the partner shuffles of the other shapes drop out and the
// stages run in the lane's registers, as lip::step_pair forms them.
//
// What bounds K11 on an H100: a member's gains, plan, defects and 12
// parameter values a node, ~550 values a node (2.2 KB in float32), are
// read once for all its α's; each α does ~0.9k FLOP of rollout and ~0.3k
// of residual rows a node. At B=512, ns=20 that is ~23 MB (7 µs at 3.35
// TB/s), so bytes bound the work at fleet sizes; but each (member, α) is a
// chain of 20 dependent nodes, so at small B the chain's latency sets the
// time (chip_smoke.py's `lip_kernel_times` prints B = 1, 512, 4096; one α
// takes 0.0095 ms at B=1, 0.0113 at B=512, 0.079 at B=4096 on an H100 at
// 700 W, chip_smoke.py --k12-versus … --parts k11).
//
// Design: a block a member, with up to four of its α's (more α's take
// more blocks of the member): a chain warp an α and one copier warp.
// Nothing a later node reads depends on the state, so the copier stages
// the member's operands once for all its α's, by bulk copies (cp.async.bulk
// of each run's 16-byte-aligned body onto an mbarrier, the few elements
// around it by cp.async): X, d, U and k whole at the start, K in pieces of
// two nodes through a ring of four slots, each refilled once every chain
// has released it (full and empty mbarriers a slot), and the parameter
// tensors, which it packs into rows while the chains run. No block barrier
// stands in the chain, and it reads no operand from device memory: a
// per-node barrier held the chains to the copies' issue, ~40-50 cycles a
// cp.async warp instruction an SM. The chain carries x̂ and u alone: lane
// j holds x̂ⱼ in a register; K(x̂ − X) takes two lanes a row, 15 columns
// each, the columns' x̂ − X shuffled from their lanes, joined by one
// shuffle; uᵢ then lives on lane i; the Euler step of row j reads x̂ and u
// of lane j ± nx/2 by one shuffle each (its pair), and under RK2 and RK4
// each later stage reads the partner's stage point by one more shuffle (2
// rounds a node under RK2, 4 under RK4). x̂ₙ and uₙ go to Xn / Un and to a
// record an (α, node) in shared memory. After the chains every thread
// evaluates an (α, node), its residual rows in order (`lip::stage_sq`,
// `lip::terminal_sq`; a warp an (α, node), as lip_evaluate does, took
// ~6× as long for 21 nodes); one thread an α adds the stage nodes in node
// order and the terminal node last, as the twin adds the stage sum and
// the terminal sum, and takes the Armijo test, so a call is
// deterministic. `regions` states every region. The sums are taken in
// another order than the plain twin's, so the two agree to rounding, not
// bit for bit.
//
// What bounds lip_evaluate: one member reads its plan and parameters,
// ~1.2k values (4.7 KB in f32), and does ~0.3k FLOP a node; at B=512 that
// is ~2.4 MB, 0.7 µs at 3.35 TB/s: the card's fill and one node's latency
// set its time. Design: a warp a member and a thread a node, up to
// kEvalMembers members a block (`eval_members`: as many as still give
// every SM a block) and at least kEvalWarps warps (the rest stage only).
// Neighbouring members' runs are contiguous, so a block stages six runs
// (X, U, the four parameter tensors), each by one warp's bulk copy of its
// 16-byte-aligned body and cp.async of its edges (`stage_run`, K11's), and
// x0's rows by cp.async beside them; node 0 then takes x0's rows and the
// pinned plan goes out from shared memory by 16-byte stores. Lane n
// evaluates node n, its rows in order (`lip::stage_sq` / `terminal_sq`,
// K11's one-thread functions) and its largest |defect|; lane 0 adds the
// stage nodes in node order and the terminal node last, as K11 adds a
// trial's, each node's sum by a shuffle. `eval_regions` states the shared
// memory. The parent's warp a node (`lip::eval_stage`, still K13's) took
// ~4× as long to evaluate a member.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include <stdint.h>

#include "lip_common.cuh"
#include "dmma.cuh"

namespace {

constexpr int kMaxAlphas = 4;        // α's of one member a block, a chain warp each
constexpr int kPieceNodes = 2;       // nodes of K a bulk copy carries
constexpr int kRing = 4;             // ring slots of K's pieces
constexpr int kMinBlocks = 5;        // blocks an SM the registers are held to:
                                     // float32 with four α fits five by its bytes

// The chain's lane map at instance S: a state row a lane (nx ≤ 32), or
// a state pair a lane (both eight-contact robots' nx = 54).
template <class S>
constexpr bool kPairs = (S::nx > 32);

// The launch bound of instance S's trial: kMinBlocks, but four for the RK
// chains, whose stage values spilled at five (72 registers in float64),
// and two for a pair a lane, whose block (~91 KB in float32 at ns=20, four
// α) two fill an SM.
template <class S>
constexpr int kTrialMinBlocks = kPairs<S> ? 2
                                : S::Step::stages > 1 ? 4 : kMinBlocks;

// The sizes of instance S: a node's packed parameter row, nx, nu, and
// K's columns a lane (the step's partner lane is j ± kHalf; with kPairs,
// pair i's rows i and i + kHalf on lane i).
template <class S>
struct Sizes {
  using L = lip::Layout<S>;
  static constexpr int kPw = L::pw, nx = S::nx, nu = S::nu, kHalf = L::half;
  static_assert(L::i_cdot == L::i_rdot + 3 &&
                    (kPairs<S> ? kHalf <= 32 && nu == kHalf
                               : nx <= 32 && 2 * nu <= 32),
                "a state row a lane and two lanes a K row, row j's ẋ on lane "
                "j ± nx/2; or a state pair and its input a lane");
  static_assert(kPieceNodes * nu * nx * 4 % 16 == 0,
                "a piece of K keeps its member's offset within 16 bytes");
};

__host__ __device__ constexpr size_t round16(size_t v) {
  return (v + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

__host__ __device__ constexpr int alphas_a_block(int nA) {
  return nA < kMaxAlphas ? nA : kMaxAlphas;
}

// Pieces of K at ns stage nodes.
__host__ __device__ constexpr int pieces(int ns) {
  return (ns + kPieceNodes - 1) / kPieceNodes;
}

// The block's shared memory for one member at ns stage nodes with na α's,
// tensors of E bytes an element (kernels/lip_rollout.py::smem_bytes states
// the same), as byte offsets: the ring of K's pieces (kRing slots, each a
// piece and 16 bytes: a run lands at its source's offset within 16
// bytes), after the chain the node sums; the member's staged runs of X, d,
// U and k and of its four parameter tensors (each 16 bytes longer than the
// run); the packed parameter rows; the records (x̂ then u an (α, node));
// the barriers (full and empty a slot, one for the runs, one for the
// parameters); and the total.
struct Regions {
  size_t ring, slot, X, d, U, k, par, prm, rec, bar, total;
};

template <class S, int E>
__host__ __device__ constexpr Regions regions(int ns, int na) {
  constexpr int nx = S::nx, nu = S::nu, kPw = Sizes<S>::kPw;
  Regions r{};
  r.slot = round16(static_cast<size_t>(kPieceNodes) * nu * nx * E + 16);
  r.ring = 0;
  r.X = r.ring + cmax(kRing * r.slot, round16(static_cast<size_t>(na) * (ns + 1) * E));
  r.d = r.X + round16(static_cast<size_t>(ns + 1) * nx * E + 16);
  r.U = r.d + round16(static_cast<size_t>(ns) * nx * E + 16);
  r.k = r.U + round16(static_cast<size_t>(ns) * nu * E + 16);
  r.par = r.k + round16(static_cast<size_t>(ns) * nu * E + 16);
  r.prm = r.par;
  for (int q = 0; q < lip::kParams; ++q)
    r.prm += round16(static_cast<size_t>(ns + 1) * lip::param_dim<S>(q) * E + 16);
  r.rec = r.prm + round16(static_cast<size_t>(ns + 1) * kPw * E);
  r.bar = r.rec + round16(static_cast<size_t>(na) * (ns + 1) * (nx + nu) * E);
  r.total = r.bar + round16(static_cast<size_t>(8) * (2 * kRing + 2));
  return r;
}

// Where a run staged into the region at dst lands: at dst plus its
// source's offset within 16 bytes, so that its body's copy is aligned at
// both ends.
template <typename T, typename D>
__device__ __forceinline__ D* landed(D* dst, const T* src) {
  return dst + (reinterpret_cast<uintptr_t>(src) % 16) / sizeof(T);
}

// The bytes of the 16-byte-aligned body of a run of `count` elements at
// src.
template <typename T>
__device__ __forceinline__ unsigned body_bytes(const T* src, size_t count) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = (s + 15) / 16 * 16, hi = (s + count * sizeof(T)) / 16 * 16;
  return hi > lo ? static_cast<unsigned>(hi - lo) : 0u;
}

// One warp stages the run of `count` elements at src into the region at
// dst (`landed`): the 16-byte-aligned body by one bulk copy (lane 0) on
// `bar`, whose expected bytes the caller has set, the elements before and
// after it by cp.async, a lane each.
template <typename T>
__device__ __forceinline__ void stage_run(T* dst, const T* src, size_t count,
                                          unsigned long long* bar, int lane) {
  constexpr int E = sizeof(T);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const unsigned bytes = body_bytes(src, count);
  const int head = bytes ? static_cast<int>((16 - s % 16) % 16) / E
                         : static_cast<int>(count);
  const int tail = static_cast<int>(count - head - bytes / E);
  T* at = landed(dst, src);
  if (lane == 0 && bytes) tma_bulk(at + head, src + head, bytes, bar);
  if (lane < head) cp_async<E>(at + lane, src + lane);
  if (lane >= 16 && lane - 16 < tail) {
    const size_t i = count - tail + (lane - 16);
    cp_async<E>(at + i, src + i);
  }
}

// The nodes piece p carries.
__device__ __forceinline__ int piece_nodes(int p, int ns) {
  return ns - p * kPieceNodes < kPieceNodes ? ns - p * kPieceNodes : kPieceNodes;
}

// The copier warp fills a ring slot with piece p of the member's K (gK;
// Ks0 … Ks1 the whole tensor): one bulk copy (lane 0) of the 16-byte-aligned window
// around the piece onto the slot's `full` barrier, which lands it at its
// `landed` offset; a window past either end of the tensor (a member's K
// not on a 16-byte boundary, at the tensor's first or last piece) goes by
// cp.async, waited for, then one arrival on `full`.
template <class S, typename T>
__device__ __forceinline__ void issue_piece(T* slot, const T* gK, int p,
                                            int ns, const T* Ks0,
                                            const T* Ks1,
                                            unsigned long long* full,
                                            int lane) {
  constexpr int E = sizeof(T), nx = S::nx, nu = S::nu;
  const T* src = gK + p * kPieceNodes * (nu * nx);
  const int count = piece_nodes(p, ns) * (nu * nx);
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src) / 16 * 16;
  const uintptr_t hi = (reinterpret_cast<uintptr_t>(src + count) + 15) / 16 * 16;
  if (lo >= reinterpret_cast<uintptr_t>(Ks0) && hi <= reinterpret_cast<uintptr_t>(Ks1)) {
    if (lane == 0) {
      mbarrier_expect_tx(full, static_cast<unsigned>(hi - lo));
      tma_bulk(slot, reinterpret_cast<const T*>(lo), static_cast<unsigned>(hi - lo),
               full);
    }
    return;
  }
  T* at = landed(slot, src);
  for (int i = lane; i < count; i += 32) cp_async<E>(at + i, src + i);
  cp_async_wait_all();
  __syncwarp();
  if (lane == 0) mbarrier_arrive(full);
}

// One chain warp's node, its operands read from the staged runs at this
// lane's places (Kr: K's row i, columns 15h … 15h + 14, for lanes i and
// i + 16; Xj, dj: row j = lane; Ui, ki: row i): x̂ − X (lane j holds x̂ⱼ),
// uᵢ = (Uᵢ + α kᵢ) + Kᵢ(x̂ − X) (x̂ − X shuffled from the columns' lanes, the
// two halves joined by one shuffle), x̂ₙ₊₁ = step(x̂, u) − (1 − α) dₙ into
// xh (row j's ẋ at each stage point from lane j ± nx/2, as lip::step_row
// forms it), and x̂ₙ, uₙ to Xn / Un and the record last. Shuffles only: no
// barrier inside a node.
template <class S, typename T>
__device__ __forceinline__ void chain_node(const T* Kr, T Xj, T dj, T Ui,
                                           T ki, T& xh, T alpha, T om,
                                           const lip::Consts<T>& k,
                                           T* __restrict__ Xo,
                                           T* __restrict__ Uo, T* rec,
                                           int lane) {
  using L = lip::Layout<S>;
  using St = typename S::Step;
  constexpr int nx = S::nx, nu = S::nu, kHalf = Sizes<S>::kHalf;
  constexpr unsigned kAll = 0xffffffffu;
  const int kh = lane / 16;
  const T base = Ui + alpha * ki;
  T kr[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) kr[c] = Kr[c];
  const T dx = lane < nx ? xh - Xj : T(0);
  T s0 = T(0), s1 = T(0);
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    const T v = __shfl_sync(kAll, dx, kh * kHalf + c);
    if (c % 2 == 0) {
      s0 += kr[c] * v;
    } else {
      s1 += kr[c] * v;
    }
  }
  T sk = s0 + s1;
  sk += __shfl_xor_sync(kAll, sk, 16);
  const T u = base + sk;
  // ẋ's row j at a point whose row j ± nx/2 is xo (lip::xdot_row): ṙ, ċ =
  // the point's row j + nx/2; r̈ = η²(r − z) − g e_z and c̈ = u, from lane
  // j − nx/2
  const int partner = lane < kHalf ? lane + kHalf : lane - kHalf;
  const T uo = __shfl_sync(kAll, u, partner);
  const auto rate = [&](T xo) {
    if (lane < L::i_rdot) return xo;
    if (lane < L::i_cdot) {
      const T v = k.eta2 * (xo - uo);
      return lane - L::i_rdot == 2 ? v - T(9.81) : v;
    }
    return uo;
  };
  T xd = rate(__shfl_sync(kAll, xh, partner));
  T xn;
  if constexpr (St::stages == 1) {
    xn = (xh + k.dt * xd) - om * dj;
  } else {
    // the later stages: the stage point x̂ + c_s·dt·k_{s−1}, its partner
    // row by one shuffle, the k's summed as ocp/integrators.py sums them
    T acc = xd;
#pragma unroll
    for (int s = 1; s < St::stages; ++s) {
      const T cdt = lip::full_stage<St>(s) ? k.dt : T(0.5) * k.dt;
      xd = rate(__shfl_sync(kAll, xh + cdt * xd, partner));
      if constexpr (St::stages == 4) acc = s == 3 ? acc + xd : acc + T(2) * xd;
    }
    if constexpr (St::stages == 4)
      xn = (xh + (k.dt / T(6)) * acc) - om * dj;
    else
      xn = (xh + k.dt * xd) - om * dj;
  }
  if (lane < nx) {
    Xo[lane] = xh;
    rec[lane] = xh;
  }
  if (lane < nu) {
    Uo[lane] = u;
    rec[nx + lane] = u;
  }
  if (lane < nx) xh = xn;
}

// One chain warp's node with a state pair a lane (kPairs): lane i < nx/2
// holds x̂ᵢ (xp) and x̂ᵢ₊ₕ (xv), h = nx/2, and reads K's row i (Kr), Xᵢ,
// Xᵢ₊ₕ, dᵢ, dᵢ₊ₕ, Uᵢ and kᵢ; uᵢ = (Uᵢ + α kᵢ) + Kᵢ(x̂ − X), the columns'
// x̂ − X shuffled from their pairs' lanes (positions and velocities in two
// partial sums); x̂ₙ₊₁ = step(x̂, u) − (1 − α) dₙ of the pair in registers
// (its velocity's rate r̈ = η²(r − z) − g e_z or c̈ = u, its position's the
// velocity; under RK2 and RK4 the stage points as lip::step_pair forms
// them), and x̂ₙ, uₙ to Xn / Un and the record last. Lanes past nx/2 hold
// lane nx/2 − 1's operands and store nothing.
template <class S, typename T>
__device__ __forceinline__ void chain_node_pairs(
    const T* Kr, T Xp, T Xv, T dp, T dv, T Ui, T ki, T& xp, T& xv, T alpha,
    T om, const lip::Consts<T>& k, T* __restrict__ Xo, T* __restrict__ Uo,
    T* rec, int lane) {
  using St = typename S::Step;
  constexpr int nx = S::nx, h = Sizes<S>::kHalf;
  constexpr unsigned kAll = 0xffffffffu;
  const bool live = lane < h;
  const T dxp = live ? xp - Xp : T(0), dxv = live ? xv - Xv : T(0);
  T s0 = T(0), s1 = T(0);
#pragma unroll
  for (int c = 0; c < h; ++c) {
    s0 += Kr[c] * __shfl_sync(kAll, dxp, c);
    s1 += Kr[h + c] * __shfl_sync(kAll, dxv, c);
  }
  const T u = (Ui + alpha * ki) + (s0 + s1);
  const int i = live ? lane : h - 1;
  const auto accel = [&](T p) {                  // lip::pair_accel of pair i
    if (i < 3) {
      const T v = k.eta2 * (p - u);
      return i == 2 ? v - T(9.81) : v;
    }
    return u;
  };
  T kp = xv, kv = accel(xp);
  T np, nv;
  if constexpr (St::stages == 1) {
    np = (xp + k.dt * kp) - om * dp;
    nv = (xv + k.dt * kv) - om * dv;
  } else {
    T sp = kp, sv = kv;                          // RK4's sum of the k's
#pragma unroll
    for (int s = 1; s < St::stages; ++s) {
      const T cdt = lip::full_stage<St>(s) ? k.dt : T(0.5) * k.dt;
      const T ps = xp + cdt * kp, vs = xv + cdt * kv;
      kp = vs;
      kv = accel(ps);
      if constexpr (St::stages == 4) {
        sp = s == 3 ? sp + kp : sp + T(2) * kp;
        sv = s == 3 ? sv + kv : sv + T(2) * kv;
      }
    }
    if constexpr (St::stages == 4) {
      np = (xp + (k.dt / T(6)) * sp) - om * dp;
      nv = (xv + (k.dt / T(6)) * sv) - om * dv;
    } else {
      np = (xp + k.dt * kp) - om * dp;
      nv = (xv + k.dt * kv) - om * dv;
    }
  }
  if (live) {
    Xo[lane] = xp;
    Xo[lane + h] = xv;
    rec[lane] = xp;
    rec[lane + h] = xv;
    Uo[lane] = u;
    rec[nx + lane] = u;
    xp = np;
    xv = nv;
  }
}

// The packed parameter row entry e of node `row` from the member's staged
// parameter tensors (mt, rdot_ref, c_ref, cdot_switch).
template <class S, typename T>
__device__ __forceinline__ T param_entry(const T* mt, const T* rd, const T* cr,
                                         const T* cs, int row, int e) {
  constexpr int nc = S::nc;
  if (e < lip::kP_rdot) return mt[row];
  if (e < lip::kP_cref) return rd[row * 3 + (e - lip::kP_rdot)];
  if (e < lip::kP_cref + nc) return cr[row * nc + (e - lip::kP_cref)];
  return cs[row * nc + (e - lip::kP_cref - nc)];
}

template <class S, typename T, bool kEvaluate>
__global__ void __launch_bounds__(32 * (kMaxAlphas + 1), kTrialMinBlocks<S>)
lip_trial_kernel(const T* __restrict__ x0, const T* __restrict__ X,
                 const T* __restrict__ U, const T* __restrict__ ks,
                 const T* __restrict__ Ks, const T* __restrict__ d,
                 const T* __restrict__ alphas, lip::Params<T> P,
                 const T* __restrict__ merit0, const T* __restrict__ Dsq,
                 const T* __restrict__ dV1, const T* __restrict__ dV2, int B,
                 int ns, int nA, lip::Consts<T> k, T nu_w, T beta,
                 T alpha_min, T* __restrict__ Xn, T* __restrict__ Un,
                 T* __restrict__ cost_out, T* __restrict__ merit_out,
                 bool* __restrict__ ok_out) {
  constexpr int nx = S::nx, nu = S::nu, kPw = Sizes<S>::kPw,
                kHalf = Sizes<S>::kHalf;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int groups = (nA + kMaxAlphas - 1) / kMaxAlphas;
  const size_t b = blockIdx.x / groups;
  const int a0 = (blockIdx.x % groups) * kMaxAlphas;
  const int na = nA - a0 < kMaxAlphas ? nA - a0 : kMaxAlphas;
  const int ns1 = ns + 1, np = pieces(ns), nc = S::nc;
  const Regions r = regions<S, sizeof(T)>(ns, alphas_a_block(nA));
  auto* full = reinterpret_cast<unsigned long long*>(smem_raw + r.bar);
  unsigned long long* empty = full + kRing;
  unsigned long long* runs = full + 2 * kRing;     // X, d, U, k
  unsigned long long* pars = runs + 1;             // the parameter tensors
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nthreads = blockDim.x;
  const int producer = nthreads / 32 - 1;          // the last warp copies
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbarrier_init(full + s, 1);
      mbarrier_init(empty + s, na);
    }
    mbarrier_init(runs, 2);     // the bodies' bytes, and the edges' arrival
    mbarrier_init(pars, 2);
    fence_mbarrier_init();
  }
  __syncthreads();
  // the member's runs in device memory, and where they land
  const T* gK = Ks + b * ns * (nu * nx);
  const T* gX = X + b * ns1 * nx;
  const T* gd = d + b * ns * nx;
  const T* gU = U + b * ns * nu;
  const T* gk = ks + b * ns * nu;
  const T* gmt = P.p[0] + b * ns1;
  const T* grd = P.p[1] + b * ns1 * 3;
  const T* gcr = P.p[2] + b * ns1 * nc;
  const T* gcs = P.p[3] + b * ns1 * nc;
  T* ring = reinterpret_cast<T*>(smem_raw + r.ring);
  T* sX = reinterpret_cast<T*>(smem_raw + r.X);
  T* sd = reinterpret_cast<T*>(smem_raw + r.d);
  T* sU = reinterpret_cast<T*>(smem_raw + r.U);
  T* sk = reinterpret_cast<T*>(smem_raw + r.k);
  T* smt = reinterpret_cast<T*>(smem_raw + r.par);
  T* srd = smt + round16(ns1 * sizeof(T) + 16) / sizeof(T);
  T* scr = srd + round16(static_cast<size_t>(ns1) * 3 * sizeof(T) + 16) / sizeof(T);
  T* scs = scr + round16(static_cast<size_t>(ns1) * nc * sizeof(T) + 16) / sizeof(T);
  const size_t slot = r.slot / sizeof(T);
  T* prm = reinterpret_cast<T*>(smem_raw + r.prm);
  T* recs = reinterpret_cast<T*>(smem_raw + r.rec);
  if (warp == producer) {
    // the member's runs by bulk copies and their edges by cp.async (an
    // arrival once the edges are in), the first kRing pieces of K; then
    // each slot refilled once its piece is read
    const T* Ks1 = Ks + static_cast<size_t>(B) * ns * (nu * nx);
    if (lane == 0) {
      mbarrier_expect_tx(runs, body_bytes(gX, ns1 * nx) + body_bytes(gd, ns * nx) +
                                   body_bytes(gU, ns * nu) + body_bytes(gk, ns * nu));
      mbarrier_expect_tx(pars, body_bytes(gmt, ns1) + body_bytes(grd, ns1 * 3) +
                                   body_bytes(gcr, ns1 * nc) + body_bytes(gcs, ns1 * nc));
    }
    __syncwarp();
    stage_run(sX, gX, ns1 * nx, runs, lane);
    stage_run(sd, gd, ns * nx, runs, lane);
    stage_run(sU, gU, ns * nu, runs, lane);
    stage_run(sk, gk, ns * nu, runs, lane);
    cp_async_commit();
    for (int p = 0; p < np && p < kRing; ++p)
      issue_piece<S>(ring + p * slot, gK, p, ns, Ks, Ks1, full + p, lane);
    stage_run(smt, gmt, ns1, pars, lane);
    stage_run(srd, grd, ns1 * 3, pars, lane);
    stage_run(scr, gcr, ns1 * nc, pars, lane);
    stage_run(scs, gcs, ns1 * nc, pars, lane);
    cp_async_commit();
    cp_async_wait_group<1>();                      // the runs' edges
    __syncwarp();
    if (lane == 0) mbarrier_arrive(runs);
    for (int p = kRing; p < np; ++p) {
      const int s = p % kRing;
      if (lane == 0) mbarrier_wait(empty + s, (p / kRing - 1) & 1);
      __syncwarp();
      issue_piece<S>(ring + s * slot, gK, p, ns, Ks, Ks1, full + s, lane);
    }
    // the packed parameter rows, while the chains run
    cp_async_wait_group<0>();
    __syncwarp();
    if (lane == 0) mbarrier_arrive(pars);
    mbarrier_wait(pars, 0);
    const T* lmt = landed(smt, gmt);
    const T* lrd = landed(srd, grd);
    const T* lcr = landed(scr, gcr);
    const T* lcs = landed(scs, gcs);
    for (int i = lane; i < ns1 * kPw; i += 32) {
      const int row = i / kPw;
      prm[i] = param_entry<S>(lmt, lrd, lcr, lcs, row, i - row * kPw);
    }
  } else if (warp < na && kPairs<S>) {  // α a0 + warp's chain, a pair a lane
    const size_t ma = static_cast<size_t>(a0 + warp) * B + b;
    const int i = lane < kHalf ? lane : kHalf - 1;
    const T* Kl = landed(ring, gK) + i * nx;
    const T* Xl = landed(sX, gX) + i;
    const T* dl = landed(sd, gd) + i;
    const T* Ul = landed(sU, gU) + i;
    const T* kl = landed(sk, gk) + i;
    T* Xo = Xn + ma * ns1 * nx;
    T* Uo = Un + ma * ns * nu;
    T* rec = recs + static_cast<size_t>(warp) * ns1 * (nx + nu);
    const T alpha = alphas[a0 + warp];
    const T om = T(1) - alpha;
    T xp = x0[b * nx + i], xv = x0[b * nx + i + kHalf];
    mbarrier_wait(runs, 0);                        // X, d, U, k are in
    int s = 0, m = 0, use = 0;                     // slot, node in piece, slot's use
    for (int n = 0; n < ns; ++n) {
      if (m == 0) mbarrier_wait(full + s, use & 1);
      chain_node_pairs<S>(Kl + s * slot + m * (nu * nx), Xl[n * nx],
                          Xl[n * nx + kHalf], dl[n * nx], dl[n * nx + kHalf],
                          Ul[n * nu], kl[n * nu], xp, xv, alpha, om, k, Xo,
                          Uo, rec, lane);
      Xo += nx;
      Uo += nu;
      rec += nx + nu;
      if (++m == kPieceNodes || n == ns - 1) {
        // piece read: every lane's reads of the slot fed the node's
        // shuffles, which lane 0 has passed
        if (lane == 0) mbarrier_arrive(empty + s);
        m = 0;
        if (++s == kRing) {
          s = 0;
          ++use;
        }
      }
    }
    if (lane < kHalf) {                            // x̂_N
      Xo[lane] = xp;
      Xo[lane + kHalf] = xv;
      rec[lane] = xp;
      rec[lane + kHalf] = xv;
    }
  } else if (warp < na) {  // α a0 + warp's chain
    const size_t ma = static_cast<size_t>(a0 + warp) * B + b;
    // this lane's places in the staged runs, stepped node by node
    const int ki = lane % 16 < nu ? lane % 16 : nu - 1, j = lane < nx ? lane : 0;
    const T* Kl = landed(ring, gK) + ki * nx + (lane / 16) * kHalf;
    const T* Xl = landed(sX, gX) + j;
    const T* dl = landed(sd, gd) + j;
    const T* Ul = landed(sU, gU) + ki;
    const T* kl = landed(sk, gk) + ki;
    T* Xo = Xn + ma * ns1 * nx;
    T* Uo = Un + ma * ns * nu;
    T* rec = recs + static_cast<size_t>(warp) * ns1 * (nx + nu);
    const T alpha = alphas[a0 + warp];
    const T om = T(1) - alpha;
    T xh = lane < nx ? x0[b * nx + lane] : T(0);
    mbarrier_wait(runs, 0);                        // X, d, U, k are in
    int s = 0, m = 0, use = 0;                     // slot, node in piece, slot's use
    for (int n = 0; n < ns; ++n) {
      if (m == 0) mbarrier_wait(full + s, use & 1);
      chain_node<S>(Kl + s * slot + m * (nu * nx), Xl[n * nx], dl[n * nx],
                    Ul[n * nu], kl[n * nu], xh, alpha, om, k, Xo, Uo, rec,
                    lane);
      Xo += nx;
      Uo += nu;
      rec += nx + nu;
      if (++m == kPieceNodes || n == ns - 1) {
        // piece read: every lane's reads of the slot fed the node's last
        // shuffles, which lane 0 has passed
        if (lane == 0) mbarrier_arrive(empty + s);
        m = 0;
        if (++s == kRing) {
          s = 0;
          ++use;
        }
      }
    }
    if (lane < nx) {                               // x̂_N
      Xo[lane] = xh;
      rec[lane] = xh;
    }
  }
  if constexpr (kEvaluate) {
    __syncthreads();                               // the records are in
    T* node_cost = ring;                           // the ring is free
    // an (α, node) a thread, the rows in order (the producer packed the
    // parameter rows)
    for (int it = tid; it < na * ns1; it += nthreads) {
      const int n = it % ns1;
      const T* rc = recs + static_cast<size_t>(it) * (nx + nu);
      const T* p = prm + n * kPw;
      node_cost[it] = n < ns ? lip::stage_sq<S>(rc, rc + nx, p, k)
                             : lip::terminal_sq<S>(rc, p, k);
    }
    __syncthreads();
    if (tid < na) {        // the stage nodes in node order, the terminal last
      const T* c = node_cost + tid * ns1;
      T sum = T(0);
      for (int n = 0; n < ns; ++n) sum += c[n];
      const T cost = sum + c[ns];
      const T al = alphas[a0 + tid];
      const T oa = T(1) - al;
      const T D = Dsq[b];
      const T merit = cost + (nu_w * (oa * oa)) * D;
      const T expected = -(al * dV1[b] + (al * al) * dV2[b]) +
                         ((T(2) * al - al * al) * nu_w) * D;
      const T exp_min = expected < T(1e-16) ? T(1e-16) : expected;  // NaN stays
      const size_t o = static_cast<size_t>(a0 + tid) * B + b;
      cost_out[o] = cost;
      merit_out[o] = merit;
      ok_out[o] = (merit0[b] - merit >= beta * exp_min) && isfinite(merit) &&
                  (al >= alpha_min);
    }
  }
}

// ---- lip_evaluate ----

constexpr int kEvalMembers = 8;    // members a block at most, a warp each
constexpr int kEvalWarps = 4;      // warps a block at least (the rest stage)

// The members a block at B members on `sms` SMs: the most, halving from
// kEvalMembers, that still gives every SM a block (at least one).
__host__ __device__ constexpr int eval_members(int B, int sms) {
  int m = kEvalMembers;
  while (m > 1 && (B + m - 1) / m < sms) m /= 2;
  return m;
}

// The block's shared memory at ns stage nodes and `mb` members, tensors
// of E bytes an element (kernels/lip_rollout.py::evaluate_smem_bytes
// states the same), as byte offsets: the members' staged runs of X, U and
// the four parameter tensors (each 16 bytes longer than the run: a run
// lands at its source's offset within 16 bytes), x0's rows, the packed
// parameter rows (a node's, packed by its thread), the barrier; and the
// total.
struct EvalRegions {
  size_t X, U, mt, rd, cr, cs, x0, prm, bar, total;
};

template <class S, int E>
__host__ __device__ constexpr EvalRegions eval_regions(int ns, int mb) {
  constexpr int nx = S::nx, nu = S::nu, kPw = Sizes<S>::kPw;
  EvalRegions r{};
  const size_t m = static_cast<size_t>(mb), ns1 = static_cast<size_t>(ns) + 1;
  r.X = 0;
  r.U = r.X + round16(m * ns1 * nx * E + 16);
  r.mt = r.U + round16(m * ns * nu * E + 16);
  r.rd = r.mt + round16(m * ns1 * lip::param_dim<S>(0) * E + 16);
  r.cr = r.rd + round16(m * ns1 * lip::param_dim<S>(1) * E + 16);
  r.cs = r.cr + round16(m * ns1 * lip::param_dim<S>(2) * E + 16);
  r.x0 = r.cs + round16(m * ns1 * lip::param_dim<S>(3) * E + 16);
  r.prm = r.x0 + round16(m * nx * E);
  r.bar = r.prm + round16(m * ns1 * kPw * E);
  r.total = r.bar + 16;
  return r;
}

// A block of `mb` members (a warp each; blockDim.x = 32·max(mb,
// kEvalWarps), the warps past the members staging only; the last block may
// hold fewer members): the members' runs of X, U and the parameter
// tensors are contiguous, six runs a block, dealt to the warps, each
// staged by one warp (`stage_run`: its 16-byte-aligned body by one bulk
// copy, its edges by cp.async), x0's rows by cp.async beside them; node
// 0's rows then take x0's, and the pinned plan goes out from shared memory
// by 16-byte stores. Lane n of a member's warp evaluates node n
// (`lip::stage_sq` / `lip::terminal_sq`, the rows in order; the node's
// largest |defect| by `nan_max`), and lane 0 adds the stage nodes in node
// order and the terminal node last, each node's sums by a shuffle.
template <class S, typename T>
__global__ void __launch_bounds__(32 * kEvalMembers)
lip_evaluate_kernel(const T* __restrict__ X, const T* __restrict__ U,
                    const T* __restrict__ x0, int x0_stride,
                    lip::Params<T> P, int B, int ns, int mb,
                    lip::Consts<T> k, T* __restrict__ cost_out,
                    T* __restrict__ dmax_out, T* __restrict__ Xpin) {
  constexpr int E = sizeof(T), nc = S::nc, nx = S::nx, nu = S::nu,
                kPw = Sizes<S>::kPw;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ns1 = ns + 1, nw = blockDim.x / 32;
  const int b0 = blockIdx.x * mb;
  const int nm = B - b0 < mb ? B - b0 : mb;
  const EvalRegions r = eval_regions<S, E>(ns, mb);
  auto* bar = reinterpret_cast<unsigned long long*>(smem_raw + r.bar);
  // the block's runs in device memory
  const size_t row0 = static_cast<size_t>(b0) * ns1;
  const T* gX = X + row0 * nx;
  const T* gU = U + static_cast<size_t>(b0) * ns * nu;
  const T* gmt = P.p[0] + row0;
  const T* grd = P.p[1] + row0 * 3;
  const T* gcr = P.p[2] + row0 * nc;
  const T* gcs = P.p[3] + row0 * nc;
  const size_t nX = static_cast<size_t>(nm) * ns1 * nx,
               nU = static_cast<size_t>(nm) * ns * nu,
               n1 = static_cast<size_t>(nm) * ns1;
  T* sX = reinterpret_cast<T*>(smem_raw + r.X);
  T* sU = reinterpret_cast<T*>(smem_raw + r.U);
  T* smt = reinterpret_cast<T*>(smem_raw + r.mt);
  T* srd = reinterpret_cast<T*>(smem_raw + r.rd);
  T* scr = reinterpret_cast<T*>(smem_raw + r.cr);
  T* scs = reinterpret_cast<T*>(smem_raw + r.cs);
  T* sx0 = reinterpret_cast<T*>(smem_raw + r.x0);
  const int tid = threadIdx.x, m = tid / 32, n = tid % 32;
  if (tid == 0) {
    mbarrier_init(bar, 1);
    fence_mbarrier_init();
    mbarrier_expect_tx(bar, body_bytes(gX, nX) + body_bytes(gU, nU) +
                                body_bytes(gmt, n1) + body_bytes(grd, n1 * 3) +
                                body_bytes(gcr, n1 * nc) +
                                body_bytes(gcs, n1 * nc));
  }
  __syncthreads();
  // run i on warp i % nw
  if (m == 0) stage_run(sX, gX, nX, bar, n);
  if (m == 1 % nw) stage_run(sU, gU, nU, bar, n);
  if (m == 2 % nw) stage_run(smt, gmt, n1, bar, n);
  if (m == 3 % nw) stage_run(srd, grd, n1 * 3, bar, n);
  if (m == 4 % nw) stage_run(scr, gcr, n1 * nc, bar, n);
  if (m == 5 % nw) stage_run(scs, gcs, n1 * nc, bar, n);
  if (x0 != nullptr)
    for (int i = tid; i < nm * nx; i += blockDim.x) {
      const int q = i / nx;
      cp_async<E>(sx0 + i, x0 + static_cast<size_t>(b0 + q) * x0_stride +
                               (i - q * nx));
    }
  cp_async_wait_all();
  __syncthreads();                                 // the edges and x0's rows
  mbarrier_wait(bar, 0);                           // the bodies
  T* lX = landed(sX, gX);
  if (x0 != nullptr) {                             // node 0 takes x0
    for (int i = tid; i < nm * nx; i += blockDim.x) {
      const int q = i / nx;
      lX[static_cast<size_t>(q) * ns1 * nx + (i - q * nx)] = sx0[i];
    }
    __syncthreads();
  }
  // the pinned plan, with wide stores
  if (Xpin != nullptr) {
    constexpr int V = 16 / E;
    T* dst = Xpin + row0 * nx;
    const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
    const int head = d % 16 == reinterpret_cast<uintptr_t>(gX) % 16
                         ? static_cast<int>((16 - d % 16) % 16) / E
                         : static_cast<int>(nX);
    const int h = head < static_cast<int>(nX) ? head : static_cast<int>(nX);
    const int body = (static_cast<int>(nX) - h) / V;
    for (int i = tid; i < body; i += blockDim.x)
      reinterpret_cast<lip::Unit<T, V>*>(dst + h)[i] =
          reinterpret_cast<const lip::Unit<T, V>*>(lX + h)[i];
    for (int i = tid; i < static_cast<int>(nX) - body * V; i += blockDim.x) {
      const int e = i < h ? i : h + body * V + (i - h);
      dst[e] = lX[e];
    }
  }
  // a node a thread
  T c = T(0), dm = T(0);
  if (m < nm && n <= ns) {
    const int row = m * ns1 + n;
    const T* lmt = landed(smt, gmt);
    const T* lrd = landed(srd, grd);
    const T* lcr = landed(scr, gcr);
    const T* lcs = landed(scs, gcs);
    T* p = reinterpret_cast<T*>(smem_raw + r.prm) + row * kPw;
    p[lip::kP_mt] = lmt[row];
#pragma unroll
    for (int i = 0; i < 3; ++i) p[lip::kP_rdot + i] = lrd[row * 3 + i];
#pragma unroll
    for (int i = 0; i < nc; ++i) {
      p[lip::kP_cref + i] = lcr[row * nc + i];
      p[lip::Param<S>::cs + i] = lcs[row * nc + i];
    }
    const T* x = lX + static_cast<size_t>(row) * nx;
    if (n < ns) {
      const T* u = landed(sU, gU) + static_cast<size_t>(m * ns + n) * nu;
      c = lip::stage_sq<S>(x, u, p, k);
      if constexpr (S::Step::stages == 1) {
#pragma unroll
        for (int j = 0; j < nx; ++j) {
          const T step = lip::step_row<S>(j, x, u, k);
          dm = lip::nan_max(dm, lip::abs_nan(step - x[nx + j]));
        }
      } else {                                     // a pair's stages once
        constexpr int h = lip::Layout<S>::half;
#pragma unroll 1
        for (int i = 0; i < h; ++i) {
          T pn, vn;
          lip::step_pair<S>(i, x, u, k, &pn, &vn);
          dm = lip::nan_max(dm, lip::abs_nan(pn - x[nx + i]));
          dm = lip::nan_max(dm, lip::abs_nan(vn - x[nx + h + i]));
        }
      }
    } else {
      c = lip::terminal_sq<S>(x, p, k);
    }
  }
  // the member's sums, one thread
  T sum = T(0), dmax = T(0);
  for (int i = 0; i < ns; ++i) {          // every lane shuffles, lane 0 keeps
    sum += __shfl_sync(0xffffffffu, c, i);
    dmax = lip::nan_max(dmax, __shfl_sync(0xffffffffu, dm, i));
  }
  const T terminal = __shfl_sync(0xffffffffu, c, ns);
  if (m < nm && n == 0) {
    cost_out[b0 + m] = sum + terminal;
    dmax_out[b0 + m] = dmax;
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

constexpr size_t kMaxSmem = 232448;   // an H100 block's dynamic shared memory

template <class S, typename T, bool kEvaluate>
int launch_trial(const void* x0, const void* X, const void* U, const void* ks,
                 const void* Ks, const void* d, const void* alphas,
                 const void* const* params, const void* merit0,
                 const void* D, const void* dV1, const void* dV2, int B,
                 int ns, int nA, const double* scalars, double nu_w,
                 double beta, double alpha_min, void* Xn, void* Un,
                 void* cost, void* merit, void* ok, void* stream) {
  if (static_cast<long long>(B) * nA == 0) return 0;
  const size_t bytes = regions<S, sizeof(T)>(ns, alphas_a_block(nA)).total;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lip_trial_kernel<S, T, kEvaluate>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>(B) *
                          static_cast<unsigned>((nA + kMaxAlphas - 1) / kMaxAlphas);
  kernel<<<blocks, 32 * (alphas_a_block(nA) + 1), bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(X),
      static_cast<const T*>(U), static_cast<const T*>(ks),
      static_cast<const T*>(Ks), static_cast<const T*>(d),
      static_cast<const T*>(alphas), lip::make_params<T>(params),
      static_cast<const T*>(merit0), static_cast<const T*>(D),
      static_cast<const T*>(dV1), static_cast<const T*>(dV2), B, ns, nA,
      lip::make_consts<T>(scalars), static_cast<T>(nu_w),
      static_cast<T>(beta), static_cast<T>(alpha_min), static_cast<T*>(Xn),
      static_cast<T*>(Un), static_cast<T*>(cost), static_cast<T*>(merit),
      static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
  }
  return count;
}

// The members a lip_evaluate block takes at B members on `sms` SMs and ns
// stage nodes, tensors of E bytes: eval_members', halved while the block
// would not fit kMaxSmem (only the eight-contact robots' float64 blocks at
// ns past 24 hold fewer than eight; kernels/lip_rollout.py::eval_members).
template <class S, int E>
int block_members(int B, int sms, int ns) {
  int m = eval_members(B, sms);
  while (m > 1 && eval_regions<S, E>(ns, m).total > kMaxSmem) m /= 2;
  return m;
}

template <class S, typename T>
int launch_evaluate(const void* X, const void* U, const void* x0,
                    int x0_stride, const void* const* params, int B, int ns,
                    const double* scalars, void* cost, void* dmax, void* Xpin,
                    void* stream) {
  if (ns + 1 > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int mb = block_members<S, sizeof(T)>(B, sm_count(), ns);
  const int warps = mb > kEvalWarps ? mb : kEvalWarps;
  const size_t bytes = eval_regions<S, sizeof(T)>(ns, mb).total;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lip_evaluate_kernel<S, T>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(B + mb - 1) / mb, 32 * warps, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      static_cast<const T*>(x0), x0_stride, lip::make_params<T>(params), B,
      ns, mb, lip::make_consts<T>(scalars), static_cast<T*>(cost),
      static_cast<T*>(dmax), static_cast<T*>(Xpin));
  return static_cast<int>(cudaGetLastError());
}

// lip_evaluate's occupancy at ns stage nodes with `mb` members a block,
// into out[0..4]: blocks resident on one SM, warps a block, shared memory
// bytes a block, registers a thread and local (spilled) bytes a thread.
template <class S, typename T>
int evaluate_occupancy(int ns, int mb, int* out) {
  const size_t bytes = eval_regions<S, sizeof(T)>(ns, mb).total;
  auto kernel = lip_evaluate_kernel<S, T>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, 32 * (mb > kEvalWarps ? mb : kEvalWarps), bytes);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = mb > kEvalWarps ? mb : kEvalWarps;
  out[2] = static_cast<int>(bytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

// K11's occupancy at ns stage nodes and nA step sizes a call (the
// evaluating kernel, the solver's), into out[0..4]: blocks resident on one
// SM, dynamic shared memory bytes a block, registers a thread, local
// (spilled) bytes a thread, warps a block.
template <class S, typename T>
int trial_occupancy(int ns, int nA, int* out) {
  const size_t bytes = regions<S, sizeof(T)>(ns, alphas_a_block(nA)).total;
  auto kernel = lip_trial_kernel<S, T, true>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, 32 * (alphas_a_block(nA) + 1), bytes);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = static_cast<int>(bytes);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = alphas_a_block(nA) + 1;
  return static_cast<int>(e);
}

}  // namespace

// lip_trial_* run the trial; lip_trial_chain_* the same kernel with the
// evaluation compiled out (Xn and Un; cost, merit and ok are not written):
// chip_smoke.py times the chain alone with it. The instance is the
// topology (nc, cm, n_legs) under the step (its id, lip::Euler / Rk2 /
// Rk4).
#define TRIAL_ENTRY(NAME, T, EVALUATE)                                        \
  extern "C" int NAME(                                                        \
      const void* x0, const void* X, const void* U, const void* ks,           \
      const void* Ks, const void* d, const void* alphas,                      \
      const void* const* params, const void* merit0, const void* D,           \
      const void* dV1, const void* dV2, int B, int ns, int nc, int cm,        \
      int n_legs, int step, int nA, const double* scalars, double nu_w,       \
      double beta, double alpha_min, void* Xn, void* Un, void* cost,          \
      void* merit, void* ok, void* stream) {                                  \
    return lip::with_topology(nc, cm, n_legs, step, [&](auto shape) {        \
      return launch_trial<decltype(shape), T, EVALUATE>(                      \
          x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1, dV2, B, ns,    \
          nA, scalars, nu_w, beta, alpha_min, Xn, Un, cost, merit, ok,        \
          stream);                                                            \
    });                                                                       \
  }

TRIAL_ENTRY(lip_trial_f32, float, true)
TRIAL_ENTRY(lip_trial_f64, double, true)
TRIAL_ENTRY(lip_trial_chain_f32, float, false)
TRIAL_ENTRY(lip_trial_chain_f64, double, false)

// x0 and Xpin are null, or x0 (B, nx, rows x0_stride elements apart)
// takes node 0's place and Xpin (B, ns+1, nx) receives the pinned plan.
#define EVALUATE_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* X, const void* U, const void* x0,           \
                      int x0_stride, const void* const* params, int B,        \
                      int ns, int nc, int cm, int n_legs, int step,           \
                      const double* scalars, void* cost, void* dmax,          \
                      void* Xpin, void* stream) {                             \
    return lip::with_topology(nc, cm, n_legs, step, [&](auto shape) {        \
      return launch_evaluate<decltype(shape), T>(X, U, x0, x0_stride, params, \
                                                 B, ns, scalars, cost, dmax,  \
                                                 Xpin, stream);               \
    });                                                                       \
  }

EVALUATE_ENTRY(lip_evaluate_f32, float)
EVALUATE_ENTRY(lip_evaluate_f64, double)

// lip_evaluate's occupancy at the instance `shape` (its index in
// kernels/lip_linearize.py::KERNEL_SHAPES) for float32 (f64 = 0) or
// float64 tensors at ns stage nodes with the block of B=4096's launch,
// kEvalMembers members (see evaluate_occupancy above).
extern "C" int lip_evaluate_occupancy(int shape, int f64, int ns, int* out) {
  return lip::with_shape(shape, [&](auto sh) {
    using S = decltype(sh);
    return f64 ? evaluate_occupancy<S, double>(ns, kEvalMembers, out)
               : evaluate_occupancy<S, float>(ns, kEvalMembers, out);
  });
}

// The members a lip_evaluate block takes at B members on the current card.
extern "C" int lip_evaluate_members(int B) {
  return eval_members(B, sm_count());
}

// K11's occupancy at the instance `shape` (as above) for float32 (f64 =
// 0) or float64 tensors at ns stage nodes and nA step sizes a call (see
// trial_occupancy above).
extern "C" int lip_trial_occupancy(int shape, int f64, int ns, int nA, int* out) {
  return lip::with_shape(shape, [&](auto sh) {
    using S = decltype(sh);
    return f64 ? trial_occupancy<S, double>(ns, nA, out)
               : trial_occupancy<S, float>(ns, nA, out);
  });
}
