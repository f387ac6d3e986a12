// K7 and K8 — the augmented-Lagrangian layer of the constrained serving
// tick (solvers/alddp.py), four entries of one source:
//
//   isrbd_al_constraints (K7)   the constraint pass at a solved plan and,
//                               by a template mode, the multiplier update
//   isrbd_al_shift       (K8a)  the warm start rolled one node, and the
//                               multipliers seeded from the gait-phase
//                               tables (no prior, tail or full prior)
//   isrbd_al_params      (K8b)  the padded `al_*` tensors of the inner
//                               solve's parameter dict
//   isrbd_al_prior_update (K8c) the post-solve multipliers blended into
//                               the phase tables (out of place)
//
// Replaces the JAX package's `ALDDP._constraints` under `vmap`
// (srbd_horizon_tpu/solvers/alddp.py:376-410), `_updated_multipliers`
// (:452-503) with the penalty schedule (:547-552), the online equality
// update (:751-759), `shift_warmstart` (:585-605), the priors' seeds and
// updates (:621-701) and `_params_with_multipliers` (:414-450), which XLA
// fused into the jitted tick on the TPU (no Pallas kernel). Plain twins:
// `kernels/isrbd_al.py::isrbd_al_*_plain`.
//
// K7, per member, over the ns stage nodes and the terminal node:
//     h  = S·h_raw(x, u, p)      (n_eq a node: rel-vel, cz, Newton–Euler,
//     hT = S_T·h_raw,T(x_N, p_N)  LIP, LIP zone; csrc/isrbd_common.cuh)
//     g  = A_fc·f                (the cones, g ≤ 0 with no lower bound)
//     viol = max(0, |h|, |hT|, g, the x/u box overshoots)
// and by mode: kEval writes h, hT, g and viol; kOnline the equality update
// λ + (ρw)·h, λ_T + (ρw_T)·hT and viol; kOffline all eight multipliers,
// μ ← max(0, μ + ρ·gap) where the bound is finite (else 0), the penalty
// schedule ρ ← min(ργ, ρ_max) where viol > viol_decrease·viol_prev and
// viol > tol, and viol. The maxima keep a NaN (nan_max, relu_nan), as
// torch.amax/clamp and jnp.max/maximum do; a side whose bound is infinite
// is 0 even for a NaN value, as the twin's torch.where makes it. The
// source is built without FMA contraction (-fmad=false, kernels/build.py),
// so each product and sum rounds on its own as the twin's separate torch
// ops do; where the twin multiplies matrices (the cones A_fc f, and R I Rᵀ,
// Iw ω, Iw ω̇ of the Euler rows) K7 forms the three-term sums as a cuBLAS
// product does on the card, a₀b₀ then fused multiply-adds in order (dot3).
// Given the same plan the multiplier updates then agree with the twin's to
// rounding of those sums alone, which the updates' cancellation near
// max(0, ·) would otherwise magnify by ρ.
//
// K8 moves values only: the rolls, the seeds and the padding are copies,
// and the prior update's blend (1−e)·a + e·b rounds as the twin's three
// torch ops do, so all of K8 is bit-equal to its twins and the tables do
// not drift from a CPU run across ticks.
//
// What bounds them on an H100: bytes. A member of the serving fleet
// (ns=20) reads its plan and multipliers, ~5.4k values, in each entry, and
// K7 does ~60 FLOP per equality row and a few per box row; K8c also copies
// the member's P·(ns·n_eq + n_eq_T) table values. At B=256 that is 1-10 MB
// an entry, 0.3-3 µs at 3.35 TB/s: the launch and a member's round trips
// to device memory, not the work, are their floor. K8: a block a member,
// threads on neighbouring elements of each member's contiguous run
// (coalesced); K8a and K8b hold every value a member reads in registers,
// loaded in one round before any store (below), and K8a loads the prior's
// phase first, its table row and flags as soon as the phase is in (two
// dependent round trips, the second under the plan's).
//
// K7: one block of eight warps a member, every value the mode reads
// staged in one round at the start: x, u, c_ref and the three masks; the
// bounds (the static (N, dim) tables at member stride 0, or the
// per-member overrides); and by mode λ, λ_T, ρ, then viol_prev and the
// μ's. Each run goes as the 16-byte-aligned window around it in 16-byte
// cp.async copies by one warp's lanes (`stage_run`), landing in its own
// region at its source's offset within 16 bytes (`landed`); the launcher
// deals the runs out to the warps, the longest first to the least loaded
// (`make_runs`, with each run's stride, elements and region), so a thread
// sets up two or three runs, not every one. Every thread then waits once;
// no load waits on a store or a barrier, and nothing is read from device
// memory after it. (One bulk copy a run, from a lane each of one warp or
// from a warp each, and the static tables left to L1 by prefetches, all
// timed no better.) The Euler rows take three lanes a node (a warp ten
// nodes, the last warps, which hold the fewest other elements): lane a
// forms R, row a of R I and of Iw = R I Rᵀ and (Iw ω)_a, and takes the
// other two entries of Iw ω from its neighbours by shuffles, so the
// geometry needs no shared-memory round trip or block barrier. The other equality rows
// go row by row over the nodes (a warp on one or two rows takes one
// path), and every other output element (the cones, the boxes and their
// multipliers) is one thread's, threads on neighbouring elements, and is
// stored as soon as it is formed (coalesced; the stores wait on nothing).
// One block barrier reduces the violation. A member's record (`reads`,
// `run_count`; ~7.9k values offline with per-member bounds, 63 KB in
// float64, 32 KB in float32) is held in shared memory, so no value waits
// in registers for another. Compiled for the shapes of
// csrc/isrbd_common.cuh only (`AL<S>` holds K7's constants at each); the
// prior tables' period P and ns are run-time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include <stdint.h>

#include "isrbd_common.cuh"
#include "dmma.cuh"

namespace {

using rigid::nan_max;
using isrbd::relu_nan;
using isrbd::kUnknownShape;

constexpr int kThreads = 256;        // a member a block
constexpr int kWarps = kThreads / 32;
constexpr int kEulerNodes = 10;      // a warp's nodes in K7's Euler pass
// K7's blocks an SM that its launch bound asks registers for: five in
// float32 (48 registers a thread), four in float64 (64; the offline
// record's 63 KB holds three). Five to eight in float32 timed the same at
// B = 256 and 4096: the fleet is held by the instructions a member takes,
// not by the blocks in flight.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 5 : 4;
constexpr size_t kMaxSmem = 232448;  // the shared memory a block may take

__host__ __device__ constexpr size_t round16(size_t v) { return (v + 15) / 16 * 16; }

// Each product and sum rounded on its own, as separate torch ops round
// them (nvcc would otherwise contract a·b + c into one fused multiply-add).
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// a₀b₀ + a₁b₁ + a₂b₂ as the twin's torch.matmul forms its three-term sums
// on the card (a cuBLAS product): a₀b₀, then fused multiply-adds in order
// of k.
template <typename T>
__device__ __forceinline__ T dot3(T a0, T a1, T a2, T b0, T b1, T b2) {
  return fma_rn(a2, b2, fma_rn(a1, b1, mul_rn(a0, b0)));
}

// The same of entries sa and sb apart.
template <typename T>
__device__ __forceinline__ T dot3(const T* a, int sa, const T* b, int sb) {
  return dot3(a[0], a[sa], a[2 * sa], b[0], b[sb], b[2 * sb]);
}

// (1 − e)·a + e·b with `ome` = 1 − e formed on the host, as the twin forms
// the Python scalar.
template <typename T>
__device__ __forceinline__ T blend(T ome, T e, T a, T b) {
  return add_rn(mul_rn(ome, a), mul_rn(e, b));
}

// An int32 or int64 phase vector's entry `b`, and that entry plus `shift`
// taken modulo P onto 0 … P−1 (a floor modulo, as torch indexes a table
// with a negative index and as Python's % takes the tail prior's
// phase − 1). K8a loads the entry first and takes the modulo after
// issuing the plan's loads; K8c takes both at once (phase_at).
__device__ __forceinline__ long long phase_value(const void* phase, int bytes,
                                                 size_t b) {
  return bytes == 8 ? static_cast<const long long*>(phase)[b]
                    : static_cast<const int*>(phase)[b];
}
__device__ __forceinline__ int phase_mod(long long v, int shift, int P) {
  const long long r = (v + shift) % P;
  return static_cast<int>(r < 0 ? r + P : r);
}
__device__ __forceinline__ int phase_at(const void* phase, int bytes, size_t b,
                                        int shift, int P) {
  return phase_mod(phase_value(phase, bytes, b), shift, P);
}

// ---- K7: isrbd_al_constraints ----

enum Mode { kEval = 0, kOnline = 1, kOffline = 2 };

// Inputs, each member-major and contiguous. The bounds may be one static
// (N, dim) table for every member (member stride 0) or the params'
// per-member overrides.
enum In {
  I_X, I_U, I_CREF, I_MSRBD, I_MLIP, I_MZONE, I_XLB, I_XUB, I_ULB, I_UUB,
  I_LAM, I_LAMT, I_RHO, I_VIOLP, I_MUUB, I_MULB, I_MUXUB, I_MUXLB, I_MUUUB,
  I_MUULB, kIns
};
enum Out {
  O_H, O_HT, O_G, O_LAM, O_LAMT, O_MUUB, O_MULB, O_MUXUB, O_MUXLB, O_MUUUB,
  O_MUULB, O_RHO, O_VIOL, kOuts
};

template <typename T>
struct Ptrs {
  const T* __restrict__ in[kIns];
  T* __restrict__ out[kOuts];
  long long stride[4];               // x_lb, x_ub, u_lb, u_ub: member strides
};

// Whether `mode` reads input i: the plan, the references, the masks and
// the bounds always; λ, λ_T and ρ in the updates; viol_prev and the μ's
// offline, but μ_lb (the cones have no lower bound: μ_lb′ is 0).
__host__ __device__ constexpr bool reads(int i, int mode) {
  return i <= I_UUB || (i <= I_RHO && mode != kEval) || (i != I_MULB && mode == kOffline);
}

// The elements of input i a member holds (a bound's static table as many).
template <class S>
__host__ __device__ constexpr size_t run_count(int i, int ns) {
  switch (i) {
    case I_X: case I_XLB: case I_XUB: case I_MUXUB: case I_MUXLB: return (ns + 1) * size_t(S::nx);
    case I_U: case I_ULB: case I_UUB: case I_MUUUB: case I_MUULB: return ns * size_t(S::nu);
    case I_CREF: return (ns + 1) * size_t(S::nc);
    case I_MSRBD: case I_MLIP: case I_MZONE: return ns + 1;
    case I_LAM: return ns * size_t(S::n_eq);
    case I_LAMT: return S::n_eq_T;
    case I_MUUB: case I_MULB: return ns * size_t(S::n_in);
    default: return 1;                       // ρ, viol_prev
  }
}

// Input i's region in shared memory: its run and 16 bytes more (the run
// lands at its source's offset within 16 bytes).
template <class S, typename T>
__host__ __device__ constexpr size_t region_bytes(int i, int ns) {
  return round16(run_count<S>(i, ns) * sizeof(T) + 16);
}

// K7's shared memory: the regions of the inputs `mode` reads, in the order
// of In, then the warps' maxima
// (kernels/isrbd_al.py::constraints_smem_bytes states the same).
template <class S, typename T>
__host__ __device__ constexpr size_t constraints_smem_bytes(int mode, int ns) {
  size_t bytes = 0;
  for (int i = 0; i < kIns; ++i)
    if (reads(i, mode)) bytes += region_bytes<S, T>(i, ns);
  return bytes + round16(kWarps * sizeof(T));
}

// Where a run staged into the region at dst lands: at dst plus its
// source's offset within 16 bytes, so that the 16-byte-aligned window
// around it starts at dst.
template <typename T>
__device__ __forceinline__ T* landed(T* dst, const T* src) {
  return dst + (reinterpret_cast<uintptr_t>(src) % 16) / sizeof(T);
}

// One warp stages the run of `count` elements at src into the region at
// dst (`landed` reads it there): the 16-byte-aligned window around the run
// in 16-byte cp.async copies, piece c by lane c % 32. The window reads only
// the 16-byte blocks the run touches, so nothing outside the pages the
// run's tensor maps, and it fits the region (region_bytes).
template <typename T>
__device__ __forceinline__ void stage_run(T* dst, const T* src, size_t count,
                                          int lane) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = s / 16 * 16, hi = (s + count * sizeof(T) + 15) / 16 * 16;
  const int pieces = static_cast<int>((hi - lo) / 16);
  auto* d = reinterpret_cast<unsigned char*>(dst);
  const auto* g = reinterpret_cast<const unsigned char*>(lo);
  for (int c = lane; c < pieces; c += 32) cp_async<16>(d + 16 * c, g + 16 * c);
}

// What the launcher works out once for a call (make_runs): each input's
// member stride in elements, the elements of its run, its region's byte
// offset, and the warp that stages it.
struct Runs {
  long long stride[kIns];
  int count[kIns];
  int region[kIns];
  int warp[kIns];
};

// K7's sizes, constants and device code at the shape S (the kernels
// below take AL<S>'s pieces; K8 reads its sizes).
template <class S>
struct AL {
  using L = isrbd::Layout<S>;
  static constexpr int nx = S::nx, nu = S::nu, nc = S::nc, n_eq = S::n_eq,
                       n_eq_T = S::n_eq_T, n_in = S::n_in;

  // The host scalars (kernels/isrbd_al.py::al_scalars): isrbd::Consts' (dt, m,
  // …, S, √w, S_T, √w_T), then w (n_eq), w_T (n_eq_T), viol_decrease, tol,
  // rho_growth, rho_max.
  template <typename T>
  struct AlConsts {
    isrbd::Consts<S, T> k;
    T w[n_eq], w_T[n_eq_T];
    T viol_decrease, tol, rho_growth, rho_max;
  };

  static constexpr int kConstScalars = isrbd::kFixedScalars + 2 * n_eq + 2 * n_eq_T;

  template <typename T>
  static AlConsts<T> make_al_consts(const double* s) {
    AlConsts<T> c;
    c.k = isrbd::make_consts<S, T>(s);
    const double* r = s + kConstScalars;
    for (int i = 0; i < n_eq; ++i) c.w[i] = static_cast<T>(r[i]);
    for (int i = 0; i < n_eq_T; ++i) c.w_T[i] = static_cast<T>(r[n_eq + i]);
    r += n_eq + n_eq_T;
    c.viol_decrease = static_cast<T>(r[0]);
    c.tol = static_cast<T>(r[1]);
    c.rho_growth = static_cast<T>(r[2]);
    c.rho_max = static_cast<T>(r[3]);
    return c;
  }

  // Unscaled equality h_q of a stage node but the Euler rows: the rows of
  // isrbd::stage_eq_h, read from the staged runs (the node's x, u and c_ref
  // rows and its three masks, each apart).
  template <typename T>
  __device__ static __forceinline__ T eq_h(int q, const T* x, const T* u,
                                           const T* cref, const T* msrbd,
                                           const T* mlip, const T* mzone,
                                           const isrbd::Consts<S, T>& k) {
    if constexpr (L::n_relvel > 0) {
      if (q < L::q_cz)
        return x[isrbd::relvel_col<S>(q, true)] - x[isrbd::relvel_col<S>(q, false)];
    }
    if (q < L::q_newton) return x[L::i_c + 3 * (q - L::q_cz) + 2] - cref[q - L::q_cz];
    if (q < L::q_euler) {                        // Newton: m(r̈ + g) − Σf
      const int a = q - L::q_newton;
      T f = T(0);
  #pragma unroll
      for (int c = 0; c < nc; ++c) f += u[isrbd::col_f(c, a)];
      const T acc = a == 2 ? u[a] + T(9.81) : u[a];
      return *msrbd * (k.m * acc - f);
    }
    const T* r = x;
    const T* w = x + L::i_w;
    if (q < L::q_zone) {                         // LIP: m(r̈ − [η²(r − zmp) − g])
      const int a = q - L::q_lip;
      T zmp = T(0);
      if (a < 2) {
  #pragma unroll
        for (int c = 0; c < nc; ++c) zmp += x[L::i_c + 3 * c + a];
        zmp = zmp / T(nc);
      }
      T lip = k.eta2 * (r[a] - zmp);
      if (a == 2) lip = lip - T(9.81);
      return *mlip * (k.m * (u[a] - lip));
    }
    const int a = q - L::q_zone;                 // LIP zone: r_z, ω
    return *mzone * (a == 0 ? x[2] - k.com_z : w[a - 1]);
  }

  // Unscaled terminal equality h_q (isrbd::terminal_eq_h from the runs).
  template <typename T>
  __device__ static __forceinline__ T terminal_h(int q, const T* x,
                                                 const T* cref,
                                                 const T* mzone,
                                                 const isrbd::Consts<S, T>& k) {
    if constexpr (L::n_relvel > 0) {
      if (q < L::q_cz)
        return x[isrbd::relvel_col<S>(q, true)] - x[isrbd::relvel_col<S>(q, false)];
    }
    if (q < L::q_cz + nc) return x[L::i_c + 3 * (q - L::q_cz) + 2] - cref[q - L::q_cz];
    const int a = q - L::q_cz - nc;
    return *mzone * (a == 0 ? x[2] - k.com_z : x[L::i_w + a - 1]);
  }

  // Euler row a (= lane % 3) of the stage node at x, u: Iw ω̇ + ω × Iw ω −
  // Σ(c − r) × f, with Iw = (R I) Rᵀ and Iw ω formed as the twin's matrix
  // products (models/srbd.py::world_inertia, srbd_residual): this lane
  // forms row a of R I and of Iw and (Iw ω)_a, and takes (Iw ω)_{a+1},
  // (Iw ω)_{a+2} from lanes `lane − a + (a+1)%3`, `… (a+2)%3`. Every lane of
  // the warp calls it (the shuffles take all 32).
  template <typename T>
  __device__ static __forceinline__ T euler_row(int a, int lane, const T* x,
                                                const T* u, const T* msrbd,
                                                const isrbd::Consts<S, T>& k) {
    T R[9];
    rigid::quat_to_rot(x + 3, R);
    const T* w = x + L::i_w;
    const T Ra0 = a == 0 ? R[0] : a == 1 ? R[3] : R[6];
    const T Ra1 = a == 0 ? R[1] : a == 1 ? R[4] : R[7];
    const T Ra2 = a == 0 ? R[2] : a == 1 ? R[5] : R[8];
    T RI[3], Iw[3];
  #pragma unroll
    for (int j = 0; j < 3; ++j) RI[j] = dot3(Ra0, Ra1, Ra2, k.I[j], k.I[3 + j], k.I[6 + j]);
  #pragma unroll
    for (int j = 0; j < 3; ++j)
      Iw[j] = dot3(RI[0], RI[1], RI[2], R[3 * j], R[3 * j + 1], R[3 * j + 2]);
    const T h = dot3(Iw[0], Iw[1], Iw[2], w[0], w[1], w[2]);
    const int a1 = (a + 1) % 3, a2 = (a + 2) % 3;
    const T h1 = __shfl_sync(0xffffffffu, h, lane - a + a1);
    const T h2 = __shfl_sync(0xffffffffu, h, lane - a + a2);
    const T Iwd = dot3(Iw[0], Iw[1], Iw[2], u[3], u[4], u[5]);
    const T wxh = w[a1] * h2 - w[a2] * h1;
    T tau = T(0);
  #pragma unroll
    for (int c = 0; c < nc; ++c) {
      const T* cc = x + L::i_c + 3 * c;
      const T* f = u + isrbd::col_f(c, 0);
      tau += (cc[a1] - x[a1]) * f[a2] - (cc[a2] - x[a2]) * f[a1];
    }
    return *msrbd * ((Iwd + wxh) - tau);
  }
};

// max(0, v − ub) where ub is finite, max(0, lb − v) where lb is, the larger
// (a NaN v gives NaN on a finite side, 0 on an infinite one).
template <typename T>
__device__ __forceinline__ T box_violation(T v, T lb, T ub) {
  const T over = isfinite(ub) ? relu_nan(v - ub) : T(0);
  const T under = isfinite(lb) ? relu_nan(lb - v) : T(0);
  return nan_max(over, under);
}

// max(0, μ + ρ·gap) where the bound is finite, else 0.
template <typename T>
__device__ __forceinline__ T side(T mu, T rho, T gap, T bound) {
  return isfinite(bound) ? relu_nan(add_rn(mu, mul_rn(rho, gap))) : T(0);
}

template <class S, typename T, int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
isrbd_al_constraints_kernel(const Ptrs<T> P, const Runs R, int ns,
                            const __grid_constant__ typename AL<S>::template AlConsts<T> c) {
  using C = AL<S>;
  using L = typename C::L;
  constexpr int nx = C::nx, nu = C::nu, nc = C::nc, n_eq = C::n_eq,
                n_eq_T = C::n_eq_T, n_in = C::n_in;
  constexpr bool kOff = kMode == kOffline;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t b = blockIdx.x;
  const int ns1 = ns + 1;
  const isrbd::Consts<S, T>& k = c.k;

  // input i: its member's run in device memory, and where it lands
  auto source = [&](int i) -> const T* { return P.in[i] + b * R.stride[i]; };
  auto run = [&](int i) -> T* {
    return landed(reinterpret_cast<T*>(smem_raw + R.region[i]), source(i));
  };
  T* red = reinterpret_cast<T*>(
      smem_raw + constraints_smem_bytes<S, T>(kMode, ns) - round16(kWarps * sizeof(T)));

  // stage every run the mode reads, in one round: each warp issues the
  // runs the launcher gave it, then every thread waits once
#pragma unroll
  for (int i = 0; i < kIns; ++i)
    if (reads(i, kMode) && warp == R.warp[i])
      stage_run(reinterpret_cast<T*>(smem_raw + R.region[i]), source(i), R.count[i], lane);
  cp_async_wait_all();
  __syncthreads();                                   // every run is in

  const T* x = run(I_X);
  const T* u = run(I_U);
  const T* cref = run(I_CREF);
  const T* msrbd = run(I_MSRBD);
  const T* mlip = run(I_MLIP);
  const T* mzone = run(I_MZONE);
  const T rho = kMode == kEval ? T(0) : *run(I_RHO);
  T vmax = T(0);

  // the stage equalities h = S·h_raw, and λ + (ρw)·h: first the Euler
  // rows, three lanes a node
  auto put_eq = [&](int n, int q, T h) {
    vmax = nan_max(vmax, isrbd::abs_nan(h));
    const size_t o = (b * ns + n) * n_eq + q;
    if (kMode == kEval)
      P.out[O_H][o] = h;
    else
      P.out[O_LAM][o] = add_rn(run(I_LAM)[n * n_eq + q], mul_rn(mul_rn(rho, c.w[q]), h));
  };
  // (the last warps, which hold the fewest elements of the passes below)
  for (int n0 = (kWarps - 1 - warp) * kEulerNodes; n0 < ns;
       n0 += kWarps * kEulerNodes) {
    const int a = lane % 3, m = n0 + lane / 3, n = m < ns ? m : n0;
    const T h = C::euler_row(a, lane, x + n * nx, u + n * nu, msrbd + n, k);
    if (lane < 3 * kEulerNodes && m < ns) {
      const int q = L::q_euler + a;
      put_eq(n, q, k.S[q] * h);
    }
  }
  // the other stage equality rows, row by row (a warp's lanes on one or
  // two rows of neighbouring nodes take one path)
  #pragma unroll 2
  for (int i = tid; i < ns * (n_eq - 3); i += kThreads) {
    const int r = i / ns, n = i - r * ns;
    const int q = r < L::q_euler ? r : r + 3;
    put_eq(n, q, k.S[q] * C::eq_h(q, x + n * nx, u + n * nu, cref + n * nc,
                                  msrbd + n, mlip + n, mzone + n, k));
  }
  // the terminal equalities hT = S_T·h_raw,T, and λ_T + (ρw_T)·hT
  if (warp == kWarps - 3 && lane < n_eq_T) {
    const int q = lane;
    const T h = k.S_T[q] * C::terminal_h(q, x + ns * nx, cref + ns * nc, mzone + ns, k);
    vmax = nan_max(vmax, isrbd::abs_nan(h));
    const size_t o = b * n_eq_T + q;
    if (kMode == kEval)
      P.out[O_HT][o] = h;
    else
      P.out[O_LAMT][o] = add_rn(run(I_LAMT)[q], mul_rn(mul_rn(rho, c.w_T[q]), h));
  }
  // the cones: g = A_fc f ≤ 0 (bounded above by 0 only)
  #pragma unroll 2
  for (int i = tid; i < ns * n_in; i += kThreads) {
    const int n = i / n_in, j = i - n * n_in;
    const T* f = u + n * nu + isrbd::col_f(j / 5, 0);
    const T g = dot3(f, 1, k.A_fc + 3 * (j % 5), 1);
    vmax = nan_max(vmax, relu_nan(g));
    const size_t o = b * ns * n_in + i;
    if (kMode == kEval) P.out[O_G][o] = g;
    if (kOff) {
      P.out[O_MUUB][o] = relu_nan(add_rn(run(I_MUUB)[i], mul_rn(rho, g)));
      P.out[O_MULB][o] = T(0);
    }
  }
  // the x boxes, every node
  {
    const T* lb = run(I_XLB);
    const T* ub = run(I_XUB);
    #pragma unroll 2
    for (int i = tid; i < ns1 * nx; i += kThreads) {
      const T v = x[i], l = lb[i], h = ub[i];
      vmax = nan_max(vmax, box_violation(v, l, h));
      if (kOff) {
        const size_t o = b * ns1 * nx + i;
        P.out[O_MUXUB][o] = side(run(I_MUXUB)[i], rho, v - h, h);
        P.out[O_MUXLB][o] = side(run(I_MUXLB)[i], rho, l - v, l);
      }
    }
  }
  // the u boxes, the stage nodes
  {
    const T* lb = run(I_ULB);
    const T* ub = run(I_UUB);
    #pragma unroll 2
    for (int i = tid; i < ns * nu; i += kThreads) {
      const T v = u[i], l = lb[i], h = ub[i];
      vmax = nan_max(vmax, box_violation(v, l, h));
      if (kOff) {
        const size_t o = b * ns * nu + i;
        P.out[O_MUUUB][o] = side(run(I_MUUUB)[i], rho, v - h, h);
        P.out[O_MUULB][o] = side(run(I_MUULB)[i], rho, l - v, l);
      }
    }
  }

  // the member's violation, then the penalty schedule
  vmax = isrbd::warp_nan_max(vmax);
  if (lane == 0) red[warp] = vmax;
  __syncthreads();
  if (warp == 0) {
    T v = lane < kWarps ? red[lane] : T(0);
    v = isrbd::warp_nan_max(v);
    if (lane == 0) {
      P.out[O_VIOL][b] = v;
      if (kOff) {
        const T prev = *run(I_VIOLP);
        T grown = rho * c.rho_growth;
        grown = grown > c.rho_max ? c.rho_max : grown;   // a NaN stays
        const bool grow = v > c.viol_decrease * prev && v > c.tol;
        P.out[O_RHO][b] = grow ? grown : rho;
      }
    }
  }
}

// ---- K8a and K8b: every value a member reads held in one round ----
//
// K8a and K8b copy: a member's runs rolled one node (K8a) or padded to
// ns + 1 nodes (K8b). Each thread loads every element it will store, of
// every run, into registers first (element i = base + s·threads + tid of
// a run, s < slots), and stores only after the last load has issued: no
// load waits on a store (a strided loop a run, as before, made each
// iteration's load wait on the earlier runs' stores, which may alias), so
// a member pays one round trip to device memory, not one a run. Threads on
// neighbouring elements of a run load and store neighbouring addresses
// (coalesced). One round holds slots·threads = 1024 elements of each run:
// the whole member up to (ns + 1)·nx ≤ 1024 (ns ≤ 26 at nx = 37); a longer
// horizon takes a round more, each loading before it stores.
//
// A block a member: K8a 1024 threads holding one element of each run,
// K8b 256 holding four; the launch bounds ask for two and four blocks an
// SM in float32 (32 and 64 registers a thread, no spill), half that in
// float64. Held values live in registers, so the registers bound the
// members an SM has in flight at large B: K8a's ten runs at four
// elements a thread took 77-140 registers (one to three blocks an SM) and
// ran its tail prior at B=4096 slower than the strided loops. Of the sizes
// tried (tools/torch_k8_variants.py), one element a thread at two blocks
// an SM ran no and the full prior fastest at B=4096 and within 4% of the
// fastest at B = 1 and 256, without spilling; K8b's four elements at four
// blocks ran fastest.
constexpr int kShiftThreads = 1024;
constexpr int kShiftSlots = 1;
constexpr int kParamsThreads = 256;
constexpr int kParamsSlots = 4;
template <typename T>
constexpr int kShiftMinBlocks = sizeof(T) == 4 ? 2 : 1;
template <typename T>
constexpr int kParamsMinBlocks = sizeof(T) == 4 ? 4 : 2;

// The widest node of a shape's runs (the bound of a member's rounds).
template <class S>
__host__ __device__ constexpr int widest() {
  constexpr int a = S::nx > S::nu ? S::nx : S::nu;
  constexpr int c = S::n_eq > S::n_in ? S::n_eq : S::n_in;
  return a > c ? a : c;
}

// ---- K8a: isrbd_al_shift ----

enum Prior { kNone = 0, kTail = 1, kFull = 2 };

// Inputs: the plan and the node-indexed multipliers (rolled), λ_T, then
// the prior's tables: the stage table (tail (B, P, n_eq), full
// (B, P, ns, n_eq)), the terminal table (B, P, n_eq_T), and the seen flags
// of each (the full prior has one flag table for both).
enum ShiftIn {
  S_X, S_U, S_LAM, S_MUUB, S_MULB, S_MUXUB, S_MUXLB, S_MUUUB, S_MUULB, S_LAMT,
  S_TAB, S_TABT, kShiftIns
};
// Outputs in the same order as the first ten inputs (λ_T only with a prior).
constexpr int kShiftOuts = S_LAMT + 1;

// The node width of rolled run r (r < S_LAMT), and whether it has the
// terminal node (ns + 1 nodes; ns otherwise).
template <class S>
__host__ __device__ constexpr int shift_dim(int r) {
  switch (r) {
    case S_X: case S_MUXUB: case S_MUXLB: return S::nx;
    case S_U: case S_MUUUB: case S_MUULB: return S::nu;
    case S_LAM: return S::n_eq;
    default: return S::n_in;
  }
}
__host__ __device__ constexpr bool shift_terminal(int r) {
  return r == S_X || r == S_MUXUB || r == S_MUXLB;
}

template <typename T>
struct ShiftPtrs {
  const T* in[kShiftIns];
  const bool* seen;                  // tail: seen_tail; full: seen
  const bool* seen_T;                // tail: seen_T; full: seen
  T* out[kShiftOuts];
};

// The element of a run of `count` elements and nodes of `dim` that output
// element i copies: node n ← node n + 1, the last node repeated.
__device__ __forceinline__ int rolled(int i, int count, int dim) {
  return i < count - dim ? i + dim : i;
}

template <class S, typename T, int kPrior>
__global__ void __launch_bounds__(kShiftThreads, kShiftMinBlocks<T>)
isrbd_al_shift_kernel(const ShiftPtrs<T> P, int ns, int period,
                      const void* phase, int phase_bytes) {
  constexpr int n_eq = S::n_eq, n_eq_T = S::n_eq_T;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int ns1 = ns + 1;
  // the prior's row hangs on the phase alone: its load goes first
  const long long raw = kPrior == kNone ? 0 : phase_value(phase, phase_bytes, b);
  for (int base = 0; base < ns1 * widest<S>(); base += kShiftSlots * kShiftThreads) {
    T v[S_LAMT][kShiftSlots];        // the rolled runs' elements, held
    T tab[kShiftSlots];              // the prior's stage entries, held
    T lamT = T(0), tabT = T(0);
    bool seed = false, seed_T = false;
    // every run's loads
#pragma unroll
    for (int r = 0; r < S_LAMT; ++r) {
      const int dim = shift_dim<S>(r);
      const int count = (shift_terminal(r) ? ns1 : ns) * dim;
      const T* in = P.in[r] + b * count;
#pragma unroll
      for (int s = 0; s < kShiftSlots; ++s) {
        const int i = base + s * kShiftThreads + tid;
        if (i < count) v[r][s] = in[rolled(i, count, dim)];
      }
    }
    if (kPrior != kNone) {
      // the terminal write's phase, and the stage tail row's (one tick
      // older); the rows and both flags load without waiting on a flag,
      // and the stores select
      const int ph = phase_mod(raw, 0, period);
      const int sph = kPrior == kTail ? phase_mod(raw, -1, period) : ph;
      const size_t row = b * period + ph, srow = b * period + sph;
      seed = P.seen[srow];
      seed_T = P.seen_T[row];
      const int last = (ns - 1) * n_eq;      // the tail row's first element
      const T* st = P.in[S_TAB] + srow * (kPrior == kFull ? ns * n_eq : n_eq);
#pragma unroll
      for (int s = 0; s < kShiftSlots; ++s) {
        const int i = base + s * kShiftThreads + tid;
        if (kPrior == kFull ? i < ns * n_eq : i >= last && i < ns * n_eq)
          tab[s] = st[kPrior == kFull ? i : i - last];
      }
      if (base == 0 && tid < n_eq_T) {
        lamT = P.in[S_LAMT][b * n_eq_T + tid];
        tabT = P.in[S_TABT][row * n_eq_T + tid];
      }
    }
    // then the stores
#pragma unroll
    for (int r = 0; r < S_LAMT; ++r) {
      const int count = (shift_terminal(r) ? ns1 : ns) * shift_dim<S>(r);
      T* out = P.out[r] + b * count;
#pragma unroll
      for (int s = 0; s < kShiftSlots; ++s) {
        const int i = base + s * kShiftThreads + tid;
        if (i >= count) continue;
        T x = v[r][s];
        if (r == S_LAM && kPrior == kFull && seed) x = tab[s];
        if (r == S_LAM && kPrior == kTail && seed && i >= (ns - 1) * n_eq) x = tab[s];
        out[i] = x;
      }
    }
    if (kPrior != kNone && base == 0 && tid < n_eq_T)
      P.out[S_LAMT][b * n_eq_T + tid] = seed_T ? tabT : lamT;
  }
}

// ---- K8b: isrbd_al_params ----

enum ParamsIn { A_LAM, A_LAMT, A_MUUB, A_MULB, A_RHO, A_MUUUB, A_MUULB, A_ULB, A_UUB, kParamsIO };

template <typename T>
struct ParamsPtrs {
  const T* in[kParamsIO];            // u_lb, u_ub: the params' (B, ns, nu) or null
  T* out[kParamsIO];                 // each (B, ns+1, dim); al_rho (B, ns+1, 1)
};

// The node width of input r (λ_T: its n_eq_T, tiled over the ns + 1
// nodes; ρ: 1, broadcast to them), and the value a padded run (λ, the μ's,
// the u boxes: ns nodes in, ns + 1 out) takes on its last node.
template <class S>
__host__ __device__ constexpr int params_dim(int r) {
  switch (r) {
    case A_LAM: return S::n_eq;
    case A_LAMT: return S::n_eq_T;
    case A_MUUB: case A_MULB: return S::n_in;
    case A_RHO: return 1;
    default: return S::nu;
  }
}
template <typename T>
__host__ __device__ constexpr T params_pad(int r) {
  return r == A_ULB ? -T(INFINITY) : r == A_UUB ? T(INFINITY) : T(0);
}

template <class S, typename T>
__global__ void __launch_bounds__(kParamsThreads, kParamsMinBlocks<T>)
isrbd_al_params_kernel(const ParamsPtrs<T> P, int ns) {
  constexpr int n_eq_T = S::n_eq_T;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int ns1 = ns + 1;
  const T rho = P.in[A_RHO][b];
  for (int base = 0; base < ns1 * widest<S>(); base += kParamsSlots * kParamsThreads) {
    T v[kParamsIO][kParamsSlots];    // each run's elements, held
    // every run's loads: the padded runs' stage nodes, λ_T's entry of
    // each element of its tiling
#pragma unroll
    for (int r = 0; r < kParamsIO; ++r) {
      if (r == A_RHO) continue;
      const T* in = P.in[r];
      if (in == nullptr) continue;             // u_lb, u_ub not overridden
      const int dim = params_dim<S>(r);
#pragma unroll
      for (int s = 0; s < kParamsSlots; ++s) {
        const int i = base + s * kParamsThreads + tid;
        if (r == A_LAMT) {
          if (i < ns1 * n_eq_T) v[r][s] = in[b * n_eq_T + i % n_eq_T];
        } else if (i < ns * dim) {
          v[r][s] = in[b * ns * dim + i];
        }
      }
    }
    // then the stores: each run over ns + 1 nodes, the padded ones' last
    // node their pad, ρ on every node
#pragma unroll
    for (int r = 0; r < kParamsIO; ++r) {
      if (r != A_RHO && P.in[r] == nullptr) continue;
      const int dim = params_dim<S>(r);
      T* out = P.out[r] + b * ns1 * dim;
#pragma unroll
      for (int s = 0; s < kParamsSlots; ++s) {
        const int i = base + s * kParamsThreads + tid;
        if (i >= ns1 * dim) continue;
        out[i] = r == A_RHO ? rho
                 : r == A_LAMT || i < ns * dim ? v[r][s] : params_pad<T>(r);
      }
    }
  }
}

// ---- K8c: isrbd_al_prior_update ----

// Inputs: the post-solve λ (B, ns, n_eq) and λ_T (B, n_eq_T), the stage and
// terminal tables and their seen flags (as K8a's); outputs: the new tables
// and flags, every entry written (the update is out of place).
template <typename T>
struct PriorPtrs {
  const T* lam;
  const T* lamT;
  const T* tab;
  const T* tabT;
  const bool* seen;
  const bool* seen_T;                // the full prior: null (one flag table)
  T* tab_out;
  T* tabT_out;
  bool* seen_out;
  bool* seen_T_out;
};

template <class S, typename T, int kPrior>
__global__ void __launch_bounds__(kThreads)
isrbd_al_prior_update_kernel(const PriorPtrs<T> P, int ns, int period,
                             const void* phase, int phase_bytes, T ome, T e) {
  constexpr int n_eq = S::n_eq, n_eq_T = S::n_eq_T;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int ph = phase_at(phase, phase_bytes, b, 0, period);
  // the stage table's row: the phase (full) or the tail's, one tick older
  const int sph = kPrior == kFull ? ph : phase_at(phase, phase_bytes, b, -1, period);
  const int row = kPrior == kFull ? ns * n_eq : n_eq;   // a table row's values
  const bool seen_s = P.seen[b * period + sph];
  const bool* seenT = kPrior == kFull ? P.seen : P.seen_T;
  const bool seen_t = seenT[b * period + ph];
  // the stage rows the blend reads: all of λ (full), its last node (tail)
  const T* src = P.lam + b * ns * n_eq + (kPrior == kFull ? 0 : (ns - 1) * n_eq);
  const size_t base = b * period * row;
  for (int i = tid; i < period * row; i += kThreads) {
    const int p = i / row, j = i - p * row;
    const T a = P.tab[base + i];
    P.tab_out[base + i] =
        p != sph ? a : (seen_s ? blend(ome, e, a, src[j]) : src[j]);
  }
  const T* lamT = P.lamT + b * n_eq_T;
  const size_t baseT = b * period * n_eq_T;
  for (int i = tid; i < period * n_eq_T; i += kThreads) {
    const int p = i / n_eq_T, j = i - p * n_eq_T;
    const T a = P.tabT[baseT + i];
    P.tabT_out[baseT + i] =
        p != ph ? a : (seen_t ? blend(ome, e, a, lamT[j]) : lamT[j]);
  }
  for (int p = tid; p < period; p += kThreads) {
    const size_t o = b * period + p;
    P.seen_out[o] = p == sph || P.seen[o];
    if (kPrior == kTail) P.seen_T_out[o] = p == ph || P.seen_T[o];
  }
}

// ---- launches ----

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// K7's runs in `mode` at ns stage nodes: the member strides (the bounds'
// from `bound_strides`, 0 for a static table), the regions in the order of
// In (constraints_smem_bytes), and the warps that stage them, the longest
// run first to the warp with the fewest pieces so far.
template <class S, typename T>
Runs make_runs(int mode, int ns, const long long* bound_strides) {
  Runs R{};
  int order[kIns], n = 0;
  size_t off = 0;
  for (int i = 0; i < kIns; ++i) {
    R.count[i] = static_cast<int>(run_count<S>(i, ns));
    R.stride[i] = i >= I_XLB && i <= I_UUB ? bound_strides[i - I_XLB] : R.count[i];
    R.region[i] = static_cast<int>(off);
    R.warp[i] = -1;
    if (reads(i, mode)) {
      off += region_bytes<S, T>(i, ns);
      order[n++] = i;
    }
  }
  for (int a = 1; a < n; ++a)                      // longest first (stable)
    for (int j = a; j > 0 && R.count[order[j]] > R.count[order[j - 1]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  long long load[kWarps] = {};
  for (int a = 0; a < n; ++a) {
    int w = 0;
    for (int v = 1; v < kWarps; ++v)
      if (load[v] < load[w]) w = v;
    R.warp[order[a]] = w;
    load[w] += (R.count[order[a]] * static_cast<long long>(sizeof(T)) + 30) / 16;
  }
  return R;
}

template <class S, typename T, int kMode>
int launch_constraints_mode(const Ptrs<T>& P, int B, int ns,
                            const typename AL<S>::template AlConsts<T>& c,
                            cudaStream_t stream) {
  const size_t bytes = constraints_smem_bytes<S, T>(kMode, ns);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = isrbd_al_constraints_kernel<S, T, kMode>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, kThreads, bytes, stream>>>(P, make_runs<S, T>(kMode, ns, P.stride), ns, c);
  return static_cast<int>(cudaGetLastError());
}

// K7's occupancy in `kMode` at ns stage nodes, into out[0..4]: blocks
// resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), warps
// a block, shared memory bytes a block, registers a thread and local
// (spilled) bytes a thread (cudaFuncGetAttributes).
template <class S, typename T, int kMode>
int constraints_occupancy_mode(int ns, int* out) {
  const size_t bytes = constraints_smem_bytes<S, T>(kMode, ns);
  auto kernel = isrbd_al_constraints_kernel<S, T, kMode>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads, bytes);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = kWarps;
  out[2] = static_cast<int>(bytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

template <class S, typename T>
int constraints_occupancy(int mode, int ns, int* out) {
  if (mode == kEval) return constraints_occupancy_mode<S, T, kEval>(ns, out);
  if (mode == kOnline) return constraints_occupancy_mode<S, T, kOnline>(ns, out);
  if (mode == kOffline) return constraints_occupancy_mode<S, T, kOffline>(ns, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A K8 kernel's occupancy at `threads` a block into out[0..4], as
// constraints_occupancy_mode fills them (no shared memory).
template <class Kernel>
int k8_occupancy(Kernel kernel, int threads, int* out) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, 0);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = threads / 32;
  out[2] = 0;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

template <class S, typename T>
int shift_occupancy(int prior, int* out) {
  if (prior == kNone) return k8_occupancy(isrbd_al_shift_kernel<S, T, kNone>, kShiftThreads, out);
  if (prior == kTail) return k8_occupancy(isrbd_al_shift_kernel<S, T, kTail>, kShiftThreads, out);
  if (prior == kFull) return k8_occupancy(isrbd_al_shift_kernel<S, T, kFull>, kShiftThreads, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class S, typename T>
int launch_constraints(int mode, const void* const* in, void* const* out,
                       const long long* strides, int B, int ns,
                       const double* scalars, void* stream) {
  if (mode < kEval || mode > kOffline) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Ptrs<T> P;
  for (int i = 0; i < kIns; ++i) P.in[i] = static_cast<const T*>(in[i]);
  for (int i = 0; i < kOuts; ++i) P.out[i] = static_cast<T*>(out[i]);
  for (int i = 0; i < 4; ++i) P.stride[i] = strides[i];
  const auto c = AL<S>::template make_al_consts<T>(scalars);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kEval)
    return launch_constraints_mode<S, T, kEval>(P, B, ns, c, st);
  if (mode == kOnline)
    return launch_constraints_mode<S, T, kOnline>(P, B, ns, c, st);
  return launch_constraints_mode<S, T, kOffline>(P, B, ns, c, st);
}

template <class S, typename T>
int launch_shift(int prior, const void* const* in, const void* seen,
                 const void* seen_T, void* const* out, int B, int ns,
                 int period, const void* phase, int phase_bytes, void* stream) {
  if (prior < kNone || prior > kFull || (prior != kNone && period < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  ShiftPtrs<T> P;
  for (int i = 0; i < kShiftIns; ++i) P.in[i] = static_cast<const T*>(in[i]);
  for (int i = 0; i < kShiftOuts; ++i) P.out[i] = static_cast<T*>(out[i]);
  P.seen = static_cast<const bool*>(seen);
  P.seen_T = static_cast<const bool*>(seen_T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prior == kNone)
    isrbd_al_shift_kernel<S, T, kNone><<<B, kShiftThreads, 0, st>>>(P, ns, period, phase, phase_bytes);
  else if (prior == kTail)
    isrbd_al_shift_kernel<S, T, kTail><<<B, kShiftThreads, 0, st>>>(P, ns, period, phase, phase_bytes);
  else
    isrbd_al_shift_kernel<S, T, kFull><<<B, kShiftThreads, 0, st>>>(P, ns, period, phase, phase_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <class S, typename T>
int launch_params(const void* const* in, void* const* out, int B, int ns,
                  void* stream) {
  if (B == 0) return 0;
  ParamsPtrs<T> P;
  for (int i = 0; i < kParamsIO; ++i) {
    P.in[i] = static_cast<const T*>(in[i]);
    P.out[i] = static_cast<T*>(out[i]);
  }
  isrbd_al_params_kernel<S, T><<<B, kParamsThreads, 0, static_cast<cudaStream_t>(stream)>>>(P, ns);
  return static_cast<int>(cudaGetLastError());
}

template <class S, typename T>
int launch_prior_update(int prior, const void* const* in, const void* seen,
                        const void* seen_T, void* const* out, void* seen_out,
                        void* seen_T_out, int B, int ns, int period,
                        const void* phase, int phase_bytes, double ema,
                        void* stream) {
  if ((prior != kTail && prior != kFull) || period < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  PriorPtrs<T> P;
  P.lam = static_cast<const T*>(in[0]);
  P.lamT = static_cast<const T*>(in[1]);
  P.tab = static_cast<const T*>(in[2]);
  P.tabT = static_cast<const T*>(in[3]);
  P.seen = static_cast<const bool*>(seen);
  P.seen_T = static_cast<const bool*>(seen_T);
  P.tab_out = static_cast<T*>(out[0]);
  P.tabT_out = static_cast<T*>(out[1]);
  P.seen_out = static_cast<bool*>(seen_out);
  P.seen_T_out = static_cast<bool*>(seen_T_out);
  const T ome = static_cast<T>(1.0 - ema), e = static_cast<T>(ema);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prior == kTail)
    isrbd_al_prior_update_kernel<S, T, kTail><<<B, kThreads, 0, st>>>(P, ns, period, phase, phase_bytes, ome, e);
  else
    isrbd_al_prior_update_kernel<S, T, kFull><<<B, kThreads, 0, st>>>(P, ns, period, phase, phase_bytes, ome, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7. mode 0 (eval: out h, hT, g, viol), 1 (online: λ, λ_T, viol) or 2
// (offline: the eight multipliers, ρ and viol); `in` and `out` in the
// order of In and Out above (unused slots null); strides: the member
// strides in elements of x_lb, x_ub, u_lb and u_ub (0: one static table).
// The contact topology (nc, cm, n_legs) picks the compiled shape, or the
// call returns kUnknownShape and launches nothing.
#define CONSTRAINTS_ENTRY(NAME, T)                                            \
  extern "C" int NAME(int mode, const void* const* in, void* const* out,      \
                      const long long* strides, int B, int ns, int nc,        \
                      int cm, int n_legs, const double* scalars,              \
                      void* stream) {                                         \
    return isrbd::with_topology(nc, cm, n_legs, [&](auto s) {                 \
      return launch_constraints<decltype(s), T>(mode, in, out, strides, B,    \
                                                ns, scalars, stream);         \
    });                                                                       \
  }

CONSTRAINTS_ENTRY(isrbd_al_constraints_f32, float)
CONSTRAINTS_ENTRY(isrbd_al_constraints_f64, double)

// K7's occupancy for the shape at index `shape` (kernels/isrbd_linearize.py::
// KERNEL_SHAPES), a mode (0-2) and float32 (f64 = 0) or float64, at ns
// stage nodes: out[0..4] as constraints_occupancy_mode fills them.
extern "C" int isrbd_al_constraints_occupancy(int shape, int mode, int f64,
                                              int ns, int* out) {
  return isrbd::with_shape(shape, [&](auto s) {
    using S = decltype(s);
    return f64 ? constraints_occupancy<S, double>(mode, ns, out)
               : constraints_occupancy<S, float>(mode, ns, out);
  });
}

// K8a's occupancy for the shape at index `shape`, a prior (0-2) and
// float32 (f64 = 0) or float64, and K8b's: out[0..4] as K7's.
extern "C" int isrbd_al_shift_occupancy(int shape, int prior, int f64, int* out) {
  return isrbd::with_shape(shape, [&](auto s) {
    using S = decltype(s);
    return f64 ? shift_occupancy<S, double>(prior, out)
               : shift_occupancy<S, float>(prior, out);
  });
}

extern "C" int isrbd_al_params_occupancy(int shape, int f64, int* out) {
  return isrbd::with_shape(shape, [&](auto s) {
    using S = decltype(s);
    return f64 ? k8_occupancy(isrbd_al_params_kernel<S, double>, kParamsThreads, out)
               : k8_occupancy(isrbd_al_params_kernel<S, float>, kParamsThreads, out);
  });
}

// K8a-c take the index of their shape in kernels/isrbd_linearize.py::
// KERNEL_SHAPES first (kUnknownShape for another index).
//
// K8a. prior 0 (none), 1 (tail) or 2 (full); `in` in the order of ShiftIn,
// `out` its first ten (λ_T null without a prior); phase (B,) int32 or
// int64 (phase_bytes 4 or 8).
#define SHIFT_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(int shape, int prior, const void* const* in,            \
                      const void* seen, const void* seen_T, void* const* out, \
                      int B, int ns, int period, const void* phase,           \
                      int phase_bytes, void* stream) {                        \
    return isrbd::with_shape(shape, [&](auto s) {                             \
      return launch_shift<decltype(s), T>(prior, in, seen, seen_T, out, B,    \
                                          ns, period, phase, phase_bytes,     \
                                          stream);                            \
    });                                                                       \
  }

SHIFT_ENTRY(isrbd_al_shift_f32, float)
SHIFT_ENTRY(isrbd_al_shift_f64, double)

// K8b. `in` and `out` in the order of ParamsIn (u_lb, u_ub null where the
// params do not override them).
#define PARAMS_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(int shape, const void* const* in, void* const* out,     \
                      int B, int ns, void* stream) {                          \
    return isrbd::with_shape(shape, [&](auto s) {                             \
      return launch_params<decltype(s), T>(in, out, B, ns, stream);           \
    });                                                                       \
  }

PARAMS_ENTRY(isrbd_al_params_f32, float)
PARAMS_ENTRY(isrbd_al_params_f64, double)

// K8c. prior 1 (tail) or 2 (full); in: λ, λ_T, the stage and terminal
// tables; out: the new tables; seen flags (seen_T and seen_T_out null for
// the full prior).
#define PRIOR_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(int shape, int prior, const void* const* in,            \
                      const void* seen, const void* seen_T, void* const* out, \
                      void* seen_out, void* seen_T_out, int B, int ns,        \
                      int period, const void* phase, int phase_bytes,         \
                      double ema, void* stream) {                             \
    return isrbd::with_shape(shape, [&](auto s) {                             \
      return launch_prior_update<decltype(s), T>(                             \
          prior, in, seen, seen_T, out, seen_out, seen_T_out, B, ns, period,  \
          phase, phase_bytes, ema, stream);                                   \
    });                                                                       \
  }

PRIOR_ENTRY(isrbd_al_prior_update_f32, float)
PRIOR_ENTRY(isrbd_al_prior_update_f64, double)
