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
// an entry, 0.3-3 µs at 3.35 TB/s: the launch, not the work, is their
// floor. Design: one block of eight warps a member, threads on
// neighbouring elements of each member's contiguous run (coalesced); K7
// stages the member's x, u and the four outer parameters it reads into a
// record a node in shared memory with cp.async (cp_async_rows,
// csrc/dmma.cuh), forms every stage node's R I Rᵀ and Iw ω on one warp (a
// node a lane) while the other warps take the cone and box rows, then the
// equality rows, and reduces the violation over the block. Compiled for
// the shapes of csrc/isrbd_common.cuh only (`AL<S>` holds K7's constants
// at each); the prior tables' period P and ns are run-time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "isrbd_common.cuh"
#include "dmma.cuh"

namespace {

using rigid::nan_max;
using isrbd::relu_nan;
using isrbd::kUnknownShape;

constexpr int kThreads = 256;        // a member a block
constexpr int kWarps = kThreads / 32;

// Each product and sum rounded on its own, as separate torch ops round
// them (nvcc would otherwise contract a·b + c into one fused multiply-add).
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// a₀b₀ + a₁b₁ + a₂b₂ (entries sa and sb apart) as the twin's torch.matmul
// forms its three-term sums on the card (a cuBLAS product): a₀b₀, then
// fused multiply-adds in order of k.
template <typename T>
__device__ __forceinline__ T dot3(const T* a, int sa, const T* b, int sb) {
  return fma_rn(a[2 * sa], b[2 * sb], fma_rn(a[sa], b[sb], mul_rn(a[0], b[0])));
}

// (1 − e)·a + e·b with `ome` = 1 − e formed on the host, as the twin forms
// the Python scalar.
template <typename T>
__device__ __forceinline__ T blend(T ome, T e, T a, T b) {
  return add_rn(mul_rn(ome, a), mul_rn(e, b));
}

// Entry `b` of an int32 or int64 phase vector, taken modulo P onto 0 … P−1
// (a floor modulo, as torch indexes a table with a negative index and as
// Python's % takes the tail prior's phase − 1).
__device__ __forceinline__ int phase_at(const void* phase, int bytes, size_t b,
                                        int shift, int P) {
  const long long v = (bytes == 8 ? static_cast<const long long*>(phase)[b]
                                  : static_cast<const int*>(phase)[b]) + shift;
  const long long r = v % P;
  return static_cast<int>(r < 0 ? r + P : r);
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
  const T* in[kIns];
  T* out[kOuts];
  long long stride[4];               // x_lb, x_ub, u_lb, u_ub: member strides
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

  // One node's record in shared memory: x and u side by side, then the
  // slots of the packed parameter row (isrbd::Layout) up to the LIP-zone
  // mask, of which K7 fills c_ref and the three model masks, the only
  // parameters the equality rows read.
  struct Rec {
    static constexpr int xu = 0, p = L::n_xu, size = p + L::p_mzone + 1;
  };
  static constexpr int kGeo = 12;             // a stage node's Iw (9) and Iw ω (3)

  template <typename T>
  static size_t constraints_smem_bytes(int ns) {
    return sizeof(T) * ((ns + 1) * Rec::size + ns * kGeo + kWarps);
  }

  // The node's world inertia Iw = (R I) Rᵀ and Iw ω as the twin forms them
  // (models/srbd.py::world_inertia and srbd_residual: matrix products).
  template <typename T>
  __device__ static __forceinline__ void node_inertia(const T* x, const isrbd::Consts<S, T>& k,
                                               T* out) {
    T R[9], RI[9];
    rigid::quat_to_rot(x + 3, R);
  #pragma unroll
    for (int i = 0; i < 3; ++i)
  #pragma unroll
      for (int j = 0; j < 3; ++j) RI[i * 3 + j] = dot3(R + i * 3, 1, k.I + j, 3);
  #pragma unroll
    for (int i = 0; i < 3; ++i)
  #pragma unroll
      for (int j = 0; j < 3; ++j) out[i * 3 + j] = dot3(RI + i * 3, 1, R + j * 3, 1);
  #pragma unroll
    for (int i = 0; i < 3; ++i) out[9 + i] = dot3(out + i * 3, 1, x + L::i_w, 1);
  }

  // Unscaled equality h_q of the stage stack: isrbd::stage_eq_h, but the
  // Euler rows Iw ω̇ + ω×Iw ω − Σ(c−r)×f with their products formed as the
  // twin forms them (dot3), from the node's Iw and Iw ω in `gs`.
  template <typename T>
  __device__ static __forceinline__ T eq_row(int q, const T* xu, const T* p,
                                             const T* gs,
                                             const isrbd::Consts<S, T>& k) {
    if (q < L::q_euler || q >= L::q_lip) {
      const isrbd::Geometry<T> none{};                 // read by the Euler rows only
      return isrbd::stage_eq_h(q, xu, p, none, k);
    }
    const int a = q - L::q_euler, a1 = (a + 1) % 3, a2 = (a + 2) % 3;
    const T* r = xu;
    const T* w = xu + L::i_w;
    const T* u = xu + nx;
    const T Iwd = dot3(gs + 3 * a, 1, u + 3, 1);
    const T wxh = w[a1] * gs[9 + a2] - w[a2] * gs[9 + a1];
    T tau = T(0);
  #pragma unroll
    for (int c = 0; c < nc; ++c) {
      const T* cc = xu + L::i_c + 3 * c;
      const T* f = u + isrbd::col_f(c, 0);
      tau += (cc[a1] - r[a1]) * f[a2] - (cc[a2] - r[a2]) * f[a1];
    }
    return p[L::p_msrbd] * ((Iwd + wxh) - tau);
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
__global__ void __launch_bounds__(kThreads)
isrbd_al_constraints_kernel(const Ptrs<T> P, int ns,
                            const __grid_constant__ typename AL<S>::template AlConsts<T> c) {
  using C = AL<S>;
  using L = typename C::L;
  using Rec = typename C::Rec;
  constexpr int nx = C::nx, nu = C::nu, nc = C::nc, n_eq = C::n_eq,
                n_eq_T = C::n_eq_T, n_in = C::n_in, kGeo = C::kGeo;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int ns1 = ns + 1;
  T* geo = s + ns1 * Rec::size;
  T* red = geo + ns * kGeo;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t b = blockIdx.x;
  const isrbd::Consts<S, T>& k = c.k;
  constexpr bool kOff = kMode == kOffline;

  // stage the member's nodes: x, u, c_ref and the masks
  cp_async_rows<T, nx, kThreads>(s + Rec::xu, Rec::size,
                                 P.in[I_X] + b * ns1 * nx, 0, ns1, tid);
  cp_async_rows<T, nu, kThreads>(s + Rec::xu + nx, Rec::size,
                                 P.in[I_U] + b * ns * nu, 0, ns, tid);
  cp_async_rows<T, nc, kThreads>(s + Rec::p + L::p_cref, Rec::size,
                                 P.in[I_CREF] + b * ns1 * nc, 0, ns1, tid);
  cp_async_rows<T, 1, kThreads>(s + Rec::p + L::p_msrbd, Rec::size,
                                P.in[I_MSRBD] + b * ns1, 0, ns1, tid);
  cp_async_rows<T, 1, kThreads>(s + Rec::p + L::p_mlip, Rec::size,
                                P.in[I_MLIP] + b * ns1, 0, ns1, tid);
  cp_async_rows<T, 1, kThreads>(s + Rec::p + L::p_mzone, Rec::size,
                                P.in[I_MZONE] + b * ns1, 0, ns1, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const T rho = kMode == kEval ? T(0) : P.in[I_RHO][b];
  T vmax = T(0);

  // warp 0: every stage node's world inertia and Iw ω, a node a lane
  if (warp == 0)
    for (int n = lane; n < ns; n += 32)
      C::node_inertia(s + n * Rec::size + Rec::xu, k, geo + n * kGeo);

  // the cones: g = A_fc f ≤ 0 (bounded above by 0 only)
  for (int i = tid; i < ns * n_in; i += kThreads) {
    const int n = i / n_in, j = i - n * n_in;
    const T* f = s + n * Rec::size + Rec::xu + nx + isrbd::col_f(j / 5, 0);
    const T g = dot3(f, 1, k.A_fc + 3 * (j % 5), 1);
    vmax = nan_max(vmax, relu_nan(g));
    const size_t o = b * ns * n_in + i;
    if (kMode == kEval) P.out[O_G][o] = g;
    if (kOff) {
      P.out[O_MUUB][o] = relu_nan(add_rn(P.in[I_MUUB][o], mul_rn(rho, g)));
      P.out[O_MULB][o] = T(0);
    }
  }
  // the x boxes, every node
  {
    const T* lb = P.in[I_XLB] + b * P.stride[0];
    const T* ub = P.in[I_XUB] + b * P.stride[1];
    for (int i = tid; i < ns1 * nx; i += kThreads) {
      const int n = i / nx;
      const T v = s[n * Rec::size + Rec::xu + (i - n * nx)];
      const T l = lb[i], u = ub[i];
      vmax = nan_max(vmax, box_violation(v, l, u));
      if (kOff) {
        const size_t o = b * ns1 * nx + i;
        P.out[O_MUXUB][o] = side(P.in[I_MUXUB][o], rho, v - u, u);
        P.out[O_MUXLB][o] = side(P.in[I_MUXLB][o], rho, l - v, l);
      }
    }
  }
  // the u boxes, the stage nodes
  {
    const T* lb = P.in[I_ULB] + b * P.stride[2];
    const T* ub = P.in[I_UUB] + b * P.stride[3];
    for (int i = tid; i < ns * nu; i += kThreads) {
      const int n = i / nu;
      const T v = s[n * Rec::size + Rec::xu + nx + (i - n * nu)];
      const T l = lb[i], u = ub[i];
      vmax = nan_max(vmax, box_violation(v, l, u));
      if (kOff) {
        const size_t o = b * ns * nu + i;
        P.out[O_MUUUB][o] = side(P.in[I_MUUUB][o], rho, v - u, u);
        P.out[O_MUULB][o] = side(P.in[I_MUULB][o], rho, l - v, l);
      }
    }
  }
  __syncthreads();                                   // the geometry is in

  // the stage equalities h = S·h_raw, and λ + (ρw)·h
  for (int i = tid; i < ns * n_eq; i += kThreads) {
    const int n = i / n_eq, q = i - n * n_eq;
    const T* rec = s + n * Rec::size;
    const T h = k.S[q] * C::eq_row(q, rec + Rec::xu, rec + Rec::p, geo + n * kGeo, k);
    vmax = nan_max(vmax, isrbd::abs_nan(h));
    const size_t o = b * ns * n_eq + i;
    if (kMode == kEval)
      P.out[O_H][o] = h;
    else
      P.out[O_LAM][o] = add_rn(P.in[I_LAM][o], mul_rn(mul_rn(rho, c.w[q]), h));
  }
  // the terminal equalities hT = S_T·h_raw,T, and λ_T + (ρw_T)·hT
  if (tid < n_eq_T) {
    const int q = tid;
    const T* rec = s + ns * Rec::size;
    const T h = k.S_T[q] * isrbd::terminal_eq_h(q, rec + Rec::xu, rec + Rec::p, k);
    vmax = nan_max(vmax, isrbd::abs_nan(h));
    const size_t o = b * n_eq_T + q;
    if (kMode == kEval)
      P.out[O_HT][o] = h;
    else
      P.out[O_LAMT][o] = add_rn(P.in[I_LAMT][o], mul_rn(mul_rn(rho, c.w_T[q]), h));
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
        const T prev = P.in[I_VIOLP][b];
        T grown = rho * c.rho_growth;
        grown = grown > c.rho_max ? c.rho_max : grown;   // a NaN stays
        const bool grow = v > c.viol_decrease * prev && v > c.tol;
        P.out[O_RHO][b] = grow ? grown : rho;
      }
    }
  }
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

template <typename T>
struct ShiftPtrs {
  const T* in[kShiftIns];
  const bool* seen;                  // tail: seen_tail; full: seen
  const bool* seen_T;                // tail: seen_T; full: seen
  T* out[kShiftOuts];
};

// Node n ← node n + 1 of an (N, kDim) run, the last node repeated.
template <typename T, int kDim>
__device__ __forceinline__ void roll(T* __restrict__ out,
                                     const T* __restrict__ in, int N, int tid) {
  for (int i = tid; i < N * kDim; i += kThreads) {
    const int n = i / kDim;
    out[i] = n + 1 < N ? in[i + kDim] : in[i];
  }
}

template <class S, typename T, int kPrior>
__global__ void __launch_bounds__(kThreads)
isrbd_al_shift_kernel(const ShiftPtrs<T> P, int ns, int period,
                      const void* phase, int phase_bytes) {
  constexpr int nx = S::nx, nu = S::nu, n_eq = S::n_eq, n_eq_T = S::n_eq_T,
                n_in = S::n_in;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int ns1 = ns + 1;
  roll<T, nx>(P.out[S_X] + b * ns1 * nx, P.in[S_X] + b * ns1 * nx, ns1, tid);
  roll<T, nu>(P.out[S_U] + b * ns * nu, P.in[S_U] + b * ns * nu, ns, tid);
  roll<T, n_in>(P.out[S_MUUB] + b * ns * n_in, P.in[S_MUUB] + b * ns * n_in, ns, tid);
  roll<T, n_in>(P.out[S_MULB] + b * ns * n_in, P.in[S_MULB] + b * ns * n_in, ns, tid);
  roll<T, nx>(P.out[S_MUXUB] + b * ns1 * nx, P.in[S_MUXUB] + b * ns1 * nx, ns1, tid);
  roll<T, nx>(P.out[S_MUXLB] + b * ns1 * nx, P.in[S_MUXLB] + b * ns1 * nx, ns1, tid);
  roll<T, nu>(P.out[S_MUUUB] + b * ns * nu, P.in[S_MUUUB] + b * ns * nu, ns, tid);
  roll<T, nu>(P.out[S_MUULB] + b * ns * nu, P.in[S_MUULB] + b * ns * nu, ns, tid);

  const T* lam = P.in[S_LAM] + b * ns * n_eq;
  T* lam_out = P.out[S_LAM] + b * ns * n_eq;
  if (kPrior == kNone) {
    roll<T, n_eq>(lam_out, lam, ns, tid);
    return;
  }
  // the terminal write's phase, and the stage tail row's (one tick older)
  const int ph = phase_at(phase, phase_bytes, b, 0, period);
  const size_t row = b * period + ph;
  const bool seed_T = P.seen_T[row];
  if (kPrior == kFull) {
    const T* tab = P.in[S_TAB] + row * ns * n_eq;
    for (int i = tid; i < ns * n_eq; i += kThreads) {
      const int n = i / n_eq;
      lam_out[i] = seed_T ? tab[i] : (n + 1 < ns ? lam[i + n_eq] : lam[i]);
    }
  } else {
    const int tph = phase_at(phase, phase_bytes, b, -1, period);
    const size_t trow = b * period + tph;
    const bool seed_tail = P.seen[trow];
    const T* tab = P.in[S_TAB] + trow * n_eq;
    for (int i = tid; i < ns * n_eq; i += kThreads) {
      const int n = i / n_eq;
      lam_out[i] = n + 1 < ns ? lam[i + n_eq]
                              : (seed_tail ? tab[i - n * n_eq] : lam[i]);
    }
  }
  if (tid < n_eq_T) {
    const T* tabT = P.in[S_TABT] + row * n_eq_T;
    P.out[S_LAMT][b * n_eq_T + tid] =
        seed_T ? tabT[tid] : P.in[S_LAMT][b * n_eq_T + tid];
  }
}

// ---- K8b: isrbd_al_params ----

enum ParamsIn { A_LAM, A_LAMT, A_MUUB, A_MULB, A_RHO, A_MUUUB, A_MUULB, A_ULB, A_UUB, kParamsIO };

template <typename T>
struct ParamsPtrs {
  const T* in[kParamsIO];            // u_lb, u_ub: the params' (B, ns, nu) or null
  T* out[kParamsIO];                 // each (B, ns+1, dim); al_rho (B, ns+1, 1)
};

// An (ns, kDim) run padded to ns + 1 nodes with `pad` on the last.
template <typename T, int kDim>
__device__ __forceinline__ void pad_node(T* __restrict__ out,
                                         const T* __restrict__ in, int ns,
                                         T pad, int tid) {
  for (int i = tid; i < (ns + 1) * kDim; i += kThreads)
    out[i] = i < ns * kDim ? in[i] : pad;
}

template <class S, typename T>
__global__ void __launch_bounds__(kThreads)
isrbd_al_params_kernel(const ParamsPtrs<T> P, int ns) {
  constexpr int nu = S::nu, n_eq = S::n_eq, n_eq_T = S::n_eq_T, n_in = S::n_in;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int ns1 = ns + 1;
  const T inf = T(INFINITY);
  pad_node<T, n_eq>(P.out[A_LAM] + b * ns1 * n_eq, P.in[A_LAM] + b * ns * n_eq, ns, T(0), tid);
  pad_node<T, n_in>(P.out[A_MUUB] + b * ns1 * n_in, P.in[A_MUUB] + b * ns * n_in, ns, T(0), tid);
  pad_node<T, n_in>(P.out[A_MULB] + b * ns1 * n_in, P.in[A_MULB] + b * ns * n_in, ns, T(0), tid);
  pad_node<T, nu>(P.out[A_MUUUB] + b * ns1 * nu, P.in[A_MUUUB] + b * ns * nu, ns, T(0), tid);
  pad_node<T, nu>(P.out[A_MUULB] + b * ns1 * nu, P.in[A_MUULB] + b * ns * nu, ns, T(0), tid);
  if (P.in[A_ULB] != nullptr)
    pad_node<T, nu>(P.out[A_ULB] + b * ns1 * nu, P.in[A_ULB] + b * ns * nu, ns, -inf, tid);
  if (P.in[A_UUB] != nullptr)
    pad_node<T, nu>(P.out[A_UUB] + b * ns1 * nu, P.in[A_UUB] + b * ns * nu, ns, inf, tid);
  const T* lamT = P.in[A_LAMT] + b * n_eq_T;
  T* tiled = P.out[A_LAMT] + b * ns1 * n_eq_T;
  for (int i = tid; i < ns1 * n_eq_T; i += kThreads) tiled[i] = lamT[i % n_eq_T];
  if (tid < ns1) P.out[A_RHO][b * ns1 + tid] = P.in[A_RHO][b];
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

template <class S, typename T, int kMode>
int launch_constraints_mode(const Ptrs<T>& P, int B, int ns,
                            const typename AL<S>::template AlConsts<T>& c,
                            cudaStream_t stream) {
  const size_t bytes = AL<S>::template constraints_smem_bytes<T>(ns);
  auto kernel = isrbd_al_constraints_kernel<S, T, kMode>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, kThreads, bytes, stream>>>(P, ns, c);
  return static_cast<int>(cudaGetLastError());
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
    isrbd_al_shift_kernel<S, T, kNone><<<B, kThreads, 0, st>>>(P, ns, period, phase, phase_bytes);
  else if (prior == kTail)
    isrbd_al_shift_kernel<S, T, kTail><<<B, kThreads, 0, st>>>(P, ns, period, phase, phase_bytes);
  else
    isrbd_al_shift_kernel<S, T, kFull><<<B, kThreads, 0, st>>>(P, ns, period, phase, phase_bytes);
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
  isrbd_al_params_kernel<S, T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P, ns);
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
