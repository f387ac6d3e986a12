// K5 — the sliced linearization of the batched MS-DDP solver on the isrbd
// AL inner problem, in closed form, every member-node and the terminal
// node in one launch.
//
// Replaces: `MSDDP._linearize_sliced` (srbd_horizon_tpu/solvers/msddp.py:
// 273-344) on the AL inner OCP (srbd_horizon_tpu/solvers/alddp.py:215-256):
// `jax.jacfwd` of the RK2 step and of the 240-row inner stage stack over
// the declared row slices under `vmap`, which XLA fused on the TPU (the
// JAX package wrote no Pallas kernel for it). Plain twin:
// `kernels/isrbd_linearize.py::isrbd_linearize_plain`. Per member-node:
//     Sx  = (A − I)[rx]          A = I + dt·F(x_mid)·(I + dt/2·F(x))
//     Bs  = B[ru][:, uc]         B = dt·(G + dt/2·F(x_mid)·G)
//     Jxp = (∂ρ/∂x)[gx]          Jup = (∂ρ/∂u)[gu]
//     ρ   = the inner stage stack        d = rk2(x, u) − X[n+1]
// and per member the terminal rt and Jt = ∂rt/∂x. F = ∂ẋ/∂x of the double
// integrator is nonzero only in the position rows (identity blocks for ṙ
// and ċ, ½Ω(ω) and ½Ξ(o) for ȯ), G = ∂ẋ/∂u is a constant selection, so
// only the quaternion rows of A − I and B carry products. The residual
// rows are weights and selections; an equality row's Jacobian is
// S_j√(ρw_j)·∂h_j, where the Newton–Euler rows need
//     ∂/∂o_j [Iw ω̇ + ω×Iw ω] = ∂Iw_j ω̇ + ω×(∂Iw_j ω),  ∂Iw_j = R_j I Rᵀ + R I R_jᵀ
// with R_j of the homogeneous quat_to_rot (csrc/rigid_common.cuh); a
// one-sided row's is ±√ρ·(its cone face or unit vector) where the row is
// active, and half that where its pre-activation is exactly 0 (the value
// jax.jacfwd gives jnp.maximum at a tie). The row sets rx, ru, gx, gu, uc
// arrive as the int32 table K1 reads (kernels/riccati.py::RiccatiRows).
//
// Compiled for the shapes of csrc/isrbd_common.cuh only (`KangarooAlShape`,
// `QuadAlShape`; `K5<S>` holds each one's constants): the per-node output
// sizes, the shared-memory layout and every loop bound are constants; the
// contact topology picks the instantiation at launch and the wrapper
// refuses other sizes. The row table stays a run-time input.
//
// What bounds it on an H100: bytes. At the Kangaroo's shape a member-node
// writes 6,956 values (Sx 703, Bs 666, Jxp 2,220, Jup 3,090, ρ 240, d 37)
// and reads ~430 (x, u and the 357 parameter values, most of them
// multipliers and bounds; the quadruped's 6,804 and ~420); most
// outputs are structural zeros that K1 reads dense. At B=256, ns=20 that
// is ~143 MB of f32 out and ~9 MB in, ~0.046 ms at 3.35 TB/s, against a few
// thousand FLOP per member-node. The first design spent instructions, not
// bytes: lane 0 alone prepared the geometry, lanes 0-3 the ∂Iw_j and lanes
// 0-27 the quaternion blocks while the rest waited, then every lane
// evaluated ~217 entries one by one, each with a run-time division, a walk
// down the segment branches of a per-entry function and a 4-byte store;
// it ran at 4.3× the byte bound.
//
// Design, K4's (csrc/srbd_linearize.cu): a block takes 4 consecutive
// stage member-nodes, one warp each. Every per-node output size times 4 is
// a multiple of 4, so in float32 a run of 4 member-nodes that begins at a
// flat index b·ns+n divisible by 4 starts 16-byte aligned in every stage
// output (double2-aligned in float64), and the nodes' blocks of one output
// are contiguous; the block composes them in one shared staging buffer and
// streams them out with 16-byte stores, the whole block on each output.
// Sx and Bs are staged for the 4 nodes at once, Jxp and Jup for 2 at a time
// (2 × 3,090 = 6,180 values is still a multiple of 4), so the buffer holds
// 6,180 values and a block 41,600 B in float32: five blocks share an SM
// (`isrbd_linearize_occupancy`). A staged block is filled with zeros
// (16-byte stores), then each warp writes its node's nonzeros by the row
// kinds the block resolved once from the row table (one entry, two
// entries, quaternion row of A − I or of B, LIP row, Newton row, cone row,
// the dense Euler rows, zero), the sparse rows one lane a row from a
// per-node table of values, the Euler rows one row at a time with the
// lanes over the columns. No entry is found by division. The node's
// prologue runs over all lanes: every lane holds the geometry and the
// quaternion rates in registers (csrc/isrbd_common.cuh, shared with K6);
// the 240 rows go by K6's passes, with the one-sided rows' slopes; lanes
// 0-11 form ∂Iw_j one row each and trade rows by shuffles; lanes 0-27 the
// quaternion blocks; the lanes over the columns the Euler rows. ρ and d
// are staged with the prologue and streamed before the Jacobians. The
// terminal pairs rt, Jt run in blocks of their own, one warp a member,
// ahead of the stage blocks so that they do not trail the last wave: the
// block fills its members' Jt with zeros straight in device memory
// (16-byte stores), then each lane writes the one or two nonzeros of its
// rows. What holds it at ~1.8× the byte bound is the store stream itself,
// not the prologue, the emission, the barriers or the zero fills (variant
// builds timed on an H100; PERF.md §7).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "isrbd_common.cuh"

namespace {

using isrbd::kUnknownShape;
constexpr int kWarps = 4;                // member-nodes (warps) a stage block

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

// The block fills `count` values at `dst` (16-byte aligned) with zeros, 16
// bytes a thread at a time, then the tail one value at a time.
template <typename T>
__device__ void zero_fill(T* dst, int count) {
  using V = typename Vec<T>::type;
  constexpr int per = sizeof(V) / sizeof(T);
  const V z{};
  V* o = reinterpret_cast<V*>(dst);
  const int nvec = count / per;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) o[i] = z;
  for (int i = nvec * per + threadIdx.x; i < count; i += blockDim.x) dst[i] = T(0);
}

// The block streams `count` staged values from shared memory to `dst`
// (16-byte aligned), 16 bytes a thread at a time.
template <typename T>
__device__ void stream_out(const T* src, T* __restrict__ dst, int count) {
  using V = typename Vec<T>::type;
  constexpr int per = sizeof(V) / sizeof(T);
  const int nvec = count / per;
  const V* s = reinterpret_cast<const V*>(src);
  V* o = reinterpret_cast<V*>(dst);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) o[i] = s[i];
  for (int i = nvec * per + threadIdx.x; i < count; i += blockDim.x)
    dst[i] = src[i];
}

// K5 at the shape S: its constants, the row kinds and the device code of
// its blocks (the kernel below runs K5<S>'s pieces).
template <class S>
struct K5 {
  using L = isrbd::Layout<S>;
  template <typename T>
  using Consts = isrbd::Consts<S, T>;
  static constexpr int nx = S::nx, nu = S::nu, nr = S::n_rho,
                       nt = S::n_term, n_uc = S::n_uc;

  // per-node sizes of the four Jacobian blocks, and the member-nodes one
  // staging of each holds (a multiple of 4 values: 16-byte aligned)
  static constexpr int kSx = S::n_rx * nx, kBs = S::n_ru * n_uc,
                kJxp = S::n_gx * nx, kJup = S::n_gu * nu;
  __host__ __device__ static constexpr int per_node(int blk) {
    return blk == 0 ? kSx : blk == 1 ? kBs : blk == 2 ? kJxp : kJup;
  }
  __host__ __device__ static constexpr int group(int blk) { return blk < 2 ? 4 : 2; }
  static constexpr int kStage = cmax(cmax(4 * kSx, 4 * kBs), cmax(2 * kJxp, 2 * kJup));
  // ρ and d of the kWarps nodes, staged with the prologue
  static constexpr int oD = kWarps * nr;
  static_assert((4 * kSx) % 4 == 0 && (4 * kBs) % 4 == 0 &&
                    (2 * kJxp) % 4 == 0 && (2 * kJup) % 4 == 0 &&
                    kStage % 4 == 0 && oD % 4 == 0 && oD + kWarps * nx <= kStage &&
                    kWarps % 2 == 0,
                "16-byte alignment of the staged outputs");

  // The per-node values the sparse rows read (a warp's value table).
  enum Value : int {
    V_DT = 0, V_H2, V_MTWRZ, V_MTWO, V_MTWRDOT, V_MTWW, V_WQDDOT, V_WMINF,
    V_WREL,
    V_EQ,                             // + q: S_q √(ρ w_q), the equality rows
    V_ZONE = V_EQ + S::n_eq,      // + i: that × mask_lipzone (LIP zone)
    V_NEWT = V_ZONE + 4,              // + i: Newton row i: × mask_srbd × m
    V_NEWTF = V_NEWT + 3,             //      and × mask_srbd × (−1)
    V_LIPU = V_NEWTF + 3,             // + i: LIP row i: × mask_lip × m,
    V_LIPX = V_LIPU + 3,              //      × mask_lip × (−m η²)
    V_LIPC = V_LIPX + 3,              //      × mask_lip × m η²/nc (i < 2)
    V_SLOPE = V_LIPC + 2,             // + g − o_cone: slope of one-sided row g
    V_N = V_SLOPE + 2 * S::n_in + L::n_box
  };

  // a warp's scratch: x and u side by side, X[n+1], params, values, the
  // quaternion blocks (Foo·, Fow·, Fow(o_mid)), Iw, Iw ω, o_mid and ω_mid, and
  // the dense Euler rows of Jxp (3 × nx) and Jup (3 × nu)
  static constexpr int wXU = 0, wXN = wXU + L::n_xu, wP = wXN + nx, wV = wP + L::n_par,
                wQ = wV + V_N, wG = wQ + 40, wEX = wG + 20, wEU = wEX + 3 * nx,
                wSize = (wEU + 3 * nu + 3) / 4 * 4;
  static constexpr int qSoo = 0, qSow = 16, qFowm = 28;           // offsets in wQ
  static constexpr int gIw = 0, gH = 9, gOm = 12, gWm = 16;       // offsets in wG
  static constexpr int kRows = S::n_rx + S::n_ru + S::n_gx + S::n_gu;
  static constexpr int oUc = kRows + 2 * S::n_b;              // uc in the row table

  // shared memory: the staging buffer, the warps' scratch (both in T), then
  // the row kinds (2 ints a row) and the dense-row slots (3 a Jacobian block
  // of ρ: Jxp, Jup)
  template <typename T>
  static constexpr size_t smem_bytes() {
    return sizeof(T) * (kStage + kWarps * wSize) + sizeof(int) * (2 * kRows + 6);
  }

  // Row kinds of the four Jacobian blocks (resolved once a block from the
  // row table): info.x = kind | slot << 8 | aux << 20, info.y = a | b << 16
  // (kQuatB: three uc positions, 8 bits each, 0xff where not live).
  enum Kind : int {
    kZero = 0,   // no entry
    kOne,        // val[slot] at column a
    kTwo,        // −val[slot] at column a, +val[slot] at column b
    kQuatS,      // Sx: row aux of dt·(Foo(ω_mid) + dt/2·Foo(ω_mid)Foo(ω)), Fow…
    kQuatB,      // Bs: row aux of dt²/2·Fow(o_mid) on the ω̇ columns
    kLipX,       // Jxp: LIP row aux (r and, for aux < 2, the contacts' c)
    kNewtonU,    // Jup: Newton row aux (r̈ and the nc forces on axis aux)
    kCone,       // Jup: cone ub row aux (three force columns of one contact)
    kDense       // Euler row aux (written by the lanes over the columns)
  };

  __host__ __device__ static int2 kind(int k, int slot = 0, int aux = 0,
                                       int a = 0, int b = 0) {
    return make_int2(k | (slot << 8) | (aux << 20), a | (b << 16));
  }

  // Position of input column `col` among the live B columns uc, or −1.
  __device__ static int uc_pos(const int* __restrict__ table, int col) {
    int pos = -1;
  #pragma unroll
    for (int c = 0; c < n_uc; ++c)
      if (table[oUc + c] == col) pos = c;
    return pos;
  }

  // Row r of block `blk` (0 Sx, 1 Bs, 2 Jxp, 3 Jup).
  template <typename T>
  __device__ static int2 resolve(int blk, int r, const int* __restrict__ table,
                          const Consts<T>& k) {
    using isrbd::col_cddot;
    using isrbd::col_f;
    if (blk == 0) {                                  // (A − I)[r]
      if (r < 3) return kind(kOne, V_DT, 0, L::i_rdot + r);
      if (r < 7) return kind(kQuatS, 0, r - 3);
      if (r < L::i_rdot) return kind(kOne, V_DT, 0, L::i_cdot + r - 7);
      return kind(kZero);
    }
    if (blk == 1) {                                  // B[r][uc]
      if (r >= 3 && r < 7) {
        const int p3 = uc_pos(table, 3), p4 = uc_pos(table, 4), p5 = uc_pos(table, 5);
        return kind(kQuatB, 0, r - 3, (p3 & 0xff) | (p4 & 0xff) << 8 | (p5 & 0xff) << 16);
      }
      const int e = r < L::i_rdot ? r - 7 : r - L::i_cdot;
      const int col = r < 3 ? r : r < L::i_rdot ? col_cddot(e / 3, e % 3)
                    : r < L::i_cdot ? r - L::i_rdot : col_cddot(e / 3, e % 3);
      const int pos = uc_pos(table, col);
      if (pos < 0) return kind(kZero);
      return kind(kOne, r < L::i_rdot ? V_H2 : V_DT, 0, pos);
    }
    if (blk == 2) {                                  // (∂ρ/∂x)[r]
      if (r == 0) return kind(kOne, V_MTWRZ, 0, 2);
      if (r < 5) return kind(kOne, V_MTWO, 0, 2 + r);
      if (r < 8) return kind(kOne, V_MTWRDOT, 0, L::i_rdot + r - 5);
      if (r < 11) return kind(kOne, V_MTWW, 0, L::i_w + r - 8);
      if (r < L::o_rel) return kind(kZero);
      if (r < L::o_minf) {                           // foot pairs
        const int g = r - L::o_rel;
        const int a = k.fpi[g < 2 ? 0 : 1], b = k.fpi[g < 2 ? 2 : 3];
        const int ax = (g % 2 == 0) ? 1 : 0;
        return kind(kTwo, V_WREL, 0, L::i_c + 3 * a + ax, L::i_c + 3 * b + ax);
      }
      if (r < L::n_res) return kind(kZero);
      if (r < L::o_cone) {                           // S_q√(ρw_q)·∂h_q/∂x
        const int q = r - L::n_res;
        if constexpr (L::n_relvel > 0) {             // none on point feet
          if (q < L::q_cz)
            return kind(kTwo, V_EQ + q, 0, isrbd::relvel_col<S>(q, false),
                        isrbd::relvel_col<S>(q, true));
        }
        if (q < L::q_newton) return kind(kOne, V_EQ + q, 0, L::i_c + 3 * (q - L::q_cz) + 2);
        if (q < L::q_euler) return kind(kZero);
        if (q < L::q_lip) return kind(kDense, 0, q - L::q_euler);
        if (q < L::q_zone) return kind(kLipX, 0, q - L::q_lip);
        const int a = q - L::q_zone;
        return kind(kOne, V_ZONE + a, 0, a == 0 ? 2 : L::i_w + a - 1);
      }
      if (r < L::o_xbox || r >= L::o_ubox) return kind(kZero);
      return kind(kOne, V_SLOPE + r - L::o_cone, 0, (r - L::o_xbox) % nx);
    }
    // (∂ρ/∂u)[r]
    if (r < 11) return kind(kZero);
    if (r < L::o_rel) return kind(kOne, V_WQDDOT, 0, isrbd::usel_col<S>(r - 11));
    if (r < L::o_minf) return kind(kZero);
    if (r < L::n_res)
      return kind(kOne, V_WMINF, 0, isrbd::usel_col<S>(L::n_qddot + r - L::o_minf));
    if (r < L::o_cone) {
      const int q = r - L::n_res;
      if (q < L::q_newton) return kind(kZero);
      if (q < L::q_euler) return kind(kNewtonU, 0, q - L::q_newton);
      if (q < L::q_lip) return kind(kDense, 0, q - L::q_euler);
      if (q < L::q_zone) return kind(kOne, V_LIPU + q - L::q_lip, 0, q - L::q_lip);
      return kind(kZero);
    }
    if (r < L::o_cone + S::n_in) return kind(kCone, 0, r - L::o_cone);
    if (r < L::o_ubox) return kind(kZero);
    return kind(kOne, V_SLOPE + r - L::o_cone, 0, (r - L::o_ubox) % nu);
  }

  // The prologue of one stage member-node, by its warp (x, u, X[n+1] and the
  // parameters are in its scratch `sw`): ρ and d into the block's staging
  // buffer (at `slot`), and the values, quaternion blocks and Euler rows the
  // Jacobian rows read into `sw`.
  template <typename T>
  __device__ static void prologue(T* sw, T* stg, int slot, const Consts<T>& k, int lane) {
    using isrbd::col_f;
    const T* x = sw + wXU;
    const T* u = x + nx;
    const T* p = sw + wP;
    T* val = sw + wV;
    T* Q = sw + wQ;
    T* G = sw + wG;
    const T hdt = T(0.5) * k.dt;
    const isrbd::Geometry<T> geo = isrbd::geometry(x, k);
    const isrbd::Rates<T> rt = isrbd::rates<S>(x, hdt);
    if (lane == 0) {                         // for the lanes that index them
  #pragma unroll
      for (int i = 0; i < 9; ++i) G[gIw + i] = geo.Iw[i];
  #pragma unroll
      for (int i = 0; i < 3; ++i) G[gH + i] = geo.h[i];
  #pragma unroll
      for (int i = 0; i < 4; ++i) G[gOm + i] = rt.om[i];
  #pragma unroll
      for (int i = 0; i < 3; ++i) G[gWm + i] = rt.wm[i];
    }
    T* orho = stg + slot * nr;
    isrbd::stage_rows<true>(lane, x, p, geo, k, [&](int r, T v) { orho[r] = v; },
                            [&](int i, T s) { val[V_SLOPE + i] = s; });
    T* od = stg + oD + slot * nx;
    const T* xn = sw + wXN;
  #pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < nx) od[j] = isrbd::step_row<S>(j, x, rt, hdt, k.dt) - xn[j];
    }
    const T sr = sqrt(p[L::p_rho]);
    const T mt = p[L::p_mt];
    // the values: the scalars, the equality rows' scales, then the masked
    // scales of the LIP-zone, Newton and LIP rows
    auto eq_scale = [&](int q) { return (sr * k.sqw[q]) * k.S[q]; };
    if (lane < V_EQ) {
      const T v = lane == V_DT ? k.dt : lane == V_H2 ? k.dt * hdt
                : lane == V_MTWRZ ? mt * k.w_rz : lane == V_MTWO ? mt * p[L::p_wo]
                : lane == V_MTWRDOT ? mt * k.w_rdot : lane == V_MTWW ? mt * k.w_w
                : lane == V_WQDDOT ? k.w_qddot : lane == V_WMINF ? k.w_minf : k.w_rel;
      val[lane] = v;
    } else if (lane < V_EQ + S::n_eq) {
      val[lane] = eq_scale(lane - V_EQ);
    }
    if (lane < 4) {
      val[V_ZONE + lane] = eq_scale(L::q_zone + lane) * p[L::p_mzone];
    } else if (lane < 7) {
      const int i = lane - 4;
      const T s = eq_scale(L::q_newton + i) * p[L::p_msrbd];
      val[V_NEWT + i] = s * k.m;
      val[V_NEWTF + i] = s * T(-1);
    } else if (lane < 12) {
      const int i = lane < 10 ? lane - 7 : lane - 10;
      const T s = eq_scale(L::q_lip + i) * p[L::p_mlip];
      if (lane < 10) {
        val[V_LIPU + i] = s * k.m;
        val[V_LIPX + i] = s * (-(k.m * k.eta2));
      } else {
        val[V_LIPC + i] = s * (k.m * k.eta2 / T(L::nc));
      }
    }
    __syncwarp();                                    // G for every lane
    {   // the quaternion blocks of A − I and B
      const T* w = x + L::i_w;
      const T* o = x + 3;
      const T* wmid = G + gWm;
      const T* omid = G + gOm;
      if (lane < 16) {
        const int i = lane / 4, j = lane % 4;
        T s = T(0);
  #pragma unroll
        for (int l = 0; l < 4; ++l)
          s += isrbd::quat_rate_jac_o(i, l, wmid) * isrbd::quat_rate_jac_o(l, j, w);
        Q[qSoo + lane] = isrbd::quat_rate_jac_o(i, j, wmid) + hdt * s;
      } else if (lane < 28) {
        const int e = lane - 16, i = e / 3, j = e % 3;
        T s = T(0);
  #pragma unroll
        for (int l = 0; l < 4; ++l)
          s += isrbd::quat_rate_jac_o(i, l, wmid) * isrbd::quat_rate_jac_w(l, j, o);
        const T fm = isrbd::quat_rate_jac_w(i, j, omid);
        Q[qFowm + e] = fm;
        Q[qSow + e] = fm + hdt * s;
      }
    }
    // the Euler rows, row a scaled by sm_a = S_q√(ρw_q)·mask_srbd
    T sm[3];
  #pragma unroll
    for (int a = 0; a < 3; ++a) sm[a] = eq_scale(L::q_euler + a) * p[L::p_msrbd];
    T* EX = sw + wEX;
    T* EU = sw + wEU;
    const T* w = x + L::i_w;
    {   // the o columns: column 3 + j on lanes 3j .. 3j+2, row a of ∂Iw_j each
      const int j = lane / 3 < 4 ? lane / 3 : 3, a = lane % 3;
      const int base = 3 * j;
      T D[9];
      isrbd::drot(j, x + 3, D);
      const T Da0 = a == 0 ? D[0] : a == 1 ? D[3] : D[6];
      const T Da1 = a == 0 ? D[1] : a == 1 ? D[4] : D[7];
      const T Da2 = a == 0 ? D[2] : a == 1 ? D[5] : D[8];
      const T RIa0 = a == 0 ? geo.RI[0] : a == 1 ? geo.RI[3] : geo.RI[6];
      const T RIa1 = a == 0 ? geo.RI[1] : a == 1 ? geo.RI[4] : geo.RI[7];
      const T RIa2 = a == 0 ? geo.RI[2] : a == 1 ? geo.RI[5] : geo.RI[8];
      T P[3];
  #pragma unroll
      for (int l = 0; l < 3; ++l) P[l] = (Da0 * k.I[l] + Da1 * k.I[3 + l]) + Da2 * k.I[6 + l];
      T dI[3];
  #pragma unroll
      for (int c = 0; c < 3; ++c)
        dI[c] = ((P[0] * geo.R[c * 3] + P[1] * geo.R[c * 3 + 1]) + P[2] * geo.R[c * 3 + 2]) +
                ((RIa0 * D[c * 3] + RIa1 * D[c * 3 + 1]) + RIa2 * D[c * 3 + 2]);
      const T* wd = u + 3;
      const T v1 = dI[0] * wd[0] + dI[1] * wd[1] + dI[2] * wd[2];
      const T v2 = dI[0] * w[0] + dI[1] * w[1] + dI[2] * w[2];
      const T q0 = __shfl_sync(0xffffffffu, v2, base);
      const T q1 = __shfl_sync(0xffffffffu, v2, base + 1);
      const T q2 = __shfl_sync(0xffffffffu, v2, base + 2);
      const T cr = a == 0 ? w[1] * q2 - w[2] * q1
                   : a == 1 ? w[2] * q0 - w[0] * q2
                            : w[0] * q1 - w[1] * q0;
      const T sa = a == 0 ? sm[0] : a == 1 ? sm[1] : sm[2];
      if (lane < 12) EX[a * nx + 3 + j] = sa * (v1 + cr);
    }
    // the other columns of the Euler rows, one column a lane
    T fsum[3] = {T(0), T(0), T(0)};
  #pragma unroll
    for (int c = 0; c < L::nc; ++c)
  #pragma unroll
      for (int i = 0; i < 3; ++i) fsum[i] += u[col_f(c, i)];
  #pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = lane + 32 * c;
      if (col >= nx || (col >= 3 && col < 7)) continue;
      T m[3] = {T(0), T(0), T(0)};
      bool live = true;                              // structurally nonzero
      if (col < 3) {                                 // r: −[Σf]ₓ
        isrbd::skew_col(fsum, col, m);
  #pragma unroll
        for (int a = 0; a < 3; ++a) m[a] = -m[a];
      } else if (col < L::i_rdot) {                  // c_q: [f_q]ₓ
        const int q = (col - 7) / 3, jj = (col - 7) % 3;
        isrbd::skew_col(u + col_f(q, 0), jj, m);
      } else if (col >= L::i_w && col < L::i_cdot) { // ω: [ω]ₓ Iw − [Iw ω]ₓ
        const int jj = col - L::i_w;
        T s0[3], s1[3], s2[3], hh[3];
        isrbd::skew_col(w, 0, s0);
        isrbd::skew_col(w, 1, s1);
        isrbd::skew_col(w, 2, s2);
        isrbd::skew_col(G + gH, jj, hh);
  #pragma unroll
        for (int a = 0; a < 3; ++a)
          m[a] = ((s0[a] * G[gIw + jj] + s1[a] * G[gIw + 3 + jj]) + s2[a] * G[gIw + 6 + jj]) - hh[a];
      } else {
        live = false;
      }
  #pragma unroll
      for (int a = 0; a < 3; ++a) EX[a * nx + col] = live ? sm[a] * m[a] : T(0);
    }
    if (lane < nu) {
      const int col = lane;
      T m[3] = {T(0), T(0), T(0)};
      bool live = true;
      if (col >= 3 && col < 6) {                     // ω̇: Iw
  #pragma unroll
        for (int a = 0; a < 3; ++a) m[a] = G[gIw + a * 3 + col - 3];
      } else if (col >= 6 && (col - 6) % 6 >= 3) {   // f_q: −[c_q − r]ₓ
        const int q = (col - 6) / 6, fj = (col - 6) % 6 - 3;
        const T* cq = x + L::i_c + 3 * q;
        const T cr[3] = {cq[0] - x[0], cq[1] - x[1], cq[2] - x[2]};
        isrbd::skew_col(cr, fj, m);
  #pragma unroll
        for (int a = 0; a < 3; ++a) m[a] = -m[a];
      } else {
        live = false;
      }
  #pragma unroll
      for (int a = 0; a < 3; ++a) EU[a * nu + col] = live ? sm[a] * m[a] : T(0);
    }
  }

  // Lane `lane` writes the nonzeros of the sparse rows lane, lane+32, … of
  // one node's block `dst` (rows of `width` entries, zero-filled before);
  // the dense Euler rows follow, one row at a time over the lanes.
  template <typename T>
  __device__ static void emit_block(int blk, const T* sw, const int* info,
                             const int* dslot, const Consts<T>& k, int lane,
                             T* dst) {
    using isrbd::col_f;
    const T* val = sw + wV;
    const T* Q = sw + wQ;
    const int first = blk == 0 ? 0
                      : blk == 1 ? S::n_rx
                      : blk == 2 ? S::n_rx + S::n_ru
                                 : S::n_rx + S::n_ru + S::n_gx;
    const int rows = blk == 0 ? S::n_rx : blk == 1 ? S::n_ru
                     : blk == 2 ? S::n_gx : S::n_gu;
    const int width = blk == 1 ? n_uc : blk == 3 ? nu : nx;
    for (int i = lane; i < rows; i += 32) {
      const int i0 = info[2 * (first + i)], i1 = info[2 * (first + i) + 1];
      const int kd = i0 & 0xff, v = (i0 >> 8) & 0xfff, aux = i0 >> 20;
      const int a = i1 & 0xffff, b = i1 >> 16;
      T* row = dst + i * width;
      switch (kd) {
        case kOne:
          row[a] = val[v];
          break;
        case kTwo:
          row[a] = -val[v];
          row[b] = val[v];
          break;
        case kQuatS:
  #pragma unroll
          for (int j = 0; j < 4; ++j) row[3 + j] = k.dt * Q[qSoo + aux * 4 + j];
  #pragma unroll
          for (int j = 0; j < 3; ++j) row[L::i_w + j] = k.dt * Q[qSow + aux * 3 + j];
          break;
        case kQuatB:
  #pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int pos = (i1 >> (8 * j)) & 0xff;
            if (pos != 0xff) row[pos] = val[V_H2] * Q[qFowm + aux * 3 + j];
          }
          break;
        case kLipX:
          row[aux] = val[V_LIPX + aux];
          if (aux < 2)
  #pragma unroll
            for (int c = 0; c < L::nc; ++c) row[L::i_c + 3 * c + aux] = val[V_LIPC + aux];
          break;
        case kNewtonU:
          row[aux] = val[V_NEWT + aux];
  #pragma unroll
          for (int c = 0; c < L::nc; ++c) row[col_f(c, aux)] = val[V_NEWTF + aux];
          break;
        case kCone: {
          const T s = val[V_SLOPE + aux];
          const T* A = k.A_fc + 3 * (aux % 5);
  #pragma unroll
          for (int j = 0; j < 3; ++j) row[col_f(aux / 5, j)] = s * A[j];
          break;
        }
        default:
          break;
      }
    }
    if (blk < 2) return;
    const T* E = sw + (blk == 2 ? wEX : wEU);
    for (int s = 0; s < 3; ++s) {
      const int i = dslot[3 * (blk - 2) + s];
      if (i < 0) continue;
      for (int c = lane; c < width; c += 32) dst[i * width + c] = E[s * width + c];
    }
  }

  // The terminal pairs of members b0 … b0+3, one warp a member.
  template <typename T>
  __device__ static void terminal_block(T* sw, const T* __restrict__ X,
                                 const isrbd::Params<T>& P, int B, int ns,
                                 long long b0, const Consts<T>& k,
                                 T* __restrict__ rt, T* __restrict__ Jt) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int n_valid = B - b0 < kWarps ? static_cast<int>(B - b0) : kWarps;
    const size_t b = b0 + warp;
    const bool live = warp < n_valid;                // warp-uniform
    zero_fill(Jt + b0 * (nt * nx), n_valid * (nt * nx));
    T* x = sw + wXU;
    T* p = sw + wP;
    if (live) {
      const size_t row = b * (ns + 1) + ns;
      for (int j = lane; j < nx; j += 32) x[j] = X[row * nx + j];
      isrbd::load_params<S>(P, row, lane, p);
      __syncwarp();
      isrbd::terminal_rows(lane, x, p, k, [&](int g, T v) { rt[b * nt + g] = v; });
    }
    __syncthreads();                                 // the zeros are written
    if (!live) return;
    T* J = Jt + b * (nt * nx);
    const T rho = p[L::p_rho];
    const T sr = sqrt(rho);
  #pragma unroll
    for (int c = 0; c < (nt + 31) / 32; ++c) {
      const int g = lane + 32 * c;
      if (g >= nt) continue;
      T* row = J + g * nx;
      if (g < 11) {                                  // tracking, mask 1
        const T w = g == 0 ? k.w_rz : g < 5 ? p[L::p_wo] : g < 8 ? k.w_rdot : k.w_w;
        row[g == 0 ? 2 : g < 5 ? 2 + g : g < 8 ? L::i_rdot + g - 5 : L::i_w + g - 8] = w;
      } else if (g < L::n_track) {                   // foot pairs
        const int r = g - 11;
        const int a = k.fpi[r < 2 ? 0 : 1], b2 = k.fpi[r < 2 ? 2 : 3];
        const int ax = (r % 2 == 0) ? 1 : 0;
        row[L::i_c + 3 * a + ax] = -k.w_rel;
        row[L::i_c + 3 * b2 + ax] = k.w_rel;
      } else if (g < L::o_tbox) {                    // S_T√(ρw)·∂h_T
        const int q = g - L::n_track;
        const T s = (sr * k.sqw_T[q]) * k.S_T[q];
        if (q < L::q_cz) {
          if constexpr (L::n_relvel > 0) {           // none on point feet
            row[isrbd::relvel_col<S>(q, true)] = s;
            row[isrbd::relvel_col<S>(q, false)] = -s;
          }
        } else if (q < L::q_cz + L::nc) {
          row[L::i_c + 3 * (q - L::q_cz) + 2] = s;
        } else {
          const int a = q - L::q_cz - L::nc;
          row[a == 0 ? 2 : L::i_w + a - 1] = s * p[L::p_mzone];
        }
      } else {                                       // x-box rows
        const int desc = isrbd::box_desc<S>(g - L::o_tbox);
        T sl;
        isrbd::box_row(desc, x, p, rho, sr, &sl);
        row[desc & 0xff] = sl;
      }
    }
  }
};

template <class S, typename T>
__global__ void __launch_bounds__(32 * kWarps)
isrbd_linearize_kernel(const T* __restrict__ X, const T* __restrict__ U,
                       isrbd::Params<T> P, const int* __restrict__ table,
                       int B, int ns, int n_term,
                       const __grid_constant__ isrbd::Consts<S, T> k,
                       T* __restrict__ Sx, T* __restrict__ Bs,
                       T* __restrict__ Jxp, T* __restrict__ Jup,
                       T* __restrict__ rho, T* __restrict__ dfx,
                       T* __restrict__ rt, T* __restrict__ Jt) {
  using C = K5<S>;
  constexpr int nx = C::nx, nu = C::nu, nr = C::nr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stg = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* sw = stg + C::kStage + warp * C::wSize;

  if (static_cast<int>(blockIdx.x) < n_term) {    // the terminal pairs first
    C::terminal_block(sw, X, P, B, ns,
                      static_cast<long long>(blockIdx.x) * kWarps, k, rt, Jt);
    return;
  }

  int* info = reinterpret_cast<int*>(stg + C::kStage + kWarps * C::wSize);
  int* dslot = info + 2 * C::kRows;
  const long long q0 = static_cast<long long>(blockIdx.x - n_term) * kWarps;
  const long long total = static_cast<long long>(B) * ns;
  const int n_valid = total - q0 < kWarps ? static_cast<int>(total - q0) : kWarps;
  const bool live = warp < n_valid;                 // warp-uniform
  if (threadIdx.x < 6) dslot[threadIdx.x] = -1;
  if (live) {
    const long long q = q0 + warp;
    const size_t b = q / ns;
    const int n = static_cast<int>(q - static_cast<long long>(b) * ns);
    const size_t row = b * (ns + 1) + n;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < nx) {
        sw[C::wXU + j] = X[row * nx + j];
        sw[C::wXN + j] = X[(row + 1) * nx + j];
      }
    }
    if (lane < nu) sw[C::wXU + nx + lane] = U[(b * ns + n) * nu + lane];
    isrbd::load_params<S>(P, row, lane, sw + C::wP);
  }
  __syncthreads();                                  // dslot cleared, loads
  for (int i = threadIdx.x; i < C::kRows; i += blockDim.x) {
    const int blk = i < S::n_rx ? 0
                    : i < S::n_rx + S::n_ru ? 1
                    : i < S::n_rx + S::n_ru + S::n_gx ? 2 : 3;
    const int first = blk == 0 ? 0
                      : blk == 1 ? S::n_rx
                      : blk == 2 ? S::n_rx + S::n_ru
                                 : S::n_rx + S::n_ru + S::n_gx;
    const int2 kd = C::resolve(blk, table[i], table, k);
    info[2 * i] = kd.x;
    info[2 * i + 1] = kd.y;
    if ((kd.x & 0xff) == C::kDense) dslot[3 * (blk - 2) + (kd.x >> 20)] = i - first;
  }
  if (live) C::prologue(sw, stg, warp, k, lane);
  __syncthreads();                                  // ρ, d; kinds; scratch
  stream_out(stg, rho + q0 * nr, n_valid * nr);
  stream_out(stg + C::oD, dfx + q0 * nx, n_valid * nx);
  __syncthreads();                                  // before the first fill
  T* const dsts[4] = {Sx, Bs, Jxp, Jup};
#pragma unroll
  for (int blk = 0; blk < 4; ++blk) {
    const int per = C::per_node(blk), grp = C::group(blk);
#pragma unroll
    for (int c0 = 0; c0 < kWarps; c0 += grp) {
      const int cnt = n_valid - c0 < grp ? n_valid - c0 : grp;
      if (cnt <= 0) break;                          // block-uniform
      zero_fill(stg, cnt * per);
      __syncthreads();
      if (live && warp >= c0 && warp < c0 + grp)
        C::emit_block(blk, sw, info, dslot, k, lane, stg + (warp - c0) * per);
      __syncthreads();
      stream_out(stg, dsts[blk] + (q0 + c0) * per, cnt * per);
      __syncthreads();                              // before the next fill
    }
  }
}

template <class S, typename T>
int launch(const void* X, const void* U, const void* const* params,
           const void* table, int B, int ns, int n_rx, int n_ru, int n_gx,
           int n_gu, int n_b, int n_uc, const double* scalars, void* Sx,
           void* Bs, void* Jxp, void* Jup, void* rho, void* d, void* rt,
           void* Jt, void* stream) {
  if (n_rx != S::n_rx || n_ru != S::n_ru || n_gx != S::n_gx ||
      n_gu != S::n_gu || n_b != S::n_b || n_uc != S::n_uc)
    return kUnknownShape;
  if (B == 0) return 0;
  const long long stage_nodes = static_cast<long long>(B) * ns;
  const long long n_stage = (stage_nodes + kWarps - 1) / kWarps;
  const long long n_term = (B + kWarps - 1) / kWarps;
  const size_t bytes = K5<S>::template smem_bytes<T>();
  auto kernel = isrbd_linearize_kernel<S, T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(n_term + n_stage), 32 * kWarps, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      isrbd::make_params<T>(params), static_cast<const int*>(table), B, ns,
      static_cast<int>(n_term), isrbd::make_consts<S, T>(scalars),
      static_cast<T*>(Sx), static_cast<T*>(Bs), static_cast<T*>(Jxp),
      static_cast<T*>(Jup), static_cast<T*>(rho), static_cast<T*>(d),
      static_cast<T*>(rt), static_cast<T*>(Jt));
  return static_cast<int>(cudaGetLastError());
}

// K5's blocks resident on one SM, warps and shared memory a block, into
// out[0..2].
template <class S, typename T>
int occupancy(int* out) {
  const size_t bytes = K5<S>::template smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(isrbd_linearize_kernel<S, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, isrbd_linearize_kernel<S, T>, 32 * kWarps, bytes);
  out[1] = kWarps;
  out[2] = static_cast<int>(bytes);
  return static_cast<int>(e);
}

}  // namespace

// The contact topology (nc, cm, n_legs) picks the compiled shape; the row
// counts must be that shape's, or the call returns kUnknownShape and
// launches nothing.
#define LINEARIZE_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* X, const void* U,                           \
                      const void* const* params, const void* table, int B,    \
                      int ns, int nc, int cm, int n_legs, int n_rx, int n_ru, \
                      int n_gx, int n_gu, int n_b, int n_uc,                  \
                      const double* scalars, void* Sx, void* Bs, void* Jxp,   \
                      void* Jup, void* rho, void* d, void* rt, void* Jt,      \
                      void* stream) {                                         \
    return isrbd::with_topology(nc, cm, n_legs, [&](auto s) {                 \
      return launch<decltype(s), T>(X, U, params, table, B, ns, n_rx, n_ru,   \
                                    n_gx, n_gu, n_b, n_uc, scalars, Sx, Bs,   \
                                    Jxp, Jup, rho, d, rt, Jt, stream);        \
    });                                                                       \
  }

LINEARIZE_ENTRY(isrbd_linearize_f32, float)
LINEARIZE_ENTRY(isrbd_linearize_f64, double)

// K5's occupancy for the shape at index `shape` (kernels/isrbd_linearize.py::
// KERNEL_SHAPES order) and float32 (f64 = 0) or float64 tensors: out[0]
// blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1]
// warps a block, out[2] shared memory bytes a block.
extern "C" int isrbd_linearize_occupancy(int shape, int f64, int* out) {
  return isrbd::with_shape(shape, [&](auto s) {
    using S = decltype(s);
    return f64 ? occupancy<S, double>(out) : occupancy<S, float>(out);
  });
}
