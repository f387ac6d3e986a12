// K10 — the sliced linearization of the batched MS-DDP solver on the LIP
// problem, in closed form, every member-node and the terminal node in one
// launch.
//
// Replaces: the dense `MSDDP._linearize_impl` (srbd_horizon_tpu/solvers/
// msddp.py:200-246), `jax.jacfwd` of the problem's step and of `_stage_rho`
// under `vmap`, which XLA fused on the TPU (the JAX package wrote no Pallas
// kernel for it; its LIP problem declares no row sparsity, so JAX forms the
// dense A, B, Jx, Ju). This kernel writes the rows the port's problem
// declares (problems/lip.py::row_sets), which hold every nonzero of the
// dense form. Plain twin: `kernels/lip_linearize.py::lip_linearize_plain`.
// Per member-node (b, n):
//     Sx  = (A − I)[rx]          (A = ∂step/∂x on the live rows)
//     Bs  = B[ru]                (B = ∂step/∂u on the live rows)
//     Jxp = (∂ρ/∂x)[gx]          Jup = (∂ρ/∂u)[gu]
//     ρ   = [stage_residual; √w_c·stage_eq]     d = step(x, u) − X[n+1]
// and per member the terminal rt and Jt = ∂rt/∂x. The row sets rx, ru, gx,
// gu arrive as the int32 table K1 reads (kernels/riccati.py::RiccatiRows).
//
// The LIP is linear–quadratic, so every Jacobian entry is a constant of dt,
// η², 1/nc, √w_c and the weights under every step (the host forms A and B
// of RK2 and RK4 by the chain rule through the stages,
// kernels/lip_linearize.py::step_blocks): Sx, Bs, Jup and Jt are the same for every
// member-node, and Jxp is a constant template whose tracking rows (rz, rxy,
// ṙ, rel) the node's `mask_track` scales and whose ċxy equality rows its
// `cdot_switch` scales. Only ρ and d read the state; d is the step's own
// (lip::step_row: the stages evaluated as ocp/integrators.py evaluates
// them, not A·x + B·u, which rounds otherwise). Each entry is formed
// as the twin forms it (the scaled entries as template × scale, equal to
// the twin's scale × weight; a structural zero stays zero whatever the
// scale), so the Jacobians agree with the twin bit for bit.
//
// Compiled for the fifteen (topology, step) instances of csrc/lip_common.cuh
// (the kernel is a template of the shape, `lip::with_topology` picks the
// instance): the per-node output sizes, the records and every loop bound
// are constants; the wrapper refuses other sizes. The row table stays a run-time input:
// the wrapper forms the templates from it, and the kernel reads its gx
// rows for the scales of Jxp.
//
// What bounds it on an H100: bytes. A member-node of the Kangaroo under
// Euler writes 2,069 values (Sx 540, Bs 225, Jxp 960, Jup 270, ρ 44, d 30;
// under RK Bs is 450) and reads 87; a member adds rt and Jt, 310. At
// B=512, ns=20 that is ~85 MB of float32 out, 26 µs
// at 3.35 TB/s, against a few hundred FLOP a member-node. At B=1 the
// 172 KB take ~0.05 µs of the card's rate: the launch and one node's
// latency set the time.
//
// Design: slots. The Jacobian templates (Sx, Bs, Jxp unscaled, Jup, Jt)
// are formed once on the host (kernels/lip_linearize.py::templates, by the
// entry formulas K10 had formed in every block, in the working type) and
// kept on the device, each repeated kVec<T> times. A group is G
// consecutive stage member-nodes (or G members' terminal pairs): G = 1
// while B·ns is small, so that B=1 takes its 20 stage nodes and its
// terminal node on 21 blocks, else G = kGroupUnits·kVec<T> (4 in float32,
// 2 in float64), whose outputs, starting at a flat index divisible by G,
// are 16-byte aligned in every field. A field of `per` values a node is
// per·G/V units a group (a unit: V values, one 16-byte store, or at G = 1
// one value); unit u of each template field belongs to one thread for the
// whole launch (the fields' units dealt round the block, each field
// starting where the last ended), which loads each once a group through
// the read-only path (L1 after the block's first group);
// the row scale of each of its Jxp values (the node's mask or switch, read
// from gx) it forms once. The block walks its groups (a grid-stride loop,
// kMinBlocks blocks an SM): the group's records (x, X[n+1], u and the
// packed parameter row a node) arrive in registers, a slot a thread chosen
// once (selects, no branch per value), go to one of two record buffers in
// shared memory, and after one barrier the next group's loads are issued
// before this group's stores, so no store waits on a load issued after it.
// A template unit's store is its template (Jxp scaled as the twin scales
// it); ρ, d and rt go a value a thread, row-major over the group's nodes
// (a warp's lanes share rows), by the shared row functions in their
// parent order. Each entry is as the twin forms it (the scaled entries
// template × scale; a structural zero stays zero whatever the scale), so
// the Jacobians agree with the twin and with the streaming kernel this
// replaced bit for bit, and ρ and d, by the same functions in the same
// order, with that kernel bit for bit. Held in registers instead, the
// template units cost 128 registers and spills; larger groups spill their
// Jxp scales (tools/torch_k10_variants.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "lip_common.cuh"

namespace {

constexpr int kSlotThreads = 512;        // threads a block
constexpr int kMinBlocks = 2;            // blocks an SM the registers are held to
constexpr int kGroupUnits = 1;           // a fleet's group: kGroupUnits·kVec<T> nodes

// The launch bound's blocks an SM at instance S: kMinBlocks, but one for
// the square-feet biped (nx = 54), whose 2,808 Jxp values a node give a
// thread six slots of Jxp scales and units: held to 64 registers they
// spilled 48 bytes a thread in float32 on an H100 (the line-feet
// quadruped's 2,592 take as many slots). The grid still takes up to
// kMinBlocks blocks an SM.
template <class S>
constexpr int kBoundBlocks = S::nx > 32 ? 1 : kMinBlocks;

// member-nodes a 16-byte group: kVec<T> values of T are 16 bytes
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// The sizes of shape S's outputs and records, and the template table.
template <class S>
struct K10 {
  using L = lip::Layout<S>;
  static constexpr int nx = S::nx, nu = S::nu, nr = S::n_rho, nt = S::nt;
  // values a node of each field
  static constexpr int kSx = S::n_rx * nx, kBs = S::n_ru * nu,
                       kJxp = S::n_gx * nx, kJup = S::n_gu * nu,
                       kJt = nt * nx;
  // the template table in per-node templates: Sx, Bs, Jxp, Jup, Jt, each
  // repeated kVec<T> times on the device (offsets × kVec<T>)
  static constexpr int oSx = 0, oBs = oSx + kSx, oJxp = oBs + kBs,
                       oJup = oJxp + kJxp, oJt = oJup + kJup,
                       kTemplates = oJt + kJt;
  // a node record: x, X[n+1], u, the packed parameter row
  static constexpr int rX = 0, rXn = nx, rU = 2 * nx, rP = 2 * nx + nu,
                       kRec = rP + L::pw;
  // the first thread of each template field's units: Sx, Bs, Jxp, Jup
  // dealt in order round the block, each starting where the last ended
  static constexpr int kRotSx = 0, kRotBs = kSx % kSlotThreads,
                       kRotJxp = (kSx + kBs) % kSlotThreads,
                       kRotJup = (kSx + kBs + kJxp) % kSlotThreads, kRotJt = 0;
};

// Slots of a field of `per` units a group: the thread's units kSlotThreads
// apart.
__host__ __device__ constexpr int slots(int per) {
  return (per + kSlotThreads - 1) / kSlotThreads;
}

// This thread's unit of a field in slot s (-1 past the field's end).
template <int per, int rot>
__device__ __forceinline__ int unit_of(int tid, int s) {
  const int u = (tid + kSlotThreads - rot) % kSlotThreads + s * kSlotThreads;
  return u < per ? u : -1;
}

// Template unit u of a field (`oF` its offset in per-node templates): one
// load through the read-only path, a hit in L1 after the block's first
// group.
template <int oF, typename T, int V>
__device__ __forceinline__ lip::Unit<T, V> template_unit(
    const T* __restrict__ tmpl, int u) {
  const T* p = tmpl + oF * kVec<T> + u * V;
  lip::Unit<T, V> x;
  if constexpr (V == 1) {
    x.v[0] = __ldg(p);
  } else {
    static_assert(sizeof(x) == 16, "a 16-byte unit");
    const int4 r = __ldg(reinterpret_cast<const int4*>(p));
    memcpy(&x, &r, sizeof(x));
  }
  return x;
}

// Store unit u of a group's field block at dst, of which the group's nodes
// fill `valid` values: one store when the unit is whole, value by value
// at the end of a partial group.
template <typename T, int V>
__device__ __forceinline__ void store_unit(T* __restrict__ dst, int u,
                                           int valid, const lip::Unit<T, V>& x) {
  if (u * V + V <= valid) {
    *reinterpret_cast<lip::Unit<T, V>*>(dst + u * V) = x;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (u * V + j < valid) dst[u * V + j] = x.v[j];
  }
}

// The scale of stage row r of ∂ρ/∂x: 0 for none, else 1 + its entry of
// the packed parameter row (the tracking mask, or cdot_switch[q]).
template <class S>
__device__ int jxp_scale(int r) {
  using L = lip::Layout<S>;
  if (r < 6 || (r >= 9 && r < 13)) return 1 + lip::kP_mt;   // tracking rows
  int q = r - L::n_res - L::n_rv - S::nc;
  return q < 0 ? 0 : 1 + lip::Param<S>::cs + q / 2;         // ċxy rows
}

// A record slot, packed in one int: the node w in the group (bits 0-3),
// the source (bits 4-7: 0 the node's x, 1 X[n+1], 2 u, 3 + t parameter
// tensor t) and the element in its row (bits 8 on). A slot past the
// group's records has source 15 and loads nothing.
enum : int { kSrcX = 0, kSrcXn = 1, kSrcU = 2, kSrcP = 3, kSrcNone = 15 };

template <class S>
__device__ int rec_slot(int i, int V) {
  using Z = K10<S>;
  if (i >= V * Z::kRec) return kSrcNone << 4;
  const int w = i / Z::kRec, e = i - w * Z::kRec;
  int src, off;
  if (e < Z::rXn) {
    src = kSrcX, off = e;
  } else if (e < Z::rU) {
    src = kSrcXn, off = e - Z::rXn;
  } else if (e < Z::rP) {
    src = kSrcU, off = e - Z::rU;
  } else {
    const int p = e - Z::rP;
    const int t = p < lip::kP_rdot ? 0 : p < lip::kP_cref ? 1
                  : p < lip::Param<S>::cs ? 2 : 3;
    src = kSrcP + t, off = p - lip::param_off<S>(t);
  }
  return w | src << 4 | off << 8;
}

// The value record slot `slot` loads for member b's node n (row = b·(ns+1)
// + n, q = b·ns + n), T(0) for none: every select, no branch.
template <class S, typename T>
__device__ __forceinline__ T rec_load(int slot, const T* __restrict__ X,
                                      const T* __restrict__ U,
                                      const lip::Params<T>& P, long long row,
                                      long long q, bool terminal) {
  using Z = K10<S>;
  const int src = (slot >> 4) & 15, off = slot >> 8;
  const T* base = src <= kSrcXn ? X : src == kSrcU ? U
                  : src == kSrcP ? P.p[0] : src == kSrcP + 1 ? P.p[1]
                  : src == kSrcP + 2 ? P.p[2] : P.p[3];
  const int stride = src <= kSrcXn ? Z::nx : src == kSrcU ? Z::nu
                     : lip::param_dim<S>(src - kSrcP);
  const long long idx = (src == kSrcU ? q : row) + (src == kSrcXn);
  const bool live = src != kSrcNone && !(terminal && (src == kSrcXn || src == kSrcU));
  return live ? base[idx * stride + off] : T(0);
}

template <typename T>
struct Out {
  T *Sx, *Bs, *Jxp, *Jup, *rho, *d, *rt, *Jt;
};

// The block stores its units of a template field (per values a node,
// `units` a group, oF its offset in per-node templates) for a group whose
// nodes fill `valid` values of the block at dst.
template <int per, int units, int rot, int oF, typename T, int V>
__device__ __forceinline__ void store_template(T* __restrict__ dst,
                                               const T* __restrict__ tmpl,
                                               int valid, int tid) {
#pragma unroll
  for (int s = 0; s < slots(units); ++s) {
    const int u = unit_of<units, rot>(tid, s);
    if (u >= 0)
      store_unit(dst, u, valid,
                 template_unit<oF, T, V>(tmpl, units == per ? u : u % per));
  }
}

// G member-nodes a group (1, or whole 16-byte units: V = kVec<T> values a
// unit, G a multiple of V).
template <class S, typename T, int G>
__global__ void __launch_bounds__(kSlotThreads, kBoundBlocks<S>)
lip_linearize_kernel(const T* __restrict__ X, const T* __restrict__ U,
                     lip::Params<T> P, const int* __restrict__ table,
                     const T* __restrict__ tmpl, int B, int ns, int n_stage,
                     int n_groups, lip::Consts<T> k, Out<T> o) {
  using Z = K10<S>;
  constexpr int V = G == 1 ? 1 : kVec<T>;
  static_assert(G % V == 0 && G <= 8, "whole units, 4 bits a node (3 in a "
                "Jxp scale)");
  static_assert(lip::Param<S>::cs + S::nc < 32, "5 bits a Jxp scale");
  constexpr int kUnitsJxp = Z::kJxp * G / V, kRecSlots = slots(G * Z::kRec);
  __shared__ __align__(16) T recs[2][G * Z::kRec];
  const int tid = threadIdx.x;
  // this thread's record slots, once
  int rs[kRecSlots];
#pragma unroll
  for (int s = 0; s < kRecSlots; ++s) rs[s] = rec_slot<S>(tid + s * kSlotThreads, G);
  const int total = B * ns;                // stage member-nodes

  // the stage groups
  T rv[kRecSlots];
  auto load_stage = [&](int g) {
#pragma unroll
    for (int s = 0; s < kRecSlots; ++s) {
      const int q = g * G + (rs[s] & 15);
      rv[s] = q < total ? rec_load<S>(rs[s], X, U, P, q + q / ns, q, false)
                        : T(0);
    }
  };
  int g = blockIdx.x, buf = 0;
  if (g < n_stage) load_stage(g);
  // this thread's Jxp scales, once, while the first records load: each
  // Jxp value's scale (5 bits: both eight-contact robots' reach 20) and node
  // in the group (3 bits), 8 bits a value
  unsigned scale[slots(kUnitsJxp)];
  const int* gx = table + S::n_rx + S::n_ru;
#pragma unroll
  for (int s = 0; s < slots(kUnitsJxp); ++s) {
    const int u = unit_of<kUnitsJxp, Z::kRotJxp>(tid, s);
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int v = (u < 0 ? 0 : u) * V + j, w = v / Z::kJxp;
      const int r = (v - w * Z::kJxp) / Z::nx;
      bits |= static_cast<unsigned>(jxp_scale<S>(gx[r]) | (w << 5)) << (8 * j);
    }
    scale[s] = bits;
  }
  for (; g < n_stage; g += gridDim.x) {
    T* rec = recs[buf];
    buf ^= 1;
#pragma unroll
    for (int s = 0; s < kRecSlots; ++s)
      if (tid + s * kSlotThreads < G * Z::kRec) rec[tid + s * kSlotThreads] = rv[s];
    // the group's records are in
    __syncthreads();
    if (g + static_cast<int>(gridDim.x) < n_stage) load_stage(g + gridDim.x);
    const long long q0 = static_cast<long long>(g) * G;
    const int nv = total - q0 < G ? static_cast<int>(total - q0) : G;
    store_template<Z::kSx, Z::kSx * G / V, Z::kRotSx, Z::oSx, T, V>(
        o.Sx + q0 * Z::kSx, tmpl, nv * Z::kSx, tid);
    store_template<Z::kBs, Z::kBs * G / V, Z::kRotBs, Z::oBs, T, V>(
        o.Bs + q0 * Z::kBs, tmpl, nv * Z::kBs, tid);
    store_template<Z::kJup, Z::kJup * G / V, Z::kRotJup, Z::oJup, T, V>(
        o.Jup + q0 * Z::kJup, tmpl, nv * Z::kJup, tid);
    T* Jxp = o.Jxp + q0 * Z::kJxp;
#pragma unroll
    for (int s = 0; s < slots(kUnitsJxp); ++s) {
      const int u = unit_of<kUnitsJxp, Z::kRotJxp>(tid, s);
      if (u < 0) continue;
      const lip::Unit<T, V> t = template_unit<Z::oJxp, T, V>(
          tmpl, kUnitsJxp == Z::kJxp ? u : u % Z::kJxp);
      lip::Unit<T, V> x;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const unsigned bits = scale[s] >> (8 * j);
        const int sid = bits & 31, w = (bits >> 5) & 7;
        const T f = rec[w * Z::kRec + Z::rP + (sid ? sid - 1 : 0)];
        x.v[j] = (sid == 0 || t.v[j] == T(0)) ? t.v[j] : t.v[j] * f;
      }
      store_unit(Jxp, u, nv * Z::kJxp, x);
    }
    // ρ and d a value a thread, row-major over the group's nodes (the
    // lanes of a warp share rows, G nodes a row), by the shared row
    // functions
#pragma unroll
    for (int s = 0; s < slots(G * (Z::nr + Z::nx)); ++s) {
      const int i = tid + s * kSlotThreads;
      if (i < G * Z::nr) {
        const int g_ = i / G, w = i - g_ * G;
        const T* r = rec + w * Z::kRec;
        const T v = lip::stage_rho_row<S>(g_, r + Z::rX, r + Z::rU, r + Z::rP, k);
        if (w < nv) o.rho[(q0 + w) * Z::nr + g_] = v;
      } else if (i < G * (Z::nr + Z::nx)) {
        const int j = (i - G * Z::nr) / G, w = i - G * Z::nr - j * G;
        const T* r = rec + w * Z::kRec;
        const T v = lip::step_row<S>(j, r + Z::rX, r + Z::rU, k) -
                    r[Z::rXn + j];
        if (w < nv) o.d[(q0 + w) * Z::nx + j] = v;
      }
    }
    // the end of a stage group
  }

  // the terminal groups: G members' rt and Jt
  if (g < n_groups) {
    auto load_terminal = [&](int gt) {
#pragma unroll
      for (int s = 0; s < kRecSlots; ++s) {
        const int b = (gt - n_stage) * G + (rs[s] & 15);
        rv[s] = b < B ? rec_load<S>(rs[s], X, U, P,
                                    static_cast<long long>(b) * (ns + 1) + ns,
                                    0, true)
                      : T(0);
      }
    };
    load_terminal(g);
    for (; g < n_groups; g += gridDim.x) {
      T* rec = recs[buf];
      buf ^= 1;
#pragma unroll
      for (int s = 0; s < kRecSlots; ++s)
        if (tid + s * kSlotThreads < G * Z::kRec) rec[tid + s * kSlotThreads] = rv[s];
      __syncthreads();
      if (g + static_cast<int>(gridDim.x) < n_groups) load_terminal(g + gridDim.x);
      const long long b0 = static_cast<long long>(g - n_stage) * G;
      const int nv = B - b0 < G ? static_cast<int>(B - b0) : G;
      store_template<Z::kJt, Z::kJt * G / V, Z::kRotJt, Z::oJt, T, V>(
          o.Jt + b0 * Z::kJt, tmpl, nv * Z::kJt, tid);
#pragma unroll
      for (int s = 0; s < slots(G * Z::nt); ++s) {
        const int i = tid + s * kSlotThreads;   // rt a value a thread, row-major
        const int g_ = i / G, w = i - g_ * G;
        if (i < G * Z::nt) {
          const T* r = rec + w * Z::kRec;
          const T v = lip::tracking_row<S>(g_, r + Z::rX, r + Z::rP, T(1), k);
          if (w < nv) o.rt[(b0 + w) * Z::nt + g_] = v;
        }
      }
      // the end of a terminal group
    }
  }
  // the block is done
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

// The member-nodes a group at B·ns stage nodes: kVec<T>·kGroupUnits where
// those groups fill every SM, else 1 (kernels/lip_linearize.py::group_nodes
// states the same).
template <typename T>
constexpr int kGroupNodes = kVec<T> * kGroupUnits;

// The member-nodes a fleet's group at instance S: kGroupNodes<T>, but one
// for the square feet (nx = 54), whose 16-byte groups spilled at the 128
// registers 512 threads a block leave (40 bytes a thread in float32's
// groups of four, 96 in float64's of two under RK2); one node a group
// takes 94 registers in float32, no spill.
template <class S, typename T>
constexpr int kVecGroup = S::nx > 32 ? 1 : kGroupNodes<T>;

template <typename T>
int group_nodes(long long stage_nodes, int sms) {
  return stage_nodes >= static_cast<long long>(kGroupNodes<T>) * sms
             ? kGroupNodes<T>
             : 1;
}

template <class S, typename T, int G>
int launch_groups(const void* X, const void* U, const void* const* params,
                  const void* table, const void* tmpl, int B, int ns,
                  const double* scalars, const Out<T>& o, void* stream) {
  const long long n_stage = (static_cast<long long>(B) * ns + G - 1) / G;
  const long long n_groups = n_stage + (B + G - 1) / G;
  const long long cap = static_cast<long long>(sm_count()) * kMinBlocks;
  const unsigned grid = static_cast<unsigned>(n_groups < cap ? n_groups : cap);
  lip_linearize_kernel<S, T, G><<<grid, kSlotThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      lip::make_params<T>(params), static_cast<const int*>(table),
      static_cast<const T*>(tmpl), B, ns, static_cast<int>(n_stage),
      static_cast<int>(n_groups), lip::make_consts<T>(scalars), o);
  return static_cast<int>(cudaGetLastError());
}

template <class S, typename T>
int launch(const void* X, const void* U, const void* const* params,
           const void* table, const void* tmpl, int B, int ns, int n_rx,
           int n_ru, int n_gx, int n_gu, const double* scalars,
           void* const* outs, void* stream) {
  if (n_rx != S::n_rx || n_ru != S::n_ru || n_gx != S::n_gx || n_gu != S::n_gu)
    return lip::kUnknownShape;
  if (B == 0) return 0;
  const Out<T> o{static_cast<T*>(outs[0]), static_cast<T*>(outs[1]),
                 static_cast<T*>(outs[2]), static_cast<T*>(outs[3]),
                 static_cast<T*>(outs[4]), static_cast<T*>(outs[5]),
                 static_cast<T*>(outs[6]), static_cast<T*>(outs[7])};
  if (group_nodes<T>(static_cast<long long>(B) * ns, sm_count()) == 1)
    return launch_groups<S, T, 1>(X, U, params, table, tmpl, B, ns, scalars,
                                  o, stream);
  return launch_groups<S, T, kVecGroup<S, T>>(X, U, params, table, tmpl, B,
                                              ns, scalars, o, stream);
}

}  // namespace

// The instance is the topology (nc, cm, n_legs) under the step (its id,
// lip::Euler / Rk2 / Rk4); outs: Sx, Bs, Jxp, Jup, ρ, d, rt, Jt, each
// 16-byte aligned; tmpl the template table
// (kernels/lip_linearize.py::templates), 16-byte aligned.
#define LINEARIZE_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* X, const void* U,                           \
                      const void* const* params, const void* table,           \
                      const void* tmpl, int B, int ns, int nc, int cm,        \
                      int n_legs, int step, int n_rx, int n_ru, int n_gx,     \
                      int n_gu, const double* scalars, void* const* outs,     \
                      void* stream) {                                         \
    return lip::with_topology(nc, cm, n_legs, step, [&](auto shape) {        \
      return launch<decltype(shape), T>(X, U, params, table, tmpl, B, ns,     \
                                        n_rx, n_ru, n_gx, n_gu, scalars,      \
                                        outs, stream);                        \
    });                                                                       \
  }

LINEARIZE_ENTRY(lip_linearize_f32, float)
LINEARIZE_ENTRY(lip_linearize_f64, double)

// K10's occupancy at the instance `shape` (its index in
// kernels/lip_linearize.py::KERNEL_SHAPES) for float32 (f64 = 0) or
// float64 tensors, with groups of one member-node (vec = 0) or of 16
// bytes' worth (vec = 1), into out[0..4]: blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the grid takes at most
// kMinBlocks of them an SM), warps a block, shared memory bytes a block,
// registers and local (spilled) bytes a thread.
template <class S, typename T, int G>
int occupancy(int* out) {
  auto kernel = lip_linearize_kernel<S, T, G>;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kSlotThreads, 0);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = kSlotThreads / 32;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

extern "C" int lip_linearize_occupancy(int shape, int f64, int vec, int* out) {
  return lip::with_shape(shape, [&](auto sh) {
    using S = decltype(sh);
    if (f64)
      return vec ? occupancy<S, double, kVecGroup<S, double>>(out)
                 : occupancy<S, double, 1>(out);
    return vec ? occupancy<S, float, kVecGroup<S, float>>(out)
               : occupancy<S, float, 1>(out);
  });
}

// The members-nodes a group at B·ns stage nodes on the current card, for
// float32 (f64 = 0) or float64 tensors.
extern "C" int lip_linearize_group_nodes(int f64, long long stage_nodes) {
  return f64 ? group_nodes<double>(stage_nodes, sm_count())
             : group_nodes<float>(stage_nodes, sm_count());
}
