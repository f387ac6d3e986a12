// K10 — the sliced linearization of the batched MS-DDP solver on the LIP
// problem, in closed form, every member-node and the terminal node in one
// launch.
//
// Replaces: the dense `MSDDP._linearize_impl` (srbd_horizon_tpu/solvers/
// msddp.py:200-246), `jax.jacfwd` of the Euler step and of `_stage_rho`
// under `vmap`, which XLA fused on the TPU (the JAX package wrote no Pallas
// kernel for it; its LIP problem declares no row sparsity, so JAX forms the
// dense A, B, Jx, Ju). This kernel writes the rows the port's problem
// declares (problems/lip.py::row_sets), which hold every nonzero of the
// dense form. Plain twin: `kernels/lip_linearize.py::lip_linearize_plain`.
// Per member-node (b, n):
//     Sx  = dt·(∂ẋ/∂x)[rx]       (A − I on the live rows, A = I + dt ∂ẋ/∂x)
//     Bs  = dt·(∂ẋ/∂u)[ru]       (B on the live rows)
//     Jxp = (∂ρ/∂x)[gx]          Jup = (∂ρ/∂u)[gu]
//     ρ   = [stage_residual; √w_c·stage_eq]     d = x + dt·ẋ − X[n+1]
// and per member the terminal rt and Jt = ∂rt/∂x. The row sets rx, ru, gx,
// gu arrive as the int32 table K1 reads (kernels/riccati.py::RiccatiRows).
//
// The LIP is linear–quadratic, so every Jacobian entry is a constant of dt,
// η², 1/nc, √w_c and the weights: Sx, Bs, Jup and Jt are the same for every
// member-node, and Jxp is a constant template whose tracking rows (rz, rxy,
// ṙ, rel) the node's `mask_track` scales and whose ċxy equality rows its
// `cdot_switch` scales. Only ρ and d read the state. Each entry is formed
// as the twin forms it (the scaled entries as template × scale, equal to
// the twin's scale × weight; a structural zero stays zero whatever the
// scale), so the Jacobians agree with the twin bit for bit.
//
// Compiled for the sizes of `lip::Shape` only (csrc/lip_common.cuh): the
// per-node output sizes, the smem layout and every loop bound are
// constants; the wrapper refuses other sizes. The row table stays a
// run-time input.
//
// What bounds it on an H100: bytes. A member-node writes 2,069 values
// (Sx 540, Bs 225, Jxp 960, Jup 270, ρ 44, d 30) and reads 87; a member
// adds rt and Jt, 310. At B=512, ns=20 that is ~85 MB of float32 out, 26 µs
// at 3.35 TB/s, against a few hundred FLOP a member-node.
//
// Design: a store stream. Each block first forms the templates (Sx, Bs,
// Jxp unscaled, Jup, Jt) in shared memory, one entry a thread, and the
// scale of each Jxp row; then it walks groups of kNodes consecutive stage
// member-nodes (and, after the stage groups, groups of kNodes members'
// terminal pairs), a grid-stride loop, so the templates are formed once a
// block. For a group it stages the nodes' x, X[n+1], u and parameter rows
// in shared memory, and the whole block streams each output: the group's
// nodes' blocks of one output are contiguous in device memory, so
// neighbouring threads store neighbouring elements, each copied from the
// template (Jxp scaled by its row's mask or switch), and ρ and d one entry
// a thread. No warp waits on another's arithmetic between stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (kernels/build.py). Plain C interface for ctypes.

#include "lip_common.cuh"

namespace {

using S = lip::Shape;
using L = lip::Layout<S>;
constexpr int kThreads = 256;
constexpr int kNodes = 16;               // member-nodes (or members) a group
constexpr int kBlocksPerSm = 4;          // the grid: at most this many an SM
constexpr int kUnknownShape = -2;        // the sizes are not lip::Shape's
constexpr int nx = S::nx, nu = S::nu, nr = S::n_rho, nt = S::nt;

// per-node sizes of the Jacobian blocks and the terminal Jacobian
constexpr int kSx = S::n_rx * nx, kBs = S::n_ru * nu, kJxp = S::n_gx * nx,
              kJup = S::n_gu * nu, kJt = nt * nx;
// shared memory (in T): the templates, then a group's node records
constexpr int tSx = 0, tBs = tSx + kSx, tJxp = tBs + kBs, tJup = tJxp + kJxp,
              tJt = tJup + kJup, tEnd = tJt + kJt;
// a node record: x, X[n+1], u, the packed parameter row
constexpr int rX = 0, rXn = nx, rU = 2 * nx, rP = 2 * nx + nu,
              kRec = rP + L::pw;

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (tEnd + kNodes * kRec) + sizeof(int) * S::n_gx;
}

// Jxp row scales: none, the tracking mask, or cdot_switch[q] (kCs + q)
enum : int { kNone = 0, kMask = 1, kCs = 2 };

// Row r, column c of dt·∂ẋ/∂x.
template <typename T>
__device__ T sx_entry(int r, int c, const lip::Consts<T>& k) {
  if (r < 3) return c == L::i_rdot + r ? k.dt : T(0);               // ṙ
  if (r < L::i_rdot) return c == L::i_cdot + r - 3 ? k.dt : T(0);   // ċ
  if (r < L::i_cdot) return c == r - L::i_rdot ? k.dt * k.eta2 : T(0);  // η² r
  return T(0);
}

// Row r, column c of dt·∂ẋ/∂u.
template <typename T>
__device__ T bs_entry(int r, int c, const lip::Consts<T>& k) {
  if (r >= L::i_rdot && r < L::i_cdot)
    return c == r - L::i_rdot ? k.dt * (-k.eta2) : T(0);            // −η² z
  if (r >= L::i_cdot) return c == 3 + r - L::i_cdot ? k.dt : T(0);  // c̈
  return T(0);
}

// Column c of the contact block on axis a: the centroid's columns.
__device__ __forceinline__ bool centroid_col(int c, int a) {
  return c >= L::i_c && c < L::i_rdot && (c - L::i_c) % 3 == a;
}

// Row g < 6 (rz, rxy, ṙ) or rel row g − 6 of the tracking Jacobian with
// the mask 1, column c.
template <typename T>
__device__ T tracking_entry(int g, int c, const lip::Consts<T>& k) {
  if (g == 0) return c == 2 ? k.w_r : T(0);
  if (g < 3) {
    if (c == g - 1) return k.w_r;
    return centroid_col(c, g - 1) ? -k.w_r / T(S::nc) : T(0);
  }
  if (g < 6) return c == L::i_rdot + g - 3 ? k.w_rdot : T(0);
  int a, b;
  lip::rel_cols<S>(g - 6, &a, &b);
  if (c == L::i_c + a) return -k.w_rel;
  return c == L::i_c + b ? k.w_rel : T(0);
}

// Row r, column c of ∂ρ/∂x before its row's scale, and the scale (*kind).
template <typename T>
__device__ T jxp_entry(int r, int c, const lip::Consts<T>& k, int* kind) {
  *kind = kNone;
  if (r < 6 || (r >= 9 && r < 13)) {                  // the tracking rows
    *kind = kMask;
    return tracking_entry(r < 6 ? r : r - 3, c, k);
  }
  if (r < 9) return centroid_col(c, r - 6) ? -k.w_zmp / T(S::nc) : T(0);
  if (r < 16) return c == r - 13 ? k.w_qddot * k.eta2 : T(0);    // r̈
  if (r < L::n_res) return T(0);                       // c̈: inputs only
  int q = r - L::n_res;                                // √w_c ∂eq/∂x
  constexpr int per = 2 * (S::cm - 1);
  if (q < L::n_rv) {
    const int base = (q / per) * S::cm, rem = q % per;
    const int i = rem / 2 + 1, ax = rem % 2;
    if (c == L::i_cdot + 3 * base + ax) return k.wc;
    return c == L::i_cdot + 3 * (base + i) + ax ? -k.wc : T(0);
  }
  q -= L::n_rv;
  if (q < S::nc) return c == L::i_c + 3 * q + 2 ? k.wc : T(0);
  q -= S::nc;
  *kind = kCs + q / 2;
  return c == L::i_cdot + 3 * (q / 2) + q % 2 ? k.wc : T(0);
}

// Row r, column c of ∂ρ/∂u.
template <typename T>
__device__ T jup_entry(int r, int c, const lip::Consts<T>& k) {
  if (r >= 6 && r < 9) return c == r - 6 ? k.w_zmp : T(0);        // zmp
  if (r >= 13 && r < 16) return c == r - 13 ? -(k.w_qddot * k.eta2) : T(0);
  if (r >= 16 && r < L::n_res) return c == 3 + r - 16 ? k.w_qddot : T(0);
  return T(0);
}

// The block forms the templates and the Jxp row scales.
template <typename T>
__device__ void form_templates(T* s, int* scale, const int* __restrict__ table,
                               const lip::Consts<T>& k) {
  const int* rx = table;
  const int* ru = rx + S::n_rx;
  const int* gx = ru + S::n_ru;
  const int* gu = gx + S::n_gx;
  for (int i = threadIdx.x; i < kSx; i += kThreads)
    s[tSx + i] = sx_entry(rx[i / nx], i % nx, k);
  for (int i = threadIdx.x; i < kBs; i += kThreads)
    s[tBs + i] = bs_entry(ru[i / nu], i % nu, k);
  for (int i = threadIdx.x; i < kJxp; i += kThreads) {
    int kind;
    s[tJxp + i] = jxp_entry(gx[i / nx], i % nx, k, &kind);
    if (i % nx == 0) scale[i / nx] = kind;
  }
  for (int i = threadIdx.x; i < kJup; i += kThreads)
    s[tJup + i] = jup_entry(gu[i / nu], i % nu, k);
  for (int i = threadIdx.x; i < kJt; i += kThreads)
    s[tJt + i] = tracking_entry(i / nx, i % nx, k);
}

// The block streams `count` values of a per-node template (`per` values a
// node) to dst, node after node.
template <int per, typename T>
__device__ __forceinline__ void stream_template(const T* tmpl,
                                                T* __restrict__ dst,
                                                int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = tmpl[i % per];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lip_linearize_kernel(const T* __restrict__ X, const T* __restrict__ U,
                     lip::Params<T> P, const int* __restrict__ table, int B,
                     int ns, int n_stage, int n_groups, lip::Consts<T> k,
                     T* __restrict__ Sx, T* __restrict__ Bs,
                     T* __restrict__ Jxp, T* __restrict__ Jup,
                     T* __restrict__ rho, T* __restrict__ dfx,
                     T* __restrict__ rt, T* __restrict__ Jt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  T* rec = s + tEnd;
  int* scale = reinterpret_cast<int*>(rec + kNodes * kRec);
  const int tid = threadIdx.x;
  form_templates(s, scale, table, k);
  const long long total = static_cast<long long>(B) * ns;

  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    __syncthreads();                       // templates; the last group's reads
    if (grp < n_stage) {                   // kNodes stage member-nodes
      const long long q0 = static_cast<long long>(grp) * kNodes;
      const int nv = total - q0 < kNodes ? static_cast<int>(total - q0) : kNodes;
      for (int i = tid; i < nv * kRec; i += kThreads) {
        const int w = i / kRec, e = i - w * kRec;
        const long long q = q0 + w;
        const size_t b = q / ns;
        const int n = static_cast<int>(q - static_cast<long long>(b) * ns);
        const size_t row = b * (ns + 1) + n;
        T v;
        if (e < rXn) v = X[row * nx + e];
        else if (e < rU) v = X[(row + 1) * nx + (e - rXn)];
        else if (e < rP) v = U[(b * ns + n) * nu + (e - rU)];
        else v = *lip::param_src<S>(P, row, e - rP);
        rec[i] = v;
      }
      __syncthreads();
      stream_template<kSx>(s + tSx, Sx + q0 * kSx, nv * kSx);
      stream_template<kBs>(s + tBs, Bs + q0 * kBs, nv * kBs);
      stream_template<kJup>(s + tJup, Jup + q0 * kJup, nv * kJup);
      T* jo = Jxp + q0 * kJxp;
      for (int i = tid; i < nv * kJxp; i += kThreads) {
        const int w = i / kJxp, e = i - w * kJxp;
        const T t = s[tJxp + e];
        const int kind = scale[e / nx];
        const T* p = rec + w * kRec + rP;
        const T f = kind == kMask ? p[lip::kP_mt]
                                  : p[lip::Param<S>::cs + (kind - kCs)];
        jo[i] = (kind == kNone || t == T(0)) ? t : t * f;
      }
      T* ro = rho + q0 * nr;
      for (int i = tid; i < nv * nr; i += kThreads) {
        const int w = i / nr;
        const T* r = rec + w * kRec;
        ro[i] = lip::stage_rho_row<S>(i - w * nr, r + rX, r + rU, r + rP, k);
      }
      T* dd = dfx + q0 * nx;
      for (int i = tid; i < nv * nx; i += kThreads) {
        const int w = i / nx, j = i - w * nx;
        const T* r = rec + w * kRec;
        dd[i] = (r[rX + j] + k.dt * lip::xdot_row<S>(j, r + rX, r + rU, k)) -
                r[rXn + j];
      }
    } else {                               // kNodes members' terminal pairs
      const long long b0 = static_cast<long long>(grp - n_stage) * kNodes;
      const int nv = B - b0 < kNodes ? static_cast<int>(B - b0) : kNodes;
      for (int i = tid; i < nv * kRec; i += kThreads) {
        const int w = i / kRec, e = i - w * kRec;
        const size_t row = static_cast<size_t>(b0 + w) * (ns + 1) + ns;
        if (e < rXn) rec[i] = X[row * nx + e];
        else if (e >= rP) rec[i] = *lip::param_src<S>(P, row, e - rP);
      }
      __syncthreads();
      stream_template<kJt>(s + tJt, Jt + b0 * kJt, nv * kJt);
      T* ro = rt + b0 * nt;
      for (int i = tid; i < nv * nt; i += kThreads) {
        const int w = i / nt;
        const T* r = rec + w * kRec;
        ro[i] = lip::tracking_row<S>(i - w * nt, r + rX, r + rP, T(1), k);
      }
    }
  }
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

template <typename T>
int launch(const void* X, const void* U, const void* const* params,
           const void* table, int B, int ns, int nc, int cm, int n_legs,
           int n_rx, int n_ru, int n_gx, int n_gu, const double* scalars,
           void* Sx, void* Bs, void* Jxp, void* Jup, void* rho, void* d,
           void* rt, void* Jt, void* stream) {
  if (nc != S::nc || cm != S::cm || n_legs != S::n_legs || n_rx != S::n_rx ||
      n_ru != S::n_ru || n_gx != S::n_gx || n_gu != S::n_gu)
    return kUnknownShape;
  if (B == 0) return 0;
  const long long stage_nodes = static_cast<long long>(B) * ns;
  const long long n_stage = (stage_nodes + kNodes - 1) / kNodes;
  const long long n_term = (B + kNodes - 1) / kNodes;
  const long long n_groups = n_stage + n_term;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(n_groups < cap ? n_groups : cap);
  const size_t bytes = smem_bytes<T>();
  auto kernel = lip_linearize_kernel<T>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U),
      lip::make_params<T>(params), static_cast<const int*>(table), B, ns,
      static_cast<int>(n_stage), static_cast<int>(n_groups),
      lip::make_consts<T>(scalars), static_cast<T*>(Sx), static_cast<T*>(Bs),
      static_cast<T*>(Jxp), static_cast<T*>(Jup), static_cast<T*>(rho),
      static_cast<T*>(d), static_cast<T*>(rt), static_cast<T*>(Jt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LINEARIZE_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* X, const void* U,                           \
                      const void* const* params, const void* table, int B,    \
                      int ns, int nc, int cm, int n_legs, int n_rx, int n_ru, \
                      int n_gx, int n_gu, const double* scalars, void* Sx,    \
                      void* Bs, void* Jxp, void* Jup, void* rho, void* d,     \
                      void* rt, void* Jt, void* stream) {                     \
    return launch<T>(X, U, params, table, B, ns, nc, cm, n_legs, n_rx, n_ru,  \
                     n_gx, n_gu, scalars, Sx, Bs, Jxp, Jup, rho, d, rt, Jt,   \
                     stream);                                                 \
  }

LINEARIZE_ENTRY(lip_linearize_f32, float)
LINEARIZE_ENTRY(lip_linearize_f64, double)

// K10's occupancy for float32 (f64 = 0) or float64 tensors into
// out[0..4]: blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the grid takes at most
// kBlocksPerSm of them an SM), warps a block, shared memory bytes a block,
// registers and local (spilled) bytes a thread.
template <typename T>
int occupancy(int* out) {
  const size_t bytes = smem_bytes<T>();
  auto kernel = lip_linearize_kernel<T>;
  cudaError_t e = cudaSuccess;
  if (bytes > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads,
                                                      bytes);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  out[1] = kThreads / 32;
  out[2] = static_cast<int>(bytes);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}

extern "C" int lip_linearize_occupancy(int f64, int* out) {
  return f64 ? occupancy<double>(out) : occupancy<float>(out);
}
