"""K12: the backward value recursion as an associative scan, then the gains
(`DDPOptions.riccati_mode="associative"`).

`riccati_associative` is the wrapper the solver calls. A CPU tensor goes to
`riccati_associative_plain`, the line-for-line PyTorch transcription of the
JAX package's `MSDDP._backward_associative`
(srbd_horizon_tpu/solvers/msddp.py:1250-1387); a CUDA tensor launches the
hand-written kernel in `csrc/riccati_associative.cu`, or raises. Both take
what K1 (`kernels/riccati.py`) takes — the sliced linearization and its
`RiccatiRows` — and return what it returns: ks (B,ns,nu), Ks (B,ns,nu,nx),
dV1 (B,), dV2 (B,).

The JAX function reads the dense linearization. The twin first forms it
from the sliced one: A = I + Sx on the rows rx, B = Bs on the rows ru and
the columns uc, and the Gauss–Newton quadratics over the residual rows gx
and gu (the rows JAX's dense Jacobians hold outside those sets are exact
zeros). Then, per node, R̃ = luu + μI is solved against [lu | lux | Bᵀ]
with `quu_solver` (the block-Schur `spd_solve` or a Cholesky solve), the
value elements (A, b, C, η, J) are formed, the terminal element is
(0, 0, 0, 2Jtᵀrt, 2JtᵀJt), and a reverse associative scan composes them
into each node's value function; the gains follow per node from V at
n + 1.

The scan is JAX's own tree: `odd_even_scan` is the recursion of
`lax.associative_scan` (jax/_src/lax/control_flow/loops.py, `_scan`), so
the twin makes the same combines on the same operands in the same order
(34 for the 21 elements of ns = 20). `scan_plan` records that tree as the
kernel's table: each combine's output slot and its two operands, grouped
by dependency depth (6 stages at ns = 20), one kernel launch a stage.

On the card every product and Gram of the three phases runs on the FP64
tensor cores, and a combine eliminates its (I + C₁J₂) system as a blocked
right-looking LU with partial pivoting, panels of 6 columns, with a
blocked back substitution. `phase_bytes` states the shared memory a block
of each phase takes, as the .cu lays it out: the combine's 74,740 B at
nx = 37 let three blocks share an SM (`COMBINE_BLOCKS_PER_SM`); the
element and gain blocks put the inverse, its workspace and the solution
where the residual rows and the value-function products were once those
are consumed, so that four share an SM at the nx = 37 SRBD shapes and the
element block of the isrbd-AL shapes fits two (≤ 115,712 B); `occupancy`
reads the same figures, the blocks an SM, registers and spilled bytes of
each phase on the card.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from srbd_horizon_tpu_torch.kernels.build import check_tensor, library
from srbd_horizon_tpu_torch.kernels.riccati import (
    KERNEL_SHAPES,
    QUU_SOLVERS,
    RiccatiRows,
    kernel_shape,
)
from srbd_horizon_tpu_torch.math.linalg import cho_factor, cho_solve, spd_solve

# the JAX function K12 replaces (XLA-fused; the JAX package wrote no
# Pallas kernel for it)
REPLACES = "srbd_horizon_tpu/solvers/msddp.py:1250"
SOURCE = "srbd_horizon_tpu_torch/csrc/riccati_associative.cu"

# K12's instantiations, in the order of the .cu's `with_instance`: (K1's
# shape name, gain solve). Both gain solves at the six SRBD and the six LIP
# shapes (the RK2 and RK4 steps share K1's shape); Cholesky alone at the two
# isrbd-AL shapes, whose only caller, the AL solver's inner solve, always
# takes it. Indices are appended, never reordered. CUDA tensors of other
# sizes or another gain solve raise ValueError.
KERNEL_INSTANCES = (
    ("srbd", "schur"),
    ("srbd", "cholesky"),
    ("lip", "schur"),
    ("lip", "cholesky"),
    ("quadruped", "schur"),
    ("quadruped", "cholesky"),
    ("isrbd_al", "cholesky"),
    ("isrbd_al_quadruped", "cholesky"),
    ("point_feet", "schur"),
    ("point_feet", "cholesky"),
    ("srbd_rk", "schur"),
    ("srbd_rk", "cholesky"),
    ("quadruped_rk", "schur"),
    ("quadruped_rk", "cholesky"),
    ("point_feet_rk", "schur"),
    ("point_feet_rk", "cholesky"),
) + tuple((shape, solver)
          for shape in ("lip_rk", "lip_quadruped", "lip_quadruped_rk",
                        "lip_point_feet", "lip_point_feet_rk")
          for solver in ("schur", "cholesky"))
# the launchers' own errors, as K1's (kernels/riccati.py)
SMEM_EXCEEDED = -1
UNKNOWN_SHAPE = -2
# the combine's blocks an SM, as its launch bound asks
# (csrc/riccati_associative.cu kCombineBlocks)
COMBINE_BLOCKS_PER_SM = 3


def lead(n: int) -> int:
    """The .cu's `lead`: a row stride of at least n doubles that is 4 mod
    8."""
    return n + (12 - n % 8) % 8


def inv_work(n: int) -> int:
    """riccati_common.cuh's `inv_work`: K2's float64 workspace at n×n."""
    if n <= 3:
        return 0
    k, m = n // 2, n - n // 2
    return k * m * 2 + m * m + max(inv_work(k), inv_work(m))


def phase_bytes(shape: str, quu_solver: str) -> Dict[str, int]:
    """The shared memory bytes a block of each phase takes at K1's shape
    `shape` with the gain solve `quu_solver`, as csrc/riccati_associative.cu
    lays them out (`ElemSmem`, `CombineSmem`, `GainSmem`)."""
    z = KERNEL_SHAPES[shape]
    nx, nu = z["nx"], z["nu"]
    schur = int(quu_solver == "schur")
    rows = (z["n_rx"] + z["n_ru"] + z["n_gx"] + z["n_gu"] + 2 * z["n_b"]
            + z["n_uc"] + nu + 2 * nx)
    sliced = z["n_rx"] * nx + z["n_ru"] * z["n_uc"]
    element = (sliced + 2 * nx + nu + nx * nx + nu * nu + nu * nx
               + max(z["n_gx"] * nx + z["n_gu"] * nu + z["n_gx"] + z["n_gu"],
                     nu * nu + max(schur * inv_work(nu), nu * (1 + 2 * nx))))
    combine = nx * lead(3 * nx + 1) + 3 * nx * lead(nx) + 4 * nx
    gain = (sliced + nu + nu * nx + nu * nu
            + max(3 * nx + 2 * nx * nx + nx * nu,
                  nu * nu + schur * inv_work(nu) + nu * (1 + nx)))
    return dict(element=element * 8 + rows * 4, combine=combine * 8 + nx * 4,
                gain=gain * 8 + rows * 4 + 4)


def odd_even_scan(fn, elems: List) -> List:
    """The inclusive scan of `elems` under the associative `fn`, by the
    recursion of JAX's `lax.associative_scan`: combine adjacent pairs,
    scan the half recursively, then combine its results with the even
    elements, and interleave. `fn(a, b)` gets a from the lower index."""
    n = len(elems)
    if n < 2:
        return list(elems)
    reduced = [fn(elems[2 * i], elems[2 * i + 1]) for i in range(n // 2)]
    odd = odd_even_scan(fn, reduced)
    m = len(odd) - 1 if n % 2 == 0 else len(odd)
    even = [elems[0]] + [fn(odd[i], elems[2 * i + 2]) for i in range(m)]
    out = []
    for i, e in enumerate(even):
        out.append(e)
        if i < len(odd):
            out.append(odd[i])
    return out


def reverse_scan(combine, elems: List) -> List:
    """JAX's `lax.associative_scan(lambda a, b: combine(b, a), elems,
    reverse=True)`: each entry n is elems[n] composed with every later
    one, `combine(earlier, later)`."""
    return odd_even_scan(lambda a, b: combine(b, a), elems[::-1])[::-1]


def scan_plan(ns: int) -> Tuple[List[List[Tuple[int, int, int]]], List[int]]:
    """The reverse scan over the ns + 1 elements as a table: element n in
    slot n, the combines' results in slots ns + 1, ns + 2, … in JAX's
    order. Returns the combines (out, earlier, later) grouped by stage —
    stage s holds those whose operands are ready after stage s − 1 — and
    each node's suffix slot."""
    depth = {n: 0 for n in range(ns + 1)}
    made: List[Tuple[int, int, int]] = []

    def combine(earlier, later):
        out = ns + 1 + len(made)
        made.append((out, earlier, later))
        depth[out] = 1 + max(depth[earlier], depth[later])
        return out

    suffix = reverse_scan(combine, list(range(ns + 1)))
    stages = [[c for c in made if depth[c[0]] == s]
              for s in range(1, max(depth.values(), default=0) + 1)]
    return stages, suffix


def dense_dynamics(Sx, Bs, rows: RiccatiRows, nu: int):
    """The dense A = I + Sx on the rows rx (B,ns,nx,nx) and B = Bs on the
    rows ru and the columns uc (B,ns,nx,nu) of the sliced ones."""
    Bsz, ns, _, nx = Sx.shape
    dtype, dev = Sx.dtype, Sx.device
    idx = rows.index(dev)
    A = torch.eye(nx, dtype=dtype, device=dev).expand(Bsz, ns, nx, nx)
    A = A.index_add(2, idx["rx"], Sx)
    Bu = Bs.new_zeros((Bsz, ns, len(rows.ru), nu)).index_copy(3, idx["uc"], Bs)
    return A, Bs.new_zeros((Bsz, ns, nx, nu)).index_copy(2, idx["ru"], Bu)


def gn_quadratics(Jxp, Jup, rho, rows: RiccatiRows):
    """The Gauss–Newton quadratics lx, lu, lxx, luu, lux of each node over
    the residual rows gx and gu (their rows in both for lux)."""
    idx = rows.index(rho.device)
    rx_ = rho.index_select(-1, idx["gx"])
    ru_ = rho.index_select(-1, idx["gu"])
    lx = 2.0 * torch.einsum("bnrx,bnr->bnx", Jxp, rx_)
    lu = 2.0 * torch.einsum("bnru,bnr->bnu", Jup, ru_)
    lxx = 2.0 * torch.einsum("bnrx,bnry->bnxy", Jxp, Jxp)
    luu = 2.0 * torch.einsum("bnru,bnrv->bnuv", Jup, Jup)
    lux = 2.0 * torch.einsum("bnru,bnrx->bnux",
                             Jup.index_select(2, idx["bu"]),
                             Jxp.index_select(2, idx["bx"]))
    return lx, lu, lxx, luu, lux


def combine_plain(e1: Dict, e2: Dict) -> Dict:
    """`_backward_associative`'s `combine` (msddp.py:1315-1358): e1 covers
    the earlier interval, e2 the suffix toward T; batch dims lead."""
    nx = e1["A"].shape[-1]
    eye = torch.eye(nx, dtype=e1["A"].dtype, device=e1["A"].device)
    CJ = torch.einsum("...xy,...yz->...xz", e1["C"], e2["J"])
    M = torch.linalg.solve(
        eye + CJ,
        torch.cat([e1["A"], e1["C"],
                   (e1["b"] - torch.einsum("...xy,...y->...x", e1["C"],
                                           e2["eta"]))[..., None]], dim=-1))
    MA1, MC1, Mb = M[..., :, :nx], M[..., :, nx:-1], M[..., :, -1]
    A12 = torch.einsum("...xy,...yz->...xz", e2["A"], MA1)
    b12 = torch.einsum("...xy,...y->...x", e2["A"], Mb) + e2["b"]
    C12 = torch.einsum("...xy,...zy->...xz",
                       torch.einsum("...xy,...yz->...xz", e2["A"], MC1),
                       e2["A"]) + e2["C"]
    J2MA1 = torch.einsum("...xy,...yz->...xz", e2["J"], MA1)
    eta12 = torch.einsum(
        "...yx,...y->...x", MA1,
        e2["eta"] + torch.einsum("...xy,...y->...x", e2["J"], e1["b"])) + e1["eta"]
    J12 = torch.einsum("...yx,...yz->...xz", e1["A"], J2MA1) + e1["J"]
    return dict(A=A12, b=b12, C=C12, eta=eta12, J=J12)


def _gain_solve(quu_solver: str):
    if quu_solver not in QUU_SOLVERS:
        raise ValueError(f"quu_solver={quu_solver!r}: one of {QUU_SOLVERS}")
    if quu_solver == "schur":
        return spd_solve
    return lambda A, rhs: cho_solve(cho_factor(A), rhs)


def riccati_associative_plain(Sx, Bs, Jxp, Jup, rho, d, Jt, rt, mu: float,
                              rows: RiccatiRows, quu_solver: str = "schur"):
    """Plain PyTorch K12 (shapes as `riccati.riccati_backward_plain`):
    ks (B,ns,nu), Ks (B,ns,nu,nx), dV1 (B,), dV2 (B,)."""
    solve = _gain_solve(quu_solver)
    Bsz, ns, nx = d.shape
    nu = Jup.shape[-1]
    dtype, dev = d.dtype, d.device
    A, Bd = dense_dynamics(Sx, Bs, rows, nu)
    lx, lu, lxx, luu, lux = gn_quadratics(Jxp, Jup, rho, rows)
    Rt = luu + mu * torch.eye(nu, dtype=dtype, device=dev)
    rhs = torch.cat([lu[..., None], lux, Bd.transpose(-1, -2)], dim=-1)
    sol = solve(Rt, rhs)
    Ri_lu, Ri_lux, Ri_Bt = sol[..., 0], sol[..., 1:1 + nx], sol[..., 1 + nx:]
    eA = A - torch.einsum("bnxu,bnuy->bnxy", Bd, Ri_lux)
    eJ = lxx - torch.einsum("bnux,bnuy->bnxy", lux, Ri_lux)
    eEta = lx - torch.einsum("bnux,bnu->bnx", lux, Ri_lu)
    eB = d - torch.einsum("bnxu,bnu->bnx", Bd, Ri_lu)
    eC = torch.einsum("bnxu,bnuy->bnxy", Bd, Ri_Bt)
    Vx_T = 2.0 * torch.einsum("brx,br->bx", Jt, rt)
    Vxx_T = 2.0 * torch.einsum("brx,bry->bxy", Jt, Jt)
    zm = Vxx_T.new_zeros((Bsz, nx, nx))
    elems = [dict(A=eA[:, n], b=eB[:, n], C=eC[:, n], eta=eEta[:, n],
                  J=eJ[:, n]) for n in range(ns)]
    elems.append(dict(A=zm, b=zm[..., 0], C=zm, eta=Vx_T, J=Vxx_T))
    suffix = reverse_scan(combine_plain, elems)
    Vxx1 = torch.stack([s["J"] for s in suffix[1:]], dim=1)
    Vx1 = torch.stack([s["eta"] for s in suffix[1:]], dim=1)
    Vx_d = Vx1 + torch.einsum("bnxy,bny->bnx", Vxx1, d)
    Qu = lu + torch.einsum("bnxu,bnx->bnu", Bd, Vx_d)
    Qux = lux + torch.einsum("bnxu,bnxy->bnuy", Bd,
                             torch.einsum("bnxy,bnyz->bnxz", Vxx1, A))
    Quu = Rt + torch.einsum("bnxu,bnxv->bnuv", Bd,
                            torch.einsum("bnxy,bnyu->bnxu", Vxx1, Bd))
    kK = -solve(Quu, torch.cat([Qu[..., None], Qux], dim=-1))
    ks, Ks = kK[..., 0], kK[..., 1:]
    dV1 = torch.einsum("bnu,bnu->b", ks, Qu)
    dV2 = 0.5 * torch.einsum("bnu,bnu->b", ks,
                             torch.einsum("bnuv,bnv->bnu", Quu, ks))
    return ks.contiguous(), Ks.contiguous(), dV1, dV2


_P = ctypes.c_void_p
_I = ctypes.c_int
_plans: Dict[tuple, tuple] = {}


def kernel_instance(nx: int, nu: int, nt: int, rows: RiccatiRows,
                    quu_solver: str) -> int:
    """The index in `KERNEL_INSTANCES` for these sizes (K1's shape names)
    and gain solve; ValueError, naming what was compiled, if none."""
    return shape_instance(kernel_shape(nx, nu, nt, rows), quu_solver)


def shape_instance(shape: str, quu_solver: str) -> int:
    """The index in `KERNEL_INSTANCES` for K1's shape name `shape` and the
    gain solve; ValueError, naming what was compiled, if none."""
    key = (shape, quu_solver)
    if key not in KERNEL_INSTANCES:
        raise ValueError(
            f"riccati_associative has no kernel for {key}; it is compiled for "
            f"{KERNEL_INSTANCES} (csrc/riccati_associative.cu)")
    return KERNEL_INSTANCES.index(key)


def _plan(ns: int, device):
    """The scan's table on `device` (built once per ns): the combines,
    stage after stage, as an int32 (34, 3) tensor for ns = 20, the
    combines a stage as a ctypes array, and the suffix slots (ns+1,)."""
    key = (ns, str(device))
    if key not in _plans:
        stages, suffix = scan_plan(ns)
        flat = [c for st in stages for c in st]
        table = torch.tensor(flat if flat else [(0, 0, 0)], dtype=torch.int32,
                             device=device)
        counts = (_I * max(len(stages), 1))(*[len(st) for st in stages])
        _plans[key] = (table, counts, len(stages), len(flat),
                       torch.tensor(suffix, dtype=torch.int32, device=device))
    return _plans[key]


def launches_per_sweep(ns: int) -> int:
    """Kernel launches one sweep makes: the elements, a launch a scan
    stage, the gains."""
    return 2 + len(scan_plan(ns)[0])


def _kernel_fn(dtype):
    lib = library("riccati_associative")
    fn = (lib.riccati_associative_f32 if dtype == torch.float32
          else lib.riccati_associative_f64)
    if fn.argtypes is None:
        fn.argtypes = ([_I] + [_P] * 9 + [_I] * 12 + [ctypes.c_double]
                       + [_P, _P, _I] + [_P] * 10)
        fn.restype = _I
    return fn


def occupancy(nx: int, nu: int, nt: int, rows: RiccatiRows,
              quu_solver: str = "schur", dtype=torch.float32) -> dict:
    """Shared memory bytes a block, blocks resident on one SM, registers
    and local (spilled) bytes a thread of each phase (element, combine,
    gain) on the current card."""
    fn = library("riccati_associative").riccati_associative_occupancy
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
        fn.restype = _I
    out = (ctypes.c_int * 12)()
    err = fn(kernel_instance(nx, nu, nt, rows, quu_solver),
             int(dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"riccati_associative occupancy failed: error {err}")
    fields = ("shared_memory_bytes", "blocks_per_sm", "registers",
              "local_bytes")
    return {f"{p}_{f}": out[3 * k + i]
            for k, f in enumerate(fields)
            for i, p in enumerate(("element", "combine", "gain"))}


def riccati_associative(Sx, Bs, Jxp, Jup, rho, d, Jt, rt, mu: float,
                        rows: RiccatiRows, quu_solver: str = "schur"):
    """K12. Same contract as `riccati_associative_plain`; launches the CUDA
    kernels for CUDA tensors (one sweep, counted once in
    `riccati_associative.launches`; `launches_per_sweep` kernel launches)
    at the sizes and gain solve of an instantiation in
    `KERNEL_INSTANCES`, and raises ValueError at any other. It computes in
    float64 for float32 tensors too, as K1 does."""
    if d.device.type == "cpu":
        return riccati_associative_plain(Sx, Bs, Jxp, Jup, rho, d, Jt, rt, mu,
                                         rows, quu_solver)
    if d.device.type != "cuda":
        raise ValueError(f"riccati_associative runs on cpu or cuda, got {d.device}")
    dtype, dev = d.dtype, d.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"riccati_associative takes float32 or float64, got {dtype}")
    Bsz, ns, nx = d.shape
    nu, nr, nt = Jup.shape[-1], rho.shape[-1], Jt.shape[-2]
    inst = kernel_instance(nx, nu, nt, rows, quu_solver)
    n_rx, n_ru, n_gx, n_gu, n_b, n_uc = (
        len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu), len(rows.bx),
        len(rows.uc))
    check_tensor("Sx", Sx, (Bsz, ns, n_rx, nx), dtype, dev)
    check_tensor("Bs", Bs, (Bsz, ns, n_ru, n_uc), dtype, dev)
    check_tensor("Jxp", Jxp, (Bsz, ns, n_gx, nx), dtype, dev)
    check_tensor("Jup", Jup, (Bsz, ns, n_gu, nu), dtype, dev)
    check_tensor("rho", rho, (Bsz, ns, nr), dtype, dev)
    check_tensor("d", d, (Bsz, ns, nx), dtype, dev)
    check_tensor("Jt", Jt, (Bsz, nt, nx), dtype, dev)
    check_tensor("rt", rt, (Bsz, nt), dtype, dev)
    plan, counts, n_stages, n_comb, suffix = _plan(ns, dev)
    f64 = torch.float64
    elems = torch.empty((ns + 1 + n_comb, Bsz, 3 * nx * nx + 2 * nx),
                        dtype=f64, device=dev)
    gains = torch.empty((Bsz, ns, nu + nu * nx + nu * nu), dtype=f64,
                        device=dev)
    terms = torch.empty((Bsz, ns, 2), dtype=f64, device=dev)
    counters = torch.empty((Bsz,), dtype=torch.int32, device=dev)
    ks = torch.empty((Bsz, ns, nu), dtype=dtype, device=dev)
    Ks = torch.empty((Bsz, ns, nu, nx), dtype=dtype, device=dev)
    dV1 = torch.empty((Bsz,), dtype=dtype, device=dev)
    dV2 = torch.empty((Bsz,), dtype=dtype, device=dev)
    fn = _kernel_fn(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            inst, Sx.data_ptr(), Bs.data_ptr(), Jxp.data_ptr(), Jup.data_ptr(),
            rho.data_ptr(), d.data_ptr(), Jt.data_ptr(), rt.data_ptr(),
            rows.packed(dev).data_ptr(),
            Bsz, ns, nx, nu, nr, nt, n_rx, n_ru, n_gx, n_gu, n_b, n_uc,
            float(mu), plan.data_ptr(), counts, n_stages, suffix.data_ptr(),
            elems.data_ptr(), gains.data_ptr(), terms.data_ptr(),
            counters.data_ptr(), ks.data_ptr(), Ks.data_ptr(), dV1.data_ptr(),
            dV2.data_ptr(), stream)
    if err == SMEM_EXCEEDED:
        raise RuntimeError("riccati_associative needs more shared memory a "
                           "block than this card allows")
    if err == UNKNOWN_SHAPE:
        raise ValueError(f"riccati_associative: instantiation {inst} does not "
                         f"take the sizes nx={nx}, nu={nu}, nt={nt}")
    if err != 0:
        raise RuntimeError(f"riccati_associative kernel failed: error {err}")
    riccati_associative.launches += 1
    riccati_associative.instance_launches[inst] += 1
    return ks, Ks, dV1, dV2


riccati_associative.launches = 0
# the sweeps of each instantiation, indexed as KERNEL_INSTANCES
riccati_associative.instance_launches = [0] * len(KERNEL_INSTANCES)
