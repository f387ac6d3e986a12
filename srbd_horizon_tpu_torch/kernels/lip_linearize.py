"""K10: the closed-form sliced linearization of the LIP problem.

`lip_linearize` is the wrapper the solver calls. A CPU tensor goes to
`lip_linearize_plain`, the batched closed form in plain PyTorch; a CUDA
tensor launches the hand-written kernel in `csrc/lip_linearize.cu`, or
raises.

Both compute, in the batch-first layout K1 reads, what the JAX package's
dense `MSDDP._linearize_impl` (srbd_horizon_tpu/solvers/msddp.py:200-246,
`jax.jacfwd` of the Euler step and of `_stage_rho`; the JAX LIP problem
declares no row sparsity) computes, sliced by the rows
`problems/lip.py::row_sets` declares, per member b and node n:

    Sx  = dt·(∂ẋ/∂x)[rx]  (B,ns,|rx|,nx)    Bs  = dt·(∂ẋ/∂u)[ru]  (B,ns,|ru|,nu)
    Jxp = (∂ρ/∂x)[gx]     (B,ns,|gx|,nx)    Jup = (∂ρ/∂u)[gu]     (B,ns,|gu|,nu)
    ρ   = [residual; √w_c·eq]  (B,ns,nr)     d   = x + dt·ẋ − X[n+1]  (B,ns,nx)
    rt  = terminal residual (B,10)          Jt  = ∂rt/∂x (B,10,nx)

The LIP is linear–quadratic: every Jacobian entry is a constant of dt, η²,
1/nc and the weights, except the tracking rows, which `mask_track`
scales, and the ċxy equality rows, which `cdot_switch` scales (those
rows are live at node 0 too: zmp and r̈, c̈ are never masked).

What bounds the kernel on an H100: bytes — a member-node writes 2,069
values (Sx 540, Bs 225, Jxp 960, Jup 270, ρ 44, d 30) and reads 87, and
computes almost nothing (the note in the .cu gives the design).

K10, K11 and lip_evaluate are compiled for one set of LIP sizes
(`lip::Shape` in csrc/lip_common.cuh, `KERNEL_SHAPE` here); their wrappers
raise ValueError, naming the sizes, for CUDA tensors of any other, and
take the plain twin for CPU tensors of any sizes.
"""

from __future__ import annotations

import ctypes

import torch

from srbd_horizon_tpu_torch.kernels.build import check_tensor, host_setup, library
from srbd_horizon_tpu_torch.problems.lip import N_TERMINAL

# the function K10 replaces (jacfwd under vmap, XLA-fused; the JAX package
# wrote no Pallas kernel for it)
REPLACES = "srbd_horizon_tpu/solvers/msddp.py:200"
SOURCE = "srbd_horizon_tpu_torch/csrc/lip_linearize.cu"

# The sizes K10, K11 and lip_evaluate are compiled for (`lip::Shape` in
# csrc/lip_common.cuh): build_lip_problem with the Kangaroo feet. The row
# counts are K10's (`RiccatiRows.from_ocp` of that OCP).
KERNEL_SHAPE = dict(nc=4, cm=2, n_legs=2, nx=30, nu=15, n_rho=44, nt=10,
                    n_rx=18, n_ru=15, n_gx=32, n_gu=18)

# the parameter rows the residuals read, in the kernels' order
PARAM_KEYS = ("mask_track", "rdot_ref", "c_ref", "cdot_switch")
N_SCALARS = 13       # LIPTerms.kernel_scalars


def kernel_sizes(terms, nx: int, nu: int, rows=None):
    """The sizes a LIP kernel would be compiled for: the problem's, and
    with `rows` (a `RiccatiRows`) the row counts K10 emits."""
    sizes = dict(nc=terms.nc, cm=terms.contact_model,
                 n_legs=terms.number_of_legs, nx=nx, nu=nu,
                 n_rho=terms.n_rho, nt=N_TERMINAL)
    if rows is not None:
        sizes.update(n_rx=len(rows.rx), n_ru=len(rows.ru),
                     n_gx=len(rows.gx), n_gu=len(rows.gu))
    return sizes


def check_kernel_shape(name: str, terms, nx: int, nu: int, rows=None):
    """Raise ValueError, naming the sizes, unless they are those the LIP
    kernels are compiled for (`KERNEL_SHAPE`)."""
    sizes = kernel_sizes(terms, nx, nu, rows)
    if sizes != {k: KERNEL_SHAPE[k] for k in sizes}:
        raise ValueError(
            f"{name} has no kernel for the sizes {sizes}; it is compiled for "
            f"{KERNEL_SHAPE} (csrc/lip_common.cuh)")


def kernel_params(params, Bsz, ns, nc, dtype, device):
    """The four parameter tensors a kernel reads, checked: each
    (B, ns+1, dim), contiguous, on `device` and of `dtype`."""
    out = []
    for key, dim in zip(PARAM_KEYS, (1, 3, nc, nc)):
        check_tensor(key, params[key], (Bsz, ns + 1, dim), dtype, device)
        out.append(params[key])
    return out


def _rel_pairs(terms):
    """(row, a, b) of the four rel rows: the row is w·((−c[a] + c[b]) − d),
    a and b offsets into c."""
    cm, nc = terms.contact_model, terms.nc
    return ((0, 1, 3 * cm + 1), (1, 0, 3 * cm),
            (2, 3 * (cm - 1) + 1, 3 * (nc - 1) + 1),
            (3, 3 * (cm - 1), 3 * (nc - 1)))


def _tracking_jac(J, terms, mt, row_rel):
    """The tracking rows rz, rxy, ṙ (rows 0:6) and the rel rows (from
    `row_rel`) of ∂ρ/∂x, scaled by mt, into J (…, rows, nx)."""
    nc = terms.nc
    i_rdot = 3 + 3 * nc
    w_r = mt * terms.w_r
    J[..., 0, 2] = w_r
    for j in range(2):
        J[..., 1 + j, j] = w_r
        for k in range(nc):
            J[..., 1 + j, 3 + 3 * k + j] = -w_r / nc
    for j in range(3):
        J[..., 3 + j, i_rdot + j] = mt * terms.w_rdot
    w_rel = mt * terms.w_rel
    for g, a, b in _rel_pairs(terms):
        J[..., row_rel + g, 3 + a] -= w_rel
        J[..., row_rel + g, 3 + b] += w_rel


def lip_linearize_plain(X, U, params, terms, rows, dt: float, wc: float):
    """Plain PyTorch K10. X (B,ns+1,nx), U (B,ns,nu), params leaves
    (B,ns+1,dim), `terms` the problem's `LIPTerms`, `rows` its
    `RiccatiRows`, wc = √w_c in the working dtype. Returns the dict
    Sx, Bs, Jxp, Jup, rho, rt, Jt, d (contiguous, batch-first)."""
    Bsz, ns1, nx = X.shape
    ns, nu, nc = ns1 - 1, U.shape[-1], terms.nc
    cm, n_legs = terms.contact_model, terms.number_of_legs
    i_rdot, i_cdot = 3 + 3 * nc, 6 + 3 * nc
    n_res, nr = terms.n_res, terms.n_rho
    eta2 = terms.eta2
    idx = rows.index(X.device)
    lead = (Bsz, ns)

    x = X[:, :ns]
    p = {k: params[k][:, :ns] for k in PARAM_KEYS}

    # ∂ẋ/∂x and ∂ẋ/∂u (constants)
    Jxd = X.new_zeros(lead + (nx, nx))
    Jud = X.new_zeros(lead + (nx, nu))
    for j in range(3):
        Jxd[..., j, i_rdot + j] = 1.0
        Jxd[..., i_rdot + j, j] = eta2
        Jud[..., i_rdot + j, j] = -eta2
    for q in range(3 * nc):
        Jxd[..., 3 + q, i_cdot + q] = 1.0
        Jud[..., i_cdot + q, 3 + q] = 1.0

    # ∂ρ/∂x and ∂ρ/∂u of the stacked stage residual
    mt = p["mask_track"][..., 0]
    cs = p["cdot_switch"]
    Jrx = X.new_zeros(lead + (nr, nx))
    _tracking_jac(Jrx, terms, mt, 9)
    for j in range(3):
        for k in range(nc):
            Jrx[..., 6 + j, 3 + 3 * k + j] = -terms.w_zmp / nc
        Jrx[..., 13 + j, j] = terms.w_qddot * eta2
    row = n_res
    for leg in range(n_legs):
        base = leg * cm
        for i in range(1, cm):
            for ax in (0, 1):
                Jrx[..., row, i_cdot + 3 * base + ax] = wc * 1.0
                Jrx[..., row, i_cdot + 3 * (base + i) + ax] = wc * -1.0
                row += 1
    for k in range(nc):
        Jrx[..., row + k, 3 + 3 * k + 2] = wc * 1.0
    row += nc
    for k in range(nc):
        for ax in (0, 1):
            Jrx[..., row, i_cdot + 3 * k + ax] = wc * cs[..., k]
            row += 1
    Jru = X.new_zeros(lead + (nr, nu))
    for j in range(3):
        Jru[..., 6 + j, j] = terms.w_zmp
        Jru[..., 13 + j, j] = -(terms.w_qddot * eta2)
    for q in range(3 * nc):
        Jru[..., 16 + q, 3 + q] = terms.w_qddot

    p_term = {k: params[k][:, ns] for k in PARAM_KEYS}
    xT = X[:, ns]
    Jt = X.new_zeros((Bsz, N_TERMINAL, nx))
    _tracking_jac(Jt, terms, torch.ones_like(xT[:, 0]), 6)
    return dict(
        Sx=(dt * Jxd).index_select(-2, idx["rx"]).contiguous(),
        Bs=(dt * Jud).index_select(-2, idx["ru"]).contiguous(),
        Jxp=Jrx.index_select(-2, idx["gx"]).contiguous(),
        Jup=Jru.index_select(-2, idx["gu"]).contiguous(),
        rho=terms.stage_rho(x, U, p, wc).contiguous(),
        rt=terms.terminal_residual(xT, p_term).contiguous(),
        Jt=Jt,
        d=((x + dt * terms.xdot(x, U)) - X[:, 1:]).contiguous(),
    )


_P = ctypes.c_void_p
_I = ctypes.c_int


def _setup(terms, nx: int, nu: int, rows, dt: float, wc: float):
    """What lip_linearize checks and builds once for (terms, dtype): the
    sizes, and the scalars as a ctypes array."""
    check_kernel_shape("lip_linearize", terms, nx, nu, rows)
    return (ctypes.c_double * N_SCALARS)(*terms.kernel_scalars(dt, wc))


_kernel_fns = {}


def _kernel_fn(dtype):
    fn = _kernel_fns.get(dtype)
    if fn is None:
        lib = library("lip_linearize")
        fn = (lib.lip_linearize_f32 if dtype == torch.float32
              else lib.lip_linearize_f64)
        fn.argtypes = [_P] * 4 + [_I] * 9 + [_P] * 10
        fn.restype = _I
        _kernel_fns[dtype] = fn
    return fn


def occupancy(dtype=torch.float32):
    """K10's occupancy on the current card for tensors of `dtype`: blocks
    resident on one SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`;
    its grid takes at most four an SM), warps and shared memory bytes a
    block, registers and local (spilled) bytes a thread."""
    fn = library("lip_linearize").lip_linearize_occupancy
    if fn.argtypes is None:
        fn.argtypes = [_I, ctypes.POINTER(_I)]
        fn.restype = _I
    out = (_I * 5)()
    err = fn(int(dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"lip_linearize occupancy query failed: error {err}")
    return dict(blocks_per_sm=out[0], warps_per_block=out[1],
                shared_memory_bytes=out[2], registers_per_thread=out[3],
                local_bytes_per_thread=out[4])


def lip_linearize(X, U, params, terms, rows, dt: float, wc: float):
    """K10. Same contract as `lip_linearize_plain`; launches the CUDA
    kernel for CUDA tensors of the sizes `KERNEL_SHAPE` (and counts the
    launch in `lip_linearize.launches`), raises ValueError for other
    sizes."""
    if X.device.type == "cpu":
        return lip_linearize_plain(X, U, params, terms, rows, dt, wc)
    Bsz, ns1, nx = X.shape
    ns, nc, nu = ns1 - 1, terms.nc, U.shape[-1]
    dtype, dev = X.dtype, X.device
    n_rows = (len(rows.rx), len(rows.ru), len(rows.gx), len(rows.gu))
    scalars = host_setup(terms, ("lip_linearize", dtype, nx, nu, n_rows, dt,
                                 wc),
                         lambda: _setup(terms, nx, nu, rows, dt, wc))
    if dev.type != "cuda":
        raise ValueError(f"lip_linearize runs on cpu or cuda, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"lip_linearize takes float32 or float64, got {dtype}")
    check_tensor("X", X, (Bsz, ns + 1, nx), dtype, dev)
    check_tensor("U", U, (Bsz, ns, nu), dtype, dev)
    pt = kernel_params(params, Bsz, ns, nc, dtype, dev)
    n_rx, n_ru, n_gx, n_gu = n_rows
    nr = terms.n_rho
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
    out = dict(Sx=new(Bsz, ns, n_rx, nx), Bs=new(Bsz, ns, n_ru, nu),
               Jxp=new(Bsz, ns, n_gx, nx), Jup=new(Bsz, ns, n_gu, nu),
               rho=new(Bsz, ns, nr), d=new(Bsz, ns, nx),
               rt=new(Bsz, N_TERMINAL), Jt=new(Bsz, N_TERMINAL, nx))
    ptrs = (_P * len(pt))(*(t.data_ptr() for t in pt))
    fn = _kernel_fn(dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            X.data_ptr(), U.data_ptr(), ptrs, rows.packed(dev).data_ptr(),
            Bsz, ns, nc, terms.contact_model, terms.number_of_legs,
            n_rx, n_ru, n_gx, n_gu, scalars,
            *(out[k].data_ptr() for k in ("Sx", "Bs", "Jxp", "Jup", "rho",
                                           "d", "rt", "Jt")),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"lip_linearize kernel failed: CUDA error {err}")
    lip_linearize.launches += 1
    return out


lip_linearize.launches = 0
