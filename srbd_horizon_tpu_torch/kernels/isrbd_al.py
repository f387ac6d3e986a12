"""K7 and K8: the augmented-Lagrangian layer of the constrained serving
tick, four entries of `csrc/isrbd_al.cu`.

    isrbd_al_constraints   K7   the constraint pass at a solved plan, and
                                the multiplier update (online or offline)
    isrbd_al_shift         K8a  the warm start rolled one node, and the
                                multipliers seeded from the phase tables
    isrbd_al_params        K8b  the padded `al_*` tensors of the inner
                                solve's parameter dict
    isrbd_al_prior_update  K8c  the post-solve multipliers blended into
                                the phase tables (out of place)

`ALDDP` (solvers/alddp.py) calls the entries. Each takes its plain twin,
`<entry>_plain`, for CPU tensors, launches its kernel for CUDA tensors of
the sizes of a shape in `isrbd_linearize.KERNEL_SHAPES` (K7 picks it by the
contact topology, K8a-c are handed its index), and raises ValueError for
any other device or size: nothing falls back to a twin on the card. The twins
are the JAX package's functions (srbd_horizon_tpu/solvers/alddp.py) in
batch-first PyTorch, built from the pieces below (the bodies the `ALDDP`
methods of the same names held before the kernels):

    constraints_plain    `_constraints` (:376-410, under vmap): scaled h,
                         hT, the cones g and the per-member violation
    multipliers_plain    `_updated_multipliers` (:452-503)
    shift_plain          `shift_warmstart` (:585-605)
    seed_tail_plain, seed_full_plain       the priors' seeds (:621, :673)
    update_tail_plain, update_full_plain   the priors' updates (:639, :685)
    isrbd_al_params_plain                  `_params_with_multipliers` (:414)

The offline twin adds the penalty schedule of `solve_batch` (:547-552), the
online twin the equality update of `solve_online_batch` (:751-759).

Every twin counts toward `PLAIN_TWINS`, the names `chip_smoke.py`'s spy
wraps to show that no twin runs on the card on the constrained path.

K7 stages every value its mode reads into shared memory in one round
(`reads`, `run_count` and `constraints_smem_bytes` state that record as
csrc/isrbd_al.cu lays it out; a call that would not fit raises
ValueError), and a call's outputs are views of one buffer
(`output_layout`). Its host work that does not change between calls (the
shape check, the scalars, the layout, the static bounds' check) is done
once (`host_setup`).

K8a and K8b hold every value a member reads in registers, loaded in one
round before any store (csrc/isrbd_al.cu). K8a-c's host work is done once
for each size as well (`shift_setup`, `params_setup`, `prior_setup`: the
entry, the shapes, the output layout, K8b's static padded bounds, the
pointer arrays a call fills in place), and a call's outputs are views of
one buffer (`shift_layout`, `params_layout`, `prior_layout`).
"""

from __future__ import annotations

import ctypes

import torch

from srbd_horizon_tpu_torch.kernels.build import (
    EVALUATE_OCCUPANCY_FIELDS,
    OUT_ALIGN,
    check_tensor,
    check_tensors,
    host_setup,
    launch as _launch,
    layout_of,
    library,
    occupancy_query,
    out_slots as _out_slots,
    output_views,
)
from srbd_horizon_tpu_torch.kernels.isrbd_linearize import (
    check_kernel_shape,
    kernel_scalars,
    shape_index,
)
from srbd_horizon_tpu_torch.problems.isrbd_al import bound_violation

SOURCE = "srbd_horizon_tpu_torch/csrc/isrbd_al.cu"
# the JAX functions each entry replaces (XLA-fused in the jitted tick; the
# JAX package wrote no Pallas kernel for them)
REPLACES = "srbd_horizon_tpu/solvers/alddp.py:376"          # K7
SHIFT_REPLACES = "srbd_horizon_tpu/solvers/alddp.py:585"    # K8a
PARAMS_REPLACES = "srbd_horizon_tpu/solvers/alddp.py:414"   # K8b
PRIOR_REPLACES = "srbd_horizon_tpu/solvers/alddp.py:685"    # K8c

PLAIN_TWINS = (
    "constraints_plain", "multipliers_plain", "shift_plain",
    "seed_tail_plain", "seed_full_plain", "update_tail_plain",
    "update_full_plain", "isrbd_al_constraints_plain", "isrbd_al_shift_plain",
    "isrbd_al_params_plain", "isrbd_al_prior_update_plain",
)

# multiplier fields of ALState in K7's offline output order
MULTIPLIERS = ("lam_eq", "lam_eq_T", "mu_ub", "mu_lb", "mu_x_ub", "mu_x_lb",
               "mu_u_ub", "mu_u_lb")
# the node-indexed fields K8a rolls, after X and U
ROLLED = ("lam_eq", "mu_ub", "mu_lb", "mu_x_ub", "mu_x_lb", "mu_u_ub",
          "mu_u_lb")


def _roll(a):
    """Node j+1 moves to j along axis 1; the last row is repeated."""
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def _pad_node(a, value: float = 0.0):
    """(B, ns, dim) -> (B, ns+1, dim) with a constant last row."""
    pad = a.new_full((a.shape[0], 1) + tuple(a.shape[2:]), value)
    return torch.cat([a, pad], dim=1)


def _amax0(a):
    """Per-member max over all trailing axes, at least 0."""
    return torch.clamp(a.reshape(a.shape[0], -1).amax(dim=1), min=0.0)


def _rows_at(table, phase):
    """table (B, P, …) at each member's phase (B,) -> (B, …)."""
    return table[torch.arange(table.shape[0], device=table.device), phase]


def _with_rows(table, phase, rows):
    """`table` with each member's row `phase` replaced (out of place)."""
    out = table.clone()
    out[torch.arange(table.shape[0], device=table.device), phase] = rows
    return out


def _bcast(mask, like):
    """(B,) mask -> broadcastable against `like`."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def is_full(prior) -> bool:
    """A `FullPhasePrior` (whole-field tables), not a `PhasePrior`."""
    return "seen" in prior._fields


# ---------------- the twins' pieces ----------------

def constraints_plain(al, X, U, params):
    """h (B,ns,n_eq), hT (B,n_eq_T) in scaled units, g (B,ns,n_ineq)
    and the per-member max violation (B,)."""
    ocp, t = al.ocp, al.terms
    ns = ocp.ns
    p_stage = {k: v[:, :ns] for k, v in params.items()}
    # (u-box overrides have ns nodes and no terminal row)
    p_term = {k: v[:, ns] for k, v in params.items() if v.shape[1] > ns}
    h = t.stage_eq(X[:, :ns], U, p_stage)
    hT = t.terminal_eq(X[:, ns], p_term)
    g = ocp.stage_ineq(X[:, :ns], U, p_stage)
    x_lb, x_ub, u_lb, u_ub = al._bounds_from(params)
    viol = torch.stack([
        _amax0(h.abs()), _amax0(hT.abs()),
        _amax0(bound_violation(g, ocp.ineq_lb, ocp.ineq_ub)),
        _amax0(bound_violation(X, x_lb, x_ub)),
        _amax0(bound_violation(U, u_lb, u_ub)),
    ]).amax(dim=0)
    return h, hT, g, viol


def multipliers_plain(al, st, X, U, h, hT, g, params, rho):
    """AL multiplier updates; rho is (B,)."""
    r2 = rho[:, None]
    r3 = r2[:, :, None]
    w = al._w_eq if al._w_eq is not None else 1.0
    w_T = al._w_eq_T if al._w_eq_T is not None else 1.0
    lam_eq = st.lam_eq + r3 * w * h
    lam_eq_T = st.lam_eq_T + r2 * w_T * hT

    def side(mu, gap, bound):
        """max(0, μ + ρ·gap) where the bound is finite, else 0."""
        fin = torch.isfinite(bound)
        return torch.where(fin, torch.clamp(mu + r3 * gap, min=0.0),
                           torch.zeros_like(mu))

    def finite(b):
        return torch.where(torch.isfinite(b), b, torch.zeros_like(b))

    ocp = al.ocp
    mu_ub = side(st.mu_ub, g - finite(ocp.ineq_ub), ocp.ineq_ub)
    mu_lb = side(st.mu_lb, finite(ocp.ineq_lb) - g, ocp.ineq_lb)
    x_lb, x_ub, u_lb, u_ub = al._bounds_from(params)
    mu_x_ub = side(st.mu_x_ub, X - finite(x_ub), x_ub)
    mu_x_lb = side(st.mu_x_lb, finite(x_lb) - X, x_lb)
    mu_u_ub = side(st.mu_u_ub, U - finite(u_ub), u_ub)
    mu_u_lb = side(st.mu_u_lb, finite(u_lb) - U, u_lb)
    return lam_eq, lam_eq_T, mu_ub, mu_lb, mu_x_ub, mu_x_lb, mu_u_ub, mu_u_lb


def shift_plain(st):
    """Roll the warm start one node forward (last row repeated) — the
    trajectory and the node-indexed multipliers."""
    sol = st.sol._replace(X=_roll(st.sol.X), U=_roll(st.sol.U))
    return st._replace(
        sol=sol, lam_eq=_roll(st.lam_eq),
        mu_ub=_roll(st.mu_ub), mu_lb=_roll(st.mu_lb),
        mu_x_ub=_roll(st.mu_x_ub), mu_x_lb=_roll(st.mu_x_lb),
        mu_u_ub=_roll(st.mu_u_ub), mu_u_lb=_roll(st.mu_u_lb),
    )


def seed_tail_plain(st, prior, phase):
    """Replace the injected tail multipliers with the phase tables'
    entries (where visited). `phase` (B,) is the cycle index of this
    tick's terminal write; the stage tail row holds the previous
    tick's, phase − 1."""
    phase = phase.long()
    P = prior.lam_tail.shape[1]
    tail_ph = (phase - 1) % P
    lam_tail = torch.where(_rows_at(prior.seen_tail, tail_ph)[:, None],
                           _rows_at(prior.lam_tail, tail_ph),
                           st.lam_eq[:, -1])
    lam_T = torch.where(_rows_at(prior.seen_T, phase)[:, None],
                        _rows_at(prior.lam_T, phase), st.lam_eq_T)
    lam_eq = torch.cat([st.lam_eq[:, :-1], lam_tail[:, None]], dim=1)
    return st._replace(lam_eq=lam_eq, lam_eq_T=lam_T)


def update_tail_plain(prior, st, phase, ema: float):
    """EMA the post-solve tail multipliers into the phase tables
    (first visit copies)."""
    phase = phase.long()
    P = prior.lam_tail.shape[1]
    tail_ph = (phase - 1) % P
    tail = st.lam_eq[:, -1]
    new_tail = torch.where(
        _rows_at(prior.seen_tail, tail_ph)[:, None],
        (1.0 - ema) * _rows_at(prior.lam_tail, tail_ph) + ema * tail, tail)
    new_T = torch.where(
        _rows_at(prior.seen_T, phase)[:, None],
        (1.0 - ema) * _rows_at(prior.lam_T, phase) + ema * st.lam_eq_T,
        st.lam_eq_T)
    true = torch.ones_like(phase, dtype=torch.bool)
    return type(prior)(
        lam_tail=_with_rows(prior.lam_tail, tail_ph, new_tail),
        lam_T=_with_rows(prior.lam_T, phase, new_T),
        seen_tail=_with_rows(prior.seen_tail, tail_ph, true),
        seen_T=_with_rows(prior.seen_T, phase, true),
    )


def seed_full_plain(st, prior, phase):
    """Replace the whole stage and terminal equality-multiplier field
    with the phase's table entry (once visited; the rolled field until
    then)."""
    phase = phase.long()
    ok = _rows_at(prior.seen, phase)
    lam_eq = _rows_at(prior.lam_eq, phase)
    lam_eq_T = _rows_at(prior.lam_eq_T, phase)
    return st._replace(
        lam_eq=torch.where(_bcast(ok, lam_eq), lam_eq, st.lam_eq),
        lam_eq_T=torch.where(_bcast(ok, lam_eq_T), lam_eq_T, st.lam_eq_T))


def update_full_plain(prior, st, phase, ema: float):
    phase = phase.long()
    seen = _rows_at(prior.seen, phase)
    new_eq = torch.where(
        _bcast(seen, st.lam_eq),
        (1.0 - ema) * _rows_at(prior.lam_eq, phase) + ema * st.lam_eq,
        st.lam_eq)
    new_T = torch.where(
        _bcast(seen, st.lam_eq_T),
        (1.0 - ema) * _rows_at(prior.lam_eq_T, phase) + ema * st.lam_eq_T,
        st.lam_eq_T)
    return type(prior)(
        lam_eq=_with_rows(prior.lam_eq, phase, new_eq),
        lam_eq_T=_with_rows(prior.lam_eq_T, phase, new_T),
        seen=_with_rows(prior.seen, phase,
                        torch.ones_like(phase, dtype=torch.bool)))


# ---------------- the twins ----------------

def isrbd_al_constraints_plain(al, X, U, params, st=None, offline=False):
    """Plain K7 at the plan X (B,ns+1,nx), U (B,ns,nu) under the outer
    params (leaves (B,ns+1,dim); u-box overrides (B,ns,nu)). Without `st`:
    h, hT, g, viol (`constraints_plain`). With the pre-update `ALState`:
    online, the equality update λ + ρw·h, λ_T + ρw_T·hT and viol; offline,
    the eight multipliers of `multipliers_plain` (the fields `MULTIPLIERS`),
    the scheduled penalty and viol."""
    h, hT, g, viol = constraints_plain(al, X, U, params)
    if st is None:
        return h, hT, g, viol
    if not offline:
        r2 = st.rho[:, None]
        w = al._w_eq if al._w_eq is not None else 1.0
        w_T = al._w_eq_T if al._w_eq_T is not None else 1.0
        return (st.lam_eq + r2[:, :, None] * w * h,
                st.lam_eq_T + r2 * w_T * hT, viol)
    opts = al.al_opts
    mults = multipliers_plain(al, st, X, U, h, hT, g, params, st.rho)
    grow = viol > opts.viol_decrease * st.viol
    rho_new = torch.where(
        grow & (viol > opts.tol),
        torch.clamp(st.rho * opts.rho_growth, max=opts.rho_max),
        st.rho)
    return mults + (rho_new, viol)


def isrbd_al_shift_plain(al, st, prior=None, phase=None):
    """Plain K8a: `shift_plain`, then with a prior its seed at `phase`."""
    st = shift_plain(st)
    if prior is None:
        return st
    seed = seed_full_plain if is_full(prior) else seed_tail_plain
    return seed(st, prior, phase)


def isrbd_al_params_plain(al, params, st):
    """The inner solver's parameter dict: the outer params plus the
    multipliers, penalty and bounds under `al_*` keys, each padded to
    (B, ns+1, dim) (stage rows 0..ns−1 hold stage multipliers; row ns
    is unused there)."""
    ns = al.ocp.ns
    lam_eq = st.lam_eq
    Bsz, dtype, dev = lam_eq.shape[0], lam_eq.dtype, lam_eq.device
    p = dict(params)
    p["al_lam_eq"] = _pad_node(lam_eq)
    p["al_lam_eq_T"] = st.lam_eq_T[:, None, :].expand(
        Bsz, ns + 1, st.lam_eq_T.shape[-1]).contiguous()
    p["al_mu_ub"] = _pad_node(st.mu_ub)
    p["al_mu_lb"] = _pad_node(st.mu_lb)
    p["al_rho"] = st.rho.to(dtype)[:, None, None].expand(
        Bsz, ns + 1, 1).contiguous()
    x_lb, x_ub, u_lb, u_ub = al._static_padded_bounds(Bsz, dtype, dev)
    inf = float("inf")
    p["al_x_lb"] = params["x_lb"].to(dtype) if "x_lb" in params else x_lb
    p["al_x_ub"] = params["x_ub"].to(dtype) if "x_ub" in params else x_ub
    p["al_u_lb"] = (_pad_node(params["u_lb"].to(dtype), -inf)
                    if "u_lb" in params else u_lb)
    p["al_u_ub"] = (_pad_node(params["u_ub"].to(dtype), inf)
                    if "u_ub" in params else u_ub)
    p["al_mu_x_ub"] = st.mu_x_ub
    p["al_mu_x_lb"] = st.mu_x_lb
    p["al_mu_u_ub"] = _pad_node(st.mu_u_ub)
    p["al_mu_u_lb"] = _pad_node(st.mu_u_lb)
    # bound values travel under the al_* keys; drop raw overrides so
    # the inner solver's parameter dict has a fixed structure
    for k in ("x_lb", "x_ub", "u_lb", "u_ub"):
        p.pop(k, None)
    return p


def isrbd_al_prior_update_plain(al, prior, st, phase, ema: float):
    """Plain K8c: `update_full_plain` or `update_tail_plain`."""
    upd = update_full_plain if is_full(prior) else update_tail_plain
    return upd(prior, st, phase, ema)


# ---------------- the entries ----------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_fns = {}


def _fn(entry: str, dtype, argtypes):
    """The C entry `<entry>_f32/_f64` with its argtypes set (cached)."""
    key = (entry, dtype)
    fn = _fns.get(key)
    if fn is None:
        suffix = "f32" if dtype == torch.float32 else "f64"
        fn = getattr(library("isrbd_al"), f"{entry}_{suffix}")
        fn.argtypes = argtypes
        fn.restype = _I
        _fns[key] = fn
    return fn


def _doubles(values):
    return (_D * len(values))(*values)


def _device(name: str, t):
    """The device and dtype of `t`, which must be CUDA float32/float64."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {t.device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, got {t.dtype}")
    return t.device, t.dtype


def _shape_setup(name, al, nx, nu) -> int:
    """The shape check of an entry, once for (terms, entry, sizes): the
    index of the shape in `KERNEL_SHAPES`."""
    return host_setup(al.terms, (name, nx, nu), lambda: shape_index(
        check_kernel_shape(name, al.terms, nx, nu)))


def _check_phase(phase, Bsz, dev):
    if phase.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"phase must be int32 or int64, got {phase.dtype}")
    check_tensors((("phase", phase, (Bsz,)),), phase.dtype, dev)


def al_scalars(al, dt: float):
    """Host doubles of `AlConsts` (csrc/isrbd_al.cu): the isrbd kernels'
    scalars (`kernel_scalars`), the stiffness w (n_eq) and w_T (n_eq_T),
    then viol_decrease, tol, rho_growth, rho_max."""
    t = al.terms

    def floats(v, n):
        return [1.0] * n if v is None else [float(a) for a in v.tolist()]

    o = al.al_opts
    return (tuple(kernel_scalars(t, dt)) + tuple(floats(al._w_eq, t.n_eq))
            + tuple(floats(al._w_eq_T, t.n_eq_T))
            + (float(o.viol_decrease), float(o.tol), float(o.rho_growth),
               float(o.rho_max)))


def _bound(name, b, Bsz, n, dim, dtype, dev):
    """A bound the kernel reads: one static (n, dim) table (member stride
    0) or a per-member (B, n, dim) override."""
    if b.dim() == 2:
        check_tensor(name, b, (n, dim), dtype, dev)
        return 0
    check_tensor(name, b, (Bsz, n, dim), dtype, dev)
    return n * dim


# ---- K7's layout: what csrc/isrbd_al.cu stages, and its one output buffer ----

NAME = "isrbd_al_constraints"
MODES = ("eval", "online", "offline")
MAX_SMEM = 232_448            # an H100 block's dynamic shared memory
WARPS = 8                     # a member's block (kThreads / 32)
# the kernel's inputs, in the order of its `In` (csrc/isrbd_al.cu)
INPUTS = ("X", "U", "c_ref", "mask_srbd", "mask_lip", "mask_lipzone", "x_lb",
          "x_ub", "u_lb", "u_ub", "lam_eq", "lam_eq_T", "rho", "viol",
          "mu_ub", "mu_lb", "mu_x_ub", "mu_x_lb", "mu_u_ub", "mu_u_lb")
BOUNDS = ("x_lb", "x_ub", "u_lb", "u_ub")


def reads(i: int, mode: int) -> bool:
    """Whether K7 in `mode` (0 eval, 1 online, 2 offline) reads input i of
    INPUTS (the .cu's `reads`)."""
    return i <= 9 or (i <= 12 and mode != 0) or (i != 15 and mode == 2)


def run_count(i: int, ns: int, terms, nx: int, nu: int) -> int:
    """The elements of input i a member holds (the .cu's `run_count`)."""
    name = INPUTS[i]
    if name in ("X", "x_lb", "x_ub", "mu_x_ub", "mu_x_lb"):
        return (ns + 1) * nx
    if name in ("U", "u_lb", "u_ub", "mu_u_ub", "mu_u_lb"):
        return ns * nu
    if name == "c_ref":
        return (ns + 1) * terms.outer.nc
    if name.startswith("mask"):
        return ns + 1
    if name == "lam_eq":
        return ns * terms.n_eq
    if name == "lam_eq_T":
        return terms.n_eq_T
    if name.startswith("mu_"):
        return ns * terms.n_ineq
    return 1                                      # rho, viol (viol_prev)


def constraints_smem_bytes(mode: int, dtype, ns: int, terms, nx: int,
                           nu: int) -> int:
    """K7's shared memory a block (the .cu's `constraints_smem_bytes`): a
    region for each input the mode reads, its run and 16 bytes more (the
    run lands at its source's offset within 16 bytes), each a 16-byte
    multiple, then the warps' maxima."""
    e = torch.finfo(dtype).bits // 8
    r16 = lambda v: -(-v // 16) * 16
    return (sum(r16(run_count(i, ns, terms, nx, nu) * e + 16)
                for i in range(len(INPUTS)) if reads(i, mode))
            + r16(WARPS * e))


def output_shapes(mode: int, Bsz: int, ns: int, terms, nx: int, nu: int):
    """K7's outputs in `mode`, in the order the entry returns them: (slot
    of the kernel's `Out`, shape) — eval h, hT, g, viol; online λ, λ_T,
    viol; offline the MULTIPLIERS, ρ and viol."""
    n_eq, n_eq_T, n_in, ns1 = terms.n_eq, terms.n_eq_T, terms.n_ineq, ns + 1
    if mode == 0:
        return ((0, (Bsz, ns, n_eq)), (1, (Bsz, n_eq_T)), (2, (Bsz, ns, n_in)),
                (12, (Bsz,)))
    lam = ((3, (Bsz, ns, n_eq)), (4, (Bsz, n_eq_T)))
    if mode == 1:
        return lam + ((12, (Bsz,)),)
    return lam + ((5, (Bsz, ns, n_in)), (6, (Bsz, ns, n_in)),
                  (7, (Bsz, ns1, nx)), (8, (Bsz, ns1, nx)),
                  (9, (Bsz, ns, nu)), (10, (Bsz, ns, nu)), (11, (Bsz,)),
                  (12, (Bsz,)))




def output_layout(mode: int, Bsz: int, ns: int, terms, nx: int, nu: int,
                  dtype):
    """Where K7's outputs lie in a call's one buffer (`layout_of`), in
    return order."""
    return layout_of(output_shapes(mode, Bsz, ns, terms, nx, nu), dtype)




def state_shapes(Bsz: int, ns: int, terms, nx: int, nu: int) -> dict:
    """The shapes of an `ALState`'s tensors at B members and ns stage
    nodes (X and U those of its plan)."""
    n_eq, n_eq_T, n_in, ns1 = terms.n_eq, terms.n_eq_T, terms.n_ineq, ns + 1
    return dict(X=(Bsz, ns1, nx), U=(Bsz, ns, nu), lam_eq=(Bsz, ns, n_eq),
                lam_eq_T=(Bsz, n_eq_T), mu_ub=(Bsz, ns, n_in),
                mu_lb=(Bsz, ns, n_in), mu_x_ub=(Bsz, ns1, nx),
                mu_x_lb=(Bsz, ns1, nx), mu_u_ub=(Bsz, ns, nu),
                mu_u_lb=(Bsz, ns, nu), rho=(Bsz,), viol=(Bsz,))




class _ConstraintsSetup:
    """K7's host work for one (terms, options, dt, device, dtype, mode, B,
    ns), past the shape check: the entry with its argtypes, the scalars,
    the output layout, the shared-memory check, the static bounds (checked
    once) and the ctypes arrays of the bounds' member strides."""

    def __init__(self, al, dev, dtype, mode, Bsz, ns, nx, nu):
        terms = al.terms
        self.al_opts = al.al_opts        # held: the key holds its id
        smem = constraints_smem_bytes(mode, dtype, ns, terms, nx, nu)
        if smem > MAX_SMEM:
            raise ValueError(f"{NAME}: ns={ns} needs {smem} B of shared memory "
                             f"a block in {MODES[mode]} mode ({MAX_SMEM} fit)")
        self.fn = _fn(NAME, dtype, [_I, _P, _P, _P] + [_I] * 5 + [_P, _P])
        self.scalars = _doubles(al_scalars(al, al.ocp.dt))
        o = terms.outer
        self.topology = (o.nc, o.contact_model, o.number_of_legs)
        self.layout, self.total = output_layout(mode, Bsz, ns, terms, nx, nu,
                                                dtype)
        self.out_slots = _out_slots(self.layout, dtype)
        self.outer = (("c_ref", (Bsz, ns + 1, o.nc)),
                      ("mask_srbd", (Bsz, ns + 1, 1)),
                      ("mask_lip", (Bsz, ns + 1, 1)),
                      ("mask_lipzone", (Bsz, ns + 1, 1)))
        self.bound_rows = ((ns + 1, nx), (ns + 1, nx), (ns, nu), (ns, nu))
        # the static tables that pass the check (None: checked at each
        # call that reads them, and raising there)
        self.static = []
        for name, b, (n, dim) in zip(BOUNDS, al._bounds, self.bound_rows):
            try:
                check_tensor(name, b, (n, dim), dtype, dev)
                self.static.append(b)
            except ValueError:
                self.static.append(None)
        shapes = state_shapes(Bsz, ns, terms, nx, nu)
        fields = (() if mode == 0 else ("lam_eq", "lam_eq_T", "rho")
                  if mode == 1 else MULTIPLIERS + ("rho", "viol"))
        self.state = tuple((f, shapes[f]) for f in fields)
        # the state's fields in the kernel's input slots 10 on (INPUTS)
        self.state_ins = INPUTS[10:10 + (0, 3, 10)[mode]]
        self.strides = {}
        # the strides when every bound is its static table (the serving
        # tick's case), or None where one of those fails its check
        self.all_static = (None if None in self.static
                           else self.stride_array((0, 0, 0, 0)))

    def stride_array(self, strides):
        arr = self.strides.get(strides)
        if arr is None:
            arr = self.strides[strides] = (ctypes.c_longlong * 4)(*strides)
        return arr


def _constraints_checked(al, X, U, params, st, offline):
    """K7's host checks of a CUDA call: (its setup, the mode, the input
    tensors in the kernel's order, the bounds' member strides as a ctypes
    array). Raises ValueError on any tensor the kernel does not take."""
    Bsz, ns1, nx = X.shape
    ns, nu = ns1 - 1, U.shape[-1]
    mode = 0 if st is None else 2 if offline else 1
    _shape_setup(NAME, al, nx, nu)               # sizes first, then device
    dev, dtype = _device(NAME, X)
    s = host_setup(al.terms, (NAME, id(al.al_opts), al.ocp.dt, dev, dtype,
                              mode, Bsz, ns),
                   lambda: _ConstraintsSetup(al, dev, dtype, mode, Bsz, ns,
                                             nx, nu))
    outer = [params[k] for k, _ in s.outer]
    items = [("X", X, (Bsz, ns1, nx)), ("U", U, (Bsz, ns, nu))]
    items += [(k, t, shape) for (k, shape), t in zip(s.outer, outer)]
    state = [getattr(st, f) for f, _ in s.state]
    items += [(f, t, shape) for (f, shape), t in zip(s.state, state)]
    check_tensors(items, dtype, dev)
    bounds = al._bounds_from(params)
    if s.all_static is not None and all(
            b is t for b, t in zip(bounds, s.static)):
        strides = s.all_static
    else:
        strides = s.stride_array(tuple(
            0 if b is static else _bound(name, b, Bsz, n, dim, dtype, dev)
            for name, b, static, (n, dim) in zip(BOUNDS, bounds, s.static,
                                                  s.bound_rows)))
    ins = [X, U, *outer, *bounds] + [None] * 10
    ins[10:10 + len(s.state_ins)] = [getattr(st, f) for f in s.state_ins]
    return s, mode, ins, strides




def _constraints_launch(s, mode, ins, strides, out_base, Bsz, ns, dev):
    """Launch K7 on the checked inputs, its outputs at `out_base` (the
    buffer's address) as `s.layout` places them."""
    outs = [None] * 13
    for slot, off in s.out_slots:
        outs[slot] = out_base + off
    ptrs_in = (_P * 20)(*[None if t is None else t.data_ptr() for t in ins])
    ptrs_out = (_P * 13)(*outs)
    _launch(NAME, s.fn, dev, mode, ptrs_in, ptrs_out, strides, Bsz, ns,
            *s.topology, s.scalars)


def isrbd_al_constraints(al, X, U, params, st=None, offline=False):
    """K7. Same contract as `isrbd_al_constraints_plain`; launches the CUDA
    kernel for CUDA tensors of the sizes of a shape in `KERNEL_SHAPES` (and
    counts the launch in `isrbd_al_constraints.launches`), raises
    ValueError for any other. A call's outputs are views of one buffer
    (`output_layout`)."""
    if X.device.type == "cpu":
        return isrbd_al_constraints_plain(al, X, U, params, st, offline)
    s, mode, ins, strides = _constraints_checked(al, X, U, params, st, offline)
    buf, views = output_views(s.layout, s.total, X.dtype, X.device)
    _constraints_launch(s, mode, ins, strides, buf.data_ptr(), X.shape[0],
                        X.shape[1] - 1, X.device)
    isrbd_al_constraints.launches += 1
    return tuple(views)


isrbd_al_constraints.launches = 0


def constraints_occupancy(mode: int, dtype=torch.float32, ns: int = 20,
                          shape: str = "kangaroo") -> dict:
    """K7's occupancy in `mode` at the shape `shape` and ns stage nodes for
    tensors of `dtype`: blocks resident on one SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), warps and shared
    memory bytes a block, registers and local (spilled) bytes a thread."""
    return occupancy_query("isrbd_al", "isrbd_al_constraints_occupancy",
                           EVALUATE_OCCUPANCY_FIELDS, shape_index(shape), mode,
                           int(dtype == torch.float64), ns)


# ---- K8a-c: their tensors, one output buffer a call, a setup a size ----
#
# A setup's pointer arrays are filled by each call just before its launch,
# which copies them into the kernel's parameters: calls on one thread only
# (two threads calling one entry at the same sizes would race on them).

SHIFT = "isrbd_al_shift"
PARAMS = "isrbd_al_params"
PRIOR = "isrbd_al_prior_update"
PRIORS = ("none", "tail", "full")      # the kernels' Prior (0, 1, 2)
# K8a's inputs and outputs after X and U, in the kernel's ShiftIn order
SHIFTED = ROLLED + ("lam_eq_T",)
# K8b's state inputs and their al_* outputs, in the kernel's ParamsIn order
# (then the u-box overrides u_lb, u_ub and their al_u_lb, al_u_ub)
PARAMS_STATE = ("lam_eq", "lam_eq_T", "mu_ub", "mu_lb", "rho", "mu_u_ub",
                "mu_u_lb")


def prior_kind(prior):
    """(the kernels' Prior, the period) of a prior or None."""
    if prior is None:
        return 0, 0
    tab = prior[0]
    return (2 if is_full(prior) else 1), (tab.shape[1] if tab.dim() > 1 else 0)


def prior_shapes(kind: int, Bsz: int, period: int, ns: int, terms):
    """A prior's tensors as the kernels take them, in its field order:
    ((field, shape), …) of its tables (the state's dtype), then of its
    seen flags (bool)."""
    n_eq, n_eq_T = terms.n_eq, terms.n_eq_T
    if kind == 2:
        return ((("lam_eq", (Bsz, period, ns, n_eq)),
                 ("lam_eq_T", (Bsz, period, n_eq_T))),
                (("seen", (Bsz, period)),))
    return ((("lam_tail", (Bsz, period, n_eq)),
             ("lam_T", (Bsz, period, n_eq_T))),
            (("seen_tail", (Bsz, period)), ("seen_T", (Bsz, period))))


def shift_layout(kind: int, Bsz: int, ns: int, terms, nx: int, nu: int,
                 dtype):
    """K8a's outputs in one buffer (`layout_of`), in the kernel's order
    (the slots of ShiftIn): X, U, the ROLLED fields and, with a prior,
    λ_T."""
    sh = state_shapes(Bsz, ns, terms, nx, nu)
    fields = ("X", "U") + ROLLED + (("lam_eq_T",) if kind else ())
    return layout_of(tuple(enumerate(sh[f] for f in fields)), dtype)


def params_fields(over):
    """K8b's written outputs, in the kernel's order (ParamsIn): (slot,
    al_* key), the padded u boxes only where `over` (u_lb, u_ub
    overridden) says."""
    keys = tuple(f"al_{f}" for f in PARAMS_STATE) + ("al_u_lb", "al_u_ub")
    return tuple((i, k) for i, k in enumerate(keys) if i < 7 or over[i - 7])


def params_layout(over, Bsz: int, ns: int, terms, nu: int, dtype):
    """K8b's written outputs in one buffer (`layout_of`), each (B, ns+1,
    dim), in the order of `params_fields`."""
    dims = dict(al_lam_eq=terms.n_eq, al_lam_eq_T=terms.n_eq_T,
                al_mu_ub=terms.n_ineq, al_mu_lb=terms.n_ineq, al_rho=1,
                al_mu_u_ub=nu, al_mu_u_lb=nu, al_u_lb=nu, al_u_ub=nu)
    return layout_of(tuple((i, (Bsz, ns + 1, dims[k]))
                           for i, k in params_fields(over)), dtype)


def prior_layout(kind: int, Bsz: int, period: int, ns: int, terms, dtype):
    """K8c's outputs in one buffer of `dtype`: the new tables' views
    (`layout_of`, slots 0, 1), then the new flags' (bool; slots 2, and 3
    for the tail prior) at byte offsets, each OUT_ALIGN-aligned. Returns
    (the tables' layout, the flags' ((slot, shape, stride, byte offset),
    …), the buffer's elements)."""
    tables, flags = prior_shapes(kind, Bsz, period, ns, terms)
    tab_layout, n = layout_of(tuple(enumerate(s for _, s in tables)), dtype)
    e = torch.finfo(dtype).bits // 8
    off, flag_layout = n * e, []
    for slot, (_, shape) in enumerate(flags, start=2):
        flag_layout.append((slot, shape, (shape[1], 1), off))
        off += -(-shape[0] * shape[1] // OUT_ALIGN) * OUT_ALIGN
    return tab_layout, tuple(flag_layout), -(-off // e)


def prior_views(tab_layout, flag_layout, total: int, dtype, device):
    """One `torch.empty` of `total` elements of `dtype` cut into K8c's
    outputs (`prior_layout`): (the buffer, the table views, the flag
    views)."""
    buf = torch.empty(total, dtype=dtype, device=device)
    flags = buf.view(torch.bool)
    return (buf, [buf.as_strided(shape, stride, off)
                  for _, shape, stride, off in tab_layout],
            [flags.as_strided(shape, stride, off)
             for _, shape, stride, off in flag_layout])


class _ShiftSetup:
    """K8a's host work for one (terms, device, dtype, prior kind, period, B,
    ns), past the shape check: the entry with its argtypes, the state's
    and the prior's tensors and shapes, the output layout and the pointer
    arrays a call fills in place."""

    def __init__(self, al, dtype, kind, period, Bsz, ns, nx, nu):
        terms = al.terms
        self.fn = _fn(SHIFT, dtype, [_I, _I, _P, _P, _P, _P] + [_I] * 3
                      + [_P, _I, _P])
        sh = state_shapes(Bsz, ns, terms, nx, nu)
        self.state = (("X", sh["X"]), ("U", sh["U"])) + tuple(
            (f, sh[f]) for f in SHIFTED)
        self.tables, self.flags = (prior_shapes(kind, Bsz, period, ns, terms)
                                   if kind else ((), ()))
        self.layout, self.total = shift_layout(kind, Bsz, ns, terms, nx, nu,
                                               dtype)
        self.out_slots = _out_slots(self.layout, dtype)
        self.ins = (_P * 12)()
        self.outs = (_P * 10)()


class _ParamsSetup:
    """K8b's host work for one (terms, device, dtype, overrides, B, ns):
    the entry with its argtypes, the state's tensors and shapes, the
    written outputs' layout and keys, the static padded bounds and the
    pointer arrays a call fills in place."""

    def __init__(self, al, dev, dtype, over, Bsz, ns, nu):
        terms = al.terms
        self.fn = _fn(PARAMS, dtype, [_I, _P, _P, _I, _I, _P])
        sh = state_shapes(Bsz, ns, terms, al.ocp.nx, nu)
        self.state = tuple((f, sh[f]) for f in PARAMS_STATE)
        self.over = tuple(k for k, o in zip(("u_lb", "u_ub"), over) if o)
        self.over_shape = (Bsz, ns, nu)
        self.keys = tuple(k for _, k in params_fields(over))
        self.layout, self.total = params_layout(over, Bsz, ns, terms, nu,
                                                dtype)
        self.out_slots = _out_slots(self.layout, dtype)
        self.bounds = dict(zip(("al_x_lb", "al_x_ub", "al_u_lb", "al_u_ub"),
                               al._static_padded_bounds(Bsz, dtype, dev)))
        self.ins = (_P * 9)()
        self.outs = (_P * 9)()


class _PriorSetup:
    """K8c's host work for one (terms, device, dtype, prior kind, period, B,
    ns): the entry with its argtypes, the state's and the prior's shapes,
    the outputs' layout and the pointer arrays a call fills in place."""

    def __init__(self, al, dtype, kind, period, Bsz, ns):
        terms = al.terms
        self.fn = _fn(PRIOR, dtype, [_I, _I, _P, _P, _P, _P, _P, _P]
                      + [_I] * 3 + [_P, _I, _D, _P])
        sh = state_shapes(Bsz, ns, terms, al.ocp.nx, al.ocp.nu)
        self.state = (("lam_eq", sh["lam_eq"]), ("lam_eq_T", sh["lam_eq_T"]))
        self.tables, self.flags = prior_shapes(kind, Bsz, period, ns, terms)
        self.tab_layout, self.flag_layout, self.total = prior_layout(
            kind, Bsz, period, ns, terms, dtype)
        self.ins = (_P * 4)()
        self.outs = (_P * 2)()


def shift_setup(al, dev, dtype, kind, period, Bsz, ns, nx, nu):
    """K8a's `_ShiftSetup` for these sizes, made once (`host_setup`)."""
    return host_setup(al.terms, (SHIFT, dev, dtype, kind, period, Bsz, ns),
                      lambda: _ShiftSetup(al, dtype, kind, period, Bsz, ns,
                                          nx, nu))


def params_setup(al, dev, dtype, over, Bsz, ns, nu):
    """K8b's `_ParamsSetup` for these sizes and overrides, made once."""
    return host_setup(al.terms, (PARAMS, dev, dtype, over, Bsz, ns),
                      lambda: _ParamsSetup(al, dev, dtype, over, Bsz, ns, nu))


def prior_setup(al, dev, dtype, kind, period, Bsz, ns):
    """K8c's `_PriorSetup` for these sizes, made once."""
    return host_setup(al.terms, (PRIOR, dev, dtype, kind, period, Bsz, ns),
                      lambda: _PriorSetup(al, dtype, kind, period, Bsz, ns))


def _named(fields, tensors):
    """(name, tensor, shape) items for `check_tensors`."""
    return [(f, t, shape) for (f, shape), t in zip(fields, tensors)]


def _checked_prior(s, prior, phase, Bsz, dtype, dev):
    """The prior's tables and flags as `s` (a K8a or K8c setup) takes them,
    checked with the phase."""
    tables = [getattr(prior, f) for f, _ in s.tables]
    flags = [getattr(prior, f) for f, _ in s.flags]
    check_tensors(_named(s.tables, tables), dtype, dev)
    check_tensors(_named(s.flags, flags), torch.bool, dev)
    _check_phase(phase, Bsz, dev)
    return tables, flags


def isrbd_al_shift(al, st, prior=None, phase=None):
    """K8a. Same contract as `isrbd_al_shift_plain` (bit for bit); launches
    the CUDA kernel for CUDA tensors (counted in `isrbd_al_shift.launches`),
    raises ValueError for any other device or size. A call's outputs are
    views of one buffer (`shift_layout`)."""
    X = st.sol.X
    if X.device.type == "cpu":
        return isrbd_al_shift_plain(al, st, prior, phase)
    Bsz, ns1, nx = X.shape
    ns, nu = ns1 - 1, st.sol.U.shape[-1]
    shape_i = _shape_setup(SHIFT, al, nx, nu)    # sizes first, then device
    dev, dtype = _device(SHIFT, X)
    kind, period = prior_kind(prior)
    s = shift_setup(al, dev, dtype, kind, period, Bsz, ns, nx, nu)
    state = [X, st.sol.U] + [getattr(st, f) for f in SHIFTED]
    check_tensors(_named(s.state, state), dtype, dev)
    ins, outs = s.ins, s.outs
    for i, t in enumerate(state):
        ins[i] = t.data_ptr()
    seen = seen_T = ph = None
    if kind:
        (tab, tabT), flags = _checked_prior(s, prior, phase, Bsz, dtype, dev)
        ins[10], ins[11] = tab.data_ptr(), tabT.data_ptr()
        seen = flags[0].data_ptr()
        seen_T = flags[-1].data_ptr()
        ph = phase.data_ptr()
    else:
        ins[10] = ins[11] = outs[9] = None
    buf, views = output_views(s.layout, s.total, dtype, dev)
    base = buf.data_ptr()
    for slot, off in s.out_slots:
        outs[slot] = base + off
    _launch(SHIFT, s.fn, dev, shape_i, kind, ins, seen, seen_T, outs, Bsz, ns,
            period, ph, phase.element_size() if kind else 0)
    isrbd_al_shift.launches += 1
    fields = dict(zip(SHIFTED, views[2:]))
    return st._replace(sol=st.sol._replace(X=views[0], U=views[1]), **fields)


isrbd_al_shift.launches = 0


def isrbd_al_params(al, params, st):
    """K8b. Same contract as `isrbd_al_params_plain` (bit for bit);
    launches the CUDA kernel for CUDA tensors (counted in
    `isrbd_al_params.launches`), raises ValueError for any other device or
    size. The padded tensors it writes are views of one buffer
    (`params_layout`)."""
    lam_eq = st.lam_eq
    if lam_eq.device.type == "cpu":
        return isrbd_al_params_plain(al, params, st)
    nx, nu, ns = al.ocp.nx, al.ocp.nu, al.ocp.ns
    shape_i = _shape_setup(PARAMS, al, nx, nu)
    dev, dtype = _device(PARAMS, lam_eq)
    Bsz = lam_eq.shape[0]
    over = ("u_lb" in params, "u_ub" in params)
    s = params_setup(al, dev, dtype, over, Bsz, ns, nu)
    state = [getattr(st, f) for f in PARAMS_STATE]
    given = {k: params[k] if params[k].dtype == dtype else params[k].to(dtype)
             for k in s.over}
    check_tensors(_named(s.state, state)
                  + [(k, t, s.over_shape) for k, t in given.items()],
                  dtype, dev)
    ins, outs = s.ins, s.outs
    for i, t in enumerate(state):
        ins[i] = t.data_ptr()
    ins[7], ins[8] = (given[k].data_ptr() if k in given else None
                      for k in ("u_lb", "u_ub"))
    buf, views = output_views(s.layout, s.total, dtype, dev)
    base = buf.data_ptr()
    outs[7] = outs[8] = None
    for slot, off in s.out_slots:
        outs[slot] = base + off
    _launch(PARAMS, s.fn, dev, shape_i, ins, outs, Bsz, ns)
    isrbd_al_params.launches += 1
    out = dict(zip(s.keys, views))
    b = s.bounds
    bound = lambda k: (b[f"al_{k}"] if k not in params else params[k]
                       if params[k].dtype == dtype else params[k].to(dtype))
    p = dict(params)
    p.update(al_lam_eq=out["al_lam_eq"], al_lam_eq_T=out["al_lam_eq_T"],
             al_mu_ub=out["al_mu_ub"], al_mu_lb=out["al_mu_lb"],
             al_rho=out["al_rho"], al_x_lb=bound("x_lb"),
             al_x_ub=bound("x_ub"), al_u_lb=out.get("al_u_lb", b["al_u_lb"]),
             al_u_ub=out.get("al_u_ub", b["al_u_ub"]),
             al_mu_x_ub=st.mu_x_ub, al_mu_x_lb=st.mu_x_lb,
             al_mu_u_ub=out["al_mu_u_ub"], al_mu_u_lb=out["al_mu_u_lb"])
    for k in ("x_lb", "x_ub", "u_lb", "u_ub"):
        p.pop(k, None)
    return p


isrbd_al_params.launches = 0


def isrbd_al_prior_update(al, prior, st, phase, ema: float):
    """K8c. Same contract as `isrbd_al_prior_update_plain` (bit for bit,
    out of place); launches the CUDA kernel for CUDA tensors (counted in
    `isrbd_al_prior_update.launches`), raises ValueError for any other
    device or size. The new tables and flags are views of one buffer
    (`prior_layout`)."""
    lam_eq = st.lam_eq
    if lam_eq.device.type == "cpu":
        return isrbd_al_prior_update_plain(al, prior, st, phase, ema)
    shape_i = _shape_setup(PRIOR, al, al.ocp.nx, al.ocp.nu)
    dev, dtype = _device(PRIOR, lam_eq)
    Bsz, ns = lam_eq.shape[0], lam_eq.shape[1] if lam_eq.dim() > 1 else 0
    kind, period = prior_kind(prior)
    s = prior_setup(al, dev, dtype, kind, period, Bsz, ns)
    state = [lam_eq, st.lam_eq_T]
    check_tensors(_named(s.state, state), dtype, dev)
    (tab, tabT), flags = _checked_prior(s, prior, phase, Bsz, dtype, dev)
    ins, outs = s.ins, s.outs
    for i, t in enumerate(state + [tab, tabT]):
        ins[i] = t.data_ptr()
    buf, tables, new_flags = prior_views(s.tab_layout, s.flag_layout,
                                         s.total, dtype, dev)
    base = buf.data_ptr()
    e = torch.finfo(dtype).bits // 8
    outs[0], outs[1] = (base + off * e for _, _, _, off in s.tab_layout)
    flag_out = [base + off for _, _, _, off in s.flag_layout]
    full = kind == 2
    _launch(PRIOR, s.fn, dev, shape_i, kind, ins, flags[0].data_ptr(),
            None if full else flags[1].data_ptr(), outs, flag_out[0],
            None if full else flag_out[1], Bsz, ns, period, phase.data_ptr(),
            phase.element_size(), float(ema))
    isrbd_al_prior_update.launches += 1
    return type(prior)(*tables, *new_flags)


isrbd_al_prior_update.launches = 0


def shift_occupancy(prior: int, dtype=torch.float32,
                    shape: str = "kangaroo") -> dict:
    """K8a's occupancy with the prior `prior` (0 none, 1 tail, 2 full) at
    the shape `shape` for tensors of `dtype`: blocks resident on one SM,
    warps a block, shared memory bytes a block (none), registers and local
    (spilled) bytes a thread."""
    return occupancy_query("isrbd_al", "isrbd_al_shift_occupancy",
                           EVALUATE_OCCUPANCY_FIELDS, shape_index(shape), prior,
                           int(dtype == torch.float64))


def params_occupancy(dtype=torch.float32, shape: str = "kangaroo") -> dict:
    """K8b's occupancy at the shape `shape` for tensors of `dtype`, as
    `shift_occupancy` gives K8a's."""
    return occupancy_query("isrbd_al", "isrbd_al_params_occupancy",
                           EVALUATE_OCCUPANCY_FIELDS, shape_index(shape),
                           int(dtype == torch.float64))
