"""K11: the LIP line-search trial — rollout, cost and Armijo test — over a
vector of step sizes; and `lip_evaluate`, the cost and largest defect of a
given plan.

`lip_trial` is the wrapper the solver calls. A CPU tensor goes to
`lip_trial_plain`: the PyTorch transcription of the JAX package's
`MSDDP._rollout` (srbd_horizon_tpu/solvers/msddp.py:1391-1410) under the
LIP problem's step (`LIPTerms.step`: Euler, RK2 or RK4) evaluated for
every α at once, then the trial's
`total_cost` (:158) and Armijo test (:1494-1578); a CUDA tensor
launches the hand-written kernel in `csrc/lip_rollout.cu`, which does all
three in one launch, or raises.

Per member and α, from x̂₀ = x0, for n = 0 … ns−1:

    uₙ    = Uₙ + α kₙ + Kₙ (x̂ₙ − Xₙ)
    x̂ₙ₊₁ = step(x̂ₙ, uₙ) − (1 − α) dₙ

then cost = Σₙ‖ρ(x̂ₙ, uₙ)‖² + ‖ρ_N(x̂_N)‖², merit = cost + ν(1−α)²D and
ok = merit0 − merit ≥ β·max(expected, 1e-16) ∧ isfinite(merit) ∧ α ≥ α_min,
expected = −(αΔV₁ + α²ΔV₂) + (2α − α²)νD. Outputs are Xn (nα, B, ns+1, nx),
Un (nα, B, ns, nu), and cost, merit, ok (nα, B).

The kernel runs a block a member with up to four of its α's, a chain
warp each, and a copier warp that stages the member's operands into
shared memory by bulk copies once for all its α's; the chains carry x̂ and
u alone, and after them every thread evaluates the cost of an (α, node). `smem_bytes` states its shared
memory, `trial_occupancy` reads the card's figures for it, and
`lip_trial_chain` launches the chain alone, for timing.

`lip_evaluate`, the second entry of the same source, evaluates a given
plan with no rollout: per member the cost and the largest
|step(Xₙ, Uₙ) − Xₙ₊₁| (NaN if any entry is NaN), what the JAX
package's solve computes with `jax.vmap(total_cost)` and
`jax.vmap(_true_defects)` (msddp.py:1221-1240, :1484). Given x0 (B, nx),
it evaluates the plan with node 0 pinned to x0 and returns that plan as a
third output, written by the same launch. Its plain twin
`lip_evaluate_plain` is `LIPTerms.total_cost` and the problem's step. The
kernel takes a warp a member and a thread a node, `eval_members(B)`
members a block; `evaluate_smem_bytes` states its shared memory. Its
wrapper's host work is K10's: a setup a size (`_EvalSetup`), one check
pass, one buffer cut into the outputs, the raw stream.

Both run at the fifteen (topology, step) instances of
`lip_linearize.KERNEL_SHAPES` on CUDA tensors and raise ValueError for
others; CPU tensors take the twins at any size. Under RK2 and RK4 each
chain node takes the step's stages, a partner-lane shuffle each
(csrc/lip_common.cuh's `step_row` is the same step on one thread).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from srbd_horizon_tpu_torch.kernels.build import (
    EVALUATE_OCCUPANCY_FIELDS,
    check_tensor,
    check_tensors,
    host_setup,
    launch,
    layout_of,
    library,
    occupancy_query,
    out_slots,
    output_views,
)
from srbd_horizon_tpu_torch.kernels.lip_linearize import (
    KERNEL_SHAPES,
    N_SCALARS,
    PARAM_KEYS,
    STEPS,
    check_kernel_shape,
    kernel_params,
    shape_index,
)
from srbd_horizon_tpu_torch.kernels.rollout import (
    armijo_plain,
    evaluate_plain,
    rollout_plain,
)

# the functions K11 replaces (an XLA-fused scan and the trial's cost and
# Armijo test; the JAX package wrote no Pallas kernel for them)
REPLACES = "srbd_horizon_tpu/solvers/msddp.py:1391"
SOURCE = "srbd_horizon_tpu_torch/csrc/lip_rollout.cu"
# the functions lip_evaluate replaces (the solve's vmapped total_cost and
# _true_defects, XLA-fused)
EVALUATE_REPLACES = "srbd_horizon_tpu/solvers/msddp.py:1221"


def lip_trial_plain(x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1,
                    dV2, terms, dt: float, wc: float, nu_w: float,
                    beta: float, alpha_min: float):
    """Plain PyTorch K11: the rollout of the LIP double integrator under
    the problem's step (`rollout.rollout_plain`), the cost Σ‖ρ‖² of each
    rolled plan
    (`terms` is the problem's `LIPTerms`, wc = √w_c) and the Armijo test
    (`rollout.armijo_plain`). params leaves (B,ns+1,dim); merit0, D, dV1,
    dV2 (B,)."""
    Xn, Un = rollout_plain(x0, X, U, ks, Ks, d, alphas, dt, terms.xdot,
                           terms.step)
    new_cost = terms.total_cost(Xn, Un, params, wc)           # (nα, B)
    new_merit, ok = armijo_plain(new_cost, alphas, merit0, D, dV1, dV2, nu_w,
                                 beta, alpha_min)
    return Xn, Un, new_cost, new_merit, ok


def lip_evaluate_plain(X, U, params, terms, dt: float, wc: float, x0=None):
    """Plain PyTorch lip_evaluate: the cost (B,) of each plan,
    `terms.total_cost`, and its largest |defect| (B,) under the problem's
    step (`rollout.evaluate_plain`, NaN kept). X (B,ns+1,nx), U
    (B,ns,nu), params leaves (B,ns+1,dim). Given x0 (B,nx), node 0 of the
    plan is x0, and the pinned plan is returned third."""
    return evaluate_plain(
        X, U, dt, terms.xdot,
        lambda Xp: terms.total_cost(Xp, U, params, wc), x0, terms.step)


# K11's block (the .cu's kMaxAlphas, kPieceNodes, kRing): a warp an α of
# one member, at most four a block; the member's K streams through a ring
# of four slots of two nodes each
MAX_ALPHAS = 4
PIECE_NODES = 2
RING = 4
MAX_SMEM = 232_448        # an H100 block's dynamic shared memory


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def alphas_a_block(nA: int) -> int:
    """The α's of a member a K11 block holds, a warp each (more α's take
    more blocks of the member)."""
    return min(nA, MAX_ALPHAS)


def smem_bytes(dtype=torch.float32, ns: int = 20, nA: int = 1,
               shape: str = "kangaroo") -> dict:
    """The shared memory one K11 block takes at the instance `shape` (a
    `KERNEL_SHAPES` name), ns stage nodes and nA step sizes a call, region
    by region (the .cu's `regions`): the ring of K's
    pieces (after the chain the node sums), the member's staged runs of X,
    d, U and k and of its four parameter tensors (each 16 bytes longer than
    the run), the packed parameter rows, the records (x̂ then u an (α,
    node)), the barriers, and the total (its dynamic shared memory)."""
    z = KERNEL_SHAPES[shape]
    nx, nu, nc = z["nx"], z["nu"], z["nc"]
    pw = 4 + 2 * nc
    E = torch.finfo(dtype).bits // 8
    na = alphas_a_block(nA)
    r16 = _round16
    slot = r16(PIECE_NODES * nu * nx * E + 16)
    out = dict(ring=max(RING * slot, r16(na * (ns + 1) * E)),
               X=r16((ns + 1) * nx * E + 16),
               d=r16(ns * nx * E + 16),
               U=r16(ns * nu * E + 16),
               k=r16(ns * nu * E + 16),
               par=sum(r16((ns + 1) * dim * E + 16) for dim in (1, 3, nc, nc)),
               prm=r16((ns + 1) * pw * E),
               rec=r16(na * (ns + 1) * (nx + nu) * E),
               bar=r16(8 * (2 * RING + 2)))
    out["total"] = sum(out.values())
    return out


@functools.lru_cache(maxsize=None)
def _block_bytes(dtype, ns: int, nA: int, shape: str) -> int:
    return smem_bytes(dtype, ns, nA, shape)["total"]


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def _setup(name, terms, nx: int, nu: int, dt: float, wc: float):
    """What a wrapper checks and builds once for (terms, dtype): the
    instance's name, and the scalars as a ctypes array."""
    shape = check_kernel_shape(name, terms, nx, nu)
    return shape, (_D * N_SCALARS)(*terms.kernel_scalars(dt, wc))


def _checked_common(name, X, U, terms, dt, wc):
    """The shared prologue of both wrappers on a non-CPU tensor: the cached
    host setup (the instance's name and the scalars), then the device and
    type."""
    nx, nu = X.shape[-1], U.shape[-1]
    dtype, dev = X.dtype, X.device
    out = host_setup(terms, (name, dtype, nx, nu, dt, wc),
                     lambda: _setup(name, terms, nx, nu, dt, wc))
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, got {dtype}")
    return out


_fns = {}


def _fn(entry, dtype, argtypes):
    key = (entry, dtype)
    fn = _fns.get(key)
    if fn is None:
        lib = library("lip_rollout")
        fn = getattr(lib, f"{entry}_{'f32' if dtype == torch.float32 else 'f64'}")
        fn.argtypes = argtypes
        fn.restype = _I
        _fns[key] = fn
    return fn


# lip_evaluate's block (the .cu's kEvalMembers, kEvalWarps): a warp a
# member, a thread a node, at most eight members a block, at least four
# warps (those past the members stage only)
EVAL_MEMBERS = 8
EVAL_WARPS = 4
EVALUATE = "lip_evaluate"


def eval_members(Bsz: int, sms: int, dtype=None, ns: int = 20,
                 shape: str = "kangaroo") -> int:
    """The members a lip_evaluate block takes at B members on `sms` SMs
    (the .cu's `eval_members`): the most, halving from EVAL_MEMBERS, that
    still gives every SM a block; given `dtype`, also halved while the
    block at ns stage nodes and the instance `shape` would not fit
    MAX_SMEM (the .cu's `block_members`: the eight-contact float64 blocks
    past ns = 24)."""
    m = EVAL_MEMBERS
    while m > 1 and -(-Bsz // m) < sms:
        m //= 2
    while (dtype is not None and m > 1 and evaluate_smem_bytes(
            dtype, ns, m, shape)["total"] > MAX_SMEM):
        m //= 2
    return m


def evaluate_smem_bytes(dtype=torch.float32, ns: int = 20,
                        members: int = EVAL_MEMBERS,
                        shape: str = "kangaroo") -> dict:
    """The shared memory one lip_evaluate block takes at the instance
    `shape`, ns stage nodes with `members` members, region by region (the
    .cu's `eval_regions`):
    the members' staged runs of X, U and the four parameter tensors (each
    16 bytes longer than the run), x0's rows, the packed parameter rows,
    the barrier, and the total."""
    z = KERNEL_SHAPES[shape]
    nx, nu, nc = z["nx"], z["nu"], z["nc"]
    E = torch.finfo(dtype).bits // 8
    m, ns1, r16 = members, ns + 1, _round16
    out = dict(X=r16(m * ns1 * nx * E + 16), U=r16(m * ns * nu * E + 16),
               mt=r16(m * ns1 * E + 16), rd=r16(m * ns1 * 3 * E + 16),
               cr=r16(m * ns1 * nc * E + 16), cs=r16(m * ns1 * nc * E + 16),
               x0=r16(m * nx * E), prm=r16(m * ns1 * (4 + 2 * nc) * E),
               bar=16)
    out["total"] = sum(out.values())
    return out


def evaluate_shapes(Bsz: int, ns: int, nx: int, pinned: bool):
    """lip_evaluate's outputs ((slot, shape), …): the cost, the largest
    defect and, pinned, the pinned plan."""
    out = ((0, (Bsz,)), (1, (Bsz,)))
    return out + ((2, (Bsz, ns + 1, nx)),) if pinned else out


class _EvalSetup:
    """lip_evaluate's host work for one (terms, device, dtype, B, ns, dt,
    wc, pinned), past the shape check: the entry with its argtypes, the
    scalars, the tensors' shapes, the output layout and the parameter
    pointer array a call fills in place."""

    def __init__(self, terms, dtype, Bsz, ns, nx, nu, dt, wc, pinned):
        if ns + 1 > 32:
            raise ValueError(f"lip_evaluate takes at most 31 stage nodes, "
                             f"got {ns}")
        self.shape = check_kernel_shape(EVALUATE, terms, nx, nu)
        self.fn = _fn(EVALUATE, dtype,
                      [_P] * 3 + [_I, _P] + [_I] * 6 + [_P] * 5)
        self.scalars = (_D * N_SCALARS)(*terms.kernel_scalars(dt, wc))
        nc = terms.nc
        self.shapes = ((Bsz, ns + 1, nx), (Bsz, ns, nu)) + tuple(
            (Bsz, ns + 1, d) for d in (1, 3, nc, nc))
        self.x0_shape = (Bsz, nx)
        self.layout, self.total = layout_of(
            evaluate_shapes(Bsz, ns, nx, pinned), dtype)
        self.out_slots = out_slots(self.layout, dtype)
        self.args = (Bsz, ns, nc, terms.contact_model, terms.number_of_legs,
                     STEPS.index(terms.step), self.scalars)
        self.params = (_P * len(PARAM_KEYS))()


def lip_evaluate(X, U, params, terms, dt: float, wc: float, x0=None):
    """lip_evaluate. Same contract as `lip_evaluate_plain`; launches the
    CUDA kernel for CUDA tensors of the sizes and step of an instance in
    `KERNEL_SHAPES` (and counts the launch in `lip_evaluate.launches` and
    in its instance's entry of `lip_evaluate.shape_launches`), raises
    ValueError for others. A call's outputs are views of one buffer
    (`evaluate_shapes`)."""
    if X.device.type == "cpu":
        return lip_evaluate_plain(X, U, params, terms, dt, wc, x0)
    nx, nu = X.shape[-1], U.shape[-1]
    dtype, dev = X.dtype, X.device
    host_setup(terms, (EVALUATE, nx, nu),            # sizes first, then device
               lambda: check_kernel_shape(EVALUATE, terms, nx, nu))
    if dev.type != "cuda":
        raise ValueError(f"lip_evaluate runs on cpu or cuda, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"lip_evaluate takes float32 or float64, got {dtype}")
    out, shape = _evaluate_launched(X, U, params, terms, dt, wc, x0)
    lip_evaluate.launches += 1
    lip_evaluate.shape_launches[shape] += 1
    return out


def _evaluate_launched(X, U, params, terms, dt, wc, x0):
    """lip_evaluate's launch on X's device, past the shape and device
    checks: the setup, one check of the tensors, the outputs cut from one
    buffer. Returns the outputs and the instance's name."""
    Bsz, ns1, nx = X.shape
    ns, nu = ns1 - 1, U.shape[-1]
    dtype, dev = X.dtype, X.device
    pinned = x0 is not None
    s = host_setup(terms, (EVALUATE, dev, dtype, Bsz, ns, dt, wc, pinned),
                   lambda: _EvalSetup(terms, dtype, Bsz, ns, nx, nu, dt, wc,
                                      pinned))
    pt = [params[k] for k in PARAM_KEYS]
    check_tensors(zip(("X", "U") + PARAM_KEYS, [X, U] + pt, s.shapes),
                  dtype, dev)
    if pinned and (x0.dtype != dtype or x0.device != dev
                   or x0.shape != s.x0_shape or x0.stride(-1) != 1):
        check_tensor("x0", x0, s.x0_shape, dtype, dev, rows=True)
    for i, t in enumerate(pt):
        s.params[i] = t.data_ptr()
    buf, views = output_views(s.layout, s.total, dtype, dev)
    base = buf.data_ptr()
    outs = [base + off for _, off in s.out_slots] + [None]
    launch(EVALUATE, s.fn, dev, X.data_ptr(), U.data_ptr(),
           x0.data_ptr() if pinned else None, x0.stride(0) if pinned else 0,
           s.params, *s.args, *outs[:3])
    return tuple(views), s.shape


lip_evaluate.launches = 0
# the launches of each (topology, step) instance, by its KERNEL_SHAPES name
lip_evaluate.shape_launches = dict.fromkeys(KERNEL_SHAPES, 0)


def evaluate_occupancy(ns: int, dtype=torch.float32, shape: str = "kangaroo"):
    """lip_evaluate's occupancy at the instance `shape` and ns stage nodes
    for tensors of `dtype`, with the block of B=4096's launch (the most
    members): blocks resident on one SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), warps and shared
    memory bytes a block, registers and local (spilled) bytes a thread."""
    return occupancy_query("lip_rollout", "lip_evaluate_occupancy",
                           EVALUATE_OCCUPANCY_FIELDS, shape_index(shape),
                           int(dtype == torch.float64), ns)


def trial_occupancy(dtype=torch.float32, ns: int = 20, nA: int = 1,
                    shape: str = "kangaroo"):
    """K11's blocks resident on one SM of the current card
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), its dynamic shared
    memory bytes a block (`smem_bytes(...)["total"]`), registers and local
    (spilled) bytes a thread and warps a block, at the instance `shape`
    for tensors of `dtype`, ns stage nodes and nA step sizes a call."""
    fn = library("lip_rollout").lip_trial_occupancy
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
        fn.restype = _I
    out = (_I * 5)()
    err = fn(shape_index(shape), int(dtype == torch.float64), ns, nA, out)
    if err != 0:
        raise RuntimeError(f"lip_trial occupancy query failed: error {err}")
    return dict(zip(("blocks_per_sm", "shared_memory_bytes",
                     "registers_per_thread", "local_bytes_per_thread",
                     "warps_per_block"), out))


def lip_trial(x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1, dV2,
              terms, dt: float, wc: float, nu_w: float, beta: float,
              alpha_min: float):
    """K11. Same contract as `lip_trial_plain`; launches the CUDA kernel
    for CUDA tensors of the sizes and step of an instance in
    `KERNEL_SHAPES` (and counts the launch in `lip_trial.launches` and in
    its instance's entry of `lip_trial.shape_launches`), raises ValueError
    for others."""
    if d.device.type == "cpu":
        return lip_trial_plain(x0, X, U, ks, Ks, d, alphas, params, merit0,
                               D, dV1, dV2, terms, dt, wc, nu_w, beta,
                               alpha_min)
    out, shape = _trial_launch("lip_trial", x0, X, U, ks, Ks, d, alphas,
                               params, merit0, D, dV1, dV2, terms, dt, wc,
                               nu_w, beta, alpha_min)
    lip_trial.launches += 1
    lip_trial.shape_launches[shape] += 1
    return out


def lip_trial_chain(x0, X, U, ks, Ks, d, alphas, params, merit0, D, dV1,
                    dV2, terms, dt: float, wc: float, nu_w: float,
                    beta: float, alpha_min: float):
    """K11's chain alone on CUDA tensors (`lip_trial`'s arguments): the
    same kernel with the evaluation compiled out, returning Xn and Un. For
    timing the chain apart; the solver never calls it, and it counts no
    launch."""
    if d.device.type != "cuda":
        raise ValueError(f"lip_trial_chain runs on cuda, got {d.device}")
    return _trial_launch("lip_trial_chain", x0, X, U, ks, Ks, d, alphas,
                         params, merit0, D, dV1, dV2, terms, dt, wc, nu_w,
                         beta, alpha_min)[0][:2]


def _trial_launch(entry, x0, X, U, ks, Ks, d, alphas, params, merit0, D,
                  dV1, dV2, terms, dt, wc, nu_w, beta, alpha_min):
    shape, scalars = _checked_common("lip_trial", X, U, terms, dt, wc)
    Bsz, ns, nx = d.shape
    nu = U.shape[-1]
    dtype, dev = d.dtype, d.device
    nA = alphas.shape[0]
    check_tensor("x0", x0, (Bsz, nx), dtype, dev)
    check_tensor("X", X, (Bsz, ns + 1, nx), dtype, dev)
    check_tensor("U", U, (Bsz, ns, nu), dtype, dev)
    check_tensor("ks", ks, (Bsz, ns, nu), dtype, dev)
    check_tensor("Ks", Ks, (Bsz, ns, nu, nx), dtype, dev)
    check_tensor("d", d, (Bsz, ns, nx), dtype, dev)
    check_tensor("alphas", alphas, (nA,), dtype, dev)
    for name, t in (("merit0", merit0), ("D", D), ("dV1", dV1), ("dV2", dV2)):
        check_tensor(name, t, (Bsz,), dtype, dev)
    if _block_bytes(dtype, ns, nA, shape) > MAX_SMEM:
        raise ValueError(f"lip_trial's block does not fit {ns} stage nodes")
    pt = kernel_params(params, Bsz, ns, terms.nc, dtype, dev)
    Xn = torch.empty((nA, Bsz, ns + 1, nx), dtype=dtype, device=dev)
    Un = torch.empty((nA, Bsz, ns, nu), dtype=dtype, device=dev)
    cost = torch.empty((nA, Bsz), dtype=dtype, device=dev)
    merit = torch.empty((nA, Bsz), dtype=dtype, device=dev)
    ok = torch.empty((nA, Bsz), dtype=torch.bool, device=dev)
    ptrs = (_P * len(pt))(*(t.data_ptr() for t in pt))
    fn = _fn(entry, dtype, [_P] * 12 + [_I] * 7 + [_P] + [_D] * 3 + [_P] * 6)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            x0.data_ptr(), X.data_ptr(), U.data_ptr(), ks.data_ptr(),
            Ks.data_ptr(), d.data_ptr(), alphas.data_ptr(), ptrs,
            merit0.data_ptr(), D.data_ptr(), dV1.data_ptr(), dV2.data_ptr(),
            Bsz, ns, terms.nc, terms.contact_model, terms.number_of_legs,
            STEPS.index(terms.step), nA, scalars, float(nu_w), float(beta), float(alpha_min),
            Xn.data_ptr(), Un.data_ptr(), cost.data_ptr(), merit.data_ptr(),
            ok.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel failed: CUDA error {err}")
    return (Xn, Un, cost, merit, ok), shape


lip_trial.launches = 0
# the launches of each (topology, step) instance, by its KERNEL_SHAPES name
lip_trial.shape_launches = dict.fromkeys(KERNEL_SHAPES, 0)
