"""PyTorch port, the CUDA kernels against their plain versions on the card,
with the tolerances of chip_smoke.py: float64 to 1e-9 relative; in
float32 against the float64 plain result, K1 to 1e-6 relative (it
computes in float64 on chip, so only float32 storage rounding remains),
and K3 (the fused trial) and K4 (the linearization) within 2× the float32
plain version's own error plus 1e-6, K4 also below 1e-5; the isrbd kernels
K5 (linearization), K6 (trial) and K1 with 18 of 30 live B columns by the
rules of K4, K3 and K1; K1 at ragged fleet sizes on both of its compiled
shapes, and refusing any other; K2 (the SPD inverse inside K1) through
its own entry, float64 to 1e-9 against `lm_spd_inverse` and float32 to
1e-6 of the float64 inverse of the same float32 stack; K3 and K4 at
ragged fleet sizes (B = 1, 133, 513; K3 with one and four step sizes);
the evaluation entries `srbd_evaluate` and `isrbd_evaluate` (cost and
largest defect of a plan) by K3's rules, a member with a NaN plan giving
NaN in both, and given x0 the pinned plan equal to the twin's bit for bit
(a NaN in one member's x0 kept), with their occupancy entries reporting at
least one block an SM; K3, K4 and srbd_evaluate refusing sizes they
were not compiled for; and the AL layer's entries (csrc/isrbd_al.cu) against
their twins with a NaN member: K7 in every mode, float64 to 1e-12 of
max(1, |twin|) entry by entry and float32 by K3's rule, K8a with no, the
tail and the full prior, K8b with and without bound overrides and K8c for
both priors, bit for bit in both types, at B = 1 and 257 as well, counting
their launches and refusing other sizes and non-contiguous views, and K7
called again on the views of its previous call's one output buffer; and
K1's Tassa instantiations (`MSDDP.solve`'s sweep: SRBD with the
block-Schur and with the Cholesky gain solve, isrbd with Cholesky)
against the Tassa twin at B = 1 and 64 by K1's rules, a NaN member kept
NaN where the twin is, an indefinite Quu giving NaN gains, the
uncompiled combinations refused before any launch, and their shared
memory equal to the collapsed form's; and the LIP kernels (K10, K11,
lip_evaluate) against their twins at B = 1, 64, 513, float64 within 1e-12
of max(1, |twin|) entry by entry (K10's Jacobians bit for bit), float32
by K3's rule, NaN members kept, the pinned plan bit for bit, K1's three
LIP instantiations by K1's rules, and refusing the LIP on point feet; and
the point-feet quadruped's instantiations (K4, K3, srbd_evaluate at
`srbd::QuadShape`, K1's collapsed and Tassa forms at `QuadShape`) by the
rules of K4, K3, srbd_evaluate and K1 at B = 1 and a fleet, with their
occupancy, K1's uncompiled Cholesky Tassa form refused; and the
constrained quadruped's (K5, K1 collapsed and Tassa-Cholesky, K6,
isrbd_evaluate, K7 and K8a-c at `isrbd::QuadAlShape` and K1's
`isrbd_al_quadruped`) by the rules of the Kangaroo's isrbd kernels, with
their occupancy, K1's block-Schur Tassa form there refused; and the
execution modes' kernels, K12 and K13, at every shape they are compiled
for (the SRBD and LIP shapes, the quadruped's, the two AL inner shapes
with K12's Cholesky gains) against their twins, float64 K12 to 1e-8 and
K13 to 1e-9, float32 to 1e-6 of the float64 twin, with their occupancy,
and refusing other sizes and K12's block-Schur gains at the AL shapes;
and the SRBD family's new instances (the point-feet biped under Euler,
each topology under RK2 and RK4: K4, K3, srbd_evaluate, and K1 in every
form compiled at their shapes) at B = 1, 64 and 133, K4, K3 and
srbd_evaluate in float64 within 1e-12 of max(1, |twin|), by their float32
rules, NaN members kept, each launch counted at its own instance, the
problem with another step refused, with their occupancy, and K2 at nu=12;
and K12 (both gain solves) and K13 (the instance's own family, its step in
the true defects) at those instances by the modes' rules, with their
occupancy, and K1's Tassa-Cholesky form at the quadruped's shapes and the
point-feet biped's RK shape.
Skipped
where no CUDA device is present (run on the card with
`python -m pytest tests/test_torch_kernels_cuda.py -m cuda`)."""

import numpy as np
import pytest
import torch

from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import isrbd_al as k78
from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
from srbd_horizon_tpu_torch.kernels import isrbd_rollout as k6
from srbd_horizon_tpu_torch.kernels import linearize as k4
from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
from srbd_horizon_tpu_torch.kernels import lip_rollout as k11
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels import rollout as k3
from srbd_horizon_tpu_torch.math.linalg import lm_spd_inverse
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
from srbd_horizon_tpu_torch.runtime.loop import build_srbd_loop
from srbd_horizon_tpu_torch.solvers.alddp import ALDDP

pytestmark = pytest.mark.cuda

ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
B = 64
K1_F32_TOL = 1e-6
K4_F32_CAP = 1e-5


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.fixture(scope="module")
def card_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    loop, prob = build_srbd_loop(SRBDConfig(dtype=torch.float64),
                                 DDPOptions(max_iters=5), device=dev)
    loop32, _ = build_srbd_loop(SRBDConfig(), DDPOptions(max_iters=5),
                                device=dev)
    ocp, solver = prob.ocp, loop.solver
    rng = np.random.RandomState(0)
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    X = torch.as_tensor(prob.initial_state.cpu().numpy()[None, None]
                        + 0.02 * rng.randn(B, ns + 1, nx), device=dev)
    U = torch.as_tensor(prob.static_input.cpu().numpy()[None, None]
                        + 0.05 * rng.randn(B, ns, nu), device=dev)
    params = {k: v.expand((B,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    lin = k4.srbd_linearize_plain(X, U, params, solver.terms, solver.rows,
                                  ocp.dt, solver._wc(torch.float64))
    x0 = X[:, 0] + 0.005 * torch.as_tensor(rng.randn(B, nx), device=dev)
    return dict(lin=lin, rows=solver.rows, mu=solver.opts.mu0, X=X, U=U,
                x0=x0, ocp=ocp, params=params, solver=solver,
                solver32=loop32.solver)


def _k1(case, dtype, fn):
    args = tuple(case["lin"][k].to(dtype).contiguous() for k in ORDER)
    return fn(*args, case["mu"], case["rows"])


def test_riccati_kernel_matches_plain(card_case):
    ref = _k1(card_case, torch.float64, k1.riccati_backward_plain)
    got = _k1(card_case, torch.float64, k1.riccati_backward)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-9
    got32 = _k1(card_case, torch.float32, k1.riccati_backward)
    for g, r in zip(got32, ref):
        assert _rel(g, r) <= K1_F32_TOL


def _lin_args(case, dtype):
    s = case["solver"] if dtype == torch.float64 else case["solver32"]
    t = lambda a: a.to(dtype).contiguous()
    return (t(case["X"]), t(case["U"]),
            {k: t(v) for k, v in case["params"].items()}, s.terms, s.rows,
            case["ocp"].dt, s._wc(dtype))


def test_linearize_kernel_matches_plain(card_case):
    ref = k4.srbd_linearize_plain(*_lin_args(card_case, torch.float64))
    got = k4.srbd_linearize(*_lin_args(card_case, torch.float64))
    torch.cuda.synchronize()
    for k in ORDER:
        assert _rel(got[k], ref[k]) <= 1e-9, k
    got32 = k4.srbd_linearize(*_lin_args(card_case, torch.float32))
    plain32 = k4.srbd_linearize_plain(*_lin_args(card_case, torch.float32))
    for k in ORDER:
        e = _rel(got32[k], ref[k])
        assert e <= 2 * _rel(plain32[k], ref[k]) + 1e-6 and e <= K4_F32_CAP, k


def test_rollout_kernel_matches_plain(card_case):
    """K3, the fused trial (rollout, cost, Armijo test), for 4 step sizes."""
    ref_k = _k1(card_case, torch.float64, k1.riccati_backward_plain)
    lin = card_case["lin"]
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=torch.float64,
                          device=card_case["X"].device)
    opts = card_case["solver"].opts

    def args(dtype):
        s = card_case["solver"] if dtype == torch.float64 else card_case["solver32"]
        t = lambda a: a.to(dtype).contiguous()
        cost0 = s.total_cost(t(card_case["X"]), t(card_case["U"]),
                             {k: t(v) for k, v in card_case["params"].items()})
        return (t(card_case["x0"]), t(card_case["X"]), t(card_case["U"]),
                t(ref_k[0]), t(ref_k[1]), t(lin["d"]), t(alphas),
                {k: t(v) for k, v in card_case["params"].items()},
                t(cost0 + opts.defect_weight * D), t(D), t(ref_k[2]),
                t(ref_k[3]), s.terms, card_case["ocp"].dt, s._wc(dtype),
                opts.defect_weight, opts.beta, opts.alpha_converge_threshold)

    ref = k3.srbd_trial_plain(*args(torch.float64))
    got = k3.srbd_trial(*args(torch.float64))
    torch.cuda.synchronize()
    for g, r in zip(got[:4], ref[:4]):
        assert _rel(g, r) <= 1e-9
    assert torch.equal(got[4], ref[4])
    got32 = k3.srbd_trial(*args(torch.float32))
    plain32 = k3.srbd_trial_plain(*args(torch.float32))
    for g, p, r in zip(got32[:4], plain32[:4], ref[:4]):
        assert _rel(g, r) <= 2 * _rel(p, r) + 1e-6


def test_wrappers_count_launches_and_check_inputs(card_case):
    before = k1.riccati_backward.launches
    _k1(card_case, torch.float32, k1.riccati_backward)
    assert k1.riccati_backward.launches == before + 1
    lin = {k: v.float() for k, v in card_case["lin"].items()}
    bad = dict(lin, Sx=lin["Sx"].transpose(-1, -2).contiguous().transpose(-1, -2))
    with pytest.raises(ValueError):
        k1.riccati_backward(*(bad[k] for k in ORDER), card_case["mu"],
                            card_case["rows"])
    assert k1.riccati_backward.launches == before + 1
    before4 = k4.srbd_linearize.launches
    X, U, params, *rest = _lin_args(card_case, torch.float32)
    k4.srbd_linearize(X, U, params, *rest)
    assert k4.srbd_linearize.launches == before4 + 1
    with pytest.raises(ValueError):
        k4.srbd_linearize(X, U, dict(params, oref=params["oref"].double()), *rest)
    assert k4.srbd_linearize.launches == before4 + 1


# ---------------- the isrbd kernels ----------------

def _isrbd_point(build, seed=1):
    """A linearization point of the AL inner problem `build(dtype)` (an
    ALDDP) with active cones and boxes, a non-unit quaternion and random
    0/1 node masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    al, al32 = build(torch.float64, dev), build(torch.float32, dev)
    ocp = al.ocp
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    n_eq, n_eq_T, n_in = al._sizes
    g = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    X = np.zeros((B, ns + 1, nx))
    X[..., 0:3] = [0.0, 0.0, 0.88] + 0.05 * g.randn(B, ns + 1, 3)
    X[..., 3:7] = [0.1, -0.2, 0.05, 0.97] + 0.02 * g.randn(B, ns + 1, 4)
    X[..., 7:] = g.uniform(-0.3, 0.3, (B, ns + 1, nx - 7))
    U = 0.5 * g.randn(B, ns, nu)
    for q in range(4):
        U[..., 9 + 6 * q:12 + 6 * q] = ([0.0, 0.0, 98.0]
                                        + [60.0, 60.0, 5.0] * g.randn(B, ns, 3))
    U[0, ns // 2:, 9:12] = 0.0      # exact ties on member 0's first contact
    pos = lambda *shape: t(np.abs(g.randn(*shape)))
    mu_ub = 5.0 * pos(B, ns, n_in)
    mu_ub[0, ns // 2:, 0:5] = 0.0
    st = al.init(t(X[:, 0]))._replace(
        lam_eq=t(g.randn(B, ns, n_eq)), lam_eq_T=t(g.randn(B, n_eq_T)),
        mu_ub=mu_ub, mu_lb=pos(B, ns, n_in),
        mu_x_ub=pos(B, ns + 1, nx), mu_x_lb=pos(B, ns + 1, nx),
        mu_u_ub=pos(B, ns, nu), mu_u_lb=pos(B, ns, nu),
        rho=t(10.0 ** g.uniform(3, 5, B)))
    params = {k: v.expand((B,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    for k in ("mask_track", "mask_srbd", "mask_lip", "mask_lipzone"):
        params[k] = t(g.randint(0, 2, tuple(params[k].shape)))
    params["Wo"] = pos(B, ns + 1, 1)
    for name, lo, hi in (("x", -0.1, 0.1), ("u", 60.0, 130.0)):
        lb = getattr(ocp, f"{name}_lb").expand(B, -1, -1).clone()
        ub = getattr(ocp, f"{name}_ub").expand(B, -1, -1).clone()
        fin = torch.isfinite(ub)
        lb[fin], ub[fin] = lo, hi
        params[f"{name}_lb"], params[f"{name}_ub"] = lb, ub
    pin = {k: v.contiguous()
           for k, v in al._params_with_multipliers(params, st).items()}
    X, U = t(X), t(U)
    lin = k5.isrbd_linearize_plain(X, U, pin, al.terms, al.inner.rows, ocp.dt)
    x0 = X[:, 0] + 0.005 * t(g.randn(B, nx))
    return dict(al=al, al32=al32, X=X, U=U, pin=pin, lin=lin, x0=x0, ocp=ocp,
                st=st, params=params)


@pytest.fixture(scope="module")
def isrbd_case():
    """The point on the Kangaroo's serving configuration."""
    return _isrbd_point(lambda dtype, dev: ALDDP(build_isrbd_problem(
        SRBDConfig(dtype=dtype), kangaroo_line_feet(), cz_rho_weight=3200.0,
        device=dev).ocp, DDPOptions(max_iters=1)))


def _k5_args(case, dtype):
    a = case["al"] if dtype == torch.float64 else case["al32"]
    t = lambda v: v.to(dtype).contiguous()
    return (t(case["X"]), t(case["U"]), {k: t(v) for k, v in case["pin"].items()},
            a.terms, a.inner.rows, case["ocp"].dt)


def test_isrbd_linearize_kernel_matches_plain(isrbd_case):
    ref = isrbd_case["lin"]
    got = k5.isrbd_linearize(*_k5_args(isrbd_case, torch.float64))
    torch.cuda.synchronize()
    for k in ORDER:
        assert _rel(got[k], ref[k]) <= 1e-9, k
    got32 = k5.isrbd_linearize(*_k5_args(isrbd_case, torch.float32))
    plain32 = k5.isrbd_linearize_plain(*_k5_args(isrbd_case, torch.float32))
    for k in ORDER:
        e = _rel(got32[k], ref[k])
        assert e <= 2 * _rel(plain32[k], ref[k]) + 1e-6 and e <= K4_F32_CAP, k


def test_riccati_kernel_with_live_columns_matches_plain(isrbd_case):
    rows = isrbd_case["al"].inner.rows
    assert len(rows.uc) == 18 and isrbd_case["lin"]["Bs"].shape[-1] == 18
    args = lambda dtype: tuple(isrbd_case["lin"][k].to(dtype).contiguous()
                               for k in ORDER) + (1e-6, rows)
    ref = k1.riccati_backward_plain(*args(torch.float64))
    got = k1.riccati_backward(*args(torch.float64))
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-9
    for g, r in zip(k1.riccati_backward(*args(torch.float32)), ref):
        assert _rel(g, r) <= K1_F32_TOL
    # float32 tensors stay float32 in shared memory: two blocks an SM or
    # more at these sizes (three, at 73,356 B)
    assert k1.shared_memory_bytes(37, 30, 101, rows) <= 113 * 1024
    assert k1.blocks_per_sm(37, 30, 101, rows) >= 2


def test_isrbd_trial_kernel_matches_plain(isrbd_case):
    """K6, the fused isrbd trial, for 4 step sizes."""
    al = isrbd_case["al"]
    lin, rows = isrbd_case["lin"], al.inner.rows
    ref_k = k1.riccati_backward_plain(*(lin[k] for k in ORDER), 1e-6, rows)
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=torch.float64,
                          device=D.device)
    opts = al.inner.opts
    cost0 = al.inner.total_cost(isrbd_case["X"], isrbd_case["U"],
                                isrbd_case["pin"])

    def args(dtype):
        a = al if dtype == torch.float64 else isrbd_case["al32"]
        t = lambda v: v.to(dtype).contiguous()
        return (t(isrbd_case["x0"]), t(isrbd_case["X"]), t(isrbd_case["U"]),
                t(ref_k[0]), t(ref_k[1]), t(lin["d"]), t(alphas),
                {k: t(v) for k, v in isrbd_case["pin"].items()},
                t(cost0 + opts.defect_weight * D), t(D), t(ref_k[2]),
                t(ref_k[3]), a.terms, isrbd_case["ocp"].dt,
                opts.defect_weight, opts.beta, opts.alpha_converge_threshold)

    ref = k6.isrbd_trial_plain(*args(torch.float64))
    got = k6.isrbd_trial(*args(torch.float64))
    torch.cuda.synchronize()
    for g, r in zip(got[:4], ref[:4]):
        assert _rel(g, r) <= 1e-9
    assert torch.equal(got[4], ref[4])
    got32 = k6.isrbd_trial(*args(torch.float32))
    plain32 = k6.isrbd_trial_plain(*args(torch.float32))
    for g, p, r in zip(got32[:4], plain32[:4], ref[:4]):
        assert _rel(g, r) <= 2 * _rel(p, r) + 1e-6


def test_isrbd_wrappers_count_launches_and_check_inputs(isrbd_case):
    before = k5.isrbd_linearize.launches
    X, U, pin, *rest = _k5_args(isrbd_case, torch.float32)
    k5.isrbd_linearize(X, U, pin, *rest)
    assert k5.isrbd_linearize.launches == before + 1
    with pytest.raises(ValueError):
        k5.isrbd_linearize(X, U, dict(pin, al_rho=pin["al_rho"].double()), *rest)
    with pytest.raises(ValueError):
        k5.isrbd_linearize(X[:, :, :-1].contiguous(), U, pin, *rest)
    assert k5.isrbd_linearize.launches == before + 1


# ---------------- K1 at ragged fleet sizes, K2 alone ----------------

def _repeat_lin(lin, Bw):
    """The linearization's members repeated up to Bw members."""
    n = lin["d"].shape[0]
    reps = -(-Bw // n)
    return {k: torch.cat([v] * reps)[:Bw].contiguous() for k, v in lin.items()}


@pytest.mark.parametrize("Bw", [1, 133, 265])
@pytest.mark.parametrize("shape", ["srbd", "isrbd_al"])
def test_riccati_kernel_at_ragged_fleet_sizes(card_case, isrbd_case, shape, Bw):
    """Fleets that leave the last wave of blocks part-full, on both
    instantiations, float64 to 1e-9 and float32 to K1_F32_TOL."""
    if shape == "srbd":
        lin, mu, rows = card_case["lin"], card_case["mu"], card_case["rows"]
    else:
        lin, mu, rows = isrbd_case["lin"], 1e-6, isrbd_case["al"].inner.rows
    lin = _repeat_lin(lin, Bw)
    assert k1.kernel_shape(lin["d"].shape[-1], lin["Jup"].shape[-1],
                           lin["Jt"].shape[1], rows) == shape
    args = lambda dtype: tuple(lin[k].to(dtype).contiguous()
                               for k in ORDER) + (mu, rows)
    ref = k1.riccati_backward_plain(*args(torch.float64))
    got = k1.riccati_backward(*args(torch.float64))
    got32 = k1.riccati_backward(*args(torch.float32))
    torch.cuda.synchronize()
    for g, g32, r in zip(got, got32, ref):
        assert _rel(g, r) <= 1e-9
        assert _rel(g32, r) <= K1_F32_TOL


def test_riccati_kernel_refuses_unknown_shape(card_case):
    """Sizes of no compiled instantiation raise ValueError before any
    launch: here the SRBD sweep with one terminal row fewer."""
    lin = {k: v.float() for k, v in card_case["lin"].items()}
    lin["Jt"], lin["rt"] = lin["Jt"][:, 1:].contiguous(), lin["rt"][:, 1:].contiguous()
    before = k1.riccati_backward.launches
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k1.riccati_backward(*(lin[k] for k in ORDER), card_case["mu"],
                            card_case["rows"])
    assert k1.riccati_backward.launches == before
    A = torch.eye(23, dtype=torch.float64, device=lin["d"].device)[None]
    with pytest.raises(ValueError):
        k1.spd_inverse(A.contiguous())


@pytest.mark.parametrize("shape", ["srbd", "isrbd_al"])
def test_spd_inverse_matches_plain(card_case, isrbd_case, shape):
    """K2 alone on the Quu-like stack 2JupᵀJup + μI of each shape."""
    lin = card_case["lin"] if shape == "srbd" else isrbd_case["lin"]
    nu = lin["Jup"].shape[-1]
    J = lin["Jup"].reshape(-1, lin["Jup"].shape[-2], nu)
    Q = (2.0 * J.transpose(-1, -2) @ J + 1e-6 * torch.eye(
        nu, dtype=torch.float64, device=J.device)).contiguous()
    before = k1.spd_inverse.launches
    got = k1.spd_inverse(Q)
    Q32 = Q.float()
    got32 = k1.spd_inverse(Q32)
    torch.cuda.synchronize()
    assert k1.spd_inverse.launches == before + 2
    assert _rel(got, lm_spd_inverse(Q)) <= 1e-9
    # the kernel carries the float32 stack in float64: only the rounding of
    # its output is left against the float64 inverse of that same stack
    assert _rel(got32, lm_spd_inverse(Q32.double())) <= 1e-6


# ---------------- K3 and K4 at ragged fleet sizes ----------------

def _repeat(t, Bw):
    reps = -(-Bw // t.shape[0])
    return torch.cat([t] * reps)[:Bw].contiguous()


def _rel_fin(got, want):
    """_rel over the entries where `want` is finite; inf if the non-finite
    entries differ."""
    got, want = got.double(), want.double()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return _rel(got[fin], want[fin])


@pytest.mark.parametrize("Bw", [1, 133, 513])
def test_linearize_kernel_at_ragged_fleet_sizes(card_case, Bw):
    """K4 where the last block of 4 member-nodes and the last terminal
    block are part-full, and the fleet leaves the last wave part-full."""
    def args(dtype):
        X, U, params, *rest = _lin_args(card_case, dtype)
        return (_repeat(X, Bw), _repeat(U, Bw),
                {k: _repeat(v, Bw) for k, v in params.items()}, *rest)

    ref = k4.srbd_linearize_plain(*args(torch.float64))
    got = k4.srbd_linearize(*args(torch.float64))
    got32 = k4.srbd_linearize(*args(torch.float32))
    plain32 = k4.srbd_linearize_plain(*args(torch.float32))
    torch.cuda.synchronize()
    for k in ORDER:
        assert got[k].shape == ref[k].shape, k
        assert _rel(got[k], ref[k]) <= 1e-9, k
        e = _rel(got32[k], ref[k])
        assert e <= 2 * _rel(plain32[k], ref[k]) + 1e-6 and e <= K4_F32_CAP, k


@pytest.mark.parametrize("nA", [1, 4])
@pytest.mark.parametrize("Bw", [1, 133, 513])
def test_rollout_kernel_at_ragged_fleet_sizes(card_case, Bw, nA):
    """K3 for one and four step sizes on fleets of 1, 133 and 513 members;
    past one member, member 1 starts from a NaN state and is rejected."""
    ref_k = _k1(card_case, torch.float64, k1.riccati_backward_plain)
    lin = card_case["lin"]
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125][:nA], dtype=torch.float64,
                          device=D.device)
    opts = card_case["solver"].opts
    x0 = _repeat(card_case["x0"], Bw)
    if Bw > 1:
        x0[1] = float("nan")
    cost0 = card_case["solver"].total_cost(card_case["X"], card_case["U"],
                                           card_case["params"])
    rep = lambda t: _repeat(t, Bw)

    def args(dtype):
        s = card_case["solver"] if dtype == torch.float64 else card_case["solver32"]
        t = lambda a: rep(a).to(dtype).contiguous()
        return (t(x0), t(card_case["X"]), t(card_case["U"]), t(ref_k[0]),
                t(ref_k[1]), t(lin["d"]), alphas.to(dtype),
                {k: t(v) for k, v in card_case["params"].items()},
                t(cost0 + opts.defect_weight * D), t(D), t(ref_k[2]),
                t(ref_k[3]), s.terms, card_case["ocp"].dt, s._wc(dtype),
                opts.defect_weight, opts.beta, opts.alpha_converge_threshold)

    ref = k3.srbd_trial_plain(*args(torch.float64))
    got = k3.srbd_trial(*args(torch.float64))
    got32 = k3.srbd_trial(*args(torch.float32))
    plain32 = k3.srbd_trial_plain(*args(torch.float32))
    torch.cuda.synchronize()
    for g, g32, p, r in zip(got[:4], got32[:4], plain32[:4], ref[:4]):
        assert g.shape == r.shape
        assert _rel_fin(g, r) <= 1e-9
        assert _rel_fin(g32, r) <= 2 * _rel_fin(p, r) + 1e-6
    assert torch.equal(got[4], ref[4])
    if Bw > 1:
        assert not bool(got[4][:, 1].any()) and not bool(got32[4][:, 1].any())
        assert bool(torch.isnan(got[2][:, 1]).all())


# ---------------- the evaluation entries ----------------

def _evaluate_check(plain, kernel, args):
    """Kernel against twin: float64 to 1e-9, float32 within 2× the float32
    twin's error + 1e-6 (against the float64 twin), NaN where the twin has
    NaN."""
    ref = plain(*args(torch.float64))
    got = kernel(*args(torch.float64))
    got32 = kernel(*args(torch.float32))
    plain32 = plain(*args(torch.float32))
    torch.cuda.synchronize()
    for g, g32, p, r in zip(got, got32, plain32, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert _rel_fin(g, r) <= 1e-9
        assert _rel_fin(g32, r) <= 2 * _rel_fin(p, r) + 1e-6
    return ref, got, got32


@pytest.mark.parametrize("Bw", [1, 64, 513])
def test_srbd_evaluate_matches_plain(card_case, Bw):
    X = _repeat(card_case["X"], Bw)
    if Bw > 1:
        X[1, 5, 4] = float("nan")

    def args(dtype):
        s = card_case["solver"] if dtype == torch.float64 else card_case["solver32"]
        t = lambda a: a.to(dtype).contiguous()
        return (t(X), t(_repeat(card_case["U"], Bw)),
                {k: t(_repeat(v, Bw)) for k, v in card_case["params"].items()},
                s.terms, card_case["ocp"].dt, s._wc(dtype))

    before = k3.srbd_evaluate.launches
    ref, got, got32 = _evaluate_check(k3.srbd_evaluate_plain,
                                      k3.srbd_evaluate, args)
    assert k3.srbd_evaluate.launches == before + 2
    if Bw > 1:
        for out in (got, got32):
            assert bool(torch.isnan(out[0][1])) and bool(torch.isnan(out[1][1]))
        assert bool(torch.isfinite(got[0][2:]).all())


@pytest.mark.parametrize("Bw", [1, 64, 257])
def test_isrbd_evaluate_matches_plain(isrbd_case, Bw):
    U = _repeat(isrbd_case["U"], Bw)
    if Bw > 1:
        U[1, 3, 0] = float("nan")          # r̈ₓ: the RK2 step reads it

    def args(dtype):
        a = isrbd_case["al"] if dtype == torch.float64 else isrbd_case["al32"]
        t = lambda v: v.to(dtype).contiguous()
        return (t(_repeat(isrbd_case["X"], Bw)), t(U),
                {k: t(_repeat(v, Bw)) for k, v in isrbd_case["pin"].items()},
                a.terms, isrbd_case["ocp"].dt)

    before = k6.isrbd_evaluate.launches
    ref, got, got32 = _evaluate_check(k6.isrbd_evaluate_plain,
                                      k6.isrbd_evaluate, args)
    assert k6.isrbd_evaluate.launches == before + 2
    if Bw > 1:
        for out in (got, got32):
            assert bool(torch.isnan(out[0][1])) and bool(torch.isnan(out[1][1]))


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _pinned_check(plain, kernel, args):
    """With x0: the cost and largest defect by `_evaluate_check`'s rules,
    and the pinned plan equal to the twin's bit for bit, in both types."""
    ref, got, got32 = _evaluate_check(plain, kernel, args)
    assert len(ref) == len(got) == len(got32) == 3
    for dtype, out in ((torch.float64, got), (torch.float32, got32)):
        want = plain(*args(dtype))[2]
        assert torch.equal(_bits(out[2]), _bits(want))
    return ref, got, got32


@pytest.mark.parametrize("Bw", [1, 64, 513])
def test_srbd_evaluate_pins_node0(card_case, Bw):
    x0 = _repeat(card_case["x0"], Bw)
    if Bw > 1:
        x0[1, 4] = float("nan")

    def args(dtype):
        s = card_case["solver"] if dtype == torch.float64 else card_case["solver32"]
        t = lambda a: a.to(dtype).contiguous()
        return (t(_repeat(card_case["X"], Bw)), t(_repeat(card_case["U"], Bw)),
                {k: t(_repeat(v, Bw)) for k, v in card_case["params"].items()},
                s.terms, card_case["ocp"].dt, s._wc(dtype), t(x0))

    before = k3.srbd_evaluate.launches
    ref, got, got32 = _pinned_check(k3.srbd_evaluate_plain, k3.srbd_evaluate,
                                    args)
    assert k3.srbd_evaluate.launches == before + 2
    if Bw > 1:
        for out in (got, got32):
            assert bool(torch.isnan(out[0][1])) and bool(torch.isnan(out[1][1]))
        assert bool(torch.isfinite(got[0][2:]).all())


@pytest.mark.parametrize("Bw", [1, 64, 257])
def test_isrbd_evaluate_pins_node0(isrbd_case, Bw):
    x0 = _repeat(isrbd_case["x0"], Bw)
    if Bw > 1:
        x0[1, 4] = float("nan")

    def args(dtype):
        a = isrbd_case["al"] if dtype == torch.float64 else isrbd_case["al32"]
        t = lambda v: v.to(dtype).contiguous()
        return (t(_repeat(isrbd_case["X"], Bw)), t(_repeat(isrbd_case["U"], Bw)),
                {k: t(_repeat(v, Bw)) for k, v in isrbd_case["pin"].items()},
                a.terms, isrbd_case["ocp"].dt, t(x0))

    before = k6.isrbd_evaluate.launches
    ref, got, got32 = _pinned_check(k6.isrbd_evaluate_plain,
                                    k6.isrbd_evaluate, args)
    assert k6.isrbd_evaluate.launches == before + 2
    if Bw > 1:
        for out in (got, got32):
            assert bool(torch.isnan(out[0][1])) and bool(torch.isnan(out[1][1]))


def test_evaluate_takes_strided_x0(card_case, isrbd_case):
    """x0 as a node of a plan (rows ns+1 nodes apart, as the serving tick
    passes X[:, 1]): the same outputs as its contiguous copy, bit for bit."""
    s = card_case["solver"]
    a = isrbd_case["al"]
    cases = ((k3.srbd_evaluate, card_case["X"], card_case["U"],
              card_case["params"], (s.terms, card_case["ocp"].dt,
                                    s._wc(torch.float64))),
             (k6.isrbd_evaluate, isrbd_case["X"], isrbd_case["U"],
              isrbd_case["pin"], (a.terms, isrbd_case["ocp"].dt)))
    for kernel, X, U, params, rest in cases:
        x0 = X[:, 1]
        assert not x0.is_contiguous()
        got = kernel(X, U, params, *rest, x0=x0)
        want = kernel(X, U, params, *rest, x0=x0.contiguous())
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))
        assert torch.equal(got[2][:, 0], X[:, 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_evaluate_occupancy(card_case, dtype):
    ns = card_case["ocp"].ns
    for mod in (k3, k6):
        occ = mod.evaluate_occupancy(ns, dtype)
        assert occ["blocks_per_sm"] >= 1 and occ["warps_per_block"] >= 1
        assert occ["shared_memory_bytes"] > 0 and occ["registers_per_thread"] > 0


def test_srbd_kernels_refuse_unknown_shape(card_case):
    """K3, K4 and srbd_evaluate on CUDA tensors of a problem with one
    contact fewer: ValueError before any launch."""
    import dataclasses

    s = card_case["solver"]
    terms = dataclasses.replace(s.terms, nc=3)
    dev = card_case["X"].device
    Bw, ns, nx, nu = 2, card_case["ocp"].ns, 31, 18
    e = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=dev)
    params = {k: e(Bw, ns + 1, v.shape[-1]) for k, v in card_case["params"].items()}
    X, U = e(Bw, ns + 1, nx), e(Bw, ns, nu)
    dt, wc = card_case["ocp"].dt, s._wc(torch.float64)
    counts = (k3.srbd_trial.launches, k3.srbd_evaluate.launches,
              k4.srbd_linearize.launches)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k4.srbd_linearize(X, U, params, terms, s.rows, dt, wc)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k3.srbd_evaluate(X, U, params, terms, dt, wc)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k3.srbd_trial(e(Bw, nx), X, U, e(Bw, ns, nu), e(Bw, ns, nu, nx),
                      e(Bw, ns, nx), e(1), params, e(Bw), e(Bw), e(Bw), e(Bw),
                      terms, dt, wc, 1e-3, 0.1, 1e-12)
    assert counts == (k3.srbd_trial.launches, k3.srbd_evaluate.launches,
                      k4.srbd_linearize.launches)


# ---------------- the AL layer: K7 and K8 ----------------

AL_F64_TOL = 1e-12
NAN_MEMBER = 5


def _flat(res, prefix=""):
    """The tensors of an entry's result, (name, tensor), in a fixed order."""
    if isinstance(res, dict):
        items = sorted(res.items())
    elif hasattr(res, "_fields"):
        items = zip(res._fields, res)
    else:
        items = ((str(i), v) for i, v in enumerate(res))
    out = []
    for k, v in items:
        out += ([(prefix + k, v)] if isinstance(v, torch.Tensor)
                else _flat(v, prefix + k + "."))
    return out


def _cast(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype).contiguous() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_cast(v, dtype) for v in tree))
    return tree


def _same(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(_bits(a), _bits(b)) if a.is_floating_point() else torch.equal(a, b)


def _al_point(c, seed=7):
    """The isrbd point `c` with member NAN_MEMBER's r̈ₓ at node 3 and one of
    its stage multipliers NaN, phase tables of P=20 (a NaN in that member's
    rows), phases that wrap the tail's phase − 1."""
    dev, al = c["X"].device, c["al"]
    g = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    ns = c["ocp"].ns
    n_eq, n_eq_T, _ = al._sizes
    U = c["U"].clone()
    U[NAN_MEMBER, 3, 0] = float("nan")
    st = c["st"]._replace(sol=c["st"].sol._replace(X=c["X"], U=U),
                          lam_eq=c["st"].lam_eq.clone())
    st.lam_eq[NAN_MEMBER, 2, 4] = float("nan")
    P = 20
    phase = torch.as_tensor(g.randint(0, P, B), dtype=torch.int32, device=dev)
    phase[:3] = torch.tensor([0, 1, P - 1], dtype=torch.int32)
    full = al.init_full_phase_prior(P, B)._replace(
        lam_eq=t(g.randn(B, P, ns, n_eq)), lam_eq_T=t(g.randn(B, P, n_eq_T)),
        seen=torch.as_tensor(g.rand(B, P) < 0.5, device=dev))
    tail = al.init_phase_prior(P, B)._replace(
        lam_tail=t(g.randn(B, P, n_eq)), lam_T=t(g.randn(B, P, n_eq_T)),
        seen_tail=torch.as_tensor(g.rand(B, P) < 0.5, device=dev),
        seen_T=torch.as_tensor(g.rand(B, P) < 0.5, device=dev))
    full.lam_eq[NAN_MEMBER, :, 1, 1] = float("nan")
    tail.lam_tail[NAN_MEMBER, :, 3] = float("nan")
    static = {k: v for k, v in c["params"].items()
              if k not in ("x_lb", "x_ub", "u_lb", "u_ub")}
    return dict(al=al, al32=c["al32"], st=st, phase=phase,
                priors={"none": None, "tail": tail, "full": full},
                bounds={"static": static, "boxes": c["params"]},
                viol_later=t(10.0 ** g.uniform(-3, 3, B)))


@pytest.fixture(scope="module")
def al_case(isrbd_case):
    return _al_point(isrbd_case)


def _al_run(case, kernel, plain, args, exact):
    """`args(al, dtype)` gives (args, kwargs). Returns the outputs: float64
    twin and kernel, float32 twin and kernel."""
    out = []
    for dtype in (torch.float64, torch.float32):
        al = case["al"] if dtype == torch.float64 else case["al32"]
        a, kw = args(al, dtype)
        out += [_flat(plain(*a, **kw)), _flat(kernel(*a, **kw))]
    torch.cuda.synchronize()
    ref, got, p32, g32 = out
    assert [n for n, _ in ref] == [n for n, _ in got] == [n for n, _ in g32]
    flt = [i for i, (_, v) in enumerate(ref) if v.is_floating_point()]
    assert any(bool(torch.isnan(ref[i][1][NAN_MEMBER]).any()) for i in flt
               if ref[i][1].dim() and ref[i][1].shape[0] == ref[flt[0]][1].shape[0])
    if exact:
        for (n, g), (_, r) in zip(got, ref):
            assert _same(g, r), n
        for (n, g), (_, p) in zip(g32, p32):
            assert _same(g, p), n
        return
    for i in flt:
        (n, g), r, p, g3 = got[i], ref[i][1], p32[i][1], g32[i][1]
        assert torch.equal(torch.isnan(g), torch.isnan(r)), n
        assert torch.equal(torch.isnan(g3), torch.isnan(p)), n
        fin = torch.isfinite(r)
        assert torch.equal(fin, torch.isfinite(g)), n
        if bool(fin.any()):
            e64 = float(((g - r).abs()[fin] / r.abs()[fin].clamp_min(1.0)).max())
            assert e64 <= AL_F64_TOL, (n, e64)
            assert _rel_fin(g3, r) <= 2 * _rel_fin(p, r) + 1e-6, n


@pytest.mark.parametrize("bounds", ["static", "boxes"])
@pytest.mark.parametrize("mode", ["eval", "online", "offline_first", "offline_later"])
def test_al_constraints_matches_plain(al_case, mode, bounds):
    c = al_case
    st = c["st"]
    if mode == "offline_later":
        st = st._replace(viol=c["viol_later"])
    kw = {} if mode == "eval" else dict(st=st, offline=mode != "online")
    launches = k78.isrbd_al_constraints.launches
    _al_run(c, k78.isrbd_al_constraints, k78.isrbd_al_constraints_plain,
            lambda al, d: ((al, _cast(st.sol.X, d), _cast(st.sol.U, d),
                            _cast(c["bounds"][bounds], d)), _cast(kw, d)),
            exact=False)
    assert k78.isrbd_al_constraints.launches == launches + 2


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bounds", ["static", "boxes"])
def test_al_constraints_twice_on_one_buffers_views(al_case, bounds, dtype):
    """An offline K7 call, then an offline and an online one fed the views
    of the previous call's one output buffer (as the next outer iteration
    and the serving tick take them): every output a view of its call's
    buffer, and each call's outputs the twin's on the same inputs (float64
    to 1e-12 of max(1, |twin|); float32 by K3's rule against the float64
    twin of the same values)."""
    c = al_case
    al = c["al"] if dtype == torch.float64 else c["al32"]
    st = _cast(c["st"], dtype)
    X, U, params = st.sol.X, st.sol.U, _cast(c["bounds"][bounds], dtype)
    fields = k78.MULTIPLIERS + ("rho", "viol")
    for offline in (True, True, False):
        got = k78.isrbd_al_constraints(al, X, U, params, st=st, offline=offline)
        want = k78.isrbd_al_constraints_plain(al, X, U, params, st=st,
                                              offline=offline)
        want64 = k78.isrbd_al_constraints_plain(
            c["al"], *(_cast(t, torch.float64) for t in (X, U, params)),
            st=_cast(st, torch.float64), offline=offline)
        torch.cuda.synchronize()
        base = got[0].untyped_storage().data_ptr()
        assert all(t.untyped_storage().data_ptr() == base for t in got)
        for n, (g, w, w64) in enumerate(zip(got, want, want64)):
            assert torch.equal(torch.isnan(g), torch.isnan(w)), n
            fin = torch.isfinite(w)
            assert torch.equal(fin, torch.isfinite(g)), n
            if dtype == torch.float64:
                e = float(((g - w).abs()[fin] / w.abs()[fin].clamp_min(1.0)).max())
                assert e <= AL_F64_TOL, (n, e)
            else:
                assert _rel_fin(g, w64) <= 2 * _rel_fin(w, w64) + 1e-6, n
        if offline:
            st = st._replace(**dict(zip(fields, got)))


@pytest.mark.parametrize("prior", ["none", "tail", "full"])
def test_al_shift_matches_plain_bit_for_bit(al_case, prior):
    c = al_case
    pr = c["priors"][prior]
    _al_run(c, k78.isrbd_al_shift, k78.isrbd_al_shift_plain,
            lambda al, d: ((al, _cast(c["st"], d), _cast(pr, d),
                            None if pr is None else c["phase"]), {}),
            exact=True)


@pytest.mark.parametrize("bounds", ["static", "boxes"])
def test_al_params_matches_plain_bit_for_bit(al_case, bounds):
    c = al_case
    _al_run(c, k78.isrbd_al_params, k78.isrbd_al_params_plain,
            lambda al, d: ((al, _cast(c["bounds"][bounds], d),
                            _cast(c["st"], d)), {}),
            exact=True)


@pytest.mark.parametrize("phase_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("ema", [0.5, 1.0])
@pytest.mark.parametrize("prior", ["tail", "full"])
def test_al_prior_update_matches_plain_bit_for_bit(al_case, prior, ema,
                                                   phase_dtype):
    c = al_case
    pr, phase = c["priors"][prior], c["phase"].to(phase_dtype)
    _al_run(c, k78.isrbd_al_prior_update, k78.isrbd_al_prior_update_plain,
            lambda al, d: ((al, _cast(pr, d), _cast(c["st"], d), phase, ema), {}),
            exact=True)
    # out of place: the tables handed in are as they were
    assert bool(torch.isnan(pr[0][NAN_MEMBER]).any())


@pytest.mark.parametrize("Bw", [1, 257])
def test_al_entries_at_ragged_fleet_sizes(al_case, Bw):
    c = al_case
    rep = lambda t: _repeat(t, Bw) if isinstance(t, torch.Tensor) else t
    st = type(c["st"])(sol=type(c["st"].sol)(*(rep(v) for v in c["st"].sol)),
                       **{k: rep(getattr(c["st"], k)) for k in c["st"]._fields
                          if k != "sol"})
    full = type(c["priors"]["full"])(*(rep(v) for v in c["priors"]["full"]))
    phase, params = rep(c["phase"]), {k: rep(v) for k, v in c["bounds"]["static"].items()}
    al = c["al"]
    for kernel, plain, a, kw in (
            (k78.isrbd_al_constraints, k78.isrbd_al_constraints_plain,
             (al, st.sol.X, st.sol.U, params), dict(st=st)),
            (k78.isrbd_al_shift, k78.isrbd_al_shift_plain, (al, st, full, phase), {}),
            (k78.isrbd_al_params, k78.isrbd_al_params_plain, (al, params, st), {}),
            (k78.isrbd_al_prior_update, k78.isrbd_al_prior_update_plain,
             (al, full, st, phase, 1.0), {})):
        got, ref = _flat(kernel(*a, **kw)), _flat(plain(*a, **kw))
        torch.cuda.synchronize()
        for (n, g), (_, r) in zip(got, ref):
            if kernel is k78.isrbd_al_constraints:
                fin = torch.isfinite(r)
                assert torch.equal(torch.isnan(g), torch.isnan(r)), n
                assert float(((g - r).abs()[fin] / r.abs()[fin].clamp_min(1.0)).max()) <= AL_F64_TOL
            else:
                assert _same(g, r), n


def test_al_entries_refuse_other_sizes_and_views(al_case):
    """CUDA tensors of a problem with one contact fewer, or a plan that is a
    strided view (the kernels index contiguous runs): ValueError before any
    launch."""
    import copy
    import dataclasses

    c = al_case
    al = copy.copy(c["al"])
    al.terms = dataclasses.replace(al.terms, n_eq=al.terms.n_eq - 1)
    st, params = c["st"], c["bounds"]["static"]
    counts = [getattr(k78, e).launches for e in (
        "isrbd_al_constraints", "isrbd_al_shift", "isrbd_al_params",
        "isrbd_al_prior_update")]
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k78.isrbd_al_constraints(al, st.sol.X, st.sol.U, params, st=st)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k78.isrbd_al_shift(al, st)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k78.isrbd_al_params(al, params, st)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k78.isrbd_al_prior_update(al, c["priors"]["full"], st, c["phase"], 1.0)
    wide = torch.cat([st.sol.X, st.sol.X], dim=-1)[..., :st.sol.X.shape[-1]]
    with pytest.raises(ValueError, match="contiguous"):
        k78.isrbd_al_constraints(c["al"], wide, st.sol.U, params, st=st)
    with pytest.raises(ValueError, match="contiguous"):
        k78.isrbd_al_shift(c["al"], st._replace(sol=st.sol._replace(X=wide)))
    assert counts == [getattr(k78, e).launches for e in (
        "isrbd_al_constraints", "isrbd_al_shift", "isrbd_al_params",
        "isrbd_al_prior_update")]


# ---------------- K1's Tassa form (MSDDP.solve's sweep) ----------------

TASSA = [("srbd", "schur"), ("srbd", "cholesky"), ("isrbd_al", "cholesky")]


def _tassa_case(card_case, isrbd_case, shape):
    """(linearization, μ, rows) of the shape's drawn point."""
    if shape == "srbd":
        return card_case["lin"], card_case["mu"], card_case["rows"]
    return isrbd_case["lin"], 1e-6, isrbd_case["al"].inner.rows


def _tassa(fn, lin, mu, rows, dtype, solver):
    args = tuple(lin[k].to(dtype).contiguous() for k in ORDER)
    return fn(*args, mu, rows, form="tassa", quu_solver=solver)


@pytest.mark.parametrize("Bw", [1, 64])
@pytest.mark.parametrize("shape,solver", TASSA)
def test_riccati_tassa_kernel_matches_plain(card_case, isrbd_case, shape,
                                            solver, Bw):
    """Each Tassa instantiation against the Tassa twin: float64 to 1e-9,
    float32 to K1_F32_TOL of the float64 twin; one member (the single
    robot's launch) and a fleet."""
    lin, mu, rows = _tassa_case(card_case, isrbd_case, shape)
    lin = _repeat_lin(lin, Bw)
    ref = _tassa(k1.riccati_backward_plain, lin, mu, rows, torch.float64, solver)
    before = k1.riccati_backward.launches
    got = _tassa(k1.riccati_backward, lin, mu, rows, torch.float64, solver)
    got32 = _tassa(k1.riccati_backward, lin, mu, rows, torch.float32, solver)
    torch.cuda.synchronize()
    assert k1.riccati_backward.launches == before + 2
    for g, g32, r in zip(got, got32, ref):
        assert bool(torch.isfinite(r).all())
        assert _rel(g, r) <= 1e-9
        assert _rel(g32, r) <= K1_F32_TOL


@pytest.mark.parametrize("shape,solver", TASSA)
def test_riccati_tassa_nan_member_stays_nan(card_case, isrbd_case, shape,
                                            solver):
    """A NaN in member 3's last defect makes its k and ΔV NaN (K stays
    finite: Quu and Qux do not see d), in the kernel as in the twin; the
    other members are untouched."""
    lin, mu, rows = _tassa_case(card_case, isrbd_case, shape)
    lin = dict(lin, d=lin["d"].clone())
    lin["d"][3, -1, 0] = float("nan")
    ref = _tassa(k1.riccati_backward_plain, lin, mu, rows, torch.float64, solver)
    got = _tassa(k1.riccati_backward, lin, mu, rows, torch.float64, solver)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[0][3]).all()) and bool(torch.isnan(ref[2][3]))
    for g, r in zip(got, ref):
        assert _rel_fin(g, r) <= 1e-9
        assert torch.equal(torch.isnan(g), torch.isnan(r))


@pytest.mark.parametrize("shape", ["srbd", "isrbd_al"])
def test_riccati_tassa_cholesky_indefinite_gives_nan(card_case, isrbd_case,
                                                     shape):
    """μ = −1e12 makes every Quu indefinite: the Cholesky instantiations
    give NaN gains and NaN ΔV, as the twin does, and nothing raises."""
    lin, _, rows = _tassa_case(card_case, isrbd_case, shape)
    for dtype in (torch.float64, torch.float32):
        ref = _tassa(k1.riccati_backward_plain, lin, -1e12, rows, dtype,
                     "cholesky")
        got = _tassa(k1.riccati_backward, lin, -1e12, rows, dtype, "cholesky")
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert bool(torch.isnan(r).all()) and bool(torch.isnan(g).all())


def test_riccati_tassa_refuses_uncompiled_combinations(card_case, isrbd_case):
    """CUDA tensors at a (shape, form, solver) with no instantiation raise
    ValueError before any launch; the collapsed form ignores the solver."""
    ilin, _, irows = _tassa_case(card_case, isrbd_case, "isrbd_al")
    args = tuple(ilin[k].float().contiguous() for k in ORDER) + (1e-6, irows)
    before = k1.riccati_backward.launches
    with pytest.raises(ValueError, match="no kernel for"):
        k1.riccati_backward(*args, form="tassa", quu_solver="schur")
    with pytest.raises(ValueError):
        k1.riccati_backward(*args, form="riccati")
    with pytest.raises(ValueError):
        k1.riccati_backward(*args, form="tassa", quu_solver="lu")
    assert k1.riccati_backward.launches == before
    got = k1.riccati_backward(*args, quu_solver="cholesky")
    want = k1.riccati_backward(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape,solver", TASSA)
def test_riccati_tassa_occupancy(card_case, isrbd_case, shape, solver):
    """The Tassa scratch lives in the region the node's blocks fill, so
    each Tassa instantiation takes its shape's collapsed bytes."""
    lin, _, rows = _tassa_case(card_case, isrbd_case, shape)
    sizes = (lin["d"].shape[-1], lin["Jup"].shape[-1], lin["Jt"].shape[1], rows)
    for dtype in (torch.float32, torch.float64):
        assert (k1.shared_memory_bytes(*sizes, dtype, "tassa", solver)
                == k1.shared_memory_bytes(*sizes, dtype))
        assert k1.blocks_per_sm(*sizes, dtype, "tassa", solver) >= 1


# ---------------- the LIP kernels: K10, K11, lip_evaluate, K1 ----------------

LIP_F64_TOL = 1e-12     # of max(1, |twin|), entry by entry


def _err1(got, want):
    """max |got − want| / max(1, |want|) over the entries where `want` is
    finite; inf if the non-finite entries differ."""
    got, want = got.double(), want.double()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return float(((got - want).abs() / want.abs().clamp_min(1.0))[fin].max())


@pytest.fixture(scope="module")
def lip_case():
    """A LIP linearization point: plans around the nominal state, random
    references and 0/1 switches and tracking masks on every node."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from srbd_horizon_tpu_torch.runtime.loop import build_lip_loop

    dev = torch.device("cuda", 0)
    loop, prob = build_lip_loop(SRBDConfig(dtype=torch.float64), device=dev)
    loop32, _ = build_lip_loop(SRBDConfig(), device=dev)
    ocp, solver = prob.ocp, loop.solver
    rng = np.random.RandomState(2)
    ns, nx, nu, nc = ocp.ns, ocp.nx, ocp.nu, prob.nc
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    X = t(prob.initial_state.cpu().numpy()[None, None]
          + 0.03 * rng.randn(B, ns + 1, nx))
    U = t(prob.static_input.cpu().numpy()[None, None]
          + 0.1 * rng.randn(B, ns, nu))
    params = dict(
        rdot_ref=t(0.3 * rng.randn(B, ns + 1, 3)),
        c_ref=t(0.05 * np.abs(rng.randn(B, ns + 1, nc))),
        cdot_switch=t(rng.randint(0, 2, (B, ns + 1, nc))),
        mask_track=t(rng.randint(0, 2, (B, ns + 1, 1))))
    lin = k10.lip_linearize_plain(X, U, params, solver.terms, solver.rows,
                                  ocp.dt, solver._wc(torch.float64))
    x0 = X[:, 0] + 0.005 * t(rng.randn(B, nx))
    return dict(lin=lin, rows=solver.rows, mu=solver.opts.mu0, X=X, U=U,
                x0=x0, ocp=ocp, params=params, solver=solver,
                solver32=loop32.solver)


def _drawn_lin_args(case, dtype, Bw=B):
    s = case["solver"] if dtype == torch.float64 else case["solver32"]
    t = lambda a: _repeat(a, Bw).to(dtype).contiguous()
    return (t(case["X"]), t(case["U"]),
            {k: t(v) for k, v in case["params"].items()}, s.terms, s.rows,
            case["ocp"].dt, s._wc(dtype))


@pytest.mark.parametrize("Bw", [1, 64, 513])
def test_lip_linearize_kernel_matches_plain(lip_case, Bw):
    """K10: float64 within LIP_F64_TOL of max(1, |twin|) entry by entry
    (the Jacobians bit for bit); float32 against the float64 twin within
    2× the float32 twin's error + 1e-6."""
    ref = k10.lip_linearize_plain(*_drawn_lin_args(lip_case, torch.float64, Bw))
    before = k10.lip_linearize.launches
    got = k10.lip_linearize(*_drawn_lin_args(lip_case, torch.float64, Bw))
    got32 = k10.lip_linearize(*_drawn_lin_args(lip_case, torch.float32, Bw))
    plain32 = k10.lip_linearize_plain(*_drawn_lin_args(lip_case, torch.float32, Bw))
    torch.cuda.synchronize()
    assert k10.lip_linearize.launches == before + 2
    for k in ORDER:
        assert got[k].shape == ref[k].shape, k
        assert _err1(got[k], ref[k]) <= LIP_F64_TOL, k
        assert _rel(got32[k], ref[k]) <= 2 * _rel(plain32[k], ref[k]) + 1e-6, k
    for k in ("Sx", "Bs", "Jxp", "Jup", "Jt"):
        assert torch.equal(got[k], ref[k]), k


def _drawn_trial_args(case, dtype, nA, Bw=B, nan_member=None):
    lin = case["lin"]
    ks, Ks, dV1, dV2 = k1.riccati_backward_plain(
        *(lin[k] for k in ORDER), case["mu"], case["rows"])
    s = case["solver"] if dtype == torch.float64 else case["solver32"]
    opts = s.opts
    t = lambda a: _repeat(a, Bw).to(dtype).contiguous()
    x0 = _repeat(case["x0"], Bw)
    if nan_member is not None:
        x0[nan_member, 3] = float("nan")
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    params = {k: t(v) for k, v in case["params"].items()}
    cost0 = s.total_cost(t(case["X"]), t(case["U"]), params)
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125][:nA], dtype=dtype,
                          device=x0.device)
    return (x0.to(dtype).contiguous(), t(case["X"]), t(case["U"]), t(ks),
            t(Ks), t(lin["d"]), alphas, params,
            cost0 + opts.defect_weight * t(D), t(D), t(dV1), t(dV2), s.terms,
            case["ocp"].dt, s._wc(dtype), opts.defect_weight, opts.beta,
            opts.alpha_converge_threshold)


@pytest.mark.parametrize("Bw", [1, 64, 513])
@pytest.mark.parametrize("nA", [1, 4])
def test_lip_trial_kernel_matches_plain(lip_case, nA, Bw):
    """K11 for 1 and 4 step sizes: float64 within LIP_F64_TOL of
    max(1, |twin|), the flags equal; float32 within 2× the float32 twin's
    error + 1e-6; a member from a NaN state NaN where the twin is."""
    nan = 1 if Bw > 1 else None
    ref = k11.lip_trial_plain(*_drawn_trial_args(lip_case, torch.float64, nA, Bw, nan))
    before = k11.lip_trial.launches
    got = k11.lip_trial(*_drawn_trial_args(lip_case, torch.float64, nA, Bw, nan))
    got32 = k11.lip_trial(*_drawn_trial_args(lip_case, torch.float32, nA, Bw, nan))
    plain32 = k11.lip_trial_plain(*_drawn_trial_args(lip_case, torch.float32, nA,
                                                   Bw, nan))
    torch.cuda.synchronize()
    assert k11.lip_trial.launches == before + 2
    for g, g32, p, r in zip(got[:4], got32[:4], plain32[:4], ref[:4]):
        assert g.shape == r.shape
        assert _err1(g, r) <= LIP_F64_TOL
        assert _rel_fin(g32, r) <= 2 * _rel_fin(p, r) + 1e-6
    assert torch.equal(got[4], ref[4])
    if nan is not None:
        assert bool(torch.isnan(got[2][:, nan]).all()) and not bool(got[4][:, nan].any())


@pytest.mark.parametrize("Bw", [1, 64, 513])
@pytest.mark.parametrize("pin", [False, True], ids=["plan", "pinned"])
def test_lip_evaluate_kernel_matches_plain(lip_case, Bw, pin):
    """lip_evaluate: a member whose plan holds a NaN is NaN in both; given
    x0 (a NaN in another member's), the pinned plan equal to the twin's
    bit for bit."""
    X = _repeat(lip_case["X"], Bw)
    x0 = _repeat(lip_case["x0"], Bw)
    if Bw > 1:
        X[1, 5, 4] = float("nan")
        x0[2, 4] = float("nan")

    def args(dtype):
        s = lip_case["solver"] if dtype == torch.float64 else lip_case["solver32"]
        t = lambda a: a.to(dtype).contiguous()
        return (t(X), t(_repeat(lip_case["U"], Bw)),
                {k: t(_repeat(v, Bw)) for k, v in lip_case["params"].items()},
                s.terms, lip_case["ocp"].dt, s._wc(dtype),
                t(x0) if pin else None)

    before = k11.lip_evaluate.launches
    ref = k11.lip_evaluate_plain(*args(torch.float64))
    got = k11.lip_evaluate(*args(torch.float64))
    got32 = k11.lip_evaluate(*args(torch.float32))
    plain32 = k11.lip_evaluate_plain(*args(torch.float32))
    torch.cuda.synchronize()
    assert k11.lip_evaluate.launches == before + 2
    for g, g32, p, r in zip(got[:2], got32[:2], plain32[:2], ref[:2]):
        assert _err1(g, r) <= LIP_F64_TOL
        assert _rel_fin(g32, r) <= 2 * _rel_fin(p, r) + 1e-6
    if pin:
        assert torch.equal(_bits(got[2]), _bits(ref[2]))
        assert torch.equal(_bits(got32[2]), _bits(plain32[2]))
    if Bw > 1:
        assert bool(torch.isnan(got[0][1])) and bool(torch.isnan(got[1][1]))


LIP_K1 = [("collapsed", "schur"), ("tassa", "schur"), ("tassa", "cholesky")]


@pytest.mark.parametrize("Bw", [1, 133])
@pytest.mark.parametrize("form,solver", LIP_K1)
def test_lip_riccati_kernel_matches_plain(lip_case, form, solver, Bw):
    """K1's three LIP instantiations against the twin: float64 to 1e-9,
    float32 to K1_F32_TOL of the float64 twin."""
    lin = _repeat_lin(lip_case["lin"], Bw)
    rows, mu = lip_case["rows"], lip_case["mu"]

    def run(fn, dtype):
        return fn(*(lin[k].to(dtype).contiguous() for k in ORDER), mu, rows,
                  form=form, quu_solver=solver)

    ref = run(k1.riccati_backward_plain, torch.float64)
    inst = k1.kernel_instance("lip", form, solver)
    before = k1.riccati_backward.instance_launches[inst]
    got = run(k1.riccati_backward, torch.float64)
    got32 = run(k1.riccati_backward, torch.float32)
    torch.cuda.synchronize()
    assert k1.riccati_backward.instance_launches[inst] == before + 2
    for g, g32, r in zip(got, got32, ref):
        assert bool(torch.isfinite(r).all())
        assert _rel(g, r) <= 1e-9
        assert _rel(g32, r) <= K1_F32_TOL
    sizes = (lin["d"].shape[-1], lin["Jup"].shape[-1], lin["Jt"].shape[1], rows)
    assert k1.blocks_per_sm(*sizes, torch.float32, form, solver) >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_lip_occupancy(lip_case, dtype):
    occ = k11.evaluate_occupancy(lip_case["ocp"].ns, dtype)
    assert occ["blocks_per_sm"] >= 1 and occ["registers_per_thread"] > 0
    assert k11.trial_occupancy(dtype)["blocks_per_sm"] >= 1


def test_lip_kernels_refuse_unknown_shape(lip_case):
    """K10, K11, lip_evaluate and K1 on CUDA tensors of a LIP topology no
    instance has (nc 3): ValueError before any launch; nothing falls
    back."""
    import dataclasses

    s = lip_case["solver"]
    terms = dataclasses.replace(s.terms, nc=3, contact_model=1)
    dev = lip_case["X"].device
    Bw, ns, nx, nu = 2, lip_case["ocp"].ns, 24, 12
    e = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=dev)
    params = dict(rdot_ref=e(Bw, ns + 1, 3), c_ref=e(Bw, ns + 1, 3),
                  cdot_switch=e(Bw, ns + 1, 3), mask_track=e(Bw, ns + 1, 1))
    X, U = e(Bw, ns + 1, nx), e(Bw, ns, nu)
    dt, wc = lip_case["ocp"].dt, s._wc(torch.float64)
    counts = (k10.lip_linearize.launches, k11.lip_trial.launches,
              k11.lip_evaluate.launches)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k10.lip_linearize(X, U, params, terms, s.rows, dt, wc)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k11.lip_evaluate(X, U, params, terms, dt, wc)
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k11.lip_trial(e(Bw, nx), X, U, e(Bw, ns, nu), e(Bw, ns, nu, nx),
                      e(Bw, ns, nx), e(1), params, e(Bw), e(Bw), e(Bw), e(Bw),
                      terms, dt, wc, 1e-3, 0.1, 1e-12)
    assert counts == (k10.lip_linearize.launches, k11.lip_trial.launches,
                      k11.lip_evaluate.launches)


# ---------------- the quadruped: K4, K3, srbd_evaluate, K1 at QuadShape ----------------

@pytest.fixture(scope="module")
def quad_case():
    """A linearization point of the point-feet quadruped (`QuadShape`):
    plans around the nominal state, random velocity references, contact
    heights, 0/1 switches and tracking masks on every node."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from srbd_horizon_tpu_torch.runtime.loop import build_quadruped_loop

    dev = torch.device("cuda", 0)
    cfg = dict(contact_model=1, number_of_legs=4)
    loop, prob = build_quadruped_loop(SRBDConfig(dtype=torch.float64, **cfg),
                                      device=dev)
    loop32, _ = build_quadruped_loop(SRBDConfig(**cfg), device=dev)
    ocp, solver = prob.ocp, loop.solver
    rng = np.random.RandomState(4)
    ns, nx, nu, nc = ocp.ns, ocp.nx, ocp.nu, prob.nc
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    X = t(prob.initial_state.cpu().numpy()[None, None]
          + 0.02 * rng.randn(B, ns + 1, nx))
    U = t(prob.static_input.cpu().numpy()[None, None]
          + 0.05 * rng.randn(B, ns, nu))
    params = {k: v.expand((B,) + tuple(v.shape)).contiguous()
              for k, v in ocp.params.items()}
    params.update(
        rdot_ref=t(0.3 * rng.randn(B, ns + 1, 3)),
        w_ref=t(0.1 * rng.randn(B, ns + 1, 3)),
        c_ref=t(0.05 * np.abs(rng.randn(B, ns + 1, nc))),
        cdot_switch=t(rng.randint(0, 2, (B, ns + 1, nc))),
        mask_track=t(rng.randint(0, 2, (B, ns + 1, 1))))
    lin = k4.srbd_linearize_plain(X, U, params, solver.terms, solver.rows,
                                  ocp.dt, solver._wc(torch.float64))
    x0 = X[:, 0] + 0.005 * t(rng.randn(B, nx))
    return dict(lin=lin, rows=solver.rows, mu=solver.opts.mu0, X=X, U=U,
                x0=x0, ocp=ocp, params=params, solver=solver,
                solver32=loop32.solver)


@pytest.mark.parametrize("Bw", [1, 64, 513])
def test_quadruped_linearize_kernel_matches_plain(quad_case, Bw):
    """K4 at QuadShape by K4's rules: float64 to 1e-9; float32 within 2×
    the float32 twin's error + 1e-6, and below K4_F32_CAP."""
    ref = k4.srbd_linearize_plain(*_drawn_lin_args(quad_case, torch.float64, Bw))
    before = k4.srbd_linearize.launches
    got = k4.srbd_linearize(*_drawn_lin_args(quad_case, torch.float64, Bw))
    got32 = k4.srbd_linearize(*_drawn_lin_args(quad_case, torch.float32, Bw))
    plain32 = k4.srbd_linearize_plain(*_drawn_lin_args(quad_case, torch.float32,
                                                     Bw))
    torch.cuda.synchronize()
    assert k4.srbd_linearize.launches == before + 2
    assert tuple(got["Jxp"].shape[2:]) == (30, 37) and got["rho"].shape[-1] == 69
    for k in ORDER:
        assert got[k].shape == ref[k].shape, k
        assert _rel(got[k], ref[k]) <= 1e-9, k
        e = _rel(got32[k], ref[k])
        assert e <= 2 * _rel(plain32[k], ref[k]) + 1e-6 and e <= K4_F32_CAP, k


@pytest.mark.parametrize("Bw", [1, 133])
@pytest.mark.parametrize("nA", [1, 4])
def test_quadruped_trial_kernel_matches_plain(quad_case, nA, Bw):
    """K3 at QuadShape for 1 and 4 step sizes: float64 to 1e-9, the flags
    equal; float32 within 2× the float32 twin's error + 1e-6; a member from
    a NaN state NaN and rejected."""
    nan = 1 if Bw > 1 else None
    ref = k3.srbd_trial_plain(*_drawn_trial_args(quad_case, torch.float64, nA,
                                               Bw, nan))
    before = k3.srbd_trial.launches
    got = k3.srbd_trial(*_drawn_trial_args(quad_case, torch.float64, nA, Bw, nan))
    got32 = k3.srbd_trial(*_drawn_trial_args(quad_case, torch.float32, nA, Bw, nan))
    plain32 = k3.srbd_trial_plain(*_drawn_trial_args(quad_case, torch.float32, nA,
                                                   Bw, nan))
    torch.cuda.synchronize()
    assert k3.srbd_trial.launches == before + 2
    for g, g32, p, r in zip(got[:4], got32[:4], plain32[:4], ref[:4]):
        assert g.shape == r.shape
        assert _rel_fin(g, r) <= 1e-9
        assert _rel_fin(g32, r) <= 2 * _rel_fin(p, r) + 1e-6
    assert torch.equal(got[4], ref[4])
    if nan is not None:
        assert bool(torch.isnan(got[2][:, nan]).all()) and not bool(got[4][:, nan].any())


@pytest.mark.parametrize("Bw", [1, 64, 513])
@pytest.mark.parametrize("pin", [False, True], ids=["plan", "pinned"])
def test_quadruped_evaluate_kernel_matches_plain(quad_case, Bw, pin):
    """srbd_evaluate at QuadShape by K3's rules: a member whose plan holds a
    NaN is NaN in both outputs; given x0, the pinned plan equal to the
    twin's bit for bit."""
    X = _repeat(quad_case["X"], Bw)
    x0 = _repeat(quad_case["x0"], Bw)
    if Bw > 1:
        X[1, 5, 4] = float("nan")
        x0[2, 4] = float("nan")

    def args(dtype):
        s = quad_case["solver"] if dtype == torch.float64 else quad_case["solver32"]
        t = lambda a: a.to(dtype).contiguous()
        return (t(X), t(_repeat(quad_case["U"], Bw)),
                {k: t(_repeat(v, Bw)) for k, v in quad_case["params"].items()},
                s.terms, quad_case["ocp"].dt, s._wc(dtype),
                t(x0) if pin else None)

    before = k3.srbd_evaluate.launches
    ref = k3.srbd_evaluate_plain(*args(torch.float64))
    got = k3.srbd_evaluate(*args(torch.float64))
    got32 = k3.srbd_evaluate(*args(torch.float32))
    plain32 = k3.srbd_evaluate_plain(*args(torch.float32))
    torch.cuda.synchronize()
    assert k3.srbd_evaluate.launches == before + 2
    for g, g32, p, r in zip(got[:2], got32[:2], plain32[:2], ref[:2]):
        assert _rel_fin(g, r) <= 1e-9
        assert _rel_fin(g32, r) <= 2 * _rel_fin(p, r) + 1e-6
    if pin:
        assert torch.equal(_bits(got[2]), _bits(ref[2]))
        assert torch.equal(_bits(got32[2]), _bits(plain32[2]))
    if Bw > 1:
        assert bool(torch.isnan(got[0][1])) and bool(torch.isnan(got[1][1]))


@pytest.mark.parametrize("Bw", [1, 133])
@pytest.mark.parametrize("form,solver", [("collapsed", "schur"),
                                         ("tassa", "schur"),
                                         ("tassa", "cholesky")])
def test_quadruped_riccati_kernel_matches_plain(quad_case, form, solver, Bw):
    """K1's three quadruped instantiations (the collapsed sweep of
    `solve_batch`, the Tassa sweep of `MSDDP.solve` with the block-Schur
    or the Cholesky gains) against the twin: float64 to 1e-9, float32 to
    K1_F32_TOL."""
    lin = _repeat_lin(quad_case["lin"], Bw)
    rows, mu = quad_case["rows"], quad_case["mu"]

    def run(fn, dtype):
        return fn(*(lin[k].to(dtype).contiguous() for k in ORDER), mu, rows,
                  form=form, quu_solver=solver)

    ref = run(k1.riccati_backward_plain, torch.float64)
    inst = k1.kernel_instance("quadruped", form, solver)
    before = k1.riccati_backward.instance_launches[inst]
    got = run(k1.riccati_backward, torch.float64)
    got32 = run(k1.riccati_backward, torch.float32)
    torch.cuda.synchronize()
    assert k1.riccati_backward.instance_launches[inst] == before + 2
    for g, g32, r in zip(got, got32, ref):
        assert bool(torch.isfinite(r).all())
        assert _rel(g, r) <= 1e-9
        assert _rel(g32, r) <= K1_F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_quadruped_occupancy(quad_case, dtype):
    """Every quadruped instantiation reports at least one block an SM."""
    ns = quad_case["ocp"].ns
    for occ in (k4.occupancy(dtype, "quadruped"),
                k3.trial_occupancy(dtype, "quadruped"),
                k3.evaluate_occupancy(ns, dtype, "quadruped")):
        assert occ["blocks_per_sm"] >= 1 and occ["registers_per_thread"] > 0
        assert occ["shared_memory_bytes"] > 0
    lin, rows = quad_case["lin"], quad_case["rows"]
    sizes = (lin["d"].shape[-1], lin["Jup"].shape[-1], lin["Jt"].shape[1], rows)
    for form in ("collapsed", "tassa"):
        assert k1.blocks_per_sm(*sizes, dtype, form) >= 1
        assert (k1.shared_memory_bytes(*sizes, dtype, form)
                == k1.shared_memory_bytes(*sizes, dtype))


def test_quadruped_refuses_uncompiled_combinations(quad_case):
    """K1 at the quadruped's sizes takes every form and gain solve (the
    Cholesky Tassa form is instance 22); a gain solve K1 does not have
    raises ValueError before any launch, as does the block-Schur Tassa
    form at the quadruped's AL inner shape."""
    lin, rows = quad_case["lin"], quad_case["rows"]
    args = tuple(lin[k].float().contiguous() for k in ORDER)
    before = k1.riccati_backward.launches
    with pytest.raises(ValueError):
        k1.riccati_backward(*args, quad_case["mu"], rows, form="tassa",
                            quu_solver="lu")
    with pytest.raises(ValueError, match="no kernel for"):
        k1.kernel_instance("isrbd_al_quadruped", "tassa", "schur")
    assert k1.riccati_backward.launches == before
    k1.riccati_backward(*args, quad_case["mu"], rows, form="tassa",
                        quu_solver="cholesky")
    torch.cuda.synchronize()
    assert k1.riccati_backward.launches == before + 1


# ---------------- the constrained quadruped: the isrbd kernels at QuadAlShape ----

@pytest.fixture(scope="module")
def qc_case():
    """The point on the constrained quadruped example's AL inner problem
    (`isrbd::QuadAlShape`: point feet, 236 stage rows, 97 terminal rows)."""
    from srbd_horizon_tpu_torch.models.quadruped import quadruped_point_feet

    robot = quadruped_point_feet()
    return _isrbd_point(lambda dtype, dev: ALDDP(build_isrbd_problem(
        SRBDConfig(dtype=dtype, contact_model=1, number_of_legs=4,
                   lip_height=float(robot.com[2])), robot, device=dev).ocp,
        DDPOptions(max_iters=1)), seed=12)


def test_quadruped_isrbd_linearize_kernel_matches_plain(qc_case):
    ref = qc_case["lin"]
    assert ref["rho"].shape[-1] == 236 and ref["Jt"].shape[1] == 97
    got = k5.isrbd_linearize(*_k5_args(qc_case, torch.float64))
    torch.cuda.synchronize()
    for k in ORDER:
        assert _rel(got[k], ref[k]) <= 1e-9, k
    got32 = k5.isrbd_linearize(*_k5_args(qc_case, torch.float32))
    plain32 = k5.isrbd_linearize_plain(*_k5_args(qc_case, torch.float32))
    for k in ORDER:
        e = _rel(got32[k], ref[k])
        assert e <= 2 * _rel(plain32[k], ref[k]) + 1e-6 and e <= K4_F32_CAP, k


@pytest.mark.parametrize("form,solver", [("collapsed", "schur"),
                                         ("tassa", "cholesky")])
def test_quadruped_al_riccati_kernel_matches_plain(qc_case, form, solver):
    """K1 at `isrbd_al_quadruped`: the collapsed sweep of `solve_batch` and
    the Tassa sweep with Cholesky gains of `ALDDP.solve`, float64 to 1e-9,
    float32 to K1_F32_TOL; the block-Schur Tassa form is refused."""
    rows = qc_case["al"].inner.rows
    kw = dict(form=form, quu_solver=solver)
    args = lambda dtype: tuple(qc_case["lin"][k].to(dtype).contiguous()
                               for k in ORDER) + (1e-6, rows)
    inst = k1.kernel_instance("isrbd_al_quadruped", form, solver)
    before = k1.riccati_backward.instance_launches[inst]
    ref = k1.riccati_backward_plain(*args(torch.float64), **kw)
    got = k1.riccati_backward(*args(torch.float64), **kw)
    got32 = k1.riccati_backward(*args(torch.float32), **kw)
    torch.cuda.synchronize()
    assert k1.riccati_backward.instance_launches[inst] == before + 2
    for g, g32, r in zip(got, got32, ref):
        assert _rel(g, r) <= 1e-9
        assert _rel(g32, r) <= K1_F32_TOL
    with pytest.raises(ValueError, match="no kernel for"):
        k1.riccati_backward(*args(torch.float32), form="tassa", quu_solver="schur")


@pytest.mark.parametrize("nA", [1, 4])
def test_quadruped_isrbd_trial_kernel_matches_plain(qc_case, nA):
    al = qc_case["al"]
    lin, rows = qc_case["lin"], al.inner.rows
    ref_k = k1.riccati_backward_plain(*(lin[k] for k in ORDER), 1e-6, rows)
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125][:nA], dtype=torch.float64,
                          device=D.device)
    opts = al.inner.opts
    cost0 = al.inner.total_cost(qc_case["X"], qc_case["U"], qc_case["pin"])
    x0 = qc_case["x0"].clone()
    x0[3] = float("nan")

    def args(dtype):
        a = al if dtype == torch.float64 else qc_case["al32"]
        t = lambda v: v.to(dtype).contiguous()
        return (t(x0), t(qc_case["X"]), t(qc_case["U"]), t(ref_k[0]),
                t(ref_k[1]), t(lin["d"]), t(alphas),
                {k: t(v) for k, v in qc_case["pin"].items()},
                t(cost0 + opts.defect_weight * D), t(D), t(ref_k[2]),
                t(ref_k[3]), a.terms, qc_case["ocp"].dt,
                opts.defect_weight, opts.beta, opts.alpha_converge_threshold)

    ref = k6.isrbd_trial_plain(*args(torch.float64))
    got = k6.isrbd_trial(*args(torch.float64))
    torch.cuda.synchronize()
    for g, r in zip(got[:4], ref[:4]):
        assert _rel_fin(g, r) <= 1e-9
    assert torch.equal(got[4], ref[4]) and not bool(got[4][:, 3].any())
    got32 = k6.isrbd_trial(*args(torch.float32))
    plain32 = k6.isrbd_trial_plain(*args(torch.float32))
    for g, p, r in zip(got32[:4], plain32[:4], ref[:4]):
        assert _rel_fin(g, r) <= 2 * _rel_fin(p, r) + 1e-6


@pytest.mark.parametrize("pin", [False, True], ids=["plan", "pinned"])
@pytest.mark.parametrize("Bw", [1, 257])
def test_quadruped_isrbd_evaluate_matches_plain(qc_case, Bw, pin):
    U = _repeat(qc_case["U"], Bw)
    if Bw > 1:
        U[1, 3, 0] = float("nan")
    x0 = _repeat(qc_case["x0"], Bw)

    def args(dtype):
        a = qc_case["al"] if dtype == torch.float64 else qc_case["al32"]
        t = lambda v: v.to(dtype).contiguous()
        return (t(_repeat(qc_case["X"], Bw)), t(U),
                {k: t(_repeat(v, Bw)) for k, v in qc_case["pin"].items()},
                a.terms, qc_case["ocp"].dt) + ((t(x0),) if pin else ())

    def plain(*a):
        return k6.isrbd_evaluate_plain(*a[:5], x0=a[5] if pin else None)

    def kernel(*a):
        return k6.isrbd_evaluate(*a[:5], x0=a[5] if pin else None)

    check = _pinned_check if pin else _evaluate_check
    _, got, got32 = check(plain, kernel, args)
    if Bw > 1:
        for out in (got, got32):
            assert bool(torch.isnan(out[0][1])) and bool(torch.isnan(out[1][1]))


@pytest.fixture(scope="module")
def qc_al_case(qc_case):
    return _al_point(qc_case, seed=13)


@pytest.mark.parametrize("mode", ["eval", "online", "offline_first", "offline_later"])
def test_quadruped_al_constraints_matches_plain(qc_al_case, mode):
    c = qc_al_case
    st = c["st"]
    if mode == "offline_later":
        st = st._replace(viol=c["viol_later"])
    kw = {} if mode == "eval" else dict(st=st, offline=mode != "online")
    for bounds in ("static", "boxes"):
        _al_run(c, k78.isrbd_al_constraints, k78.isrbd_al_constraints_plain,
                lambda al, d: ((al, _cast(st.sol.X, d), _cast(st.sol.U, d),
                                _cast(c["bounds"][bounds], d)), _cast(kw, d)),
                exact=False)


@pytest.mark.parametrize("prior", ["none", "tail", "full"])
def test_quadruped_al_shift_and_params_match_plain_bit_for_bit(qc_al_case, prior):
    c = qc_al_case
    pr = c["priors"][prior]
    _al_run(c, k78.isrbd_al_shift, k78.isrbd_al_shift_plain,
            lambda al, d: ((al, _cast(c["st"], d), _cast(pr, d),
                            None if pr is None else c["phase"]), {}),
            exact=True)
    bounds = "static" if prior == "none" else "boxes"
    _al_run(c, k78.isrbd_al_params, k78.isrbd_al_params_plain,
            lambda al, d: ((al, _cast(c["bounds"][bounds], d),
                            _cast(c["st"], d)), {}),
            exact=True)


@pytest.mark.parametrize("ema", [0.5, 1.0])
@pytest.mark.parametrize("prior", ["tail", "full"])
def test_quadruped_al_prior_update_matches_plain_bit_for_bit(qc_al_case, prior, ema):
    c = qc_al_case
    pr = c["priors"][prior]
    _al_run(c, k78.isrbd_al_prior_update, k78.isrbd_al_prior_update_plain,
            lambda al, d: ((al, _cast(pr, d), _cast(c["st"], d), c["phase"],
                            ema), {}),
            exact=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_quadruped_isrbd_occupancy(qc_case, dtype):
    """K5, K6 and isrbd_evaluate at QuadAlShape report at least one block an
    SM, and K1 at its AL shape at least one."""
    ns = qc_case["ocp"].ns
    for occ in (k5.occupancy(dtype, "quadruped"),
                k6.trial_occupancy(dtype, "quadruped"),
                k6.evaluate_occupancy(ns, dtype, "quadruped")):
        assert occ["blocks_per_sm"] >= 1 and occ["shared_memory_bytes"] > 0
    rows = qc_case["al"].inner.rows
    for form, solver in (("collapsed", "schur"), ("tassa", "cholesky")):
        assert k1.blocks_per_sm(37, 30, 97, rows, dtype, form, solver) >= 1


# ---- K12 (riccati_associative) and K13 (linear_trial): the modes ----

# K12 in float64: R̃ = luu + μI is solved alone (K1 solves Quu), then 34
# pivoted (I + C₁J₂) solves: rounding reads 1.3e-9 over 512 drawn members
# (chip_smoke.py's K12_F64_TOL)
K12_F64_TOL = 1e-8


def _mode_case(request):
    return request.getfixturevalue("card_case" if request.param == "srbd"
                                   else "lip_case")


@pytest.fixture(params=["srbd", "lip"])
def mode_case(request):
    return _mode_case(request)


@pytest.mark.parametrize("Bw", [1, 64, 133])
@pytest.mark.parametrize("solver", ["schur", "cholesky"])
def test_riccati_associative_matches_plain(mode_case, solver, Bw):
    """K12 against its twin on the same sliced lin: float64 to 1e-8 (see
    K12_F64_TOL), float32 to 1e-6 of the float64 twin (it computes in
    float64)."""
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    c = mode_case
    lin = {k: _repeat(c["lin"][k], Bw) for k in ORDER}
    args = lambda dtype: tuple(lin[k].to(dtype).contiguous() for k in ORDER)
    ref = k12.riccati_associative_plain(*args(torch.float64), c["mu"],
                                        c["rows"], solver)
    n0 = k12.riccati_associative.launches
    got = k12.riccati_associative(*args(torch.float64), c["mu"], c["rows"],
                                  solver)
    torch.cuda.synchronize()
    assert k12.riccati_associative.launches == n0 + 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float64
        assert _rel(g, r) <= K12_F64_TOL
    got32 = k12.riccati_associative(*args(torch.float32), c["mu"], c["rows"],
                                    solver)
    ref32 = k12.riccati_associative_plain(
        *(a.double() for a in args(torch.float32)), c["mu"], c["rows"], solver)
    for g, r in zip(got32, ref32):
        assert g.dtype == torch.float32 and _rel(g, r) <= K1_F32_TOL


@pytest.mark.parametrize("nA", [1, 4])
@pytest.mark.parametrize("Bw", [1, 64])
def test_linear_trial_matches_plain(mode_case, nA, Bw):
    """K13 against its twin: float64 to 1e-9, float32 to 1e-6 of the float64
    twin on the same float32 inputs (it computes in float64), the flags
    equal in float64."""
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    c = mode_case
    s = c["solver"]
    lin = {k: _repeat(c["lin"][k], Bw) for k in ORDER}
    ks, Ks, dV1, dV2 = k12.riccati_associative_plain(
        *(lin[k] for k in ORDER), c["mu"], c["rows"])
    X, U, x0 = (_repeat(c[k], Bw) for k in ("X", "U", "x0"))
    params = {k: _repeat(v, Bw) for k, v in c["params"].items()}
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    merit0 = s.total_cost(X, U, params) + s.opts.defect_weight * D
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125][:nA], dtype=torch.float64,
                          device=X.device)

    def args(dtype, cast=None):
        t = lambda a: a.to(dtype).contiguous()
        out = (t(x0), t(X), t(U), t(ks), t(Ks), t(lin["Sx"]), t(lin["Bs"]),
               t(lin["d"]), t(alphas), {k: t(v) for k, v in params.items()},
               t(merit0), t(D), t(dV1), t(dV2))
        if cast is not None:
            out = tuple({k: v.to(cast) for k, v in a.items()}
                        if isinstance(a, dict) else a.to(cast) for a in out)
        return out + (s.terms, s.rows, c["ocp"].dt, s._wc(torch.float64),
                      s.opts.defect_weight, s.opts.beta,
                      s.opts.alpha_converge_threshold)

    ref = k13.linear_trial_plain(*args(torch.float64))
    n0 = k13.linear_trial.launches
    got = k13.linear_trial(*args(torch.float64))
    torch.cuda.synchronize()
    assert k13.linear_trial.launches == n0 + 1
    for g, r in zip(got[:4], ref[:4]):
        assert g.shape == r.shape and _rel(g, r) <= 1e-9
    assert torch.equal(got[4], ref[4])
    got32 = k13.linear_trial(*args(torch.float32))
    ref32 = k13.linear_trial_plain(*args(torch.float32, torch.float64))
    for g, r in zip(got32[:4], ref32[:4]):
        assert g.dtype == torch.float32 and _rel(g, r) <= K1_F32_TOL


# K12's and K13's instantiations at the shapes past the SRBD and LIP ones:
# the quadruped's SRBD problem with both gain solves, the two AL inner
# problems with Cholesky (the AL solver's only gain solve)
NEW_MODE_SHAPES = [("quadruped", "schur"), ("quadruped", "cholesky"),
                   ("isrbd_al", "cholesky"), ("isrbd_al_quadruped", "cholesky")]
NEW_MODE_IDS = [f"{s}-{g}" for s, g in NEW_MODE_SHAPES]


def _new_mode_case(request, shape):
    """quad_case, or an AL point (isrbd_case, qc_case) with the inner
    solver's rows, μ, parameters and solver under mode_case's keys."""
    if shape == "quadruped":
        return request.getfixturevalue("quad_case")
    c = request.getfixturevalue("isrbd_case" if shape == "isrbd_al"
                                else "qc_case")
    s = c["al"].inner
    return dict(lin=c["lin"], rows=s.rows, mu=s.opts.mu0, X=c["X"], U=c["U"],
                x0=c["x0"], params=c["pin"], solver=s, ocp=c["ocp"])


@pytest.mark.parametrize("Bw", [1, 64, 133])
@pytest.mark.parametrize("shape,solver", NEW_MODE_SHAPES, ids=NEW_MODE_IDS)
def test_riccati_associative_new_shapes_match_plain(request, shape, solver, Bw):
    """K12 at the quadruped's SRBD shape and the two AL shapes against its
    twin, by the rules of `test_riccati_associative_matches_plain` (the AL
    points carry penalties ρ up to 1e5 in the element's R̃)."""
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    c = _new_mode_case(request, shape)
    lin = {k: _repeat(c["lin"][k], Bw) for k in ORDER}
    args = lambda dtype: tuple(lin[k].to(dtype).contiguous() for k in ORDER)
    nt = lin["Jt"].shape[1]
    assert k12.KERNEL_INSTANCES[k12.kernel_instance(
        37, lin["Jup"].shape[-1], nt, c["rows"], solver)] == (shape, solver)
    ref = k12.riccati_associative_plain(*args(torch.float64), c["mu"],
                                        c["rows"], solver)
    n0 = k12.riccati_associative.launches
    got = k12.riccati_associative(*args(torch.float64), c["mu"], c["rows"],
                                  solver)
    torch.cuda.synchronize()
    assert k12.riccati_associative.launches == n0 + 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel(g, r) <= K12_F64_TOL
    got32 = k12.riccati_associative(*args(torch.float32), c["mu"], c["rows"],
                                    solver)
    ref32 = k12.riccati_associative_plain(
        *(a.double() for a in args(torch.float32)), c["mu"], c["rows"], solver)
    for g, r in zip(got32, ref32):
        assert g.dtype == torch.float32 and _rel(g, r) <= K1_F32_TOL


@pytest.mark.parametrize("nA", [1, 4])
@pytest.mark.parametrize("Bw", [1, 64])
@pytest.mark.parametrize("shape", ["quadruped", "isrbd_al", "isrbd_al_quadruped"])
def test_linear_trial_new_families_match_plain(request, shape, Bw, nA):
    """K13's quadruped SRBD family and its isrbd-AL family (RK2 defects, the
    inner stacks) at both AL shapes against the twin, by the rules of
    `test_linear_trial_matches_plain`."""
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    c = _new_mode_case(request, shape)
    s = c["solver"]
    assert k13.FAMILIES[k13.family_index(s.terms, 37, s.ocp.nu, c["rows"])][2] \
        == shape
    lin = {k: _repeat(c["lin"][k], Bw) for k in ORDER}
    ks, Ks, dV1, dV2 = k12.riccati_associative_plain(
        *(lin[k] for k in ORDER), c["mu"], c["rows"], "cholesky")
    X, U, x0 = (_repeat(c[k], Bw) for k in ("X", "U", "x0"))
    params = {k: _repeat(v, Bw) for k, v in c["params"].items()}
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    merit0 = s.total_cost(X, U, params) + s.opts.defect_weight * D
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125][:nA], dtype=torch.float64,
                          device=X.device)

    def args(dtype, cast=None):
        t = lambda a: a.to(dtype).contiguous()
        out = (t(x0), t(X), t(U), t(ks), t(Ks), t(lin["Sx"]), t(lin["Bs"]),
               t(lin["d"]), t(alphas), {k: t(v) for k, v in params.items()},
               t(merit0), t(D), t(dV1), t(dV2))
        if cast is not None:
            out = tuple({k: v.to(cast) for k, v in a.items()}
                        if isinstance(a, dict) else a.to(cast) for a in out)
        return out + (s.terms, s.rows, c["ocp"].dt, s._wc(torch.float64),
                      s.opts.defect_weight, s.opts.beta,
                      s.opts.alpha_converge_threshold)

    ref = k13.linear_trial_plain(*args(torch.float64))
    n0 = k13.linear_trial.launches
    got = k13.linear_trial(*args(torch.float64))
    torch.cuda.synchronize()
    assert k13.linear_trial.launches == n0 + 1
    for g, r in zip(got[:4], ref[:4]):
        assert g.shape == r.shape and _rel(g, r) <= 1e-9
    assert torch.equal(got[4], ref[4])
    got32 = k13.linear_trial(*args(torch.float32))
    ref32 = k13.linear_trial_plain(*args(torch.float32, torch.float64))
    for g, r in zip(got32[:4], ref32[:4]):
        assert g.dtype == torch.float32 and _rel(g, r) <= K1_F32_TOL


def test_modes_kernels_refuse_other_shapes(quad_case, isrbd_case):
    """K12 and K13 are compiled for K1's nine shapes only (K12 with Cholesky
    alone at the AL ones): a quadruped linearization with one residual row
    fewer, and the AL shape with the block-Schur gain solve, raise
    ValueError before any launch."""
    import dataclasses

    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    c = quad_case
    rows = dataclasses.replace(c["rows"], gx=c["rows"].gx[:-1])
    args = tuple((c["lin"][k][:, :, :-1] if k == "Jxp" else c["lin"][k])
                 .contiguous() for k in ORDER)
    n0 = k12.riccati_associative.launches
    with pytest.raises(ValueError):
        k12.riccati_associative(*args, c["mu"], rows)
    inner = isrbd_case["al"].inner
    lin = isrbd_case["lin"]
    with pytest.raises(ValueError, match="riccati_associative has no kernel"):
        k12.riccati_associative(*(lin[k].contiguous() for k in ORDER),
                                inner.opts.mu0, inner.rows, "schur")
    assert k12.riccati_associative.launches == n0
    with pytest.raises(ValueError):
        k13.family_index(c["solver"].terms, 37, 24, rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_modes_occupancy(card_case, lip_case, quad_case, isrbd_case, qc_case,
                         dtype):
    """Each phase of every K12 instantiation at K1's first five shapes,
    and K13 at their families, report at least one block an SM (the
    point-feet and RK shapes: `test_family_modes_occupancy`)."""
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    rows = {"srbd": card_case["rows"], "lip": lip_case["rows"],
            "quadruped": quad_case["rows"],
            "isrbd_al": isrbd_case["al"].inner.rows,
            "isrbd_al_quadruped": qc_case["al"].inner.rows}
    for shape, solver in k12.KERNEL_INSTANCES:
        if shape not in rows:
            continue
        sz = k1.KERNEL_SHAPES[shape]
        occ = k12.occupancy(sz["nx"], sz["nu"], sz["nt"], rows[shape], solver,
                            dtype)
        assert min(v for k, v in occ.items() if "blocks" in k) >= 1
    for name in k13.FAMILY_NAMES:
        if name in rows:
            assert k13.occupancy(name, dtype)["blocks_per_sm"] >= 1


# ---------------- the SRBD family at every topology and step ----------------

FAMILY = ("point_feet", "kangaroo_rk2", "kangaroo_rk4", "quadruped_rk2",
          "quadruped_rk4", "point_feet_rk2", "point_feet_rk4")
FAMILY_B = (1, 64, 133)
FAMILY_F64_TOL = 1e-12          # of max(1, |twin|), K4, K3, srbd_evaluate


def _err1(got, want):
    got, want = got.double(), want.double()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    return float(((got - want).abs() / want.abs().clamp_min(1.0))[fin].max())


def _family_loop(inst, dtype, dev):
    from srbd_horizon_tpu_torch.models.kangaroo import point_feet
    from srbd_horizon_tpu_torch.models.quadruped import (quadruped_point_feet,
                                                         trot_group_mask)

    topology, _, step = inst.partition("_rk")
    step = "RK" + step if step else "EULER"
    kw = dict(kangaroo=({}, kangaroo_line_feet(), None),
              quadruped=(dict(contact_model=1, number_of_legs=4),
                         quadruped_point_feet(), trot_group_mask()),
              point_feet=(dict(contact_model=1, number_of_legs=2),
                          point_feet(), None))[topology]
    return build_srbd_loop(SRBDConfig(dtype=dtype, **kw[0]),
                           DDPOptions(max_iters=5), robot=kw[1], device=dev,
                           group_mask=kw[2], integrator=step)


@pytest.fixture(scope="module", params=FAMILY)
def family_case(request):
    """One (topology, step) instance on the card: float64 and float32
    solvers, a point near the walk at B=133 (plans around the nominal
    state, the contact plan of 5 WPG ticks), its float64 plain
    linearization and collapsed sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    inst = request.param
    dev = torch.device("cuda", 0)
    loop, prob = _family_loop(inst, torch.float64, dev)
    loop32, _ = _family_loop(inst, torch.float32, dev)
    ocp, s = prob.ocp, loop.solver
    Bw = max(FAMILY_B)
    rng = np.random.RandomState(15)
    params1, wst = dict(ocp.params), loop.wpg.init_state()
    for _ in range(5):
        params1, wst = loop.wpg.advance(
            params1, wst, torch.tensor(1, dtype=torch.int32, device=dev))
    params = {k: v.expand((Bw,) + tuple(v.shape)).contiguous()
              for k, v in params1.items()}
    ns, nx, nu = ocp.ns, ocp.nx, ocp.nu
    X = torch.as_tensor(prob.initial_state.cpu().numpy()[None, None]
                        + 0.02 * rng.randn(Bw, ns + 1, nx), device=dev)
    U = torch.as_tensor(prob.static_input.cpu().numpy()[None, None]
                        + 0.05 * rng.randn(Bw, ns, nu), device=dev)
    x0 = X[:, 0] + 0.005 * torch.as_tensor(rng.randn(Bw, nx), device=dev)
    lin = k4.srbd_linearize_plain(X, U, params, s.terms, s.rows, ocp.dt,
                                  s._wc(torch.float64))
    sweep = k1.riccati_backward_plain(*(lin[k] for k in ORDER), s.opts.mu0,
                                      s.rows)
    return dict(inst=inst, ocp=ocp, solver=s, solver32=loop32.solver, X=X,
                U=U, x0=x0, params=params, lin=lin, sweep=sweep)


def _fam_sub(case, Bw, dtype):
    t = lambda a: a[:Bw].to(dtype).contiguous()
    s = case["solver"] if dtype == torch.float64 else case["solver32"]
    return s, t, {k: t(v) for k, v in case["params"].items()}


@pytest.mark.parametrize("Bw", FAMILY_B)
def test_family_linearize_matches_plain(family_case, Bw):
    """K4 at the instance: float64 to 1e-12 of max(1, |twin|), float32 by
    K4's rule; the launch counted at its own instance only."""
    c = family_case
    out = {}
    for dtype in (torch.float64, torch.float32):
        s, t, p = _fam_sub(c, Bw, dtype)
        a = (t(c["X"]), t(c["U"]), p, s.terms, s.rows, c["ocp"].dt,
             s._wc(dtype))
        before = dict(k4.srbd_linearize.shape_launches)
        out[dtype] = (k4.srbd_linearize_plain(*a), k4.srbd_linearize(*a))
        after = k4.srbd_linearize.shape_launches
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
            == {c["inst"]: 1}
    torch.cuda.synchronize()
    ref = out[torch.float64][0]
    for k in ORDER:
        assert _err1(out[torch.float64][1][k], ref[k]) <= FAMILY_F64_TOL, k
        e = _rel(out[torch.float32][1][k], ref[k])
        assert e <= 2 * _rel(out[torch.float32][0][k], ref[k]) + 1e-6, k
        assert e <= K4_F32_CAP, k


@pytest.mark.parametrize("Bw", FAMILY_B)
def test_family_riccati_matches_plain(family_case, Bw):
    """K1 at the instance's shape, every form and gain solve compiled
    there: float64 to 1e-9, float32 to 1e-6 of the float64 twin."""
    c = family_case
    s = c["solver"]
    lin = {k: v[:Bw].contiguous() for k, v in c["lin"].items()}
    ocp = c["ocp"]
    shape = k1.kernel_shape(ocp.nx, ocp.nu, lin["Jt"].shape[1], s.rows)
    forms = [(f, q) for sh, f, q in k1.KERNEL_INSTANCES if sh == shape]
    assert ("collapsed", "schur") in forms and ("tassa", "schur") in forms
    a64 = tuple(lin[k] for k in ORDER)
    a32 = tuple(v.float().contiguous() for v in a64)
    for form, solver in forms:
        kw = dict(form=form, quu_solver=solver)
        ref = k1.riccati_backward_plain(*a64, s.opts.mu0, s.rows, **kw)
        got = k1.riccati_backward(*a64, s.opts.mu0, s.rows, **kw)
        got32 = k1.riccati_backward(*a32, s.opts.mu0, s.rows, **kw)
        torch.cuda.synchronize()
        for g, g32, r in zip(got, got32, ref):
            assert _rel(g, r) <= 1e-9, (form, solver)
            assert _rel(g32, r) <= K1_F32_TOL, (form, solver)


@pytest.mark.parametrize("nA", [1, 4])
@pytest.mark.parametrize("Bw", FAMILY_B)
def test_family_trial_matches_plain(family_case, Bw, nA):
    """K3 at the instance: float64 to 1e-12 of max(1, |twin|) with equal
    flags, float32 within 2× the float32 twin's error + 1e-6; member 1
    (B > 1) starts from a NaN state and is rejected."""
    c = family_case
    ks, Ks, dV1, dV2 = c["sweep"]
    d = c["lin"]["d"]
    D = torch.sum(d * d, dim=(1, 2))
    x0 = c["x0"].clone()
    if Bw > 1:
        x0[1] = float("nan")
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125][:nA], dtype=torch.float64,
                          device=d.device)
    out = {}
    for dtype in (torch.float64, torch.float32):
        s, t, p = _fam_sub(c, Bw, dtype)
        opts = s.opts
        merit0 = s.total_cost(t(c["X"]), t(c["U"]), p) + \
            opts.defect_weight * t(D)
        a = (t(x0), t(c["X"]), t(c["U"]), t(ks), t(Ks), t(d), alphas.to(dtype),
             p, merit0, t(D), t(dV1), t(dV2), s.terms, c["ocp"].dt,
             s._wc(dtype), opts.defect_weight, opts.beta,
             opts.alpha_converge_threshold)
        out[dtype] = (k3.srbd_trial_plain(*a), k3.srbd_trial(*a))
    torch.cuda.synchronize()
    ref = out[torch.float64][0]
    got = out[torch.float64][1]
    for g, r in zip(got[:4], ref[:4]):
        assert _err1(g, r) <= FAMILY_F64_TOL
    assert torch.equal(got[4], ref[4])
    if Bw > 1:
        assert not bool(got[4][:, 1].any())
    p32, g32 = out[torch.float32]
    for g, p_, r in zip(g32[:4], p32[:4], ref[:4]):
        fin = torch.isfinite(r)
        assert _rel(g[fin], r[fin]) <= 2 * _rel(p_[fin], r[fin]) + 1e-6


@pytest.mark.parametrize("pin", [False, True], ids=["plan", "pinned"])
@pytest.mark.parametrize("Bw", FAMILY_B)
def test_family_evaluate_matches_plain(family_case, Bw, pin):
    """srbd_evaluate at the instance (the defects under its step):
    float64 to 1e-12 of max(1, |twin|), float32 by K3's rule; member 1's
    plan (B > 1) holds a NaN that comes out NaN; the pinned plan bit for
    bit."""
    c = family_case
    X = c["X"].clone()
    if Bw > 1:
        X[1, 5, 4] = float("nan")
    out = {}
    for dtype in (torch.float64, torch.float32):
        s, t, p = _fam_sub(c, Bw, dtype)
        kw = dict(x0=t(c["x0"])) if pin else {}
        a = (t(X), t(c["U"]), p, s.terms, c["ocp"].dt, s._wc(dtype))
        out[dtype] = (k3.srbd_evaluate_plain(*a, **kw),
                      k3.srbd_evaluate(*a, **kw))
    torch.cuda.synchronize()
    ref, got = out[torch.float64]
    p32, g32 = out[torch.float32]
    for i in range(2):
        assert _err1(got[i], ref[i]) <= FAMILY_F64_TOL
        fin = torch.isfinite(ref[i])
        assert _rel(g32[i][fin], ref[i][fin]) <= \
            2 * _rel(p32[i][fin], ref[i][fin]) + 1e-6
        if Bw > 1:
            assert bool(torch.isnan(got[i][1])) and bool(torch.isnan(g32[i][1]))
    if pin:
        assert torch.equal(_bits(got[2]), _bits(ref[2]))
        assert torch.equal(_bits(g32[2]), _bits(p32[2]))


def test_family_refusals(family_case):
    """On CUDA tensors the instance's kernels refuse the problem with its
    step named otherwise (an RK problem never runs an Euler kernel, nor an
    Euler one an RK kernel) before any launch, and K1 refuses a form not
    compiled at its shape."""
    import dataclasses

    c = family_case
    s = c["solver"]
    ocp = c["ocp"]
    other = "RK4" if s.terms.step == "EULER" else "EULER"
    terms = dataclasses.replace(s.terms, step=other)
    counts = (k4.srbd_linearize.launches, k3.srbd_evaluate.launches)
    a = (c["X"][:2].contiguous(), c["U"][:2].contiguous(),
         {k: v[:2].contiguous() for k, v in c["params"].items()})
    with pytest.raises(ValueError, match="no kernel for the sizes"):
        k4.srbd_linearize(*a, terms, s.rows, ocp.dt, s._wc(torch.float64))
    if s.terms.step != "EULER":
        # the evaluation has no row table: the Euler instance exists, but
        # the RK problem's terms never reach it
        assert k4.check_kernel_shape("e", terms, ocp.nx, ocp.nu) != \
            k4.check_kernel_shape("e", s.terms, ocp.nx, ocp.nu)
    assert counts == (k4.srbd_linearize.launches, k3.srbd_evaluate.launches)
    shape = k1.kernel_shape(ocp.nx, ocp.nu, c["lin"]["Jt"].shape[1], s.rows)
    if (shape, "tassa", "cholesky") not in k1.KERNEL_INSTANCES:
        lin = {k: v[:2].contiguous() for k, v in c["lin"].items()}
        with pytest.raises(ValueError, match="no kernel for"):
            k1.riccati_backward(*(lin[k] for k in ORDER), s.opts.mu0, s.rows,
                                form="tassa", quu_solver="cholesky")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_family_occupancy(family_case, dtype):
    c = family_case
    inst, ns = c["inst"], c["ocp"].ns
    for occ in (k4.occupancy(dtype, inst), k3.trial_occupancy(dtype, inst),
                k3.evaluate_occupancy(ns, dtype, inst)):
        assert occ["blocks_per_sm"] >= 1 and occ["registers_per_thread"] > 0
    s, ocp = c["solver"], c["ocp"]
    nt = c["lin"]["Jt"].shape[1]
    for sh, form, solver in k1.KERNEL_INSTANCES:
        if sh == k1.kernel_shape(ocp.nx, ocp.nu, nt, s.rows):
            assert k1.blocks_per_sm(ocp.nx, ocp.nu, nt, s.rows, dtype, form,
                                    solver) >= 1


def test_spd_inverse_at_nu12():
    """K2 alone at the point-feet biped's nu=12: float64 to 1e-9 against
    `lm_spd_inverse`, float32 to 1e-6 of the float64 inverse of the same
    float32 stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = np.random.RandomState(12)
    J = torch.as_tensor(g.randn(300, 24, 12), device="cuda")
    A = (2.0 * J.transpose(-1, -2) @ J
         + 1e-6 * torch.eye(12, dtype=torch.float64, device="cuda")).contiguous()
    assert _rel(k1.spd_inverse(A), lm_spd_inverse(A)) <= 1e-9
    A32 = A.float()
    assert _rel(k1.spd_inverse(A32), lm_spd_inverse(A32.double())) <= 1e-6


# K12 and K13 at the family's instances: K12 at the instance's K1 shape
# with each gain solve, K13 at the instance's own family (its step in the
# true defects)


@pytest.mark.parametrize("Bw", FAMILY_B)
@pytest.mark.parametrize("solver", ["schur", "cholesky"])
def test_family_riccati_associative_matches_plain(family_case, solver, Bw):
    """K12 at the instance's shape against its twin: float64 to
    K12_F64_TOL, float32 to 1e-6 of the float64 twin on the same float32
    inputs; the sweep counted at its instantiation."""
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    c = family_case
    s, ocp = c["solver"], c["ocp"]
    lin = {k: v[:Bw].contiguous() for k, v in c["lin"].items()}
    args = lambda dtype: tuple(lin[k].to(dtype).contiguous() for k in ORDER)
    inst = k12.kernel_instance(ocp.nx, ocp.nu, lin["Jt"].shape[1], s.rows,
                               solver)
    ref = k12.riccati_associative_plain(*args(torch.float64), s.opts.mu0,
                                        s.rows, solver)
    n0 = k12.riccati_associative.instance_launches[inst]
    got = k12.riccati_associative(*args(torch.float64), s.opts.mu0, s.rows,
                                  solver)
    torch.cuda.synchronize()
    assert k12.riccati_associative.instance_launches[inst] == n0 + 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape and _rel(g, r) <= K12_F64_TOL
    got32 = k12.riccati_associative(*args(torch.float32), s.opts.mu0, s.rows,
                                    solver)
    ref32 = k12.riccati_associative_plain(
        *(a.double() for a in args(torch.float32)), s.opts.mu0, s.rows, solver)
    for g, r in zip(got32, ref32):
        assert g.dtype == torch.float32 and _rel(g, r) <= K1_F32_TOL


@pytest.mark.parametrize("nA", [1, 4])
@pytest.mark.parametrize("Bw", FAMILY_B)
def test_family_linear_trial_matches_plain(family_case, Bw, nA):
    """K13 at the instance's family (the instance's step in the true
    defects) against its twin: float64 to 1e-9 with the flags equal,
    float32 to 1e-6 of the float64 twin on the same float32 inputs; the
    launch counted at the family."""
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    c = family_case
    s, ocp = c["solver"], c["ocp"]
    fam = k13.family_index(s.terms, ocp.nx, ocp.nu, s.rows)
    assert k13.FAMILY_NAMES[fam] == c["inst"]
    lin = {k: v[:Bw].contiguous() for k, v in c["lin"].items()}
    ks, Ks, dV1, dV2 = k12.riccati_associative_plain(
        *(lin[k] for k in ORDER), s.opts.mu0, s.rows)
    X, U, x0 = (c[k][:Bw].contiguous() for k in ("X", "U", "x0"))
    params = {k: v[:Bw].contiguous() for k, v in c["params"].items()}
    D = torch.sum(lin["d"] ** 2, dim=(1, 2))
    merit0 = s.total_cost(X, U, params) + s.opts.defect_weight * D
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.125][:nA], dtype=torch.float64,
                          device=X.device)

    def args(dtype, cast=None):
        t = lambda a: a.to(dtype).contiguous()
        out = (t(x0), t(X), t(U), t(ks), t(Ks), t(lin["Sx"]), t(lin["Bs"]),
               t(lin["d"]), t(alphas), {k: t(v) for k, v in params.items()},
               t(merit0), t(D), t(dV1), t(dV2))
        if cast is not None:
            out = tuple({k: v.to(cast) for k, v in a.items()}
                        if isinstance(a, dict) else a.to(cast) for a in out)
        return out + (s.terms, s.rows, ocp.dt, s._wc(torch.float64),
                      s.opts.defect_weight, s.opts.beta,
                      s.opts.alpha_converge_threshold)

    ref = k13.linear_trial_plain(*args(torch.float64))
    n0 = k13.linear_trial.family_launches[fam]
    got = k13.linear_trial(*args(torch.float64))
    torch.cuda.synchronize()
    assert k13.linear_trial.family_launches[fam] == n0 + 1
    for g, r in zip(got[:4], ref[:4]):
        assert g.shape == r.shape and _rel(g, r) <= 1e-9
    assert torch.equal(got[4], ref[4])
    got32 = k13.linear_trial(*args(torch.float32))
    ref32 = k13.linear_trial_plain(*args(torch.float32, torch.float64))
    for g, r in zip(got32[:4], ref32[:4]):
        assert g.dtype == torch.float32 and _rel(g, r) <= K1_F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_family_modes_occupancy(family_case, dtype):
    """K12's three phases with each gain solve and K13's family at the
    instance report at least one block an SM."""
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

    c = family_case
    s, ocp = c["solver"], c["ocp"]
    nt = c["lin"]["Jt"].shape[1]
    for solver in ("schur", "cholesky"):
        occ = k12.occupancy(ocp.nx, ocp.nu, nt, s.rows, solver, dtype)
        assert min(v for k, v in occ.items() if "blocks" in k) >= 1
    occ = k13.occupancy(c["inst"], dtype)
    assert occ["blocks_per_sm"] >= 1 and occ["registers_per_thread"] > 0
