"""PyTorch port, the CUDA kernels against their plain versions on the card,
with the tolerances of chip_smoke.py: float64 to 1e-9 relative; in
float32 against the float64 plain result, K1 to 1e-6 relative (it
computes in float64 on chip, so only float32 storage rounding remains),
and K3 (the fused trial) and K4 (the linearization) within 2× the float32
plain version's own error plus 1e-6, K4 also below 1e-5. Skipped where no
CUDA device is present (run on the card with
`python -m pytest tests/test_torch_kernels_cuda.py -m cuda`)."""

import numpy as np
import pytest
import torch

from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.kernels import linearize as k4
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels import rollout as k3
from srbd_horizon_tpu_torch.runtime.loop import build_srbd_loop

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
