"""The augmented-Lagrangian inner problem of the constrained solver: the
outer OCP's residuals with its equality, inequality and box constraints
folded in as residual rows (srbd_horizon_tpu/solvers/alddp.py:136-256).

    eq:    √(ρ w_j)·S_j h_j + λ_j / √(ρ w_j)
    ineq:  √ρ·[ub finite]·max(0, g − ub + μ_ub/ρ)   and the lb side
    boxes: the same with g = x (resp. u), node-indexed bounds

The inner stage stack is [outer residual; AL-eq; cone ub; cone lb; x-box
ub; x-box lb; u-box ub; u-box lb] (240 rows for the isrbd biped) and the
terminal stack [outer terminal residual; AL-eq_T; x-box ub; x-box lb]
(101 rows). Multipliers, penalty and bounds arrive through the parameter
dict under `al_*` keys, padded to (…, ns+1, dim) like every parameter.

`ALTerms` is the terms object of the inner OCP: the batched MS-DDP solver
evaluates costs through it and hands it to the kernels K5
(kernels/isrbd_linearize.py) and K6 (kernels/isrbd_rollout.py), which
read the isrbd constants from `outer` and the row scales from here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

# parameter tensors the kernels K5/K6 read, in their order; dims by name
PARAM_KEYS = (
    "mask_track", "Wo", "rdot_ref", "w_ref", "c_ref", "mask_srbd",
    "mask_lip", "mask_lipzone", "al_rho", "al_lam_eq", "al_lam_eq_T",
    "al_mu_ub", "al_mu_lb", "al_x_lb", "al_x_ub", "al_mu_x_ub",
    "al_mu_x_lb", "al_u_lb", "al_u_ub", "al_mu_u_ub", "al_mu_u_lb",
)


def _finite_or_zero(b):
    fin = torch.isfinite(b)
    return fin, torch.where(fin, b, torch.zeros_like(b))


def one_sided_pre(v, lb, ub, mu_lb, mu_ub, rho):
    """Pre-activations of the one-sided AL pair for lb ≤ v ≤ ub and the
    masks of the finite bounds: (a_ub, a_lb, ub_m, lb_m). A ±inf bound is
    replaced by 0 before any arithmetic and masked out after."""
    ub_fin, ub_f = _finite_or_zero(ub)
    lb_fin, lb_f = _finite_or_zero(lb)
    a_ub = v - ub_f + mu_ub / rho
    a_lb = lb_f - v + mu_lb / rho
    return a_ub, a_lb, ub_fin.to(v.dtype), lb_fin.to(v.dtype)


def one_sided(v, lb, ub, mu_lb, mu_ub, rho, sr):
    """AL residual pair (t_ub, t_lb) for lb ≤ v ≤ ub."""
    a_ub, a_lb, ub_m, lb_m = one_sided_pre(v, lb, ub, mu_lb, mu_ub, rho)
    return (sr * ub_m * torch.clamp(a_ub, min=0.0),
            sr * lb_m * torch.clamp(a_lb, min=0.0))


def _relu_slope(a):
    """d max(0, a)/da: 1 above 0, 0 below, and ½ at exactly 0 — the value
    `jax.jacfwd` gives `jnp.maximum` at a tie, which the solver meets
    whenever a swing foot's force is exactly zero with a zero multiplier."""
    return (a > 0).to(a.dtype) + 0.5 * (a == 0).to(a.dtype)


def one_sided_slopes(v, lb, ub, mu_lb, mu_ub, rho, sr):
    """(∂t_ub/∂v, ∂t_lb/∂v) of `one_sided`: ±√ρ where the row is active
    (±½√ρ where its pre-activation is exactly 0)."""
    a_ub, a_lb, ub_m, lb_m = one_sided_pre(v, lb, ub, mu_lb, mu_ub, rho)
    return (sr * ub_m * _relu_slope(a_ub), -(sr * lb_m * _relu_slope(a_lb)))


def bound_violation(v, lb, ub):
    """Elementwise violation of lb ≤ v ≤ ub (0 where satisfied)."""
    zero = torch.zeros_like(v)
    over = torch.where(torch.isfinite(ub), torch.clamp(v - ub, min=0.0), zero)
    under = torch.where(torch.isfinite(lb), torch.clamp(lb - v, min=0.0), zero)
    return torch.maximum(over, under)


@dataclasses.dataclass(frozen=True)
class ALTerms:
    """Inner-problem terms: the outer OCP (its callables and static
    inequality bounds), the outer problem's `ISRBDTerms`, and the per-row
    scale S and stiffness root √w of the equality stacks (None = ones)."""

    family = "isrbd_al"

    ocp: Any                               # the outer OCP
    outer: Any                             # its ISRBDTerms
    eq_scale: Optional[torch.Tensor]
    eq_scale_T: Optional[torch.Tensor]
    sqw_eq: Optional[torch.Tensor]
    sqw_eq_T: Optional[torch.Tensor]
    n_eq: int
    n_eq_T: int
    n_ineq: int
    _cache: Dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def n_rho(self) -> int:
        """Rows of the inner stage stack."""
        return (self.outer.n_res + self.n_eq + 2 * self.n_ineq
                + 2 * self.ocp.nx + 2 * self.ocp.nu)

    @property
    def n_term(self) -> int:
        """Rows of the inner terminal stack."""
        return 15 + self.n_eq_T + 2 * self.ocp.nx

    def stage_eq(self, x, u, p):
        """The scaled equality stack S·h."""
        h = self.ocp.stage_eq(x, u, p)
        return h if self.eq_scale is None else self.eq_scale * h

    def terminal_eq(self, x, p):
        h = self.ocp.terminal_eq(x, p)
        return h if self.eq_scale_T is None else self.eq_scale_T * h

    def stage_residual(self, x, u, p):
        ocp = self.ocp
        rho = p["al_rho"][..., 0:1]
        sr = torch.sqrt(rho)
        srw = sr if self.sqw_eq is None else sr * self.sqw_eq
        terms = [ocp.stage_residual(x, u, p),
                 srw * self.stage_eq(x, u, p) + p["al_lam_eq"] / srw]
        terms += one_sided(ocp.stage_ineq(x, u, p), ocp.ineq_lb, ocp.ineq_ub,
                           p["al_mu_lb"], p["al_mu_ub"], rho, sr)
        terms += one_sided(x, p["al_x_lb"], p["al_x_ub"], p["al_mu_x_lb"],
                           p["al_mu_x_ub"], rho, sr)
        terms += one_sided(u, p["al_u_lb"], p["al_u_ub"], p["al_mu_u_lb"],
                           p["al_mu_u_ub"], rho, sr)
        return torch.cat(terms, dim=-1)

    def terminal_residual(self, x, p):
        rho = p["al_rho"][..., 0:1]
        sr = torch.sqrt(rho)
        srw = sr if self.sqw_eq_T is None else sr * self.sqw_eq_T
        terms = [self.ocp.terminal_residual(x, p),
                 srw * self.terminal_eq(x, p) + p["al_lam_eq_T"] / srw]
        terms += one_sided(x, p["al_x_lb"], p["al_x_ub"], p["al_mu_x_lb"],
                           p["al_mu_x_ub"], rho, sr)
        return torch.cat(terms, dim=-1)

    def family_args(self, wc: float) -> Tuple[float, ...]:
        """What this family's cost functions and kernels take besides the
        common arguments: nothing (the inner OCP has no equality stack of
        its own, so the penalty root √w_c has no row to scale)."""
        return ()

    def stage_rho(self, x, u, p):
        """The inner OCP's stacked stage residual is `stage_residual`."""
        return self.stage_residual(x, u, p)

    def total_cost(self, X, U, params):
        """Σ_n ‖ρ_n‖² + ‖ρ_N‖² over leading batch axes of X (…, ns+1, nx);
        params leaves are (…, ns+1, dim)."""
        ns = U.shape[-2]
        rho = self.stage_residual(X[..., :ns, :], U,
                                  {k: v[..., :ns, :] for k, v in params.items()})
        rt = self.terminal_residual(X[..., ns, :],
                                    {k: v[..., ns, :] for k, v in params.items()})
        return torch.sum(rho * rho, dim=(-1, -2)) + torch.sum(rt * rt, dim=-1)

    def check_cone_bounds(self) -> None:
        """Raise unless the inequality rows are bounded as the isrbd
        kernels assume, g ≤ 0 with no lower bound. The bounds are static,
        so they are read from the device once."""
        if "cone_bounds_ok" not in self._cache:
            lb, ub = self.ocp.ineq_lb, self.ocp.ineq_ub
            self._cache["cone_bounds_ok"] = bool(
                torch.all(ub == 0) & torch.all(torch.isinf(lb) & (lb < 0)))
        if not self._cache["cone_bounds_ok"]:
            raise ValueError("the isrbd kernels take cone rows g ≤ 0 only")

    def row_scales(self) -> Tuple[float, ...]:
        """S (n_eq), √w (n_eq), S_T (n_eq_T), √w_T (n_eq_T) as host floats,
        for the kernels (ones where a scale is absent)."""
        if "row_scales" not in self._cache:
            def floats(t, n):
                return [1.0] * n if t is None else [float(v) for v in t.tolist()]
            self._cache["row_scales"] = tuple(
                floats(self.eq_scale, self.n_eq) + floats(self.sqw_eq, self.n_eq)
                + floats(self.eq_scale_T, self.n_eq_T)
                + floats(self.sqw_eq_T, self.n_eq_T))
        return self._cache["row_scales"]

    def param_dims(self) -> Tuple[int, ...]:
        """Trailing dims of `PARAM_KEYS`, in order."""
        nc, nx, nu = self.outer.nc, self.ocp.nx, self.ocp.nu
        return (1, 1, 3, 3, nc, 1, 1, 1, 1, self.n_eq, self.n_eq_T,
                self.n_ineq, self.n_ineq, nx, nx, nx, nx, nu, nu, nu, nu)
