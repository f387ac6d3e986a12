"""AL-DDP — augmented-Lagrangian constrained trajectory optimization, the
batched entry points of srbd_horizon_tpu/solvers/alddp.py ported to
PyTorch.

  outer loop (fixed count):
    1. inner MS-DDP solve of min J(X,U) + Σ [ λᵀh + ρ/2‖h‖² ]
                                   + Σ ρ/2‖max(0, μ/ρ + g−ub)‖² (+ lb side)
    2. multiplier update  λ ← λ + ρ h,  μ ← max(0, μ + ρ (g−ub))
    3. penalty growth     ρ ← γρ if the violation did not drop by
                          `viol_decrease`

The AL terms are residual rows of the inner problem
(problems/isrbd_al.py), so the inner solver's Gauss-Newton machinery
and its kernels apply: the inner solves run `MSDDP.solve_batch` with the
isrbd kernels K5 (linearization), K1 (Riccati sweep) and K6 (trial).
Multipliers, penalty and bounds reach the inner problem through the
parameter dict (`al_*` keys). The layer around the inner solves runs on
the entries of kernels/isrbd_al.py: K7 (the constraint pass and the
multiplier update), K8a (the shift and the prior's seed), K8b (the padded
`al_*` tensors) and K8c (the prior's update), each its plain twin on the
CPU and its CUDA kernel on the card.

The batched entry points are batch-first: states, multipliers and priors
carry the fleet on their leading axis, where the JAX package vmaps member
functions: `solve_batch` (the offline seed), `solve_online_batch`, both
gait-phase priors and `serving_tick_batch`. The single-robot entry points
take the JAX package's unbatched state (no leading axis; ρ and the
violation 0-d): `solve` and `solve_online`, which run the inner
`MSDDP.solve` and the AL layer's entries as B=1 views; `init` and
`shift_warmstart` take either.

The inner solver is built with `quu_solver="cholesky"`, as the JAX
package builds it (alddp.py:324-331: at ρ → 1e8 the block-Schur solve
emits NaNs): `solve` and `solve_online` run K1's Tassa form with the
Cholesky gain solve. Under the default execution modes, the batched
lane-major sweep that every batched entry point runs ignores the option
and takes the block-Schur inverse, in JAX as here (see kernels/riccati.py).

The inner solver takes `ddp_opts`' execution modes as JAX passes them:
under `riccati_mode="associative"` (K12 at the AL shapes, Cholesky gains)
or `forward_pass="linear"` (K13), every entry point runs them, and the
batched inner solves are the JAX package's `vmap(solve)`
(`MSDDP._solve_members`), so they too take the Cholesky gain solve.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from srbd_horizon_tpu_torch.config import DDPOptions
from srbd_horizon_tpu_torch.kernels import isrbd_al
from srbd_horizon_tpu_torch.ocp.spec import OCP
from srbd_horizon_tpu_torch.problems.isrbd_al import ALTerms
from srbd_horizon_tpu_torch.solvers.msddp import DDPSolution, MSDDP


@dataclasses.dataclass(frozen=True)
class ALOptions:
    outer_iters: int = 8
    rho0: float = 1e2
    rho_growth: float = 10.0
    rho_max: float = 1e8
    viol_decrease: float = 0.25    # required violation contraction per outer
    tol: float = 1e-6              # target max constraint violation


class PhasePrior(NamedTuple):
    """Gait-phase-indexed priors for the multipliers the receding horizon
    injects at the tail. Per member (leading fleet axis B):
      lam_tail (B, P, n_eq)    prior for stage row ns−1, by the phase of
                               the schedule at that row
      lam_T    (B, P, n_eq_T)  prior for the terminal multipliers
      seen_*   (B, P) bool     entry valid (first visit copies, later
                               visits EMA-blend)"""

    lam_tail: torch.Tensor
    lam_T: torch.Tensor
    seen_tail: torch.Tensor
    seen_T: torch.Tensor


class FullPhasePrior(NamedTuple):
    """Per-phase tables of the whole stage-equality multiplier field: each
    (node, phase) entry receives one λ-update per gait cycle and converges
    across cycles. Inequality multipliers stay rolled.
      lam_eq (B, P, ns, n_eq), lam_eq_T (B, P, n_eq_T), seen (B, P) bool"""

    lam_eq: torch.Tensor
    lam_eq_T: torch.Tensor
    seen: torch.Tensor


class ALState(NamedTuple):
    """Batch-first AL solver state (B leads every leaf)."""

    sol: DDPSolution
    lam_eq: torch.Tensor      # (B, ns, n_eq) stage equality multipliers
    lam_eq_T: torch.Tensor    # (B, n_eq_T) terminal equality multipliers
    mu_ub: torch.Tensor       # (B, ns, n_ineq) upper-bound multipliers (≥0)
    mu_lb: torch.Tensor       # (B, ns, n_ineq) lower-bound multipliers (≥0)
    mu_x_ub: torch.Tensor     # (B, ns+1, nx) state upper-box multipliers
    mu_x_lb: torch.Tensor     # (B, ns+1, nx) state lower-box multipliers
    mu_u_ub: torch.Tensor     # (B, ns, nu) input upper-box multipliers
    mu_u_lb: torch.Tensor     # (B, ns, nu) input lower-box multipliers
    rho: torch.Tensor         # (B,) penalty
    viol: torch.Tensor        # (B,) last max constraint violation


@dataclasses.dataclass
class ALDDP:
    """Augmented-Lagrangian solver over a constrained OCP with equality
    stacks, bounded inequality rows and variable boxes (the isrbd
    problem). `ocp.constants["isrbd_terms"]` names the problem to the
    kernels of the inner solver."""

    ocp: OCP
    ddp_opts: DDPOptions = DDPOptions()
    al_opts: ALOptions = ALOptions()

    def __post_init__(self):
        outer = self.ocp
        if "isrbd_terms" not in outer.constants:
            raise NotImplementedError(
                "the inner solver's kernels are written for the isrbd "
                "problem: the OCP's constants need 'isrbd_terms' "
                "(problems/isrbd.py)")
        if (outer.ineq_ub is None or outer.x_lb is None or outer.x_ub is None
                or outer.u_lb is None or outer.u_ub is None):
            raise NotImplementedError(
                "the ported AL solver takes OCPs with inequality rows and "
                "both variable boxes (the isrbd problem)")
        dev, dtype = outer.x_lb.device, outer.x_lb.dtype
        zx = torch.zeros(outer.nx, dtype=dtype, device=dev)
        zu = torch.zeros(outer.nu, dtype=dtype, device=dev)
        p0 = {k: v[0] for k, v in outer.params.items()}
        n_r = outer.stage_residual(zx, zu, p0).shape[0]
        n_eq = outer.stage_eq(zx, zu, p0).shape[0]
        n_eq_T = outer.terminal_eq(zx, p0).shape[0]
        n_in = outer.stage_ineq(zx, zu, p0).shape[0]
        self._sizes = (n_eq, n_eq_T, n_in)
        self._w_eq = outer.eq_rho_weight
        self._w_eq_T = outer.eq_rho_weight_T
        self._bounds = (outer.x_lb, outer.x_ub, outer.u_lb, outer.u_ub)
        self._padded_bounds: Dict = {}

        terms = ALTerms(
            ocp=outer, outer=outer.constants["isrbd_terms"],
            eq_scale=outer.eq_scale, eq_scale_T=outer.eq_scale_T,
            sqw_eq=None if self._w_eq is None else torch.sqrt(self._w_eq),
            sqw_eq_T=(None if self._w_eq_T is None
                      else torch.sqrt(self._w_eq_T)),
            n_eq=n_eq, n_eq_T=n_eq_T, n_ineq=n_in,
        )
        self.terms = terms

        # Inner-stack sparsity: the inner stage stack is
        #   [outer residual; AL-eq; cone ub; cone lb;
        #    x-box ub; x-box lb; u-box ub; u-box lb]
        # and its x/u row sets are composed from the outer declarations,
        # so the inner solves take the blocksparse sweep and the sliced
        # linearization. Outer residual_x/u_rows index the leading
        # [stage_residual; stage_eq] rows; cone segments use
        # ineq_x/u_rows (None = all rows, both); a box row is live iff its
        # dim is ever finitely bounded in the static bounds (bounds
        # delivered through the params must keep that pattern).
        if outer.residual_x_rows is None or outer.residual_u_rows is None:
            raise NotImplementedError(
                "the inner solver needs the outer OCP's declared row sparsity")
        xr = [int(r) for r in outer.residual_x_rows]
        ur = [int(r) for r in outer.residual_u_rows]
        off = n_r + n_eq
        cone_x = outer.ineq_x_rows if outer.ineq_x_rows is not None else range(n_in)
        cone_u = outer.ineq_u_rows if outer.ineq_u_rows is not None else range(n_in)
        for seg in (0, 1):                               # t_ub, then t_lb
            xr.extend(off + seg * n_in + int(r) for r in cone_x)
            ur.extend(off + seg * n_in + int(r) for r in cone_u)
        off += 2 * n_in
        for b in (outer.x_ub, outer.x_lb):               # ub rows, lb rows
            live = np.where(np.isfinite(b.cpu().numpy()).any(0))[0]
            xr.extend(off + int(j) for j in live)
            off += outer.nx
        for b in (outer.u_ub, outer.u_lb):
            live = np.where(np.isfinite(b.cpu().numpy()).any(0))[0]
            ur.extend(off + int(j) for j in live)
            off += outer.nu

        def no_eq(x, *_):
            return x.new_zeros(x.shape[:-1] + (0,))

        inner_ocp = dataclasses.replace(
            outer,
            stage_residual=terms.stage_residual,
            terminal_residual=terms.terminal_residual,
            stage_eq=no_eq,
            terminal_eq=no_eq,
            residual_x_rows=tuple(sorted(xr)),
            residual_u_rows=tuple(sorted(ur)),
            constants=dict(outer.constants, terms=terms),
        )
        # the unbatched inner solves take the Cholesky gain solve, and so do
        # the batched ones under a non-default riccati_mode or forward_pass
        # (JAX's vmap(solve)); under the defaults the batched ones ignore
        # the option, as in the JAX package
        self._inner = MSDDP(inner_ocp, dataclasses.replace(
            self.ddp_opts, quu_solver="cholesky"))

    @property
    def inner(self) -> MSDDP:
        """The inner batched MS-DDP solver (kernels K5, K1, K6). Its
        `on_phase` hook also receives this layer's phases ("al_shift",
        "al_params", "al_constraints", "al_prior")."""
        return self._inner

    def _phase(self, name: str) -> None:
        self._inner._phase(name)

    # ---------- sizes ----------

    def init(self, x0, U0: Optional[torch.Tensor] = None) -> ALState:
        """Cold state for x0 (B, nx), U0 (ns, nu) or (B, ns, nu); or for one
        robot, x0 (nx,) and U0 (ns, nu), the unbatched state."""
        if x0.dim() == 1:
            return _unbatch(self.init(x0[None], U0))
        n_eq, n_eq_T, n_in = self._sizes
        ns, nx, nu = self.ocp.ns, self.ocp.nx, self.ocp.nu
        Bsz = x0.shape[0]
        if U0 is not None and U0.dim() == 2:
            U0 = U0.expand(Bsz, ns, nu).contiguous()
        z = lambda *shape: torch.zeros((Bsz,) + shape, dtype=x0.dtype,
                                       device=x0.device)
        return ALState(
            sol=self._inner.init(x0, U0),
            lam_eq=z(ns, n_eq), lam_eq_T=z(n_eq_T),
            mu_ub=z(ns, n_in), mu_lb=z(ns, n_in),
            mu_x_ub=z(ns + 1, nx), mu_x_lb=z(ns + 1, nx),
            mu_u_ub=z(ns, nu), mu_u_lb=z(ns, nu),
            rho=torch.full((Bsz,), self.al_opts.rho0, dtype=x0.dtype,
                           device=x0.device),
            viol=torch.full((Bsz,), float("inf"), dtype=x0.dtype,
                            device=x0.device),
        )

    # ---------- constraint evaluation at a trajectory ----------

    def _bounds_from(self, params):
        """Bound tensors for this solve: the params can override the static
        OCP bounds (online re-pinning)."""
        x_lb, x_ub, u_lb, u_ub = self._bounds
        return (params.get("x_lb", x_lb), params.get("x_ub", x_ub),
                params.get("u_lb", u_lb), params.get("u_ub", u_ub))

    def _constraints(self, X, U, params):
        """h (B,ns,n_eq), hT (B,n_eq_T) in scaled units, g (B,ns,n_ineq)
        and the per-member max violation (B,): K7 in its evaluation
        mode."""
        return isrbd_al.isrbd_al_constraints(self, X, U, params)

    # ---------- solve ----------

    def _static_padded_bounds(self, Bsz, dtype, device):
        """The static boxes as (B, ns+1, dim) parameter tensors (u boxes
        padded with an unbounded terminal row), built once per fleet size."""
        key = (Bsz, dtype, str(device))
        if key not in self._padded_bounds:
            x_lb, x_ub, u_lb, u_ub = (b.to(device=device, dtype=dtype)
                                      for b in self._bounds)
            inf = float("inf")
            ex = lambda b: b.expand((Bsz,) + tuple(b.shape)).contiguous()
            self._padded_bounds[key] = (
                ex(x_lb), ex(x_ub),
                ex(torch.cat([u_lb, u_lb.new_full((1, u_lb.shape[1]), -inf)])),
                ex(torch.cat([u_ub, u_ub.new_full((1, u_ub.shape[1]), inf)])),
            )
        return self._padded_bounds[key]

    def _params_with_multipliers(self, params, st: ALState) -> Dict[str, torch.Tensor]:
        """The inner solver's parameter dict: the outer params plus the
        multipliers, penalty and bounds under `al_*` keys, each padded to
        (B, ns+1, dim) (K8b)."""
        return isrbd_al.isrbd_al_params(self, params, st)

    def _updated_multipliers(self, st: ALState, X, U, h, hT, g, params, rho):
        """AL multiplier updates from given h, hT and g; rho is (B,). The
        plain reference: the solves run K7's offline mode, which forms h,
        hT and g itself."""
        return isrbd_al.multipliers_plain(self, st, X, U, h, hT, g, params, rho)

    def solve_batch(self, st: ALState, x0, params) -> ALState:
        """Batched AL solve over the leading fleet axis: `outer_iters`
        outer iterations, each a batched inner MS-DDP solve, the multiplier
        updates and the per-member penalty schedule."""
        for _ in range(self.al_opts.outer_iters):
            p_in = self._params_with_multipliers(params, st)
            sol = self._inner.solve_batch(st.sol, x0, p_in)
            (lam_eq, lam_eq_T, mu_ub, mu_lb, mu_x_ub, mu_x_lb, mu_u_ub,
             mu_u_lb, rho_new, viol) = isrbd_al.isrbd_al_constraints(
                self, sol.X, sol.U, params, st=st, offline=True)
            st = ALState(
                sol=sol, lam_eq=lam_eq, lam_eq_T=lam_eq_T,
                mu_ub=mu_ub, mu_lb=mu_lb, mu_x_ub=mu_x_ub, mu_x_lb=mu_x_lb,
                mu_u_ub=mu_u_ub, mu_u_lb=mu_u_lb, rho=rho_new, viol=viol)
        return st

    def solve(self, st: ALState, x0, params) -> ALState:
        """The full AL solve for one robot (`solve`, alddp.py:505-534):
        `outer_iters` outer iterations of an inner `MSDDP.solve`, K7's
        offline multiplier update with the ρ schedule, and K8b for the
        inner parameters, each at B=1. `st` unbatched, x0 (nx,), params
        leaves (ns+1, dim) (u-box overrides (ns, nu))."""
        p1 = {k: v[None] for k, v in params.items()}
        stb = _batch(st)
        for _ in range(self.al_opts.outer_iters):
            p_in = self._params_with_multipliers(p1, stb)
            sol = self._inner.solve(_unbatch(stb.sol), x0,
                                    {k: v[0] for k, v in p_in.items()})
            solb = _batch(sol)
            (lam_eq, lam_eq_T, mu_ub, mu_lb, mu_x_ub, mu_x_lb, mu_u_ub,
             mu_u_lb, rho_new, viol) = isrbd_al.isrbd_al_constraints(
                self, solb.X, solb.U, p1, st=stb, offline=True)
            stb = ALState(
                sol=solb, lam_eq=lam_eq, lam_eq_T=lam_eq_T,
                mu_ub=mu_ub, mu_lb=mu_lb, mu_x_ub=mu_x_ub, mu_x_lb=mu_x_lb,
                mu_u_ub=mu_u_ub, mu_u_lb=mu_u_lb, rho=rho_new, viol=viol)
        return _unbatch(stb)

    def solve_online(self, st: ALState, x0, params) -> ALState:
        """One frozen-penalty outer iteration for one robot (`solve_online`,
        alddp.py:570-583): the inner `MSDDP.solve` and K7's online equality
        update, at B=1."""
        p1 = {k: v[None] for k, v in params.items()}
        stb = _batch(st)
        p_in = self._params_with_multipliers(p1, stb)
        sol = self._inner.solve(st.sol, x0, {k: v[0] for k, v in p_in.items()})
        lam_eq, lam_eq_T, viol = isrbd_al.isrbd_al_constraints(
            self, sol.X[None], sol.U[None], p1, st=stb)
        return st._replace(sol=sol, lam_eq=lam_eq[0], lam_eq_T=lam_eq_T[0],
                           viol=viol[0])

    def solution_dict(self, st: ALState):
        """The inner solver's `solution_dict` of the state's plan."""
        return self._inner.solution_dict(st.sol)

    def solve_online_batch(self, st: ALState, x0, params) -> ALState:
        """One frozen-penalty outer iteration over the fleet: the batched
        inner solve and the equality-multiplier update."""
        self._phase("al_params")
        p_in = self._params_with_multipliers(params, st)
        sol = self._inner.solve_batch(st.sol, x0, p_in)
        self._phase("al_constraints")
        lam_eq, lam_eq_T, viol = isrbd_al.isrbd_al_constraints(
            self, sol.X, sol.U, params, st=st)
        return st._replace(sol=sol, lam_eq=lam_eq, lam_eq_T=lam_eq_T,
                           viol=viol)

    def shift_warmstart(self, st: ALState) -> ALState:
        """Roll the warm start one node forward (last row repeated) — the
        trajectory and the node-indexed multipliers — so the initial
        iterate and the multiplier estimates line up with the receding
        horizon. The hybrid node masks stay put, so multipliers shifted
        across the model boundary start one update behind (K8a). Takes a
        fleet's state or one robot's (unbatched, 0-d ρ)."""
        if st.rho.dim() == 0:
            return _unbatch(isrbd_al.isrbd_al_shift(self, _batch(st)))
        return isrbd_al.isrbd_al_shift(self, st)

    # ---------- gait-phase multiplier priors ----------

    def _prior_zeros(self, batch: int, period: int):
        """Makers of the empty prior tables, on the problem's device and in
        its dtype (where the `ALState` they seed lives)."""
        dev, dtype = self.ocp.x_lb.device, self.ocp.x_lb.dtype
        z = lambda *s: torch.zeros((batch, period) + s, dtype=dtype, device=dev)
        seen = lambda: torch.zeros((batch, period), dtype=torch.bool, device=dev)
        return z, seen

    def init_phase_prior(self, period: int, batch: int) -> PhasePrior:
        """Empty per-member, per-phase tail-multiplier tables."""
        n_eq, n_eq_T, _ = self._sizes
        z, seen = self._prior_zeros(batch, period)
        return PhasePrior(lam_tail=z(n_eq), lam_T=z(n_eq_T),
                          seen_tail=seen(), seen_T=seen())

    def _seed_from_prior(self, st: ALState, prior: PhasePrior, phase) -> ALState:
        """Replace the injected tail multipliers with the phase tables'
        entries (where visited). `phase` (B,) is the cycle index of this
        tick's terminal write; the stage tail row holds the previous
        tick's, phase − 1. The plain reference: the serving tick seeds
        inside K8a's shift."""
        return isrbd_al.seed_tail_plain(st, prior, phase)

    def _update_prior(self, prior: PhasePrior, st: ALState, phase,
                      ema: float) -> PhasePrior:
        """EMA the post-solve tail multipliers into the phase tables
        (first visit copies; K8c)."""
        return isrbd_al.isrbd_al_prior_update(self, prior, st, phase, ema)

    def init_full_phase_prior(self, period: int, batch: int) -> FullPhasePrior:
        """Empty per-member full-field phase tables."""
        n_eq, n_eq_T, _ = self._sizes
        z, seen = self._prior_zeros(batch, period)
        return FullPhasePrior(
            lam_eq=z(self.ocp.ns, n_eq), lam_eq_T=z(n_eq_T), seen=seen())

    def _seed_full_prior(self, st: ALState, prior: FullPhasePrior, phase) -> ALState:
        """Replace the whole stage and terminal equality-multiplier field
        with the phase's table entry (once visited; the rolled field until
        then). The plain reference: the serving tick seeds inside K8a's
        shift."""
        return isrbd_al.seed_full_plain(st, prior, phase)

    def _update_full_prior(self, prior: FullPhasePrior, st: ALState, phase,
                           ema: float) -> FullPhasePrior:
        """EMA the post-solve multiplier field into the phase tables (K8c)."""
        return isrbd_al.isrbd_al_prior_update(self, prior, st, phase, ema)

    def serving_tick_batch(self, st: ALState, x0, params, outers: int = 2,
                           prior=None, phase=None, prior_ema: float = 0.5):
        """The constrained fleet-serving tick: shifted warm start, then
        `outers` frozen-penalty outer iterations. Callers advance the
        WPG/params first, then pass the new x0 here.

        With `prior` (and the per-member `phase`, the cycle index of this
        tick's WPG terminal write): seed multipliers from the gait-phase
        tables before solving and EMA the post-solve values back —
        returns (ALState, prior). A `PhasePrior` seeds only the injected
        tail rows; a `FullPhasePrior` replaces the whole
        equality-multiplier field. Without a prior, returns the ALState
        alone."""
        self._phase("al_shift")
        st = isrbd_al.isrbd_al_shift(self, st, prior, phase)
        for _ in range(outers):
            st = self.solve_online_batch(st, x0, params)
        if prior is not None:
            self._phase("al_prior")
            prior = isrbd_al.isrbd_al_prior_update(self, prior, st, phase,
                                                   prior_ema)
        self._phase("glue")
        return st if prior is None else (st, prior)


def _batch(tree):
    """A one-robot `ALState` or `DDPSolution` (or a tensor) as a B=1 fleet:
    every tensor with a leading axis of 1."""
    if isinstance(tree, torch.Tensor):
        return tree[None]
    return type(tree)(*(_batch(v) for v in tree))


def _unbatch(tree):
    """The inverse of `_batch`: member 0 of a B=1 fleet."""
    if isinstance(tree, torch.Tensor):
        return tree[0]
    return type(tree)(*(_unbatch(v) for v in tree))
