"""Multiple-shooting Gauss-Newton DDP — srbd_horizon_tpu/solvers/msddp.py
ported to PyTorch: the production batched path (`MSDDP.solve_batch`) and
the single-robot solve (`MSDDP.solve`).

One iteration for a fleet of B members:
  1. the sliced linearization in closed form, over the declared row
     slices only — kernel K4 (`kernels/linearize.py`) for the SRBD
     problem, K5 (`kernels/isrbd_linearize.py`) for the isrbd AL inner
     problem, K10 (`kernels/lip_linearize.py`) for the LIP problem;
  2. the blocksparse backward Riccati sweep — kernel K1
     (`kernels/riccati.py`), for each;
  3. the α₀ trial and, for members that reject it, the gated, compacted
     backtracking fan — kernel K3 (`kernels/rollout.py`), K6
     (`kernels/isrbd_rollout.py`) or K11 (`kernels/lip_rollout.py`) rolls
     out, costs and Armijo-tests every α of a trial in one launch;
  4. the masked update; active-set compaction across iterations.

A solve's starting cost and its final defect norm come from one
evaluation launch each (`srbd_evaluate` in `kernels/rollout.py`,
`isrbd_evaluate` in `kernels/isrbd_rollout.py`, `lip_evaluate` in
`kernels/lip_rollout.py`), which evaluates the plan
with the trial kernel's rows and step and no rollout; the first also pins
node 0 to x0 and writes the pinned plan the solve starts from.

The linearization, trial and evaluation kernels are written per problem
family: the solver reads the problem's terms object
(`ocp.constants["terms"]`: `SRBDTerms`, `LIPTerms`, or the AL solver's
`ALTerms`) and
takes the kernels its `family` names; costs go through the same object.

`solve` runs one robot (unbatched X (ns+1, nx), U (ns, nu), x0 (nx,),
params leaves (ns+1, dim)) on the same kernels at B=1, as the JAX
package's unbatched `solve` (msddp.py:1689-1739) computes it: the
Tassa-form sweep of `_backward` (K1's Tassa instantiations, with the gain
solve `DDPOptions.quu_solver`), and the line search of `_iteration`
(:1580-1673) in `line_search_mode`: "parallel", `_parallel_line_search`'s
chunks α₀·f^(cK+i), i < K (:1494-1578), one K3 or K6 launch of K α's a
chunk; or "sequential", one launch of one α a step.

The JAX package's two other execution modes run on `solve`'s iteration:
`riccati_mode="associative"` takes the associative-scan sweep
(`_backward_associative`, msddp.py:1250) in K1's place — kernel K12
(`kernels/riccati_associative.py`) — and `forward_pass="linear"` makes the
parallel line search's trial the linearized forward pass with the measured
defects (`_forward_linear`, :1454, in the trial of :1507-1531) — kernel K13
(`kernels/linear_trial.py`); the sequential line search always rolls out.
Under either, `solve_batch` is the JAX package's `vmap(solve)`
(`_solve_members`). Both kernels are compiled for K1's nine shapes: the
SRBD problem of the Kangaroo, the point-feet quadruped and the point-feet
biped under Euler, RK2 and RK4 (K13 a family for each step; K12 one
instantiation for RK2 and RK4, which share K1's shape), the LIP, and the AL
inner problem of both the Kangaroo and the quadruped (K12 with the
Cholesky gain solve alone there, which the AL solver always takes); the
solver refuses the modes on any other problem or gain solve.

The JAX package's `lax.while_loop`/`lax.cond` decisions (the solve loop,
the fan deepening, the fan and active-set compaction) are host decisions
here: each reads one small device value back. `MSDDP.host_syncs` counts
those reads. Compaction gathers exactly the members concerned; each
member's arithmetic is independent of its position in the batch, so only
the per-member semantics of the JAX path are kept, not its fixed-size
gathers. Decisions that depend on the JAX batch size (the fan-compaction
threshold inside a compacted iteration) use the size JAX would see.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from srbd_horizon_tpu_torch.config import DDPOptions, check_options
from srbd_horizon_tpu_torch.kernels.isrbd_linearize import isrbd_linearize
from srbd_horizon_tpu_torch.kernels.isrbd_rollout import (
    isrbd_evaluate,
    isrbd_trial,
)
from srbd_horizon_tpu_torch.kernels.linearize import srbd_linearize
from srbd_horizon_tpu_torch.kernels.lip_linearize import lip_linearize
from srbd_horizon_tpu_torch.kernels.linear_trial import (
    FAMILIES,
    family_index,
    linear_trial,
)
from srbd_horizon_tpu_torch.kernels.lip_rollout import lip_evaluate, lip_trial
from srbd_horizon_tpu_torch.kernels.riccati import RiccatiRows, riccati_backward
from srbd_horizon_tpu_torch.kernels.riccati_associative import (
    riccati_associative,
    shape_instance,
)
from srbd_horizon_tpu_torch.kernels.rollout import srbd_evaluate, srbd_trial
from srbd_horizon_tpu_torch.ocp.spec import OCP

# terms.family -> (linearization wrapper, trial wrapper, evaluation wrapper)
_KERNELS = {
    "srbd": (srbd_linearize, srbd_trial, srbd_evaluate),
    "isrbd_al": (isrbd_linearize, isrbd_trial, isrbd_evaluate),
    "lip": (lip_linearize, lip_trial, lip_evaluate),
}


class DDPSolution(NamedTuple):
    """Solver state/result: X (B, ns+1, nx), U (B, ns, nu), cost (B,),
    converged (B,) bool, iterations (B,) int32, defect_norm (B,) for a
    fleet (`solve_batch`); the same without the leading B for one robot
    (`solve`)."""

    X: torch.Tensor
    U: torch.Tensor
    cost: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor
    defect_norm: torch.Tensor


class _IterState(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    cost: torch.Tensor
    converged: torch.Tensor
    it: torch.Tensor


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(b,) or (K, b) mask -> broadcastable against `like`."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return a.index_select(0, idx)


def _pick(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Entry idx[b] of the leading (K,) axis of `arr` (K, b, …) for each
    member b."""
    ix = idx.reshape((1,) + idx.shape + (1,) * (arr.dim() - 2))
    return arr.gather(0, ix.expand((1,) + arr.shape[1:]))[0]


@dataclasses.dataclass
class MSDDP:
    """Multiple-shooting GN-DDP over a fixed OCP; `solve_batch` is the
    fleet path. `host_syncs` counts the device→host reads it has made.
    `on_phase`, when set, is called with the name of each phase as it
    starts ("cost0", "linearize", "sweep", "trial", "fan", "update",
    "defects", and "glue" for the rest), so a caller can time the phases
    inside a real solve."""

    ocp: OCP
    opts: DDPOptions = DDPOptions()
    host_syncs: int = 0
    on_phase: Optional[Callable[[str], None]] = dataclasses.field(
        default=None, repr=False)
    rows: RiccatiRows = dataclasses.field(init=False, repr=False)
    _wc_by_dtype: dict = dataclasses.field(default_factory=dict, init=False,
                                           repr=False)

    def __post_init__(self):
        check_options(self.opts)
        ocp = self.ocp
        if any(r is None for r in (ocp.residual_x_rows, ocp.residual_u_rows,
                                   ocp.dynamics_x_rows, ocp.dynamics_u_rows)):
            raise NotImplementedError(
                "the port's solver needs the OCP's declared row sparsity "
                "(blocksparse path only)"
            )
        terms = ocp.constants.get("terms")
        if getattr(terms, "family", None) not in _KERNELS:
            raise NotImplementedError(
                "the linearization and trial kernels are written per problem "
                "family: the OCP's constants need a 'terms' object of one of "
                f"{sorted(_KERNELS)} (problems/srbd.py, problems/lip.py, "
                "solvers/alddp.py)"
            )
        self.rows = RiccatiRows.from_ocp(ocp)
        opts = self.opts
        if (opts.riccati_mode, opts.forward_pass) != ("sequential",
                                                       "nonlinear"):
            # K12 and K13 exist at K1's first fourteen shapes (K12 with
            # both gain solves, but Cholesky alone at the AL ones; K13 at
            # every SRBD and LIP topology and step but the two with eight
            # contacts, and both AL inner problems): a problem or gain
            # solve without a kernel — the SRBD and the LIP at nc=8 (K1,
            # K3, K4, K10 and K11 run the square-feet biped, contact_model
            # 4, and the line-feet quadruped, contact_model 2 on four legs;
            # the modes do not yet) or at contact_model 3, block-Schur gains
            # at the AL shapes — is refused on every device, before any
            # launch
            try:
                shape = FAMILIES[family_index(terms, ocp.nx, ocp.nu,
                                              self.rows)][2]
                if opts.riccati_mode == "associative":
                    shape_instance(shape, opts.quu_solver)
            except ValueError as err:
                raise NotImplementedError(
                    f"riccati_mode={opts.riccati_mode!r}, forward_pass="
                    f"{opts.forward_pass!r}, quu_solver={opts.quu_solver!r}: "
                    "K12 and K13 have no kernel for this problem: the SRBD "
                    "and the LIP at contact_model 3 or 4 and at nc=8 (the "
                    "square-feet biped, contact_model=4, and the line-feet "
                    "quadruped, contact_model=2 on four legs: ROADMAP.md "
                    "Queue 2 row 12) and block-Schur gains at the AL shapes "
                    f"have none yet (ROADMAP.md Queue 2): {err}"
                ) from None

    @property
    def terms(self):
        return self.ocp.constants["terms"]

    def _phase(self, name: str) -> None:
        if self.on_phase is not None:
            self.on_phase(name)

    def _host(self, t: torch.Tensor):
        """Read a small device value on the host (one counted sync)."""
        self.host_syncs += 1
        return t.tolist()

    # ---------- cost evaluation ----------

    def _wc(self, dtype) -> float:
        """√constraint_weight, rounded in the working dtype (as the JAX
        package computes it)."""
        if dtype not in self._wc_by_dtype:
            self._wc_by_dtype[dtype] = float(torch.sqrt(torch.tensor(
                self.opts.constraint_weight, dtype=dtype)))
        return self._wc_by_dtype[dtype]

    def _family_args(self, dtype):
        """The terms object's family-specific arguments (√w_c for a
        problem that penalises an equality stack, nothing otherwise)."""
        return self.terms.family_args(self._wc(dtype))

    def _stage_rho(self, x, u, p):
        """Stacked stage residual [residual; √w_c · eq] (the AL inner
        problem has no eq stack of its own)."""
        return self.terms.stage_rho(x, u, p, *self._family_args(x.dtype))

    def total_cost(self, X, U, params):
        """Σ_n ‖ρ_n‖² + ‖ρ_N‖² over leading batch axes of X (…, ns+1, nx)
        (plain PyTorch; `solve_batch` takes `_evaluate`)."""
        return self.terms.total_cost(X, U, params,
                                     *self._family_args(X.dtype))

    def _true_defects(self, X, U, params):
        """step(Xₙ, Uₙ) − Xₙ₊₁ (plain PyTorch; `solve_batch` takes
        `_evaluate`)."""
        ns = self.ocp.ns
        p_stage = {k: v[..., :ns, :] for k, v in params.items()}
        F = self.ocp.step(X[..., :ns, :], U, p_stage, self.ocp.dt)
        return F - X[..., 1:, :]

    def _evaluate(self, X, U, params, x0=None):
        """The cost Σₙ‖ρₙ‖² + ‖ρ_N‖² (B,) of each plan and its largest
        |step(Xₙ, Uₙ) − Xₙ₊₁| (B,), NaN kept, in one launch of the family's
        evaluation kernel (the plain twin for CPU tensors). Given x0 (B, nx;
        its rows may lie apart, as a node of a plan does), node 0 of each
        plan is pinned to it, and the pinned plans come third, from the same
        launch."""
        evaluate = _KERNELS[self.terms.family][2]
        return evaluate(X.contiguous(), U.contiguous(),
                        {k: v.contiguous() for k, v in params.items()},
                        self.terms, self.ocp.dt,
                        *self._family_args(X.dtype), x0=x0)

    # ---------- linearization ----------

    def _linearize_sliced(self, X, U, params):
        """Jacobian rows the blocksparse sweep reads, per member and node
        (K4 or K5, in closed form): Sx = (A − I)[rx] (B,ns,|rx|,nx),
        Bs = B[ru][:, uc] (B,ns,|ru|,|uc|), Jxp = ∂ρ[gx]/∂x,
        Jup = ∂ρ[gu]/∂u, plus ρ (B,ns,nr), rt (B,nt), Jt (B,nt,nx) and the
        defects d (B,ns,nx)."""
        params = {k: v.contiguous() for k, v in params.items()}
        linearize = _KERNELS[self.terms.family][0]
        return linearize(X.contiguous(), U.contiguous(), params,
                         self.terms, self.rows, self.ocp.dt,
                         *self._family_args(X.dtype))

    # ---------- backward sweep and trial (the kernels) ----------

    def _backward_lanemajor(self, lin, mu):
        """Blocksparse Riccati sweep (K1): batch-first lin in, ks (B,ns,nu),
        Ks (B,ns,nu,nx), dV1 (B,), dV2 (B,) out."""
        return riccati_backward(
            lin["Sx"], lin["Bs"], lin["Jxp"], lin["Jup"], lin["rho"],
            lin["d"], lin["Jt"], lin["rt"], mu, self.rows,
        )

    def _backward(self, lin, mu):
        """`_backward` of the JAX package (msddp.py:365): the Tassa-form
        sweep with the gain solve `opts.quu_solver` (K1's Tassa
        instantiations), on the batch-first lin; same outputs as
        `_backward_lanemajor`."""
        return riccati_backward(
            lin["Sx"], lin["Bs"], lin["Jxp"], lin["Jup"], lin["rho"],
            lin["d"], lin["Jt"], lin["rt"], mu, self.rows, form="tassa",
            quu_solver=self.opts.quu_solver,
        )

    def _backward_associative(self, lin, mu):
        """`_backward_associative` of the JAX package (msddp.py:1250): the
        value recursion as an associative scan, then the gains, with the
        gain solve `opts.quu_solver` (K12), on the batch-first lin; same
        outputs as `_backward`."""
        return riccati_associative(
            lin["Sx"], lin["Bs"], lin["Jxp"], lin["Jup"], lin["rho"],
            lin["d"], lin["Jt"], lin["rt"], mu, self.rows,
            quu_solver=self.opts.quu_solver,
        )

    def _trial(self, al, x0, X, U, ks, Ks, d, params, merit0, D, dV1, dV2,
               lin=None):
        """Trial + cost + Armijo test for the α vector `al` (K,), one kernel
        launch: each result has a leading (K,) axis. The rollout (K3, K6 or
        K11), or, given the sliced linearization `lin` (the parallel line
        search passes it under forward_pass="linear"), the linearized
        forward pass with the measured defects (K13)."""
        opts = self.opts
        if lin is not None:
            return linear_trial(
                x0.contiguous(), X.contiguous(), U.contiguous(), ks, Ks,
                lin["Sx"], lin["Bs"], d, al,
                {k: v.contiguous() for k, v in params.items()},
                merit0, D, dV1, dV2, self.terms, self.rows, self.ocp.dt,
                self._wc(X.dtype), opts.defect_weight, opts.beta,
                opts.alpha_converge_threshold)
        trial = _KERNELS[self.terms.family][1]
        return trial(
            x0.contiguous(), X.contiguous(), U.contiguous(), ks, Ks, d, al,
            {k: v.contiguous() for k, v in params.items()},
            merit0, D, dV1, dV2, self.terms, self.ocp.dt,
            *self._family_args(X.dtype), opts.defect_weight, opts.beta, opts.alpha_converge_threshold,
        )

    # ---------- one batched iteration ----------

    def _resolvable(self, dV1, dV2, D, merit0):
        """The merit reduction the model predicts at α₀ and the merit's
        rounding floor: backtracking is worth it only while the reduction
        at the chunk's α stays above the floor."""
        opts = self.opts
        a0, nu_w = opts.alpha_0, opts.defect_weight
        expected0 = -(a0 * dV1 + a0 ** 2 * dV2) + (2.0 * a0 - a0 ** 2) * nu_w * D
        m1 = torch.clamp(merit0, min=1.0)
        noise = torch.maximum(32.0 * torch.finfo(merit0.dtype).eps * m1,
                              opts.cost_reduction_ths * m1)
        return expected0, noise

    def _run_fan(self, alphas, data):
        """Chunked deepening: width-K fans of ever-smaller α until every
        active member has an accepted step, nothing resolvable is left,
        or α passed the max_line_search_steps floor. Seeded by the α₀
        trial; the first chunk always runs (the caller only fans when
        some member needs it)."""
        opts = self.opts
        K = opts.parallel_line_search_width
        f = opts.line_search_decrease_factor
        n_chunks = -(-opts.max_line_search_steps // K)
        (x0b, Xb0, Ub0, ksb, Ksb, db, paramsb, costb0, merit0b, Db,
         dV1b, dV2b, expected0b, noiseb, activeb,
         X1b, U1b, cost1b, merit1b, ok1b) = data

        Xb = torch.where(_bcast(ok1b, X1b), X1b, Xb0)
        Ub = torch.where(_bcast(ok1b, U1b), U1b, Ub0)
        costb = torch.where(ok1b, cost1b, costb0)
        meritb = torch.where(ok1b, merit1b, merit0b)
        found = ok1b
        c = 0
        while True:
            al = alphas * (f ** float(c * K + 1))
            Xs, Us, costs, merits, oks = self._trial(
                al, x0b, Xb0, Ub0, ksb, Ksb, db, paramsb, merit0b, Db,
                dV1b, dV2b)
            pick_idx = torch.argmax(oks.to(torch.int8), dim=0)     # first True
            pick = lambda arr: _pick(arr, pick_idx)
            hit = torch.any(oks, dim=0) & ~found
            Xb = torch.where(_bcast(hit, Xb), pick(Xs), Xb)
            Ub = torch.where(_bcast(hit, Ub), pick(Us), Ub)
            costb = torch.where(hit, pick(costs), costb)
            meritb = torch.where(hit, pick(merits), meritb)
            found = found | hit
            c += 1
            if c >= n_chunks:
                break
            worth = expected0b * (f ** float(c * K)) > noiseb
            if not self._host(torch.any(activeb & ~found & worth)):
                break
        return Xb, Ub, costb, meritb, found

    def _iteration_batch(self, state: _IterState, x0, params,
                         lanes: Optional[int] = None):
        """One DDP iteration for a batch (per-member α selection, masked
        updates). `lanes` is the batch size the JAX path would see for
        this call (the compaction level), which sets the fan-compaction
        threshold; it defaults to the batch size."""
        opts = self.opts
        dtype = state.X.dtype
        Bsz = state.cost.shape[0]
        lanes = Bsz if lanes is None else lanes

        self._phase("linearize")
        lin = self._linearize_sliced(state.X, state.U, params)
        self._phase("sweep")
        ks, Ks, dV1, dV2 = self._backward_lanemajor(lin, opts.mu0)
        d = lin["d"]

        nu_w = opts.defect_weight
        D = torch.sum(d * d, dim=(1, 2))
        merit0 = state.cost + nu_w * D
        K_ls = opts.parallel_line_search_width
        alphas = opts.alpha_0 * (
            opts.line_search_decrease_factor
            ** torch.arange(K_ls, dtype=dtype, device=state.X.device)
        )

        # α₀ alone first: at warm steady state every active member takes it
        self._phase("trial")
        X1, U1, cost1, merit1, ok1 = (
            v[0] for v in self._trial(alphas[:1], x0, state.X, state.U, ks,
                                      Ks, d, params, merit0, D, dV1, dV2)
        )
        self._phase("fan")
        active = ~state.converged
        expected0, noise = self._resolvable(dV1, dV2, D, merit0)
        # only members whose predicted reduction is resolvable above the
        # merit's rounding floor are worth backtracking
        worth0 = expected0 > noise
        need = active & ~ok1 & worth0
        n_need = self._host(torch.sum(need))

        full_data = (
            x0, state.X, state.U, ks, Ks, d, params, state.cost,
            merit0, D, dV1, dV2, expected0, noise, active,
            X1, U1, cost1, merit1, ok1,
        )
        M = opts.line_search_compact
        if n_need == 0:
            Xn, Un, new_cost, new_merit, accepted = X1, U1, cost1, merit1, ok1
        elif 0 < M < lanes and n_need <= M:
            # fan only the members that need it
            idx = torch.argsort((~need).to(torch.int8), stable=True)[:n_need]
            sub = tuple(
                {k: _take(v, idx) for k, v in a.items()} if isinstance(a, dict)
                else _take(a, idx)
                for a in full_data
            )
            Xs, Us, costs, merits, found_s = self._run_fan(alphas, sub)
            Xn = torch.where(_bcast(ok1, X1), X1, state.X).index_copy(0, idx, Xs)
            Un = torch.where(_bcast(ok1, U1), U1, state.U).index_copy(0, idx, Us)
            new_cost = torch.where(ok1, cost1, state.cost).index_copy(0, idx, costs)
            new_merit = torch.where(ok1, merit1, merit0).index_copy(0, idx, merits)
            accepted = ok1.index_copy(0, idx, found_s)
        else:
            Xn, Un, new_cost, new_merit, accepted = self._run_fan(alphas, full_data)

        self._phase("update")
        upd = accepted & active
        merit_red = merit0 - new_merit
        conv_now = (~accepted) | (
            merit_red <= opts.cost_reduction_ths * torch.clamp(merit0, min=1.0)
        )
        out = _IterState(
            X=torch.where(_bcast(upd, Xn), Xn, state.X),
            U=torch.where(_bcast(upd, Un), Un, state.U),
            cost=torch.where(upd, new_cost, state.cost),
            converged=torch.where(active, conv_now, state.converged),
            it=torch.where(active, state.it + 1, state.it),
        )
        self._phase("glue")
        return out

    def compaction_levels(self, Bsz: int):
        """Compacted sub-batch sizes [B/2, B/4, …] (at most
        `opts.active_compact_levels`, none below 32 lanes)."""
        levels = []
        M = Bsz
        for _ in range(self.opts.active_compact_levels):
            M //= 2
            if M >= 32:
                levels.append(M)
        return levels

    def _iteration_compacted(self, state: _IterState, x0, params, n_active: int):
        """Active-set compaction: when the `n_active` still-active members
        fit in a level B/2^l, iterate just those members and scatter the
        results back; otherwise iterate the whole batch."""
        Bsz = state.cost.shape[0]
        fitting = [M for M in self.compaction_levels(Bsz) if n_active <= M]
        if not fitting:
            return self._iteration_batch(state, x0, params)
        idx = torch.argsort(state.converged.to(torch.int8), stable=True)[:n_active]
        sub = _IterState(*(_take(a, idx) for a in state))
        out = self._iteration_batch(
            sub, _take(x0, idx), {k: _take(v, idx) for k, v in params.items()},
            lanes=min(fitting),
        )
        return _IterState(*(base.index_copy(0, idx, new)
                            for base, new in zip(state, out)))

    # ---------- one robot: the JAX package's unbatched iteration ----------

    def _parallel_line_search(self, X, U, cost, x0, params, lin, ks, Ks, dV1,
                              dV2, D, merit0, live=None):
        """`_parallel_line_search` (msddp.py:1494-1578) for each member of
        (B, …) tensors as the JAX package's unbatched solve runs it (B=1,
        or `vmap(solve)`): chunk c is one trial launch of α₀·f^(cK+i),
        i < K, for every member; each member takes the first accepted
        (largest) α of a chunk, and runs the next chunk while it found none
        and the model's reduction at α₀·f^(cK) is resolvable above its
        merit's rounding floor (one counted read a chunk, after each but
        the last). `live` (B,) bool masks the members that search (None:
        all). The trial is the rollout, or under forward_pass="linear" the
        linearized forward pass. Returns the plans, costs and merits taken
        and `found` (B,)."""
        opts = self.opts
        K = opts.parallel_line_search_width
        f = opts.line_search_decrease_factor
        alphas = opts.alpha_0 * (
            f ** torch.arange(K, dtype=X.dtype, device=X.device))
        n_chunks = -(-opts.max_line_search_steps // K)
        expected0, noise = self._resolvable(dV1, dV2, D, merit0)
        linear = lin if opts.forward_pass == "linear" else None
        d = lin["d"]
        Xb, Ub, costb, meritb = X, U, cost, merit0
        run, found = live, None
        c = 0
        while True:
            Xs, Us, costs, merits, oks = self._trial(
                alphas * (f ** float(c * K)), x0, X, U, ks, Ks, d, params,
                merit0, D, dV1, dV2, linear)
            idx = torch.argmax(oks.to(torch.int8), dim=0)     # first True
            pick = lambda arr: _pick(arr, idx)
            hit = torch.any(oks, dim=0)
            if run is not None:
                hit = run & hit
            Xb = torch.where(_bcast(hit, Xb), pick(Xs), Xb)
            Ub = torch.where(_bcast(hit, Ub), pick(Us), Ub)
            costb = torch.where(hit, pick(costs), costb)
            meritb = torch.where(hit, pick(merits), meritb)
            found = hit if found is None else found | hit
            c += 1
            if c >= n_chunks:
                break
            worth = expected0 * (f ** float(c * K)) > noise
            cont = ~found & worth
            if run is not None:
                cont = run & cont
            if not self._host(torch.any(cont)):
                break
            run = cont
        return Xb, Ub, costb, meritb, found

    def _sequential_line_search(self, X, U, cost, x0, params, lin, ks, Ks,
                                dV1, dV2, D, merit0, live=None):
        """The sequential backtracking of `_iteration` (msddp.py:1617-1661)
        for each member: one rollout launch of one α a step, α ← f·α
        (rounded in the plan's dtype, as the JAX package computes it; every
        member still searching is at the same step, so one α serves them
        all) until the member's step is accepted, `max_line_search_steps`
        ran or α fell below `alpha_converge_threshold`; one counted read a
        step. Always the nonlinear rollout, whatever `forward_pass` says,
        as in the JAX package. `live` as in `_parallel_line_search`."""
        opts = self.opts
        dtype = X.dtype
        in_dtype = lambda v: torch.tensor(v, dtype=dtype)
        alpha = in_dtype(opts.alpha_0)
        found = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
        run = live
        Xb, Ub, costb, meritb = X, U, cost, merit0
        for _ in range(opts.max_line_search_steps):
            if not bool(alpha >= opts.alpha_converge_threshold):
                break
            Xs, Us, costs, merits, oks = self._trial(
                alpha.reshape(1).to(X.device), x0, X, U, ks, Ks, lin["d"],
                params, merit0, D, dV1, dV2)
            hit = oks[0] if run is None else run & oks[0]
            found = found | hit
            Xb = torch.where(_bcast(hit, Xb), Xs[0], Xb)
            Ub = torch.where(_bcast(hit, Ub), Us[0], Ub)
            costb = torch.where(hit, costs[0], costb)
            meritb = torch.where(hit, merits[0], meritb)
            run = ~found if run is None else run & ~hit
            if not self._host(torch.any(run)):
                break
            alpha = alpha * opts.line_search_decrease_factor
        return Xb, Ub, costb, meritb, found

    def _iteration(self, X, U, cost, x0, params, live=None):
        """One iteration of the JAX package's unbatched `_iteration`
        (msddp.py:1580-1673) for each member of (B, …) tensors: the sliced
        linearization (K4, K5 or K10), the sweep of `riccati_mode` (K1's
        Tassa form or K12), the line search of `line_search_mode`, the
        update. `live` (B,) bool masks the members whose line search runs
        (None: all). Returns X, U, cost, converged."""
        opts = self.opts
        self._phase("linearize")
        lin = self._linearize_sliced(X, U, params)
        self._phase("sweep")
        if opts.riccati_mode == "associative":
            ks, Ks, dV1, dV2 = self._backward_associative(lin, opts.mu0)
        else:
            ks, Ks, dV1, dV2 = self._backward(lin, opts.mu0)
        d = lin["d"]
        D = torch.sum(d * d, dim=(1, 2))
        merit0 = cost + opts.defect_weight * D
        self._phase("trial")
        search = (self._parallel_line_search
                  if opts.line_search_mode == "parallel"
                  else self._sequential_line_search)
        Xn, Un, new_cost, new_merit, accepted = search(
            X, U, cost, x0, params, lin, ks, Ks, dV1, dV2, D, merit0, live)
        self._phase("update")
        converged = (~accepted) | (
            merit0 - new_merit
            <= opts.cost_reduction_ths * torch.clamp(merit0, min=1.0))
        out = (torch.where(_bcast(accepted, Xn), Xn, X),
               torch.where(_bcast(accepted, Un), Un, U),
               torch.where(accepted, new_cost, cost), converged)
        self._phase("glue")
        return out

    def _solve_members(self, sols: DDPSolution, x0, params) -> DDPSolution:
        """`solve_batch` under a non-default `riccati_mode` or `forward_pass`:
        the JAX package's `jax.vmap(self.solve)` (msddp.py:1213-1216). Each
        member runs `solve`'s iteration — the sweep with `quu_solver`, the
        line search of `line_search_mode` on the unbatched chunk grid, no
        active-set or fan compaction — batched over the members, and its
        state freezes once it converged or ran `max_iters` iterations (one
        counted read an iteration, of whether any member still runs)."""
        opts = self.opts
        self._phase("cost0")
        cost, _, X = self._evaluate(sols.X, sols.U, params, x0=x0)
        U = sols.U
        Bsz = cost.shape[0]
        converged = torch.zeros(Bsz, dtype=torch.bool, device=X.device)
        it = torch.zeros(Bsz, dtype=torch.int32, device=X.device)
        self._phase("glue")
        while True:
            run = ~converged & (it < opts.max_iters)
            if not self._host(torch.any(run)):
                break
            Xn, Un, cn, conv = self._iteration(X, U, cost, x0, params, live=run)
            X = torch.where(_bcast(run, X), Xn, X)
            U = torch.where(_bcast(run, U), Un, U)
            cost = torch.where(run, cn, cost)
            converged = torch.where(run, conv, converged)
            it = it + run.to(torch.int32)
        self._phase("defects")
        _, defect_norm = self._evaluate(X, U, params)
        self._phase("glue")
        return DDPSolution(X=X, U=U, cost=cost, converged=converged,
                           iterations=it, defect_norm=defect_norm)

    # ---------- public API ----------

    def init(self, x0, U0: Optional[torch.Tensor] = None) -> DDPSolution:
        """Cold start for x0 (B, nx), or (nx,) for one robot: X = x0 on
        every node, U = 0 (or U0)."""
        ns, nu = self.ocp.ns, self.ocp.nu
        lead = x0.shape[:-1]
        U = (torch.zeros(lead + (ns, nu), dtype=x0.dtype, device=x0.device)
             if U0 is None else U0)
        X = x0[..., None, :].expand(lead + (ns + 1, x0.shape[-1])).clone()
        z = torch.zeros(lead, dtype=x0.dtype, device=x0.device)
        return DDPSolution(
            X=X, U=U, cost=z, converged=torch.zeros(lead, dtype=torch.bool,
                                                    device=x0.device),
            iterations=torch.zeros(lead, dtype=torch.int32, device=x0.device),
            defect_norm=z.clone(),
        )

    def solve_batch(self, sols: DDPSolution, x0, params) -> DDPSolution:
        """Batched MS-DDP solve over a leading fleet axis: per-member α
        selection and masked convergence, the same semantics as the JAX
        package's `solve_batch` (under a non-default `riccati_mode` or
        `forward_pass`, its `vmap(solve)`: `_solve_members`)."""
        opts = self.opts
        if (opts.riccati_mode, opts.forward_pass) != ("sequential", "nonlinear"):
            return self._solve_members(sols, x0, params)
        self._phase("cost0")
        # node 0 is pinned to the measured state: a stale warm start's x0
        # gap becomes the node-0 defect (the evaluation writes the pinned
        # plan, a new tensor)
        cost0, _, X = self._evaluate(sols.X, sols.U, params, x0=x0)
        Bsz = cost0.shape[0]
        state = _IterState(
            X=X, U=sols.U, cost=cost0,
            converged=torch.zeros(Bsz, dtype=torch.bool, device=X.device),
            it=torch.zeros(Bsz, dtype=torch.int32, device=X.device),
        )
        self._phase("glue")
        while True:
            active = ~state.converged
            n_cont, n_active = self._host(torch.stack([
                torch.sum(active & (state.it < opts.max_iters)),
                torch.sum(active),
            ]))
            if n_cont == 0:
                break
            if opts.active_compact_levels > 0:
                state = self._iteration_compacted(state, x0, params, n_active)
            else:
                state = self._iteration_batch(state, x0, params)

        self._phase("defects")
        _, defect_norm = self._evaluate(state.X, state.U, params)
        self._phase("glue")
        return DDPSolution(
            X=state.X, U=state.U, cost=state.cost,
            converged=state.converged, iterations=state.it,
            defect_norm=defect_norm,
        )

    def solve(self, sol: DDPSolution, x0, params) -> DDPSolution:
        """One full MS-DDP solve for one robot — the JAX package's `solve`
        (msddp.py:1689-1739): X (ns+1, nx), U (ns, nu), x0 (nx,), params
        leaves (ns+1, dim), run as B=1 views on the kernels. Node 0 is
        pinned to x0 and the starting cost evaluated in one launch; then
        iterations while unconverged and under `max_iters` (one counted
        read of the convergence flag after each but the last allowed); the
        final largest |defect| from one more launch."""
        opts = self.opts
        p1 = {k: v[None] for k, v in params.items()}
        x0b = x0[None]
        self._phase("cost0")
        cost, _, X = self._evaluate(sol.X[None], sol.U[None], p1, x0=x0b)
        U = sol.U[None]
        converged = torch.zeros(1, dtype=torch.bool, device=X.device)
        self._phase("glue")
        it = 0
        while it < opts.max_iters:
            X, U, cost, converged = self._iteration(X, U, cost, x0b, p1)
            it += 1
            if it >= opts.max_iters or self._host(converged[0]):
                break
        self._phase("defects")
        _, defect_norm = self._evaluate(X, U, p1)
        self._phase("glue")
        return DDPSolution(
            X=X[0], U=U[0], cost=cost[0], converged=converged[0],
            iterations=torch.tensor(it, dtype=torch.int32, device=X.device),
            defect_norm=defect_norm[0],
        )

    def solution_dict(self, sol: DDPSolution) -> Dict[str, Any]:
        """Named solution blocks (`solution_dict`, msddp.py:1741-1748):
        x_opt and u_opt, and each state and input block by its layout name,
        time-major ((…, ns+1, dim) and (…, ns, dim))."""
        out: Dict[str, Any] = dict(x_opt=sol.X, u_opt=sol.U)
        out.update(self.ocp.state_layout.unpack(sol.X))
        out.update(self.ocp.input_layout.unpack(sol.U))
        return out
