"""The OCP container (the port of srbd_horizon_tpu/ocp/spec.py).

An OCP is a handful of plain tensor functions plus static metadata:

  - `params` is a dict name -> (ns+1, dim) tensor (or (B, ns+1, dim) for a
    fleet). The solver slices node n and passes the per-node dict `p` to
    every stage callable.
  - `stage_residual(x, u, p)`, `terminal_residual(x, p)`, `stage_eq(x, u, p)`
    return stacked residual vectors; all of them broadcast over leading
    batch axes and are traceable by `torch.func`.
  - `stage_ineq(x, u, p)` returns g(x, u, p) with the static bounds
    `ineq_lb`/`ineq_ub`; `x_lb/x_ub` ((ns+1, nx)) and `u_lb/u_ub`
    ((ns, nu)) are node-indexed variable boxes, ±inf where unbounded. The
    AL solver (solvers/alddp.py) enforces both as one-sided
    augmented-Lagrangian rows; `eq_scale(_T)` and `eq_rho_weight(_T)`
    are its per-row unit scaling and penalty stiffness of the equality
    stacks.
  - `step(x, u, p, dt)` is the discrete dynamics (Euler, RK2 or RK4 for
    SRBD, `build_srbd_problem(integrator=)`; RK2 for isrbd).
  - The row sets declare the Jacobian sparsity the blocksparse Riccati
    sweep relies on: `residual_x_rows`/`residual_u_rows` over the stacked
    rows [stage_residual; stage_eq], and `dynamics_x_rows`/
    `dynamics_u_rows` where (A − I) and B can be nonzero,
    `dynamics_u_cols` the input columns the step consumes, and
    `ineq_x_rows`/`ineq_u_rows` the same for the inequality stack.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from srbd_horizon_tpu_torch.ocp.layout import VarLayout


@dataclasses.dataclass(frozen=True)
class OCP:
    """A discrete-time optimal control problem over ns+1 nodes."""

    ns: int
    dt: float
    state_layout: VarLayout
    input_layout: VarLayout

    step: Callable[..., torch.Tensor]
    xdot: Callable[..., torch.Tensor]

    stage_residual: Callable[..., torch.Tensor]
    terminal_residual: Callable[..., torch.Tensor]
    stage_eq: Callable[..., torch.Tensor]
    terminal_eq: Callable[..., torch.Tensor]
    stage_ineq: Optional[Callable[..., torch.Tensor]] = None
    ineq_lb: Optional[torch.Tensor] = None
    ineq_ub: Optional[torch.Tensor] = None

    # per-row scaling and AL penalty stiffness of the equality stacks
    eq_scale: Optional[torch.Tensor] = None
    eq_scale_T: Optional[torch.Tensor] = None
    eq_rho_weight: Optional[torch.Tensor] = None
    eq_rho_weight_T: Optional[torch.Tensor] = None

    # node-indexed variable boxes: x (ns+1, nx), u (ns, nu); None = unbounded
    x_lb: Optional[torch.Tensor] = None
    x_ub: Optional[torch.Tensor] = None
    u_lb: Optional[torch.Tensor] = None
    u_ub: Optional[torch.Tensor] = None

    residual_x_rows: Optional[Any] = None
    residual_u_rows: Optional[Any] = None
    dynamics_x_rows: Optional[Any] = None
    dynamics_u_rows: Optional[Any] = None
    # input columns the dynamics consume (live columns of B); None = all
    dynamics_u_cols: Optional[Any] = None
    # stage_ineq rows with any x- (resp. u-) dependence; None = all rows
    ineq_x_rows: Optional[Any] = None
    ineq_u_rows: Optional[Any] = None

    params: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    constants: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def nx(self) -> int:
        return self.state_layout.total

    @property
    def nu(self) -> int:
        return self.input_layout.total

    def params_at(self, params: Dict[str, torch.Tensor], n) -> Dict[str, torch.Tensor]:
        """Node n of every parameter tensor (node axis is -2, so this works
        for a single problem and for a fleet alike)."""
        return {k: v[..., n, :] for k, v in params.items()}


def unbounded(nodes: int, dim: int, dtype=torch.float32, device=None):
    """(−inf, +inf) box-bound pair of shape (nodes, dim): the canvas for
    `x_lb/x_ub` and `u_lb/u_ub`."""
    lb = torch.full((nodes, dim), -float("inf"), dtype=dtype, device=device)
    return lb, -lb


def node_mask(ns: int, start: int, stop: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """(ns+1,) 0/1 mask for `nodes=range(start, stop)` activation sets."""
    idx = torch.arange(ns + 1, device=device)
    return ((idx >= start) & (idx < stop)).to(dtype)
