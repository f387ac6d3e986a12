"""The OCP container (the port of srbd_horizon_tpu/ocp/spec.py).

An OCP is a handful of plain tensor functions plus static metadata:

  - `params` is a dict name -> (ns+1, dim) tensor (or (B, ns+1, dim) for a
    fleet). The solver slices node n and passes the per-node dict `p` to
    every stage callable.
  - `stage_residual(x, u, p)`, `terminal_residual(x, p)`, `stage_eq(x, u, p)`
    return stacked residual vectors; all of them broadcast over leading
    batch axes and are traceable by `torch.func`.
  - `step(x, u, p, dt)` is the discrete (Euler) dynamics.
  - The row sets declare the Jacobian sparsity the blocksparse Riccati
    sweep relies on: `residual_x_rows`/`residual_u_rows` over the stacked
    rows [stage_residual; stage_eq], and `dynamics_x_rows`/
    `dynamics_u_rows` where (A − I) and B can be nonzero.
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

    residual_x_rows: Optional[Any] = None
    residual_u_rows: Optional[Any] = None
    dynamics_x_rows: Optional[Any] = None
    dynamics_u_rows: Optional[Any] = None
    # input columns the dynamics consume; None = every column (the port's
    # kernels do not take column-sparse B yet)
    dynamics_u_cols: Optional[Any] = None

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


def node_mask(ns: int, start: int, stop: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """(ns+1,) 0/1 mask for `nodes=range(start, stop)` activation sets."""
    idx = torch.arange(ns + 1, device=device)
    return ((idx >= start) & (idx < stop)).to(dtype)
