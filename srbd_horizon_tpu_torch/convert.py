"""Carry state across from the JAX package: numpy arrays in, the port's
tensors out, on a given device and dtype.

The caller turns JAX arrays into numpy (`np.asarray`) on its own side,
so nothing here knows of JAX. Floating leaves take `dtype`; integer and
boolean leaves keep their kind (int32 counters, bool flags). Every
function takes a fleet's state (a leading B axis, for `tick_batch` and
the batched solves) or one robot's as the JAX package's unbatched entry
points hold it (for `tick`, `MSDDP.solve`, `ALDDP.solve` and
`solve_online`): shapes pass through as they are. The execution modes
(`riccati_mode="associative"`, `forward_pass="linear"`) carry no state of
their own: a solve under them reads and writes the same `DDPSolution`
and `LoopCarry`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from srbd_horizon_tpu_torch.config import resolve_device
from srbd_horizon_tpu_torch.runtime.loop import LoopCarry, TickInput
from srbd_horizon_tpu_torch.solvers.alddp import (
    ALState,
    FullPhasePrior,
    PhasePrior,
)
from srbd_horizon_tpu_torch.solvers.msddp import DDPSolution
from srbd_horizon_tpu_torch.wpg import WPGState


def to_tensor(a, *, device, dtype) -> torch.Tensor:
    """One array: floats to `dtype`, ints to int32, bools stay bool."""
    arr = np.array(a)                      # a writable copy
    if arr.dtype == np.bool_:
        return torch.as_tensor(arr, device=device)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.as_tensor(arr.astype(np.int32), device=device)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def params_from_numpy(params: Mapping[str, np.ndarray], *, device="cuda",
                      dtype=torch.float32) -> dict:
    """OCP params: name -> (ns+1, dim) or (B, ns+1, dim)."""
    dev = resolve_device(device)
    return {k: to_tensor(v, device=dev, dtype=dtype) for k, v in params.items()}


def tick_input_from_numpy(action, rdot_ref, w_ref, *, device="cuda",
                          dtype=torch.float32) -> TickInput:
    dev = resolve_device(device)
    return TickInput(
        action=to_tensor(action, device=dev, dtype=dtype),
        rdot_ref=to_tensor(rdot_ref, device=dev, dtype=dtype),
        w_ref=to_tensor(w_ref, device=dev, dtype=dtype),
    )


def solution_from_numpy(sol: Mapping[str, np.ndarray], *, device="cuda",
                        dtype=torch.float32) -> DDPSolution:
    """A DDPSolution from its fields by name (X, U, cost, converged,
    iterations, defect_norm), batch-first or one robot's (0-d cost,
    flag and count)."""
    dev = resolve_device(device)
    return DDPSolution(**{f: to_tensor(sol[f], device=dev, dtype=dtype)
                          for f in DDPSolution._fields})


def al_state_from_numpy(state: Mapping[str, np.ndarray], *, device="cuda",
                        dtype=torch.float32) -> ALState:
    """An ALState from its fields by name; `sol` is itself the mapping
    `solution_from_numpy` takes. A fleet's leaves lead with the fleet axis
    (rho and viol (B,)); one robot's have none (rho and viol 0-d)."""
    dev = resolve_device(device)
    rest = {f: to_tensor(state[f], device=dev, dtype=dtype)
            for f in ALState._fields if f != "sol"}
    return ALState(sol=solution_from_numpy(state["sol"], device=dev,
                                           dtype=dtype), **rest)


def phase_prior_from_numpy(prior: Mapping[str, np.ndarray], *, device="cuda",
                           dtype=torch.float32):
    """A `FullPhasePrior` (fields lam_eq, lam_eq_T, seen) or a tail
    `PhasePrior` (lam_tail, lam_T, seen_tail, seen_T) from its fields by
    name, with the fleet axis leading."""
    dev = resolve_device(device)
    cls = FullPhasePrior if "lam_eq" in prior else PhasePrior
    return cls(**{f: to_tensor(prior[f], device=dev, dtype=dtype)
                  for f in cls._fields})


def carry_from_numpy(x, sol: Mapping[str, np.ndarray], params,
                     step_counter, *, device="cuda",
                     dtype=torch.float32) -> LoopCarry:
    """A LoopCarry from the state x, the DDPSolution fields by name (X, U,
    cost, converged, iterations, defect_norm), the params and the WPG step
    counter: a fleet's (x (B, nx), counter (B,)) or one robot's (x (nx,),
    counter 0-d, params (ns+1, dim))."""
    dev = resolve_device(device)
    return LoopCarry(
        x=to_tensor(x, device=dev, dtype=dtype),
        sol=solution_from_numpy(sol, device=dev, dtype=dtype),
        params=params_from_numpy(params, device=dev, dtype=dtype),
        wpg_state=WPGState(step_counter=to_tensor(step_counter, device=dev,
                                                  dtype=dtype)),
    )
