"""Fixed-step integrators as step-function factories (the port of the
Euler step of srbd_horizon_tpu/ocp/integrators.py — the only one the DDP
path uses)."""

from __future__ import annotations


def euler(xdot_fn):
    """x⁺ = x + dt ẋ(x, u)."""

    def step(x, u, p, dt):
        return x + dt * xdot_fn(x, u, p)

    return step
