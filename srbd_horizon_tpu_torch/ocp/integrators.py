"""Fixed-step integrators as step-function factories (the port of
srbd_horizon_tpu/ocp/integrators.py): Euler for the SRBD DDP path, RK2
(explicit midpoint) for the isrbd shooting transcription."""

from __future__ import annotations


def euler(xdot_fn):
    """x⁺ = x + dt ẋ(x, u)."""

    def step(x, u, p, dt):
        return x + dt * xdot_fn(x, u, p)

    return step


def rk2(xdot_fn):
    """Explicit midpoint: k1 = ẋ(x, u); x⁺ = x + dt ẋ(x + dt/2 k1, u)."""

    def step(x, u, p, dt):
        k1 = xdot_fn(x, u, p)
        return x + dt * xdot_fn(x + 0.5 * dt * k1, u, p)

    return step
