"""Fixed-step integrators as step-function factories (the port of
srbd_horizon_tpu/ocp/integrators.py): Euler, RK2 (explicit midpoint) and
the classic RK4. The SRBD problem takes any of the three
(`build_srbd_problem(..., integrator=)`, by `BY_NAME`); the isrbd shooting
transcription takes RK2."""

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


def rk4(xdot_fn):
    """Classic RK4: x⁺ = x + dt/6 (k1 + 2k2 + 2k3 + k4)."""

    def step(x, u, p, dt):
        k1 = xdot_fn(x, u, p)
        k2 = xdot_fn(x + 0.5 * dt * k1, u, p)
        k3 = xdot_fn(x + 0.5 * dt * k2, u, p)
        k4 = xdot_fn(x + dt * k3, u, p)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    return step


BY_NAME = {"EULER": euler, "RK2": rk2, "RK4": rk4}
