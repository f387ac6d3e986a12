"""Solver option presets — the port of srbd_horizon_tpu/solvers/options.py:
factory functions with the reference's names and roles, returning the
port's option objects. The presets are data; which of them a ported path
can run is decided where the options are used (`config.check_options`)."""

from __future__ import annotations

from typing import Tuple

from srbd_horizon_tpu_torch.config import DDPOptions
from srbd_horizon_tpu_torch.solvers.alddp import ALOptions


def ddp_example_options() -> DDPOptions:
    """The option set the closed-loop examples pass to the DDP solver."""
    return DDPOptions(
        max_iters=100, alpha_converge_threshold=1e-12, beta=1e-3
    )


def ddp_online_options(max_iters: int = 5) -> DDPOptions:
    """Online per-tick budget (the reference caps online iterations at 5)."""
    return DDPOptions(
        max_iters=max_iters, alpha_converge_threshold=1e-12, beta=1e-3
    )


def ipopt_offline_solver_options() -> Tuple[DDPOptions, ALOptions]:
    """Offline full-NLP solve to tight feasibility: generous inner
    iterations, full AL outer schedule."""
    return (
        DDPOptions(max_iters=30, alpha_converge_threshold=1e-12, beta=1e-3),
        ALOptions(outer_iters=8, rho0=1e3, tol=1e-6),
    )


def ipopt_online_solver_options(max_iteration: int = 5) -> Tuple[DDPOptions, ALOptions]:
    """Online constrained MPC budget."""
    return (
        DDPOptions(
            max_iters=max_iteration, alpha_converge_threshold=1e-12, beta=1e-3
        ),
        ALOptions(outer_iters=1, rho0=1e3),
    )


def sqp_offline_solver_options(ns: int = 20) -> Tuple[DDPOptions, ALOptions]:
    """Gauss-Newton SQP offline variant."""
    del ns
    return (
        DDPOptions(max_iters=20, beta=1e-4),
        ALOptions(outer_iters=6, rho0=1e3),
    )


def sqp_online_solver_options(max_iterations: int = 1) -> Tuple[DDPOptions, ALOptions]:
    """Single-iteration online SQP."""
    return (
        DDPOptions(max_iters=max_iterations, beta=1e-4),
        ALOptions(outer_iters=1, rho0=1e3),
    )


def al_serving_options(max_iters: int = 15) -> Tuple[DDPOptions, ALOptions]:
    """float32 serving configuration for the constrained (AL) path: with
    the equality stack in scaled units (`OCP.eq_scale`) the AL schedule
    converges at ρ ≤ 1e5, where float32 storage with the Riccati kernel's
    float64 arithmetic holds the walking-MPC violation trace."""
    return (
        DDPOptions(
            max_iters=max_iters, alpha_converge_threshold=1e-12, beta=1e-3
        ),
        ALOptions(outer_iters=6, rho0=1e3, rho_max=1e5, tol=1e-5),
    )
