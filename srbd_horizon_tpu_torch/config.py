"""Typed configuration: the port's own copy of `SRBDConfig` and
`DDPOptions` (srbd_horizon_tpu/config.py), with `dtype` a torch dtype.

Only fields the port reads are carried: a field of the JAX dataclasses
that nothing here reads (the example rate `hz`, the `lax.scan` unroll
factors) is absent, so setting it raises `TypeError`; it comes back with
the code that reads it (`zmp_tracking_gain` came back with the LIP
problem, problems/lip.py). Of the options
kept, `MSDDP` rejects at construction those whose path is not ported
(see `check_options`).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SRBDConfig:
    """Static configuration of the SRBD, isrbd and LIP MPC problems (defaults =
    the reference's launch parameters, as in the JAX package)."""

    # horizon
    ns: int = 20
    T: float = 1.0

    # contact topology: nc = number_of_legs * contact_model
    contact_model: int = 2
    number_of_legs: int = 2

    # cost gains
    r_tracking_gain: float = 1e3
    rdot_tracking_gain: float = 1e4
    w_tracking_gain: float = 1e4
    rel_position_gain: float = 1e4
    force_switch_weight: float = 1e2
    min_qddot_gain: float = 1e0
    min_f_gain: float = 1e-2
    zmp_tracking_gain: float = 1e3
    rz_tracking_gain_isrbd: float = 2e3

    # physics
    friction_cone_coefficient: float = 0.8
    force_scaling: float = 1000.0
    gravity: float = 9.81
    lip_height: float = 0.88

    # variable boxes of the constrained (isrbd) problem
    max_contact_force: float = 1000.0
    max_contact_velocity: float = 10.0

    # numerics
    dtype: torch.dtype = torch.float32

    @property
    def nc(self) -> int:
        return self.number_of_legs * self.contact_model

    @property
    def dt(self) -> float:
        return self.T / self.ns

    @property
    def eta2(self) -> float:
        """LIP natural frequency squared."""
        return self.gravity / self.lip_height


@dataclasses.dataclass(frozen=True)
class DDPOptions:
    """MS-DDP solver options. Field meanings are those of the JAX
    package's `DDPOptions`; the A/B knobs it kept as measured-and-rejected
    experiments exist here only so that setting one raises."""

    max_iters: int = 100
    alpha_0: float = 1.0
    alpha_converge_threshold: float = 1e-12
    line_search_decrease_factor: float = 0.5
    beta: float = 1e-3
    cost_reduction_ths: float = 1e-9
    mu0: float = 1e-6
    constraint_weight: float = 1e6
    max_line_search_steps: int = 40
    # "parallel" (width-K fans of α) or "sequential" (one α a step);
    # read by `MSDDP.solve` (and by `solve_batch` under a non-default
    # riccati_mode or forward_pass, which runs `solve` member by member):
    # the default `solve_batch` always fans, as the JAX package's
    # `_iteration_batch` does
    line_search_mode: str = "parallel"
    parallel_line_search_width: int = 4
    line_search_compact: int = 64
    # gain solve of `MSDDP.solve`'s sweep (Tassa form or associative scan):
    # "schur" (the block-Schur inverse) or "cholesky"; the default
    # `solve_batch`'s collapsed sweep always takes the block-Schur inverse,
    # as the JAX package's does
    quu_solver: str = "schur"
    # "sequential" (K1's Tassa-form sweep) or "associative" (K12's scan);
    # with forward_pass "nonlinear" (the rollout, K3/K6/K11) or "linear"
    # (the linearized forward pass of the parallel line search, K13). Both
    # modes run at K1's five shapes: the SRBD problem of the Kangaroo and of
    # the point-feet quadruped, the LIP, and the AL inner problem of both
    # robots' isrbd problems (there K12 takes the Cholesky gain solve, which
    # the AL solver always asks for); the solver refuses them elsewhere
    riccati_mode: str = "sequential"
    backward_contract: str = "blocksparse"
    backward_pair_nodes: bool = False
    analytic_jacobians: bool = False
    gram_row_pruning: bool = False
    linearize_sliced: bool = True
    linearize_lane_out: bool = False
    linearize_fused_backward: bool = False
    linearize_precision: str = "f32"
    linearize_ad: str = "fwd"
    active_compact_levels: int = 4
    rollout_lane_major: bool = False
    forward_pass: str = "nonlinear"
    defect_weight: float = 1e5


# knob -> the only value the port accepts (the JAX package measured the
# others on its TPU and rejected them; reopen one only as an H100 A/B)
_REJECTED_KNOBS = {
    "backward_pair_nodes": False,
    "linearize_fused_backward": False,
    "linearize_lane_out": False,
    "rollout_lane_major": False,
    "gram_row_pruning": False,
    "linearize_precision": "f32",
    "linearize_ad": "fwd",
}


def check_options(opts: DDPOptions) -> None:
    """Raise on any option the port's production path does not run."""
    if opts.riccati_mode not in ("sequential", "associative"):
        raise ValueError(
            f"riccati_mode={opts.riccati_mode!r}: 'sequential' or "
            "'associative'"
        )
    if opts.forward_pass not in ("nonlinear", "linear"):
        raise ValueError(
            f"forward_pass={opts.forward_pass!r}: 'nonlinear' or 'linear'"
        )
    if opts.analytic_jacobians:
        raise NotImplementedError(
            "analytic_jacobians=True selects the JAX package's dense "
            "linearization path, which the port does not have: the port's "
            "sliced linearization is already the closed form (kernel K4)"
        )
    for name, allowed in _REJECTED_KNOBS.items():
        if getattr(opts, name) != allowed:
            raise ValueError(
                f"{name}={getattr(opts, name)!r} is a rejected A/B knob; the "
                f"port runs only {allowed!r}"
            )
    if opts.backward_contract != "blocksparse":
        raise ValueError(
            f"backward_contract={opts.backward_contract!r} is a rejected A/B "
            "knob; the port runs only 'blocksparse'"
        )
    if not opts.linearize_sliced:
        raise NotImplementedError(
            "linearize_sliced=False: only the sliced linearization is ported"
        )
    if opts.line_search_mode not in ("parallel", "sequential"):
        raise ValueError(
            f"line_search_mode={opts.line_search_mode!r}: 'parallel' or "
            "'sequential'"
        )
    if opts.quu_solver not in ("schur", "cholesky"):
        raise ValueError(
            f"quu_solver={opts.quu_solver!r}: 'schur' or 'cholesky'"
        )


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. "cuda" (the default everywhere)
    requires a CUDA device; the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "srbd_horizon_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run the plain PyTorch "
            "path on the CPU"
        )
    return dev
