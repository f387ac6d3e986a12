"""PyTorch port, isolation: no file of `srbd_horizon_tpu_torch/` nor
`chip_smoke.py` imports JAX or the JAX package, no module of the package
uses `torch.func` (the linearization is the closed-form K4), and the
entry points run on CUDA unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from srbd_horizon_tpu_torch.config import SRBDConfig, resolve_device
from srbd_horizon_tpu_torch.convert import al_state_from_numpy, params_from_numpy
from srbd_horizon_tpu_torch.models.kangaroo import kangaroo_line_feet
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem
from srbd_horizon_tpu_torch.problems.srbd import build_srbd_problem
from srbd_horizon_tpu_torch.runtime.loop import (
    build_quadruped_loop,
    build_srbd_loop,
    standing_schedule,
    walk_command,
    walking_schedule,
)
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE_FILES = sorted((ROOT / "srbd_horizon_tpu_torch").rglob("*.py"))
PORT_FILES = PACKAGE_FILES + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "srbd_horizon_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def _uses_torch_func(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and node.attr == "func"
                and isinstance(node.value, ast.Name) and node.value.id == "torch"):
            return True
    return any(m.split(".")[:2] == ["torch", "func"] or m.startswith("functorch")
               for m in _imported_modules(path))


@pytest.mark.parametrize("path", PACKAGE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_uses_no_torch_func(path):
    assert not _uses_torch_func(path), f"{path.name} uses torch.func"


def test_port_package_is_complete():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for required in (
        "srbd_horizon_tpu_torch/kernels/riccati.py",
        "srbd_horizon_tpu_torch/kernels/rollout.py",
        "srbd_horizon_tpu_torch/kernels/linearize.py",
        "srbd_horizon_tpu_torch/kernels/build.py",
        "srbd_horizon_tpu_torch/kernels/isrbd_linearize.py",
        "srbd_horizon_tpu_torch/kernels/isrbd_rollout.py",
        "srbd_horizon_tpu_torch/solvers/msddp.py",
        "srbd_horizon_tpu_torch/solvers/alddp.py",
        "srbd_horizon_tpu_torch/problems/isrbd.py",
        "srbd_horizon_tpu_torch/runtime/loop.py",
        "srbd_horizon_tpu_torch/runtime/serving.py",
        "srbd_horizon_tpu_torch/math/linalg.py",
        "srbd_horizon_tpu_torch/convert.py",
        "srbd_horizon_tpu_torch/models/quadruped.py",
        "srbd_horizon_tpu_torch/models/urdf.py",
    ):
        assert required in names
    for asset in ("kangaroo_like.urdf", "quadruped_like.urdf"):
        assert (ROOT / "srbd_horizon_tpu_torch" / "assets" / asset).exists()
    for src in ("riccati_backward.cu", "srbd_rollout.cu", "srbd_linearize.cu",
                "srbd_common.cuh", "isrbd_rollout.cu", "isrbd_linearize.cu",
                "isrbd_common.cuh", "rigid_common.cuh", "dmma.cuh"):
        assert (ROOT / "srbd_horizon_tpu_torch" / "csrc" / src).exists()


@pytest.fixture
def no_cuda(monkeypatch):
    """Behave as a machine without a CUDA device, wherever the test runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    "build_srbd_loop", "build_srbd_problem", "wpg_build", "walk_command",
    "params_from_numpy", "build_isrbd_problem", "al_state_from_numpy",
    "walking_schedule", "standing_schedule", "build_quadruped_loop",
])
def test_entry_points_default_to_cuda(no_cuda, entry):
    call = {
        "build_srbd_loop": lambda: build_srbd_loop(),
        "build_srbd_problem": lambda: build_srbd_problem(
            SRBDConfig(), kangaroo_line_feet()),
        "wpg_build": lambda: WalkingPatternGenerator.build(0.0, 20),
        "walk_command": lambda: walk_command(4),
        "params_from_numpy": lambda: params_from_numpy({}),
        "build_isrbd_problem": lambda: build_isrbd_problem(
            SRBDConfig(), kangaroo_line_feet()),
        "al_state_from_numpy": lambda: al_state_from_numpy({}),
        "walking_schedule": lambda: walking_schedule(40),
        "standing_schedule": lambda: standing_schedule(40),
        "build_quadruped_loop": lambda: build_quadruped_loop(),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_cpu_is_used_only_when_asked(no_cuda):
    assert resolve_device("cpu").type == "cpu"
    loop, prob = build_srbd_loop(device="cpu")
    assert prob.initial_state.device.type == "cpu"
    assert prob.initial_state.dtype == torch.float32


@pytest.mark.parametrize("make", ["init_phase_prior", "init_full_phase_prior"])
def test_prior_tables_live_where_the_solver_does(no_cuda, make):
    """The gait-phase priors take no device or dtype of their own: they
    are made where the problem's tensors are, so a fleet on the card gets
    its tables on the card."""
    from srbd_horizon_tpu_torch.solvers.alddp import ALDDP
    from srbd_horizon_tpu_torch.solvers.options import al_serving_options

    prob = build_isrbd_problem(SRBDConfig(dtype=torch.float64),
                               kangaroo_line_feet(), device="cpu")
    solver = ALDDP(prob.ocp, *al_serving_options(1))
    prior = getattr(solver, make)(4, 3)
    state = solver.init(prob.initial_state.expand(3, -1))
    for table in prior:
        assert table.device == state.lam_eq.device
        assert table.shape[:2] == (3, 4)
        assert table.dtype in (state.lam_eq.dtype, torch.bool)
