"""PyTorch port, `quu_solver="cholesky"` on the point-feet quadruped's SRBD
problem under Euler (K1's `quadruped` shape, now with a Tassa-Cholesky
instantiation), in float64 on the CPU (K1's plain twin), against the JAX
package, whose `MSDDP._backward` takes the option at any shape:

  - K1's Tassa twin with the Cholesky gains against JAX's `_backward` with
    quu_solver="cholesky" on its dense linearization of a drawn iterate
    (ns=8), to 1e-10;
  - `MSDDP.solve` with the Cholesky gains under the default modes against
    JAX's `solve`, and `solve_batch` at B=4 against JAX's `solve_batch`
    (its collapsed sweep ignores the gain solve, as the port's does):
    iterations and convergence equal, plans and cost to 1e-9, the final
    defects to 1e-12.
"""

import pytest
import torch

from _torch_parity import (
    check_k1_cholesky, check_mode_solves, modes_kernel_results, solve_results,
)
from srbd_horizon_tpu_torch.kernels import riccati as k1

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def kernels():
    return modes_kernel_results("quadruped", "EULER", parts=("k1",))


def test_k1_tassa_cholesky_twin_matches_jax(kernels):
    assert kernels["k1_shape"] == "quadruped"
    check_k1_cholesky(kernels)
    assert k1.KERNEL_INSTANCES[k1.kernel_instance(
        "quadruped", "tassa", "cholesky")] == ("quadruped", "tassa", "cholesky")


def test_cholesky_solves_match_jax():
    s = solve_results("quadruped", "EULER", jax_solve_batch=True,
                      vmap_solve=False, quu_solver="cholesky")
    check_mode_solves(s, ("sequential", "nonlinear"))
    assert int(s["solve"].iterations) > 2
    assert s["spy"].k1 == int(s["solve"].iterations)
