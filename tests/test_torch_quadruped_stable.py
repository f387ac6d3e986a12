"""PyTorch port, the quadruped's trot on its own: the criteria of the JAX
package's `tests/test_quadruped.py::TestClosedLoopTrot` — 120 closed-loop
ticks of `walking_schedule(vx=0.25, start=10)` with the example's options
and the trot WPG, float64 on the CPU: every state finite, the CoM height
within 0.05 of its start, forward progress above 0.5 m, the largest defect
norm below 1e-5 and the Newton–Euler residual below 1e-6 — held by the port
alone, with no JAX run beside it."""

import numpy as np
import torch

from srbd_horizon_tpu_torch import SRBDConfig, build_quadruped_loop, walking_schedule

torch.set_num_threads(1)


def test_stable_trot():
    loop, prob = build_quadruped_loop(
        SRBDConfig(contact_model=1, number_of_legs=4, dtype=torch.float64),
        device="cpu")
    carry = loop.init(prob.initial_state)
    sched = walking_schedule(120, vx=0.25, start=10, dtype=torch.float64,
                             device="cpu")
    carry, out = loop.run(carry, sched)
    X = out.x.numpy()
    z0 = float(prob.initial_state[2])
    assert np.all(np.isfinite(X))
    assert np.all(np.abs(X[:, 2] - z0) < 0.05), "CoM height left band"
    assert X[-1, 0] - X[0, 0] > 0.5, "no forward progress"
    assert float(out.defect_norm.max()) < 1e-5
    assert float(out.srbd_residual.abs().max()) < 1e-6
