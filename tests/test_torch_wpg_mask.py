"""PyTorch port, the WPG's contact mask on the CPU: `advance` takes the
mask of the contacts that follow the A-cycle from one tensor a device
(`wpg._left_mask`), made on the first advance, instead of building it from
the host tuple on every advance (a pageable host-to-device copy on the
card, which waits for the stream). Over one gait cycle of the quadruped's
diagonal-pair trot (a fleet mixing the three actions), and of the biped
split, the advance is bit-equal to the old construction, and after the
first advance no tensor is made from host data."""

import numpy as np
import pytest
import torch

from srbd_horizon_tpu_torch import wpg as wpg_mod
from srbd_horizon_tpu_torch.models.quadruped import trot_group_mask
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator

torch.set_num_threads(1)

F64 = torch.float64
NS = 20
B = 6


def _old_mask(group_mask, nc, cm, device):
    """The construction `advance` made on every call before."""
    if group_mask is not None:
        return torch.tensor(group_mask, device=device)
    return torch.arange(nc, device=device) < cm


def _params(nc, rng):
    return {"c_ref": torch.as_tensor(rng.randn(B, NS + 1, nc)),
            "cdot_switch": torch.as_tensor(rng.rand(B, NS + 1, nc)),
            "w_ref": torch.as_tensor(rng.randn(B, NS + 1, 3)),
            "orientation_tracking_gain": torch.as_tensor(
                rng.rand(B, NS + 1, 1))}


def _cycle(wpg, nc, seed):
    """One gait cycle (2·step_nodes advances) from drawn params and
    counters, actions STANCE, STEP and JUMP across the fleet."""
    rng = np.random.RandomState(seed)
    p = _params(nc, rng)
    st = wpg.init_state((B,))._replace(step_counter=torch.as_tensor(
        rng.randint(0, 2 * wpg.step_nodes, B), dtype=torch.int32))
    action = torch.as_tensor([0, 1, 2, 1, 1, 0], dtype=torch.int32)
    out = []
    for _ in range(2 * wpg.step_nodes):
        p, st = wpg.advance(p, st, action, terrain_z=0.01)
        out.append(({k: v.clone() for k, v in p.items()}, st.step_counter))
    return out


@pytest.mark.parametrize("topology,mask", [
    (dict(contact_model=1, number_of_legs=4), trot_group_mask()),
    (dict(contact_model=2, number_of_legs=2), None)], ids=["trot", "biped"])
def test_advance_bit_equal_to_the_old_construction(monkeypatch, topology,
                                                   mask):
    wpg = WalkingPatternGenerator.build(0.0, NS, dtype=F64, device="cpu",
                                        group_mask=mask, **topology)
    nc = topology["contact_model"] * topology["number_of_legs"]
    new = _cycle(wpg, nc, 3)
    monkeypatch.setattr(wpg_mod, "_left_mask", _old_mask)
    old = _cycle(wpg, nc, 3)
    for (pn, sn), (po, so) in zip(new, old):
        assert torch.equal(sn, so)
        for k in pn:
            assert torch.equal(pn[k], po[k]), k


def test_trot_advance_makes_no_tensor_from_host_data(monkeypatch):
    wpg = WalkingPatternGenerator.build(0.0, NS, dtype=F64, device="cpu",
                                        group_mask=trot_group_mask(),
                                        contact_model=1, number_of_legs=4)
    rng = np.random.RandomState(4)
    p, st = _params(4, rng), wpg.init_state((B,))
    action = torch.ones(B, dtype=torch.int32)
    p, st = wpg.advance(p, st, action)
    made = []
    tensor = torch.tensor
    monkeypatch.setattr(wpg_mod.torch, "tensor",
                        lambda *a, **k: made.append(a) or tensor(*a, **k))
    for _ in range(wpg.step_nodes):
        p, st = wpg.advance(p, st, action)
    assert made == []
    assert wpg_mod._left_mask(wpg.group_mask, 4, 1, "cpu") is \
        wpg_mod._left_mask(wpg.group_mask, 4, 1, torch.device("cpu"))
