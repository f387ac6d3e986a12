"""PyTorch port, the URDF loaders, against the JAX package on the CPU.

`srbd_horizon_tpu_torch/models/urdf.py` is the port's own copy of the JAX
package's pure-Python extractor (numpy and `xml.etree` only), reading the
port's own copies of the two URDF assets:

  - `URDFModel` (forward kinematics, mass, CoM, composite inertia, frames)
    and `load_robot_constants` against JAX's on `tests/test_urdf.py`'s
    two-leg test biped and on both assets, to 1e-12;
  - `kangaroo_from_urdf()` and `quadruped_from_urdf()` against the
    recorded `kangaroo_line_feet()` and `quadruped_point_feet()`, to 1e-12;
  - the copied assets byte-equal to the JAX package's.
"""

from pathlib import Path

import numpy as np
import pytest

from srbd_horizon_tpu.models import kangaroo as j_kangaroo
from srbd_horizon_tpu.models import quadruped as j_quadruped
from srbd_horizon_tpu.models import urdf as j_urdf
from srbd_horizon_tpu_torch.models import kangaroo as t_kangaroo
from srbd_horizon_tpu_torch.models import quadruped as t_quadruped
from srbd_horizon_tpu_torch.models import urdf as t_urdf
from test_urdf import TEST_URDF

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-12

# (urdf path, joints, frames, world frame) of each model the tests load
MODELS = {
    "test_biped": (None, [0.3, -0.2], ["left_foot", "right_foot"], None),
    "test_biped_world": (None, [0.0, 0.4], ["left_foot", "right_foot"],
                         "left_foot"),
    "kangaroo": (t_kangaroo.KANGAROO_URDF, list(t_kangaroo.KANGAROO_JOINT_INIT),
                 list(t_kangaroo.KANGAROO_FOOT_FRAMES),
                 t_kangaroo.KANGAROO_WORLD_FRAME),
    "quadruped": (t_quadruped.QUADRUPED_URDF,
                  list(t_quadruped.QUADRUPED_JOINT_INIT),
                  list(t_quadruped.QUADRUPED_FOOT_FRAMES),
                  t_quadruped.QUADRUPED_WORLD_FRAME),
}


@pytest.fixture(scope="module")
def test_biped_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("urdf") / "testbot.urdf"
    p.write_text(TEST_URDF)
    return p


def _model(name, test_biped_file):
    path, joints, frames, world = MODELS[name]
    return (path or str(test_biped_file)), joints, frames, world


@pytest.mark.parametrize("name", list(MODELS))
def test_urdf_model_matches_jax(name, test_biped_file):
    path, joints, frames, world = _model(name, test_biped_file)
    text = Path(path).read_text()
    got = t_urdf.URDFModel(text).constants(joints, frames, world)
    want = j_urdf.URDFModel(text).constants(joints, frames, world)
    assert abs(got["mass"] - want["mass"]) <= TOL * max(1.0, want["mass"])
    for key in ("com", "inertia"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL)
    assert list(got["frames"]) == list(want["frames"]) == frames
    for f in frames:
        np.testing.assert_allclose(got["frames"][f], want["frames"][f],
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_kinematics_matches_jax(name, test_biped_file):
    path, joints, _, _ = _model(name, test_biped_file)
    text = Path(path).read_text()
    got = t_urdf.URDFModel(text).fk(joints)
    want = j_urdf.URDFModel(text).fk(joints)
    assert set(got) == set(want)
    for link in want:
        np.testing.assert_allclose(got[link], want[link], rtol=0, atol=TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_load_robot_constants_matches_jax(name, test_biped_file):
    path, joints, frames, world = _model(name, test_biped_file)
    got = t_urdf.load_robot_constants(path, joints, frames, world)
    want = j_urdf.load_robot_constants(path, joints, frames, world)
    assert isinstance(got, t_kangaroo.RobotConstants)
    assert got.foot_frames == want.foot_frames
    assert abs(got.mass - want.mass) <= TOL * max(1.0, want.mass)
    for key in ("inertia", "com", "foot_positions"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("load, recorded", [
    (t_kangaroo.kangaroo_from_urdf, t_kangaroo.kangaroo_line_feet),
    (t_quadruped.quadruped_from_urdf, t_quadruped.quadruped_point_feet),
], ids=["kangaroo", "quadruped"])
def test_loaders_give_the_recorded_constants(load, recorded):
    got, want = load(), recorded()
    assert got.foot_frames == want.foot_frames
    assert abs(got.mass - want.mass) <= TOL * want.mass
    for key in ("inertia", "com", "foot_positions"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("load, jax_load", [
    (t_kangaroo.kangaroo_from_urdf, j_kangaroo.kangaroo_from_urdf),
    (t_quadruped.quadruped_from_urdf, j_quadruped.quadruped_from_urdf),
], ids=["kangaroo", "quadruped"])
def test_loaders_match_jax(load, jax_load):
    got, want = load(), jax_load()
    for key in ("inertia", "com", "foot_positions"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=0, atol=TOL)
    assert got.mass == want.mass and got.foot_frames == want.foot_frames


@pytest.mark.parametrize("asset", ["kangaroo_like.urdf", "quadruped_like.urdf"])
def test_assets_are_byte_equal_copies(asset):
    port = REPO / "srbd_horizon_tpu_torch" / "assets" / asset
    ref = REPO / "srbd_horizon_tpu" / "assets" / asset
    assert port.read_bytes() == ref.read_bytes()


def test_native_tool_path_is_the_repos():
    """`run_native_tool` defaults to the repository's C++ extractor, the
    same file the JAX package's copy calls."""
    calls = []

    class Done:
        stdout = "{}"

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return Done()

    orig = t_urdf.subprocess.run
    t_urdf.subprocess.run = fake_run
    try:
        assert t_urdf.run_native_tool("x.urdf", [0.0], ["a"], "w") == {}
    finally:
        t_urdf.subprocess.run = orig
    tool = REPO / "tools" / "urdf_constants" / "urdf_constants"
    assert calls == [[str(tool), "x.urdf", "--joints", "0.0", "--frames", "a",
                      "--world-frame", "w"]]
