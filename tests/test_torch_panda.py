"""The Franka Panda end-effector scene on the port, against the JAX package.

`gym_so100_tpu/assets/pandas_transfer_cube_ee.xml`: .obj meshes, `general`
actuators with affine gain and bias, the finger-coupling joint equality
and the mocap weld, nv = 15.

* The port's `build_model` against JAX's, leaf by leaf, in float64 (float
  leaves to 1e-12 relative, 1e-15 absolute; int leaves, statics and the
  pair table equal), and the scene's own numbers (tests/test_panda.py's).
* One float64 control step (`forward.n_steps`, 10 substeps) from the
  "home" keyframe with the mocap target on the ee site, against JAX's:
  qpos, qvel, the warm start and the target to 1e-10 of each array's
  largest magnitude (see the test for the fused `n_steps` program).
* Slow, as tests/test_panda.py is: that test's mocap-weld criteria on the
  port alone, in float32 (the arm settles like MuJoCo's within 0.2 m of the
  keyframe's ee pose, the ee follows a 3 cm move of the target along +x by
  more than 1.5 cm, the fingers stay coupled within 5e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_DIR
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.ops import forward as jax_fwd
from gym_so100_tpu_torch.models.builder import PANDA_XML, build_model
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.ops import smooth

K = 24
RTOL, ATOL = 1e-12, 1e-15


@pytest.fixture(scope="module")
def models():
    mj, aux_j = jax_build_model(f"{ASSETS_DIR}/pandas_transfer_cube_ee.xml", max_contacts=K)
    assert mj.qpos0.dtype == jnp.float64
    mt, aux_t = build_model(PANDA_XML, max_contacts=K, device="cpu", dtype=torch.float64)
    return mj, aux_j, mt, aux_t


@pytest.mark.parametrize("field_kind", ["float", "int", "static"])
def test_panda_model_matches_jax(models, field_kind):
    mj, _, mt, _ = models
    checked = 0
    for f in dataclasses.fields(mj):
        jv, tv = getattr(mj, f.name), getattr(mt, f.name)
        if hasattr(jv, "dtype") and hasattr(jv, "shape"):
            jv = np.asarray(jv)
            assert isinstance(tv, torch.Tensor) and tuple(tv.shape) == jv.shape, f.name
            is_float = np.issubdtype(jv.dtype, np.floating)
            if field_kind != ("float" if is_float else "int"):
                continue
            if is_float:
                np.testing.assert_allclose(tv.numpy(), jv, rtol=RTOL, atol=ATOL,
                                           err_msg=f.name)
            else:
                np.testing.assert_array_equal(tv.numpy(), jv, err_msg=f.name)
        elif field_kind != "static":
            continue
        elif f.name == "pairs":
            for pf in ("box_box", "hull_box", "hull_hull", "ccd"):
                assert getattr(tv, pf) == getattr(jv, pf), pf
        elif isinstance(jv, float):
            np.testing.assert_allclose(tv, jv, rtol=RTOL, err_msg=f.name)
        else:
            assert tv == jv, f.name
        checked += 1
    assert checked > 0


def test_panda_compiles(models):
    _, aux_j, m, aux = models
    assert (m.nq, m.nv, m.nu) == (16, 15, 8)
    assert len(m.eq_site1) == 1 and len(m.eq_jnt_q1) == 1     # weld, finger coupling
    np.testing.assert_allclose(m.actuator_kp[:4].numpy(), [4500, 4500, 3500, 3500])
    np.testing.assert_allclose(m.actuator_bias1[:2].numpy(), [-4500, -4500])
    np.testing.assert_allclose(m.actuator_kv[:2].numpy(), [450, 450])
    assert np.isfinite(m.actuator_forcerange[:7].numpy()).all()
    for name, (kq, kc) in aux_j["keyframes"].items():
        np.testing.assert_array_equal(np.asarray(aux["keyframes"][name][0]), np.asarray(kq))
        np.testing.assert_array_equal(np.asarray(aux["keyframes"][name][1]), np.asarray(kc))
    assert "home" in aux["keyframes"]


def _rel(a, b):
    """max |a - b| over the largest magnitude of b."""
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-30))


def test_one_control_step_from_home_matches_jax(models):
    """The port's `fwd.n_steps` against JAX's control step taken as ten
    jitted substeps (`fwd.step`, the body of JAX's `n_steps`) to 1e-10 of
    each array's largest magnitude; and against JAX's `n_steps` jitted
    whole within the larger of 1e-10 and twice the gap between JAX's two
    compilations (on this state, stiff servos under a weld, the fused
    program parts from the stepped one by ~3.5e-10 in qpos and ~2.5e-6 in
    the warm start: XLA rounds the fused scan otherwise)."""
    mj, aux_j, mt, aux = models
    kq, kc = aux["keyframes"]["home"]
    ee = mt.site_id("ee_site")
    s_t = fwd.make_state(mt, qpos=kq, ctrl=kc)
    s_t = s_t.replace(mocap_pos=smooth.kinematics(mt, s_t).site_xpos[ee][None].clone())
    s_t = fwd.n_steps(mt, s_t, 10)

    kq_j, kc_j = aux_j["keyframes"]["home"]
    s0 = jax_fwd.make_state(mj, qpos=kq_j, ctrl=kc_j, dtype=jnp.float64)
    s0 = s0.replace(mocap_pos=jax_fwd.smooth.kinematics(mj, s0).site_xpos[ee][None])
    fused = jax.jit(lambda s: jax_fwd.n_steps(mj, s, 10))(s0)
    substep = jax.jit(lambda s: jax_fwd.step(mj, s)[0])
    stepped = s0
    for _ in range(10):
        stepped = substep(stepped)
    assert float(np.abs(np.asarray(stepped.qpos) - np.asarray(kq_j)).max()) > 1e-3, \
        "the step left the arm where it was"
    for k in ("qpos", "qvel", "qacc_warmstart", "mocap_pos"):
        ours = getattr(s_t, k).numpy()
        assert _rel(ours, getattr(stepped, k)) <= 1e-10, (k, _rel(ours, getattr(stepped, k)))
        gap = _rel(getattr(fused, k), getattr(stepped, k))
        assert _rel(ours, getattr(fused, k)) <= max(1e-10, 2 * gap), (k, gap)


@pytest.mark.slow
def test_panda_mocap_weld_ik_on_the_port():
    m, aux = build_model(PANDA_XML, max_contacts=K, device="cpu")
    kq, kc = aux["keyframes"]["home"]
    ee = m.site_id("ee_site")
    kin = lambda s: smooth.kinematics(m, s).site_xpos[ee]
    s = fwd.make_state(m, qpos=kq, ctrl=kc)
    p0 = kin(s).clone()
    s = s.replace(mocap_pos=p0[None].clone())
    for _ in range(25):
        s = fwd.n_steps(m, s, 10)
    assert bool(torch.isfinite(s.qpos).all())
    # MuJoCo itself settles 0.140 m from the keyframe's ee pose here (the JAX
    # test's calibration): "home" is no equilibrium of the weld and servos
    assert float((kin(s) - p0).norm()) < 0.2
    s2 = s.replace(mocap_pos=s.mocap_pos + torch.tensor([[0.03, 0.0, 0.0]]))
    for _ in range(50):
        s2 = fwd.n_steps(m, s2, 10)
    assert float(kin(s2)[0] - kin(s)[0]) > 0.015
    q1 = s2.qpos[m.jnt_qposadr[m.joint_id("finger_joint1")]]
    q2 = s2.qpos[m.jnt_qposadr[m.joint_id("finger_joint2")]]
    assert abs(float(q1 - q2)) < 5e-3, (float(q1), float(q2))
