"""The batched lanes step of the Franka Panda EE scene on the port, against
the JAX package's `forward.n_steps_batched` on the same inputs.

`gym_so100_tpu/assets/pandas_transfer_cube_ee.xml` (nv = 15, K = 24): the
Panda's general actuators, the mocap weld (6 rows) and the finger-coupling
joint equality (1 row), the cube's box and hull contacts, and the Newton
solve at nv = 15 (on the card the solver kernel's nv = 15 build; here, as
in JAX on the CPU at B % 128 != 0, the plain solve).  4 envs start from
the "home" keyframe with their arm joints moved by a seeded numpy draw of
at most 0.01 rad, each with its mocap target on its own ee site.

The step sits on knife edges of the Newton solve: where a lane stops
(the improvement < tol test) moves under one ulp of noise on the start,
which moves the lanes' qvel well past 1e-5 of scale in float32 and past
1e-10 in float64 after one substep, and far more over a control step.
So each lane of qpos, qvel and the warm start is held to the larger of a
fixed bound and twice the most that 8 one-ulp perturbations of the
port's start move that lane (the floor rule of chip_smoke.py's solver
check), after one substep:

* float32: the fixed bound 1e-5 of each array's largest magnitude, and
  the candidate counts equal.  One jitted JAX program serves every case
  (JAX compiles and runs it for minutes on the CPU); as a negative
  control, the bound must reject the port's substep with the finger
  coupling dropped.
* float64, slow-marked for its JAX run: the fixed bound 1e-10 (that of
  tests/test_torch_panda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_DIR
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.models.scene import State as JaxState
from gym_so100_tpu.ops import forward as jax_fwd
from gym_so100_tpu_torch.models.builder import PANDA_XML, build_model
from gym_so100_tpu_torch.models.scene import State
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.ops import smooth_lanes

B, K = 4, 24
ARRAYS = ("qpos", "qvel", "qacc_warmstart")
FLOOR_SAMPLES = 8


def _start(dtype):
    """The port's model and the batched start state in `dtype`, and the
    same state as JAX leaves."""
    m, aux = build_model(PANDA_XML, max_contacts=K, device="cpu", dtype=dtype)
    kq, kc = aux["keyframes"]["home"]
    qpos = np.tile(np.asarray(kq, np.float64), (B, 1))
    qpos[:, :7] += np.random.RandomState(3).uniform(-0.01, 0.01, (B, 7))
    one = fwd.make_state(m, qpos=kq, ctrl=kc)
    s = State(qpos=torch.tensor(qpos, dtype=dtype), qvel=torch.zeros(B, m.nv, dtype=dtype),
              ctrl=one.ctrl.expand(B, -1).clone(),
              mocap_pos=one.mocap_pos.expand(B, -1, -1).clone(),
              mocap_quat=one.mocap_quat.expand(B, -1, -1).clone(),
              qacc_warmstart=torch.zeros(B, m.nv, dtype=dtype))
    ee = m.site_id("ee_site")
    s = s.replace(mocap_pos=smooth_lanes.kinematics(m, s).site_xpos[:, ee][:, None].clone())
    sj = JaxState(**{k: jnp.asarray(getattr(s, k).numpy()) for k in (
        "qpos", "qvel", "ctrl", "mocap_pos", "mocap_quat", "qacc_warmstart")})
    return m, s, sj


def _jax_model(dtype):
    mj, _ = jax_build_model(f"{ASSETS_DIR}/pandas_transfer_cube_ee.xml", max_contacts=K)
    return mj.astype(jnp.float32) if dtype == torch.float32 else mj


def _substeps(dtype):
    """The port's and JAX's `n_steps_batched(m, s, 1)` from the same start,
    and per array the most that FLOOR_SAMPLES one-ulp perturbations of the
    port's start qpos move each lane of the port's result, (B,)."""
    m, s, sj = _start(dtype)
    mj = _jax_model(dtype)
    out_t, ncon_t = fwd.n_steps_batched(m, s, 1)
    out_j, ncon_j = jax.jit(lambda s: jax_fwd.n_steps_batched(mj, s, 1))(sj)
    gen = torch.Generator().manual_seed(5)
    eps = torch.finfo(dtype).eps
    spread = {k: torch.zeros(B, dtype=torch.float64) for k in ARRAYS}
    for _ in range(FLOOR_SAMPLES):
        qpos = s.qpos * (1 + eps * torch.randn(s.qpos.shape, generator=gen, dtype=dtype))
        moved = fwd.n_steps_batched(m, s.replace(qpos=qpos), 1)[0]
        for k in ARRAYS:
            d = (getattr(moved, k) - getattr(out_t, k)).abs().amax(1).double()
            spread[k] = torch.maximum(spread[k], d)
    return dict(m=m, s=s, out_t=out_t, ncon_t=ncon_t, out_j=out_j, ncon_j=ncon_j,
                spread=spread)


def _within(ours, theirs, spread, tol):
    """Per lane: max |ours - theirs| against the larger of tol times the
    largest magnitude of theirs and twice the lane's one-ulp spread."""
    ours, theirs = ours.numpy().astype(np.float64), np.asarray(theirs, np.float64)
    diff = np.abs(ours - theirs).max(1)
    bound = np.maximum(tol * np.abs(theirs).max(), 2 * spread.numpy())
    return bool((diff <= bound).all()), diff, bound


@pytest.fixture(scope="module")
def float32_substep():
    return _substeps(torch.float32)


@pytest.mark.parametrize("name", ARRAYS)
def test_float32_substep_matches_jax(float32_substep, name):
    r = float32_substep
    ours, theirs = getattr(r["out_t"], name), getattr(r["out_j"], name)
    assert r["out_j"].qpos.dtype == jnp.float32 and ours.dtype == torch.float32
    assert np.isfinite(ours.numpy()).all() and ours.shape == theirs.shape
    ok, diff, bound = _within(ours, theirs, r["spread"][name], 1e-5)
    assert ok, (name, diff, bound)


def test_float32_substep_contacts_and_motion(float32_substep):
    """The same candidate counts (the cube on the table in every env),
    and a step that moves the arm."""
    r = float32_substep
    np.testing.assert_array_equal(r["ncon_t"].numpy(), np.asarray(r["ncon_j"]))
    assert (r["ncon_t"] > 0).all()
    assert float(r["out_t"].qvel[:, :7].abs().max()) > 1e-3, "the substep left the arm at rest"


def test_float32_bound_rejects_a_planted_fault(float32_substep):
    """The port's substep with the finger-coupling equality dropped lies
    outside the bound in some array."""
    r = float32_substep
    m = r["m"]
    faulty = dataclasses.replace(m, eq_jnt_q1=(), eq_jnt_q2=(), eq_jnt_v1=(), eq_jnt_v2=())
    out_f = fwd.n_steps_batched(faulty, r["s"], 1)[0]
    assert not all(_within(getattr(out_f, k), getattr(r["out_j"], k), r["spread"][k], 1e-5)[0]
                   for k in ARRAYS)


@pytest.mark.slow
def test_float64_substep_matches_jax():
    r = _substeps(torch.float64)
    np.testing.assert_array_equal(r["ncon_t"].numpy(), np.asarray(r["ncon_j"]))
    for name in ARRAYS:
        ok, diff, bound = _within(getattr(r["out_t"], name), getattr(r["out_j"], name),
                                  r["spread"][name], 1e-10)
        assert ok, (name, diff, bound)
