"""Stage-by-stage parity of the port's substep with the JAX package's lanes
path, at B = 8 on one seeded state (random arm offsets, the cube resting on
the table so the contact stages have work):

* smooth dynamics in float64 (`forward_smooth_lanes`): every output to 1e-10
  relative (the two sides sum in different orders);
* collision in float32 (`collide_batched_lanes`), fed the same geom poses:
  active slots, pair ids and candidate counts equal, depth/position/frame
  within 1e-5;
* constraint rows in float32 (`make_efc_from_lanes`), fed the same
  ContactLanes and kinematics: every row array within 1e-5 (rel 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.models.scene import ContactLanes as JaxContactLanes
from gym_so100_tpu.models.scene import Data as JaxData
from gym_so100_tpu.models.scene import State as JaxState
from gym_so100_tpu.ops import constraint_lanes as jax_efc
from gym_so100_tpu.ops import smooth_lanes as jax_smooth
from gym_so100_tpu.ops.collision import narrowphase as jax_np
from gym_so100_tpu_torch.models.convert import model_from_numpy
from gym_so100_tpu_torch.models.scene import Data, State
from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes
from gym_so100_tpu_torch.ops.collision import narrowphase

B = 8


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def models():
    mj, _ = jax_build_model(ASSETS_XML, max_contacts=16)
    return mj, model_from_numpy(_leaves(mj))


def _state(m, dtype):
    rng = np.random.RandomState(9)
    qpos = np.tile(m.qpos0.numpy(), (B, 1))
    qpos[:, :6] += rng.uniform(-0.4, 0.4, (B, 6))
    qpos[:, 6:8] += rng.uniform(-0.05, 0.05, (B, 2))
    qpos[:, 8] = 0.0195                       # cube 0.5 mm into the table
    t = lambda a: torch.tensor(a, dtype=dtype)
    return State(qpos=t(qpos), qvel=t(rng.uniform(-0.5, 0.5, (B, m.nv))),
                 ctrl=t(rng.uniform(-0.5, 0.5, (B, m.nu))),
                 mocap_pos=torch.zeros(B, 0, 3, dtype=dtype),
                 mocap_quat=torch.zeros(B, 0, 4, dtype=dtype),
                 qacc_warmstart=torch.zeros(B, m.nv, dtype=dtype))


def _jax_state(s):
    n = lambda x: jnp.asarray(x.numpy())
    return JaxState(qpos=n(s.qpos), qvel=n(s.qvel), ctrl=n(s.ctrl),
                    mocap_pos=n(s.mocap_pos), mocap_quat=n(s.mocap_quat),
                    qacc_warmstart=n(s.qacc_warmstart))


def test_smooth_float64(models):
    mj, mt = models
    s = _state(mt, torch.float64)
    out_t = smooth_lanes.forward_smooth_lanes(mt, s)
    out_j = jax.jit(lambda s: jax_smooth.forward_smooth_lanes(mj, s))(_jax_state(s))
    for key in ("geom_xpos", "geom_xmat", "site_xpos", "site_xmat", "subtree_com0",
                "cdof", "qM", "qacc_smooth", "qfrc_actuator", "qfrc_passive",
                "qfrc_bias", "qfrc_smooth"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=1e-10, atol=1e-12, err_msg=key)


@pytest.fixture(scope="module")
def contacts(models):
    mj, mt = models
    mj32 = mj.astype(jnp.float32)
    mt32 = model_from_numpy(_leaves(mj32))
    s = _state(mt32, torch.float32)
    sl = smooth_lanes.forward_smooth_lanes(mt32, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"], cdof=sl["cdof"],
             subtree_com=sl["subtree_com0"][:, None])
    cl_t = narrowphase.collide_batched_lanes(mt32, d)
    n = lambda x: jnp.asarray(x.numpy())
    dj = JaxData(geom_xpos=n(d.geom_xpos), geom_xmat=n(d.geom_xmat), cdof=n(d.cdof),
                 subtree_com=n(d.subtree_com))
    cl_j = jax.jit(lambda d: jax_np.collide_batched_lanes(mj32, d))(dj)
    return mj32, mt32, s, d, dj, cl_t, cl_j


def test_collide_float32(contacts):
    _, _, _, _, _, cl_t, cl_j = contacts
    act = np.asarray(cl_j.active)
    assert act.sum() >= B, "too few contacts in the test state"
    np.testing.assert_array_equal(cl_t.active.numpy(), act)
    np.testing.assert_array_equal(cl_t.ncand.numpy(), np.asarray(cl_j.ncand))
    for name in ("geom1", "geom2", "condim"):
        np.testing.assert_array_equal(getattr(cl_t, name).numpy()[act],
                                      np.asarray(getattr(cl_j, name))[act], err_msg=name)
    np.testing.assert_allclose(cl_t.dist.numpy(), np.asarray(cl_j.dist), atol=1e-5)
    for c in range(3):
        np.testing.assert_allclose(cl_t.pos[c].numpy(), np.asarray(cl_j.pos[c]), atol=1e-5)
        for r in range(3):
            np.testing.assert_allclose(cl_t.frame[r][c].numpy(),
                                       np.asarray(cl_j.frame[r][c]), atol=1e-5)


def test_efc_float32(contacts):
    mj32, mt32, s, d, dj, cl_t, _ = contacts
    n = lambda x: jnp.asarray(x.numpy())
    # both sides assemble rows from the very same contacts (the port's)
    cl_j = JaxContactLanes(
        dist=n(cl_t.dist), pos=tuple(n(x) for x in cl_t.pos),
        frame=tuple(tuple(n(x) for x in row) for row in cl_t.frame),
        friction0=n(cl_t.friction0), friction1=n(cl_t.friction1),
        solref0=n(cl_t.solref0), solref1=n(cl_t.solref1),
        solimp=tuple(n(x) for x in cl_t.solimp), geom1=n(cl_t.geom1),
        geom2=n(cl_t.geom2), condim=n(cl_t.condim), active=n(cl_t.active),
        dof_dmask=tuple(n(x) for x in cl_t.dof_dmask), invw_diag=n(cl_t.invw_diag),
        ncand=n(cl_t.ncand))
    e_t = constraint_lanes.make_efc_from_lanes(mt32, d, s, cl_t)
    e_j = jax.jit(lambda d, s, c: jax_efc.make_efc_from_lanes(mj32, d, s, c))(
        dj, _jax_state(s), cl_j)
    assert (e_t.neq, e_t.nf, e_t.nl) == (e_j.neq, e_j.nf, e_j.nl)
    np.testing.assert_allclose(e_t.J.numpy(), np.stack([np.asarray(x) for x in e_j.J]),
                               rtol=1e-5, atol=1e-5)
    for name in ("aref", "D", "R", "pos", "floss", "con_mu", "con_uscale", "con_Dn"):
        np.testing.assert_allclose(getattr(e_t, name).numpy(), np.asarray(getattr(e_j, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(e_t.con_active.numpy(), np.asarray(e_j.con_active))
