"""The port's equality rows (site welds, joint couplings) against the JAX
package's `constraint.equality_rows`, vmapped, on the scenes that have them:
the SO100 EE scene (a mocap weld on the end effector) and the Panda EE scene
(a mocap weld and the finger joint coupling).

Both sides get the same float64 kinematics (site frames, cdof, root com
from the port's smooth pass) and the same random state (seeded numpy).
Every block agrees to 1e-12 (abs and rel)."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.models.scene import Data as JaxData
from gym_so100_tpu.models.scene import State as JaxState
from gym_so100_tpu.ops import constraint as jax_constraint
from gym_so100_tpu_torch.models.convert import model_from_numpy
from gym_so100_tpu_torch.models.scene import Data, State
from gym_so100_tpu_torch.ops import constraint, constraint_lanes, smooth_lanes
from gym_so100_tpu_torch.ops.collision import narrowphase

ASSETS = Path(__file__).resolve().parents[1] / "gym_so100_tpu" / "assets"
B = 6
TOL = 1e-12


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@pytest.mark.parametrize("scene", ["so100_transfer_cube_ee.xml", "pandas_transfer_cube_ee.xml"])
def test_equality_rows_match(scene):
    mj, _ = jax_build_model(str(ASSETS / scene), max_contacts=8)
    mt = model_from_numpy(_leaves(mj))
    assert len(mt.eq_site1) + len(mt.eq_jnt_q1) > 0
    rng = np.random.RandomState(4)
    qpos = np.tile(mt.qpos0.numpy(), (B, 1)) + rng.uniform(-0.2, 0.2, (B, mt.nq))
    qvel = rng.uniform(-1, 1, (B, mt.nv))
    mocap_pos = mt.body_pos[[b for b in range(mt.nbody) if mt.body_mocapid[b] >= 0]]
    mpos = mocap_pos.numpy()[None] + rng.uniform(-0.05, 0.05, (B, mt.nmocap, 3))
    mquat = rng.randn(B, mt.nmocap, 4)
    mquat /= np.linalg.norm(mquat, axis=-1, keepdims=True)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    s = State(qpos=t(qpos), qvel=t(qvel), ctrl=torch.zeros(B, mt.nu, dtype=torch.float64),
              mocap_pos=t(mpos), mocap_quat=t(mquat))
    sl = smooth_lanes.forward_smooth_lanes(mt, s)
    d = Data(site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"], cdof=sl["cdof"],
             subtree_com=sl["subtree_com0"][:, None], geom_xpos=sl["geom_xpos"],
             geom_xmat=sl["geom_xmat"])
    blocks_t = constraint.equality_rows(mt, d, s)

    n = lambda x: jax.numpy.asarray(x.numpy())
    dj = JaxData(site_xpos=n(d.site_xpos), site_xmat=n(d.site_xmat), cdof=n(d.cdof),
                 subtree_com=n(d.subtree_com))
    sj = JaxState(qpos=n(s.qpos), qvel=n(s.qvel), ctrl=n(s.ctrl))
    blocks_j = jax.vmap(lambda d1, s1: jax_constraint.equality_rows(mj, d1, s1))(dj, sj)

    assert len(blocks_t) == len(blocks_j)
    for bt, bj in zip(blocks_t, blocks_j):
        for name, x, y in zip(("J", "aref", "D", "R", "pos"), bt, bj):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=TOL, atol=TOL,
                                       err_msg=f"{scene}: {name}")

    # the lanes assembly puts them first, as the equality block
    efc = constraint_lanes.make_efc_from_lanes(
        mt, d, s, narrowphase.collide_batched_lanes(mt, d))
    neq = sum(b[1].shape[1] for b in blocks_t)
    assert efc.neq == neq
    np.testing.assert_array_equal(efc.aref[:neq].numpy(),
                                  torch.cat([b[1] for b in blocks_t], 1).T.numpy())


def test_quat_from_mat_matches_jax():
    """`quat.from_mat` against the JAX package's on random rotations and on
    rotations by nearly pi about each axis, which take each of the four
    branches of Shepperd's method; float64, to 1e-12."""
    from gym_so100_tpu.ops import quat as jax_quat
    from gym_so100_tpu_torch.ops import quat

    rng = np.random.RandomState(8)
    q = rng.randn(200, 4)
    near_pi = np.concatenate([np.full((3, 1), 1e-3), np.eye(3)], 1)
    q = np.concatenate([q, near_pi, -near_pi[:, [0, 2, 3, 1]]])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = quat.to_mat(torch.from_numpy(q))
    ours = quat.from_mat(R)
    theirs = jax_quat.from_mat(jax.numpy.asarray(R.numpy()))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=TOL, atol=TOL)
    # a rotation round-trips up to the quaternion's sign
    sign = np.sign((ours.numpy() * q).sum(1, keepdims=True))
    np.testing.assert_allclose(ours.numpy() * sign, q, atol=1e-12)
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    diag = R.diagonal(dim1=1, dim2=2).argmax(1)
    assert (tr > 0).any() and all((diag[tr <= 0] == i).any() for i in range(3))
