"""The port's CartesianBatchedEnv alone, float32, on the gained weld: the
JAX package's IK-tracking criteria (tests/test_ee_batched.py) at B = 8.

Each env moves its mocap target 5 cm along its own unit direction (z >= 0,
seeded numpy; 10 control steps of half the largest nudge), then holds it
for 15.  The target moves exactly 5 cm; every ee site ends within 2.5 cm
of its own target, having moved more than 2 cm along its direction; the
targets differ between envs by more than 3 cm."""

import numpy as np
import torch

from gym_so100_tpu_torch.envs.ee_env import EE_XML, CartesianBatchedEnv
from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.ops import smooth_lanes

B = 8


def test_each_env_tracks_its_own_target():
    m, _ = build_model(EE_XML, max_contacts=16, device="cpu")
    env = CartesianBatchedEnv(m, num_envs=B, device="cpu")
    es = env.reset(seed=2)
    ee_site = env.ids.ee_site
    rng = np.random.RandomState(0)
    dirs = rng.uniform(-1, 1, (B, 3))
    dirs[:, 2] = np.abs(dirs[:, 2])            # stay above the table
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    start = es.physics.mocap_pos[:, 0].clone()
    ee0 = smooth_lanes.kinematics(m, es.physics).site_xpos[:, ee_site].clone()
    assert torch.allclose(start, ee0, atol=1e-6)

    move = torch.cat([torch.tensor(dirs * 0.5, dtype=torch.float32),
                      torch.zeros(B, 1)], 1)
    for _ in range(10):
        es, obs, rew, term, trunc, info = env.step(es, move)
    for _ in range(15):
        es, obs, rew, term, trunc, info = env.step(es, torch.zeros(B, 4))

    target = es.physics.mocap_pos[:, 0]
    np.testing.assert_allclose((target - start).norm(dim=1).numpy(), 0.05, atol=1e-5)
    ee = smooth_lanes.kinematics(m, es.physics).site_xpos[:, ee_site]
    err = (ee - target).norm(dim=1)
    torch.testing.assert_close(err, info["ee_err"])
    assert bool((err < 0.025).all()), err
    along = ((ee - ee0).numpy() * dirs).sum(1)
    assert (along > 0.02).all(), along
    assert np.ptp(target.numpy(), axis=0).max() > 0.03
    assert obs.shape == (B, 15) and bool(torch.isfinite(obs).all())
