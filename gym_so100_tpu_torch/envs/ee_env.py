"""Batched Cartesian (end-effector) control: the mocap weld as implicit IK.

The port of `gym_so100_tpu/envs/ee_env.py`.  The action is a per-env
Cartesian delta of the mocap target (and a gripper delta); the 6-row site
weld between the mocap target and the end-effector site is assembled with
the other constraint rows (`constraint.equality_rows`, rows [0:6] of the
batch-last rows) and the Newton solve drags the arm after the target, so
the constraint solver is the IK.  Every env tracks its own target.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from ..device import resolve_device
from ..models.scene import Model, State
from ..ops import forward as fwd
from ..ops import quat, smooth_lanes
from . import constants as C
from . import core

# the mocap weld scene, read in place from the JAX package's asset folder
EE_XML = str(Path(__file__).resolve().parents[2] / "gym_so100_tpu" / "assets"
             / "so100_transfer_cube_ee.xml")

# the reference teleop's nudges: 0.01 m per mocap step, 0.05 per gripper
# step; actions in [-1, 1] scale up to these
POS_SCALE = 0.01
GRIP_SCALE = 0.05
JAW_RANGE = (float(C.JOINT_RANGES[5, 0]), float(C.JOINT_RANGES[5, 1]))


class CartesianBatchedEnv:
    """Batched end-effector-space env over the mocap-weld scene, on `device`
    (default: the GPU, raising when there is none).

    Action: (B, 4) in [-1, 1]: the mocap target's xyz delta (x POS_SCALE
    metres) and a gripper ctrl delta (x GRIP_SCALE, clipped to the jaw's
    range).  The arm's position actuators track the current joint
    positions, so the weld alone places the arm.

    Usage:
        env = CartesianBatchedEnv(num_envs=1024)
        es = env.reset(seed=0)
        es, obs, reward, terminated, truncated, info = env.step(es, actions)
    """

    def __init__(self, m: Model | None = None, num_envs: int = 1024,
                 task: str = "so100_touch_cube", max_episode_steps: int = 300,
                 orientation_mode: str = "follow", weld_gain: bool = True,
                 device="cuda", seed: int = 0, max_contacts: int = 32):
        """`m` defaults to the EE scene built with `max_contacts` contact
        slots, in float32.

        weld_gain: stiffen the weld on this env's copy of the model (solimp
        0.95/0.995, solref time constant 0.01) so that the target drags the
        arm; the scene's own weld (solimp 0.9/0.95, solref 0.02) lags
        ~3.6 cm behind a 4 cm drag.  False keeps the scene's weld.

        orientation_mode: "follow" sets the mocap orientation to the ee's
        current one at every control step, so the weld's rotation rows only
        damp the wrist and its translation rows do a feasible position IK
        (3 constraints on 5 arm dofs); "fixed" holds the reset orientation
        (6 constraints on 5 dofs: position error expected)."""
        self.device = resolve_device(device)
        if m is None:
            from ..models.builder import build_model

            m, _ = build_model(EE_XML, max_contacts=max_contacts, device=self.device)
        else:
            m = m.to(self.device)
        if not m.eq_site1:
            raise ValueError(
                "CartesianBatchedEnv needs a scene with a mocap weld "
                "(so100_transfer_cube_ee.xml); the joint-space scene has no "
                "equality rows to drive")
        if orientation_mode not in ("follow", "fixed"):
            raise ValueError(orientation_mode)
        if weld_gain:
            si = m.eq_solimp.clone()
            si[:, 0] = 0.95
            si[:, 1] = 0.995
            sr = m.eq_solref.clone()
            sr[:, 0] = 0.01
            m = dataclasses.replace(m, eq_solimp=si, eq_solref=sr)
        self.m = m
        self.task = task
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.orientation_mode = orientation_mode
        self.ids = core.TaskIds.from_model(m)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _ee_quat(self, d):
        return quat.from_mat(d.site_xmat[:, self.ids.ee_site])[:, None]

    def reset(self, seed=None, box_pose=None) -> core.EnvState:
        """Fresh episodes: arm and cube as `core.reset`, the mocap target on
        the ee site, position and orientation, so the weld starts at zero
        error.  Cube spawns come from `box_pose` (num_envs, 7) when given,
        else from the env's generator (reseeded by `seed`)."""
        if seed is not None:
            self.generator.manual_seed(seed)
        if box_pose is None:
            box_pose = C.sample_so100_box_poses(self.num_envs, self.generator,
                                                self.m.dtype, self.device)
        es = core.reset(self.m, torch.as_tensor(box_pose, dtype=self.m.dtype,
                                                device=self.device))
        s = es.physics
        d = smooth_lanes.kinematics(self.m, s)
        s = s.replace(
            mocap_pos=d.site_xpos[:, self.ids.ee_site][:, None].to(s.mocap_pos.dtype),
            mocap_quat=self._ee_quat(d).to(s.mocap_quat.dtype))
        return es.replace(physics=s)

    def apply_action(self, s: State, action) -> State:
        """Mocap delta and gripper delta -> the batched State the substeps
        start from: ctrl[:5] track the current joint positions (the position
        actuators act as dampers), ctrl[5] the clipped jaw target; in
        "follow" mode the mocap orientation snaps to the ee's."""
        a = torch.clamp(torch.as_tensor(action, device=self.device), -1.0, 1.0).to(s.qpos.dtype)
        mocap = s.mocap_pos + a[:, None, :3] * POS_SCALE
        jaw = torch.clamp(s.ctrl[:, 5] + a[:, 3] * GRIP_SCALE, JAW_RANGE[0], JAW_RANGE[1])
        ctrl = torch.cat([s.qpos[:, :5], jaw[:, None]], -1).to(s.ctrl.dtype)
        mq = s.mocap_quat
        if self.orientation_mode == "follow":
            mq = self._ee_quat(smooth_lanes.kinematics(self.m, s)).to(mq.dtype)
        return s.replace(mocap_pos=mocap, ctrl=ctrl, mocap_quat=mq)

    def step(self, es: core.EnvState, actions):
        """One control step.  Returns (state, obs (B, 15) float32, reward
        (B,), terminated (B,), truncated (B,), info): info["ee_err"] (B,) is
        the distance of the ee site from its target, info["ncon"] (B,) the
        contact-candidate watch.  No autoreset."""
        s = self.apply_action(es.physics, actions)
        s, ncon = fwd.n_steps_batched(self.m, s, C.N_SUBSTEPS)
        d = smooth_lanes.kinematics(self.m, s)
        flags = core._pair_contact_flags_batched(self.m, d, self.ids)
        reward, _ = core.task_reward(self.m, d, self.ids, self.task, flags)
        obs = core.observations(self.m, d, s, self.ids)
        es2 = core.EnvState(physics=s, t=es.t + 1, box_pose=es.box_pose)
        diff = d.site_xpos[:, self.ids.ee_site] - s.mocap_pos[:, 0]
        info = {"ncon": ncon, "ee_err": torch.sqrt((diff * diff).sum(-1))}
        obs_vec = torch.cat([obs["box_position"], obs["bin_position"], obs["ee_position"],
                             obs["qpos"]], -1).to(torch.float32)
        return (es2, obs_vec, reward, reward == 4.0, es2.t >= self.max_episode_steps,
                info)
