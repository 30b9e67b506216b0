"""Env core of the batched path: reset, one control step, rewards and
observations (a frozen copy of the port's batched `envs/core.py`).

Task semantics:

* touch_gripper: any contact between `red_box` and the 8 finger-pad geoms;
* touch_table: red_box/table contact;
* bin AABB from the `bin_center` site with hw 0.06, h 0.03, cube_half 0.01;
* TouchCube staged distance shaping + touch bonus + (-0.2) step penalty,
  success (reward 4) when touching within 0.05;
* TouchCubeSparse: 4 or -0.2;
* CubeToBin ladder 1/2/2.5/3/4.

The touch flags come from a direct narrowphase of the 9 reward pairs
(`_pair_contact_flags_batched`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.scene import Data, Model, State
from ..ops import forward as fwd
from ..ops import smooth_lanes
from ..ops.collision import boxbox_lanes
from . import constants as C

TASKS = ("so100_touch_cube", "so100_touch_cube_sparse", "so100_cube_to_bin")


@dataclass(frozen=True)
class EnvState:
    physics: State            # leaves (...) for one env, (B, ...) batched
    t: torch.Tensor           # () or (B,) int32 steps taken this episode
    box_pose: torch.Tensor    # (7,) or (B, 7) cube spawn used at episode start

    def replace(self, **kw) -> "EnvState":
        import dataclasses

        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TaskIds:
    """Static geom/site ids the rewards need (resolved once per model)."""

    cube_geom: int
    table_geom: int
    pad_geoms: tuple
    cube_site: int
    ee_site: int
    bin_site: int

    @staticmethod
    def from_model(m: Model) -> "TaskIds":
        return TaskIds(
            cube_geom=m.geom_id("red_box"),
            table_geom=m.geom_id("table"),
            pad_geoms=tuple(
                m.geom_id(f"{side}_jaw_pad_{i}")
                for side in ("fixed", "moving") for i in range(1, 5)
            ),
            cube_site=m.site_id("cube_site"),
            ee_site=m.site_id("ee_site"),
            bin_site=m.site_id("bin_center"),
        )


def reset(m: Model, box_pose: torch.Tensor) -> EnvState:
    """Episode init: arm and ctrl to the start pose, the cube's free joint to
    box_pose (B, 7)."""
    dtype, dev = box_pose.dtype, box_pose.device
    start = torch.as_tensor(C.SO100_START_ARM_POSE, dtype=dtype, device=dev)
    B = box_pose.shape[0]
    s1 = fwd.make_state(m, dtype=dtype)
    qpos = m.qpos0.to(dtype).repeat(B, 1)
    qpos[:, :6] = start
    qpos[:, -7:] = box_pose
    physics = State(
        qpos=qpos,
        qvel=torch.zeros(B, m.nv, dtype=dtype, device=dev),
        ctrl=start.repeat(B, 1),
        mocap_pos=s1.mocap_pos.expand(B, *s1.mocap_pos.shape).clone(),
        mocap_quat=s1.mocap_quat.expand(B, *s1.mocap_quat.shape).clone(),
        qacc_warmstart=torch.zeros(B, m.nv, dtype=dtype, device=dev),
    )
    return EnvState(
        physics=physics,
        t=torch.zeros(B, dtype=torch.int32, device=dev),
        box_pose=box_pose,
    )


def _pair_contact_flags_batched(m: Model, d: Data, ids: TaskIds):
    """touch_gripper / touch_table (each (B,) bool) by direct box-box
    narrowphase on the 9 reward pairs (cube vs 8 finger pads, cube vs
    table): independent of the deepest-K contact selection."""
    others = list(ids.pad_geoms) + [ids.table_geom]
    cube = ids.cube_geom
    B = d.geom_xpos.shape[0]
    P = len(others)
    gx1 = d.geom_xpos[:, others, :]                    # (B, P, 3)
    gm1 = d.geom_xmat[:, others, :, :]
    gxc = d.geom_xpos[:, cube, :]                      # (B, 3)
    gmc = d.geom_xmat[:, cube, :, :]
    sz1 = m.geom_size[others]                          # (P, 3)
    szc = m.geom_size[cube]
    p1 = tuple(gx1[..., k].T for k in range(3))
    R1 = tuple(tuple(gm1[..., j, k].T for k in range(3)) for j in range(3))
    s1 = tuple(sz1[:, k][:, None].expand(P, B) for k in range(3))
    p2 = tuple(gxc[:, k][None].expand(P, B) for k in range(3))
    R2 = tuple(tuple(gmc[:, j, k][None].expand(P, B) for k in range(3))
               for j in range(3))
    s2 = tuple(szc[k].expand(P, B) for k in range(3))
    out = boxbox_lanes.box_box_lanes(p1, R1, s1, p2, R2, s2)
    touching = out["active"][0]
    for a in out["active"][1:]:
        touching = touching | a                        # (P, B) any slot
    return touching[:-1].any(dim=0), touching[-1]


def _bin_aabb(d: Data, ids: TaskIds):
    center = d.site_xpos[:, ids.bin_site]              # (B, 3)
    hw, h = 0.06, 0.03
    off = torch.tensor([hw, hw, 0.0], dtype=center.dtype, device=center.device)
    top = torch.tensor([hw, hw, h], dtype=center.dtype, device=center.device)
    return center - off, center + top


def task_reward(m: Model, d: Data, ids: TaskIds, task: str, flags):
    """Per-step reward and success for `task`, each (B,), with flags =
    (touch_gripper, touch_table) from `_pair_contact_flags_batched`."""
    cube_pos = d.site_xpos[:, ids.cube_site]
    if task == "so100_cube_to_bin":
        # the reference reads the cube position as float32
        cube_pos = cube_pos.to(torch.float32).to(cube_pos.dtype)
    ee_pos = d.site_xpos[:, ids.ee_site]
    diff = ee_pos - cube_pos
    dist = torch.sqrt((diff * diff).sum(-1))
    touch_gripper, touch_table = flags
    dtype = cube_pos.dtype

    if task == "so100_touch_cube":
        r = torch.zeros_like(dist)
        for thresh, scale in ((0.7, 0.1), (0.5, 0.2), (0.3, 0.5), (0.1, 1.0), (0.05, 2.0)):
            r = torch.where(dist < thresh,
                            torch.maximum(r, scale * (1 - dist / thresh)), r)
        r = r + torch.where(touch_gripper, 1.0, 0.0).to(dtype)
        success = touch_gripper & (dist < 0.05)
        return torch.where(success, 4.0, r - 0.2), success

    if task == "so100_touch_cube_sparse":
        success = touch_gripper & (dist < 0.05)
        return torch.where(success, 4.0, torch.full_like(dist, -0.2)), success

    if task == "so100_cube_to_bin":
        bin_lo, bin_hi = _bin_aabb(d, ids)
        cube_half = 0.01
        over_bin = (
            (bin_lo[:, 0] < cube_pos[:, 0]) & (cube_pos[:, 0] < bin_hi[:, 0])
            & (bin_lo[:, 1] < cube_pos[:, 1]) & (cube_pos[:, 1] < bin_hi[:, 1])
        )
        inside = ((cube_pos - cube_half > bin_lo)
                  & (cube_pos + cube_half < bin_hi)).all(-1)
        released = inside & ~touch_gripper
        lifted = touch_gripper & ~touch_table
        r = torch.zeros_like(dist)
        r = torch.where(touch_gripper, 1.0, r)
        r = torch.where(lifted, 2.0, r)
        r = torch.where(over_bin, 2.5, r)
        r = torch.where(inside, 3.0, r)
        r = torch.where(released, 4.0, r)
        return r, released

    raise NotImplementedError(task)


def observations(m: Model, d: Data, s: State, ids: TaskIds):
    """Raw state obs features, batched."""
    return dict(
        qpos=s.qpos[..., :6],
        qvel=s.qvel[..., :6],
        env_state=s.qpos[..., 6:],
        box_position=d.site_xpos[..., ids.cube_site, :],
        bin_position=d.site_xpos[..., ids.bin_site, :],
        ee_position=d.site_xpos[..., ids.ee_site, :],
    )


def step_batched(m: Model, es: EnvState, actions, ids: TaskIds, task: str):
    """One control step for the batch: unnormalize actions -> 10 substeps ->
    position-stage refresh (kinematics; the reward contact flags come from
    the direct pair narrowphase) -> obs and reward.  terminated is
    reward == 4; truncation is the caller's."""
    dtype = es.physics.qpos.dtype
    act6 = C.unnormalize_so100(torch.as_tensor(actions)[..., :6].to(dtype))
    s = es.physics.replace(ctrl=act6)
    s, ncon = fwd.n_steps_batched(m, s, C.N_SUBSTEPS)
    d = smooth_lanes.kinematics(m, s).replace(ncon=ncon)
    flags = _pair_contact_flags_batched(m, d, ids)
    reward, success = task_reward(m, d, ids, task, flags)
    obs = observations(m, d, s, ids)
    terminated = reward == 4.0
    es2 = EnvState(physics=s, t=es.t + 1, box_pose=es.box_pose)
    return es2, obs, reward, terminated, d
