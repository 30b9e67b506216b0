"""The faults that the check of the program `batched_env` has to catch,
each planted in the timed path as a wrapper of the program's
`BatchedEnv.step` (`fault(step) -> step`), on a freshly built env before
its first step (`benchmark/programs/batched_env.py` `faults`).

    unchanged   the step returns its state unchanged
    half        half of the batch left unstepped (envs B/2.. keep their state)
    answer      env 0's observation replaced by env 1's
    terminal    the reset envs' terminal observation replaced by their new
                episode's first one (the classic autoreset fault)
    stale_frame (pixel observations) the reset envs' new frame not rendered:
                they get their terminal frame
    hull        every hull pair's depth zeroed in the sweep, so no hull
                contact is made (the arm's meshes against the cube, the
                table and each other); the stand-in is in place while each
                step runs, the first included, so on the card the substep
                graph captured in that step holds it
    control     the reference computed in bfloat16, the nearest precision
                below the configuration's float32, in the program's place

`for_config(config, device)` gives those that the configuration can have.
`benchmark/calibrate.py` reads them on the card at the cell's own size,
each on an env of its own, `benchmark/tests/test_bench_faults.py` on the
CPU at a few envs.
"""

from __future__ import annotations

import dataclasses

import torch

from . import check


def unchanged(step):
    def broken(es, actions, reset_box_pose=None):
        return (es,) + tuple(step(es, actions, reset_box_pose=reset_box_pose)[1:])
    return broken


def half(step):
    def broken(es, actions, reset_box_pose=None):
        out = step(es, actions, reset_box_pose=reset_box_pose)
        B = es.t.shape[0]
        keep = lambda a, b: torch.cat([b[:B // 2], a[B // 2:]])
        phys = dataclasses.replace(out[0].physics, **{
            f: keep(getattr(es.physics, f), getattr(out[0].physics, f)) for f in check.PHYS})
        return (out[0].replace(physics=phys),) + tuple(out[1:])
    return broken


def _map(obs, fn):
    return {k: fn(v) for k, v in obs.items()} if isinstance(obs, dict) else fn(obs)


def _select(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def answer(step):
    def broken(es, actions, reset_box_pose=None):
        out = list(step(es, actions, reset_box_pose=reset_box_pose))
        out[1] = _map(out[1], lambda x: torch.cat([x[1:2], x[1:]]))
        return tuple(out)
    return broken


def terminal(step):
    def broken(es, actions, reset_box_pose=None):
        es2, obs, r, term, trunc, info = step(es, actions, reset_box_pose=reset_box_pose)
        done = term | trunc
        final = info["final_obs"]
        if isinstance(obs, dict):
            final = {k: _select(done, obs[k], final[k]) for k in obs}
        else:
            final = _select(done, obs, final)
        return es2, obs, r, term, trunc, dict(info, final_obs=final)
    return broken


def stale_frame(step):
    def broken(es, actions, reset_box_pose=None):
        es2, obs, r, term, trunc, info = step(es, actions, reset_box_pose=reset_box_pose)
        done = term | trunc
        obs = dict(obs, pixels=_select(done, info["final_obs"]["pixels"], obs["pixels"]))
        return es2, obs, r, term, trunc, info
    return broken


def hull(step):
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    def broken(es, actions, reset_box_pose=None):
        sweep = hull_lanes.sweep_h

        def zeroed(p_pack, R_pack, tb):
            out = sweep(p_pack, R_pack, tb).clone()
            out[:tb.P] = 0.0
            return out
        zeroed.launches = 0           # the kernel's wrapper counts its launches here
        hull_lanes.sweep_h = zeroed
        try:
            return step(es, actions, reset_box_pose=reset_box_pose)
        finally:
            hull_lanes.sweep_h = sweep
    return broken


def control(config, device):
    low = check.Reference(config, device, torch.bfloat16)

    def make(step):
        def broken(es, actions, reset_box_pose=None):
            es2, obs, r, term, trunc, final, _ = low.env.step(
                low.envstate(check.state_only(es)), actions.to(low.dtype),
                reset_box_pose.to(low.dtype))
            return es2, obs, r, term, trunc, {"final_obs": final}
        return broken
    return make


def for_config(config, device) -> dict:
    """{name: fault} for the configuration; the control's bfloat16
    reference is built here."""
    out = {"unchanged": unchanged, "half": half, "answer": answer,
           "terminal": terminal, "hull": hull, "control": control(config, device)}
    if config["obs_mode"] == "pixels_agent_pos":
        out["stale_frame"] = stale_frame
    return out
