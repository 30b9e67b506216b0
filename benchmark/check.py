"""The comparison that decides a run's `correct`.

For each checked control step of the window the harness keeps the
program's state before the step, the step's inputs and everything the
step returned.  The plain reference (`benchmark/reference/`, its own model
built from the scene's XML) then

* takes the program's state before the step and the same action and cube
  spawns, and steps it itself (10 substeps: smooth, collision with the hull
  pairs and the K rounds of selection, constraint rows, the Newton solve,
  integration; then reward, termination, truncation and the autoreset);
* works out the observations and rewards of the state the program returned
  (kinematics, the 9 reward pairs, the obs vector, or the render);
* works out the terminal observations of the envs that the step reset, from
  its own state before its autoreset, and the fresh episodes that the
  autoreset should have started.

The physics is followed step by step from the program's own state, since
float32 trajectories part by rounding over many steps; the start (the
reset) is checked by itself.  The numbers, each against its limit in the
configuration file:

  state_gap_p90  90th percentile over the checked envs of the largest
                 |program - reference| / (1 + |reference|) over qpos and
                 qvel after the step: a fault that touches most envs.
  envs_off_pct   the share (%) of the checked envs whose gap exceeds the
                 configuration's `check.off_gap`: a fault confined to a few
                 envs, such as the hull contacts of the envs whose arm
                 touches something.  Kernel and plain Newton solves part at
                 rounding-level knife edges in a few envs, so a share and
                 not the maximum; a share, so that one limit holds at any
                 width.
  answer_gap     the largest |program - reference| over the observations
                 (the state vector, or the arm qpos beside the frame) of
                 every env, and the terminal observations and rewards of
                 the envs that the step did not reset, all worked out from
                 the state the program returned.
  terminal_gap   the largest |program - reference| over the terminal
                 observations and rewards of the envs that the step reset,
                 against the reference's own step from the same state.
  reset_errors   envs whose done flags, fresh state, step count or spawn
                 do not match exactly: the reset at the start, and in each
                 checked step truncation against the step count,
                 termination against the reward, the reset envs' state
                 against a fresh episode from the given spawn, and the
                 other envs' step count and spawn.
  frame_gap      (pixel observations) the largest share of one frame's
                 pixels more than one level off, over every env's returned
                 frame and the terminal frames of the envs not reset,
                 against the reference's render of the state the program
                 returned.
  terminal_frame_gap  the same over the terminal frames of the envs reset,
                 against the render of the reference's own terminal state.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PHYS = ("qpos", "qvel", "ctrl", "mocap_pos", "mocap_quat", "qacc_warmstart")


@dataclasses.dataclass
class Outputs:
    """One control step's results as plain tensors (float32 or exact)."""

    phys: dict          # PHYS fields, (B, ...)
    t: torch.Tensor
    box_pose: torch.Tensor
    obs: object         # (B, 15) or {"pixels", "agent_pos"}
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    final_obs: object
    terminal: object = None   # the reference's state before its autoreset


def _f32(x):
    if isinstance(x, dict):
        return {k: _f32(v) for k, v in x.items()}
    if x is None or not torch.is_floating_point(x):
        return x
    return x.to(torch.float32)


def outputs_of(es, obs, reward, terminated, truncated, final_obs) -> Outputs:
    """Outputs from what an env step returned (the program's or a
    stand-in's; any object with `.physics`, `.t`, `.box_pose`)."""
    return Outputs(
        phys={f: _f32(getattr(es.physics, f)).clone() for f in PHYS},
        t=es.t.clone(), box_pose=_f32(es.box_pose).clone(), obs=_f32(obs),
        reward=_f32(reward), terminated=terminated, truncated=truncated,
        final_obs=_f32(final_obs))


@dataclasses.dataclass
class Record:
    """A checked control step: the state before it (`before`, an Outputs
    with only phys, t and box_pose meaningful), its inputs and the
    program's results."""

    index: int
    before: Outputs
    actions: torch.Tensor
    poses: torch.Tensor
    out: Outputs = None


def state_only(es) -> Outputs:
    return Outputs(phys={f: _f32(getattr(es.physics, f)).clone() for f in PHYS},
                   t=es.t.clone(), box_pose=_f32(es.box_pose).clone(), obs=None,
                   reward=None, terminated=None, truncated=None, final_obs=None)


class Reference:
    """The plain reference of a configuration, in `dtype`, on `device`."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        from .reference.batch import RefEnv
        from .reference.envs import core
        from .reference.models import scene
        from .reference.models.builder import build_model

        self.core, self.scene = core, scene
        self.dtype = dtype
        m, aux = build_model(str(ROOT / cfg["scene_xml"]),
                             max_contacts=cfg["max_contacts"], device=device, dtype=dtype)
        if not cfg["hull_contacts"]:
            raise ValueError("the reference steps the scene with its hull contacts")
        self.env = RefEnv(m, aux, cfg["task"], cfg["episode_steps"], obs_mode=cfg["obs_mode"],
                          obs_height=cfg["obs_height"], obs_width=cfg["obs_width"],
                          tris_per_mesh=cfg["tris_per_mesh"])
        self.pixels = cfg["obs_mode"] == "pixels_agent_pos"

    def envstate(self, o: Outputs):
        cast = lambda x: x.to(self.dtype) if torch.is_floating_point(x) else x
        phys = self.scene.State(**{f: cast(o.phys[f]) for f in PHYS})
        return self.core.EnvState(physics=phys, t=o.t, box_pose=cast(o.box_pose))

    def step(self, rec: Record, observe=True) -> Outputs:
        """The reference's own control step from the program's state, with
        its state before the autoreset in `terminal`."""
        es2, obs, reward, term, trunc, final, terminal = self.env.step(
            self.envstate(rec.before), rec.actions.to(self.dtype),
            rec.poses.to(self.dtype), observe=observe)
        out = outputs_of(es2, obs, reward, term, trunc, final)
        out.terminal = state_only(terminal)
        return out

    def reset(self, poses, t=None) -> Outputs:
        es = self.env.reset(poses.to(self.dtype))
        if t is not None:
            es = es.replace(t=t)
        return state_only(es)

    def observe(self, o: Outputs):
        return _f32(self.env.observe(self.envstate(o)))

    def reward(self, o: Outputs):
        return self.env.reward(self.envstate(o))[0].to(torch.float32)

    def hull_envs(self, o: Outputs) -> int:
        """The envs of state `o` with an active hull pair."""
        from .reference.models.scene import Data
        from .reference.ops import smooth_lanes
        from .reference.ops.collision import hull_lanes

        m = self.env.m
        sl = smooth_lanes.forward_smooth_lanes(m, self.envstate(o).physics)
        d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
                 site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"],
                 subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"])
        return int(hull_lanes.collide_hulls_lanes(m, d, lanes_out=True)[3].any(0).sum())


def _rows_equal(a: Outputs, b: Outputs):
    """(B,) whether each env's state, step count and spawn are equal."""
    eq = (a.t == b.t) & (a.box_pose == b.box_pose).all(1)
    for f in PHYS:
        eq &= (a.phys[f] == b.phys[f]).flatten(1).all(1)
    return eq


def take(o: Outputs, mask) -> Outputs:
    """The envs `mask` of a state (phys, t, box_pose)."""
    return Outputs(phys={f: o.phys[f][mask] for f in PHYS}, t=o.t[mask],
                   box_pose=o.box_pose[mask], obs=None, reward=None,
                   terminated=None, truncated=None, final_obs=None)


def _gap(a, b):
    d = (a - b).abs()
    return float(torch.nan_to_num(d, nan=torch.inf).max()) if d.numel() else 0.0


def _rows(obs, mask):
    if isinstance(obs, dict):
        return {k: v[mask] for k, v in obs.items()}
    return obs[mask]


def frame_shares(a, b):
    """(N,) each frame's share of pixels more than one level off."""
    if not a.shape[0]:
        return torch.zeros(0)
    off = ((a.to(torch.int16) - b.to(torch.int16)).abs() > 1).any(-1)
    return off.flatten(1).double().mean(1)


class Tally:
    """The numbers over the checked steps of one run; `off_gap` is the
    state gap above which an env counts in `envs_off_pct`."""

    def __init__(self, pixels: bool, off_gap: float):
        self.pixels = pixels
        self.off_gap = off_gap
        self.gaps = []
        self.answer = 0.0
        self.terminal = 0.0
        self.reset_errors = 0
        self.frame = 0.0
        self.terminal_frame = 0.0
        self.steps = 0
        self.done = 0
        self.mine = []            # the reference's own steps, in order

    def start(self, ref: Reference, before: Outputs, poses, ages):
        """The program's reset against the reference's."""
        self.reset_errors += int((~_rows_equal(before, ref.reset(poses, ages))).sum())

    def add(self, ref: Reference, rec: Record, out: Outputs, mine: Outputs):
        """One checked step: `out` what the program (or a stand-in in its
        place) returned, `mine` the reference's own step from rec.before."""
        self.steps += 1
        self.mine.append(mine)
        x = torch.cat([out.phys["qpos"], out.phys["qvel"]], 1)
        xr = torch.cat([mine.phys["qpos"], mine.phys["qvel"]], 1)
        g = ((x - xr).abs() / (1 + xr.abs())).amax(1)
        self.gaps.append(torch.nan_to_num(g, nan=torch.inf))

        done = out.terminated | out.truncated
        keep = ~done
        self.done += int(done.sum())
        seen = ref.observe(out)
        vec = (lambda o: o["agent_pos"]) if self.pixels else (lambda o: o)
        self.answer = max(self.answer, _gap(vec(out.obs), vec(seen)),
                          _gap(vec(out.final_obs)[keep], vec(seen)[keep]),
                          _gap(out.reward[keep], ref.reward(out)[keep]))
        if self.pixels:
            for a, b in ((out.obs, seen), (_rows(out.final_obs, keep), _rows(seen, keep))):
                self.frame = max([self.frame] + frame_shares(a["pixels"], b["pixels"]).tolist())
        if bool(done.any()):
            last = ref.observe(take(mine.terminal, done))
            self.terminal = max(self.terminal, _gap(vec(out.final_obs)[done], vec(last)),
                                _gap(out.reward[done], mine.reward[done]))
            if self.pixels:
                self.terminal_frame = max([self.terminal_frame] + frame_shares(
                    out.final_obs["pixels"][done], last["pixels"]).tolist())

        limit = ref.env.max_episode_steps
        t_next = rec.before.t + 1
        bad = out.truncated != (t_next >= limit)
        bad |= out.terminated != (out.reward == 4.0)
        fresh = ref.reset(rec.poses, torch.zeros_like(rec.before.t))
        bad |= done & ~_rows_equal(out, fresh)
        bad |= keep & ((out.t != t_next) | (out.box_pose != rec.before.box_pose).any(1))
        self.reset_errors += int(bad.sum())

    def numbers(self) -> dict:
        gaps = torch.cat(self.gaps) if self.gaps else torch.full((1,), torch.inf)
        out = {
            "state_gap_p90": float(torch.quantile(gaps.double().clamp(max=1e30), 0.9)),
            "envs_off_pct": 100.0 * int((gaps > self.off_gap).sum()) / gaps.numel(),
            "answer_gap": self.answer,
            "terminal_gap": self.terminal,
            "reset_errors": self.reset_errors,
        }
        if self.pixels:
            out["frame_gap"] = self.frame
            out["terminal_frame_gap"] = self.terminal_frame
        return out


def judge(numbers: dict, limits: dict, steps_checked: int):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and at least one step checked."""
    rows = [(k, numbers[k], limits[k]) for k in numbers]
    ok = steps_checked > 0 and all(v <= lim for _, v, lim in rows)
    return ok, rows
