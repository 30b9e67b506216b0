"""SAC+HER training: batched goal-conditioned envs and the learner on one device.

The port of `gym_so100_tpu/agents/train_her.py`.  The goal env runs
batched: goal sampling and the 5000-total-step curriculum (near-cube goals
first, then the bin interior) act on the whole env batch; episodes are
staged per env lane and flushed into the episode `HerBuffer` when they end,
so the "future" relabeling happens at sample time on the device; the
learner's observation is concat(state obs, goal).

Every random draw comes from a generator: the env's (cube spawns, goals)
and the SAC state's (warm-up actions, policy noise, buffer samples, update
noise).  Each can be injected instead (`_do_step`'s `draws`), so that a test
can feed another implementation's draws.  One host read per env-batch step,
the number of finished episodes, decides the autoreset and the flush.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from ..device import resolve_device
from ..envs import constants as C
from ..envs import core
from ..envs.goal_env import compute_reward, goal_distance
from ..parallel.batch import BatchedEnv, _where
from .her import HerBuffer
from .sac import SAC, SACConfig, SACState

GOAL_DIM = 3
T_MAX = 300        # the reference GoalEnv's own episode limit
TASK = "so100_cube_to_bin"


@dataclasses.dataclass
class GoalEnvState:
    """Batched goal-conditioned env state."""

    es: core.EnvState          # batched physics env state
    goal: torch.Tensor         # (B, 3) float32
    t: torch.Tensor            # (B,) int32 step in the episode
    total: int                 # env steps taken by the batch (curriculum clock)


@dataclasses.dataclass
class HERTrainState:
    sac: SACState
    her: HerBuffer
    genv: GoalEnvState
    # per-env episode staging
    st_obs: torch.Tensor       # (B, T, obs_dim)
    st_act: torch.Tensor       # (B, T, act_dim)
    st_next: torch.Tensor      # (B, T, obs_dim)
    st_agoal: torch.Tensor     # (B, T, 3)


@dataclasses.dataclass
class HERConfig:
    num_envs: int = 32
    total_steps: int = 200_000
    learning_starts: int = 1_000
    her_episodes: int = 256            # episode capacity
    her_ratio: float = 0.8             # n_sampled_goal=4 -> 4/5 relabeled
    utd: int = 1                       # gradient updates per env-batch step
    distance_threshold: float = 0.01
    curriculum_steps: int = 5_000
    log_every: int = 50
    checkpoint_dir: str | None = None
    checkpoint_every: int = 20_000
    hull_contacts: bool = True         # full contact set
    max_episode_steps: int = T_MAX
    # minimum distance between a sampled goal and the cube's rest site
    # estimate: goals closer than this are pushed radially out, so that no
    # episode succeeds without moving the cube (0 = the reference behavior)
    goal_min_dist: float = 0.0
    # contact slots of the scene built when no model is given
    max_contacts: int = 32


def sample_goal(u, box_pose, total, curriculum_steps, goal_min_dist=0.0):
    """Goals (B, 3) from uniforms u (B, 3): within +-0.03 xy of the cube
    spawn `box_pose` (B, 7) and z in [0.01, 0.05] while the total env step
    count `total` is below `curriculum_steps`, else in the bin's interior;
    with `goal_min_dist` > 0, goals within that distance of the cube's rest
    site (spawn xy + the 0.01 site offset, z 0.03) are pushed radially out
    to it.  In box_pose's dtype."""
    dtype, dev = box_pose.dtype, box_pose.device
    u = u.to(dtype)
    B = box_pose.shape[0]
    col = lambda v: torch.full((B,), v, dtype=dtype, device=dev)
    if total < curriculum_steps:
        lo = torch.stack([box_pose[:, 0] - 0.03, box_pose[:, 1] - 0.03, col(0.01)], -1)
        hi = torch.stack([box_pose[:, 0] + 0.03, box_pose[:, 1] + 0.03, col(0.05)], -1)
    else:
        lo = torch.tensor([C.bin_min[0] + 0.005, C.bin_min[1] + 0.005, 0.01],
                          dtype=dtype, device=dev)
        hi = torch.tensor([C.bin_max[0] - 0.005, C.bin_max[1] - 0.005, 0.05],
                          dtype=dtype, device=dev)
    g = lo + u * (hi - lo)
    if goal_min_dist > 0.0:
        rest = torch.stack([box_pose[:, 0] + 0.01, box_pose[:, 1] + 0.01, col(0.03)], -1)
        delta = g - rest
        dist = goal_distance(g, rest)[:, None]
        g = torch.where(dist < goal_min_dist,
                        rest + delta * (goal_min_dist / dist.clamp(min=1e-6)), g)
    return g


class HERTrainer:
    """SAC+HER on batched goal envs (the cube_to_bin scene).  `model`
    defaults to the SO100 scene with `cfg.max_contacts` contact slots;
    `device` defaults to the GPU and raises without one (device="cpu" runs
    the plain PyTorch paths)."""

    def __init__(self, model=None, cfg: HERConfig | None = None,
                 sac_cfg: SACConfig | None = None, device="cuda"):
        self.cfg = cfg = cfg or HERConfig()
        self.device = resolve_device(device)
        self.env = BatchedEnv(model, TASK, cfg.num_envs, hull_contacts=cfg.hull_contacts,
                              device=self.device, max_contacts=cfg.max_contacts)
        self.m = self.env.m
        self.obs_dim = 15          # the state obs vector (box, bin, ee, qpos)
        self.sac = SAC(sac_cfg or SACConfig(obs_dim=self.obs_dim + GOAL_DIM, act_dim=6,
                                            lr=1e-4, buffer_size=1, batch_size=256),
                       device=self.device)

    # -- goal env mechanics --------------------------------------------------

    def _goals(self, box_pose, total, u=None):
        if u is None:
            u = torch.rand(box_pose.shape[0], GOAL_DIM, generator=self.env.generator,
                           dtype=self.m.dtype, device=self.env.generator.device)
        u = torch.as_tensor(u, device=self.device)
        return sample_goal(u, box_pose, total, self.cfg.curriculum_steps,
                           self.cfg.goal_min_dist).to(torch.float32)

    def reset(self, seed=None, box_pose=None, goal_u=None) -> GoalEnvState:
        """Fresh episodes and goals for every env: cube spawns from
        `box_pose` and goals from the uniforms `goal_u` (B, 3) when given,
        else from the env's generator (reseeded by `seed`)."""
        es = self.env.reset(seed=seed, box_pose=box_pose)
        B = self.cfg.num_envs
        return GoalEnvState(
            es=es, goal=self._goals(es.box_pose, 0, goal_u),
            t=torch.zeros(B, dtype=torch.int32, device=self.device), total=0)

    def _goal_step(self, genv: GoalEnvState, actions, spawn=None, goal_u=None):
        """One goal-conditioned env step; the done envs (success, or the
        episode limit) restart with a fresh cube spawn and a fresh goal.
        Returns (genv2, next_obs, agoal, reward, success, done, t_after,
        n_done, ncon); next_obs and agoal are the step's own, before any
        reset; ncon (B,) the contact-candidate watch."""
        cfg = self.cfg
        es2, obs, _, _, d = core.step_batched(self.m, genv.es, actions, self.env.ids, TASK)
        next_obs = self.env._obs_vector(obs)
        agoal = d.site_xpos[:, self.env.ids.cube_site].to(torch.float32)
        reward = compute_reward(agoal, genv.goal, cfg.distance_threshold)
        success = reward >= 0.0
        t2 = genv.t + 1
        done = success | (t2 >= cfg.max_episode_steps)
        n_done = int(done.sum())           # the step's one host read
        es3, goal2 = es2, genv.goal
        if n_done:
            if spawn is None:
                spawn = self.env._spawn()
            fresh = core.reset(self.m, torch.as_tensor(spawn, dtype=self.m.dtype,
                                                       device=self.device))
            es3 = _where(done, fresh, es2)
            goal2 = torch.where(done[:, None],
                                self._goals(es3.box_pose, genv.total, goal_u), genv.goal)
        genv2 = GoalEnvState(es=es3, goal=goal2, t=torch.where(done, 0, t2),
                             total=genv.total + cfg.num_envs)
        return genv2, next_obs, agoal, reward, success, done, t2, n_done, d.ncon

    # -- train step ----------------------------------------------------------

    def _do_step(self, ts: HERTrainState, learn: bool, draws=None):
        """One env-batch step: act (uniform random actions, or the policy
        when `learn`), step the goal envs, stage the transitions, flush the
        finished episodes into the HER buffer, then (when `learn`) `utd`
        SAC updates on HER samples, skipped while the buffer holds no
        episode.  The learner's state is updated in place.

        `draws` may give any of: "actions" (B, 6) for a warm-up step,
        "act_noise" (B, 6) for a policy step, "spawn" (B, 7), "goal_u"
        (B, 3), and "updates", a list of (buffer draws, (eps_next,
        eps_actor)) per update.  Returns (ts, reward, success, metrics)."""
        cfg, sac = self.cfg, self.sac
        draws = draws or {}
        st = ts.sac
        B = cfg.num_envs
        obs = self.env.observe(ts.genv.es)
        obs_goal = torch.cat([obs, ts.genv.goal], -1)
        st.normalizer.update(obs_goal)
        if learn:
            acts = sac.act(st, obs_goal, noise=draws.get("act_noise"))
        elif "actions" in draws:
            acts = torch.as_tensor(draws["actions"], device=self.device)
        else:
            acts = torch.rand(B, 6, generator=st.generator, device=self.device) * 2 - 1

        t_before = ts.genv.t
        genv2, next_obs, agoal, reward, success, done, t_after, n_done, ncon = self._goal_step(
            ts.genv, acts, draws.get("spawn"), draws.get("goal_u"))

        lanes = torch.arange(B, device=self.device)
        t_idx = t_before.long()
        for buf, val in ((ts.st_obs, obs), (ts.st_act, acts), (ts.st_next, next_obs),
                         (ts.st_agoal, agoal)):
            buf[lanes, t_idx] = val.to(buf.dtype)
        ts.her.add_episodes(done, ts.st_obs, ts.st_act, ts.st_next, ts.st_agoal,
                            ts.genv.goal, t_after, n_done=n_done)

        metrics = {}
        if learn:
            upd = draws.get("updates") or [(None, None)] * max(1, cfg.utd)
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            for buf_draws, noise in upd:
                if ts.her.n_eps == 0:
                    metrics = dict(critic_loss=zero, actor_loss=zero,
                                   alpha=st.log_alpha.detach().exp().float(), entropy=zero)
                    continue
                batch = ts.her.sample(sac.cfg.batch_size, st.generator, cfg.her_ratio,
                                      cfg.distance_threshold, draws=buf_draws)
                st, m = sac.update(st, batch, noise)
                metrics = {k: v.float() for k, v in m.items()}
        moved = goal_distance(agoal[:, :2], ts.genv.es.box_pose[:, :2]) > 0.005
        metrics.update(
            goal_dist=goal_distance(agoal, ts.genv.goal).mean(),
            cube_moved_frac=moved.float().mean(),
            ep_done=done.float().sum(),
            ep_succ=success.float().sum(),
            # contact-buffer saturation watch: values at or above K mean
            # contacts were dropped
            ncon_max=ncon.max(),
        )
        ts.sac, ts.genv = st, genv2
        return ts, reward, success, metrics

    # -- loop ----------------------------------------------------------------

    def init(self, seed=0) -> HERTrainState:
        """Fresh learner (SAC init from `seed`), empty HER buffer and
        staging, and fresh episodes from the env generator seeded seed + 1."""
        cfg = self.cfg
        B, T = cfg.num_envs, cfg.max_episode_steps
        z = lambda *s: torch.zeros(*s, dtype=torch.float32, device=self.device)
        return HERTrainState(
            sac=self.sac.init(seed),
            her=HerBuffer(cfg.her_episodes, T, self.obs_dim, 6, device=self.device),
            genv=self.reset(seed=seed + 1),
            st_obs=z(B, T, self.obs_dim), st_act=z(B, T, 6),
            st_next=z(B, T, self.obs_dim), st_agoal=z(B, T, GOAL_DIM),
        )

    def train(self, seed=0, progress=print, init_state: HERTrainState | None = None):
        """Train until `cfg.total_steps` env steps; returns the state.

        A restored `init_state` resumes at the env-batch step its curriculum
        clock has reached (total // num_envs), so warm-up is not re-entered
        past `learning_starts` and checkpoint names continue.  (The JAX
        trainer restarts its loop counter at 0 on resume.)"""
        cfg = self.cfg
        ts = init_state if init_state is not None else self.init(seed)
        steps = start = ts.genv.total // cfg.num_envs
        t0 = time.perf_counter()
        rew_acc, succ_acc, epd_acc, eps_acc = [], [], [], []
        ncon_peak = torch.zeros((), dtype=torch.int32, device=self.device)
        while steps * cfg.num_envs < cfg.total_steps:
            learn = steps * cfg.num_envs >= cfg.learning_starts
            ts, rew, succ, metrics = self._do_step(ts, learn)
            steps += 1
            rew_acc.append(rew)
            succ_acc.append(succ)
            epd_acc.append(metrics.pop("ep_done"))
            eps_acc.append(metrics.pop("ep_succ"))
            ncon_peak = torch.maximum(ncon_peak, metrics.pop("ncon_max"))
            if steps % cfg.log_every == 0:
                n_done = float(torch.stack(epd_acc).sum())
                n_succ = float(torch.stack(eps_acc).sum())
                line = {
                    "env_steps": steps * cfg.num_envs,
                    "mean_reward": round(float(torch.stack(rew_acc).mean()), 4),
                    "success_rate": round(float(torch.stack(succ_acc).float().mean()), 4),
                    "ep_success_rate": round(n_succ / max(n_done, 1.0), 4),
                    "episodes_done": int(n_done),
                    "episodes_stored": ts.her.n_eps,
                    "sps": round((steps - start) * cfg.num_envs
                                 / (time.perf_counter() - t0), 1),
                    "ncon_peak": int(ncon_peak),
                }
                for k, v in metrics.items():
                    line[k] = round(float(v), 4)
                progress(line)
                rew_acc, succ_acc, epd_acc, eps_acc = [], [], [], []
            if cfg.checkpoint_dir and steps % max(1, cfg.checkpoint_every // cfg.num_envs) == 0:
                self.save(ts, cfg.checkpoint_dir, steps * cfg.num_envs)
        return ts

    # -- checkpoints ---------------------------------------------------------

    def state_dict(self, ts: HERTrainState) -> dict:
        """Everything of `ts` and the env generator (torch.save-able)."""
        g = ts.genv
        return dict(
            sac=self.sac.state_dict(ts.sac), her=ts.her.state_dict(),
            genv=dict(physics={f.name: getattr(g.es.physics, f.name)
                                for f in dataclasses.fields(g.es.physics)},
                      t_env=g.es.t,
                      box_pose=g.es.box_pose, goal=g.goal, t=g.t, total=g.total),
            staging=dict(obs=ts.st_obs, act=ts.st_act, next=ts.st_next, agoal=ts.st_agoal),
            env_generator=self.env.generator.get_state(),
        )

    def load_state_dict(self, d: dict) -> HERTrainState:
        """The state that `state_dict` saved, on this trainer's device; also
        restores the env generator."""
        ts = self.init(0)
        ts.sac = self.sac.load_state_dict(d["sac"])
        ts.her.load_state_dict(d["her"])
        dev = lambda x: x.to(self.device)
        g = d["genv"]
        physics = type(ts.genv.es.physics)(**{k: dev(v) for k, v in g["physics"].items()})
        ts.genv = GoalEnvState(
            es=core.EnvState(physics=physics, t=dev(g["t_env"]), box_pose=dev(g["box_pose"])),
            goal=dev(g["goal"]), t=dev(g["t"]), total=int(g["total"]))
        st = d["staging"]
        ts.st_obs, ts.st_act = dev(st["obs"]), dev(st["act"])
        ts.st_next, ts.st_agoal = dev(st["next"]), dev(st["agoal"])
        self.env.generator.set_state(d["env_generator"])
        return ts

    def save(self, ts: HERTrainState, path, step):
        """Write `path`/her_ckpt_<step>.pt; returns its path."""
        os.makedirs(path, exist_ok=True)
        ckpt = os.path.abspath(os.path.join(path, f"her_ckpt_{step}.pt"))
        torch.save(self.state_dict(ts), ckpt)
        return ckpt

    def restore(self, path) -> HERTrainState:
        """The state saved at `path` (and the env generator's)."""
        return self.load_state_dict(torch.load(os.path.abspath(path), map_location="cpu",
                                               weights_only=True))
