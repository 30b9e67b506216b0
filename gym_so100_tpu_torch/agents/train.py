"""SAC training loop: the batched env and the learner on one device.

The port of `gym_so100_tpu/agents/train.py`, on state or pixel
observations: random actions until `learning_starts`, then one policy
step, one buffer write and `utd` gradient updates per env-batch step; the
reference's stage-based entropy/LR curriculum; deterministic evaluation,
with an mp4 of env 0 when `video_dir` is set; and checkpoints of the whole
learner state (`torch.save`, with the same `sac_config.json` sidecar as
the JAX trainer).

Transitions never leave the device.  Beyond the one host sync per control
step of `BatchedEnv.step` (its any(done) test), the loop reads the device
only to write a log line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.batch import BatchedEnv
from .sac import SAC, SACConfig, SACState


@dataclasses.dataclass
class TrainConfig:
    task: str = "so100_cube_to_bin"
    num_envs: int = 64
    total_steps: int = 100_000        # env steps (per env batch step = num_envs)
    learning_starts: int = 1_000
    utd: int = 1                      # gradient updates per env batch step
    log_every: int = 50
    checkpoint_dir: str | None = None
    checkpoint_every: int = 5_000
    # full contact set by default; False drops the arm-mesh pairs
    hull_contacts: bool = True
    # contact slots of the scene built when no model is given (the JAX
    # package's default, GST_MAX_CONTACTS, is 32)
    max_contacts: int = 32
    # obs type: "state" (flat 15-dim) or "pixels_agent_pos" (top-camera
    # frames at obs_height x obs_width and the arm qpos)
    obs: str = "state"
    obs_height: int = 48
    obs_width: int = 64
    render_aux: object = None       # aux dict of build_model, for a given model
    # periodic in-training evaluation (deterministic rollouts, best-model
    # checkpoint, an mp4 of env 0's first episode)
    eval_every: int = 0             # env steps between evals; 0 = off
    eval_episodes: int = 8
    video_dir: str | None = None    # write eval_<step>.mp4 here
    # stage curriculum: tuple of (end_steps, target_entropy, lr) applied when
    # total env steps < end_steps * num_envs.  Empty = constant
    # hyperparameters; REFERENCE_STAGES is the reference's schedule.
    stages: tuple = ()


# the reference's 3-stage entropy/LR curriculum
REFERENCE_STAGES = (
    (40_000, -2.0, 1e-4),   # stage 1: high exploration
    (65_000, -3.0, 1e-4),   # stage 2: balanced
    (85_000, -7.0, 5e-5),   # stage 3: exploitation
)


class Trainer:
    """SAC trainer on the port's BatchedEnv.  `model` defaults to the SO100
    scene with `tcfg.max_contacts` contact slots; `device` defaults to the
    GPU and raises without one (device="cpu" runs the plain PyTorch
    paths).  `env_state` holds the env batch's state after the last
    env-batch step of `train`."""

    def __init__(self, model=None, tcfg: TrainConfig | None = None,
                 sac_cfg: SACConfig | None = None, device="cuda"):
        self.tcfg = tcfg = tcfg or TrainConfig()
        self.device = resolve_device(device)
        self.env = BatchedEnv(
            model, tcfg.task, tcfg.num_envs, hull_contacts=tcfg.hull_contacts,
            obs_mode=tcfg.obs, device=self.device, max_contacts=tcfg.max_contacts,
            obs_height=tcfg.obs_height, obs_width=tcfg.obs_width,
            render_aux=tcfg.render_aux,
        )
        if sac_cfg is None:
            sac_cfg = (SACConfig(obs_dim=6, pixels=(tcfg.obs_height, tcfg.obs_width))
                       if tcfg.obs == "pixels_agent_pos" else SACConfig())
        self.sac = SAC(sac_cfg, device=self.device)
        self.env_state = None
        self._eval_env = None
        self._video_renderer = None
        self._cur_stage = None
        self._best_eval = -float("inf")

    def _rollout_warmup(self, st: SACState, es, obs):
        """One env-batch step with uniform random actions (before
        learning_starts)."""
        acts = torch.rand(self.tcfg.num_envs, self.sac.cfg.act_dim,
                          generator=st.generator, device=self.device) * 2 - 1
        es2, next_obs, rew, term, trunc, info = self.env.step(es, acts)
        # boundary transitions bootstrap from the episode's true terminal obs
        self.sac.ingest(st, obs, acts, rew, info["final_obs"], term)
        return es2, next_obs, rew, info["ncon"].max()

    def _rollout(self, st: SACState, es, obs):
        """One env-batch step with the policy, then `utd` gradient updates."""
        acts = self.sac.act(st, obs)
        es2, next_obs, rew, term, trunc, info = self.env.step(es, acts)
        st, metrics = self.sac.train_step(st, obs, acts, rew, info["final_obs"], term)
        for _ in range(self.tcfg.utd - 1):
            batch = st.buffer.sample(self.sac.cfg.batch_size, st.generator)
            st, metrics = self.sac.update(st, batch)
        # contact-buffer saturation watch: active narrowphase candidates;
        # values at or above the model's K mean contacts were dropped
        return es2, next_obs, rew, dict(metrics, ncon_max=info["ncon"].max())

    def _apply_stage(self, st: SACState, env_steps):
        """Set (target_entropy, lr_scale) for the stage containing env_steps."""
        stages = self.tcfg.stages
        if not stages:
            return st
        te, lr = stages[-1][1], stages[-1][2]
        for end, s_te, s_lr in reversed(stages):
            if env_steps < end * self.tcfg.num_envs:
                te, lr = s_te, s_lr
        if self._cur_stage == (te, lr):
            return st
        self._cur_stage = (te, lr)
        st.target_entropy = float(te)
        st.lr_scale = lr / self.sac.cfg.lr
        return st

    def train(self, seed=0, progress=print, init_state: SACState | None = None):
        """Train until `tcfg.total_steps` env steps; returns the SACState.

        A restored `init_state` resumes at the env-batch step count it
        stored (`batch_steps`), so warm-up is not re-entered and checkpoint
        names continue.  (The JAX trainer derives that count from the
        gradient-update count, `step // utd`, which leaves out the warm-up
        steps; storing it repairs that.)  A resumed run draws its fresh
        episodes from the restored env generator."""
        t = self.tcfg
        resumed = init_state is not None
        st = init_state if resumed else self.sac.init(seed)
        es = self.env.reset(seed=None if resumed else seed + 1)
        obs = self.env.observe(es)
        steps = start_steps = st.batch_steps
        t0 = time.perf_counter()
        rew_acc = []
        ncon_peak = torch.zeros((), dtype=torch.int32, device=self.device)
        while steps * t.num_envs < t.total_steps:
            st = self._apply_stage(st, steps * t.num_envs)
            if steps * t.num_envs < t.learning_starts:
                es, obs, rew, ncon = self._rollout_warmup(st, es, obs)
                metrics = {}
            else:
                es, obs, rew, metrics = self._rollout(st, es, obs)
                ncon = metrics.pop("ncon_max")
            steps += 1
            st.batch_steps = steps
            self.env_state = es
            ncon_peak = torch.maximum(ncon_peak, ncon)
            rew_acc.append(rew)
            if steps % t.log_every == 0:
                line = {
                    "env_steps": steps * t.num_envs,
                    "mean_reward": round(float(torch.stack(rew_acc).mean()), 4),
                    "sps": round((steps - start_steps) * t.num_envs
                                 / (time.perf_counter() - t0), 1),
                    "ncon_peak": int(ncon_peak),
                }
                rew_acc = []
                for k, v in metrics.items():
                    line[k] = round(float(v), 4)
                progress(line)
            if t.checkpoint_dir and steps % max(1, t.checkpoint_every // t.num_envs) == 0:
                self.save(st, t.checkpoint_dir, steps * t.num_envs)
            if t.eval_every and steps % max(1, t.eval_every // t.num_envs) == 0:
                self._run_eval(st, steps * t.num_envs, progress)
        return st

    def evaluate(self, st: SACState, seed=0):
        """Deterministic-policy evaluation on a fresh env batch of its own
        (so the training env's generator is untouched).  Returns
        (mean_return, success_rate, frames) over the first
        `tcfg.eval_episodes` envs; frames, when `tcfg.video_dir` is set, are
        env 0's (240, 320, 3) uint8 top-camera frames after each step of its
        first episode (on a renderer at full mesh detail), else empty."""
        t = self.tcfg
        if self._eval_env is None:
            self._eval_env = BatchedEnv(
                self.env.m, t.task, t.num_envs,
                max_episode_steps=self.env.max_episode_steps, obs_mode=t.obs,
                device=self.device, obs_height=t.obs_height, obs_width=t.obs_width,
                render_aux=self.env.render_aux)
        env = self._eval_env
        if t.video_dir and self._video_renderer is None:
            from ..render.rasterizer import Renderer

            aux = self.env.render_aux
            if aux is None:
                raise ValueError("eval videos need render_aux (the aux dict from "
                                 "build_model) for a given model")
            self._video_renderer = Renderer(self.env.m, aux)
        es = env.reset(seed=seed + 12345)
        obs = env.observe(es)
        B = t.num_envs
        returns = torch.zeros(B, dtype=torch.float64, device=self.device)
        finished = torch.zeros(B, dtype=torch.bool, device=self.device)
        success = torch.zeros_like(finished)
        frames = []
        for _ in range(env.max_episode_steps):
            acts = self.sac.act(st, obs, deterministic=True)
            es, obs, rew, term, trunc, info = env.step(es, acts)
            returns += rew * ~finished
            success |= term & ~finished
            if t.video_dir and not bool(finished[0]):
                frames.append(self._video_renderer.render(
                    es.physics.index(0), 240, 320, "top").cpu().numpy())
            finished |= term | trunc
            if bool(finished.all()):
                break
        k = max(1, min(t.eval_episodes, B))
        return float(returns[:k].mean()), float(success[:k].double().mean()), frames

    def _run_eval(self, st, env_steps, progress):
        mean_ret, succ_rate, frames = self.evaluate(st)
        progress({
            "eval_at": env_steps,
            "eval_mean_return": round(mean_ret, 3),
            "eval_success_rate": round(succ_rate, 3),
        })
        t = self.tcfg
        if t.video_dir and frames:
            import imageio

            os.makedirs(t.video_dir, exist_ok=True)
            imageio.mimsave(os.path.join(t.video_dir, f"eval_{env_steps}.mp4"),
                            np.stack(frames), fps=50)
        if mean_ret > self._best_eval:
            self._best_eval = mean_ret
            if self.tcfg.checkpoint_dir:
                self.save(st, os.path.join(self.tcfg.checkpoint_dir, "best"), env_steps)
        return mean_ret

    # -- checkpointing -------------------------------------------------------

    def save(self, st: SACState, path, step):
        """Write `path`/ckpt_<step>.pt (the whole learner state, its
        generator and the env's) and the `path`/sac_config.json sidecar;
        returns the checkpoint's path."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "sac_config.json"), "w") as f:
            json.dump(dataclasses.asdict(self.sac.cfg), f)
        ckpt = os.path.abspath(os.path.join(path, f"ckpt_{step}.pt"))
        torch.save({"sac": self.sac.state_dict(st),
                    "env_generator": self.env.generator.get_state()}, ckpt)
        return ckpt

    def restore(self, path) -> SACState:
        """The SACState saved at `path`; also restores the env generator."""
        d = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
        self.env.generator.set_state(d["env_generator"])
        return self.sac.load_state_dict(d["sac"])

    @staticmethod
    def load_config(ckpt_path) -> SACConfig | None:
        """Read the SACConfig sidecar written next to a checkpoint."""
        cfg_file = os.path.join(os.path.dirname(os.path.abspath(ckpt_path)),
                                "sac_config.json")
        if not os.path.exists(cfg_file):
            return None
        with open(cfg_file) as f:
            raw = json.load(f)
        raw["features"] = tuple(raw.get("features", (256, 256)))
        raw["pixels"] = tuple(raw.get("pixels", ()))
        return SACConfig(**raw)
