"""Hindsight experience replay on the device.

The port of `gym_so100_tpu/agents/her.py`.  The buffer stores whole
episodes of goal-conditioned transitions; sampling relabels a share of the
transitions with achieved goals from later in the same episode ("future"
strategy) and recomputes their rewards with `goal_env.compute_reward`.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..envs.goal_env import compute_reward, goal_distance


class HerBuffer:
    """Episode ring buffer (E episodes of T steps) for goal-conditioned
    transitions, on the device.  `ptr` (episodes written so far) and `n_eps`
    (episodes stored) are host integers, as in the replay buffer of
    `agents/sac.py`.  Rows past an episode's `ep_len` hold stale data."""

    FIELDS = ("obs", "act", "next_obs", "agoal", "dgoal", "ep_len")

    def __init__(self, episodes, T, obs_dim, act_dim, dtype=torch.float32, device="cuda"):
        device = resolve_device(device)
        z = lambda *s, dt=dtype: torch.zeros(*s, dtype=dt, device=device)
        self.obs = z(episodes, T, obs_dim)
        self.act = z(episodes, T, act_dim)
        self.next_obs = z(episodes, T, obs_dim)
        self.agoal = z(episodes, T, 3)            # achieved goal after the step
        self.dgoal = z(episodes, 3)               # the episode's desired goal
        self.ep_len = z(episodes, dt=torch.int32)
        self.ptr = 0
        self.n_eps = 0

    @property
    def episodes(self):
        return self.ep_len.shape[0]

    def add_episodes(self, mask, obs, act, next_obs, agoal, dgoal, length, n_done=None):
        """Store the episodes of the lanes where `mask` (B,) is true: obs,
        act, next_obs, agoal (B, T, ...), dgoal (B, 3), length (B,).

        The same ring as adding the finished lanes one at a time in lane
        order: the i-th finisher goes to slot (ptr + i) mod E, so when more
        than E lanes finish at once the later ones overwrite the earlier;
        only the last E are written, so that no slot is written twice.
        `n_done` is mask.sum() when the caller has read it already."""
        n_done = int(mask.sum()) if n_done is None else n_done
        if n_done == 0:
            return
        E = self.episodes
        lanes = torch.nonzero(mask).squeeze(1)[-E:]
        first = self.ptr + n_done - lanes.shape[0]
        slots = (first + torch.arange(lanes.shape[0], device=lanes.device)) % E
        for name, val in zip(self.FIELDS, (obs, act, next_obs, agoal, dgoal, length)):
            buf = getattr(self, name)
            buf[slots] = val[lanes].to(buf.dtype)
        self.ptr += n_done
        self.n_eps = min(self.n_eps + n_done, E)

    def draws(self, batch_size, generator):
        """The four random draws of one `sample`: episode ids, two raw
        integers in [0, 2^30) for the step and the future goal's offset, and
        a uniform for the relabel test."""
        dev = self.ep_len.device
        ri = lambda hi: torch.randint(0, hi, (batch_size,), generator=generator, device=dev)
        return (ri(max(self.n_eps, 1)), ri(1 << 30), ri(1 << 30),
                torch.rand(batch_size, generator=generator, device=dev))

    def sample(self, batch_size, generator=None, her_ratio=0.8, distance_threshold=0.01,
               draws=None):
        """A batch of transitions, `her_ratio` of them relabeled with a goal
        achieved at a uniform later step [t, ep_len) of the same episode.
        `draws` = (ep, t_raw, fut_raw, u) as `draws` makes them; drawn from
        `generator` when not given.  Returns dict(obs, act, rew, next_obs,
        done), obs and next_obs with the goal appended."""
        ep, t_raw, fut_raw, u = draws if draws is not None else self.draws(
            batch_size, generator)
        tl = self.ep_len[ep].clamp(min=1)
        t = t_raw % tl
        fut = t + fut_raw % (tl - t).clamp(min=1)
        relabel = u < her_ratio
        goal = torch.where(relabel[:, None], self.agoal[ep, fut], self.dgoal[ep])
        agoal = self.agoal[ep, t]
        return dict(
            obs=torch.cat([self.obs[ep, t], goal], -1),
            act=self.act[ep, t],
            rew=compute_reward(agoal, goal, distance_threshold),
            next_obs=torch.cat([self.next_obs[ep, t], goal], -1),
            done=goal_distance(agoal, goal) < distance_threshold,
        )

    def state_dict(self):
        return {**{n: getattr(self, n) for n in self.FIELDS},
                "ptr": self.ptr, "n_eps": self.n_eps}

    def load_state_dict(self, d):
        for n in self.FIELDS:
            getattr(self, n).copy_(d[n])
        self.ptr, self.n_eps = int(d["ptr"]), int(d["n_eps"])
