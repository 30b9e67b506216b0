"""SAC learner: networks, replay buffer and updates.

The port of `gym_so100_tpu/agents/sac.py`: twin Q critics, a
tanh-squashed Gaussian actor, automatic entropy tuning against
`target_entropy`, Polyak target updates and running obs normalization
(clip 10).  Observations are flat state vectors, or, with
`SACConfig.pixels` = (H, W), dicts {"pixels": (H, W, 3) uint8,
"agent_pos": (obs_dim,)} read through a NatureCNN encoder (the actor has
its own, the twin critics share one) and stored as uint8 in the replay
buffer.  The replay buffer, the normalizer and the networks live on one
device; every random draw comes from the state's own `torch.Generator`.

The state is mutable: `update`, `train_step` and `ingest` change the
`SACState` they are given in place and return it.  Layouts and init follow
the Flax modules of the JAX package, so `agents/convert.py` carries a JAX
state across: a torch weight is the transpose of a Flax kernel, kernels
start LeCun-normal (truncated at two standard deviations), biases at zero;
convolutions pad as Flax's "SAME" does, and the CNN's features are
flattened in Flax's (H, W, C) order.
Adam runs with optax's defaults (betas 0.9/0.999, eps 1e-8).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device

LOG_2PI = math.log(2 * math.pi)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """Flax's default Dense and Conv kernel init on a torch (out, in) or
    (out, in, kh, kw) weight: a normal of variance 1/fan_in (fan_in = in *
    kh * kw) truncated to two standard deviations (drawn by inverting the
    normal CDF of a uniform, as jax.random.truncated_normal does)."""
    std = math.sqrt(1.0 / math.prod(weight.shape[1:])) / 0.87962566103423978
    lo = math.erf(-2.0 / math.sqrt(2.0))
    u = torch.empty_like(weight).uniform_(lo, -lo, generator=generator)
    with torch.no_grad():
        weight.copy_(torch.clamp(torch.erfinv(u) * math.sqrt(2.0), -2.0, 2.0) * std)


def _linear(n_in, n_out, device, dtype):
    # no default init: that would draw from torch's global generator
    return torch.nn.utils.skip_init(nn.Linear, n_in, n_out, device=device or "cpu",
                                    dtype=dtype)


class MLP(nn.Module):
    """Hidden layers of `features` with ReLU, then a linear output."""

    def __init__(self, n_in, features, n_out, device=None, dtype=None):
        super().__init__()
        dims = (n_in, *features)
        self.hidden = nn.ModuleList(
            _linear(a, b, device, dtype) for a, b in zip(dims[:-1], dims[1:]))
        self.out = _linear(dims[-1], n_out, device, dtype)

    def layers(self):
        return [*self.hidden, self.out]

    def forward(self, x):
        for lin in self.hidden:
            x = torch.relu(lin(x))
        return self.out(x)


# XLA compiles the JAX package's `uint8 / 255.0` in float32 as a product
# with the float32 reciprocal (the two differ by one ulp for 126 of the 256
# values), so the port multiplies too
INV_255 = float(np.float32(1.0 / 255.0))


def unit_pixels(pixels, dtype):
    """uint8 frames -> floats in [0, 1], computed in float32, as `dtype`."""
    return (pixels.to(torch.float32) * INV_255).to(dtype)


def same_padding(size, kernel, stride):
    """(low, high) padding of one spatial axis under XLA's "SAME": the
    output has ceil(size / stride) entries and the low side gets the
    smaller half of the total."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class NatureCNN(nn.Module):
    """The NatureCNN image encoder of the JAX package: conv 32 8x8/4, 64
    4x4/2 and 64 3x3/1, each with ReLU and "SAME" padding, flattened in
    (H, W, C) order, then Dense `out` and ReLU.  Takes (..., H, W, 3)
    images in [0, 1]."""

    LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))     # (channels, kernel, stride)

    def __init__(self, height, width, out=256, device=None, dtype=None):
        super().__init__()
        convs, self.pads = [], []
        c_in, h, w = 3, height, width
        for c_out, k, stride in self.LAYERS:
            convs.append(torch.nn.utils.skip_init(
                nn.Conv2d, c_in, c_out, k, stride=stride, device=device or "cpu",
                dtype=dtype))
            ph, pw = same_padding(h, k, stride), same_padding(w, k, stride)
            self.pads.append((*pw, *ph))                 # F.pad: (left, right, top, bottom)
            c_in, h, w = c_out, -(-h // stride), -(-w // stride)
        self.convs = nn.ModuleList(convs)
        self.dense = _linear(c_in * h * w, out, device, dtype)

    def layers(self):
        return [*self.convs, self.dense]

    def forward(self, img):
        lead = img.shape[:-3]
        x = img.reshape(-1, *img.shape[-3:]).permute(0, 3, 1, 2)
        for conv, pad in zip(self.convs, self.pads):
            x = torch.relu(conv(F.pad(x, pad)))
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)
        return torch.relu(self.dense(x))


class Encoder(nn.Module):
    """Pixel obs front end: the CNN's features, then agent_pos."""

    def __init__(self, pixels, device=None, dtype=None):
        super().__init__()
        self.cnn = NatureCNN(*pixels, device=device, dtype=dtype)

    def forward(self, obs):
        return torch.cat([self.cnn(obs["pixels"]), obs["agent_pos"]], dim=-1)


def _encoder(pixels, obs_dim, device, dtype):
    """(encoder or None, width of the encoded obs)."""
    if not pixels:
        return None, obs_dim
    enc = Encoder(pixels, device, dtype)
    return enc, enc.cnn.dense.out_features + obs_dim


class Actor(nn.Module):
    """obs -> (mean, log_std), the head split [mean | log_std] and log_std
    clipped to [log_std_min, log_std_max].  With `pixels` = (H, W) the obs
    is the pixel dict, read through the actor's own Encoder."""

    def __init__(self, obs_dim, act_dim, features=(256, 256), log_std_min=-20.0,
                 log_std_max=2.0, pixels=(), device=None, dtype=None):
        super().__init__()
        self.act_dim = act_dim
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        self.encoder, n_in = _encoder(pixels, obs_dim, device, dtype)
        self.mlp = MLP(n_in, features, 2 * act_dim, device, dtype)

    def mlps(self):
        return [self.mlp]

    def forward(self, obs):
        x = obs if self.encoder is None else self.encoder(obs)
        mean, log_std = self.mlp(x).split(self.act_dim, dim=-1)
        return mean, torch.clamp(log_std, self.log_std_min, self.log_std_max)


class Critic(nn.Module):
    """Twin Q: (obs, act) -> (q1, q2), each (batch,).  With `pixels` the
    two Q heads share one Encoder."""

    def __init__(self, obs_dim, act_dim, features=(256, 256), pixels=(),
                 device=None, dtype=None):
        super().__init__()
        self.encoder, n_in = _encoder(pixels, obs_dim, device, dtype)
        self.q1 = MLP(n_in + act_dim, features, 1, device, dtype)
        self.q2 = MLP(n_in + act_dim, features, 1, device, dtype)

    def mlps(self):
        return [self.q1, self.q2]

    def forward(self, obs, act):
        enc = obs if self.encoder is None else self.encoder(obs)
        x = torch.cat([enc, act], dim=-1)
        return self.q1(x)[..., 0], self.q2(x)[..., 0]


def init_flax_(module: nn.Module, generator: torch.Generator):
    """Initialise every layer of an Actor or Critic as Flax's Dense and Conv
    do."""
    layers = [] if module.encoder is None else module.encoder.cnn.layers()
    for mlp in module.mlps():
        layers += mlp.layers()
    for layer in layers:
        lecun_normal_(layer.weight, generator)
        with torch.no_grad():
            layer.bias.zero_()


def sample_action(actor: Actor, obs, eps):
    """tanh-squashed Gaussian sample and its log-prob, from the standard
    normal draw `eps` (shaped like the action)."""
    mean, log_std = actor(obs)
    act = torch.tanh(mean + torch.exp(log_std) * eps)
    logp = (
        -0.5 * (eps**2 + 2 * log_std + LOG_2PI)
        - torch.log(torch.clamp(1 - act**2, min=1e-6))
    ).sum(-1)
    return act, logp


def det_action(actor: Actor, obs):
    mean, _ = actor(obs)
    return torch.tanh(mean)


class Normalizer:
    """Running obs mean/var (population variance, count starting at 1e-4),
    applied as clip((obs - mean) / sqrt(var + 1e-8), +-10)."""

    def __init__(self, mean, var, count):
        self.mean, self.var, self.count = mean, var, count

    @staticmethod
    def create(dim, dtype=torch.float32, device="cuda"):
        device = resolve_device(device)
        return Normalizer(
            mean=torch.zeros(dim, dtype=dtype, device=device),
            var=torch.ones(dim, dtype=dtype, device=device),
            count=torch.tensor(1e-4, dtype=dtype, device=device),
        )

    def update(self, batch):
        """Merge the statistics of `batch` (n, dim) in place."""
        bmean = batch.mean(0)
        bvar = batch.var(0, correction=0)
        bcount = batch.shape[0]
        delta = bmean - self.mean
        tot = self.count + bcount
        mean = self.mean + delta * bcount / tot
        m2 = self.var * self.count + bvar * bcount + delta**2 * self.count * bcount / tot
        self.mean, self.var, self.count = mean, m2 / tot, tot

    def norm(self, obs, clip=10.0):
        return torch.clamp((obs - self.mean) / torch.sqrt(self.var + 1e-8), -clip, clip)

    def tensors(self):
        return {"mean": self.mean, "var": self.var, "count": self.count}


def _map_obs(fn, obs, *rest):
    """fn applied to a flat obs tensor, or to each entry of an obs dict."""
    if isinstance(obs, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in obs.items()}
    return fn(obs, *rest)


class ReplayBuffer:
    """Fixed-capacity ring buffer of transitions on the device.  `ptr` and
    `size` are host integers (they depend only on batch sizes), so writing
    and sampling never wait for the device.

    `obs_spec` is the flat obs width, or a dict name -> (shape, dtype) for
    dict observations (the pixel obs keeps its frames as uint8)."""

    FIELDS = ("obs", "act", "rew", "next_obs", "done")

    def __init__(self, capacity, obs_spec, act_dim, dtype=torch.float32, device="cuda"):
        device = resolve_device(device)
        z = lambda *s, dt=dtype: torch.zeros(*s, dtype=dt, device=device)
        if isinstance(obs_spec, int):
            mk = lambda: z(capacity, obs_spec)
        else:
            mk = lambda: {k: z(capacity, *sh, dt=dt) for k, (sh, dt) in obs_spec.items()}
        self.obs = mk()
        self.act = z(capacity, act_dim)
        self.rew = z(capacity)
        self.next_obs = mk()
        self.done = z(capacity, dt=torch.bool)     # terminal (not truncation)
        self.ptr = 0
        self.size = 0

    @property
    def capacity(self):
        return self.act.shape[0]

    def add_batch(self, obs, act, rew, next_obs, done):
        """Write a batch of B transitions at the ring pointer."""
        B, cap = act.shape[0], self.capacity
        idx = (self.ptr + torch.arange(B, device=self.act.device)) % cap

        def put(buf, val):
            buf[idx] = val.to(buf.dtype)

        for name, val in zip(self.FIELDS, (obs, act, rew, next_obs, done)):
            _map_obs(put, getattr(self, name), val)
        self.ptr = (self.ptr + B) % cap
        self.size = min(self.size + B, cap)

    def take(self, idx):
        return {name: _map_obs(lambda a: a[idx], getattr(self, name))
                for name in self.FIELDS}

    def sample(self, batch_size, generator):
        idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                            device=self.act.device)
        return self.take(idx)


@dataclass(frozen=True)
class SACConfig:
    obs_dim: int = 15
    act_dim: int = 6
    lr: float = 1e-4
    buffer_size: int = 50_000
    batch_size: int = 256
    gamma: float = 0.99
    tau: float = 0.005
    target_entropy: float = -2.0
    features: tuple = (256, 256)
    # (H, W) of the pixels_agent_pos obs (CNN + state encoder, obs_dim is
    # then agent_pos's width); empty tuple = flat state obs
    pixels: tuple = ()


@dataclass
class SACState:
    actor: Actor
    critic: Critic
    target_critic: Critic
    log_alpha: torch.Tensor        # 0-dim leaf, requires grad
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    alpha_opt: torch.optim.Adam
    buffer: ReplayBuffer
    normalizer: Normalizer
    generator: torch.Generator
    step: int = 0                  # gradient updates
    batch_steps: int = 0           # env-batch steps the trainer has taken
    # stage hyperparameters (the trainer's curriculum sets them)
    target_entropy: float = -2.0
    lr_scale: float = 1.0


class SAC:
    """SAC bound to a config, a device and a float dtype; the learning state
    lives in an SACState."""

    def __init__(self, cfg: SACConfig, device="cuda", dtype=torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype

    def make_actor(self) -> Actor:
        c = self.cfg
        return Actor(c.obs_dim, c.act_dim, c.features, pixels=c.pixels,
                     device=self.device, dtype=self.dtype)

    def make_critic(self) -> Critic:
        c = self.cfg
        return Critic(c.obs_dim, c.act_dim, c.features, pixels=c.pixels,
                      device=self.device, dtype=self.dtype)

    def obs_spec(self):
        """The replay buffer's obs spec (see ReplayBuffer): agent_pos is kept
        in float32 whatever the learner's dtype, as in the JAX package."""
        c = self.cfg
        if not c.pixels:
            return c.obs_dim
        h, w = c.pixels
        return {"pixels": ((h, w, 3), torch.uint8),
                "agent_pos": ((c.obs_dim,), torch.float32)}

    def _state_obs(self, obs):
        """The part of `obs` the normalizer tracks: all of a flat obs, the
        agent_pos of a pixel obs."""
        return obs["agent_pos"] if self.cfg.pixels else obs

    def _norm_obs(self, normalizer: Normalizer, obs):
        """Normalize: running mean/var on the state part; pixels scaled to
        [0, 1].  Both pass through float32 first, as in the JAX package."""
        if not self.cfg.pixels:
            return normalizer.norm(obs.to(self.dtype))
        return {"pixels": unit_pixels(obs["pixels"], self.dtype),
                "agent_pos": normalizer.norm(
                    obs["agent_pos"].to(torch.float32).to(self.dtype))}

    def init(self, seed=0) -> SACState:
        """Fresh state: Flax-style init from a generator seeded with `seed`,
        which then drives every later draw of the state."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        actor, critic = self.make_actor(), self.make_critic()
        init_flax_(actor, gen)
        init_flax_(critic, gen)
        return self.new_state(actor, critic, generator=gen)

    def new_state(self, actor, critic, target_critic=None, log_alpha=0.0,
                  normalizer=None, generator=None, seed=0) -> SACState:
        """State around given networks: fresh optimizers and an empty buffer;
        the target critic defaults to a copy of `critic`."""
        cfg = self.cfg
        target = copy.deepcopy(critic if target_critic is None else target_critic)
        target.requires_grad_(False)
        log_alpha = torch.tensor(float(log_alpha), dtype=self.dtype, device=self.device,
                                 requires_grad=True)
        adam = lambda params: torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                               eps=1e-8)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        return SACState(
            actor=actor, critic=critic, target_critic=target, log_alpha=log_alpha,
            actor_opt=adam(actor.parameters()), critic_opt=adam(critic.parameters()),
            alpha_opt=adam([log_alpha]),
            buffer=ReplayBuffer(cfg.buffer_size, self.obs_spec(), cfg.act_dim,
                                self.dtype, self.device),
            normalizer=normalizer or Normalizer.create(cfg.obs_dim, self.dtype, self.device),
            generator=generator, target_entropy=cfg.target_entropy,
        )

    def _noise(self, st: SACState, n):
        return torch.randn(n, self.cfg.act_dim, generator=st.generator,
                           device=self.device, dtype=self.dtype)

    # -- acting --------------------------------------------------------------

    @torch.no_grad()
    def act(self, st: SACState, obs, deterministic=False, noise=None):
        """Actions for `obs` (B, obs_dim, or the pixel dict); the standard
        normal draw of a stochastic action is `noise` (B, act_dim) when
        given, else from the state's generator."""
        nobs = self._norm_obs(st.normalizer, obs)
        if deterministic:
            return det_action(st.actor, nobs)
        if noise is None:
            noise = self._noise(st, self._state_obs(obs).shape[0])
        return sample_action(st.actor, nobs, noise)[0]

    # -- learning ------------------------------------------------------------

    def update(self, st: SACState, batch, noise=None, group=None):
        """One gradient step on `batch` (dict of obs, act, rew, next_obs,
        done): critic, then actor against the updated critic, then alpha,
        then the Polyak target update.  `noise` = (eps_next, eps_actor), the
        two standard normal draws (batch, act_dim) of the target and actor
        samples; drawn from the state's generator when not given.  Returns
        (st, metrics), the metrics as 0-dim device tensors.

        With a process group `group`, `batch` is this rank's rows of a batch
        sharded over the group's ranks in rank order, and `st` is the same
        on every rank: the draws are made for the whole batch and each rank
        takes its rows (`noise`, when given, is this rank's rows), and the
        gradients and the metrics are averaged across ranks.  The update
        then equals the one on the concatenated batch, and every rank ends
        with the same state."""
        cfg = self.cfg
        average = lambda tensors: None
        if group is not None:
            from ..parallel import dist

            average = lambda tensors: dist.all_reduce_mean_(tensors, group)
        if noise is None:
            n = batch["act"].shape[0]
            whole, rows = n, slice(0, n)
            if group is not None:
                whole = n * dist.world(group)[1]
                rows = dist.env_rows(whole, group)
            noise = [self._noise(st, whole)[rows] for _ in range(2)]
        eps_next, eps_actor = noise
        for opt in (st.actor_opt, st.critic_opt, st.alpha_opt):
            for param_group in opt.param_groups:
                param_group["lr"] = cfg.lr * st.lr_scale
        nobs = self._norm_obs(st.normalizer, batch["obs"])
        alpha = st.log_alpha.detach().exp()

        with torch.no_grad():
            nnext = self._norm_obs(st.normalizer, batch["next_obs"])
            next_act, next_logp = sample_action(st.actor, nnext, eps_next)
            tq1, tq2 = st.target_critic(nnext, next_act)
            tq = torch.minimum(tq1, tq2) - alpha * next_logp
            target = batch["rew"] + cfg.gamma * (~batch["done"]).to(tq.dtype) * tq

        q1, q2 = st.critic(nobs, batch["act"])
        closs = ((q1 - target) ** 2 + (q2 - target) ** 2).mean()
        st.critic_opt.zero_grad(set_to_none=True)
        closs.backward()
        average([p.grad for p in st.critic.parameters() if p.grad is not None])
        st.critic_opt.step()

        # the actor's gradient only: the critic's .grad stays as its own step
        # left it
        act, logp = sample_action(st.actor, nobs, eps_actor)
        q1, q2 = st.critic(nobs, act)
        aloss = (alpha * logp - torch.minimum(q1, q2)).mean()
        params = list(st.actor.parameters())
        grads = torch.autograd.grad(aloss, params)
        average(grads)
        for p, g in zip(params, grads):
            p.grad = g
        st.actor_opt.step()

        logp = logp.detach()
        lloss = -(st.log_alpha.exp() * (logp + st.target_entropy)).mean()
        st.alpha_opt.zero_grad(set_to_none=True)
        lloss.backward()
        average([st.log_alpha.grad])
        st.alpha_opt.step()

        with torch.no_grad():
            for t, p in zip(st.target_critic.parameters(), st.critic.parameters()):
                t.copy_((1 - cfg.tau) * t + cfg.tau * p)
        st.step += 1
        losses = torch.stack([closs.detach(), aloss.detach(), -logp.mean()])
        average([losses])
        metrics = dict(critic_loss=losses[0], actor_loss=losses[1],
                       alpha=st.log_alpha.detach().exp(), entropy=losses[2])
        return st, metrics

    def ingest(self, st: SACState, obs, act, rew, next_obs, done):
        """Write a batch of env transitions to the buffer and merge its
        state obs into the normalizer."""
        st.buffer.add_batch(obs, act, rew, next_obs, done)
        st.normalizer.update(self._state_obs(obs).to(self.dtype))
        return st

    def train_step(self, st: SACState, obs, act, rew, next_obs, done, noise=None):
        """Ingest a batch of env transitions and take one gradient update on
        a batch sampled from the buffer."""
        self.ingest(st, obs, act, rew, next_obs, done)
        batch = st.buffer.sample(self.cfg.batch_size, st.generator)
        return self.update(st, batch, noise)

    # -- checkpoints ---------------------------------------------------------

    def state_dict(self, st: SACState) -> dict:
        """Everything of `st` as tensors, ints and dicts (torch.save-able)."""
        buf = st.buffer
        return dict(
            actor=st.actor.state_dict(), critic=st.critic.state_dict(),
            target_critic=st.target_critic.state_dict(),
            log_alpha=st.log_alpha.detach(),
            actor_opt=st.actor_opt.state_dict(), critic_opt=st.critic_opt.state_dict(),
            alpha_opt=st.alpha_opt.state_dict(),
            buffer={**{n: getattr(buf, n) for n in buf.FIELDS},
                    "ptr": buf.ptr, "size": buf.size},
            normalizer=st.normalizer.tensors(),
            generator=st.generator.get_state(),
            step=st.step, batch_steps=st.batch_steps,
            target_entropy=st.target_entropy, lr_scale=st.lr_scale,
        )

    def load_state_dict(self, d: dict) -> SACState:
        """The SACState that `state_dict` saved, on this SAC's device."""
        st = self.init()
        st.actor.load_state_dict(d["actor"])
        st.critic.load_state_dict(d["critic"])
        st.target_critic.load_state_dict(d["target_critic"])
        with torch.no_grad():
            st.log_alpha.copy_(d["log_alpha"])
        # copies: an optimizer keeps the step counters it is given and
        # counts them on in place, so two states loaded from one dict would
        # share them
        for opt, name in ((st.actor_opt, "actor_opt"), (st.critic_opt, "critic_opt"),
                          (st.alpha_opt, "alpha_opt")):
            opt.load_state_dict(copy.deepcopy(d[name]))
        for n in ReplayBuffer.FIELDS:
            _map_obs(lambda a, v: a.copy_(v), getattr(st.buffer, n), d["buffer"][n])
        st.buffer.ptr, st.buffer.size = int(d["buffer"]["ptr"]), int(d["buffer"]["size"])
        st.normalizer = Normalizer(**{k: v.to(self.device)
                                      for k, v in d["normalizer"].items()})
        st.generator.set_state(d["generator"].cpu())
        st.step, st.batch_steps = int(d["step"]), int(d["batch_steps"])
        st.target_entropy, st.lr_scale = float(d["target_entropy"]), float(d["lr_scale"])
        return st
