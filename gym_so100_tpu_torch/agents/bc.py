"""Behavior cloning from teleop demonstrations, state observations.

The port of `gym_so100_tpu/agents/bc.py`: reads the pickled demo format
(a list of episode dicts with "observations", "actions", ...), trains the
SAC actor's architecture by Gaussian maximum likelihood on the
tanh-inverted actions, and copies the result into a SAC actor for
fine-tuning.  Pixel observations raise until the rasterizer and the
NatureCNN encoder are ported.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from ..device import resolve_device
from .sac import SAC, Actor, SACState, init_flax_

_PIXELS = ("BC on pixel observations needs the NatureCNN encoder, which is "
           "not ported yet (ROADMAP.md, queue A3: pixels)")


def load_demo_transitions(paths, obs_key=None, pixels=False):
    """Flatten demo pickles into (obs (N, D), act (N, A)) float32 arrays.

    Observations may be flat arrays or dicts; `obs_key` selects a dict
    entry, else a dict's non-pixel entries are concatenated in key order.
    Only demo files this project wrote should be loaded: unpickling runs
    code."""
    if pixels:
        raise NotImplementedError(_PIXELS)
    obs_l, act_l = [], []
    for p in paths:
        with open(p, "rb") as f:
            episodes = pickle.load(f)
        for ep in episodes:
            obs = ep["observations"]
            acts = np.asarray(ep["actions"], np.float32)
            for i in range(len(acts)):
                o = obs[i]
                if isinstance(o, dict):
                    if obs_key:
                        o = o[obs_key]
                    else:
                        o = np.concatenate(
                            [np.ravel(o[k]) for k in sorted(o) if k != "pixels"])
                obs_l.append(np.asarray(o, np.float32).ravel())
                act_l.append(acts[i])
    return np.stack(obs_l), np.stack(act_l)


def train_bc(obs, act, epochs=50, batch_size=256, lr=3e-4, seed=0,
             features=(256, 256), progress=None, device="cuda",
             dtype=torch.float32, actor: Actor | None = None) -> Actor:
    """Gaussian MLE behavior cloning; returns the trained Actor.

    Minimises 0.5 ((atanh(clip(a, +-0.999)) - mean) / std)^2 + log_std with
    Adam, over batches taken in np.random.RandomState(seed).permutation
    order each epoch (a last partial batch is dropped).  Starts from
    `actor` when given, else from a Flax-style init seeded with `seed`."""
    if isinstance(obs, dict):
        raise NotImplementedError(_PIXELS)
    device = resolve_device(device)
    obs = torch.as_tensor(np.asarray(obs), dtype=dtype, device=device)
    act = torch.as_tensor(np.asarray(act), dtype=dtype, device=device)
    n = obs.shape[0]
    if actor is None:
        actor = Actor(obs.shape[1], act.shape[1], features, device=device, dtype=dtype)
        init_flax_(actor, torch.Generator(device=device).manual_seed(seed))
    opt = torch.optim.Adam(actor.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    rng = np.random.RandomState(seed)
    bs = min(batch_size, n)
    for e in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        losses = []
        for i in range(0, n - bs + 1, bs):
            idx = order[i:i + bs]
            mean, log_std = actor(obs[idx])
            pre = torch.atanh(torch.clamp(act[idx], -0.999, 0.999))
            loss = (0.5 * ((pre - mean) / torch.exp(log_std)) ** 2 + log_std).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if progress:
            progress({"epoch": e, "bc_loss": float(torch.stack(losses).mean())})
    return actor


def transfer_to_sac(sac: SAC, st: SACState, bc_actor: Actor) -> SACState:
    """Load the BC policy's weights into the SAC actor (same architecture,
    so a straight copy; the actor's optimizer state is kept)."""
    ref = {k: tuple(v.shape) for k, v in st.actor.state_dict().items()}
    new = {k: tuple(v.shape) for k, v in bc_actor.state_dict().items()}
    if ref != new:
        raise ValueError(f"BC policy and SAC actor architectures differ: {ref} vs {new}")
    st.actor.load_state_dict(bc_actor.state_dict())
    return st
