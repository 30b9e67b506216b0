"""Behavior cloning from teleop demonstrations.

The port of `gym_so100_tpu/agents/bc.py`: reads the pickled demo format
(a list of episode dicts with "observations", "actions", ...), trains the
SAC actor's architecture by Gaussian maximum likelihood on the
tanh-inverted actions, and copies the result into a SAC actor for
fine-tuning.  Both obs types are supported: flat state vectors, and the
pixel dict {"pixels": (H, W, 3) uint8, "agent_pos"} through the same
NatureCNN encoder as the pixel SAC actor, so the weights transfer
parameter for parameter.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from ..device import resolve_device
from .sac import SAC, Actor, SACState, init_flax_, unit_pixels


def load_demo_transitions(paths, obs_key=None, pixels=False):
    """Flatten demo pickles into (obs (N, D), act (N, A)) float32 arrays.

    Observations may be flat arrays or dicts; `obs_key` selects a dict
    entry, else a dict's non-pixel entries are concatenated in key order.
    With pixels=True, dict observations keep their frames: returns
    ({"pixels": (N, H, W, 3) uint8, "agent_pos": (N, D) float32}, act),
    agent_pos falling back to a "qpos" entry.  Only demo files this
    project wrote should be loaded: unpickling runs code."""
    obs_l, act_l, pix_l = [], [], []
    for p in paths:
        with open(p, "rb") as f:
            episodes = pickle.load(f)
        for ep in episodes:
            obs = ep["observations"]
            acts = np.asarray(ep["actions"], np.float32)
            for i in range(len(acts)):
                o = obs[i]
                if isinstance(o, dict):
                    if pixels:
                        pix_l.append(np.asarray(o["pixels"], np.uint8))
                        o = o.get("agent_pos", o.get("qpos"))
                    elif obs_key:
                        o = o[obs_key]
                    else:
                        o = np.concatenate(
                            [np.ravel(o[k]) for k in sorted(o) if k != "pixels"])
                elif pixels:
                    raise ValueError("pixels=True needs dict observations")
                obs_l.append(np.asarray(o, np.float32).ravel())
                act_l.append(acts[i])
    if pixels:
        return ({"pixels": np.stack(pix_l), "agent_pos": np.stack(obs_l)},
                np.stack(act_l))
    return np.stack(obs_l), np.stack(act_l)


def train_bc(obs, act, epochs=50, batch_size=256, lr=3e-4, seed=0,
             features=(256, 256), progress=None, device="cuda",
             dtype=torch.float32, actor: Actor | None = None) -> Actor:
    """Gaussian MLE behavior cloning; returns the trained Actor.

    Minimises 0.5 ((atanh(clip(a, +-0.999)) - mean) / std)^2 + log_std with
    Adam, over batches taken in np.random.RandomState(seed).permutation
    order each epoch (a last partial batch is dropped).  Starts from
    `actor` when given, else from a Flax-style init seeded with `seed`.

    `obs` is a flat (N, D) array, or the pixel dict of
    load_demo_transitions(pixels=True): the actor is then the pixel Actor,
    and the frames stay uint8 on the device until a batch is taken."""
    device = resolve_device(device)
    pixels = isinstance(obs, dict)
    if pixels:
        frames = torch.as_tensor(np.asarray(obs["pixels"], np.uint8), device=device)
        agent_pos = torch.as_tensor(np.asarray(obs["agent_pos"], np.float32),
                                    device=device)
        n, obs_dim, size = frames.shape[0], agent_pos.shape[1], tuple(frames.shape[1:3])

        def take(idx):
            # [0, 1] floats at batch time
            return {"pixels": unit_pixels(frames[idx], dtype),
                    "agent_pos": agent_pos[idx].to(dtype)}
    else:
        obs = torch.as_tensor(np.asarray(obs), dtype=dtype, device=device)
        n, obs_dim, size = obs.shape[0], obs.shape[1], ()
        take = obs.__getitem__
    act = torch.as_tensor(np.asarray(act), dtype=dtype, device=device)
    if actor is None:
        actor = Actor(obs_dim, act.shape[1], features, pixels=size, device=device,
                      dtype=dtype)
        init_flax_(actor, torch.Generator(device=device).manual_seed(seed))
    opt = torch.optim.Adam(actor.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    rng = np.random.RandomState(seed)
    bs = min(batch_size, n)
    for e in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        losses = []
        for i in range(0, n - bs + 1, bs):
            idx = order[i:i + bs]
            mean, log_std = actor(take(idx))
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
