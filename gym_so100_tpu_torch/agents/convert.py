"""Bridge between the JAX SAC's Flax parameter trees and the port's modules.

A Flax tree as numpy arrays looks like
{'params': {'MLP_0': {'Dense_0': {'kernel': (in, out), 'bias': (out,)}, ...}}}:
the actor has MLP_0, the critic MLP_0 (q1) and MLP_1 (q2).  A Flax kernel
is the transpose of a torch weight.  The tests use this to start the JAX
learner and its port from the very same parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from .sac import SAC, Actor, Critic, Normalizer, SACState


def _mlp_trees(tree):
    tree = tree.get("params", tree)
    return [tree[f"MLP_{i}"] for i in range(len(tree))]


def _dense(mlp_tree):
    return [mlp_tree[f"Dense_{i}"] for i in range(len(mlp_tree))]


def load_flax_(module: Actor | Critic, tree):
    """Copy a Flax tree into `module` (an Actor or a Critic) in place."""
    mlps = module.mlps()
    trees = _mlp_trees(tree)
    if len(trees) != len(mlps):
        raise ValueError(f"{len(trees)} MLPs in the tree, {len(mlps)} in the module")
    with torch.no_grad():
        for mlp, mt in zip(mlps, trees):
            layers, dense = mlp.layers(), _dense(mt)
            if len(layers) != len(dense):
                raise ValueError(f"{len(dense)} Dense layers in the tree, "
                                 f"{len(layers)} in the module")
            for lin, d in zip(layers, dense):
                w = torch.from_numpy(np.asarray(d["kernel"]).T.copy())
                if w.shape != lin.weight.shape:
                    raise ValueError(f"kernel {tuple(w.shape[::-1])} does not fit "
                                     f"weight {tuple(lin.weight.shape)}")
                lin.weight.copy_(w)
                lin.bias.copy_(torch.from_numpy(np.array(d["bias"])))
    return module


def to_flax(module: Actor | Critic) -> dict:
    """The Flax tree of `module`, as numpy arrays (copies)."""
    return {"params": {
        f"MLP_{i}": {
            f"Dense_{j}": {"kernel": lin.weight.detach().cpu().numpy().T.copy(),
                           "bias": lin.bias.detach().cpu().numpy().copy()}
            for j, lin in enumerate(mlp.layers())
        }
        for i, mlp in enumerate(module.mlps())
    }}


def actor_from_numpy(actor_params, device="cpu", dtype=torch.float32) -> Actor:
    """An Actor holding a lone Flax actor tree (a BC policy), its widths
    read from the tree."""
    dense = _dense(_mlp_trees(actor_params)[0])
    kernels = [np.asarray(d["kernel"]) for d in dense]
    actor = Actor(kernels[0].shape[0], kernels[-1].shape[1] // 2,
                  tuple(k.shape[1] for k in kernels[:-1]), device=device, dtype=dtype)
    return load_flax_(actor, actor_params)


def sac_params_from_numpy(sac: SAC, actor_params, critic_params,
                          target_critic_params=None, log_alpha=0.0, normalizer=None,
                          seed=0) -> SACState:
    """An SACState of `sac` holding the JAX SAC's actor, critic and target
    critic trees, `log_alpha` and `normalizer` ({"mean", "var", "count"} as
    numpy arrays, or None for a fresh one).  The target critic defaults to
    the critic.  Optimizers start fresh, the buffer empty, the generator
    from `seed`."""
    actor = load_flax_(sac.make_actor(), actor_params)
    critic = load_flax_(sac.make_critic(), critic_params)
    target = None
    if target_critic_params is not None:
        target = load_flax_(sac.make_critic(), target_critic_params)
    norm = None
    if normalizer is not None:
        norm = Normalizer(**{
            k: torch.as_tensor(np.array(normalizer[k]), dtype=sac.dtype,
                               device=sac.device)
            for k in ("mean", "var", "count")})
    return sac.new_state(actor, critic, target, log_alpha=float(np.asarray(log_alpha)),
                         normalizer=norm, seed=seed)
