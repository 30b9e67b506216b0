"""Bridge between the JAX SAC's Flax parameter trees and the port's modules.

A Flax tree as numpy arrays looks like
{'params': {'MLP_0': {'Dense_0': {'kernel': (in, out), 'bias': (out,)}, ...}}}:
the actor has MLP_0, the critic MLP_0 (q1) and MLP_1 (q2).  A Flax Dense
kernel is the transpose of a torch weight.  Pixel networks add
'Encoder_0': {'NatureCNN_0': {'Conv_0', 'Conv_1', 'Conv_2', 'Dense_0'}}; a
Flax conv kernel (kh, kw, c_in, c_out) is a torch weight (c_out, c_in, kh,
kw) transposed.  The tests use this to start the JAX learner and its port
from the very same parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from .sac import SAC, Actor, Critic, Normalizer, SACState


# Flax kernel -> torch weight, by the kernel's rank (Dense 2, Conv 4)
_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1)}
_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0)}


def _numbered(tree, prefix):
    return [tree[f"{prefix}_{i}"]
            for i in range(sum(k.startswith(prefix + "_") for k in tree))]


def _mlp_trees(tree):
    return _numbered(tree.get("params", tree), "MLP")


def _cnn_tree(tree):
    """The NatureCNN's layer trees (Conv_0-2, Dense_0), or None."""
    enc = tree.get("params", tree).get("Encoder_0")
    if enc is None:
        return None
    cnn = enc["NatureCNN_0"]
    return [*_numbered(cnn, "Conv"), *_numbered(cnn, "Dense")]


def _load_layers_(layers, trees, what):
    if len(layers) != len(trees):
        raise ValueError(f"{len(trees)} {what} layers in the tree, {len(layers)} "
                         f"in the module")
    for layer, d in zip(layers, trees):
        k = np.asarray(d["kernel"])
        w = torch.from_numpy(k.transpose(_TO_TORCH[k.ndim]).copy())
        if w.shape != layer.weight.shape:
            raise ValueError(f"kernel {k.shape} does not fit weight "
                             f"{tuple(layer.weight.shape)}")
        layer.weight.copy_(w)
        layer.bias.copy_(torch.from_numpy(np.array(d["bias"])))


def load_flax_(module: Actor | Critic, tree):
    """Copy a Flax tree into `module` (an Actor or a Critic) in place."""
    mlps = module.mlps()
    trees = _mlp_trees(tree)
    if len(trees) != len(mlps):
        raise ValueError(f"{len(trees)} MLPs in the tree, {len(mlps)} in the module")
    cnn = _cnn_tree(tree)
    if (cnn is None) != (module.encoder is None):
        raise ValueError("the tree and the module differ in having a pixel encoder")
    with torch.no_grad():
        if cnn is not None:
            _load_layers_(module.encoder.cnn.layers(), cnn, "NatureCNN")
        for mlp, mt in zip(mlps, trees):
            _load_layers_(mlp.layers(), _numbered(mt, "Dense"), "Dense")
    return module


def _layer_tree(layer):
    w = layer.weight.detach().cpu().numpy()
    return {"kernel": w.transpose(_TO_FLAX[w.ndim]).copy(),
            "bias": layer.bias.detach().cpu().numpy().copy()}


def to_flax(module: Actor | Critic) -> dict:
    """The Flax tree of `module`, as numpy arrays (copies)."""
    params = {
        f"MLP_{i}": {f"Dense_{j}": _layer_tree(lin) for j, lin in enumerate(mlp.layers())}
        for i, mlp in enumerate(module.mlps())
    }
    if module.encoder is not None:
        cnn = module.encoder.cnn
        params["Encoder_0"] = {"NatureCNN_0": {
            **{f"Conv_{j}": _layer_tree(c) for j, c in enumerate(cnn.convs)},
            "Dense_0": _layer_tree(cnn.dense)}}
    return {"params": params}


def actor_from_numpy(actor_params, pixels=(), device="cpu", dtype=torch.float32) -> Actor:
    """An Actor holding a lone Flax actor tree (a BC policy), its widths
    read from the tree; a tree with a pixel encoder needs the frame size
    `pixels` = (H, W), which its kernels do not determine."""
    cnn = _cnn_tree(actor_params)
    if (cnn is None) == bool(pixels):
        raise ValueError("pixels=(H, W) is needed exactly when the tree has a "
                         "pixel encoder")
    kernels = [np.asarray(d["kernel"])
               for d in _numbered(_mlp_trees(actor_params)[0], "Dense")]
    obs_dim = kernels[0].shape[0]
    if cnn is not None:
        obs_dim -= np.asarray(cnn[-1]["kernel"]).shape[1]
    actor = Actor(obs_dim, kernels[-1].shape[1] // 2,
                  tuple(k.shape[1] for k in kernels[:-1]), pixels=pixels,
                  device=device, dtype=dtype)
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
