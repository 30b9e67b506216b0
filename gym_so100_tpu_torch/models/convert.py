"""Bridge from plain numpy leaves to the port's Model and State.

A caller holding the JAX package's Model (or State) passes its fields as a
mapping of name -> numpy array (numeric leaves) or Python value (static
fields, including the collision pair table as any object or mapping with
box_box/hull_box/hull_hull/ccd).  The tests use this to feed the JAX
function and its port the very same model and state.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .scene import CollisionPairs, Model, State


def _pairs(p) -> CollisionPairs:
    get = (lambda k: p[k]) if isinstance(p, Mapping) else (lambda k: getattr(p, k))
    return CollisionPairs(**{
        f.name: tuple(tuple(x) for x in get(f.name))
        for f in dataclasses.fields(CollisionPairs)
    })


def _leaf(v, device, dtype):
    if isinstance(v, np.ndarray):
        t = torch.from_numpy(np.array(v, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return v


def model_from_numpy(leaves: Mapping, device="cpu", dtype=None) -> Model:
    """Model from {field name: numpy array or static value}; float arrays are
    cast to `dtype` when given.  Unknown names raise."""
    names = {f.name for f in dataclasses.fields(Model)}
    unknown = set(leaves) - names
    if unknown:
        raise KeyError(f"not Model fields: {sorted(unknown)}")
    kw = {k: _leaf(v, device, dtype) for k, v in leaves.items()}
    if "pairs" in kw:
        kw["pairs"] = _pairs(kw["pairs"])
    return Model(**kw)


def state_from_numpy(leaves: Mapping, device="cpu", dtype=None) -> State:
    """State from {field name: numpy array or None}."""
    names = {f.name for f in dataclasses.fields(State)}
    unknown = set(leaves) - names
    if unknown:
        raise KeyError(f"not State fields: {sorted(unknown)}")
    return State(**{k: _leaf(v, device, dtype) for k, v in leaves.items()})
