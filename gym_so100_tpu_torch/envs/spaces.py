"""Observation and action spaces of the single-env adapters, without
Gymnasium.

The card has no Gymnasium, so the port's adapters describe their spaces
with these two classes, which carry the attributes the adapters and their
callers read: `Box` (`low`, `high`, `shape`, `dtype`, `contains`, `sample`)
and `Dict` (`spaces`, item access, `contains`, `sample`).  `sample` draws
from the numpy Generator it is given, or from the space's own.
"""

from __future__ import annotations

import numpy as np


class Box:
    """A box in R^n: `low` <= x <= `high` elementwise, of `shape` and
    `dtype` (bounds broadcast to the shape)."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.broadcast_shapes(np.shape(low), np.shape(high))
        self.shape = tuple(int(n) for n in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()
        self.np_random = np.random.default_rng()

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape and np.can_cast(x.dtype, self.dtype, "same_kind")
                and bool(np.all(x >= self.low)) and bool(np.all(x <= self.high)))

    def sample(self, rng: np.random.Generator | None = None) -> np.ndarray:
        """A point of the box: integers in [low, high] for an integer box,
        else uniform where the bounds are finite and normal where not."""
        rng = self.np_random if rng is None else rng
        if np.issubdtype(self.dtype, np.integer):
            hi = self.high.astype(np.int64) + 1
            return rng.integers(self.low.astype(np.int64), hi, size=self.shape).astype(self.dtype)
        lo = self.low.astype(np.float64)
        hi = self.high.astype(np.float64)
        bounded = np.isfinite(lo) & np.isfinite(hi)
        out = rng.normal(size=self.shape)
        out[bounded] = rng.uniform(lo[bounded], hi[bounded])
        return out.astype(self.dtype)


class Dict:
    """A dict of named spaces."""

    def __init__(self, spaces: dict):
        self.spaces = dict(spaces)
        self.np_random = np.random.default_rng()

    def __getitem__(self, key):
        return self.spaces[key]

    def contains(self, x) -> bool:
        return (isinstance(x, dict) and x.keys() == self.spaces.keys()
                and all(sp.contains(x[k]) for k, sp in self.spaces.items()))

    def sample(self, rng: np.random.Generator | None = None) -> dict:
        rng = self.np_random if rng is None else rng
        return {k: sp.sample(rng) for k, sp in self.spaces.items()}
