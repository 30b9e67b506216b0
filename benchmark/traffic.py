"""The one traffic generator: a closed loop of batched control steps,
every input drawn from the run's seed.

A traffic file (`benchmark/traffic/<name>.json`) gives its parameters:

    envs          the batch, one env per row
    action        {"low", "high", "dim"}: a fresh action per env and control
                  step, uniform in [low, high]^dim, drawn on the device
    spawn         {"x": [lo, hi], "y": [lo, hi], "z"}: the cube's spawn,
                  uniform over x and y, upright at height z; drawn for every
                  env at reset and again on every control step for the envs
                  that the step resets
    episode_age   {"steps"}: the episode limit; each env starts at an age
                  from the stratified set floor(i * steps / envs), i < envs,
                  in an order drawn from the seed, so about envs / steps
                  episodes end on every control step, the same number for
                  every seed
    warmup_steps  control steps before the window
    check         {"steps", "first", "last"}: how many of the window's
                  control steps the reference checks, drawn from the seed
                  among its steps first..last (counted from 0); the window
                  runs at least until step `last` is done
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import torch

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


class Traffic:
    """The inputs of one run: `initial()` once, then `step_inputs()` once
    per control step, in order, so step i's inputs depend only on the seed
    and i."""

    def __init__(self, spec: dict, seed: int, device, dtype=torch.float32):
        self.spec = spec
        self.envs = int(spec["envs"])
        self.device = torch.device(device)
        self.dtype = dtype
        seed = int(seed) % 2 ** 63
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.host = torch.Generator().manual_seed(seed)
        self.pick = random.Random(seed)

    def _poses(self):
        sp = self.spec["spawn"]
        u = torch.rand(self.envs, 2, generator=self.gen, dtype=self.dtype,
                       device=self.device)
        pose = torch.zeros(self.envs, 7, dtype=self.dtype, device=self.device)
        pose[:, 0] = sp["x"][0] + u[:, 0] * (sp["x"][1] - sp["x"][0])
        pose[:, 1] = sp["y"][0] + u[:, 1] * (sp["y"][1] - sp["y"][0])
        pose[:, 2] = sp["z"]
        pose[:, 3] = 1.0
        return pose

    def initial(self):
        """(cube poses (envs, 7), episode ages (envs,) int32)."""
        steps = int(self.spec["episode_age"]["steps"])
        ages = torch.arange(self.envs, dtype=torch.int64) * steps // self.envs
        ages = ages[torch.randperm(self.envs, generator=self.host)]
        return self._poses(), ages.to(torch.int32).to(self.device)

    def step_inputs(self):
        """(actions (envs, dim), cube poses for the envs this step resets
        (envs, 7))."""
        a = self.spec["action"]
        u = torch.rand(self.envs, int(a["dim"]), generator=self.gen,
                       dtype=self.dtype, device=self.device)
        return a["low"] + u * (a["high"] - a["low"]), self._poses()

    def check_steps(self):
        """The window's control steps whose outputs the reference checks."""
        c = self.spec["check"]
        return sorted(self.pick.sample(range(int(c["first"]), int(c["last"]) + 1),
                                       int(c["steps"])))
