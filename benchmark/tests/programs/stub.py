"""The program `stub`, the tests' own: a stand-in of a few lines, outside
`benchmark/programs/`, that no cell names.  The benchmark's tests point
the harness's programs directory here and drive it through `harness.main`
to show that a configuration's `program` key picks the module that runs
the cell.

Its "program" moves one number per env, x <- x / 2 + a, for inputs a
drawn from the seed; its check works the same out again in float64.  A
configuration may name one of its faults (`"fault"`), planted at build.
"""

from __future__ import annotations

import time

import torch


class Traffic:
    def __init__(self, spec, seed):
        self.envs = int(spec["envs"])
        self.gen = torch.Generator().manual_seed(int(seed) % 2 ** 63)

    def step_inputs(self):
        return torch.rand(self.envs, generator=self.gen)


def traffic(spec, seed, device):
    return Traffic(spec, seed)


def build(config, spec, seed, device):
    program = lambda x, a: x * 0.5 + a          # noqa: E731
    fault = config.get("fault")
    return faults(config, device)[fault](program) if fault else program


def drive(run, program, traffic, device, seconds, trace=False, t_process=None, sync=None):
    """The window: steps until `seconds` have passed and two are done.  No
    trace."""
    x = torch.zeros(traffic.envs)
    t0 = time.perf_counter()
    if t_process is not None:
        run.setup_s = t0 - t_process
    i = 0
    while True:
        a = traffic.step_inputs()
        run.records.append(a)
        x = program(x, a)
        i += 1
        if time.perf_counter() - t0 >= seconds and i >= 2:
            break
    run.window_s = time.perf_counter() - t0
    run.steps, run.env_steps, run.failed = i, i * traffic.envs, 0
    run.start = x
    return x


def verify(run, config, device, ref=None):
    x = torch.zeros(run.start.shape, dtype=torch.float64)
    for a in run.records:
        x = x * 0.5 + a.double()
    gap = float((run.start.double() - x).abs().max())
    limit = config["limits"]["gap"]
    return gap <= limit, [("gap", gap, limit)], None, None


def kernel_shapes(ref, spec):
    return None


def limit_names(config):
    return {"gap"}


def faults(config, device):
    return {"unchanged": lambda program: (lambda x, a: x)}


def readings(ref, run, tally):
    return {}
