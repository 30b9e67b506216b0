"""env_rest_ms: the traced control step's wall time (the benchmark's range
around `BatchedEnv.step`, closed after a device synchronize) less the five
physics ranges (smooth, collide, efc, solve, integrate): the reward, the
observations, the kinematics refresh, the autoreset and, with pixel
observations, the renders."""

from benchmark.trace import PHYSICS_RANGES, range_ms


def read(run):
    if run.trace is None:
        return None
    physics = sum(range_ms(run.trace, name) or 0.0 for name in PHYSICS_RANGES)
    return run.trace.wall_us / 1e3 - physics
