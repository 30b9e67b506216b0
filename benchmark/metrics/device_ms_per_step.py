"""device_ms_per_step: the device's busy time (ms) in one control step of
the cell's envs: the union of the intervals of every kernel, copy and set
in a profiler trace of one control step taken once the window has closed.
The step's time once the host no longer paces it."""

from benchmark.trace import union_us


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.device_ops()
    if not ops:
        return None
    return union_us((e.start, e.end) for e in ops) / 1e3
