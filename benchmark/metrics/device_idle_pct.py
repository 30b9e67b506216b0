"""device_idle_pct: the share (%) of the traced control step's wall time in
which no kernel, copy or set ran on the device (100 less the union of their
intervals over the step's own window)."""

from benchmark.trace import union_us


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.device_ops()
    if not ops:
        return None
    busy = union_us((e.start, e.end) for e in ops)
    return 100.0 * (1.0 - busy / run.trace.wall_us)
