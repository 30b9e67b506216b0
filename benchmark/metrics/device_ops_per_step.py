"""device_ops_per_step: the kernels, copies and sets that one traced control
step ran on the device, counted in the trace."""


def read(run):
    if run.trace is None:
        return None
    n = len(run.trace.device_ops())
    return float(n) if n else None
