"""done_sync_ms: host time (ms) of the `done_sync` range that the program
opens around `BatchedEnv.step`'s done test in one traced control step:
the step's one device-to-host sync, where the host waits for the device
to drain its queue."""

from benchmark.trace import range_ms


def read(run):
    return range_ms(run.trace, "done_sync")
