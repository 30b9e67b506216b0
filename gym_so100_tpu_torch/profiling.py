"""Profiling hooks: a `torch.profiler` capture and the stage annotations.

The port of `gym_so100_tpu/profiling.py`.  The physics stages carry
`annotate` ranges (`ops/forward.py`: smooth, collide, efc, solve,
integrate, as JAX's `named_scope`s), so a trace attributes host and device
time to them, and `trace()` captures one:

    from gym_so100_tpu_torch.profiling import trace
    with trace("/tmp/so100-trace") as prof:
        env.step(es, actions)
    prof.key_averages()          # per-op and per-range CPU and CUDA times

The trace is written as `trace.json` in `logdir` (Chrome trace format:
open it in Perfetto or chrome://tracing).  An annotation outside a
capture costs a few microseconds of host time and no device sync.
"""

from __future__ import annotations

import contextlib
import os
import warnings

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .device import resolve_device


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Capture a torch.profiler trace of the enclosed block (CPU activity,
    and CUDA activity on a CUDA `device`) into `logdir`/trace.json; yields
    the profiler.

    On the CPU a profiler that cannot start or stop warns and the block
    runs untraced, as JAX's `trace` does; on the card it raises."""
    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=False)
    try:
        prof.start()
    except Exception as e:
        if device.type == "cuda":
            raise
        warnings.warn(f"profiler trace unavailable: {e}")
        yield None
        return
    try:
        yield prof
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        try:
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        except Exception as e:
            if device.type == "cuda":
                raise
            warnings.warn(f"profiler stop failed: {e}")


def annotate(name: str):
    """A named range in the trace (`torch.profiler.record_function`)."""
    return record_function(name)
