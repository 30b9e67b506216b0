"""Profiling hooks: a `torch.profiler` capture, the stage spans and the
counters.

The port of `gym_so100_tpu/profiling.py`.  The stages carry `annotate`
spans (`ops/forward.py`: smooth, collide, efc, solve, integrate, as JAX's
`named_scope`s; `Renderer.render_batch`: render; `BatchedEnv.step`:
done_sync, the step's one device-to-host sync, and autoreset), so a trace
attributes host and device time to them, and `trace()` captures one:

    from gym_so100_tpu_torch.profiling import trace
    with trace("/tmp/so100-trace") as prof:
        env.step(es, actions)
    prof.key_averages()          # per-op and per-range CPU and CUDA times

Everything here records only while a torch profiler records (`trace()`,
or any `torch.profiler.profile` the caller starts), with one exception:
the marks of a CUDA graph capture.  Otherwise a span is a null context and
a count does nothing.  While one records:

* a span opens a host range (`record_function`) and, on CUDA, launches
  the empty kernel `gst_span_<name>` (`csrc/span_mark.cu`) when it opens
  and the mark of the enclosing span (`gst_span_none` at the top) when it
  closes.  The step runs on one stream, so every device op between two
  marks belongs to the span the earlier one names.  A name outside
  `SPANS` opens its range and launches no mark;
* `count(name, value)` adds to a counter without a sync (a tensor is
  summed elementwise on its device, reduced when read), and `counters()`
  reads them all.  `solver_lanes.solve_lanes` counts `newton.solves`,
  `newton.iterations` and `newton.capped` (solves that reached the
  iteration budget); `forward.n_steps_batched` counts `substep.graphed`
  and `substep.eager`.

While the current stream captures a CUDA graph (`capturing()`; the
substep graphs of `forward.n_steps_batched`), a span launches its marks
whether or not a profiler records, so the graph holds them and every
replay runs them with the work around them; it opens its host range only
while a profiler records.  Counts are not made during a capture, whose
work does not run: whoever replays the graph counts after each replay.

`trace()` writes `trace.json` (Chrome trace format: open it in Perfetto or
chrome://tracing; the marks are the `gst_span_*` kernels on the device
track) and `counters.json` in `logdir`.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import warnings

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function

from .device import resolve_device

# The spans that mark the device stream, in the order of csrc/span_mark.cu's
# kernels; "none" is the mark of no open span
SPANS = ("none", "smooth", "collide", "efc", "solve", "integrate", "render",
         "autoreset", "done_sync")
_SPAN_INDEX = {name: i for i, name in enumerate(SPANS)}

_NULL = contextlib.nullcontext()
_local = threading.local()      # .open: indices of this thread's open marked spans
_host_counts = {}               # name -> float
_device_counts = {}             # (name, shape, device) -> accumulated tensor


def recording() -> bool:
    """Whether a torch profiler records on this thread and no CUDA graph
    capture is under way: whether counts are made."""
    return _profiler_enabled() and not capturing()


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Capture a torch.profiler trace of the enclosed block (CPU activity,
    and CUDA activity on a CUDA `device`) into `logdir`/trace.json, and the
    counters counted inside it into `logdir`/counters.json; yields the
    profiler.

    On the CPU a profiler that cannot start or stop warns and the block
    runs untraced, as JAX's `trace` does; on the card it raises."""
    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=False)
    reset_counters()
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
            with open(os.path.join(logdir, "counters.json"), "w") as f:
                json.dump(counters(), f, indent=1, sort_keys=True)
        except Exception as e:
            if device.type == "cuda":
                raise
            warnings.warn(f"profiler stop failed: {e}")


class _Span:
    """A host range (where `ranged`) and, for a name in SPANS, the marks
    around it."""

    __slots__ = ("_range", "_index")

    def __init__(self, name, ranged=True):
        self._range = record_function(name) if ranged else _NULL
        self._index = _SPAN_INDEX.get(name)

    def __enter__(self):
        self._range.__enter__()
        if self._index is not None:
            _open_spans().append(self._index)
            _launch_mark(self._index)
        return self

    def __exit__(self, *exc):
        if self._index is not None:
            stack = _open_spans()
            stack.pop()
            _launch_mark(stack[-1] if stack else 0)
        return self._range.__exit__(*exc)


def _open_spans():
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def _launch_mark(index):
    """Launch mark `index` of SPANS on the current CUDA stream; nothing
    where CUDA is not in use."""
    if torch.cuda.is_initialized():
        from . import kernels

        kernels.launch("gst_span_mark", index)


def annotate(name: str):
    """A named span: while a profiler records, a host range
    (`torch.profiler.record_function`) and, for a name in SPANS, its marks
    on the device stream; during a CUDA graph capture with no profiler,
    the marks alone; otherwise a null context."""
    if _profiler_enabled():
        return _Span(name)
    return _Span(name, ranged=False) if capturing() else _NULL


def count(name: str, value):
    """Add `value` to counter `name` while a profiler records and no CUDA
    graph capture is under way: a number on the host, a tensor elementwise
    into an accumulator on its device (no sync; `counters()` reduces).
    Does nothing otherwise."""
    if not recording():
        return
    if not isinstance(value, torch.Tensor):
        _host_counts[name] = _host_counts.get(name, 0.0) + float(value)
        return
    value = value.detach()
    key = (name, tuple(value.shape), value.device)
    acc = _device_counts.get(key)
    if acc is None:
        wide = torch.float64 if value.is_floating_point() else torch.int64
        _device_counts[key] = value.to(wide, copy=True)
    else:
        acc.add_(value)


def counters() -> dict:
    """{name: total} of every counter since the last reset (one sync for
    each device that holds counters)."""
    out = dict(_host_counts)
    by_device = {}
    for (name, _, device), acc in _device_counts.items():
        by_device.setdefault(device, []).append((name, acc.sum(dtype=torch.float64)))
    for sums in by_device.values():
        for (name, _), v in zip(sums, torch.stack([s for _, s in sums]).tolist()):
            out[name] = out.get(name, 0.0) + v
    return out


def reset_counters():
    """Drop every counter (`trace()` does on entry)."""
    _host_counts.clear()
    _device_counts.clear()
