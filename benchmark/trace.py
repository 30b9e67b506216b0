"""A profiler trace of one control step, reduced to what the per-layer
metric readers take.

`capture(fn)` runs `fn` inside `torch.profiler` (CPU and CUDA activities)
under the benchmark's own range `STEP_RANGE`, and returns a `Trace` built
from the profiler's in-memory events: host ranges (`record_function`),
host ops, and the device's kernels, copies and sets, each with its start
and end in microseconds.  Nothing is written to disk.
"""

from __future__ import annotations

from dataclasses import dataclass, field

STEP_RANGE = "bench.control_step"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass(frozen=True)
class Event:
    name: str
    kind: str        # kineto's activity type: user_annotation, cpu_op, kernel, ...
    start: float     # microseconds
    end: float
    tid: int = 0


@dataclass
class Trace:
    """The events of one traced control step.  `step` is (start, end) of
    the benchmark's range around it, which ends after a device
    synchronize, so every device op of the step lies inside it."""

    events: list
    step: tuple
    kinds: dict = field(default_factory=dict)   # events seen by kind

    @property
    def wall_us(self) -> float:
        return self.step[1] - self.step[0]

    def host_ranges(self, name):
        """(start, end) of each host range `name` inside the step."""
        s0, s1 = self.step
        return [(e.start, e.end) for e in self.events
                if e.kind == "user_annotation" and e.name == name
                and e.start >= s0 and e.end <= s1]

    def device_ops(self):
        """The kernels, copies and sets inside the step, by start."""
        s0, s1 = self.step
        return sorted((e for e in self.events if e.kind in DEVICE_KINDS
                       and e.start >= s0 and e.end <= s1), key=lambda e: e.start)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(trace: Trace):
    """The device's idle intervals inside the step: before its first op,
    between the union of its ops, and after its last."""
    s0, s1 = trace.step
    gaps, reach = [], s0
    for e in trace.device_ops():
        if e.start > reach:
            gaps.append((reach, e.start))
        reach = max(reach, e.end)
    if s1 > reach:
        gaps.append((reach, s1))
    return gaps


def host_labels(trace: Trace, times):
    """For each time in `times` (ascending), what the host thread that ran
    the step was doing: "<innermost range>/<innermost op>", the op being
    "python" when no op was open."""
    s0, s1 = trace.step
    main = [e for e in trace.events if e.kind == "user_annotation" and e.name == STEP_RANGE]
    tid = main[0].tid if main else None
    host = sorted((e for e in trace.events
                   if e.kind in ("user_annotation", "cpu_op") and e.tid == tid
                   and e.end >= s0 and e.start <= s1),
                  key=lambda e: (e.start, -e.end))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i].start <= t:
            while stack and stack[-1].end <= host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        rng = next((e.name for e in reversed(stack) if e.kind == "user_annotation"
                    and e.name != STEP_RANGE), "step")
        op = stack[-1].name if stack and stack[-1].kind == "cpu_op" else "python"
        out.append(f"{rng}/{op}")
    return out


def breakdown(trace: Trace, top=10):
    """{"device_ops": the device ops that took the most time, summed by
    name; "idle_gaps": the device's idle time summed by what the host was
    doing}, each a list of [name, seconds], longest first."""
    by_name = {}
    for e in trace.device_ops():
        key = e.name[:160]
        by_name[key] = by_name.get(key, 0.0) + (e.end - e.start) * 1e-6
    gaps = idle_gaps(trace)
    labels = host_labels(trace, [(a + b) / 2 for a, b in gaps])
    by_label = {}
    for (a, b), lab in zip(gaps, labels):
        by_label[lab] = by_label.get(lab, 0.0) + (b - a) * 1e-6
    longest = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": longest(by_name), "idle_gaps": longest(by_label)}


def _kind(k):
    """kineto's activity type of a profiler event.  Where the event does
    not carry it (older torch), it is told from the device, the
    user-annotation flag and the name."""
    if hasattr(k, "activity_type"):
        return str(k.activity_type())
    on_device = str(k.device_type()).endswith("CUDA")
    if k.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    name = k.name()
    if on_device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def from_kineto(kineto_events) -> Trace:
    """A Trace from the profiler's kineto events (`prof.profiler.kineto_results
    .events()`)."""
    events, kinds = [], {}
    for k in kineto_events:
        kind = _kind(k)
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind not in ("user_annotation", "cpu_op") + DEVICE_KINDS:
            continue
        start = k.start_ns() / 1e3
        events.append(Event(k.name(), kind, start, start + k.duration_ns() / 1e3,
                            int(k.start_thread_id())))
    steps = [e for e in events if e.kind == "user_annotation" and e.name == STEP_RANGE]
    if len(steps) != 1:
        raise RuntimeError(f"the trace holds {len(steps)} ranges {STEP_RANGE!r}, not 1")
    return Trace(events=events, step=(steps[0].start, steps[0].end), kinds=kinds)


def capture(fn):
    """Run `fn()` once under torch.profiler inside the range STEP_RANGE,
    synchronizing the device before the range closes; returns (fn's
    result, the stopped profiler), for `from_kineto` to read later."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with record_function(STEP_RANGE):
            out = fn()
            torch.cuda.synchronize()
    finally:
        prof.stop()
    return out, prof



PHYSICS_RANGES = ("smooth", "collide", "efc", "solve", "integrate")


def range_ms(trace, name):
    """Summed host duration (ms) of the ranges `name` in the traced step,
    or None where there is no trace or no such range."""
    if trace is None:
        return None
    spans = trace.host_ranges(name)
    return sum(e - s for s, e in spans) / 1e3 if spans else None


def kernel_mean_us(trace, part):
    """Mean device duration (us) of the kernels whose name holds `part`
    in the traced step, or None where none ran."""
    if trace is None:
        return None
    durs = [e.end - e.start for e in trace.device_ops()
            if e.kind == "kernel" and part in e.name]
    return sum(durs) / len(durs) if durs else None
