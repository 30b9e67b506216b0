"""The traced step's device ops labelled by the program's stage marks.

While a profiler records, the program (`gym_so100_tpu_torch/profiling.py`)
launches an empty kernel `gst_span_<name>` on its one stream when a stage
span opens, and the mark of the enclosing span (`gst_span_none` at the
top) when it closes.  Walking the step's device ops in start order, each
op belongs to the span the last mark before it names; ops before the first
mark belong to no span ("none").  The marks themselves are left out of
every sum.  A trace without marks (a program that does not place them)
gives None throughout.
"""

from __future__ import annotations

from benchmark.trace import PHYSICS_RANGES, union_us

MARK = "gst_span_"


def mark_name(op_name):
    """The span a mark kernel names ("gst_span_smooth" or "gst_span_smooth()"
    -> "smooth"), or None for any other op."""
    if not op_name.startswith(MARK):
        return None
    return op_name[len(MARK):].split("(")[0]


def labelled(trace):
    """[(label, op)] of the step's device ops other than the marks, or None
    where there is no trace or it holds no mark."""
    if trace is None:
        return None
    label, out, marked = "none", [], False
    for e in trace.device_ops():
        name = mark_name(e.name)
        if name is None:
            out.append((label, e))
        else:
            label, marked = name, True
    return out if marked else None


def _pick(trace, labels):
    ops = labelled(trace)
    if ops is None:
        return None
    return [e for label, e in ops if label in labels]


def device_ms(trace, labels):
    """Union (ms) of the device ops labelled with any of `labels`, or None
    where there is no marked trace or no such op."""
    ops = _pick(trace, labels)
    return union_us((e.start, e.end) for e in ops) / 1e3 if ops else None


def device_ops(trace, labels):
    """Count of the device ops labelled with any of `labels`, or None where
    there is no marked trace or no such op."""
    ops = _pick(trace, labels)
    return float(len(ops)) if ops else None


def env_labels(trace):
    """The labels of the step's ops outside the five physics spans: no
    span, the sync, the autoreset, the renders."""
    ops = labelled(trace) or []
    return {label for label, _ in ops} - set(PHYSICS_RANGES)


def self_ms(trace, name, child):
    """Host time (ms) of the ranges `name` less that of the ranges `child`
    nested in them, or None where there is no trace or no range `name`."""
    if trace is None:
        return None
    outer = trace.host_ranges(name)
    if not outer:
        return None
    inner = [(s, e) for s, e in trace.host_ranges(child)
             if any(a <= s and e <= b for a, b in outer)]
    return (sum(e - s for s, e in outer) - sum(e - s for s, e in inner)) / 1e3


def counter_ratio(run, num, den, scale=1.0):
    """scale x counter `num` / counter `den` of the program's counters,
    which hold the traced step's counts (the only profiled region of a
    run), or None where there is no trace, no such counter or no count."""
    if run.trace is None:
        return None
    from gym_so100_tpu_torch import profiling

    read = getattr(profiling, "counters", None)
    if read is None:
        return None
    counts = read()
    if not counts.get(den) or num not in counts:
        return None
    return scale * counts[num] / counts[den]
