"""collide_device_ops.state: the device ops (kernels, copies, sets; the marks
left out) that one traced control step runs in the `collide` stage: those
between a `gst_span_collide` mark and the next mark (`benchmark/spans.py`)."""

from benchmark import spans


def read(run):
    return spans.device_ops(run.trace, {"collide"})
