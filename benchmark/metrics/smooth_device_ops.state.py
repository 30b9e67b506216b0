"""smooth_device_ops.state: the device ops (kernels, copies, sets; the marks
left out) that one traced control step runs in the `smooth` stage: those
between a `gst_span_smooth` mark and the next mark (`benchmark/spans.py`)."""

from benchmark import spans


def read(run):
    return spans.device_ops(run.trace, {"smooth"})
