"""render_device_ms: device time (ms) of the renders in one traced control
step: the union of the device ops between a `gst_span_render` mark and
the next mark (`benchmark/spans.py`)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run.trace, {"render"})
