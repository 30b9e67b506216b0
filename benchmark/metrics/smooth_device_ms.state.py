"""smooth_device_ms.state: device time (ms) of the `smooth` stage in one traced
control step: the union of the device ops that run between a
`gst_span_smooth` mark and the next mark (`benchmark/spans.py`), over the
ten substeps."""

from benchmark import spans


def read(run):
    return spans.device_ms(run.trace, {"smooth"})
