"""hull_sweep_roofline: the hull sweep kernel's share (%) of its roofline:
the least time its shapes need (the larger of its bytes at the memory
bandwidth and its operations at the float32 rate, `benchmark/roofline.py`)
over the mean device time of its launches in one traced control step."""

from benchmark import roofline
from benchmark.trace import kernel_mean_us


def read(run):
    mean_us = kernel_mean_us(run.trace, "hull_sweep")
    if mean_us is None or run.shapes is None:
        return None
    h = run.shapes["hull"]
    nbytes, ops = roofline.hull_sweep_work(run.shapes["B"], h["G"], h["ND"], h["P"],
                                           h["Vmax"], h["counts"])
    return 100.0 * roofline.least_seconds(nbytes, ops) / (mean_us * 1e-6)
