"""newton_solve_roofline: the Newton solve kernel's share (%) of its bytes
bound: the least time to read its packed inputs and write its result once
at the memory bandwidth (`benchmark/roofline.py`; its operations depend on
iteration counts the env step does not expose, so they are not counted)
over the mean device time of its launches in one traced control step."""

from benchmark import roofline
from benchmark.trace import kernel_mean_us


def read(run):
    mean_us = kernel_mean_us(run.trace, "newton_solve")
    if mean_us is None or run.shapes is None:
        return None
    s = run.shapes
    nbytes = roofline.newton_solve_bytes(s["B"], s["nv"], s["neq"], s["nf"], s["nl"], s["K"])
    return 100.0 * roofline.least_seconds(nbytes) / (mean_us * 1e-6)
