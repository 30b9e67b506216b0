"""efc_ms: host time (ms) of the `efc` ranges that the program opens in
`ops/forward.py`, summed over the ten substeps of one traced control step."""

from benchmark.trace import range_ms


def read(run):
    return range_ms(run.trace, "efc")
