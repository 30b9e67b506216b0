"""newton_capped_pct.state: the share (%) of env solves in one traced
control step that used the solver's whole iteration budget: the
program's counters 100 x `newton.capped` / `newton.solves`."""

from benchmark import spans


def read(run):
    return spans.counter_ratio(run, "newton.capped", "newton.solves", 100.0)
