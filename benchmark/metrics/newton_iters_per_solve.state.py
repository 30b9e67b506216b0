"""newton_iters_per_solve.state: Newton iterations per env solve in one
traced control step: the program's counters `newton.iterations` (the
solver's per-env iteration counts, summed) over `newton.solves` (envs x
solves), counted while the profiler records."""

from benchmark import spans


def read(run):
    return spans.counter_ratio(run, "newton.iterations", "newton.solves")
