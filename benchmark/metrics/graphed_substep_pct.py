"""graphed_substep_pct: the share (%) of the traced control step's physics
substeps that ran as replays of a CUDA graph: the program's counters
100 x `substep.graphed` / (`substep.graphed` + `substep.eager`), counted
by `forward.n_steps_batched` while the profiler records.  None where the
program counts no substeps."""


def read(run):
    if run.trace is None:
        return None
    from gym_so100_tpu_torch import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    counts = counters()
    graphed, eager = counts.get("substep.graphed", 0.0), counts.get("substep.eager", 0.0)
    if not graphed + eager:
        return None
    return 100.0 * graphed / (graphed + eager)
