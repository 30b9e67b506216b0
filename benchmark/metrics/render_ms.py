"""render_ms: host time (ms) of the `render` ranges that the program opens
in `Renderer.render_batch`, summed over one traced control step (the
terminal frames' render and, inside the autoreset, the fresh episodes')."""

from benchmark.trace import range_ms


def read(run):
    return range_ms(run.trace, "render")
