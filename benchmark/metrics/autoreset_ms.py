"""autoreset_ms: self time (ms) of the `autoreset` range that the program
opens in `BatchedEnv.step` in one traced control step: the range less the
`render` ranges nested in it (the fresh episodes' frames)."""

from benchmark import spans


def read(run):
    return spans.self_ms(run.trace, "autoreset", "render")
