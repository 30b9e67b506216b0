"""setup_s: from process start to the window's start: imports, device
initialisation, the kernel library's load (its nvcc build on a checkout's
first run), the model build, env and renderer construction, the reset and
the warm-up control steps."""


def read(run):
    return run.setup_s
