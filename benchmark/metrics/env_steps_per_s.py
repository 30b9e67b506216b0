"""env_steps_per_s: every env-step the window completed (envs x control
steps) over all the wall time from the window's start to the end of its
last control step, which ends on a device synchronize."""


def read(run):
    if not run.steps:
        return None
    return run.env_steps / run.window_s
