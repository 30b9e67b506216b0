"""env_device_ms.state: device time (ms) of one traced control step outside
the five physics stages: the union of the device ops labelled by no
physics mark (`benchmark/spans.py`): the kinematics refresh, the reward,
the observations, the done test's sync, the autoreset and, with pixel
observations, the renders."""

from benchmark import spans


def read(run):
    return spans.device_ms(run.trace, spans.env_labels(run.trace))
