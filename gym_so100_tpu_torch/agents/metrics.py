"""Metric sink for the trainers' `progress` callbacks: JSON lines on stdout,
and TensorBoard scalars where `torch.utils.tensorboard` imports.

The port's own copy of `gym_so100_tpu/agents/metrics.py`.  Numeric fields
become scalars under their own keys, stepped by "env_steps" (or "eval_at"
for eval lines).  Without a TensorBoard backend the logger writes stdout
only.
"""

from __future__ import annotations

import json


class MetricLogger:
    """Callable progress sink: MetricLogger(logdir)(line_dict).

    line_dict: {"env_steps": int, "mean_reward": float, ...} or
    {"eval_at": int, "eval_mean_return": float, ...}.
    """

    def __init__(self, logdir=None, stdout=True):
        self.stdout = stdout
        self._tb = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"[metrics] tensorboard unavailable ({e}); stdout only")
            else:
                self._tb = SummaryWriter(log_dir=logdir)

    def __call__(self, line: dict):
        if self.stdout:
            print(json.dumps(line), flush=True)
        if self._tb is None:
            return
        step = line.get("env_steps", line.get("eval_at"))
        if step is None:
            return
        for k, v in line.items():
            if k in ("env_steps", "eval_at"):
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self._tb.add_scalar(k, float(v), int(step))
        self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
