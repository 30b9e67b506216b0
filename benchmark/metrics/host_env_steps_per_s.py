"""host_env_steps_per_s: `env_steps_per_s` (every env-step the window
completed over all of its wall time) read per layer, in a cell where the
host's dispatch paces the step and the rate swings with the host's speed."""

from benchmark.harness import reader

read = reader("env_steps_per_s")
