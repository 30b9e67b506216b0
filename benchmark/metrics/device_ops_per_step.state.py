"""device_ops_per_step.state: `device_ops_per_step` (see that reader),
read in the state cell, where the end-to-end metric it moves is the
device's busy time per step, not the host-paced rate."""

from benchmark.harness import reader

read = reader("device_ops_per_step")
