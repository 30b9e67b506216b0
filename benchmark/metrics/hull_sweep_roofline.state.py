"""hull_sweep_roofline.state: `hull_sweep_roofline` (see that reader),
read in the state cell, where the end-to-end metric it moves is the
device's busy time per step, not the host-paced rate."""

from benchmark.harness import reader

read = reader("hull_sweep_roofline")
