"""graphed_substep_pct.state: `graphed_substep_pct` in the state cell."""

from benchmark.harness import reader

read = reader("graphed_substep_pct")
