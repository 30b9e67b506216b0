"""The check that a run loaded neither JAX nor the JAX package.

Modules are compared by their top-level name, the part before the first
dot, whole: the port's name, `gym_so100_tpu_torch`, begins with the JAX
package's, `gym_so100_tpu`, and is not the JAX package.
"""

from __future__ import annotations

import sys

FORBIDDEN_IN_RUN = ("jax", "jaxlib", "flax", "gym_so100_tpu")
PROGRAM = "gym_so100_tpu_torch"


def loaded_top_level(modules=None):
    """The top-level names of the loaded modules."""
    return {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}


def forbidden_loaded(forbidden=FORBIDDEN_IN_RUN, modules=None):
    """The forbidden top-level names among the loaded modules, sorted."""
    return sorted(loaded_top_level(modules) & set(forbidden))
