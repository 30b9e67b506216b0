"""The import checks compare whole top-level names: the JAX package's is
caught, the port's (whose name begins with it) is not; a run loads
neither JAX nor the JAX package, and the reference loads no part of the
program."""

import json
import subprocess
import sys
import types

from benchmark import imports
from benchmark.harness import ROOT


def test_planted_jax_package_is_caught_and_port_is_not():
    mods = {"gym_so100_tpu_torch": types.ModuleType("p"),
            "gym_so100_tpu_torch.parallel.batch": types.ModuleType("p"),
            "torch": types.ModuleType("t")}
    assert imports.forbidden_loaded(modules=mods) == []
    mods["gym_so100_tpu.ops.smooth"] = types.ModuleType("j")
    assert imports.forbidden_loaded(modules=mods) == ["gym_so100_tpu"]
    mods["jax.numpy"] = types.ModuleType("j")
    assert imports.forbidden_loaded(modules=mods) == ["gym_so100_tpu", "jax"]
    assert imports.forbidden_loaded([imports.PROGRAM], modules=mods) == [imports.PROGRAM]


def _loaded_after(code):
    """Top-level module names loaded by a fresh interpreter after `code`."""
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; import json; "
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_planted_import_is_caught_in_a_real_process():
    loaded = _loaded_after("import types; sys.modules['gym_so100_tpu'] = types.ModuleType('x')")
    assert "gym_so100_tpu" in loaded
    assert imports.forbidden_loaded(modules=loaded) == ["gym_so100_tpu"]


def test_the_run_path_loads_no_jax():
    loaded = _loaded_after(
        "from benchmark import harness, check, calibrate, trace, traffic, roofline; "
        "import benchmark.programs.batched_env; "
        "import gym_so100_tpu_torch.parallel.batch, gym_so100_tpu_torch.render.rasterizer, "
        "gym_so100_tpu_torch.models.builder")
    assert imports.PROGRAM in loaded
    assert imports.forbidden_loaded(modules=loaded) == []


def test_the_reference_loads_no_program():
    loaded = _loaded_after(
        "import benchmark.reference.batch, benchmark.reference.render.rasterizer, "
        "benchmark.reference.models.builder")
    assert imports.forbidden_loaded(imports.FORBIDDEN_IN_RUN + (imports.PROGRAM,),
                                    modules=loaded) == []
