"""The port stands alone: no JAX, gymnasium, MuJoCo or JAX-package imports.

The machine with the GPU has none of those packages, so a single import of
one of them anywhere on the port's path, even inside a function, breaks the
port there.  Two guards:

* an AST scan of every module of gym_so100_tpu_torch and of chip_smoke.py
  for `import`/`from` statements (and import_module/__import__ calls with a
  literal name) of a forbidden package;
* a subprocess whose import system refuses those packages, which imports
  chip_smoke, builds the Model on the CPU, takes two BatchedEnv control
  steps through the plain PyTorch paths, renders a pixel observation,
  takes one SAC update, imports every agents module, both training
  scripts and the hull kernel A/B script, and takes one HER goal-env step and one Cartesian (mocap-weld)
  env step, then builds the single-env Gymnasium-API adapter (`SO100Env`,
  float64, state obs, on the CPU), takes one step with it and imports
  `envs.registration` and `envs.goal_env`'s `SO100GoalEnv`; then imports
  `parallel/dist.py` (and finds no process group to join),
  `profiling.py`, the three periphery modules (`interop/lerobot.py`,
  `render/mjpeg.py`, `teleop/input.py`) and every script, and builds the
  Panda EE scene's Model on the CPU.
"""

import ast
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gymnasium", "mujoco",
             "dm_control", "gym_so100_tpu")


def _port_files():
    files = sorted((ROOT / "gym_so100_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def _violations(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                        and _forbidden(arg.value):
                    bad.append(arg.value)
    return bad


def test_scan_finds_the_port():
    files = _port_files()
    assert len(files) > 15
    assert all(f.exists() for f in files)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    assert _violations(path) == []


def test_scan_catches_imports_inside_functions(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(textwrap.dedent("""
        import os
        def f():
            import jax.numpy as jnp
            from gym_so100_tpu.models import mjcf
            import importlib
            importlib.import_module("mujoco")
        from .relative import thing
    """))
    assert _violations(probe) == ["jax.numpy", "gym_so100_tpu.models", "mujoco"]


_RUN_WITHOUT = r"""
import importlib.abc, sys
FORBIDDEN = %r

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, %r)
import torch
import chip_smoke  # the work sits under `if __name__ == "__main__"`
from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.parallel.batch import BatchedEnv

m, aux = build_model(max_contacts=16, device="cpu")
assert m.nv == 12 and m.qpos0.dtype == torch.float32
env = BatchedEnv(m, num_envs=8, device="cpu")
es = env.reset(seed=0)
g = torch.Generator().manual_seed(0)
for _ in range(2):
    es, obs, reward, term, trunc, info = env.step(es, torch.rand(8, 6, generator=g) * 2 - 1)
    assert bool(torch.isfinite(obs).all()) and obs.shape == (8, 15)
penv = BatchedEnv(m, num_envs=2, device="cpu", obs_mode="pixels_agent_pos",
                  render_aux=aux, obs_height=24, obs_width=32)
assert penv.observe(penv.reset(seed=0))["pixels"].shape == (2, 24, 32, 3)
from gym_so100_tpu_torch.agents import bc, convert, metrics, sac, train
from gym_so100_tpu_torch.scripts import train_sac

s = sac.SAC(sac.SACConfig(batch_size=8, buffer_size=32), device="cpu")
st = s.init(seed=0)
st, m = s.train_step(st, obs, torch.rand(8, 6, generator=g) * 2 - 1, reward,
                     info["final_obs"], term)
assert st.step == 1 and all(bool(torch.isfinite(v)) for v in m.values())
from gym_so100_tpu_torch.agents import her, train_her
from gym_so100_tpu_torch.envs import ee_env, goal_env
from gym_so100_tpu_torch.scripts import hull_ab, train_sac_her

tr = train_her.HERTrainer(env.m, train_her.HERConfig(num_envs=2, her_episodes=2), sac.SACConfig(
    obs_dim=18, buffer_size=1, batch_size=8, features=(16, 16)), device="cpu")
ts = tr.init(seed=0)
ts, rew, succ, hm = tr._do_step(ts, learn=False)
assert rew.shape == (2,) and ts.genv.t.tolist() == [1, 1] and ts.genv.total == 2
assert bool(torch.isfinite(ts.st_obs[:, 0]).all())
m_ee, _ = build_model(ee_env.EE_XML, max_contacts=8, device="cpu")
ee = ee_env.CartesianBatchedEnv(m_ee, num_envs=2, device="cpu")
es, obs, reward, term, trunc, info = ee.step(ee.reset(seed=0), torch.zeros(2, 4))
assert obs.shape == (2, 15) and bool(torch.isfinite(info["ee_err"]).all())
from gym_so100_tpu_torch.envs import gym_env, registration
from gym_so100_tpu_torch.envs.goal_env import SO100GoalEnv

senv = gym_env.SO100Env(task="so100_touch_cube", obs_type="so100_state",
                        dtype=torch.float64, device="cpu")
obs, info = senv.reset(seed=0)
obs, reward, term, trunc, info = senv.step(senv.action_space.sample())
assert obs.shape == (15,) and isinstance(reward, float) and trunc is False
assert set(registration.REGISTRY) == {"gym_so100_tpu/SO100TouchCube-v0",
    "gym_so100_tpu/SO100TouchCubeSparse-v0", "gym_so100_tpu/SO100CubeToBin-v0"}
from gym_so100_tpu_torch import profiling
from gym_so100_tpu_torch.interop import lerobot
from gym_so100_tpu_torch.parallel import dist
from gym_so100_tpu_torch.render import mjpeg
from gym_so100_tpu_torch.teleop import input as teleop_input
import gym_so100_tpu_torch.scripts as scripts_pkg, importlib, pkgutil

for mod in pkgutil.iter_modules(scripts_pkg.__path__):
    importlib.import_module(f"gym_so100_tpu_torch.scripts.{mod.name}")
assert dist.init_distributed() is False
from gym_so100_tpu_torch.models.builder import PANDA_XML

m_panda, aux_panda = build_model(PANDA_XML, max_contacts=8, device="cpu")
assert (m_panda.nv, m_panda.nu) == (15, 8) and "home" in aux_panda["keyframes"]
loaded = sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
assert not loaded, loaded
print("ISOLATED OK")
"""


def test_port_runs_with_forbidden_packages_refused():
    code = _RUN_WITHOUT % (FORBIDDEN, str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ISOLATED OK" in res.stdout


def test_entry_points_default_to_the_gpu():
    """Without a card, the default device raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from gym_so100_tpu_torch.parallel.batch import BatchedEnv

    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedEnv()


def test_wrappers_never_fall_back_for_device_tensors():
    """A tensor that is not on the CPU reaches the kernel path, which checks
    it and raises: there is no silent fallback to the plain version."""
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    meta = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")
    tb = types.SimpleNamespace(
        verts=meta(25, 192), D=meta(132, 3), counts=meta(25, dt=torch.int32),
        i1=meta(129, dt=torch.int32), i2=meta(129, dt=torch.int32), vtot=604)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hull_lanes.sweep_h(meta(75, 8), meta(225, 8), tb)
    from gym_so100_tpu_torch.scripts import probe_chain

    probe_chain.chain_fused.launches = 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        probe_chain.chain_fused(meta(4, 8), meta(3, 8), meta(9, 8))
    assert probe_chain.chain_fused.launches == 0
