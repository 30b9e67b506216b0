"""The port's process-group path (`parallel/dist.py`, `BatchedEnv.shard`, the
Trainer and `SAC.update` on a process group) on the CPU, with gloo.

* `init_distributed`: False for one process; the variables it reads (JAX's
  first, then torch's), the backend it picks from the device, and the
  refusal of an incomplete set.
* Two ranks (subprocesses, as tests/test_multihost.py starts JAX's), each
  with its half of a float64 batch, take `SAC.update(group=...)`: held to
  JAX's own sharded update (`dist.replicate`, `dist.shard_env` on the
  8-device CPU mesh of tests/conftest.py, the same parameters carried
  across by `agents/convert.py`, JAX's draws given to the ranks): losses
  and parameters to 1e-10 of each tensor's largest magnitude, and the two
  ranks bit-equal.
* Two ranks against one process with the same seed (float64 env, B = 8):
  `BatchedEnv.shard` (reset, an autoreset on the first rank's rows only,
  obs of every step) and the Trainer (2 warm-up and 2 learning env-batch
  steps of 2-step episodes, utd 2): obs, the buffer, the normalizer, the
  parameters and the env state to 1e-12, and the parameters bit-equal
  across ranks.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.agents import sac as jax_sac
from gym_so100_tpu.parallel import dist as jax_dist
from gym_so100_tpu_torch.parallel import dist

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_dist_worker.py")
OBS, ACT, BATCH = 15, 6, 16
DIST_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
             "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_ranks(mode, tmp_path, world=2):
    """Start `world` worker ranks; returns a function that waits for them
    and returns their outputs."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k not in DIST_VARS}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(r), str(world), port, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(world)]

    def wait(timeout=300):
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0 and f"RANK_OK {r}" in log, f"rank {r}:\n{log[-4000:]}"
        return [torch.load(tmp_path / f"{mode}_{r}.pt", weights_only=False)
                for r in range(world)]

    return wait


# -- init_distributed ---------------------------------------------------------


@pytest.fixture
def no_dist_vars(monkeypatch):
    for k in DIST_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_init_distributed_is_false_for_one_process(no_dist_vars):
    assert dist.init_distributed() is False
    assert dist.world() == (0, 1) and dist.env_mesh() is None
    assert dist.env_rows(8) == slice(0, 8)


@pytest.mark.parametrize("names", [
    {"JAX_COORDINATOR_ADDRESS": "host:1234", "JAX_NUM_PROCESSES": "3",
     "JAX_PROCESS_ID": "2"},
    {"MASTER_ADDR": "host", "MASTER_PORT": "1234", "WORLD_SIZE": "3", "RANK": "2"},
])
def test_init_distributed_reads_the_variables(no_dist_vars, names):
    """JAX's variables or torch's give the same call; device "cpu" picks
    gloo; the default device, CUDA, raises on a machine without a GPU."""
    calls = []
    no_dist_vars.setattr(torch.distributed, "is_initialized", lambda: False)
    no_dist_vars.setattr(torch.distributed, "init_process_group",
                         lambda *a, **kw: calls.append((a, kw)))
    for k, v in names.items():
        no_dist_vars.setenv(k, v)
    assert dist.init_distributed(device="cpu") is True
    assert calls == [(("gloo",), dict(init_method="tcp://host:1234", world_size=3,
                                      rank=2))]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dist.init_distributed()


def test_init_distributed_refuses_an_incomplete_set(no_dist_vars):
    no_dist_vars.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        dist.init_distributed(device="cpu")


# -- the sharded update against JAX's ----------------------------------------


def _jax_sharded_update(tmp_path):
    """JAX's update on the float64 batch sharded over the 8-device mesh, its
    state replicated; writes the same inputs for the port's ranks."""
    cfg = jax_sac.SACConfig(buffer_size=1024, batch_size=BATCH)
    s = jax_sac.SAC(cfg)
    st = s.init(jax.random.PRNGKey(0))
    f64 = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), t)
    actor, critic = f64(st.actor_params), f64(st.critic_params)
    rng = np.random.RandomState(2)
    norm = jax_sac.Normalizer.create(OBS, jnp.float64).update(
        jnp.asarray(rng.randn(64, OBS) * 0.7 + 0.1))
    log_alpha = jnp.asarray(0.1, jnp.float64)
    st = dataclasses.replace(
        st, actor_params=actor, critic_params=critic, target_critic_params=critic,
        log_alpha=log_alpha, actor_opt=s.actor_tx.init(actor),
        critic_opt=s.critic_tx.init(critic), alpha_opt=s.alpha_tx.init(log_alpha),
        normalizer=norm)
    obs = rng.randn(BATCH, OBS) * 0.5 + 0.2
    batch = dict(obs=obs, act=rng.uniform(-1, 1, (BATCH, ACT)), rew=rng.randn(BATCH),
                 next_obs=obs + 0.05 * rng.randn(BATCH, OBS), done=rng.rand(BATCH) < 0.3)
    _, k1, k2 = jax.random.split(st.key, 3)
    eps = [np.asarray(jax.random.normal(k, (BATCH, ACT), jnp.float64)) for k in (k1, k2)]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    torch.save(dict(actor=np_tree(actor), critic=np_tree(critic),
                    log_alpha=np.asarray(log_alpha), batch=batch, eps=eps,
                    normalizer={k: np.asarray(getattr(norm, k))
                                for k in ("mean", "var", "count")}),
               tmp_path / "update_in.pt")

    mesh = jax_dist.env_mesh(8)
    st = jax_dist.replicate(st, mesh)
    jb = jax_dist.shard_env({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    assert jb["obs"].sharding.spec == jax.sharding.PartitionSpec("env", None)
    st2, metrics = jax.jit(s.update)(st, jb)
    return np_tree(metrics), [np_tree(x) for x in (
        st2.actor_params, st2.critic_params, st2.target_critic_params, st2.log_alpha)]


def _assert_rel(actual, expected, rtol, what):
    for (path, a), (_, e) in zip(jax.tree_util.tree_leaves_with_path(actual),
                                 jax.tree_util.tree_leaves_with_path(expected)):
        a, e = np.asarray(a, np.float64), np.asarray(e, np.float64)
        assert a.shape == e.shape, (what, path)
        scale = max(float(np.abs(e).max()), 1e-30)
        np.testing.assert_allclose(a, e, rtol=0, atol=rtol * scale, err_msg=f"{what} {path}")


def test_sharded_update_matches_jax_on_the_mesh(tmp_path):
    assert jax.device_count() >= 8, "conftest must provide the virtual mesh"
    m_j, p_j = _jax_sharded_update(tmp_path)
    r0, r1 = _start_ranks("update", tmp_path)()
    for k in ("critic_loss", "actor_loss", "alpha", "entropy"):
        _assert_rel(r0["metrics"][k], m_j[k], 1e-10, k)
        assert np.array_equal(r0["metrics"][k], r1["metrics"][k]), k
    assert len(jax.tree_util.tree_leaves(r0["params"])) == len(jax.tree_util.tree_leaves(p_j))
    _assert_rel(r0["params"], p_j, 1e-10, "params")
    for a, b in zip(jax.tree_util.tree_leaves(r0["params"]),
                    jax.tree_util.tree_leaves(r1["params"])):
        assert np.array_equal(np.asarray(a), np.asarray(b)), "ranks differ"


# -- two ranks against one process --------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's env and trainer runs on two ranks, and meanwhile in this
    process without a group."""
    sys.path.insert(0, HERE)
    import torch_dist_worker as w

    wait = _start_ranks("train", tmp_path_factory.mktemp("dist_train"))
    one = {"env": w.env_run(), "train": w.train_run()}
    return wait(), one


def _close(a, b, what, tol=1e-12):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _close(a[k], b[k], f"{what}.{k}", tol)
        return
    if isinstance(a, torch.Tensor):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        if a.dtype == torch.bool or not a.is_floating_point():
            assert torch.equal(a, b), what
        else:
            torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=what)
        return
    assert a == b, what


def test_sharded_env_equals_the_one_process_batch(runs):
    ranks, one = runs
    # env 0, on rank 0, auto-resets on the first step: a new spawn there
    assert not torch.equal(one["env"]["obs"][1, 0, :3], one["env"]["obs"][0, 0, :3])
    for r, out in enumerate(ranks):
        _close(out["env"], one["env"], f"rank {r} env")


def test_sharded_trainer_equals_the_one_process_run(runs):
    ranks, one = runs
    ref = one["train"]
    assert ref["buffer"]["size"] == 32 and ref["step"] == 4 and len(ref["lines"]) == 4
    for r, out in enumerate(ranks):
        for part in ("buffer", "normalizer", "actor", "critic", "target_critic",
                     "log_alpha", "env_qpos", "step", "batch_steps"):
            _close(out["train"][part], ref[part], f"rank {r} {part}")
    # only rank 0 logs, and its lines are the one-process run's but the clock
    drop = lambda lines: [{k: v for k, v in ln.items() if k != "sps"} for ln in lines]
    assert drop(ranks[0]["train"]["lines"]) == drop(ref["lines"])
    assert ranks[1]["train"]["lines"] == []


def test_ranks_hold_bit_equal_learners(runs):
    (r0, r1), _ = runs
    for part in ("actor", "critic", "target_critic", "normalizer"):
        for k, v in r0["train"][part].items():
            assert torch.equal(v, r1["train"][part][k]), f"{part}.{k}"
    assert torch.equal(r0["train"]["log_alpha"], r1["train"]["log_alpha"])
    assert torch.equal(r0["train"]["generator"], r1["train"]["generator"])
