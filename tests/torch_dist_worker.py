"""One rank of the port's multi-process runs in tests/test_torch_dist.py.

    python tests/torch_dist_worker.py MODE RANK WORLD PORT DIR

Joins a gloo process group of WORLD ranks at localhost:PORT through
`parallel.dist.init_distributed` (device "cpu"), runs MODE and writes its
results to DIR/MODE_RANK.pt:

* update: `SAC.update(group=...)` on this rank's rows of the float64 batch,
  draws and parameters in DIR/update_in.pt;
* train: `env_run` and `train_run` below on the process group.

`env_run` and `train_run` also run in one process, without a group, as the
reference the ranks are held to.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gym_so100_tpu_torch.agents.convert import sac_params_from_numpy, to_flax  # noqa: E402
from gym_so100_tpu_torch.agents.sac import SAC, SACConfig  # noqa: E402
from gym_so100_tpu_torch.agents.train import TrainConfig, Trainer  # noqa: E402
from gym_so100_tpu_torch.models.builder import build_model  # noqa: E402
from gym_so100_tpu_torch.parallel import dist  # noqa: E402
from gym_so100_tpu_torch.parallel.batch import BatchedEnv  # noqa: E402

NUM_ENVS = 8
K = 8
EPISODE = 2        # control steps per episode: every env auto-resets twice


def _model():
    # float64 (run without the arm-mesh pairs, so that a control step is
    # quick on the CPU): a rank's rows round as the one-process batch's,
    # up to the ulps that the float32 observations do not see
    return build_model(max_contacts=K, device="cpu", dtype=torch.float64)[0]


def env_run(group=None):
    """BatchedEnv at NUM_ENVS envs (this rank's rows on a group): reset,
    then 3 control steps with actions for the whole batch, env 0 one step
    short of its limit (so only the first rank has a done env on step 1).
    Returns the (whole-batch) obs of each step and the last state's qpos."""
    env = BatchedEnv(_model(), "so100_touch_cube", NUM_ENVS, hull_contacts=False,
                     device="cpu", seed=3, max_episode_steps=4)
    if group is not None:
        env.shard(group)
    es = env.reset(seed=4)
    t = torch.zeros(NUM_ENVS, dtype=es.t.dtype)
    t[0] = env.max_episode_steps - 1
    es = es.replace(t=t[env.rows])
    gen = torch.Generator().manual_seed(5)
    gather = (lambda x: x) if group is None else (lambda x: dist.all_gather_env(x, group))
    obs = [gather(env.observe(es))]
    for _ in range(3):
        acts = torch.rand(NUM_ENVS, 6, generator=gen, dtype=torch.float64) * 2 - 1
        es, o, *_ = env.step(es, acts[env.rows])
        obs.append(gather(o))
    return {"obs": torch.stack(obs), "qpos": gather(es.physics.qpos)}


def train_run(group=None):
    """Trainer at NUM_ENVS envs: 2 warm-up and 2 learning env-batch steps,
    utd 2, episodes of EPISODE steps; returns the learner state, the env
    state and the log lines."""
    tr = Trainer(_model(), TrainConfig(
        task="so100_touch_cube", num_envs=NUM_ENVS, total_steps=4 * NUM_ENVS,
        learning_starts=2 * NUM_ENVS, utd=2, log_every=1, hull_contacts=False),
        SACConfig(features=(32, 32), batch_size=16, buffer_size=64),
        device="cpu", group=group)
    tr.env.max_episode_steps = EPISODE
    lines = []
    st = tr.train(seed=0, progress=lines.append)
    out = tr.sac.state_dict(st)
    qpos = tr.env_state.physics.qpos
    out["env_qpos"] = qpos if group is None else dist.all_gather_env(qpos, group)
    out["lines"] = lines
    return out


def update_run(path, group):
    """SAC.update on this rank's rows of the float64 batch in `path` (numpy
    arrays: the JAX SAC's parameter trees, its normalizer, the batch and
    the two Gaussian draws of the whole batch)."""
    d = torch.load(path, weights_only=False)
    s = SAC(SACConfig(buffer_size=1024), device="cpu", dtype=torch.float64)
    st = sac_params_from_numpy(s, d["actor"], d["critic"], d["critic"],
                               log_alpha=d["log_alpha"], normalizer=d["normalizer"])
    rows = dist.env_rows(d["batch"]["act"].shape[0], group)
    batch = {k: torch.from_numpy(v[rows]).to(torch.bool if k == "done" else torch.float64)
             for k, v in d["batch"].items()}
    st, m = s.update(st, batch, noise=[torch.from_numpy(e[rows]) for e in d["eps"]],
                     group=group)
    return {"metrics": {k: v.numpy() for k, v in m.items()},
            "params": [to_flax(st.actor), to_flax(st.critic), to_flax(st.target_critic),
                       st.log_alpha.detach().numpy()]}


def main():
    mode, rank, world, port, out_dir = sys.argv[1:6]
    assert dist.init_distributed(f"localhost:{port}", int(world), int(rank), device="cpu")
    group = dist.env_mesh()
    torch.manual_seed(1234 + int(rank))     # nothing may draw from the global generator
    if mode == "update":
        out = update_run(os.path.join(out_dir, "update_in.pt"), group)
    else:
        out = {"env": env_run(group), "train": train_run(group)}
    torch.save(out, os.path.join(out_dir, f"{mode}_{rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
