"""The port's SAC trainer on the CPU at B = 8: the stage curriculum against
the JAX trainer's, the warm-up and learning rollouts, the buffer against a
replay of the env, save/restore/resume, evaluation and the CLI."""

import types

import numpy as np
import pytest
import torch

from gym_so100_tpu.agents.sac import SACConfig as JaxSACConfig
from gym_so100_tpu.agents.sac import SACState as JaxSACState
from gym_so100_tpu.agents.train import REFERENCE_STAGES as JAX_STAGES
from gym_so100_tpu.agents.train import TrainConfig as JaxTrainConfig
from gym_so100_tpu.agents.train import Trainer as JaxTrainer
from gym_so100_tpu_torch.agents.sac import SACConfig
from gym_so100_tpu_torch.agents.train import REFERENCE_STAGES, TrainConfig, Trainer
from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.parallel.batch import BatchedEnv
from gym_so100_tpu_torch.scripts import train_sac

B = 8
TASK = "so100_touch_cube"
LIMIT = 2          # episode limit: every lane truncates at steps 2 and 4
SMALL = SACConfig(batch_size=16, buffer_size=256, features=(32, 32))


@pytest.fixture(scope="module")
def model_and_aux():
    return build_model(max_contacts=32, device="cpu")


@pytest.fixture(scope="module")
def model(model_and_aux):
    return model_and_aux[0]


def _trainer(model, total_steps, ckpt_dir, stages=(), render_aux=None):
    tr = Trainer(model, TrainConfig(
        task=TASK, num_envs=B, total_steps=total_steps, learning_starts=2 * B, utd=2,
        log_every=1, checkpoint_dir=str(ckpt_dir), checkpoint_every=B, stages=stages,
        render_aux=render_aux,
    ), SMALL, device="cpu")
    tr.env.max_episode_steps = LIMIT
    return tr


@pytest.mark.parametrize("env_steps", [0, 40_000 * B - 1, 40_000 * B, 65_000 * B - 1,
                                       65_000 * B, 85_000 * B - 1, 85_000 * B, 10**9])
def test_apply_stage_matches_jax(model, env_steps):
    assert REFERENCE_STAGES == JAX_STAGES
    tr = Trainer(model, TrainConfig(task=TASK, num_envs=B, stages=REFERENCE_STAGES),
                 SMALL, device="cpu")
    st = tr._apply_stage(tr.sac.init(0), env_steps)
    jax_self = types.SimpleNamespace(
        tcfg=JaxTrainConfig(num_envs=B, stages=JAX_STAGES),
        sac=types.SimpleNamespace(cfg=JaxSACConfig()))
    st_j = JaxTrainer._apply_stage(jax_self, JaxSACState(*[None] * 11), env_steps)
    assert st.target_entropy == float(st_j.target_entropy)
    assert st.lr_scale == pytest.approx(float(st_j.lr_scale), rel=1e-7)
    # the learning rate reaches the optimizers at the next update
    batch = st.buffer.sample(4, st.generator)
    tr.sac.update(st, batch)
    assert st.critic_opt.param_groups[0]["lr"] == SMALL.lr * st.lr_scale


def _ckpt_names(path):
    return sorted((p.name for p in path.glob("ckpt_*")),
                  key=lambda n: int(n[len("ckpt_"):-len(".pt")]))


@pytest.fixture(scope="module")
def runs(model_and_aux, tmp_path_factory):
    """Run 1: 3 env-batch steps (2 warm-up, 1 learning), a checkpoint after
    each.  Run 2: a new trainer restores the last one and goes on to 5."""
    model, aux = model_and_aux
    ckpt = tmp_path_factory.mktemp("ckpt")
    lines1, lines2 = [], []
    tr1 = _trainer(model, 3 * B, ckpt, render_aux=aux)
    st1 = tr1.train(seed=0, progress=lines1.append)
    buffer1 = {k: getattr(st1.buffer, k).clone() for k in st1.buffer.FIELDS}
    meta1 = dict(step=st1.step, size=st1.buffer.size, batch_steps=st1.batch_steps,
                 norm=st1.normalizer.tensors())
    names1 = _ckpt_names(ckpt)

    tr2 = _trainer(model, 5 * B, ckpt)
    restored = tr2.restore(ckpt / f"ckpt_{3 * B}.pt")
    restored_params = [p.clone() for p in restored.actor.parameters()]
    st2 = tr2.train(seed=0, progress=lines2.append, init_state=restored)
    return dict(tr1=tr1, st1=st1, lines1=lines1, buffer1=buffer1, meta1=meta1,
                names1=names1, st2=st2, lines2=lines2, restored_params=restored_params,
                names2=_ckpt_names(ckpt), ckpt=ckpt)


def test_warmup_then_learning(runs):
    lines = runs["lines1"]
    assert [ln["env_steps"] for ln in lines] == [B, 2 * B, 3 * B]
    assert "critic_loss" not in lines[0] and "critic_loss" not in lines[1]
    assert {"critic_loss", "actor_loss", "alpha", "entropy"} <= set(lines[2])
    assert all(np.isfinite(v) for ln in lines for v in ln.values())
    meta = runs["meta1"]
    assert meta["step"] == 2                 # utd updates after one learning step
    assert meta["size"] == 3 * B and meta["batch_steps"] == 3
    assert runs["names1"] == [f"ckpt_{k * B}.pt" for k in (1, 2, 3)]
    assert (runs["ckpt"] / "sac_config.json").exists()


def test_buffer_holds_the_env_transitions(runs, model):
    """A fresh env fed the stored actions reproduces every stored transition;
    at the boundary (step 2) next_obs is the terminal obs, not the reset obs
    the next transition starts from."""
    buf = runs["buffer1"]
    env = BatchedEnv(model, TASK, B, max_episode_steps=LIMIT, device="cpu")
    es = env.reset(seed=1)
    obs = env.observe(es)
    for k in range(3):
        rows = slice(k * B, (k + 1) * B)
        assert torch.equal(buf["obs"][rows], obs)
        es, obs, rew, term, trunc, info = env.step(es, buf["act"][rows])
        assert torch.equal(buf["rew"][rows], rew.to(torch.float32))
        assert torch.equal(buf["next_obs"][rows], info["final_obs"])
        assert torch.equal(buf["done"][rows], term)
        assert bool(trunc.all()) == (k == 1)
    assert torch.equal(buf["next_obs"][:B], buf["obs"][B:2 * B])
    assert not torch.equal(buf["next_obs"][B:2 * B], buf["obs"][2 * B:3 * B])
    assert bool((buf["act"][:2 * B].abs() <= 1).all())
    norm = runs["meta1"]["norm"]
    torch.testing.assert_close(norm["mean"], buf["obs"][:3 * B].mean(0))
    assert float(norm["count"]) == pytest.approx(3 * B + 1e-4)


def test_resume_continues_the_step_count(runs):
    """The restored run resumes at env-batch step 3, past warm-up: both of
    its steps learn (utd updates each), its log lines and checkpoint names
    continue where an uninterrupted run's would."""
    lines = runs["lines2"]
    assert [ln["env_steps"] for ln in lines] == [4 * B, 5 * B]
    assert all("critic_loss" in ln for ln in lines)
    st2 = runs["st2"]
    assert st2.step == runs["meta1"]["step"] + 2 * 2
    assert st2.buffer.size == 5 * B and st2.batch_steps == 5
    assert runs["names2"] == [f"ckpt_{k * B}.pt" for k in range(1, 6)]


def test_restore_is_bit_equal(runs, model, tmp_path):
    st1 = runs["st1"]
    for a, b in zip(st1.actor.parameters(), runs["restored_params"]):
        assert torch.equal(a, b)
    tr = _trainer(model, 3 * B, tmp_path)
    path = tr.save(st1, tmp_path, 3 * B)
    st = tr.restore(path)
    for net in ("actor", "critic", "target_critic"):
        for a, b in zip(getattr(st1, net).state_dict().values(),
                        getattr(st, net).state_dict().values()):
            assert torch.equal(a, b)
    assert torch.equal(st.log_alpha, st1.log_alpha)
    for k in st1.buffer.FIELDS:
        assert torch.equal(getattr(st.buffer, k), getattr(st1.buffer, k))
    assert (st.buffer.ptr, st.buffer.size, st.step, st.batch_steps) == (
        st1.buffer.ptr, st1.buffer.size, st1.step, st1.batch_steps)
    assert torch.equal(st.generator.get_state(), st1.generator.get_state())
    assert Trainer.load_config(path) == SMALL


def test_evaluate(runs):
    """Without video_dir no frames; with it, env 0's (240, 320, 3) uint8
    top-camera frames after each step of its (LIMIT-step) first episode."""
    tr, st = runs["tr1"], runs["st1"]
    mean_ret, succ, frames = tr.evaluate(st)
    assert np.isfinite(mean_ret) and 0.0 <= succ <= 1.0 and frames == []
    tr.tcfg.video_dir = "videos"
    try:
        mean_ret2, _, frames = tr.evaluate(st)
    finally:
        tr.tcfg.video_dir = None
    assert mean_ret2 == mean_ret
    assert len(frames) == LIMIT
    for f in frames:
        assert f.shape == (240, 320, 3) and f.dtype == np.uint8
        assert len(np.unique(f.reshape(-1, 3), axis=0)) > 3


def test_cli_trains_on_the_cpu(capsys):
    st = train_sac.main(["--device", "cpu", "--task", TASK, "--num-envs", str(B),
                         "--total-steps", str(B), "--learning-starts", "0",
                         "--batch-size", "8", "--buffer-size", "64"])
    assert st.step == 1 and st.buffer.size == B
    st = train_sac.main(["--device", "cpu", "--task", TASK, "--num-envs", "2",
                         "--total-steps", "2", "--learning-starts", "0",
                         "--batch-size", "2", "--buffer-size", "8",
                         "--obs", "pixels_agent_pos", "--obs-height", "24",
                         "--obs-width", "32"])
    assert st.step == 1 and st.buffer.size == 2
    assert st.buffer.obs["pixels"].shape == (8, 24, 32, 3)
    assert st.buffer.obs["pixels"].dtype == torch.uint8
