"""The port's periphery: BC, the teleop input layer, the LeRobot interop,
the MJPEG server, the scripts and the profiler hooks.

The port's counterparts of tests/test_periphery.py's eight tests, on the
port's modules (`agents/bc.py`, `teleop/input.py`, `envs/constants.py`,
`interop/lerobot.py`, `render/mjpeg.py`, `scripts/`); the fake-`lerobot`
cases of tests/test_lerobot_interop.py on the port's interop (its fake
module tree under both namespace layouts; the rollout, slow as JAX's,
drives the port's registered env on the CPU); and `profiling.trace` writing a CPU trace that
holds the physics stages' annotations.

Held to the JAX package on the same inputs, bit for bit: the four unit
conversions of `envs/constants.py` (numpy and torch inputs, float32 and
float64, in and out of range), `GamepadControllerHID._decode` on every
layout and `KeyboardController` on the same reports and keys, and the
frames that `demos_to_lerobot_dataset` writes under the fake `lerobot`.
"""

import importlib
import json
import pickle
import sys

import numpy as np
import pytest
import torch
from gym_so100_tpu.envs import constants as jax_constants
from gym_so100_tpu.interop import lerobot as jax_lerobot
from gym_so100_tpu.teleop import input as jax_input
from test_lerobot_interop import (  # noqa: F401 (fixture)
    FakeLeRobotDataset,
    RecordingPolicy,
    fake_lerobot,
)

# the scripts that run the port's envs or engine, then the host-only ones
DEVICE_SCRIPTS = ("example", "evaluate_policy", "record_teleop", "train_bc", "teleop",
                  "teleop_ee", "teleop_ee_pandas", "viewer", "evaluate_lerobot_policy",
                  "train_sac", "train_sac_her")
SCRIPTS = DEVICE_SCRIPTS + ("upload_lerobot_demos", "merge_demonstrations", "hull_ab")


def test_bc_fits_linear_policy(tmp_path):
    from gym_so100_tpu_torch.agents.bc import load_demo_transitions, train_bc
    from gym_so100_tpu_torch.agents.sac import det_action

    rng = np.random.RandomState(0)
    W = rng.randn(6, 15).astype(np.float32) * 0.1
    episodes = []
    for _ in range(3):
        obs = rng.randn(40, 15).astype(np.float32)
        acts = np.tanh(obs @ W.T).astype(np.float32)
        episodes.append(dict(observations=list(obs), actions=list(acts),
                             rewards=[0.0] * 40, infos=[{}] * 40))
    path = tmp_path / "demos.pkl"
    with open(path, "wb") as f:
        pickle.dump(episodes, f)

    o, a = load_demo_transitions([str(path)])
    assert o.shape == (120, 15) and a.shape == (120, 6)
    lines = []
    actor = train_bc(o, a, epochs=30, batch_size=32, progress=lines.append, device="cpu")
    assert lines[-1]["bc_loss"] < lines[0]["bc_loss"]
    with torch.no_grad():
        pred = det_action(actor, torch.from_numpy(o[:10])).numpy()
    assert np.abs(pred - a[:10]).mean() < 0.2


def test_input_controller_contract():
    from gym_so100_tpu_torch.teleop.input import InputController, KeyboardController

    c = InputController()
    assert c.gripper_command() == "no-op"
    c.open_gripper_command = True
    assert c.gripper_command() == "open"
    assert not c.should_save()
    c.episode_end_status = "success"
    assert c.should_save()
    assert {j for j, _ in KeyboardController.KEYMAP.values()} == set(range(6))


def test_gamepad_decode_logitech_layout():
    """Synthetic HID reports through the Logitech RumblePad 2 layout: dpad
    nibble, stick axes with deadzone, trigger bitfield, face-button tags."""
    from gym_so100_tpu_torch.teleop.input import LAYOUTS, GamepadControllerHID

    c = GamepadControllerHID(x_step_size=1.0, y_step_size=1.0, z_step_size=1.0)
    c.layout = LAYOUTS["Logitech"]
    idle = [0, 15, 128, 128, 128, 128, 0, 0, 0]
    c._decode(idle)
    assert c.direction is None and c.get_deltas() == (0.0, 0.0, 0.0)
    assert c.gripper_command() == "no-op"
    assert not c.intervention_flag and c.episode_end_status is None
    c._decode([0, 0, 128, 0, 128, 128, 0x02, 0, 0])
    assert c.direction == "up" and c.intervention_flag
    assert c.get_deltas() == (1.0, 0.0, 0.0)
    for bits, want in ((0x08, "open"), (0x04, "close"), (0x0C, "no-op")):
        c._decode([0, 15, 128, 128, 128, 128, bits, 0, 0])
        assert c.gripper_command() == want
    for bit, want in ((7, "success"), (5, "failure"), (4, "rerecord_episode")):
        c._decode([0, 15, 128, 128, 128, 128, 0, 0, 1 << bit])
        assert c.episode_end_status == want
    c._decode(idle)
    assert c.episode_end_status is None
    c._decode([0, 15, 128, 133, 128, 128, 0, 0, 0])
    assert c.get_deltas() == (0.0, 0.0, 0.0)
    for lay in LAYOUTS.values():
        assert len(lay.axes) == 4 and lay.min_len >= max(lay.axes) + 1


def test_lerobot_unit_conversions_roundtrip():
    from gym_so100_tpu_torch.envs import constants as C

    q = np.array([0.5, -1.0, 1.5, 0.3, -2.0, 0.8])
    lr = C.normalize_gym_so100_to_lerobot(q)
    assert lr.shape == (6,)
    back = C.unnormalize_so100(C.normalize_lerobot_to_gym_so100(lr))
    np.testing.assert_allclose(back, q, atol=1e-5)
    # the torch path gives the numpy path's values
    t = C.unnormalize_so100(C.normalize_lerobot_to_gym_so100(
        C.normalize_gym_so100_to_lerobot(torch.from_numpy(q))))
    np.testing.assert_array_equal(t.numpy(), back)


# each conversion with inputs that span its domain and run past both ends
CONVERSIONS = {
    "unnormalize_so100": (-1.5, 1.5),
    "normalize_so100": (-4.0, 4.0),
    "normalize_gym_so100_to_lerobot": (-4.0, 4.0),
    "normalize_lerobot_to_gym_so100": (-150.0, 150.0),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(CONVERSIONS))
def test_unit_conversion_bit_equal_to_jax(name, dtype):
    """The port's conversion on numpy and on torch inputs gives JAX's bits,
    for a batch and for one action."""
    from gym_so100_tpu_torch.envs import constants as C

    lo, hi = CONVERSIONS[name]
    x = np.random.RandomState(11).uniform(lo, hi, (64, 6)).astype(dtype)
    x[0], x[1] = lo, hi
    for arr in (x, x[5]):
        want = np.asarray(getattr(jax_constants, name)(arr))
        assert want.dtype == dtype
        got_np = getattr(C, name)(arr)
        got_t = getattr(C, name)(torch.from_numpy(arr))
        assert got_np.dtype == dtype and got_t.numpy().dtype == dtype
        np.testing.assert_array_equal(got_np, want)
        np.testing.assert_array_equal(got_t.numpy(), want)


def _controller_state(c):
    """A controller's decoded state: its public attributes but the device
    handle and layout, and what its accessors return."""
    state = {k: v for k, v in vars(c).items()
             if not k.startswith("_") and k not in ("device", "layout")}
    state.update(deltas=c.get_deltas(), gripper=c.gripper_command(),
                 save=c.should_save(), quit=c.should_quit())
    return state


@pytest.mark.parametrize("layout", sorted(jax_input.LAYOUTS))
def test_gamepad_decode_matches_jax(layout):
    """Both decoders on the same reports: random bytes at every length from
    empty to past the layout's longest field, and the idle, dpad, trigger
    and face-button reports of the Logitech test; equal state after each."""
    from gym_so100_tpu_torch.teleop import input as port_input

    assert sorted(port_input.LAYOUTS) == sorted(jax_input.LAYOUTS)
    cs = []
    for mod in (jax_input, port_input):
        c = mod.GamepadControllerHID(x_step_size=0.5, y_step_size=1.0, z_step_size=2.0)
        c.layout = mod.LAYOUTS[layout]
        cs.append(c)
    rng = np.random.RandomState(3)
    reports = [list(rng.randint(0, 256, n)) for n in range(16) for _ in range(8)]
    reports += [[0, 15, 128, 128, 128, 128, 0, 0, 0], [0, 0, 128, 0, 128, 128, 0x02, 0, 0],
                [0, 15, 128, 133, 128, 128, 0, 0, 0]]
    reports += [[0, 15, 128, 128, 128, 128, bits, 0, 0] for bits in (0x08, 0x04, 0x0C)]
    reports += [[0, 15, 128, 128, 128, 128, 0, 0, 1 << bit] for bit in range(8)]
    assert _controller_state(cs[0]) == _controller_state(cs[1])
    for rep in reports:
        for c in cs:
            c._decode([int(b) for b in rep])
        assert _controller_state(cs[0]) == _controller_state(cs[1]), rep


def test_keyboard_controller_matches_jax(monkeypatch):
    """Both keyboard controllers on the same injected keys (the keymap,
    the episode tags, unknown keys, then quit), one update per chunk:
    equal joint deltas, tags and running flag after each."""
    import os

    from gym_so100_tpu_torch.teleop import input as port_input

    assert port_input.KeyboardController.KEYMAP == jax_input.KeyboardController.KEYMAP
    rfd, wfd = os.pipe()
    monkeypatch.setattr(sys, "stdin", os.fdopen(rfd, "r"))
    cs = [mod.KeyboardController(step=0.03) for mod in (jax_input, port_input)]
    keys = list(port_input.KeyboardController.KEYMAP) + list("123?xq ")
    rng = np.random.RandomState(5)
    chunks = [[keys[i] for i in rng.randint(0, len(keys) - 1, rng.randint(0, 6))]
              for _ in range(40)] + [["a", "a", "z", "h"], ["2"], ["3"], ["q"]]
    for chunk in chunks:
        for c in cs:
            for k in chunk:
                c.inject(k)
            c.update()
        assert _controller_state(cs[0]) == _controller_state(cs[1]), chunk
    assert not cs[1].running
    os.close(wfd)


def test_lerobot_interop_gated():
    from gym_so100_tpu_torch.interop import lerobot as lri

    assert "observation.images.top" in lri.FEATURES
    with pytest.raises(RuntimeError, match="lerobot"):
        lri.load_pretrained_policy("act", "nonexistent")


def test_scripts_importable():
    for name in SCRIPTS:
        mod = importlib.import_module(f"gym_so100_tpu_torch.scripts.{name}")
        assert callable(mod.main), name


def test_scripts_default_to_the_gpu():
    """Every script that runs the port takes --device, default cuda."""
    import argparse

    for name in DEVICE_SCRIPTS:
        mod = importlib.import_module(f"gym_so100_tpu_torch.scripts.{name}")
        seen = {}

        def parse(self, args=None, namespace=None, _seen=seen):
            _seen.update({a.dest: a.default for a in self._actions})
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = parse
        try:
            with pytest.raises(SystemExit):
                mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        assert seen.get("device") == "cuda", name


def test_mjpeg_server_stream_and_keys():
    import http.client

    from gym_so100_tpu_torch.render.mjpeg import MjpegServer

    keys = []
    srv = MjpegServer(port=0, fps=30.0, title="t", help_text="h",
                      key_handler=keys.append).start()
    try:
        frame = np.zeros((8, 8, 3), np.uint8)
        frame[:, :, 0] = 255
        srv.publish(frame)
        conn = http.client.HTTPConnection("localhost", srv.port, timeout=5)
        conn.request("GET", "/")
        r = conn.getresponse()
        assert r.status == 200 and b"t" in r.read()
        conn2 = http.client.HTTPConnection("localhost", srv.port, timeout=5)
        conn2.request("GET", "/stream")
        r2 = conn2.getresponse()
        assert r2.status == 200
        assert "multipart/x-mixed-replace" in r2.getheader("Content-Type")
        chunk = r2.read(400)
        assert b"--frame" in chunk and b"image/jpeg" in chunk and b"\xff\xd8" in chunk
        conn2.close()
        conn3 = http.client.HTTPConnection("localhost", srv.port, timeout=5)
        conn3.request("POST", "/key", body=json.dumps({"key": "a"}))
        assert conn3.getresponse().status == 204
        assert keys == ["a"]
    finally:
        srv.stop()


def test_keyboard_inject_drives_recorder_loop(monkeypatch):
    import os

    from gym_so100_tpu_torch.teleop.input import KeyboardController

    rfd, wfd = os.pipe()
    monkeypatch.setattr(sys, "stdin", os.fdopen(rfd, "r"))
    ctl = KeyboardController()
    for k in "aaz":
        ctl.inject(k)
    ctl.update()
    assert abs(ctl.joint_deltas[0] - ctl.step) < 1e-9
    ctl.update()
    assert ctl.joint_deltas[0] == 0.0
    ctl.inject("1")
    ctl.update()
    assert ctl.episode_end_status == "success"
    ctl.inject("q")
    ctl.update()
    assert not ctl.running
    os.close(wfd)


# -- the LeRobot interop under the fake module tree ---------------------------


def test_demos_to_lerobot_dataset(fake_lerobot, tmp_path):
    from gym_so100_tpu_torch.envs import constants as C
    from gym_so100_tpu_torch.interop.lerobot import demos_to_lerobot_dataset

    rng = np.random.RandomState(0)
    H, W = 4, 5

    def episode(T, last_reward):
        rews = np.full(T, 1.0, np.float32)
        rews[-1] = last_reward
        return {"observations": [{"agent_pos": rng.uniform(-1, 1, 6).astype(np.float32),
                                  "pixels": rng.randint(0, 255, (H, W, 3), np.uint8)}
                                 for _ in range(T)],
                "actions": rng.uniform(-1, 1, (T, 6)).astype(np.float32),
                "rewards": rews, "infos": [{} for _ in range(T)]}

    demo = [episode(3, 4.0), episode(2, 1.0)]
    path = tmp_path / "demo.pkl"
    with open(path, "wb") as f:
        pickle.dump(demo, f)
    ds = demos_to_lerobot_dataset([str(path)], "user/test", fps=50, push=True)
    assert ds is FakeLeRobotDataset.created and ds.pushed
    assert ds.episode_lengths == [3, 2] and len(ds.frames) == 5
    assert ds.image_writer.waits == 2 and ds.buffer_clears == 2
    frame0, task0 = ds.frames[0]
    assert task0 == "Put the red cube into the bin"
    np.testing.assert_allclose(
        frame0["observation.state"],
        C.normalize_gym_so100_to_lerobot(demo[0]["observations"][0]["agent_pos"]), rtol=1e-6)
    np.testing.assert_allclose(
        frame0["action"],
        C.normalize_gym_so100_to_lerobot(C.unnormalize_so100(demo[0]["actions"][0])),
        rtol=1e-6)
    assert frame0["observation.images.top"].shape == (3, H, W)
    np.testing.assert_array_equal(frame0["observation.images.top"][0],
                                  demo[0]["observations"][0]["pixels"][..., 0])
    assert ds.frames[2][0]["next.success"][0] and not ds.frames[4][0]["next.success"][0]


def test_demos_to_lerobot_dataset_matches_jax(fake_lerobot, tmp_path):
    """JAX's and the port's export of the same demo pickle (dict obs with
    pixels, and flat obs) under the fake `lerobot`: the same frames, bit
    for bit, with the same tasks, episode lengths, features and calls."""
    from gym_so100_tpu_torch.interop.lerobot import FEATURES, demos_to_lerobot_dataset

    assert FEATURES == jax_lerobot.FEATURES
    rng = np.random.RandomState(1)

    def episode(T, dict_obs):
        rews = rng.choice([0.0, 1.0, 4.0], T).astype(np.float32)
        if dict_obs:
            obs = [{"agent_pos": rng.uniform(-4, 4, 6).astype(np.float32),
                    "pixels": rng.randint(0, 255, (4, 5, 3), np.uint8)} for _ in range(T)]
        else:
            obs = list(rng.uniform(-4, 4, (T, 15)))
        return {"observations": obs, "actions": rng.uniform(-1.5, 1.5, (T, 6)),
                "rewards": rews, "infos": [{} for _ in range(T)]}

    paths = []
    for i, demo in enumerate(([episode(4, True), episode(3, True)], [episode(5, False)])):
        paths.append(str(tmp_path / f"demo{i}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(demo, f)
    out = []
    for export in (jax_lerobot.demos_to_lerobot_dataset, demos_to_lerobot_dataset):
        ds = export(paths, "user/test", fps=30, push=True, task_text="t")
        assert ds is FakeLeRobotDataset.created
        out.append(ds)
    want, got = out
    assert len(got.frames) == len(want.frames) == 12
    for (fg, tg), (fw, tw) in zip(got.frames, want.frames):
        assert tg == tw == "t" and fg.keys() == fw.keys()
        for k in fw:
            assert np.asarray(fg[k]).dtype == np.asarray(fw[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(fg[k]), np.asarray(fw[k]), err_msg=k)
    for attr in ("repo_id", "fps", "features", "use_videos", "episode_lengths", "pushed",
                 "buffer_clears"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.image_writer.waits == want.image_writer.waits


@pytest.mark.slow
def test_rollout_policy(fake_lerobot):
    """rollout_policy on the port's registered env (float32 state obs, the
    CPU): the batch dict, the unit round trip, episode ends.  Slow, as
    JAX's is: 8 control steps take ~10 s here."""
    from gym_so100_tpu_torch.envs import constants as C
    from gym_so100_tpu_torch.envs.registration import make
    from gym_so100_tpu_torch.interop.lerobot import rollout_policy

    env = make("gym_so100_tpu/SO100TouchCube-v0", obs_type="so100_state",
               max_episode_steps=3, device="cpu")
    policy = RecordingPolicy(np.zeros(6, np.float32))
    out = rollout_policy(policy, env, episodes=2, lerobot_units=True)
    assert len(out["returns"]) == 2 and len(out["successes"]) == 2
    assert len(policy.batches) == 6
    b0 = policy.batches[0]
    assert set(b0) == {"observation.state"} and tuple(b0["observation.state"].shape) == (1, 6)
    obs0, _ = env.reset(seed=0)
    np.testing.assert_allclose(np.asarray(b0["observation.state"][0]),
                               C.normalize_gym_so100_to_lerobot(obs0[-6:]),
                               rtol=1e-5, atol=1e-5)


# -- profiling -----------------------------------------------------------------


def test_trace_writes_a_cpu_trace_with_the_stages(tmp_path):
    """One batched substep and one single-env substep under `trace`: the
    trace file opens as JSON and holds each stage's range."""
    from gym_so100_tpu_torch.envs.gym_env import SO100Env
    from gym_so100_tpu_torch.ops import forward as fwd
    from gym_so100_tpu_torch.parallel.batch import BatchedEnv
    from gym_so100_tpu_torch.profiling import annotate, trace

    env = BatchedEnv(task="so100_touch_cube", num_envs=2, device="cpu", max_contacts=4)
    es = env.reset(seed=0)
    single = SO100Env(task="so100_touch_cube", obs_type="so100_state", device="cpu")
    single.reset(seed=0)
    with trace(str(tmp_path), device="cpu") as prof:
        with annotate("batched"):
            fwd.step_batched(env.m, es.physics)
        with annotate("single"):
            fwd.step(single._m, single._es.physics)
    assert prof is not None
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    stages = {"smooth", "collide", "efc", "solve", "integrate"}
    assert stages | {"batched", "single"} <= names, stages - names
    counts = {s: sum(e.get("name") == s for e in events) for s in stages}
    assert all(n == 2 for n in counts.values()), counts
