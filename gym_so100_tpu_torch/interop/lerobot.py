"""LeRobot dataset/policy interop.

The port of `gym_so100_tpu/interop/lerobot.py`: demo pickles -> a
LeRobotDataset with the same feature schema, and pretrained LeRobot
policies rolled out in the port's envs (`envs/registration.make`), with
the gym <-> LeRobot unit conversions of `envs/constants.py`.  The
`lerobot` package is optional: it is imported only inside the functions,
and every entry point raises a RuntimeError naming it when it is missing.

API version: the flattened namespaces of lerobot >= 0.2
(`lerobot.datasets.lerobot_dataset`, `lerobot.policies.<kind>.modeling_<kind>`)
are imported first, the legacy `lerobot.common.` prefix second.  The
surface used:
  * LeRobotDataset.create(repo_id=, fps=, features=, use_videos=)
  * dataset.add_frame(frame_dict, task=str)
  * dataset.image_writer.wait_until_done()            (when present)
  * dataset.save_episode()
  * dataset.clear_episode_buffer()                    (when present)
  * dataset.push_to_hub()
  * <Policy>.from_pretrained(path), .select_action(batch)
"""

from __future__ import annotations

import numpy as np

from ..envs import constants as C

FEATURES = {
    "observation.images.top": {"dtype": "video", "shape": (3, 480, 640),
                               "names": ["channel", "height", "width"]},
    "observation.state": {"dtype": "float32", "shape": (6,), "names": None},
    "action": {"dtype": "float32", "shape": (6,), "names": None},
    "next.reward": {"dtype": "float32", "shape": (1,), "names": None},
    "next.success": {"dtype": "bool", "shape": (1,), "names": None},
    "seed": {"dtype": "int64", "shape": (1,), "names": None},
}


def _require_lerobot():
    try:
        import lerobot  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "LeRobot interop needs the 'lerobot' package (pip install lerobot)"
        ) from e


def demos_to_lerobot_dataset(demo_paths, repo_id, fps=50, push=False,
                             task_text="Put the red cube into the bin"):
    """Convert demo pickles (a list of episode dicts with "observations",
    "actions", "rewards") to a LeRobotDataset; returns the dataset."""
    _require_lerobot()
    import pickle

    try:
        # lerobot >= 0.2 flattened layout
        from lerobot.datasets.lerobot_dataset import LeRobotDataset
    except ImportError:
        from lerobot.common.datasets.lerobot_dataset import LeRobotDataset

    ds = LeRobotDataset.create(
        repo_id=repo_id, fps=fps, features=FEATURES, use_videos=True
    )
    for path in demo_paths:
        with open(path, "rb") as f:
            episodes = pickle.load(f)
        for ep_i, ep in enumerate(episodes):
            acts = np.asarray(ep["actions"], np.float32)
            rews = np.asarray(ep["rewards"], np.float32)
            for t in range(len(acts)):
                obs = ep["observations"][t]
                state = obs["agent_pos"] if isinstance(obs, dict) else obs[-6:]
                frame = {
                    "observation.state": np.asarray(
                        C.normalize_gym_so100_to_lerobot(state), np.float32
                    ),
                    "action": np.asarray(
                        C.normalize_gym_so100_to_lerobot(
                            C.unnormalize_so100(acts[t])
                        ),
                        np.float32,
                    ),
                    "next.reward": np.asarray([rews[t]], np.float32),
                    "next.success": np.asarray([rews[t] >= 4.0]),
                    "seed": np.asarray([ep_i], np.int64),
                }
                if isinstance(obs, dict) and "pixels" in obs:
                    frame["observation.images.top"] = np.transpose(
                        obs["pixels"], (2, 0, 1)
                    )
                ds.add_frame(frame, task=task_text)
            # drain the async image writer, save, then clear the episode
            # buffer on lerobot versions that still have it (newer
            # save_episode clears)
            writer = getattr(ds, "image_writer", None)
            if writer is not None and hasattr(writer, "wait_until_done"):
                writer.wait_until_done()
            ds.save_episode()
            if hasattr(ds, "clear_episode_buffer"):
                ds.clear_episode_buffer()
    if push:
        ds.push_to_hub()
    return ds


POLICY_CLASSES = {
    # flattened lerobot >= 0.2 paths
    "act": "lerobot.policies.act.modeling_act.ACTPolicy",
    "diffusion": "lerobot.policies.diffusion.modeling_diffusion.DiffusionPolicy",
    "pi0fast": "lerobot.policies.pi0fast.modeling_pi0fast.PI0FASTPolicy",
    "smolvla": "lerobot.policies.smolvla.modeling_smolvla.SmolVLAPolicy",
}


def load_pretrained_policy(kind, path_or_repo):
    _require_lerobot()
    import importlib

    module, cls = POLICY_CLASSES[kind].rsplit(".", 1)
    try:
        policy_cls = getattr(importlib.import_module(module), cls)
    except ImportError:
        # legacy pre-0.2 layout
        legacy = module.replace("lerobot.", "lerobot.common.", 1)
        policy_cls = getattr(importlib.import_module(legacy), cls)
    return policy_cls.from_pretrained(path_or_repo)


def rollout_policy(policy, env, episodes=1, lerobot_units=True, task_text=None,
                   video_path=None):
    """Roll a LeRobot policy in a Gymnasium-API env of the port for
    `episodes` episodes (seeds 0, 1, ...); returns {"returns", "successes"}.
    With `lerobot_units` the state goes to the policy, and its action comes
    back, in LeRobot units.  Env 0's rendered frames go to `video_path`
    (needs imageio)."""
    _require_lerobot()
    import torch

    frames, returns, successes = [], [], []
    for ep in range(episodes):
        obs, info = env.reset(seed=ep)
        total = 0.0
        done = False
        while not done:
            state = obs["agent_pos"] if isinstance(obs, dict) else obs[-6:]
            if lerobot_units:
                state = np.asarray(C.normalize_gym_so100_to_lerobot(state))
            batch = {
                "observation.state": torch.as_tensor(state, dtype=torch.float32)[None],
            }
            if isinstance(obs, dict) and "pixels" in obs:
                img = torch.as_tensor(obs["pixels"]).permute(2, 0, 1)[None] / 255.0
                batch["observation.images.top"] = img.float()
            if task_text is not None:
                batch["task"] = [task_text]
            with torch.no_grad():
                action = policy.select_action(batch)[0].cpu().numpy()
            if lerobot_units:
                action = np.asarray(C.normalize_lerobot_to_gym_so100(action))
            obs, reward, term, trunc, info = env.step(np.asarray(action, np.float32))
            total += float(reward)
            done = term or trunc
            if video_path and ep == 0:
                frames.append(np.asarray(env.render()))
        returns.append(total)
        successes.append(bool(info.get("is_success", False)))
    if video_path and frames:
        import imageio

        imageio.mimsave(video_path, np.stack(frames), fps=50)
    return {"returns": returns, "successes": successes}
