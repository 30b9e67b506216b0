"""The reference agrees with the port's plain path (its CPU path) bit for
bit at a few envs, through two control steps with an autoreset, in both
observation modes."""

import pytest
import torch

from benchmark import harness, traffic
from benchmark.reference.batch import RefEnv
from benchmark.reference.models.builder import build_model

BENCH = harness.load_benchmark()
# one cell of each configuration: the run below sets its own width
CELLS = {c: harness.find_cell(BENCH, c)
         for c in {w["config"]: w["name"] for w in reversed(BENCH["workloads"])}.values()}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_equals_port_plain_path(cell):
    c, config = CELLS[cell]
    B = 3
    spec = dict(traffic.load(c["traffic"]), envs=B)
    gen = traffic.Traffic(spec, 2 ** 31 + 5, "cpu")
    prog = harness.program(config).build(config, spec, 0, "cpu")
    m, aux = build_model(str(harness.ROOT / config["scene_xml"]),
                         max_contacts=config["max_contacts"], device="cpu")
    ref = RefEnv(m, aux, config["task"], config["episode_steps"], obs_mode=config["obs_mode"],
                 obs_height=config["obs_height"], obs_width=config["obs_width"],
                 tris_per_mesh=config["tris_per_mesh"])
    poses, _ = gen.initial()
    t = torch.tensor([699, 3, 698], dtype=torch.int32)
    es = prog.reset(box_pose=poses).replace(t=t)
    er = ref.reset(poses).replace(t=t.clone())
    for _ in range(2):
        actions, spawn = gen.step_inputs()
        a = prog.step(es, actions, reset_box_pose=spawn)
        b = ref.step(er, actions, spawn)
        es, er = a[0], b[0]
        for f in ("qpos", "qvel", "ctrl", "qacc_warmstart"):
            assert torch.equal(getattr(es.physics, f), getattr(er.physics, f)), f
        assert torch.equal(es.t, er.t) and torch.equal(es.box_pose, er.box_pose)
        for x, y in zip(a[2:5], b[2:5]):
            assert torch.equal(x, y)
        for x, y in ((a[1], b[1]), (a[5]["final_obs"], b[5])):
            if isinstance(x, dict):
                assert torch.equal(x["pixels"], y["pixels"])
                assert torch.equal(x["agent_pos"], y["agent_pos"])
            else:
                assert torch.equal(x, y)
    assert int(es.t[0]) == 1 and int(es.t[2]) == 0      # both reset along the way
