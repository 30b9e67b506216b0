"""A configuration picks the program the harness drives; the check's
`envs_off_pct` holds one limit at any width; and every run of a
`batched_env` cell checks a step in which an env ends its episode."""

import json
import time

import pytest
import torch

from benchmark import check, harness, traffic

BENCH = harness.load_benchmark()
CELLS = sorted(w["name"] for w in BENCH["workloads"])
PROGRAMS = harness.ROOT / "benchmark" / "tests" / "programs"     # the tests' own programs


@pytest.mark.parametrize("fault,correct", [(None, True), ("unchanged", False)])
def test_a_configuration_names_the_program_that_runs_it(fault, correct, monkeypatch,
                                                        capsys, tmp_path):
    """`harness.main` runs a cell whose configuration names the program
    `stub` through `<programs directory>/stub.py`, to a result line, with
    the card's calls stubbed out on the CPU."""
    config = json.loads((PROGRAMS / "stub_config.json").read_text())
    if fault:
        config["fault"] = fault
    path = tmp_path / "stub.json"
    path.write_text(json.dumps(config))
    bench = dict(BENCH)
    bench["configs"] = [{"name": "stub", "source": "a test", "file": str(path),
                         "reduced": [], "why": "a test"}]
    bench["workloads"] = [{"name": "stub.b256", "config": "stub", "traffic": "closed_loop.b256",
                           "chips": 1, "why": "a test"}]
    bench["end_to_end"] = [{"name": n, "unit": u, "better": b, "bound": 0.25,
                            "source": "host_clock"}
                           for n, u, b in (("env_steps_per_s", "env-steps/s", "higher"),
                                           ("setup_s", "s", "lower"))]
    monkeypatch.setattr(harness, "load_benchmark", lambda: bench)
    monkeypatch.setattr(harness, "PROGRAMS", PROGRAMS)
    for name, fn in (("is_available", lambda: True), ("device_count", lambda: 1),
                     ("synchronize", lambda *a, **k: None),
                     ("max_memory_allocated", lambda *a, **k: 0),
                     ("get_device_name", lambda *a, **k: "no card"),
                     ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    argv = ["--workload", "stub.b256", "--seed", str(2 ** 31 + 11), "--seconds", "0.05",
            "--trace", "0"]
    assert harness.main(argv, time.perf_counter()) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is correct
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert result["attempted"] >= 2 * 256 and result["attempted"] % 256 == 0
    assert list(result)[-1] == "checks" and list(result["checks"]) == ["gap"]


@pytest.mark.parametrize("checked,off,correct", [
    (8192, 300, True), (8192, 301, False),     # the state and pixel cells at 4096 envs
    (1024, 37, True), (1024, 38, False),       # the four checked steps of 256 envs
    (256, 9, True), (256, 10, False),          # two checked steps of 128 envs
])
def test_envs_off_pct_holds_one_limit_at_any_width(checked, off, correct):
    limits = harness.find_cell(BENCH, "cube_to_bin.state.b4096")[1]["limits"]
    tally = check.Tally(False, 1e-3)
    gaps = torch.full((checked,), 1e-6)
    gaps[torch.randperm(checked, generator=torch.Generator().manual_seed(checked))[:off]] = 0.5
    tally.gaps = list(gaps.split(checked // 2))
    numbers = tally.numbers()
    assert numbers["envs_off_pct"] == pytest.approx(100 * off / checked)
    if checked == 8192:      # the count the check compared before it became a share
        assert numbers["envs_off_pct"] * 81.92 == pytest.approx(off)
    assert check.judge(numbers, limits, 2)[0] is correct


@pytest.mark.parametrize("cell", CELLS)
def test_every_run_checks_an_episode_end(cell):
    """The traffic's stratified ages end some episode (truncation at the
    episode limit) in a checked step on every seed; at 256 envs only the
    env aged 689 ends one in steps 8-11, at step 9, so all four are
    checked."""
    c, config = harness.find_cell(BENCH, cell)
    if config.get("program", "batched_env") != "batched_env":
        pytest.skip("not a batched_env cell")
    spec = traffic.load(c["traffic"])
    chk = spec["check"]
    assert 0 <= chk["first"] and chk["steps"] <= chk["last"] - chk["first"] + 1
    assert config["check"]["off_gap"] > 0
    for seed in (1, 2 ** 31 + 3, 2 ** 33 + 5):
        gen = traffic.Traffic(spec, seed, "cpu")
        _, ages = gen.initial()
        # an env of age a truncates in window step k, a + warm-up + k + 1 = the limit
        ends = config["episode_steps"] - 1 - int(spec["warmup_steps"]) - ages
        window = {int(k) for k in ends if chk["first"] <= k <= chk["last"]}
        assert window & set(gen.check_steps()), (seed, window)
        if spec["envs"] == 256:
            assert window == {9}
