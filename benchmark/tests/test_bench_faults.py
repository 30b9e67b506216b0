"""The harness's check, driven as a run drives it (set-up, warm-up,
window, reference) but on the CPU at a few envs, passes the program as it
is and fails it with the timed path broken underneath by each fault of
the cell's program (`batched_env`: `benchmark/faults.py`) that the cell
can have, planted before the program's first step.  The same on the card,
at 256 envs, is marked `card`."""

import pytest
import torch

from benchmark import harness, traffic

BENCH = harness.load_benchmark()
# one cell of each configuration: the runs below set their own width and steps
CELLS = sorted({w["config"]: w["name"] for w in reversed(BENCH["workloads"])}.values())
PIXELS = {c for c in CELLS if harness.find_cell(BENCH, c)[1]["obs_mode"] != "state"}
NAMES = ["answer", "control", "half", "stale_frame", "terminal", "unchanged"]  # hull: below


def drive_cell(cell, fault, device, envs, steps=2):
    """(correct, numbers, run) of a run whose checked steps are its last
    two of `steps`; half of the envs end their episode in the first."""
    c, config = harness.find_cell(BENCH, cell)
    prog = harness.program(config)
    spec = dict(traffic.load(c["traffic"]), envs=envs,
                check={"steps": 2, "first": steps - 2, "last": steps - 1})
    gen = prog.traffic(spec, 2 ** 31 + 77, device)
    first = gen.initial

    def initial():
        poses, ages = first()
        ages[::2] = 700 - steps
        return poses, ages
    gen.initial = initial
    env = prog.build(config, spec, 0, device)
    if fault is not None:
        env = prog.faults(config, device)[fault](env)
    run = harness.Run(c, config, spec)
    sync = (lambda: torch.cuda.synchronize()) if torch.device(device).type == "cuda" \
        else (lambda: None)
    prog.drive(run, env, gen, device, seconds=0, sync=sync)
    correct, rows, ref, _ = prog.verify(run, config, device)
    return correct, dict((n, v) for n, v, _ in rows), run, ref


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_passes(cell):
    correct, numbers, run, _ = drive_cell(cell, None, "cpu", 4)
    assert correct, numbers
    assert sum(int((r.out.terminated | r.out.truncated).sum()) for r in run.records) > 0


@pytest.mark.parametrize("fault", NAMES)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_fails(cell, fault):
    if fault == "stale_frame" and cell not in PIXELS:
        pytest.skip("a state observation has no frame")
    # an episode that ends a step or two after its reset ends where it began
    steps = 12 if fault in ("terminal", "stale_frame") else 2
    correct, numbers, _, _ = drive_cell(cell, fault, "cpu", 4, steps=steps)
    assert not correct, numbers


def test_hull_fault_fails():
    """Hull contacts start some steps after a reset: the checked steps
    are the 11th and 12th, where the sound run has some."""
    cell = "cube_to_bin.state.b4096"
    correct, numbers, run, ref = drive_cell(cell, None, "cpu", 64, steps=12)
    assert correct, numbers
    assert ref.hull_envs(run.records[-1].before) > 0
    correct, numbers, _, _ = drive_cell(cell, "hull", "cpu", 64, steps=12)
    assert not correct, numbers
    assert numbers["envs_off_pct"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_sound_passes_and_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert drive_cell(cell, None, "cuda", 256)[0]
    assert not drive_cell(cell, "control", "cuda", 256)[0]


def test_traced_step_comes_after_the_window(monkeypatch):
    """A traced run's profiled control step runs once the window has
    closed and is the next one in which an episode ends (here the second
    after the window): the window keeps its steps and its checked records,
    the trace holds one step's ten substeps of physics ranges, and the
    traced step reset the env whose episode ended."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cell = CELLS[0]
    c, config = harness.find_cell(BENCH, cell)
    prog = harness.program(config)
    spec = dict(traffic.load(c["traffic"]), envs=4, check={"steps": 2, "first": 0, "last": 1})
    gen = prog.traffic(spec, 2 ** 31 + 5, "cpu")
    first = gen.initial

    def initial():
        poses, ages = first()
        ages[:] = 0
        ages[1] = 700 - 1 - 4      # ends in the second step after the two of the window
        return poses, ages
    gen.initial = initial
    env = prog.build(config, spec, 0, "cpu")
    run = harness.Run(c, config, spec)
    es = prog.drive(run, env, gen, "cpu", seconds=0, trace=True, sync=lambda: None)
    assert run.steps == 2 and len(run.step_s) == 2 and len(run.records) == 2
    assert run.trace is not None
    for name in ("smooth", "collide", "efc", "solve", "integrate"):
        assert len(run.trace.host_ranges(name)) == 10
    assert es.t.tolist() == [5, 0, 5, 5]
    assert prog.verify(run, config, "cpu")[0]

