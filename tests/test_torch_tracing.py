"""The port's tracing (`gym_so100_tpu_torch/profiling.py`) on the CPU: the
spans, their marks on the device stream and the counters.

No test here builds or loads the CUDA kernel library: a recorder stands
in for the mark launcher where the marks are checked, and the mark
kernels' source is compiled for the host through the shim of
`kernels_host.py`.
"""

import ctypes
import json
import re
import shutil

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gym_so100_tpu_torch import profiling
from gym_so100_tpu_torch.envs import constants as C
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.ops import solver_lanes
from gym_so100_tpu_torch.parallel.batch import BatchedEnv

MARK_SOURCE = profiling.__file__.replace("profiling.py", "csrc/span_mark.cu")


@pytest.fixture
def marks(monkeypatch):
    """The names of the marks launched, in order, in place of launches."""
    out = []
    monkeypatch.setattr(profiling, "_launch_mark", lambda i: out.append(profiling.SPANS[i]))
    profiling.reset_counters()
    yield out
    profiling.reset_counters()


def _small_env(**kw):
    return BatchedEnv(task="so100_cube_to_bin", num_envs=2, device="cpu", max_contacts=4,
                      hull_contacts=False, **kw)


def test_annotate_records_nothing_without_a_profiler(marks, monkeypatch):
    def no_range(name):
        raise AssertionError(f"range {name!r} opened with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", no_range)
    assert not profiling.recording()
    with profiling.annotate("collide"):
        with profiling.annotate("batched"):
            pass
    profiling.count("newton.solves", 3)
    profiling.count("newton.iterations", torch.ones(4, dtype=torch.int32))
    assert marks == [] and profiling.counters() == {}


def test_substep_without_a_profiler_marks_and_counts_nothing(marks):
    env = _small_env()
    fwd.step_batched(env.m, env.reset(seed=0).physics)
    assert marks == [] and profiling.counters() == {}


def test_nested_spans_mark_entry_and_restore_the_enclosing_span(marks):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("autoreset"):
            with profiling.annotate("render"):
                pass
            with profiling.annotate("batched"):          # no mark of its own
                with profiling.annotate("smooth"):
                    pass
            with pytest.raises(ValueError):
                with profiling.annotate("collide"):
                    raise ValueError("inside a span")
        with profiling.annotate("done_sync"):
            pass
    assert marks == ["autoreset", "render", "autoreset", "smooth", "autoreset",
                     "collide", "autoreset", "none", "done_sync", "none"]
    ranges = {e.name for e in prof.events()}
    assert {"autoreset", "render", "batched", "smooth", "collide", "done_sync"} <= ranges
    assert profiling._open_spans() == []


def test_span_table_matches_the_mark_kernels():
    src = open(MARK_SOURCE).read()
    table = [(int(i), n) for i, n in re.findall(r"X\((\d+), (\w+)\)", src)]
    assert table == list(enumerate(profiling.SPANS))
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)


def test_mark_kernels_build_and_check_their_index_on_the_host(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    import kernels_host

    lib = kernels_host._build(tmp_path, "span_mark", "float")
    lib.gst_span_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.gst_span_mark.restype = ctypes.c_int
    assert [lib.gst_span_mark(i, None) for i in range(len(profiling.SPANS))] \
        == [0] * len(profiling.SPANS)
    assert lib.gst_span_mark(len(profiling.SPANS), None) != 0
    assert lib.gst_span_mark(-1, None) != 0


def test_trace_writes_the_newton_counters(tmp_path, marks):
    env = _small_env()
    physics = env.reset(seed=0).physics
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        _, d = fwd.step_batched(env.m, physics)
    assert prof is not None
    got = json.loads((tmp_path / "counters.json").read_text())
    niter = d.solver_niter
    cap = solver_lanes.budgets(env.m, physics.qpos.dtype)[0]
    assert got == {"newton.solves": 2.0, "newton.iterations": float(niter.sum()),
                   "newton.capped": float((niter >= cap).sum())}
    assert got["newton.iterations"] >= 2
    assert marks[-1] == "none" and len(marks) == 2 * 5
    # a new trace starts its counters from zero
    with profiling.trace(str(tmp_path), device="cpu"):
        pass
    assert json.loads((tmp_path / "counters.json").read_text()) == {}


@pytest.mark.parametrize("obs_mode", ["state", "pixels_agent_pos"])
def test_step_trace_holds_the_sync_the_autoreset_and_the_renders(tmp_path, marks, obs_mode,
                                                                monkeypatch):
    """One control step with env 0 at the end of its episode: the step's
    host ranges and two marks for each range of a span in the table.  The
    step runs one substep, not ten, to keep the trace small (a profiled
    ten-substep step records a million host events)."""
    monkeypatch.setattr(C, "N_SUBSTEPS", 1)
    kw = dict(obs_mode=obs_mode, obs_height=12, obs_width=16) \
        if obs_mode != "state" else {}
    env = _small_env(**kw)
    es = env.reset(seed=0)
    es = es.replace(t=torch.tensor([env.max_episode_steps - 1, 0], dtype=es.t.dtype))
    with profiling.trace(str(tmp_path), device="cpu"):
        out = env.step(es, torch.zeros(2, 6))
    assert out[4].tolist() == [True, False]
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    spans = {n: [e for e in events if e["name"] == n] for n in profiling.SPANS}
    n = {k: len(v) for k, v in spans.items()}
    renders = 2 if obs_mode != "state" else 0
    assert n == {"none": 0, "smooth": 1, "collide": 1, "efc": 1, "solve": 1,
                 "integrate": 1, "render": renders, "autoreset": 1, "done_sync": 1}
    assert len(marks) == 2 * sum(n.values()) and marks[-1] == "none"
    if renders:
        # the second render, of the fresh episodes, lies inside the autoreset
        a = spans["autoreset"][0]
        inside = [r for r in spans["render"]
                  if r["ts"] >= a["ts"] and r["ts"] + r["dur"] <= a["ts"] + a["dur"]]
        assert len(inside) == 1
        i = marks.index("autoreset")
        assert marks[i:i + 3] == ["autoreset", "render", "autoreset"]
