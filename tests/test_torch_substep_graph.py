"""The substep CUDA graph of `forward.n_steps_batched`.

On the CPU (no card): CPU states take the eager loop; the graph path's
plumbing (static buffers, the running ncon, returned States that own
their memory, one graph per width) with `forward._capture` replaced by a
stand-in that runs the substep at each replay; the spans' marks during a
capture with no profiler; the counts a replay makes against an eager
substep's; the benchmark's reader of the counts; and that no stage of a
float32 substep builds a tensor from host data or waits for the device,
which a capture could not hold.

Tests marked `card` need a CUDA device and skip without one (decided
inside each test); on the card they hold the graph against the eager
substeps bit for bit (cube-to-bin with state and pixel observations, the
Cartesian EE env, the five-cube scene, the batched Panda) and check the
profiler's view of the replays:

    python -m pytest tests/test_torch_substep_graph.py -m card --noconftest -q -s
"""

import collections
import dataclasses
import traceback

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from gym_so100_tpu_torch import profiling
from gym_so100_tpu_torch.envs.ee_env import EE_XML, CartesianBatchedEnv
from gym_so100_tpu_torch.models.builder import PANDA_XML, build_model
from gym_so100_tpu_torch.models.scene import Data, State, static_tables
from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes, solver_lanes
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.parallel.batch import BatchedEnv

FIELDS = fwd._FIELDS


def _same(a, b):
    """Bit equality of two States (or tensors)."""
    if isinstance(a, torch.Tensor):
        bits = lambda t: t.contiguous().view(torch.uint8) if t.is_floating_point() else t
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))
    return all(_same(getattr(a, f), getattr(b, f)) for f in FIELDS)


def _cube_state(B=2, K=8, seed=0):
    """A cube-to-bin state on the CPU, float32, `B` envs moved off their
    reset by a few substeps with seeded controls."""
    env = BatchedEnv(task="so100_cube_to_bin", num_envs=B, device="cpu", max_contacts=K,
                     seed=seed)
    s = env.reset(seed=seed).physics
    g = torch.Generator().manual_seed(seed)
    ctrl = s.ctrl + 0.2 * torch.rand(s.ctrl.shape, generator=g) - 0.1
    return env.m, s.replace(ctrl=ctrl)


@pytest.fixture
def fake_capture(monkeypatch):
    """`forward._capture` on the CPU: nothing runs at capture, and each
    replay runs the captured function as if under capture (so it counts
    nothing, as a graph's replay runs no Python) and leaves its result in
    the buffer returned at capture.  Yields the number of captures so far
    (a list of one count)."""
    captures = [0]

    def capture(fn):
        captures[0] += 1
        out = torch.zeros(0, dtype=torch.int32)

        def replay():
            with monkeypatch.context() as mp:
                mp.setattr(profiling, "capturing", lambda: True)
                niter = fn()
            out.resize_(niter.shape).copy_(niter)

        return replay, out

    monkeypatch.setattr(fwd, "_capture", capture)
    yield captures


@pytest.fixture
def marks(monkeypatch):
    """The names of the marks launched, in order, in place of launches."""
    out = []
    monkeypatch.setattr(profiling, "_launch_mark", lambda i: out.append(profiling.SPANS[i]))
    profiling.reset_counters()
    yield out
    profiling.reset_counters()


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def test_cpu_states_take_the_eager_loop(monkeypatch):
    m, s = _cube_state()

    def no_capture(fn):
        raise AssertionError("a CPU state was captured")

    monkeypatch.setattr(fwd, "_capture", no_capture)
    out, ncon = fwd.n_steps_batched(m, s, 3)
    ref, ref_ncon = s, torch.zeros(2, dtype=torch.int32)
    for _ in range(3):
        ref, d = fwd.step_batched(m, ref)
        ref_ncon = torch.maximum(ref_ncon, d.contact.ncand)
    assert _same(out, ref) and _same(ncon, ref_ncon)


def test_graph_path_matches_the_eager_loop_and_owns_its_results(fake_capture):
    captures, graphed = fake_capture, fwd._graphed_steps
    m, s = _cube_state()
    eager = [fwd._eager_steps(m, s, 3)]
    eager.append(fwd._eager_steps(m, eager[-1][0], 3))
    eager.append(fwd._eager_steps(m, eager[-1][0], 3))
    first = graphed(m, s, 3)
    held = first[0]
    held_copy = {f: getattr(first[0], f).clone() for f in FIELDS}
    second = graphed(m, first[0], 3)
    third = graphed(m, second[0], 3)
    assert captures[0] == 1
    for got, ref in zip((first, second, third), eager):
        assert _same(got[0], ref[0]) and _same(got[1], ref[1])
    # the State returned first is untouched by the two calls after it, and
    # shares no memory with the graph's static buffers
    g = static_tables(m, f"substep_graph.2.{s.qpos.device}.{s.qpos.dtype}", None)
    for f in FIELDS:
        assert torch.equal(getattr(held, f), held_copy[f])
        assert getattr(held, f).numel() == 0 or (
            getattr(held, f).data_ptr() != getattr(g.state, f).data_ptr())
    assert third[1].data_ptr() != g.ncon.data_ptr()


def test_each_width_captures_its_own_graph(fake_capture):
    captures, graphed = fake_capture, fwd._graphed_steps
    m, s = _cube_state(B=3)
    graphed(m, s, 2)
    graphed(m, s, 2)
    assert captures[0] == 1
    narrow = State(**{f: getattr(s, f)[:1] for f in FIELDS})
    out, _ = graphed(m, narrow, 2)
    assert captures[0] == 2
    assert _same(out, fwd._eager_steps(m, narrow, 2)[0])


def test_a_replay_counts_what_an_eager_substep_counts(fake_capture, marks):
    graphed = fwd._graphed_steps
    m, s = _cube_state()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset_counters()
        fwd._eager_steps(m, s, 4)
        eager = profiling.counters()
        profiling.reset_counters()
        graphed(m, s, 4)                   # the warm-up substep, then 3 replays
        graphed(m, s, 4)                   # 4 replays
        got = profiling.counters()
    assert eager["substep.eager"] == 4 and "substep.graphed" not in eager
    assert got["substep.eager"] == 1 and got["substep.graphed"] == 7
    # the same substeps twice: twice the eager counts of each Newton counter
    for name in ("newton.solves", "newton.iterations", "newton.capped"):
        assert got[name] == 2 * eager[name]
    assert eager["newton.solves"] == 8 and eager["newton.iterations"] >= 8


def test_count_solves_counts_as_the_solver_does(marks):
    m, s = _cube_state()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset_counters()
        _, d = fwd.step_batched(m, s)
        solver = profiling.counters()
        profiling.reset_counters()
        solver_lanes.count_solves(m, d.solver_niter, s.qpos.dtype)
        assert profiling.counters() == solver


def test_annotate_marks_a_capture_with_no_profiler(marks, monkeypatch):
    def no_range(name):
        raise AssertionError(f"range {name!r} opened with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", no_range)
    monkeypatch.setattr(profiling, "capturing", lambda: True)
    with profiling.annotate("smooth"):
        with profiling.annotate("batched"):        # no mark of its own
            with profiling.annotate("collide"):
                pass
    assert marks == ["smooth", "collide", "smooth", "none"]
    assert profiling._open_spans() == []


def test_nothing_is_counted_during_a_capture(marks, monkeypatch):
    monkeypatch.setattr(profiling, "capturing", lambda: True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not profiling.recording()
        profiling.count("newton.solves", 3)
        profiling.count("newton.iterations", torch.ones(4, dtype=torch.int32))
        with profiling.annotate("efc"):
            pass
    assert profiling.counters() == {}
    assert marks == ["efc", "none"]
    assert "efc" in {e.name for e in prof.events()}


@pytest.mark.parametrize("counts,expected", [
    ({"substep.graphed": 10.0}, 100.0),
    ({"substep.graphed": 9.0, "substep.eager": 1.0}, 90.0),
    ({"substep.eager": 10.0, "newton.solves": 40960.0}, 0.0),
    ({"newton.solves": 40960.0}, None),      # a program without the counts
])
def test_graphed_substep_pct_reader(counts, expected, monkeypatch):
    from benchmark import harness

    class Run:
        trace = object()

    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    for name in ("graphed_substep_pct", "graphed_substep_pct.state"):
        assert harness.reader(name)(Run()) == expected
    Run.trace = None
    assert harness.reader("graphed_substep_pct")(Run()) is None


# what a capture cannot hold: host data copied to the device, a wait for
# the device, a tensor made on the host's default device
_SYNCS = {"_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique2",
          "repeat_interleave"}
_FACTORIES = {"arange", "tril_indices", "triu_indices", "zeros", "ones", "full", "empty",
              "eye", "linspace", "rand", "randn", "randint"}


def _port_line():
    port = [f for f in traceback.extract_stack() if "gym_so100_tpu_torch" in f.filename]
    return f"{port[-1].filename}:{port[-1].lineno}" if port else "?"


class _HostWork(TorchDispatchMode):
    """The ops of a CPU run that, on the card, would copy host data to the
    device (a Python scalar written into a tensor among them) or wait for
    the device; each with the port's line that issued it."""

    def __init__(self, found):
        super().__init__()
        self.found = found

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        out = func(*args, **kwargs)
        what = None
        if name in ("lift_fresh", "lift_fresh_copy"):
            what = "host data"
        elif name in _SYNCS:
            what = "sync"
        elif name in ("index", "index_put", "index_put_") and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in args[1]):
            what = "boolean mask"
        if what:
            self.found[(what, name, _port_line())] += 1
        return out


class _HostFactories(TorchFunctionMode):
    """Tensors made with no device named: on the host, whatever the
    state's device."""

    def __init__(self, found):
        super().__init__()
        self.found = found

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") in _FACTORIES and "device" not in kwargs:
            self.found[("made without a device", func.__name__, _port_line())] += 1
        return func(*args, **kwargs)


def _multicube(tmp_path, cubes):
    m, _ = build_model(chip_smoke.write_multicube_scene(str(tmp_path), cubes=cubes),
                       max_contacts=32, device="cpu", dtype=torch.float32)
    return m, chip_smoke._multicube_start(m, 2)


def _ee(tmp_path):
    env = CartesianBatchedEnv(build_model(EE_XML, max_contacts=16, device="cpu",
                                          dtype=torch.float32)[0], num_envs=2, device="cpu")
    return env.m, env.reset(seed=0).physics


def _panda(tmp_path):
    m, _ = build_model(PANDA_XML, max_contacts=24, device="cpu", dtype=torch.float32)
    s = fwd.make_state(m)
    return m, State(**{f: getattr(s, f).expand(2, *getattr(s, f).shape).clone()
                           for f in FIELDS})


@pytest.mark.parametrize("scene", ["cube_to_bin", "ee", "panda", "five_cube"])
def test_a_float32_substep_holds_nothing_a_capture_cannot(scene, tmp_path):
    m, s = {"cube_to_bin": lambda p: _cube_state(K=32),
            "ee": _ee,
            "panda": _panda,
            "five_cube": lambda p: _multicube(p, 4)}[scene](tmp_path)
    assert s.qpos.dtype == torch.float32
    fwd.step_batched(m, s)                 # the static tables, as the warm-up substep builds them
    found = collections.Counter()
    with _HostFactories(found), _HostWork(found):
        s2, d = fwd.step_batched(m, s)
        fwd._eager_steps(m, s2, 1)
        # the solver kernel's input packing, which only the card runs
        sl = smooth_lanes.forward_smooth_lanes(m, s)
        efc = constraint_lanes.make_efc_from_lanes(
            m, Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
                    site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"],
                    subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"]),
            s, d.contact)
        solver_lanes.pack_fused_inputs(m, sl["qM_lanes"], sl["qacc_smooth"], efc,
                                       s.qacc_warmstart)
    assert not found, "\n".join(f"{n} x {k}" for k, n in found.items())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _eager_env_steps(monkeypatch, run):
    """`run()` with `n_steps_batched` launching the substeps one by one."""
    with monkeypatch.context() as mp:
        mp.setattr(fwd, "n_steps_batched", fwd._eager_steps)
        return run()


def _bitwise(a, b, where):
    """Assert bit equality of two nests of tensors (dicts, tuples,
    dataclasses)."""
    if isinstance(a, torch.Tensor):
        assert _same(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _bitwise(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            _bitwise(x, y, f"{where}[{i}]")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _bitwise(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    else:
        assert a == b, where


def _cube_env_run(card, obs_mode, steps=3):
    """`steps` control steps of a fresh 4096-env cube-to-bin BatchedEnv
    (K = 32, hull contacts), 80 envs one step from their episode's end;
    returns every output of every step."""
    env = BatchedEnv(task="so100_cube_to_bin", num_envs=4096, device=card, max_contacts=32,
                     obs_mode=obs_mode, seed=7)
    es = env.reset(seed=7)
    es = es.replace(t=torch.where(torch.arange(4096, device=card) % 51 == 0, 699, 0).to(es.t))
    g = torch.Generator(device=card).manual_seed(11)
    outs = []
    for _ in range(steps):
        actions = 2 * torch.rand(4096, 6, device=card, generator=g) - 1
        out = env.step(es, actions)
        es = out[0]
        outs.append(out)
    torch.cuda.synchronize()
    return outs


@pytest.mark.card
@pytest.mark.parametrize("obs_mode", ["state", "pixels_agent_pos"])
def test_card_cube_to_bin_graph_is_bit_equal_to_eager(obs_mode, monkeypatch):
    card = _card()
    graphed = _cube_env_run(card, obs_mode)
    eager = _eager_env_steps(monkeypatch, lambda: _cube_env_run(card, obs_mode))
    assert int(graphed[0][3].sum() + graphed[0][4].sum()) > 0     # some envs reset
    _bitwise(graphed, eager, obs_mode)


def _ee_run(card, steps=3):
    env = CartesianBatchedEnv(num_envs=1024, device=card)
    es = env.reset(seed=3)
    g = torch.Generator(device=card).manual_seed(5)
    outs = []
    for _ in range(steps):
        out = env.step(es, 2 * torch.rand(1024, 4, device=card, generator=g) - 1)
        es = out[0]
        outs.append(out)
    torch.cuda.synchronize()
    return outs


@pytest.mark.card
def test_card_ee_env_graph_is_bit_equal_to_eager(monkeypatch):
    card = _card()
    graphed = _ee_run(card)
    _bitwise(graphed, _eager_env_steps(monkeypatch, lambda: _ee_run(card)), "ee")


@pytest.mark.card
@pytest.mark.parametrize("scene", ["five_cube", "panda"])
def test_card_scene_graph_is_bit_equal_to_eager(scene, tmp_path):
    """The five-cube scene (nv = 36, `newton_solve_wide`) at 4096 envs and
    the batched Panda (nv = 15, a weld and a joint coupling) at 1024."""
    card = _card()
    if scene == "five_cube":
        m, _ = build_model(chip_smoke.write_multicube_scene(str(tmp_path), cubes=4),
                           max_contacts=32, device=card, dtype=torch.float32)
        assert m.nv == 36
        start = chip_smoke._multicube_start(m, 4096)
    else:
        m, aux = build_model(PANDA_XML, max_contacts=24, device=card, dtype=torch.float32)
        assert m.nv == 15 and len(m.eq_jnt_q1) == 1
        start = chip_smoke._panda_batched_start(m, aux, 1024)
    a, b = start, start
    for step in range(3):
        a, nc_a = fwd.n_steps_batched(m, a, 10)
        b, nc_b = fwd._eager_steps(m, b, 10)
        _bitwise((a, nc_a), (b, nc_b), f"{scene} step {step}")


@pytest.mark.card
def test_card_held_state_and_a_second_width(monkeypatch):
    card = _card()
    captures = []
    real = fwd._capture
    monkeypatch.setattr(fwd, "_capture", lambda fn: (captures.append(1), real(fn))[1])
    env = BatchedEnv(task="so100_cube_to_bin", num_envs=4096, device=card, max_contacts=32)
    s = env.reset(seed=1).physics
    held, held_ncon = fwd.n_steps_batched(env.m, s, 10)
    copy = [getattr(held, f).clone() for f in FIELDS] + [held_ncon.clone()]
    s2 = fwd.n_steps_batched(env.m, held, 10)[0]
    fwd.n_steps_batched(env.m, s2, 10)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in
               zip([getattr(held, f) for f in FIELDS] + [held_ncon], copy))
    assert len(captures) == 1
    narrow = State(**{f: getattr(s, f)[:128].clone() for f in FIELDS})
    got = fwd.n_steps_batched(env.m, narrow, 10)
    got = fwd.n_steps_batched(env.m, got[0], 10)
    ref = fwd._eager_steps(env.m, fwd._eager_steps(env.m, narrow, 10)[0], 10)
    assert len(captures) == 2
    _bitwise(got, ref, "width 128")


def _kernel_names(prof):
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.card
def test_card_replayed_kernels_and_marks_show_in_the_trace(tmp_path):
    """A step whose graph was captured before the profiler started: each
    replay's kernels appear under their own names."""
    from gym_so100_tpu_torch.ops.collision import hull_lanes

    card = _card()
    env = BatchedEnv(task="so100_cube_to_bin", num_envs=4096, device=card, max_contacts=32)
    es = env.reset(seed=2)
    es = env.step(es, torch.zeros(4096, 6, device=card))[0]      # captures
    torch.cuda.synchronize()
    launches = (hull_lanes.sweep_h.launches, solver_lanes.solve_fused.launches)
    with profiling.trace(str(tmp_path / "after"), device=card) as prof:
        env.step(es, torch.zeros(4096, 6, device=card))
    names = _kernel_names(prof)
    counts = profiling.counters()
    print("replayed step:", len(names), "device ops;",
          sum("hull_sweep" in n for n in names), "hull_sweep,",
          sum("newton_solve" in n for n in names), "newton_solve,",
          sum("gst_span" in n for n in names), "marks; counters", counts)
    assert sum("hull_sweep" in n for n in names) == 10
    assert sum("newton_solve" in n for n in names) == 10
    assert sum("gst_span_smooth" in n for n in names) == 10
    assert counts["substep.graphed"] == 10 and "substep.eager" not in counts
    assert counts["newton.solves"] == 10 * 4096
    assert (hull_lanes.sweep_h.launches - launches[0],
            solver_lanes.solve_fused.launches - launches[1]) == (10, 10)


@pytest.mark.card
def test_card_a_capture_inside_a_trace(tmp_path):
    """A fresh env whose graph is captured inside `profiling.trace`: one
    eager substep, nine replays, both kernels in the trace, and the
    graph replays on after the trace."""
    card = _card()
    fresh = BatchedEnv(task="so100_cube_to_bin", num_envs=4096, device=card, max_contacts=32)
    es = fresh.reset(seed=3)
    with profiling.trace(str(tmp_path / "inside"), device=card) as prof:
        es = fresh.step(es, torch.zeros(4096, 6, device=card))[0]
    names = _kernel_names(prof)
    counts = profiling.counters()
    print("captured inside the trace:", len(names), "device ops;",
          sum("hull_sweep" in n for n in names), "hull_sweep,",
          sum("newton_solve" in n for n in names), "newton_solve; counters", counts)
    assert counts["substep.eager"] == 1 and counts["substep.graphed"] == 9
    assert sum("hull_sweep" in n for n in names) == 10
    out = fresh.step(es, torch.zeros(4096, 6, device=card))
    assert torch.isfinite(out[0].physics.qpos).all()
