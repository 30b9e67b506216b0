"""The readers of the program's stage marks and counters on a small
synthetic trace, against values worked out by hand."""

import pytest

from benchmark import harness, spans
from benchmark import trace as tr

E = tr.Event


def _trace(marked=True):
    events = [
        E(tr.STEP_RANGE, "user_annotation", 0.0, 1000.0, 1),
        E("render", "user_annotation", 300.0, 350.0, 1),
        E("done_sync", "user_annotation", 550.0, 590.0, 1),
        E("autoreset", "user_annotation", 600.0, 800.0, 1),
        E("render", "user_annotation", 650.0, 750.0, 1),      # nested in the autoreset
        E("elementwise", "kernel", 5.0, 15.0, 7),              # before the first mark
        E("gst_span_smooth", "kernel", 20.0, 21.0, 7),
        E("mul", "kernel", 22.0, 40.0, 7),
        E("add", "kernel", 41.0, 60.0, 7),
        E("gst_span_none", "kernel", 61.0, 62.0, 7),
        E("gst_span_collide", "kernel", 63.0, 64.0, 7),
        E("void hull_sweep_kernel<8>(float const*)", "kernel", 65.0, 100.0, 7),
        E("gst_span_none", "kernel", 101.0, 102.0, 7),
        E("Memcpy DtoH", "gpu_memcpy", 110.0, 120.0, 7),
        E("gst_span_autoreset", "kernel", 130.0, 131.0, 7),
        E("Memset", "gpu_memset", 132.0, 150.0, 7),
        E("gst_span_render()", "kernel", 151.0, 152.0, 7),    # a demangled name
        E("raster", "kernel", 153.0, 200.0, 7),
        E("gst_span_autoreset", "kernel", 201.0, 202.0, 7),
        E("gst_span_none", "kernel", 203.0, 204.0, 7),
        E("gst_span_smooth", "kernel", 1100.0, 1101.0, 7),    # outside the step
        E("mul", "kernel", 1102.0, 1110.0, 7),
    ]
    if not marked:
        events = [e for e in events if not e.name.startswith(spans.MARK)]
    return tr.Trace(events=events, step=(0.0, 1000.0))


class _Run:
    def __init__(self, t):
        self.trace = t


@pytest.mark.parametrize("name,expected", [
    ("smooth_device_ms.state", 0.037),        # [22, 40] + [41, 60]; the mark left out
    ("collide_device_ms.state", 0.035),
    ("smooth_device_ops.state", 2.0),
    ("collide_device_ops.state", 1.0),
    # outside the physics: no span before the first mark [5, 15] and after
    # the first none [110, 120], the autoreset [132, 150], the render [153, 200]
    ("env_device_ms.state", 0.085),
    ("render_device_ms", 0.047),
    ("render_ms", 0.150),
    ("done_sync_ms", 0.040),
    # the autoreset's 200 us less the 100 us render nested in it
    ("autoreset_ms", 0.100),
])
def test_span_reader_values(name, expected):
    assert harness.reader(name)(_Run(_trace())) == pytest.approx(expected)


def test_labels_leave_the_marks_out_and_start_at_none():
    ops = spans.labelled(_trace())
    assert [(label, e.name[:6]) for label, e in ops] == [
        ("none", "elemen"), ("smooth", "mul"), ("smooth", "add"), ("collide", "void h"),
        ("none", "Memcpy"), ("autoreset", "Memset"), ("render", "raster")]
    marks = [e for e in _trace().device_ops() if spans.mark_name(e.name)]
    assert len(ops) + len(marks) == len(_trace().device_ops())
    assert spans.env_labels(_trace()) == {"none", "autoreset", "render"}


@pytest.mark.parametrize("name", ["efc_device_ms.state", "solve_device_ms.state"])
def test_a_stage_without_ops_reads_nothing(name):
    assert harness.reader(name)(_Run(_trace())) is None


SPAN_READERS = ["smooth_device_ms.state", "collide_device_ms.state", "efc_device_ms.state",
                "solve_device_ms.state", "env_device_ms.state", "smooth_device_ops.state",
                "collide_device_ops.state", "render_device_ms"]
COUNTER_READERS = ["newton_iters_per_solve.state", "newton_capped_pct.state"]
RANGE_READERS = ["render_ms", "autoreset_ms", "done_sync_ms"]


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_nothing_from_a_trace_without_marks(name):
    assert harness.reader(name)(_Run(_trace(marked=False))) is None


@pytest.mark.parametrize("name", SPAN_READERS + COUNTER_READERS + RANGE_READERS)
def test_readers_return_nothing_without_a_trace(name):
    assert harness.reader(name)(_Run(None)) is None


def test_counter_readers(monkeypatch):
    from gym_so100_tpu_torch import profiling

    counts = {"newton.solves": 40960.0, "newton.iterations": 102400.0, "newton.capped": 40.96}
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    run = _Run(_trace())
    assert harness.reader("newton_iters_per_solve.state")(run) == pytest.approx(2.5)
    assert harness.reader("newton_capped_pct.state")(run) == pytest.approx(0.1)
    counts.clear()                                   # a step that counted nothing
    assert harness.reader("newton_iters_per_solve.state")(run) is None
    monkeypatch.delattr(profiling, "counters")       # a program without counters
    assert harness.reader("newton_capped_pct.state")(run) is None
