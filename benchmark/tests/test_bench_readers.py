"""The per-layer readers on a small synthetic trace, against values
worked out by hand."""

import pytest

from benchmark import harness, roofline
from benchmark import trace as tr

E = tr.Event


def _trace():
    step = E(tr.STEP_RANGE, "user_annotation", 0.0, 1000.0, 1)
    events = [
        step,
        E("smooth", "user_annotation", 10.0, 110.0, 1),
        E("smooth", "user_annotation", 400.0, 430.0, 1),
        E("collide", "user_annotation", 120.0, 320.0, 1),
        E("efc", "user_annotation", 330.0, 350.0, 1),
        E("solve", "user_annotation", 350.0, 360.0, 1),
        E("integrate", "user_annotation", 360.0, 365.0, 1),
        E("aten::mul", "cpu_op", 20.0, 40.0, 1),
        E("void hull_sweep_kernel<8>(float const*)", "kernel", 100.0, 200.0, 7),
        E("elementwise", "kernel", 150.0, 300.0, 7),
        E("void hull_sweep_kernel<8>(float const*)", "kernel", 600.0, 640.0, 7),
        E("Memcpy DtoH", "gpu_memcpy", 500.0, 600.0, 7),
        E("void newton_solve_kernel<12>(float const*)", "kernel", 700.0, 750.0, 7),
        E("Memset", "gpu_memset", 1200.0, 1300.0, 7),          # outside the step
        E("smooth", "user_annotation", 1100.0, 1200.0, 1),     # outside the step
        E("gpu range", "gpu_user_annotation", 0.0, 1000.0, 7),  # not a device op
    ]
    return tr.Trace(events=events, step=(0.0, 1000.0))


class _Run:
    def __init__(self, t, shapes=None):
        self.trace, self.shapes = t, shapes


SHAPES = dict(B=2, nv=2, K=1, neq=0, nf=1, nl=1,
              hull=dict(G=2, ND=3, P=1, Vmax=4, counts=[3, 4]))


@pytest.mark.parametrize("name,expected", [
    # device union: [100, 300] + [500, 640] + [700, 750] = 390 us of 1000
    ("device_idle_pct", 61.0),
    ("device_ops_per_step", 5.0),
    ("device_ops_per_step.state", 5.0),
    ("device_ms_per_step", 0.390),
])
def test_reader_values(name, expected):
    assert harness.reader(name)(_Run(_trace(), SHAPES)) == pytest.approx(expected)


def test_roofline_readers_by_hand():
    # hull: bytes 4 * (3*2*2 + 9*2*2 + 2*3*4 + 3*3 + 4*1*2) + 4 * (2 + 2) = 4 * 89 + 16
    nbytes, ops = roofline.hull_sweep_work(2, 2, 3, 1, 4, [3, 4])
    assert nbytes == 372
    # ops: B * ND * ((27 + 14) + (27 + 21) + 2 * P) = 2 * 3 * 91
    assert ops == 546
    least = max(372 / 3.35e12, 546 / 67e12)
    got = harness.reader("hull_sweep_roofline")(_Run(_trace(), SHAPES))
    assert got == pytest.approx(100 * least / 70e-6)          # mean of 100 and 40 us
    # newton: NE = 0 + 1 + 1 + 4 = 6 rows; J 12, aref + D 12, aux 5, us 4,
    # tri 3, x0 + warm 4, out 5: 45 rows of B = 2 float32
    assert roofline.newton_solve_bytes(2, 2, 0, 1, 1, 1) == 4 * 45 * 2
    got = harness.reader("newton_solve_roofline")(_Run(_trace(), SHAPES))
    assert got == pytest.approx(100 * (360 / 3.35e12) / 50e-6)


@pytest.mark.parametrize("name", ["hull_sweep_roofline", "newton_solve_roofline"])
def test_state_cell_roofline_readers_are_the_same_readers(name):
    run = _Run(_trace(), SHAPES)
    assert harness.reader(name + ".state")(run) == harness.reader(name)(run)


def test_rate_readers():
    run = _Run(None)
    run.steps, run.env_steps, run.window_s = 3, 3 * 4096, 6.0
    assert harness.reader("env_steps_per_s")(run) == pytest.approx(2048.0)
    assert harness.reader("host_env_steps_per_s")(run) == pytest.approx(2048.0)
    run.steps = 0
    assert harness.reader("host_env_steps_per_s")(run) is None


@pytest.mark.parametrize("name", ["device_idle_pct",
                                  "device_ops_per_step", "hull_sweep_roofline",
                                  "newton_solve_roofline", "device_ms_per_step",
                                  "device_ops_per_step.state", "hull_sweep_roofline.state",
                                  "newton_solve_roofline.state"])
def test_readers_return_nothing_without_a_trace(name):
    assert harness.reader(name)(_Run(None, SHAPES)) is None


def test_union_and_gaps():
    assert tr.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert tr.idle_gaps(_trace()) == [(0.0, 100.0), (300.0, 500.0), (640.0, 700.0),
                                      (750.0, 1000.0)]


def test_breakdown_labels_gaps_by_host_activity():
    b = tr.breakdown(_trace())
    ops = dict(b["device_ops"])
    assert ops["void hull_sweep_kernel<8>(float const*)"] == pytest.approx(140e-6)
    gaps = dict(b["idle_gaps"])
    # the gaps [0, 100] and [300, 500] have their midpoints (50, 400) in a
    # smooth range with no op open; [640, 700] and [750, 1000] in none
    assert gaps == pytest.approx({"smooth/python": 300e-6, "step/python": 310e-6})
