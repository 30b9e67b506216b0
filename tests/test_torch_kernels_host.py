"""The hull-sweep kernel's CUDA source, compiled for the host and checked on
the CPU (the shim and the states: tests/kernels_host.py).

Float32, against `sweep_h_plain` (the same operations in the same order):
equal on the resting-cube state, also at a batch that leaves the last
block partly empty, and on the mocap-weld scene, whose larger tables run 4
envs per block; tables too large for a 4-env block make the entry point
return an error.
"""

import ctypes

import pytest
import torch
from kernels_host import (  # noqa: F401 (fixtures)
    _ee_state,
    _build,
    _hull_host,
    _hull_inputs,
    _P,
    _I,
    contact_state,
    host_tmp,
)

from gym_so100_tpu_torch.ops.collision import hull_lanes


@pytest.fixture(scope="module")
def host_libs(host_tmp):
    hull = _build(host_tmp, "hull_sweep", "float")
    hull.gst_hull_sweep.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    hull.gst_hull_sweep_shape.argtypes = [_I] * 4 + [_P]
    return dict(hull=hull)


@pytest.fixture(scope="module")
def ee_full_scene():
    return _ee_state(lift_mocap_box=False)


def test_hull_kernel_source_equals_plain(host_libs, contact_state):
    tb, args = _hull_inputs(contact_state)
    ref = hull_lanes.sweep_h_plain(*args)
    err, out = _hull_host(host_libs["hull"], tb, args)
    assert err == 0
    assert (ref[:tb.P] < 0).any(), "no penetrating hull pair in the test state"
    assert torch.equal(out, ref)


def test_hull_kernel_source_equals_plain_in_a_partial_block(host_libs, contact_state):
    """B = 29 is no multiple of the 8 envs of a block: the last block mixes
    real envs with zero-filled staging lanes that must write nothing."""
    tb, args = _hull_inputs(contact_state, lanes=29)
    ref = hull_lanes.sweep_h_plain(*args)
    err, out = _hull_host(host_libs["hull"], tb, args)
    assert err == 0 and out.shape[1] == 29
    assert torch.equal(out, ref)


def test_hull_kernel_source_refuses_tables_too_large_for_a_block(host_libs,
                                                                 contact_state):
    """Tables that do not fit one block's shared memory at 8 envs, nor at
    4, make the entry point return an error, and nothing is launched."""
    tb, args = _hull_inputs(contact_state)
    err, out = _hull_host(host_libs["hull"], tb, args, ND=4 * tb.D.shape[0])
    assert err != 0 and torch.isnan(out).all()


def test_hull_kernel_source_equals_plain_on_the_ee_scene(host_libs, ee_full_scene):
    """The mocap-weld scene has one hull geom more (G = 26, P = 138): 8
    envs no longer fit a block, so the kernel runs 4 per block, and its
    tables stay bit-equal to the plain version's (B = 32 and 29)."""
    for lanes in (None, 29):
        tb, args = _hull_inputs(ee_full_scene, lanes)
        shape = (ctypes.c_int * 3)()
        host_libs["hull"].gst_hull_sweep_shape(tb.G, tb.D.shape[0], tb.P, tb.vtot, shape)
        assert (tb.G, tb.P, shape[0]) == (26, 138, 4)
        ref = hull_lanes.sweep_h_plain(*args)
        err, out = _hull_host(host_libs["hull"], tb, args)
        assert err == 0 and torch.equal(out, ref)
    assert (ref[:tb.P] < 0).any(), "no penetrating hull pair in the test state"
