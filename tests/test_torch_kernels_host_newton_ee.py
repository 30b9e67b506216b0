"""The Newton-solve kernel's CUDA source, built in float64 for the host, on
two states of the mocap-weld (EE) scene, whose 6 equality rows lead the
rows (the shim and the states: tests/kernels_host.py).

There half the lanes sit on knife edges of the float64 plain solve itself,
so the lanes that one-ulp perturbations of the plain solve's inputs change
are held to what those perturbations do instead of to 1e-9.  The check
fails on both states for a mutated copy of the source (the equality rows'
gradient scaled by 1.01).

The perturbed plain solves depend on the state only, not on the kernel
build under test, so they run once per state (`ee_floor`) for both tests.
"""

import dataclasses

import pytest
import torch
from kernels_host import (  # noqa: F401 (fixtures)
    EPS64,
    FULL_BUDGETS,
    PERTURB_SAMPLES,
    _ee_state,
    _problem,
    _solve_host,
    _solver_lib,
    host_tmp,
)

from gym_so100_tpu_torch.ops import constraint_lanes, solver_lanes
from gym_so100_tpu_torch.ops.collision import narrowphase


@pytest.fixture(scope="module")
def host_libs(host_tmp):
    return {"solve_double": _solver_lib(host_tmp, "double")}


@pytest.fixture(scope="module", params=["lifted_mocap_box", "full_scene"])
def ee_state(request):
    return request.param, _ee_state(lift_mocap_box=request.param == "lifted_mocap_box")


@pytest.fixture(scope="module")
def ee_floor(ee_state):
    """The EE state's float64 solver problem, its plain solve, and how far
    PERTURB_SAMPLES one-ulp perturbations of the plain solve's inputs move
    each lane (wq, wf) and whether they change its iteration count
    (moved_n).

    The state: the 6 weld rows (neq = 6, active in every env, with a
    residual) lead the rows, and every env has contacts."""
    state = ee_state[1]
    m, s, sl, d = state
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, narrowphase.collide_batched_lanes(m, d))
    assert efc.neq == 6 and (efc.D[:6] > 0).all() and (efc.pos[:6].abs().amax(0) > 1e-4).all()
    m, qM, a0, efc, warm = _problem(state, torch.float64)
    tol = solver_lanes.budgets(m, torch.float32)[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(solver_lanes, "budgets", lambda m, dtype: (*FULL_BUDGETS, tol))
        qp, fp, npl = solver_lanes.solve_plain(m, qM, a0, efc, warm)
        gen = torch.Generator().manual_seed(7)
        ulp = lambda t: t * (1 + EPS64 * torch.randn(t.shape, generator=gen, dtype=t.dtype))
        wq = torch.zeros(qp.shape[0], dtype=qp.dtype)
        wf = torch.zeros(fp.shape[0], dtype=fp.dtype)
        moved_n = torch.zeros(npl.shape, dtype=torch.bool)
        for _ in range(PERTURB_SAMPLES):
            q2, f2, n2 = solver_lanes.solve_plain(
                m, ulp(qM), ulp(a0),
                dataclasses.replace(efc, J=ulp(efc.J), aref=ulp(efc.aref), D=ulp(efc.D)), warm)
            wq = torch.maximum(wq, (q2 - qp).abs().amax(1))
            wf = torch.maximum(wf, (f2 - fp).abs().amax(1))
            moved_n |= n2 != npl
    return dict(problem=(m, qM, a0, efc, warm), tol=tol, plain=(qp, fp, npl),
                wq=wq, wf=wf, moved_n=moved_n)


def _check_ee_state(lib, floor):
    """The EE state's kernel solve against the plain one.

    Its states put many lanes on knife edges of the float64 plain solve
    itself: one-ulp perturbations of its inputs (PERTURB_SAMPLES of them)
    change the iteration count of about half the lanes (the stop test
    after convergence, with the mocap box lifted) and, on the full scene,
    move lanes by far more than 1e-9 of the scale.  So the
    criterion of test_torch_kernels_host_newton.py (1e-9, same iteration
    count, >= 95% of lanes) holds on the lanes that no perturbation
    changes; on the others the kernel may part from the plain solve only as
    the perturbations do: values by at most twice the most they moved that
    lane, and another iteration count only where they changed it."""
    qk, fk, nk = _solve_host(lib, *floor["problem"], FULL_BUDGETS, floor["tol"])
    qp, fp, npl = floor["plain"]
    wq, wf, moved_n = floor["wq"], floor["wf"], floor["moved_n"]
    sq, sf = qp.abs().amax().clamp(min=1.0), fp.abs().amax().clamp(min=1.0)
    dq, df = (qk - qp).abs().amax(1), (fk - fp).abs().amax(1)
    same_x = (dq <= 1e-9 * sq) & (df <= 1e-9 * sf)
    same_n = nk == npl.double()
    stable = (wq <= 1e-9 * sq) & (wf <= 1e-9 * sf) & ~moved_n
    assert stable.sum() >= 8, stable
    assert float((same_x & same_n)[stable].double().mean()) >= 0.95
    assert (dq[~same_x] <= 2 * wq[~same_x]).all() and (df[~same_x] <= 2 * wf[~same_x]).all()
    assert not (~same_n & ~moved_n).any()


def test_solver_kernel_source_with_equality_rows_equals_plain_in_float64(
        host_libs, ee_floor):
    _check_ee_state(host_libs["solve_double"], ee_floor)


def test_solver_check_fails_for_mutated_equality_rows(host_tmp, ee_floor):
    """The check above fails on both EE states when the equality rows'
    gradient is scaled by 1.01 in the source."""
    mutation = ("            g = Dr * jr;\n            h = Dr;",
                "            g = (r < L.neq ? 1.01f : 1.f) * Dr * jr;\n            h = Dr;")
    lib = _solver_lib(host_tmp, "double", mutation, tag="_equality_gradient")
    with pytest.raises(AssertionError):
        _check_ee_state(lib, ee_floor)
