"""The Newton-solve kernel's CUDA source, compiled for the host and checked
on the CPU on the resting-cube state (the shim and the states:
tests/kernels_host.py).

* built in float64 (every `float` of the source made `double`): equal to
  `solve_plain` in float64 under the same budgets to 1e-9 on at least 95%
  of the lanes, on a state whose contacts reach both the top and the
  middle zone of the elliptic cone (a lane can part at a knife edge of the
  line search, e.g. the sign of a directional derivative that is 0 up to
  rounding);
* built in float32: finite, with iteration counts in range;
* in both builds, the results of a batch that leaves the last block partly
  empty equal those of a full batch on its lanes;
* the float64 check fails for mutated copies of the source: a middle-zone
  gradient or Hessian term scaled, or the rows of one lane of the warp
  dropped from the gradient.

The states of the mocap-weld scene: test_torch_kernels_host_newton_ee.py.
"""

import pytest
import torch
from kernels_host import (  # noqa: F401 (fixtures)
    FULL_BUDGETS,
    _problem,
    _solve_host,
    _solver_lib,
    contact_state,
    host_tmp,
)

from gym_so100_tpu_torch.ops import solver_lanes


@pytest.fixture(scope="module")
def host_libs(host_tmp):
    return {f"solve_{real}": _solver_lib(host_tmp, real) for real in ("float", "double")}


def _share_equal_in_float64(lib, contact_state, budgets, monkeypatch, lanes=None,
                            zones=("top", "middle")):
    """Share of lanes on which the float64 kernel source equals
    `solve_plain` (qacc and qfrc to 1e-9, same iteration count); the
    state's active contacts must reach each of the cone `zones`."""
    m, qM, a0, efc, warm = _problem(contact_state, torch.float64, lanes)
    # the float32 budgets and tol (and two shorter ones) on both sides, so
    # that lanes stop with their budget spent as on the card
    tol = solver_lanes.budgets(m, torch.float32)[-1]
    monkeypatch.setattr(solver_lanes, "budgets", lambda m, dtype: (*budgets, tol))
    qk, fk, nk = _solve_host(lib, m, qM, a0, efc, warm, budgets, tol)
    qp, fp, npl = solver_lanes.solve_plain(m, qM, a0, efc, warm)
    # the state must reach the given zones of the elliptic cone
    jar = (efc.J * qp.T[:, None]).sum(0) - efc.aref
    cone = solver_lanes._cost_terms(efc, jar)[5]
    for zone in zones:
        assert (cone[zone] & efc.con_active).any(), zone
    same = ((qk - qp).abs().amax(1) <= 1e-9 * qp.abs().amax().clamp(min=1.0)) & \
           ((fk - fp).abs().amax(1) <= 1e-9 * fp.abs().amax().clamp(min=1.0)) & \
           (nk == npl.double())
    return float(same.double().mean())


@pytest.mark.parametrize("budgets", [FULL_BUDGETS, (3, 6, 5), (1, 6, 0)])
def test_solver_kernel_source_equals_plain_in_float64(host_libs, contact_state, budgets,
                                                      monkeypatch):
    share = _share_equal_in_float64(host_libs["solve_double"], contact_state, budgets,
                                    monkeypatch)
    assert share >= 0.95, share


def test_solver_kernel_source_in_a_partial_block_equals_full_blocks(host_libs,
                                                                   contact_state):
    """B = 29 is no multiple of the envs of a block: the warps of the last
    block past B stage zeros and must neither solve nor write (a write past
    B lands in the next output row).  Each env's result must not depend on
    the batch, so the first 29 lanes equal those of the B = 32 run bit for
    bit, in both builds.  (`solve_plain` is no reference here: its float64
    results move with the batch width, as torch's vector loops round the
    last lanes otherwise.)"""
    for real, dtype in (("double", torch.float64), ("float", torch.float32)):
        lib = host_libs[f"solve_{real}"]
        *budgets, tol = solver_lanes.budgets(contact_state[0], torch.float32)
        full = _solve_host(lib, *_problem(contact_state, dtype), budgets, tol)
        part = _solve_host(lib, *_problem(contact_state, dtype, lanes=29), budgets, tol)
        for f, p in zip(full, part):
            assert p.shape[0] == 29 and torch.equal(f[:29], p)


# Mutations of newton_solve.cu that the float64 check must catch: a
# middle-zone term of the gradient and of the Hessian scaled by 1.1, and the
# rows of lane 0 (contact 0, active in every env of the state) dropped from
# the warp's gradient sum.
MUTATIONS = {
    "middle_gradient": ("+ kw * mu * uhat[j - 1] * usj[j];",
                        "+ 1.1f * kw * mu * uhat[j - 1] * usj[j];"),
    "middle_hessian": ("a[m] += kz * ai * al + wmu * (ss - pi * pl);",
                       "a[m] += 1.1f * kz * ai * al + wmu * (ss - pi * pl);"),
    "lane0_gradient": ("gcon[v] += t;", "if (lane != 0) gcon[v] += t;"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_solver_check_fails_for_mutated_source(host_tmp, contact_state, mutation,
                                               monkeypatch):
    lib = _solver_lib(host_tmp, "double", MUTATIONS[mutation], tag=f"_{mutation}")
    share = _share_equal_in_float64(lib, contact_state, FULL_BUDGETS, monkeypatch)
    assert share < 0.95, share


def test_solver_kernel_source_runs_in_float32(host_libs, contact_state):
    m, qM, a0, efc, warm = _problem(contact_state, torch.float32)
    *budgets, tol = solver_lanes.budgets(m, torch.float32)
    qk, fk, nk = _solve_host(host_libs["solve_float"], m, qM, a0, efc, warm, budgets, tol)
    qp, _, npl = solver_lanes.solve_plain(m, qM, a0, efc, warm)
    assert torch.isfinite(qk).all() and torch.isfinite(fk).all()
    assert ((nk >= 1) & (nk <= solver_lanes.NEWTON_ITERS)).all()
    rms = float(qp.pow(2).mean().sqrt())
    err = (qk - qp).abs().amax(1) / max(rms, 1.0)
    assert float(err.median()) < 1e-4
    assert abs(float(nk.mean()) - float(npl.float().mean())) < 0.5
