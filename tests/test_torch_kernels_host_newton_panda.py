"""The Newton-solve kernel's CUDA source at nv = 15 (the Franka Panda EE
scene), built in float64 for the host (the shim: tests/kernels_host.py).

The state: the batched lanes step of `pandas_transfer_cube_ee.xml` (K = 24,
float32) held for 4 control steps from "home", with each env's arm joints
moved by at most 0.01 rad (seeded) and its mocap target on its ee site:
the cube resting on the table in every env, and the 7 equality rows (the
6-row weld and the finger-coupling joint) leading the constraint rows.
6 envs, so the second 4-env block is half empty.

* The nv = 15 instantiation against `solve_plain` in float64 under the
  same budgets.  Every env has 4-5 contacts in the middle zone of the
  cone, and lanes sit on knife edges of the plain solve itself: one-ulp
  perturbations of its inputs move some well past 1e-9 of scale.  So
  the rule of the EE states (test_torch_kernels_host_newton_ee.py) holds
  here: 1e-9 and the same iteration count on at least 95% of the lanes no
  perturbation moves, and elsewhere at most twice what the perturbations
  do.
* Padding: a build with only the nv = 16 instantiation runs the Panda
  problem padded, and the nv = 12 resting-cube problem padded; both are
  bit-equal to their own instantiation's results.
* The check fails for mutated copies of the source: the triangle entries
  a lane owns fixed at 3 again (covers 96 of the 120 at nv = 15), and the
  padded dofs' qM block made singular (see the test for which entries).
* nv above 16: the entry point refuses it, and so does `solve_fused`.
"""

import dataclasses

import numpy as np
import pytest
import torch
from kernels_host import (  # noqa: F401 (fixtures)
    EPS64,
    FULL_BUDGETS,
    PERTURB_SAMPLES,
    _problem,
    _solve_host,
    _solver_lib,
    contact_state,
    host_tmp,
)

from gym_so100_tpu_torch.models.builder import PANDA_XML, build_model
from gym_so100_tpu_torch.models.scene import Data, State
from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes, solver_lanes
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.ops.collision import narrowphase

PANDA_ENVS = 6
HOLD_SUBSTEPS = 40      # 4 control steps


@pytest.fixture(scope="module")
def panda_state():
    m, aux = build_model(PANDA_XML, max_contacts=24, device="cpu")
    kq, kc = aux["keyframes"]["home"]
    B = PANDA_ENVS
    qpos = np.tile(np.asarray(kq, np.float64), (B, 1))
    qpos[:, :7] += np.random.RandomState(8).uniform(-0.01, 0.01, (B, 7))
    one = fwd.make_state(m, qpos=kq, ctrl=kc)
    s = State(qpos=torch.tensor(qpos, dtype=torch.float32), qvel=torch.zeros(B, m.nv),
              ctrl=one.ctrl.expand(B, -1).clone(),
              mocap_pos=one.mocap_pos.expand(B, -1, -1).clone(),
              mocap_quat=one.mocap_quat.expand(B, -1, -1).clone(),
              qacc_warmstart=torch.zeros(B, m.nv))
    ee = m.site_id("ee_site")
    s = s.replace(mocap_pos=smooth_lanes.kinematics(m, s).site_xpos[:, ee][:, None].clone())
    s, _ = fwd.n_steps_batched(m, s, HOLD_SUBSTEPS)
    sl = smooth_lanes.forward_smooth_lanes(m, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
             site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"],
             subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"])
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, narrowphase.collide_batched_lanes(m, d))
    assert m.nv == 15 and efc.neq == 7 and (efc.D[:7] > 0).all()
    assert efc.con_active.any(0).all(), "some env has no active contact"
    return m, s, sl, d


@pytest.fixture(scope="module")
def panda_floor(panda_state):
    """The float64 problem, the float32 budgets and tol, the plain solve,
    and how far PERTURB_SAMPLES one-ulp perturbations of the plain solve's
    inputs move each lane (wq, wf) and whether they change its iteration
    count (moved_n)."""
    m, qM, a0, efc, warm = problem = _problem(panda_state, torch.float64)
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
    return dict(problem=problem, tol=tol, plain=(qp, fp, npl), wq=wq, wf=wf,
                moved_n=moved_n)


@pytest.fixture(scope="module")
def libs(host_tmp):
    return {nvs: _solver_lib(host_tmp, "double", tag=f"_nv{nvs[0]}", nvs=nvs)
            for nvs in ((12,), (15,), (16,))}


def _check(lib, floor):
    """The kernel source's solve against the plain one: on the lanes that
    no one-ulp perturbation of the plain solve moves past 1e-9 of scale or
    to another iteration count, equal to 1e-9 with the same count on at
    least 95% of them; on the others within twice what the perturbations
    moved the lane, and another count only where they changed it."""
    qk, fk, nk = _solve_host(lib, *floor["problem"], FULL_BUDGETS, floor["tol"])
    qp, fp, npl = floor["plain"]
    wq, wf, moved_n = floor["wq"], floor["wf"], floor["moved_n"]
    sq, sf = qp.abs().amax().clamp(min=1.0), fp.abs().amax().clamp(min=1.0)
    dq, df = (qk - qp).abs().amax(1), (fk - fp).abs().amax(1)
    same_x = (dq <= 1e-9 * sq) & (df <= 1e-9 * sf)
    same_n = nk == npl.double()
    stable = (wq <= 1e-9 * sq) & (wf <= 1e-9 * sf) & ~moved_n
    assert stable.any(), "no lane off the knife edges"
    assert float((same_x & same_n)[stable].double().mean()) >= 0.95
    assert (dq[~same_x] <= 2 * wq[~same_x]).all() and (df[~same_x] <= 2 * wf[~same_x]).all()
    assert not (~same_n & ~moved_n).any()


def test_nv15_source_equals_plain_in_float64(libs, panda_floor):
    _check(libs[(15,)], panda_floor)


def test_padded_panda_problem_equals_its_instantiation(libs, panda_floor):
    """nv = 15 on the nv = 16 instantiation: the padded dofs change no
    sum over the real ones, so the results are bit-equal."""
    problem, tol = panda_floor["problem"], panda_floor["tol"]
    own = _solve_host(libs[(15,)], *problem, FULL_BUDGETS, tol)
    padded = _solve_host(libs[(16,)], *problem, FULL_BUDGETS, tol)
    for a, b in zip(own, padded):
        assert a.shape == b.shape and torch.equal(a, b)


def test_padded_resting_cube_problem_equals_its_instantiation(libs, contact_state):
    """The nv = 12 resting-cube problem (tests/kernels_host.py) run
    padded on the nv = 16 instantiation: bit-equal to the nv = 12 one."""
    m, qM, a0, efc, warm = problem = _problem(contact_state, torch.float64)
    *budgets, tol = solver_lanes.budgets(m, torch.float32)
    own = _solve_host(libs[(12,)], *problem, budgets, tol)
    padded = _solve_host(libs[(16,)], *problem, budgets, tol)
    assert own[0].shape == (a0.shape[0], 12)
    for a, b in zip(own, padded):
        assert torch.equal(a, b)


# Mutations of newton_solve.cu that the float64 check must catch, each with
# the instantiations it is built with: the entries of the triangle a lane
# owns fixed at 3, as at nv = 12 (entries 96-119 of the nv = 15 Hessian
# are then never assembled), on the nv = 15 build; and, on the nv = 16
# build where the Panda runs padded, the padded qM block given off-diagonal
# 1 in place of 0, which couples the padded dof to the real ones.  (Its
# diagonal set to 0 in place of 1 leaves every result as it is: the padded
# dof's gradient is 0 whatever its mass, and the Cholesky clamps the zero
# pivot to sqrt(FLT_MIN), so its factor row solves to 0 all the same.)
MUTATIONS = {
    "slots_fixed_at_3": (
        ("static constexpr int SLOTS = (NTRI + WARP - 1) / WARP;",
         "static constexpr int SLOTS = 3;"), (15,)),
    "padded_qM_off_diagonal_1": (
        ("return tri_nv + i == tri(r, r) ? 1.f : 0.f;",
         "return tri_nv + i == tri(r, r) ? 1.f : 1.f;"), (16,)),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_check_fails_for_mutated_source(host_tmp, panda_floor, mutation):
    mutate, nvs = MUTATIONS[mutation]
    lib = _solver_lib(host_tmp, "double", mutate, tag=f"_{mutation}", nvs=nvs)
    with pytest.raises(AssertionError):
        _check(lib, panda_floor)


def test_nv_above_16_is_refused(libs, panda_floor):
    """The entry point returns cudaErrorInvalidValue (1 in the shim) and a
    zero launch shape for nv = 17 and writes nothing; `solve_fused`
    raises, naming the limit, before it touches the card."""
    import ctypes

    lib = libs[(16,)]
    (m, qM, a0, efc, warm), tol = panda_floor["problem"], panda_floor["tol"]
    NE, B = efc.aref.shape
    K = efc.con_mu.shape[0]
    out = torch.full((2 * 17 + 1, B), float("nan"), dtype=torch.float64)
    err = lib.gst_newton_solve(*[None] * 8, out.data_ptr(), 17, NE, efc.neq, efc.nf,
                               efc.nl, K, B, *FULL_BUDGETS, tol, None)
    assert err == 1 and torch.isnan(out).all()
    shape = (ctypes.c_int * 3)(7, 7, 7)
    lib.gst_newton_solve_shape.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.gst_newton_solve_shape(17, NE, efc.neq, efc.nf, efc.nl, K,
                               ctypes.cast(shape, ctypes.c_void_p))
    assert tuple(shape) == (0, 0, 0)
    lib.gst_newton_solve_shape(16, NE, efc.neq, efc.nf, efc.nl, K,
                               ctypes.cast(shape, ctypes.c_void_p))
    assert tuple(shape)[:2] == (4, 128) and shape[2] > 0
    big = torch.zeros(B, 17, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="nv <= 16"):
        solver_lanes.solve_fused(m, torch.zeros(17, 17, B), big, efc, big)
