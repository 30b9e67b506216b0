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
* An nv and NE whose single env's region exceeds one block's shared
  memory: the entry point refuses them (a zero launch shape), and so does
  `solve_fused`, which reads that shape.
"""

import pytest
import torch
from kernels_host import (  # noqa: F401 (fixtures)
    FULL_BUDGETS,
    _panda_state,
    _problem,
    _solve_host,
    _solver_lib,
    check_floor,
    contact_state,
    host_tmp,
    plain_floor,
)

from gym_so100_tpu_torch.ops import constraint_lanes, solver_lanes
from gym_so100_tpu_torch.ops.collision import narrowphase

PANDA_ENVS = 6
HOLD_SUBSTEPS = 40      # 4 control steps


@pytest.fixture(scope="module")
def panda_state():
    m, s, sl, d = state = _panda_state(PANDA_ENVS, HOLD_SUBSTEPS)
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, narrowphase.collide_batched_lanes(m, d))
    assert m.nv == 15 and efc.neq == 7 and (efc.D[:7] > 0).all()
    assert efc.con_active.any(0).all(), "some env has no active contact"
    return state


@pytest.fixture(scope="module")
def panda_floor(panda_state):
    """The float64 problem, the float32 budgets and tol, the plain solve,
    and how far PERTURB_SAMPLES one-ulp perturbations of the plain solve's
    inputs move each lane (`kernels_host.plain_floor`)."""
    return plain_floor(panda_state)


@pytest.fixture(scope="module")
def libs(host_tmp):
    return {nvs: _solver_lib(host_tmp, "double", tag=f"_nv{nvs[0]}", nvs=nvs)
            for nvs in ((12,), (15,), (16,))}


def test_nv15_source_equals_plain_in_float64(libs, panda_floor):
    check_floor(libs[(15,)], panda_floor)


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
        check_floor(lib, panda_floor)


def test_env_region_above_the_block_limit_is_refused(host_tmp, panda_floor, monkeypatch):
    """An nv and NE whose single env's region exceeds one block's 232,448 B
    of shared memory (nv = 40, NE = 1500: J alone is 240 KB): the entry
    point returns cudaErrorInvalidValue (1 in the shim) and a zero launch
    shape and writes nothing; `solve_fused`, given this build as its
    library, raises before it touches the card (meta tensors), naming the
    limit, nv and NE.  Below the limit the launch shape is the runtime-nv
    kernel's one env per block of 128 threads at every NE at nv = 40, its
    shared memory growing with NE, and nv = 16 with NE = 1500, whose
    instantiation's 4-env block does not fit, still gets a launch shape
    (the runtime-nv kernel's).  A float32 build: the float64 one counts its
    shared memory in doubles."""
    import ctypes
    import dataclasses

    from gym_so100_tpu_torch import kernels

    lib = _solver_lib(host_tmp, "float", tag="_nv16_float", nvs=(16,))
    (m, qM, a0, efc, warm), tol = panda_floor["problem"], panda_floor["tol"]
    B = a0.shape[0]
    K = efc.con_mu.shape[0]
    nv, NE = 40, 1500
    out = torch.full((2 * nv + 1, B), float("nan"), dtype=torch.float32)
    err = lib.gst_newton_solve(*[None] * 8, out.data_ptr(), nv, NE, efc.neq, efc.nf,
                               efc.nl, K, B, *FULL_BUDGETS, tol, None)
    assert err == 1 and torch.isnan(out).all()
    lib.gst_newton_solve_shape.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]

    def shape_of(nv, NE):
        shape = (ctypes.c_int * 3)(7, 7, 7)
        lib.gst_newton_solve_shape(nv, NE, efc.neq, efc.nf, efc.nl, K,
                                   ctypes.cast(shape, ctypes.c_void_p))
        return tuple(shape)

    assert shape_of(nv, NE) == (0, 0, 0)
    assert shape_of(16, efc.aref.shape[0])[:2] == (4, 128)
    assert shape_of(16, NE)[:2] == (1, 128)
    seen, last = set(), 0
    for NE_ in (170, 400, 700, 1300, 1400, NE):
        E, threads, smem = shape_of(nv, NE_)
        assert (E, threads) in ((1, 128), (0, 0)) and smem <= 232448 and (smem > 0) == (E > 0)
        assert smem > last or E == 0
        seen.add(E)
        last = smem
    assert seen == {1, 0}
    monkeypatch.setattr(kernels, "library", lambda: lib)
    meta = lambda *shape: torch.empty(*shape, device="meta")
    big = dataclasses.replace(efc, J=meta(nv, NE, B), aref=meta(NE, B), D=meta(NE, B))
    with pytest.raises(ValueError, match=f"232448 B.*nv = {nv} with NE = {NE}"):
        solver_lanes.solve_fused(m, meta(nv, nv, B), meta(B, nv), big, meta(B, nv))
