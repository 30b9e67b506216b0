"""The Newton-solve kernel's runtime-nv kernel (nv above the largest
instantiation; one env per block of 4 warps), its CUDA source built in
float64 for the host (the shim: tests/kernels_host.py), on
chip_smoke.py's multi-cube scenes.

The states: so100_transfer_cube.xml with 4 free cubes (nv = 36, the
five-cube scene) and with 1 (nv = 18: one slot per lane), float32, K =
32, 6 envs (6 blocks) from chip_smoke's start
(qpos0, the arm joints moved by a seeded draw) after 2 control steps of the
port's `n_steps_batched` on the CPU: the cubes resting on the table, 4
contacts each, in every env.

* The default build (instantiations 12, 15, 16) runs nv = 18 and 36 on the
  runtime-nv kernel, held to `solve_plain` in float64 under the same
  budgets by the rule of the Panda state (`kernels_host.check_floor`):
  1e-9 of scale and the same iteration count on at least 95% of the lanes
  that no one-ulp perturbation of the plain solve's inputs moves, elsewhere
  at most twice what the perturbations do.
* nv = 12 (the resting-cube state) and 15 (the Panda state) still run on
  their instantiations in the default build: its launch shape is theirs,
  and its results equal those of a build with that instantiation alone,
  bit for bit.  A build with no instantiation runs them on the runtime-nv
  kernel, whose sums and products are the instantiations' in the same
  order: bit-equal again.
* An nv the instantiations take, with so many contact rows that its
  instantiation's 4-env block does not fit one block's shared memory (the
  resting-cube state with K = 96 contact slots; the float64 build counts
  shared memory in doubles), runs on the runtime-nv kernel, one env per
  block: the default build's launch shape and results are those of the
  build with no instantiation, bit for bit.
* A batch of 5 envs at nv = 36 gives each env the bits it gets solved
  alone (B = 1).
* The check fails for mutated copies of the source: the forward
  triangular solve leaving out the rows past 32 (rows 32-35 at nv = 36:
  the last cube's z and rotations, coupled by its contacts' friction to
  its x and y; leaving them out of the back substitution moved the
  results by less than the check's 1e-9), the first triangle entry a
  thread updates right of a Cholesky column found mod 16 in place of mod
  96, the threads of the trailing update (threads t and t + 16 then update
  the same entries, and most go without), and the block barrier dropped between the jar pass
  at the trial point and the pass over its units, whose costs the per-lane
  sums add up (the units then read jar values the pass has not written
  yet).
"""

import dataclasses

import pytest
import torch
from kernels_host import (  # noqa: F401 (fixtures)
    FULL_BUDGETS,
    _multicube_state,
    _panda_state,
    _problem,
    _solve_host,
    _solver_lib,
    check_floor,
    contact_state,
    host_tmp,
    plain_floor,
)

from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.ops import constraint_lanes, solver_lanes
from gym_so100_tpu_torch.ops.collision import narrowphase

ENVS = 6
SUBSTEPS = 20           # 2 control steps
BUILT = (12, 15, 16)    # the default build's instantiations


@pytest.fixture(scope="module")
def libs(host_tmp):
    """The default build, a build without instantiations (every nv on the
    runtime-nv kernel), and one build for each of nv = 12 and 15 alone."""
    return {nvs: _solver_lib(host_tmp, "double", tag="_wide_" + "_".join(map(str, nvs)),
                             nvs=nvs)
            for nvs in (BUILT, (), (12,), (15,))}


@pytest.fixture(scope="module")
def cube_floor(tmp_path_factory):
    """cube_floor(cubes): the `plain_floor` of the scene with `cubes` free
    cubes, computed once per module."""
    floors = {}

    def floor(cubes):
        if cubes not in floors:
            state = _multicube_state(tmp_path_factory.mktemp("scene"), cubes, ENVS, SUBSTEPS)
            m, s, sl, d = state
            efc = constraint_lanes.make_efc_from_lanes(
                m, d, s, narrowphase.collide_batched_lanes(m, d))
            assert m.nv == 12 + 6 * cubes
            assert (efc.con_active.sum(0) >= 4 * cubes).all(), "a cube is not on the table"
            floors[cubes] = plain_floor(state)
        return floors[cubes]
    return floor


@pytest.mark.parametrize("cubes", [4, 1], ids=["nv36", "nv18"])
def test_wide_kernel_source_equals_plain_in_float64(libs, cube_floor, cubes):
    floor = cube_floor(cubes)
    assert floor["problem"][0].nv > max(BUILT)
    check_floor(libs[BUILT], floor)


def _envs(problem, sl):
    """The solver problem of the envs `sl` (a slice of the batch)."""
    m, qM, a0, efc, warm = problem
    lane = lambda t: t[..., sl].contiguous()
    efc = dataclasses.replace(efc, **{
        f.name: lane(getattr(efc, f.name)) for f in dataclasses.fields(efc)
        if isinstance(getattr(efc, f.name), torch.Tensor)})
    return m, lane(qM), a0[sl].contiguous(), efc, warm[sl].contiguous()


def test_wide_kernel_env_alone_equals_env_in_a_batch_of_5(libs, cube_floor):
    floor = cube_floor(4)
    batch = _envs(floor["problem"], slice(0, 5))
    out = _solve_host(libs[BUILT], *batch, FULL_BUDGETS, floor["tol"])
    assert out[0].shape == (5, 36) and torch.isfinite(out[0]).all()
    for b in range(5):
        alone = _solve_host(libs[BUILT], *_envs(batch, slice(b, b + 1)), FULL_BUDGETS,
                            floor["tol"])
        for a, one in zip(out, alone):
            assert torch.equal(a[b:b + 1], one)


@pytest.fixture(scope="module", params=["resting_cube_nv12", "panda_nv15"])
def small_problem(request, contact_state):
    if request.param == "panda_nv15":
        return _problem(_panda_state(ENVS, 40), torch.float64)
    return _problem(contact_state, torch.float64, lanes=ENVS)


def _shape(lib, m, efc):
    import ctypes

    shape = (ctypes.c_int * 3)()
    lib.gst_newton_solve_shape.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.gst_newton_solve_shape(m.nv, efc.aref.shape[0], efc.neq, efc.nf, efc.nl,
                               efc.con_mu.shape[0], ctypes.cast(shape, ctypes.c_void_p))
    return tuple(shape)


def test_instantiated_nv_keeps_its_instantiation(libs, small_problem):
    m, qM, a0, efc, warm = small_problem
    *budgets, tol = solver_lanes.budgets(m, torch.float32)
    alone = libs[(m.nv,)]
    assert _shape(libs[BUILT], m, efc) == _shape(alone, m, efc)
    assert _shape(libs[BUILT], m, efc) != _shape(libs[()], m, efc)
    for a, b in zip(_solve_host(libs[BUILT], *small_problem, budgets, tol),
                    _solve_host(alone, *small_problem, budgets, tol)):
        assert torch.equal(a, b)


def test_wide_kernel_equals_the_instantiation_bit_for_bit(libs, small_problem):
    m, qM, a0, efc, warm = small_problem
    *budgets, tol = solver_lanes.budgets(m, torch.float32)
    wide = _solve_host(libs[()], *small_problem, budgets, tol)
    own = _solve_host(libs[(m.nv,)], *small_problem, budgets, tol)
    assert wide[0].shape == (ENVS, m.nv) and (wide[2] >= 1).all()
    for a, b in zip(wide, own):
        assert torch.equal(a, b)


def test_instantiated_nv_with_too_many_rows_runs_on_the_wide_kernel(libs, contact_state):
    m, s, sl, d = contact_state
    m96, _ = build_model(max_contacts=96, device="cpu")
    problem = _problem((m96, s, sl, d), torch.float64, lanes=ENVS)
    m, qM, a0, efc, warm = problem
    *budgets, tol = solver_lanes.budgets(m, torch.float32)
    shape = _shape(libs[BUILT], m, efc)
    assert m.nv == 12 and shape[0] == 1 and shape == _shape(libs[()], m, efc)
    own = _solve_host(libs[BUILT], *problem, budgets, tol)
    wide = _solve_host(libs[()], *problem, budgets, tol)
    assert torch.isfinite(own[0]).all() and (own[2] >= 1).all()
    for a, b in zip(own, wide):
        assert torch.equal(a, b)


# Mutations of newton_solve.cu that the nv = 36 check must catch: the
# forward solve's row loop cut to the first 32 rows, the first entry a
# thread updates right of a Cholesky column found mod 16 in place of mod
# 96, and the barrier after the jar pass at the trial point dropped.
MUTATIONS = {
    "row_loop_first_slot_only": (
        "for (int i = j + lane; i < nv; i += WARP) {",
        "for (int i = j + lane; i < nv && i < WARP; i += WARP) {"),
    "update_owner_mod_16": (
        "t0 + ((own - t0) % TS + TS) % TS",
        "t0 + ((own - t0) % 16 + 16) % 16"),
    "barrier_dropped_before_unit_costs": (
        "__syncthreads();                       // jar and x - x0 at x_new are in jn, dxn",
        ""),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_check_fails_for_mutated_source(host_tmp, cube_floor, mutation):
    lib = _solver_lib(host_tmp, "double", MUTATIONS[mutation], tag=f"_{mutation}", nvs=())
    with pytest.raises(AssertionError):
        check_floor(lib, cube_floor(4))
