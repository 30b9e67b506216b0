"""The batched lanes step of chip_smoke.py's multi-cube SO100 scenes on the
port, against the JAX package on the same inputs.

`chip_smoke.write_multicube_scene` writes so100_transfer_cube.xml with more
free cubes resting on the table (K = 32): with one (nv = 18) the Newton
solve is the one the card's runtime-nv kernel runs with one slot per lane;
with four (nv = 36, the five-cube scene) two.  Both start from
chip_smoke's start (qpos0, each env's arm joints moved by a seeded draw of
at most 0.01 rad, the servos at 0) and run 2 control steps through the
port on the CPU, so that every env has its cubes' contacts (from qpos0 the
cubes sit 1 mm above the table, and the first substep has none); that
state is handed to both packages.

* nv = 18, float32, 4 envs: one substep of `forward.n_steps_batched` (on
  the CPU both run the plain solve: JAX's scan path at B % 128 != 0).
  Each lane of qpos, qvel and the warm start is held to the larger of
  1e-5 of the array's largest magnitude and twice the most that 8 one-ulp
  perturbations of the port's start move that lane (the rule of
  tests/test_torch_panda_batched.py), with equal candidate counts; the
  bound must reject the port's substep with the extra cube's contact time
  constant doubled (a planted fault).  JAX runs the substep op by op
  (`jax.disable_jit()`, about a minute): its jit compile took 4-8 minutes
  on an 8-core CPU beside the suite's other workers.
* nv = 36, float64, 4 envs: the Newton solve alone.  The port's
  `solve_plain` against JAX's `solver_lanes.solve_lanes` (the scan path) on
  the same float64 problem (the settled state's fields in float64, the
  port's constraint rows handed to both): qacc and qfrc within 1e-10 of
  the larger of 1 and their largest magnitude, iteration counts equal.
  JAX's solve runs op by op (`jax.disable_jit`, ~20 s): jitted at nv = 36
  its compile grew past 18 GB of memory and 12 minutes here, and JAX's
  whole step at nv = 36 past 4 minutes, so neither is run.
"""

import dataclasses

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.models.scene import State as JaxState
from gym_so100_tpu.ops import forward as jax_fwd
from gym_so100_tpu.ops import solver_lanes as jax_solver
from gym_so100_tpu.ops.constraint_lanes import EfcLanes as JaxEfcLanes
from gym_so100_tpu_torch.models.builder import build_model
from gym_so100_tpu_torch.models.scene import Data
from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes, solver_lanes
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.ops.collision import narrowphase

B, K = 4, 32
SETTLE = 20             # substeps (2 control steps) of the port before the comparison
ARRAYS = ("qpos", "qvel", "qacc_warmstart")
FLOOR_SAMPLES = 8
FIELDS = ("qpos", "qvel", "ctrl", "mocap_pos", "mocap_quat", "qacc_warmstart")


def _settled(path):
    """The port's model and its float32 batch after SETTLE substeps."""
    m, _ = build_model(str(path), max_contacts=K, device="cpu")
    s, _ = fwd.n_steps_batched(m, chip_smoke._multicube_start(m, B), SETTLE)
    return m, s


def _within(ours, theirs, spread, tol):
    """Per lane: max |ours - theirs| against the larger of tol times the
    largest magnitude of theirs and twice the lane's one-ulp spread."""
    ours, theirs = ours.numpy().astype(np.float64), np.asarray(theirs, np.float64)
    diff = np.abs(ours - theirs).max(1)
    bound = np.maximum(tol * np.abs(theirs).max(), 2 * spread.numpy())
    return bool((diff <= bound).all()), diff, bound


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    return {cubes: chip_smoke.write_multicube_scene(d, cubes) for cubes in (1, 4)}


@pytest.fixture(scope="module")
def substep(scenes):
    """The port's and JAX's `n_steps_batched(m, s, 1)` on the nv = 18 scene
    from the settled state, and per array the most that FLOOR_SAMPLES
    one-ulp perturbations of the port's start qpos move each lane of the
    port's result, (B,)."""
    m, s = _settled(scenes[1])
    assert m.nv == 18
    mj, _ = jax_build_model(str(scenes[1]), max_contacts=K)
    mj = mj.astype(jnp.float32)
    sj = JaxState(**{k: jnp.asarray(getattr(s, k).numpy()) for k in FIELDS})
    out_t, ncon_t = fwd.n_steps_batched(m, s, 1)
    with jax.disable_jit():
        out_j, ncon_j = jax_fwd.n_steps_batched(mj, sj, 1)
    gen = torch.Generator().manual_seed(5)
    eps = torch.finfo(torch.float32).eps
    spread = {k: torch.zeros(B, dtype=torch.float64) for k in ARRAYS}
    for _ in range(FLOOR_SAMPLES):
        qpos = s.qpos * (1 + eps * torch.randn(s.qpos.shape, generator=gen))
        moved = fwd.n_steps_batched(m, s.replace(qpos=qpos), 1)[0]
        for k in ARRAYS:
            d = (getattr(moved, k) - getattr(out_t, k)).abs().amax(1).double()
            spread[k] = torch.maximum(spread[k], d)
    return dict(m=m, s=s, out_t=out_t, ncon_t=ncon_t, out_j=out_j, ncon_j=ncon_j,
                spread=spread)


@pytest.mark.parametrize("name", ARRAYS)
def test_nv18_substep_matches_jax(substep, name):
    r = substep
    ours, theirs = getattr(r["out_t"], name), getattr(r["out_j"], name)
    assert r["out_j"].qpos.dtype == jnp.float32 and ours.dtype == torch.float32
    assert np.isfinite(ours.numpy()).all() and ours.shape == theirs.shape
    ok, diff, bound = _within(ours, theirs, r["spread"][name], 1e-5)
    assert ok, (name, diff, bound)


def test_nv18_substep_contacts(substep):
    """The same candidate counts, the extra cube on the table in every env."""
    r = substep
    np.testing.assert_array_equal(r["ncon_t"].numpy(), np.asarray(r["ncon_j"]))
    assert (r["ncon_t"] >= 4).all()


def test_nv18_bound_rejects_a_planted_fault(substep):
    """The port's substep with the extra cube's contact time constant
    doubled (its pairs' solref) lies outside the bound in some array."""
    r = substep
    m = r["m"]
    cube = m.names_geom.index("cube0_geom")
    flat = list(m.pairs.box_box) + list(m.pairs.hull_box) + list(m.pairs.hull_hull)
    pairs = [i for i, pair in enumerate(flat) if cube in pair]
    solref = m.pair_solref.clone()
    solref[pairs, 0] *= 2
    out_f = fwd.n_steps_batched(dataclasses.replace(m, pair_solref=solref), r["s"], 1)[0]
    assert not all(_within(getattr(out_f, k), getattr(r["out_j"], k), r["spread"][k], 1e-5)[0]
                   for k in ARRAYS)


@pytest.fixture(scope="module")
def solve36(scenes):
    """The five-cube scene's float64 solver problem at the settled state
    (its fields in float64), solved by the port's plain solve and by JAX's
    `solve_lanes` on the same rows."""
    _, s = _settled(scenes[4])
    m, _ = build_model(str(scenes[4]), max_contacts=K, device="cpu", dtype=torch.float64)
    s = s.replace(**{k: getattr(s, k).double() for k in FIELDS})
    sl = smooth_lanes.forward_smooth_lanes(m, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
             site_xpos=sl["site_xpos"], site_xmat=sl["site_xmat"],
             subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"])
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, narrowphase.collide_batched_lanes(m, d))
    qM, a0, warm = sl["qM_lanes"], sl["qacc_smooth"], s.qacc_warmstart
    ours = solver_lanes.solve_plain(m, qM, a0, efc, warm)
    mj, _ = jax_build_model(str(scenes[4]), max_contacts=K)
    n = lambda t: jnp.asarray(t.numpy())
    efc_j = JaxEfcLanes(
        J=[n(efc.J[v]) for v in range(m.nv)], aref=n(efc.aref), D=n(efc.D), R=n(efc.R),
        pos=n(efc.pos), floss=n(efc.floss), con_mu=n(efc.con_mu),
        con_uscale=n(efc.con_uscale), con_active=n(efc.con_active), con_Dn=n(efc.con_Dn),
        neq=efc.neq, nf=efc.nf, nl=efc.nl)
    qM_j = [[n(qM[i, j]) for j in range(m.nv)] for i in range(m.nv)]
    with jax.disable_jit():
        theirs = jax_solver.solve_lanes(mj, qM_j, n(a0), efc_j, n(warm))
    return m, efc, ours, [np.asarray(t) for t in theirs]


def test_nv36_solve_matches_jax_in_float64(solve36):
    m, efc, (q, f, it), (qj, fj, itj) = solve36
    assert m.nv == 36 and q.dtype == torch.float64 and qj.dtype == np.float64
    assert (efc.con_active.sum(0) >= 16).all(), "a cube is not on the table"
    for ours, theirs in ((q, qj), (f, fj)):
        scale = max(1.0, float(np.abs(theirs).max()))
        assert np.abs(ours.numpy() - theirs).max() <= 1e-10 * scale
    np.testing.assert_array_equal(it.numpy(), np.asarray(itj, it.numpy().dtype))
