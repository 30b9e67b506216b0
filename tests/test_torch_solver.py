"""The port's Newton solve (kernel 2's plain version) against the JAX
package's Pallas kernel `_solve_fused_pallas`, run in interpret mode at
B = 128 (the narrowest batch that takes the fused path).

Inputs: a settled, contact-rich float32 batch (random arm offsets and
controls from seeded numpy, 30 substeps through the port), then one more
substep's constraint rows from the port.  Both solvers get those very rows,
mass matrix, unconstrained acceleration and warmstart.  Contract of
tests/test_solver_pallas.py: qacc per-lane p95 < 1e-4 and max < 5e-2
(relative to rms, floor 1); qfrc p95 < 5e-3; mean niter within 0.5 and
fewer than 25% of lanes with a different niter."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.ops import solver_lanes as jax_solver
from gym_so100_tpu.ops.constraint_lanes import EfcLanes as JaxEfcLanes
from gym_so100_tpu_torch.models.convert import model_from_numpy, state_from_numpy
from gym_so100_tpu_torch.models.scene import Data
from gym_so100_tpu_torch.ops import constraint_lanes, smooth_lanes, solver_lanes
from gym_so100_tpu_torch.ops import forward as fwd
from gym_so100_tpu_torch.ops.collision import narrowphase

B = 128


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


@pytest.fixture(scope="module")
def problem():
    mj, _ = jax_build_model(ASSETS_XML, max_contacts=16)
    mj32 = mj.astype(jnp.float32)
    mt = model_from_numpy(_leaves(mj32))
    rng = np.random.RandomState(3)
    qpos = np.tile(np.asarray(mj32.qpos0), (B, 1))
    qpos[:, :6] += rng.uniform(-0.3, 0.3, (B, 6))
    qpos[:, 6:8] += rng.uniform(-0.05, 0.05, (B, 2))
    f32 = lambda a: np.asarray(a, np.float32)
    s = state_from_numpy(dict(
        qpos=f32(qpos), qvel=np.zeros((B, mt.nv), np.float32),
        ctrl=f32(rng.uniform(-0.5, 0.5, (B, mt.nu))),
        mocap_pos=np.zeros((B, 0, 3), np.float32),
        mocap_quat=np.zeros((B, 0, 4), np.float32),
        qacc_warmstart=np.zeros((B, mt.nv), np.float32),
    ))
    s, _ = fwd.n_steps_batched(mt, s, 30)
    sl = smooth_lanes.forward_smooth_lanes(mt, s)
    d = Data(geom_xpos=sl["geom_xpos"], geom_xmat=sl["geom_xmat"],
                 subtree_com=sl["subtree_com0"][:, None], cdof=sl["cdof"])
    cl = narrowphase.collide_batched_lanes(mt, d)
    efc = constraint_lanes.make_efc_from_lanes(mt, d, s, cl)
    return mj32, mt, sl["qM_lanes"], sl["qacc_smooth"], efc, s.qacc_warmstart


def test_problem_is_contact_rich(problem):
    _, _, _, _, efc, _ = problem
    assert efc.J.shape == (12, 82, B)          # nf 12 + nl 6 + K*CDIM 64
    assert (efc.nf, efc.nl, efc.neq) == (12, 6, 0)
    assert efc.con_active.any(0).float().mean() > 0.2


def test_solve_matches_fused_pallas(problem):
    mj32, mt, qM, a0, efc, warm = problem
    nv = mt.nv
    n = lambda t: jnp.asarray(t.numpy())
    efc_j = JaxEfcLanes(
        J=[n(efc.J[v]) for v in range(nv)], aref=n(efc.aref), D=n(efc.D),
        R=n(efc.R), pos=n(efc.pos), floss=n(efc.floss), con_mu=n(efc.con_mu),
        con_uscale=n(efc.con_uscale), con_active=n(efc.con_active),
        con_Dn=n(efc.con_Dn), neq=efc.neq, nf=efc.nf, nl=efc.nl,
    )
    qM_j = [[n(qM[i, j]) for j in range(nv)] for i in range(nv)]
    assert jax_solver  # the fused path runs for f32 with B % 128 == 0
    qr, fr, nr = jax.jit(lambda q, a, e, w: jax_solver.solve_lanes(mj32, q, a, e, w))(
        qM_j, n(a0), efc_j, n(warm))
    qr, fr, nr = np.asarray(qr), np.asarray(fr), np.asarray(nr, np.float64)

    qf, ff, nf = solver_lanes.solve_lanes(mt, qM, a0, efc, warm)
    qf, ff, nf = qf.numpy(), ff.numpy(), nf.numpy().astype(np.float64)
    assert qf.dtype == np.float32 and qf.shape == (B, nv)

    rms = float(np.sqrt((qr ** 2).mean()))
    err = np.abs(qf - qr).max(axis=1) / max(rms, 1.0)
    assert np.quantile(err, 0.95) < 1e-4, err.max()
    assert err.max() < 5e-2, err.max()
    frms = float(np.sqrt((fr ** 2).mean()))
    ferr = np.abs(ff - fr).max(axis=1) / max(frms, 1.0)
    assert np.quantile(ferr, 0.95) < 5e-3, ferr.max()
    assert abs(nf.mean() - nr.mean()) < 0.5
    assert (nf != nr).mean() < 0.25


def test_packed_kernel_inputs(problem):
    """The kernel's packing: component-major contact rows and the lower
    triangle of qM, as the Pallas kernel took them."""
    _, mt, qM, a0, efc, warm = problem
    inp = solver_lanes.pack_fused_inputs(mt, qM, a0, efc, warm)
    ns, K = 18, 16
    NE = efc.aref.shape[0]
    assert inp["J"].shape == (12 * NE, B)
    k, j = 5, 2
    np.testing.assert_array_equal(inp["aref"][ns + j * K + k].numpy(),
                                  efc.aref[ns + k * 4 + j].numpy())
    np.testing.assert_array_equal(inp["J"][3 * NE + ns + j * K + k].numpy(),
                                  efc.J[3, ns + k * 4 + j].numpy())
    np.testing.assert_array_equal(inp["us"][j * K + k].numpy(),
                                  efc.con_uscale[k, j].numpy())
    np.testing.assert_array_equal(inp["qM"][7 * 8 // 2 + 3].numpy(), qM[7, 3].numpy())
    assert inp["aux"].shape == (2 * 12 + 2 * K + 1, B)
