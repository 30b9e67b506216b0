"""The single-env engine's dynamics against the JAX package's, on the CPU.

Float64, the parity model (ccd manifolds, K = 32), on two contact states:
"rest" (the cube flat on the table, 0.5 mm in: a 4-point manifold; the
arm at its start pose with small seeded joint velocities) and "grip" (the
cube between the half-open finger pads: 13 contacts, with seeded joint
velocities, controls and warm start).  Same inputs on both sides (the
Model and State through the bridge; for the stages after collision, JAX's
own contacts and rows bridged), to 1e-10 absolute and relative:

* `smooth.forward_smooth` (kinematics, com, CRBA and its Cholesky factor,
  RNE, actuation, passive, qacc_smooth) and `smooth.integrate` (grip);
* `constraint.make_efc` on JAX's contacts: every row array and the cone
  data (grip);
* `solver.solve` on JAX's rows: qacc, qfrc_constraint, the row forces, and
  the iteration count equal (rest);
* `forward.step`, one whole substep: the next State, qacc, the contacts
  and niter; and `forward.position_stage` (rest; grip with the bound
  below on qacc).

The grip state's solve is ill-conditioned: JAX's own solve, its rows'
aref perturbed by one ulp in a seeded half of the rows, parts from itself
by up to 4e-11 x max(rms(qacc), 1), which is 4e-9 on this state's qacc.
There the port's solve is held to the floor rule of `chip_smoke.py`:
max |dqacc| / max(rms, 1) at most twice the larger one-ulp spread of the
two solvers (4 perturbations each), and at most 1e-10 where that is
larger; niter equal.

Float32 (K = 32, single-point hull contacts): the same solve on the same
rows within the JAX contract of `tests/test_solver_pallas.py` (ROADMAP
C4; on a lone env its p95 bounds, max |dqacc| / max(rms, 1) < 1e-4 and
max |dqfrc| / max(rms, 1) < 5e-3), or the floor rule (as above, for each
of the two statistics) where that is larger.  Two
control steps of `SO100Env(dtype=float32)` against JAX's with
`dtype=jnp.float32`: obs and qpos to 1e-5, qvel to 2e-4 (20 substeps x h x
the contract's 1e-4 on |qacc| <= 50), the reward to 1e-5, terminated
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_so100_tpu.envs.gym_env import ASSETS_XML
from gym_so100_tpu.envs.gym_env import SO100Env as JaxEnv
from gym_so100_tpu.models.builder import build_model as jax_build_model
from gym_so100_tpu.ops import constraint as jax_constraint
from gym_so100_tpu.ops import forward as jax_fwd
from gym_so100_tpu.ops import smooth as jax_smooth
from gym_so100_tpu.ops import solver as jax_solver
from gym_so100_tpu.ops.collision import narrowphase as jax_np
from gym_so100_tpu_torch.envs.gym_env import SO100Env
from gym_so100_tpu_torch.models.convert import model_from_numpy, state_from_numpy
from gym_so100_tpu_torch.models.scene import Contact, Data
from gym_so100_tpu_torch.ops import constraint, smooth, solver
from gym_so100_tpu_torch.ops import forward as fwd

K = 32
TOL = 1e-10


def _leaves(obj):
    return {f.name: (np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v)
            for f in dataclasses.fields(obj) for v in [getattr(obj, f.name)]}


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=name)


def _state(mj, dt, name):
    """The contact state `name` ("rest" or "grip")."""
    rng = np.random.RandomState(7)
    q = np.asarray(mj.qpos0, np.float64).copy()
    q[:6] = [0.0, -0.96, 1.16, 0.0, 0.0, 0.3 if name == "grip" else 0.02239]
    if name == "rest":
        q[6:13] = [-0.2, 0.45, 0.0195, 1.0, 0.0, 0.0, 0.0]
        qvel = np.zeros(mj.nv)
        qvel[:6] = rng.normal(size=6) * 0.02
        return jax_fwd.make_state(mj, qpos=jnp.asarray(q, dt), qvel=jnp.asarray(qvel, dt),
                                  ctrl=jnp.asarray(q[:6], dt), dtype=dt)
    s = jax_fwd.make_state(mj, qpos=jnp.asarray(q))
    d = jax_smooth.kinematics(mj, s)
    pads = [[mj.geom_id(f"{side}_jaw_pad_{i}") for i in range(1, 5)]
            for side in ("fixed", "moving")]
    xpos = np.asarray(d.geom_xpos, np.float64)
    q[6:9] = 0.5 * (xpos[pads[0]].mean(0) + xpos[pads[1]].mean(0))
    qvel = rng.normal(size=mj.nv) * 0.2
    return s.replace(qpos=jnp.asarray(q, dt), qvel=jnp.asarray(qvel, dt),
                     ctrl=jnp.asarray(q[:6] + rng.uniform(-0.2, 0.2, 6), dt),
                     qacc_warmstart=jnp.asarray(rng.normal(size=mj.nv), dt))


_PROBLEMS = {}


def _problem(dt, name):
    """JAX's forward pass on the contact state, stage by stage, and the
    port's Model and State (built once per dtype and state)."""
    if (dt, name) in _PROBLEMS:
        return _PROBLEMS[dt, name]
    if dt not in _PROBLEMS:
        mj, _ = jax_build_model(ASSETS_XML, max_contacts=K, ccd_manifolds=dt == jnp.float64)
        mj = mj.astype(dt)

        @jax.jit
        def stages(s):
            d = jax_smooth.forward_smooth(mj, s)
            con = jax_np.collide(mj, d)
            efc = jax_constraint.make_efc(mj, d, s, con)
            return d, con, efc, jax_solver.solve(mj, d, efc, s.qacc_warmstart)

        solve = jax.jit(lambda d, efc, w: jax_solver.solve(mj, d, efc, w))
        _PROBLEMS[dt] = dict(mj=mj, mt=model_from_numpy(_leaves(mj)), stages=stages,
                             solve=solve)
    base = _PROBLEMS[dt]
    sj = _state(base["mj"], dt, name)
    _PROBLEMS[dt, name] = dict(base, dt=dt, sj=sj, st=state_from_numpy(_leaves(sj)),
                               out=base["stages"](sj))
    return _PROBLEMS[dt, name]


@pytest.fixture(scope="module")
def problem():
    return _problem(jnp.float64, "grip")


def _rms(a):
    a = np.asarray(a, np.float64)
    return max(float(np.sqrt(np.mean(a * a))), 1.0)


def _floor(p, n=4):
    """Twice the larger one-ulp spread of the two solvers on p's rows, for
    qacc and for qfrc: max |d| / max(rms, 1) with aref moved up one ulp in
    a seeded half of the rows."""
    if "floor" in p:
        return p["floor"]
    dj, _, ej, (qacc, qfrc, *_) = p["out"]
    d, e = _port_data(dj), _port_efc(ej)
    warm = p["st"].qacc_warmstart
    q0, f0 = solver.solve(p["mt"], d, e, warm)[:2]
    rng = np.random.RandomState(0)
    worst = [0.0, 0.0]
    for _ in range(n):
        up = torch.nextafter(e.aref, torch.full_like(e.aref, np.inf))
        aref = torch.where(torch.from_numpy(rng.rand(e.aref.shape[0]) < 0.5), up, e.aref)
        q1, f1 = solver.solve(p["mt"], d, e.replace(aref=aref), warm)[:2]
        qj1, fj1 = p["solve"](dj, dataclasses.replace(ej, aref=jnp.asarray(aref.numpy())),
                              p["sj"].qacc_warmstart)[:2]
        for i, (a0, a1, b0, b1) in enumerate(((q0, q1, qacc, qj1), (f0, f1, qfrc, fj1))):
            worst[i] = max(worst[i], float((a1 - a0).abs().max()) / _rms(a0),
                           float(np.abs(np.asarray(b1) - np.asarray(b0)).max()) / _rms(b0))
    p["floor"] = (2 * worst[0], 2 * worst[1])
    return p["floor"]


def _port_data(dj):
    return Data(**{k: t(getattr(dj, k)) for k in (
        "xpos", "xquat", "xipos", "ximat", "site_xpos", "site_xmat", "geom_xpos",
        "geom_xmat", "subtree_com", "cdof", "qM", "qLD", "qfrc_bias", "qfrc_passive",
        "qfrc_actuator", "qfrc_smooth", "qacc_smooth")})


def _port_contact(cj):
    return Contact(**{f.name: t(getattr(cj, f.name)) for f in dataclasses.fields(Contact)
                      if getattr(cj, f.name) is not None})


def _port_efc(ej):
    return constraint.Efc(**{f.name: (t(v) if hasattr(v, "shape") else v)
                             for f in dataclasses.fields(constraint.Efc)
                             for v in [getattr(ej, f.name)]})


def test_forward_smooth_matches_jax(problem):
    dj = problem["out"][0]
    dt_ = smooth.forward_smooth(problem["mt"], problem["st"])
    for k in ("xpos", "xquat", "xipos", "ximat", "site_xpos", "site_xmat", "geom_xpos",
              "geom_xmat", "subtree_com", "cdof", "qM", "qLD", "qfrc_bias", "qfrc_passive",
              "qfrc_actuator", "qfrc_smooth", "qacc_smooth"):
        close(getattr(dt_, k).numpy(), getattr(dj, k), TOL, k)
    qacc = dj.qacc_smooth
    s_j = jax_smooth.integrate(problem["mj"], problem["sj"], qacc)
    s_t = smooth.integrate(problem["mt"], problem["st"], t(qacc))
    close(s_t.qpos.numpy(), s_j.qpos, TOL, "integrate qpos")
    close(s_t.qvel.numpy(), s_j.qvel, TOL, "integrate qvel")


def test_make_efc_matches_jax(problem):
    dj, cj, ej, _ = problem["out"]
    assert int(np.asarray(cj.active).sum()) > 4
    et = constraint.make_efc(problem["mt"], _port_data(dj), problem["st"], _port_contact(cj))
    assert (et.neq, et.nf, et.nl) == (ej.neq, ej.nf, ej.nl)
    for f in dataclasses.fields(constraint.Efc):
        v = getattr(ej, f.name)
        if hasattr(v, "shape"):
            ours = getattr(et, f.name).numpy()
            if ours.dtype == bool:
                np.testing.assert_array_equal(ours, np.asarray(v), f.name)
            else:
                close(ours, v, TOL, f.name)


@pytest.mark.parametrize("name", ["rest", "grip"])
@pytest.mark.parametrize("dt", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_solve_matches_jax(dt, name):
    p = _problem(dt, name)
    dj, cj, ej, (qacc, qfrc, force, niter) = p["out"]
    assert int(np.asarray(cj.active).sum()) >= 4
    q, f, fo, n = solver.solve(p["mt"], _port_data(dj), _port_efc(ej), p["st"].qacc_warmstart)
    dev = float(np.abs(q.numpy() - np.asarray(qacc, np.float64)).max()) / _rms(qacc)
    if dt == jnp.float64 and name == "rest":
        close(q.numpy(), qacc, TOL, "qacc")
        close(f.numpy(), qfrc, TOL, "qfrc")
        close(fo.numpy(), force, TOL, "force")
    elif dt == jnp.float64:
        assert dev <= max(TOL, _floor(p)[0]), dev
    else:
        fdev = float(np.abs(f.numpy() - np.asarray(qfrc, np.float64)).max()) / _rms(qfrc)
        assert dev <= max(1e-4, _floor(p)[0]), dev
        assert fdev <= max(5e-3, _floor(p)[1]), fdev
    if dt == jnp.float64:
        assert int(n) == int(niter) > 1


@pytest.mark.parametrize("name", ["rest", "grip"])
def test_step_matches_jax(name):
    p = _problem(jnp.float64, name)
    mj, mt = p["mj"], p["mt"]
    s_j, d_j = jax.jit(lambda s: jax_fwd.step(mj, s))(p["sj"])
    s_t, d_t = fwd.step(mt, p["st"])
    for k in ("qpos", "qvel"):
        close(getattr(s_t, k).numpy(), getattr(s_j, k), TOL, k)
    if name == "rest":
        close(s_t.qacc_warmstart.numpy(), s_j.qacc_warmstart, TOL, "qacc_warmstart")
        close(d_t.qacc.numpy(), d_j.qacc, TOL, "qacc")
        close(d_t.qfrc_constraint.numpy(), d_j.qfrc_constraint, TOL, "qfrc_constraint")
    else:
        dev = float(np.abs(d_t.qacc.numpy() - np.asarray(d_j.qacc)).max()) / _rms(d_j.qacc)
        assert dev <= max(TOL, _floor(p)[0]), dev
    assert int(d_t.solver_niter) == int(d_j.solver_niter)
    np.testing.assert_array_equal(d_t.contact.active.numpy(), np.asarray(d_j.contact.active))
    close(d_t.contact.dist.numpy(), d_j.contact.dist, TOL, "dist")
    p_j = jax.jit(lambda s: jax_fwd.position_stage(mj, s))(s_j)
    p_t = fwd.position_stage(mt, s_t)
    close(p_t.site_xpos.numpy(), p_j.site_xpos, TOL, "position stage site_xpos")
    np.testing.assert_array_equal(p_t.contact.active.numpy(), np.asarray(p_j.contact.active))
    close(p_t.contact.pos.numpy(), p_j.contact.pos, TOL, "position stage contacts")


def test_float32_env_matches_jax():
    kw = dict(task="so100_touch_cube", obs_type="so100_state")
    ej = JaxEnv(dtype=jnp.float32, **kw)
    et = SO100Env(device="cpu", **kw)
    assert et._m.dtype == torch.float32 and et._m.max_contacts == K and not et._m.pairs.ccd
    (oj, _), (ot, _) = ej.reset(seed=1), et.reset(seed=1)
    close(ot, oj, 1e-6, "reset obs")
    rng = np.random.RandomState(5)
    for i in range(2):
        a = rng.uniform(-1, 1, 6).astype(np.float32)
        (oj, rj, tj, _, _), (ot, rt, tt, _, _) = ej.step(a), et.step(a)
        close(ot, oj, 1e-5, f"step {i}: obs")
        close(rt, rj, 1e-5, f"step {i}: reward")
        assert tt == tj
        close(et._es.physics.qpos.numpy(), ej._es.physics.qpos, 1e-5, f"step {i}: qpos")
        close(et._es.physics.qvel.numpy(), ej._es.physics.qvel, 2e-4, f"step {i}: qvel")
