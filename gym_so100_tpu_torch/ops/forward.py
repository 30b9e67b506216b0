"""Forward dynamics + integration: the mj_step equivalent.

The port of `gym_so100_tpu/ops/forward.py`.  One substep runs smooth
dynamics, collision, constraint assembly, the Newton solve and
semi-implicit Euler; ten substeps make one 0.02 s control step.

* The single-env engine (`forward`, `step`, `n_steps`, `position_stage`),
  which the Gymnasium adapter runs: `smooth`, `narrowphase.collide`,
  `constraint.make_efc`, `solver.solve`, on State and Data leaves with no
  env axis.
* The batched engine (`forward_batched`, `step_batched`, `n_steps_batched`):
  `smooth_lanes`, `narrowphase.collide_batched_lanes` (with the hull-sweep
  kernel), `constraint_lanes` and `solver_lanes` (with the solver kernel).

Both name their stages in profiler traces as JAX's `named_scope`s do
(`profiling.annotate`: smooth, collide, efc, solve, integrate).
"""

from __future__ import annotations

import torch

from ..models.scene import Data, Model, State
from ..profiling import annotate
from . import constraint, constraint_lanes, smooth, smooth_lanes, solver, solver_lanes
from .collision import narrowphase


def forward(m: Model, s: State) -> Data:
    """One env's forward dynamics: Data with the contacts, qacc (after the
    constraint solve), qfrc_constraint and solver_niter."""
    with annotate("smooth"):
        d = smooth.forward_smooth(m, s)
    with annotate("collide"):
        con = narrowphase.collide(m, d)
    d = d.replace(contact=con)
    with annotate("efc"):
        efc = constraint.make_efc(m, d, s, con)
    with annotate("solve"):
        qacc, qfrc, _, niter = solver.solve(m, d, efc, s.qacc_warmstart)
    return d.replace(qacc=qacc, qfrc_constraint=qfrc, solver_niter=niter)


def step(m: Model, s: State) -> tuple[State, Data]:
    """One physics substep of one env (forward, then semi-implicit Euler)."""
    d = forward(m, s)
    with annotate("integrate"):
        s2 = smooth.integrate(m, s, d.qacc)
    return s2.replace(qacc_warmstart=d.qacc), d


def n_steps(m: Model, s: State, n: int) -> State:
    """n physics substeps of one env (a 0.02 s control step when n = 10);
    the final State only (`position_stage` refreshes kinematics and
    contacts for it)."""
    for _ in range(n):
        s, _ = step(m, s)
    return s


def position_stage(m: Model, s: State) -> Data:
    """Kinematics and contacts of the current state, no solve (mj_step1):
    what the env layer reads after the substeps."""
    d = smooth.kinematics(m, s)
    return d.replace(contact=narrowphase.collide(m, d))


def forward_batched(m: Model, s: State) -> Data:
    """Batched forward dynamics; `s` leaves have a leading env axis.
    Returns Data with qacc (post-constraint), qfrc_constraint, solver_niter
    and the selected contacts (`contact`, ContactLanes)."""
    with annotate("smooth"):
        sl = smooth_lanes.forward_smooth_lanes(m, s)
    d = Data(
        geom_xpos=sl["geom_xpos"],
        geom_xmat=sl["geom_xmat"],
        site_xpos=sl["site_xpos"],
        site_xmat=sl["site_xmat"],
        # only the root row is consumed downstream
        subtree_com=sl["subtree_com0"][:, None, :],
        cdof=sl["cdof"],
        qM=sl["qM"],
        qacc_smooth=sl["qacc_smooth"],
        qfrc_actuator=sl["qfrc_actuator"],
        qfrc_passive=sl["qfrc_passive"],
        qfrc_bias=sl["qfrc_bias"],
        qfrc_smooth=sl["qfrc_smooth"],
    )
    with annotate("collide"):
        cl = narrowphase.collide_batched_lanes(m, d)
    with annotate("efc"):
        efc = constraint_lanes.make_efc_from_lanes(m, d, s, cl)
    with annotate("solve"):
        qacc, qfrc, niter = solver_lanes.solve_lanes(
            m, sl["qM_lanes"], d.qacc_smooth, efc, s.qacc_warmstart
        )
    return d.replace(contact=cl, qacc=qacc, qfrc_constraint=qfrc,
                     solver_niter=niter)


def step_batched(m: Model, s: State) -> tuple[State, Data]:
    """One physics substep (forward, then semi-implicit Euler)."""
    d = forward_batched(m, s)
    with annotate("integrate"):
        s2 = smooth_lanes.integrate_lanes(m, s, d.qacc)
    return s2.replace(qacc_warmstart=d.qacc), d


def n_steps_batched(m: Model, s: State, n: int):
    """n physics substeps; returns (final State, ncon (B,) int32), ncon the
    largest count of active narrowphase candidates over the substeps (the
    contact-buffer saturation watch)."""
    ncon = torch.zeros(s.qpos.shape[0], dtype=torch.int32, device=s.qpos.device)
    for _ in range(n):
        s, d = step_batched(m, s)
        ncon = torch.maximum(ncon, d.contact.ncand)
    return s, ncon


def make_state(m: Model, qpos=None, qvel=None, ctrl=None, dtype=None) -> State:
    """A single (unbatched) State at qpos0 (or the given values); mocap
    bodies start at their XML body pose."""
    dtype = dtype or m.dtype
    dev = m.device
    mocap_rows = sorted((b for b in range(m.nbody) if m.body_mocapid[b] >= 0),
                        key=lambda b: m.body_mocapid[b])
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return State(
        qpos=as_t(qpos) if qpos is not None else m.qpos0.to(dtype),
        qvel=torch.zeros(m.nv, dtype=dtype, device=dev) if qvel is None else as_t(qvel),
        ctrl=torch.zeros(m.nu, dtype=dtype, device=dev) if ctrl is None else as_t(ctrl),
        mocap_pos=m.body_pos[mocap_rows].to(dtype),
        mocap_quat=m.body_quat[mocap_rows].to(dtype),
        qacc_warmstart=torch.zeros(m.nv, dtype=dtype, device=dev),
    )
