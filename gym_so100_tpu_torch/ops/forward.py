"""Batched forward dynamics + integration: the mj_step equivalent.

The port of the batched half of `gym_so100_tpu/ops/forward.py`.  One
substep runs smooth dynamics (`smooth_lanes`), collision
(`narrowphase.collide_batched_lanes`, with the hull-sweep kernel),
constraint assembly (`constraint_lanes`), the Newton solve (`solver_lanes`,
with the solver kernel) and semi-implicit Euler.  Ten substeps make one
0.02 s control step.
"""

from __future__ import annotations

import torch

from ..models.scene import Data, Model, State
from . import constraint_lanes, smooth_lanes, solver_lanes
from .collision import narrowphase


def forward_batched(m: Model, s: State) -> Data:
    """Batched forward dynamics; `s` leaves have a leading env axis.
    Returns Data with qacc (post-constraint), qfrc_constraint, solver_niter
    and the selected contacts (`contact`, ContactLanes)."""
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
    cl = narrowphase.collide_batched_lanes(m, d)
    efc = constraint_lanes.make_efc_from_lanes(m, d, s, cl)
    qacc, qfrc, niter = solver_lanes.solve_lanes(
        m, sl["qM_lanes"], d.qacc_smooth, efc, s.qacc_warmstart
    )
    return d.replace(contact=cl, qacc=qacc, qfrc_constraint=qfrc,
                     solver_niter=niter)


def step_batched(m: Model, s: State) -> tuple[State, Data]:
    """One physics substep (forward, then semi-implicit Euler)."""
    d = forward_batched(m, s)
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
