"""One physics substep of the batched engine and the n-substep control
step, with no stage annotations (a frozen copy of the port's batched
`forward_batched`, `step_batched`, `n_steps_batched` and `make_state`).

A substep runs smooth dynamics (`smooth_lanes`), collision
(`narrowphase.collide_batched_lanes`), constraint assembly
(`constraint_lanes`), the Newton solve (`solver_lanes`, plain) and
semi-implicit Euler.
"""

from __future__ import annotations

import torch

from ..models.scene import Data, Model, State
from . import constraint_lanes, smooth_lanes, solver_lanes
from .collision import narrowphase


def forward_batched(m: Model, s: State) -> Data:
    """Batched forward dynamics; `s` leaves have a leading env axis."""
    sl = smooth_lanes.forward_smooth_lanes(m, s)
    d = Data(
        geom_xpos=sl["geom_xpos"],
        geom_xmat=sl["geom_xmat"],
        site_xpos=sl["site_xpos"],
        site_xmat=sl["site_xmat"],
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
        m, sl["qM_lanes"], d.qacc_smooth, efc, s.qacc_warmstart)
    return d.replace(contact=cl, qacc=qacc, qfrc_constraint=qfrc,
                     solver_niter=niter)


def step_batched(m: Model, s: State) -> tuple[State, Data]:
    """One physics substep (forward, then semi-implicit Euler)."""
    d = forward_batched(m, s)
    s2 = smooth_lanes.integrate_lanes(m, s, d.qacc)
    return s2.replace(qacc_warmstart=d.qacc), d


def n_steps_batched(m: Model, s: State, n: int):
    """n physics substeps; returns (final State, ncon (B,) int32), ncon the
    largest count of active narrowphase candidates over the substeps."""
    ncon = torch.zeros(s.qpos.shape[0], dtype=torch.int32, device=s.qpos.device)
    for _ in range(n):
        s, d = step_batched(m, s)
        ncon = torch.maximum(ncon, d.contact.ncand)
    return s, ncon


def make_state(m: Model, dtype=None) -> State:
    """A single (unbatched) State at qpos0; mocap bodies start at their XML
    body pose."""
    dtype = dtype or m.dtype
    dev = m.device
    mocap_rows = sorted((b for b in range(m.nbody) if m.body_mocapid[b] >= 0),
                        key=lambda b: m.body_mocapid[b])
    return State(
        qpos=m.qpos0.to(dtype),
        qvel=torch.zeros(m.nv, dtype=dtype, device=dev),
        ctrl=torch.zeros(m.nu, dtype=dtype, device=dev),
        mocap_pos=m.body_pos[mocap_rows].to(dtype),
        mocap_quat=m.body_quat[mocap_rows].to(dtype),
        qacc_warmstart=torch.zeros(m.nv, dtype=dtype, device=dev),
    )
