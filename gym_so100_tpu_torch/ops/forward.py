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
  kernel), `constraint_lanes` and `solver_lanes` (with the solver kernel);
  `position_stage_batched`, its kinematics and batch-first contacts.

Both name their stages in profiler traces as JAX's `named_scope`s do
(`profiling.annotate`: smooth, collide, efc, solve, integrate).

On the card, `n_steps_batched` replays one CUDA graph of `step_batched`
per substep (`_SubstepGraph`): the host launches the ~19,000 small kernels
of a substep once, at capture, instead of every substep.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import profiling
from ..models.scene import Data, Model, State, static_tables
from ..profiling import annotate
from . import constraint, constraint_lanes, smooth, smooth_lanes, solver, solver_lanes
from .collision import hull_lanes, narrowphase


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


def position_stage_batched(m: Model, s: State) -> Data:
    """`position_stage` for a batched State (leaves (B, ...)): batched
    kinematics, then the batch-first contacts of `collide_batched` (in
    float32 one hull-sweep kernel launch on the card)."""
    d = smooth_lanes.kinematics(m, s)
    return d.replace(contact=narrowphase.collide_batched(m, d))


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
    contact-buffer saturation watch).

    CUDA states run the substeps as replays of one CUDA graph of
    `step_batched` (`_SubstepGraph`), kept for each model, batch width,
    device and dtype and captured at the first call; CPU states run them
    one by one.  The replays launch the same kernels on the same inputs
    as the substeps run one by one, so the two give the same bits.  The
    State returned owns its memory.  While a profiler records, each
    substep counts `substep.graphed` or `substep.eager`."""
    if s.qpos.device.type != "cuda" or n < 1:
        return _eager_steps(m, s, n)
    with torch.cuda.device(s.qpos.device):
        return _graphed_steps(m, s, n)


def _graphed_steps(m: Model, s: State, n: int):
    """`n_steps_batched` as replays of the `_SubstepGraph` of `s`'s model,
    width, device and dtype (n >= 1)."""
    B, dev, dtype = s.qpos.shape[0], s.qpos.device, s.qpos.dtype
    g = static_tables(m, f"substep_graph.{B}.{dev}.{dtype}", lambda m: _SubstepGraph())
    if g.replay is None:
        # the warm-up substep builds the static tables and the kernel library
        # before anything is captured; its result is the first substep's
        g.capture(m, *_eager_steps(m, s, 1))
        n -= 1
    else:
        g.load(s)
    for _ in range(n):
        g.step(m, dtype)
    return State(**{f: getattr(g.state, f).clone() for f in _FIELDS}), g.ncon.clone()


def _eager_steps(m: Model, s: State, n: int):
    """`n_steps_batched` with the substeps launched one by one."""
    ncon = torch.zeros(s.qpos.shape[0], dtype=torch.int32, device=s.qpos.device)
    for _ in range(n):
        s, d = step_batched(m, s)
        ncon = torch.maximum(ncon, d.contact.ncand)
        profiling.count("substep.eager", 1)
    return s, ncon


_FIELDS = tuple(f.name for f in dataclasses.fields(State))
# the kernel wrappers whose Python launch counters a replay advances by the
# launches its graph holds
_COUNTED = ((hull_lanes, "sweep_h"), (solver_lanes, "solve_fused"))


class _SubstepGraph:
    """One substep of `step_batched` as a CUDA graph: it reads the State
    from the static buffers `state` and writes the next one back into them,
    raising the running maximum `ncon` and leaving the solve's `niter` in a
    buffer of its own, all in a memory pool of its own."""

    def __init__(self):
        self.replay = None

    def capture(self, m: Model, s: State, ncon):
        """Capture the substep that follows State `s` (with `ncon` so far)."""
        self.state = State(**{f: torch.empty_like(getattr(s, f)) for f in _FIELDS})
        self.ncon = torch.empty_like(ncon)
        self.load(s, ncon)
        before = [getattr(mod, name).launches for mod, name in _COUNTED]
        self.replay, self.niter = _capture(lambda: self._substep(m))
        self.launches = []
        for (mod, name), k in zip(_COUNTED, before):
            fn = getattr(mod, name)
            self.launches.append(fn.launches - k)
            fn.launches = k      # captured, not run: the replays count them

    def _substep(self, m: Model):
        s2, d = step_batched(m, self.state)
        torch.maximum(self.ncon, d.contact.ncand, out=self.ncon)
        for f in _FIELDS:
            new, static = getattr(s2, f), getattr(self.state, f)
            if new is not static:
                static.copy_(new)
        return d.solver_niter

    def load(self, s: State, ncon=None):
        """Copy State `s` into the static buffers; `ncon` so far, or zero."""
        for f in _FIELDS:
            getattr(self.state, f).copy_(getattr(s, f))
        if ncon is None:
            self.ncon.zero_()
        else:
            self.ncon.copy_(ncon)

    def step(self, m: Model, dtype):
        """One substep: a replay, and its counts."""
        self.replay()
        for (mod, name), k in zip(_COUNTED, self.launches):
            getattr(mod, name).launches += k
        profiling.count("substep.graphed", 1)
        solver_lanes.count_solves(m, self.niter, dtype)


def _capture(fn):
    """Capture `fn()`'s launches on the current stream's device as a CUDA
    graph with a memory pool of its own; returns (the graph's replay,
    `fn()`'s result, whose buffers each replay rewrites)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    return graph.replay, out


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
