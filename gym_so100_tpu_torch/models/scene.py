"""Static scene model and dynamic state containers for the PyTorch physics core.

`Model` is the product of the MJCF builder (`builder.build_model`): every
numeric leaf is a `torch.Tensor`, every structural quantity (tree topology,
joint addressing, the collision pair table) is a plain Python int or tuple,
so the physics code unrolls its loops over bodies, joints and pairs in
Python and only the numerics run as tensor ops.  Field names, shapes and
meanings follow `gym_so100_tpu/models/scene.py` one for one, so a reader can
match every leaf with its JAX counterpart (and `convert.model_from_numpy`
can bridge one into the other).

`State` is the dynamic state carried across steps, `Data` the per-step
derived quantities, `Contact` the selected contact buffer batch-first
(fields (K, ...), or (B, K, ...) batched) and `ContactLanes` the one of the
batched path in batch-last form (fields (K, B)).  Each has `.to(device,
dtype)`, which moves every tensor and casts the floating ones.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

# Geom type codes (subset of MJCF geom types we support).
GEOM_PLANE = 0
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_CYLINDER = 5
GEOM_BOX = 6
GEOM_MESH = 7

# Joint type codes.
JNT_FREE = 0
JNT_BALL = 1
JNT_SLIDE = 2
JNT_HINGE = 3


def _to(x, device, dtype):
    """Move a tensor (cast it when floating); nested tuples/lists recurse;
    anything else is returned as it is."""
    if isinstance(x, torch.Tensor):
        if dtype is not None and x.is_floating_point():
            return x.to(device=device, dtype=dtype)
        return x.to(device=device)
    if isinstance(x, (tuple, list)) and any(
        isinstance(v, (torch.Tensor, tuple, list)) for v in x
    ):
        return type(x)(_to(v, device, dtype) for v in x)
    return x


class _TensorFields:
    """`.to(device, dtype)` and `.replace(**kw)` for frozen dataclasses."""

    def to(self, device=None, dtype=None):
        return dataclasses.replace(self, **{
            f.name: _to(getattr(self, f.name), device, dtype)
            for f in dataclasses.fields(self)
        })

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def index(self, idx):
        """Every tensor field indexed by `idx` (e.g. a slice of envs, or
        None to add a leading batch axis); other fields as they are."""
        return dataclasses.replace(self, **{
            f.name: v[idx] for f in dataclasses.fields(self)
            if isinstance(v := getattr(self, f.name), torch.Tensor)
        })


@dataclass(frozen=True)
class CollisionPairs:
    """Static collision pair table, grouped by collider kind (see the JAX
    package's `CollisionPairs`): tuples of (geom1, geom2) index pairs;
    per-pair mixed contact parameters live in the Model's aligned arrays,
    indexed by the flat pair id (box_box ++ hull_box ++ hull_hull)."""

    box_box: tuple = ()
    hull_box: tuple = ()     # convex mesh vs box (mesh first)
    hull_hull: tuple = ()
    # strict-parity manifold pairs (geom1, geom2, flat_pair_id, slot1,
    # slot2); filled only by build_model(ccd_manifolds=True)
    ccd: tuple = ()


@dataclass(frozen=True)
class Model(_TensorFields):
    # --- sizes and topology (static) ---
    nq: int = 0
    nv: int = 0
    nu: int = 0
    nbody: int = 0
    ngeom: int = 0
    nsite: int = 0
    ncam: int = 0
    nmocap: int = 0
    body_parentid: tuple = ()
    body_jntadr: tuple = ()
    body_jntnum: tuple = ()
    body_weldid: tuple = ()
    body_mocapid: tuple = ()
    jnt_type: tuple = ()
    jnt_bodyid: tuple = ()
    jnt_qposadr: tuple = ()
    jnt_dofadr: tuple = ()
    jnt_limited: tuple = ()
    dof_bodyid: tuple = ()
    dof_jntid: tuple = ()
    geom_type: tuple = ()
    geom_bodyid: tuple = ()
    geom_condim: tuple = ()
    geom_meshid: tuple = ()
    geom_vertadr: tuple = ()
    geom_vertnum: tuple = ()
    site_bodyid: tuple = ()
    cam_bodyid: tuple = ()
    cam_mode: tuple = ()
    cam_targetbodyid: tuple = ()
    actuator_dofid: tuple = ()
    names_body: tuple = ()
    names_joint: tuple = ()
    names_geom: tuple = ()
    names_site: tuple = ()
    names_cam: tuple = ()
    names_actuator: tuple = ()
    timestep: float = 0.002
    impratio: float = 1.0
    cone: str = "pyramidal"
    solver_iterations: int = 100
    solver_tolerance: float = 1e-8
    ls_iterations: int = 50
    pairs: CollisionPairs = field(default_factory=CollisionPairs)
    max_contacts: int = 32
    stat_meaninertia: float = 1.0
    fl_dofs: tuple = ()
    hull_start: tuple = ()
    eq_site1: tuple = ()
    eq_site2: tuple = ()
    eq_jnt_q1: tuple = ()
    eq_jnt_q2: tuple = ()
    eq_jnt_v1: tuple = ()
    eq_jnt_v2: tuple = ()
    pair_condim: tuple = ()
    exact_nvert: tuple = ()

    # --- numeric tensors ---
    gravity: Optional[torch.Tensor] = None
    body_pos: Optional[torch.Tensor] = None        # (NB, 3)
    body_quat: Optional[torch.Tensor] = None       # (NB, 4)
    body_ipos: Optional[torch.Tensor] = None       # (NB, 3)
    body_iquat: Optional[torch.Tensor] = None      # (NB, 4)
    body_mass: Optional[torch.Tensor] = None       # (NB,)
    body_inertia: Optional[torch.Tensor] = None    # (NB, 3)
    body_invweight0: Optional[torch.Tensor] = None  # (NB, 2)
    jnt_axis: Optional[torch.Tensor] = None        # (NJ, 3)
    jnt_pos: Optional[torch.Tensor] = None         # (NJ, 3)
    jnt_range: Optional[torch.Tensor] = None       # (NJ, 2)
    jnt_solref: Optional[torch.Tensor] = None      # (NJ, 2)
    jnt_solimp: Optional[torch.Tensor] = None      # (NJ, 5)
    dof_armature: Optional[torch.Tensor] = None    # (NV,)
    dof_damping: Optional[torch.Tensor] = None     # (NV,)
    dof_frictionloss: Optional[torch.Tensor] = None  # (NV,)
    dof_invweight0: Optional[torch.Tensor] = None  # (NV,)
    dof_solref: Optional[torch.Tensor] = None      # (NV, 2)
    dof_solimp: Optional[torch.Tensor] = None      # (NV, 5)
    geom_pos: Optional[torch.Tensor] = None        # (NG, 3)
    geom_quat: Optional[torch.Tensor] = None       # (NG, 4)
    geom_size: Optional[torch.Tensor] = None       # (NG, 3)
    geom_friction: Optional[torch.Tensor] = None   # (NG, 3)
    geom_solref: Optional[torch.Tensor] = None     # (NG, 2)
    geom_solimp: Optional[torch.Tensor] = None     # (NG, 5)
    geom_rgba: Optional[torch.Tensor] = None       # (NG, 4)
    mesh_verts: Optional[torch.Tensor] = None      # (sum V, 3)
    site_pos: Optional[torch.Tensor] = None        # (NS, 3)
    site_quat: Optional[torch.Tensor] = None       # (NS, 4)
    cam_pos: Optional[torch.Tensor] = None         # (NC, 3)
    cam_quat: Optional[torch.Tensor] = None        # (NC, 4)
    cam_fovy: Optional[torch.Tensor] = None        # (NC,)
    actuator_kp: Optional[torch.Tensor] = None     # (NU,)
    actuator_kv: Optional[torch.Tensor] = None     # (NU,)
    actuator_bias0: Optional[torch.Tensor] = None  # (NU,)
    actuator_bias1: Optional[torch.Tensor] = None  # (NU,)
    actuator_forcerange: Optional[torch.Tensor] = None  # (NU, 2)
    actuator_ctrlrange: Optional[torch.Tensor] = None   # (NU, 2)
    qpos0: Optional[torch.Tensor] = None           # (NQ,)
    pair_friction: Optional[torch.Tensor] = None   # (NP, 3)
    pair_solref: Optional[torch.Tensor] = None     # (NP, 2)
    pair_solimp: Optional[torch.Tensor] = None     # (NP, 5)
    pair_margin: Optional[torch.Tensor] = None     # (NP,)
    hull_vertsT: Optional[torch.Tensor] = None     # (3, nblocks*HULL_BLOCK)
    hull_lcen: Optional[torch.Tensor] = None       # (nblocks, 3)
    hull_lhalf: Optional[torch.Tensor] = None      # (nblocks, 3)
    exact_verts: Optional[torch.Tensor] = None     # (GX, VX, 3)
    exact_polyn: Optional[torch.Tensor] = None     # (GX, PX, 3)
    exact_polyvid: Optional[torch.Tensor] = None   # (GX, PX, PVX) int32
    exact_polynv: Optional[torch.Tensor] = None    # (GX, PX) int32
    eq_solref: Optional[torch.Tensor] = None       # (NEQ, 2)
    eq_solimp: Optional[torch.Tensor] = None       # (NEQ, 5)
    eq_jnt_poly: Optional[torch.Tensor] = None     # (NJEQ, 5)
    eq_jnt_solref: Optional[torch.Tensor] = None   # (NJEQ, 2)
    eq_jnt_solimp: Optional[torch.Tensor] = None   # (NJEQ, 5)

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.qpos0.dtype

    def body_id(self, name: str) -> int:
        return self.names_body.index(name)

    def geom_id(self, name: str) -> int:
        return self.names_geom.index(name)

    def site_id(self, name: str) -> int:
        return self.names_site.index(name)

    def joint_id(self, name: str) -> int:
        return self.names_joint.index(name)


@dataclass(frozen=True)
class State(_TensorFields):
    """Dynamic state; batched leaves carry a leading env axis (B, ...)."""

    qpos: torch.Tensor                 # (NQ,)
    qvel: torch.Tensor                 # (NV,)
    ctrl: torch.Tensor                 # (NU,)
    mocap_pos: Optional[torch.Tensor] = None    # (NMOCAP, 3)
    mocap_quat: Optional[torch.Tensor] = None   # (NMOCAP, 4)
    qacc_warmstart: Optional[torch.Tensor] = None  # (NV,)


@dataclass(frozen=True)
class Contact(_TensorFields):
    """Fixed-size selected contact buffer (K = model.max_contacts), batch-
    first: fields (K, ...) for one env, (B, K, ...) for a batch."""

    dist: torch.Tensor        # (K,) signed distance (negative = penetrating)
    pos: torch.Tensor         # (K, 3) world midpoint
    frame: torch.Tensor       # (K, 3, 3) rows: normal, tangent1, tangent2
    friction: torch.Tensor    # (K, 3) slide, torsion, roll
    solref: torch.Tensor      # (K, 2)
    solimp: torch.Tensor      # (K, 5)
    geom1: torch.Tensor       # (K,) int
    geom2: torch.Tensor       # (K,) int
    condim: torch.Tensor      # (K,) int
    active: torch.Tensor      # (K,) bool
    # per-contact statics of the batched narrowphase; None on the single-env
    # path, where constraint.make_efc derives them from geom1/geom2
    dof_dmask: Optional[torch.Tensor] = None   # (K, nv) Jacobian sign mask
    invw_diag: Optional[torch.Tensor] = None   # (K,) body_invweight0 sum
    # active narrowphase candidates before the deepest-K cull
    ncand: Optional[torch.Tensor] = None       # () int32, or (B,)


@dataclass(frozen=True)
class ContactLanes(_TensorFields):
    """Selected contact buffer in batch-last form (fields (K, B)).

    Spatial components are tuples (x, y, z); `frame` is rows-major nested
    tuples fr[row][comp].  Produced by narrowphase.collide_batched_lanes,
    consumed by constraint_lanes.make_efc_from_lanes."""

    dist: torch.Tensor        # (K, B)
    pos: tuple                # 3 x (K, B) world midpoint
    frame: tuple              # 3 x 3 x (K, B) rows: normal, t1, t2
    friction0: torch.Tensor   # (K, B) slide
    friction1: torch.Tensor   # (K, B) torsion
    solref0: torch.Tensor
    solref1: torch.Tensor
    solimp: tuple             # 5 x (K, B)
    geom1: torch.Tensor       # (K, B) int
    geom2: torch.Tensor
    condim: torch.Tensor
    active: torch.Tensor      # (K, B) bool
    dof_dmask: tuple          # nv x (K, B) per-dof Jacobian sign mask
    invw_diag: torch.Tensor   # (K, B)
    ncand: torch.Tensor       # (B,) active candidates before the cull


@dataclass(frozen=True)
class Data(_TensorFields):
    """Per-step derived quantities: no env axis on the single-env path,
    a leading one (B, ...) on the batched path."""

    xpos: Optional[torch.Tensor] = None         # (B, NB, 3)
    xquat: Optional[torch.Tensor] = None        # (B, NB, 4)
    xipos: Optional[torch.Tensor] = None        # (B, NB, 3)
    ximat: Optional[torch.Tensor] = None        # (B, NB, 3, 3)
    site_xpos: Optional[torch.Tensor] = None    # (B, NS, 3)
    site_xmat: Optional[torch.Tensor] = None    # (B, NS, 3, 3)
    geom_xpos: Optional[torch.Tensor] = None    # (B, NG, 3)
    geom_xmat: Optional[torch.Tensor] = None    # (B, NG, 3, 3)
    subtree_com: Optional[torch.Tensor] = None  # (NB, 3); batched (B, 1, 3) root row
    cdof: Optional[torch.Tensor] = None         # (B, NV, 6)
    qM: Optional[torch.Tensor] = None           # (B, NV, NV)
    qLD: Optional[torch.Tensor] = None          # (NV, NV) Cholesky factor of qM
    qfrc_bias: Optional[torch.Tensor] = None
    qfrc_passive: Optional[torch.Tensor] = None
    qfrc_actuator: Optional[torch.Tensor] = None
    qfrc_smooth: Optional[torch.Tensor] = None
    qacc_smooth: Optional[torch.Tensor] = None
    qacc: Optional[torch.Tensor] = None
    qfrc_constraint: Optional[torch.Tensor] = None
    contact: Optional[Contact | ContactLanes] = None
    solver_niter: Optional[torch.Tensor] = None  # (B,)
    ncon: Optional[torch.Tensor] = None          # (B,)


_STATIC = {}


def static_tables(m: Model, name: str, build):
    """`build(m)` computed once per Model object and kept beside it.

    The collision and constraint stages derive constant tables (index
    arrays, packed vertices) from the Model's static structure; building
    them once keeps host work and host-to-device copies off every substep.
    Entries are keyed by object identity and dropped with the Model."""
    import weakref

    key = (id(m), name)
    hit = _STATIC.get(key)
    if hit is not None and hit[0]() is m:
        return hit[1]
    value = build(m)
    _STATIC[key] = (weakref.ref(m, lambda _: _STATIC.pop(key, None)), value)
    return value
