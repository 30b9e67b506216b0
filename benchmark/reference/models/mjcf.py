"""Minimal MJCF reader.

Parses the subset of MJCF used by the SO-ARM100 scenes
(gym_so100_tpu/assets/so100_transfer_cube.xml and its includes) into a
plain-Python intermediate representation.  `builder.py` compiles that IR into
the static array Model consumed by the PyTorch physics core.  This is the
port's own copy of `gym_so100_tpu/models/mjcf.py` (numpy only), kept so the
port never imports the JAX package.

This is a from-scratch reader, not a port of MuJoCo's compiler; it covers:
includes, compiler (angle/meshdir), option, asset meshes/materials, nested
default classes with childclass inheritance, bodies/joints/geoms/sites/cameras,
inertial elements, position actuators (incl. inheritrange + dampratio),
contact excludes, equality welds, keyframes, and mocap bodies.
"""

from __future__ import annotations

import dataclasses
import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .stl import load_mesh

# MuJoCo global defaults for attributes we consume.
_GEOM_DEFAULTS = dict(
    type="sphere",
    size="0 0 0",
    pos="0 0 0",
    quat="1 0 0 0",
    friction="1 0.005 0.0001",
    solref="0.02 1",
    solimp="0.9 0.95 0.001 0.5 2",
    condim="3",
    contype="1",
    conaffinity="1",
    group="0",
    density="1000",
    margin="0",
    rgba="0.5 0.5 0.5 1",
    mesh=None,
    material=None,
    mass=None,
    euler=None,
)
_JOINT_DEFAULTS = dict(
    type="hinge",
    pos="0 0 0",
    axis="0 0 1",
    range="0 0",
    frictionloss="0",
    armature="0",
    damping="0",
    stiffness="0",
    limited=None,
)
_POSITION_DEFAULTS = dict(
    kp="1",
    kv="0",
    dampratio="0",
    forcerange="0 0",
    ctrlrange="0 0",
    inheritrange="0",
    gear="1",
)
_GENERAL_DEFAULTS = dict(
    gainprm="1 0 0",
    biasprm="0 0 0",
    forcerange="0 0",
    ctrlrange="0 0",
    gear="1",
    dyntype="none",
    gaintype="fixed",
    biastype="none",
)
_SITE_DEFAULTS = dict(pos="0 0 0", quat="1 0 0 0", size="0.005", type="sphere", rgba="0.5 0.5 0.5 1")


def _fl(s, n=None):
    v = np.array([float(x) for x in s.split()], dtype=np.float64)
    if n is not None and v.size != n:
        raise ValueError(f"expected {n} floats, got {s!r}")
    return v


def _fl_pad(s, defaults):
    """Parse floats, padding missing trailing entries with defaults (MJCF
    allows partial solimp/solref specifications)."""
    v = [float(x) for x in s.split()]
    out = np.array(defaults, dtype=np.float64)
    out[: len(v)] = v
    return out


@dataclass
class MeshAsset:
    name: str
    verts: np.ndarray  # (V, 3)
    faces: np.ndarray  # (F, 3)


@dataclass
class Geom:
    name: str
    type: str
    size: np.ndarray
    pos: np.ndarray
    quat: np.ndarray
    friction: np.ndarray
    solref: np.ndarray
    solimp: np.ndarray
    condim: int
    contype: int
    conaffinity: int
    group: int
    rgba: np.ndarray
    mesh: Optional[str] = None


@dataclass
class Joint:
    name: str
    type: str  # "hinge" | "free" | "slide" | "ball"
    pos: np.ndarray
    axis: np.ndarray
    range: np.ndarray
    limited: bool
    frictionloss: float
    armature: float
    damping: float
    stiffness: float


@dataclass
class Site:
    name: str
    pos: np.ndarray
    quat: np.ndarray


@dataclass
class Camera:
    name: str
    pos: np.ndarray
    quat: np.ndarray
    mode: str
    target: Optional[str]
    fovy: float


@dataclass
class Inertial:
    pos: np.ndarray
    quat: np.ndarray
    mass: float
    diaginertia: np.ndarray


@dataclass
class Body:
    name: str
    pos: np.ndarray
    quat: np.ndarray
    mocap: bool = False
    inertial: Optional[Inertial] = None
    joints: list[Joint] = field(default_factory=list)
    geoms: list[Geom] = field(default_factory=list)
    sites: list[Site] = field(default_factory=list)
    cameras: list[Camera] = field(default_factory=list)
    children: list["Body"] = field(default_factory=list)


@dataclass
class Actuator:
    name: str
    joint: str
    kp: float                    # position: kp; general: gainprm[0]
    kv: float
    dampratio: float
    forcerange: np.ndarray
    ctrlrange: np.ndarray
    inheritrange: bool
    gear: float
    kind: str = "position"       # "position" | "general"
    biasprm: np.ndarray = None   # (3,) general actuators only


@dataclass
class Keyframe:
    name: str
    qpos: np.ndarray
    ctrl: np.ndarray


@dataclass
class Weld:
    site1: str
    site2: str
    solref: np.ndarray
    solimp: np.ndarray


@dataclass
class JointEq:
    """<equality><joint> coupling: q1 - q01 = polycoef(q2 - q02)."""

    joint1: str
    joint2: str
    polycoef: np.ndarray  # (5,)
    solref: np.ndarray
    solimp: np.ndarray


@dataclass
class Option:
    timestep: float = 0.002
    gravity: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, -9.81]))
    cone: str = "pyramidal"
    impratio: float = 1.0
    integrator: str = "euler"
    iterations: int = 100
    tolerance: float = 1e-8
    ls_iterations: int = 50


@dataclass
class MjcfDoc:
    option: Option
    meshes: dict[str, MeshAsset]
    worldbody: Body
    actuators: list[Actuator]
    keyframes: list[Keyframe]
    excludes: list[tuple[str, str]]
    welds: list[Weld]
    joint_eqs: list[JointEq]


class _Defaults:
    """Nested default-class resolution (MJCF <default> tree)."""

    def __init__(self):
        # classname -> {elemtag -> {attr -> value}}
        self.classes: dict[str, dict[str, dict[str, str]]] = {"main": {}}
        self.parents: dict[str, Optional[str]] = {"main": None}

    def add_tree(self, elem: ET.Element, parent: str = "main"):
        name = elem.get("class", "main" if parent == "main" else None)
        if name is None:
            raise ValueError("nested default without class name")
        if name not in self.classes:
            self.classes[name] = {}
            self.parents[name] = parent
        for child in elem:
            if child.tag == "default":
                self.add_tree(child, name)
            else:
                self.classes[name].setdefault(child.tag, {}).update(child.attrib)

    def resolve(self, tag: str, elem: ET.Element, active_class: str) -> dict[str, str]:
        """Merge attributes: global defaults < class chain < element attrs."""
        chain = []
        c = elem.get("class", active_class)
        while c is not None:
            chain.append(c)
            c = self.parents.get(c)
        merged: dict[str, str] = {}
        for cls in reversed(chain):  # root first, leaf overrides
            merged.update(self.classes.get(cls, {}).get(tag, {}))
        merged.update(elem.attrib)
        return merged


def _resolve_mesh_path(fname: str, filedir: str, maindir: str, meshdir: str) -> str:
    cands = [
        os.path.join(filedir, meshdir, fname),
        os.path.join(filedir, fname),
        os.path.join(maindir, meshdir, fname),
        os.path.join(maindir, fname),
    ]
    for c in cands:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(f"mesh {fname!r} not found near {filedir!r}")


class _Parser:
    def __init__(self, main_path: str):
        self.main_dir = os.path.dirname(os.path.abspath(main_path))
        self.defaults = _Defaults()
        self.meshes: dict[str, MeshAsset] = {}
        self.option = Option()
        self.actuators: list[Actuator] = []
        self.keyframes: list[Keyframe] = []
        self.excludes: list[tuple[str, str]] = []
        self.welds: list[Weld] = []
        self.joint_eqs: list[JointEq] = []
        self.angle = "degree"
        self.meshdir = ""
        self.worldbody = Body("world", np.zeros(3), np.array([1.0, 0, 0, 0]))
        self._auto_id = 0

    # -- include expansion -------------------------------------------------
    def _expand(self, path: str) -> list[tuple[ET.Element, str]]:
        """Flatten the include tree into (top-level element, filedir) pairs in
        document order, which matches MuJoCo's splice semantics."""
        tree = ET.parse(path)
        root = tree.getroot()
        filedir = os.path.dirname(os.path.abspath(path))
        out: list[tuple[ET.Element, str]] = []
        for child in root:
            if child.tag == "include":
                sub = os.path.join(filedir, child.get("file"))
                out.extend(self._expand(sub))
            else:
                out.append((child, filedir))
        return out

    def parse(self, path: str) -> MjcfDoc:
        elements = self._expand(path)
        # Pass 1: compiler / option / defaults / assets (order-independent setup).
        for elem, filedir in elements:
            if elem.tag == "compiler":
                if elem.get("angle"):
                    self.angle = elem.get("angle")
                if elem.get("meshdir"):
                    self.meshdir = elem.get("meshdir")
            elif elem.tag == "option":
                o = self.option
                if elem.get("timestep"):
                    o.timestep = float(elem.get("timestep"))
                if elem.get("gravity"):
                    o.gravity = _fl(elem.get("gravity"), 3)
                if elem.get("cone"):
                    o.cone = elem.get("cone")
                if elem.get("impratio"):
                    o.impratio = float(elem.get("impratio"))
                if elem.get("integrator"):
                    o.integrator = elem.get("integrator")
                if elem.get("iterations"):
                    o.iterations = int(elem.get("iterations"))
                if elem.get("tolerance"):
                    o.tolerance = float(elem.get("tolerance"))
            elif elem.tag == "default":
                self.defaults.add_tree(elem)
        for elem, filedir in elements:
            if elem.tag == "asset":
                for a in elem:
                    if a.tag == "mesh":
                        name = a.get("name") or os.path.splitext(os.path.basename(a.get("file")))[0]
                        scale = _fl(a.get("scale", "1 1 1"), 3)
                        if a.get("vertex") is not None:
                            # inline vertex list (MJCF <mesh vertex="...">);
                            # faces from the convex hull like MuJoCo
                            verts = np.asarray(
                                _fl(a.get("vertex")), dtype=np.float64
                            ).reshape(-1, 3) * scale[None, :]
                            try:
                                from scipy.spatial import ConvexHull

                                faces = ConvexHull(verts).simplices.astype(
                                    np.int32
                                )
                            except Exception:
                                faces = np.zeros((0, 3), np.int32)
                            self.meshes[name] = MeshAsset(name, verts, faces)
                            continue
                        p = _resolve_mesh_path(a.get("file"), filedir, self.main_dir, self.meshdir)
                        verts, faces = load_mesh(p, scale)
                        self.meshes[name] = MeshAsset(name, verts, faces)
        # Pass 2: worldbody content, actuators, contacts, equality, keyframes.
        for elem, filedir in elements:
            if elem.tag == "worldbody":
                self._parse_body_children(elem, self.worldbody, "main")
            elif elem.tag == "actuator":
                for a in elem:
                    if a.tag == "position":
                        attrs = self.defaults.resolve("position", a, "main")
                        merged = dict(_POSITION_DEFAULTS)
                        merged.update({k: v for k, v in attrs.items() if v is not None})
                        self.actuators.append(
                            Actuator(
                                name=a.get("name", a.get("joint")),
                                joint=attrs["joint"],
                                kp=float(merged["kp"]),
                                kv=float(merged["kv"]),
                                dampratio=float(merged["dampratio"]),
                                forcerange=_fl(merged["forcerange"], 2),
                                ctrlrange=_fl(merged["ctrlrange"], 2),
                                inheritrange=merged["inheritrange"] not in ("0", "false", 0),
                                gear=float(str(merged["gear"]).split()[0]),
                            )
                        )
                    elif a.tag == "general":
                        # affine gain/bias actuators (the Panda EE scene,
                        # franka_emika_panda/panda_ee.xml:268-285):
                        # force = gainprm0*ctrl + biasprm . [1, length, vel]
                        attrs = self.defaults.resolve("general", a, "main")
                        merged = dict(_GENERAL_DEFAULTS)
                        merged.update({k: v for k, v in attrs.items() if v is not None})
                        if merged["dyntype"] != "none":
                            raise NotImplementedError(
                                f"general actuator dyntype {merged['dyntype']}"
                            )
                        if merged["gaintype"] != "fixed":
                            raise NotImplementedError(
                                f"general actuator gaintype {merged['gaintype']}"
                            )
                        if "joint" not in merged or merged.get("joint") is None:
                            raise NotImplementedError(
                                "general actuators require a joint transmission"
                            )
                        gain = _fl_pad(merged["gainprm"], [1.0, 0.0, 0.0])[:3]
                        bias = _fl_pad(merged["biasprm"], [0.0, 0.0, 0.0])[:3]
                        self.actuators.append(
                            Actuator(
                                name=a.get("name", merged.get("joint")),
                                joint=merged["joint"],
                                kp=float(gain[0]),
                                kv=-float(bias[2]),
                                dampratio=0.0,
                                forcerange=_fl(merged["forcerange"], 2),
                                ctrlrange=_fl(merged["ctrlrange"], 2),
                                inheritrange=False,
                                gear=float(str(merged["gear"]).split()[0]),
                                kind="general",
                                biasprm=np.asarray(bias),
                            )
                        )
                    else:
                        raise NotImplementedError(f"actuator {a.tag}")
            elif elem.tag == "contact":
                for c in elem:
                    if c.tag == "exclude":
                        self.excludes.append((c.get("body1"), c.get("body2")))
            elif elem.tag == "equality":
                for e in elem:
                    if e.tag == "joint":
                        self.joint_eqs.append(
                            JointEq(
                                joint1=e.get("joint1"),
                                joint2=e.get("joint2"),
                                polycoef=_fl_pad(
                                    e.get("polycoef", "0 1 0 0 0"),
                                    [0.0, 1.0, 0.0, 0.0, 0.0],
                                ),
                                solref=_fl_pad(e.get("solref", "0.02 1"), [0.02, 1.0]),
                                solimp=_fl_pad(
                                    e.get("solimp", "0.9 0.95 0.001 0.5 2"),
                                    [0.9, 0.95, 0.001, 0.5, 2.0],
                                ),
                            )
                        )
                    elif e.tag == "weld":
                        self.welds.append(
                            Weld(
                                site1=e.get("site1"),
                                site2=e.get("site2"),
                                solref=_fl_pad(e.get("solref", "0.02 1"), [0.02, 1.0]),
                                solimp=_fl_pad(e.get("solimp", "0.9 0.95 0.001 0.5 2"), [0.9, 0.95, 0.001, 0.5, 2.0]),
                            )
                        )
            elif elem.tag == "keyframe":
                for k in elem:
                    self.keyframes.append(
                        Keyframe(
                            name=k.get("name", ""),
                            qpos=_fl(k.get("qpos")),
                            ctrl=_fl(k.get("ctrl")) if k.get("ctrl") else np.zeros(0),
                        )
                    )
        return MjcfDoc(
            option=self.option,
            meshes=self.meshes,
            worldbody=self.worldbody,
            actuators=self.actuators,
            keyframes=self.keyframes,
            excludes=self.excludes,
            welds=self.welds,
            joint_eqs=self.joint_eqs,
        )

    # -- orientation handling ---------------------------------------------
    def _quat_from(self, attrs: dict) -> np.ndarray:
        if attrs.get("quat") is not None:
            q = _fl(attrs["quat"], 4)
            return q / np.linalg.norm(q)
        if attrs.get("euler") is not None:
            e = _fl(attrs["euler"], 3)
            if self.angle == "degree":
                e = e * math.pi / 180.0
            q = _euler_xyz_to_quat(e)
            return q / np.linalg.norm(q)
        return np.array([1.0, 0.0, 0.0, 0.0])

    # -- body tree ---------------------------------------------------------
    def _parse_body_children(self, elem: ET.Element, body: Body, active_class: str):
        for child in elem:
            if child.tag == "body":
                attrs = dict(child.attrib)
                q = self._quat_from(attrs)
                b = Body(
                    name=attrs.get("name", f"body_{self._auto_id}"),
                    pos=_fl(attrs.get("pos", "0 0 0"), 3),
                    quat=q,
                    mocap=attrs.get("mocap", "false") == "true",
                )
                self._auto_id += 1
                cls = attrs.get("childclass", active_class)
                self._parse_body_children(child, b, cls)
                body.children.append(b)
            elif child.tag == "inertial":
                pos = _fl(child.get("pos"), 3)
                mass = float(child.get("mass"))
                if child.get("diaginertia") is not None:
                    diag = _fl(child.get("diaginertia"), 3)
                    q = np.array([1.0, 0, 0, 0])
                    if child.get("quat") is not None:
                        q = _fl(child.get("quat"), 4)
                        q = q / np.linalg.norm(q)
                else:
                    # fullinertia -> principal axes
                    fi = _fl(child.get("fullinertia"), 6)
                    I = np.array(
                        [
                            [fi[0], fi[3], fi[4]],
                            [fi[3], fi[1], fi[5]],
                            [fi[4], fi[5], fi[2]],
                        ]
                    )
                    w, v = np.linalg.eigh(I)
                    order = np.argsort(w)[::-1]
                    w, v = w[order], v[:, order]
                    if np.linalg.det(v) < 0:
                        v[:, 2] *= -1
                    diag = w
                    q = _mat_to_quat(v)
                body.inertial = Inertial(pos=pos, quat=q, mass=mass, diaginertia=diag)
            elif child.tag == "joint":
                attrs = self.defaults.resolve("joint", child, active_class)
                merged = dict(_JOINT_DEFAULTS)
                merged.update({k: v for k, v in attrs.items() if v is not None})
                rng = _fl(merged["range"], 2)
                if self.angle == "degree" and merged["type"] in ("hinge", "ball"):
                    rng = rng * math.pi / 180.0
                limited = merged["limited"]
                if limited is None:  # autolimits: limited iff range specified
                    limited = "range" in attrs and (rng[0] != 0 or rng[1] != 0)
                else:
                    limited = limited == "true"
                body.joints.append(
                    Joint(
                        name=merged.get("name", f"joint_{self._auto_id}"),
                        type=merged["type"],
                        pos=_fl(merged["pos"], 3),
                        axis=_normed(_fl(merged["axis"], 3)),
                        range=rng,
                        limited=bool(limited),
                        frictionloss=float(merged["frictionloss"]),
                        armature=float(merged["armature"]),
                        damping=float(merged["damping"]),
                        stiffness=float(merged["stiffness"]),
                    )
                )
                self._auto_id += 1
            elif child.tag == "freejoint":
                body.joints.append(
                    Joint(
                        name=child.get("name", f"joint_{self._auto_id}"),
                        type="free",
                        pos=np.zeros(3),
                        axis=np.array([0.0, 0, 1]),
                        range=np.zeros(2),
                        limited=False,
                        frictionloss=0.0,
                        armature=0.0,
                        damping=0.0,
                        stiffness=0.0,
                    )
                )
                self._auto_id += 1
            elif child.tag == "geom":
                attrs = self.defaults.resolve("geom", child, active_class)
                merged = dict(_GEOM_DEFAULTS)
                merged.update({k: v for k, v in attrs.items() if v is not None})
                size = _fl(merged["size"])
                size = np.concatenate([size, np.zeros(3 - size.size)])
                body.geoms.append(
                    Geom(
                        name=merged.get("name", ""),
                        type=merged["type"],
                        size=size,
                        pos=_fl(merged["pos"], 3),
                        quat=self._quat_from(merged),
                        friction=_fl(merged["friction"], 3),
                        solref=_fl_pad(merged["solref"], [0.02, 1.0]),
                        solimp=_fl_pad(merged["solimp"], [0.9, 0.95, 0.001, 0.5, 2.0]),
                        condim=int(merged["condim"]),
                        contype=int(merged["contype"]),
                        conaffinity=int(merged["conaffinity"]),
                        group=int(merged["group"]),
                        rgba=_fl(merged["rgba"], 4),
                        mesh=merged.get("mesh"),
                    )
                )
            elif child.tag == "site":
                attrs = self.defaults.resolve("site", child, active_class)
                merged = dict(_SITE_DEFAULTS)
                merged.update({k: v for k, v in attrs.items() if v is not None})
                body.sites.append(
                    Site(
                        name=merged.get("name", f"site_{self._auto_id}"),
                        pos=_fl(merged["pos"], 3),
                        quat=self._quat_from(merged),
                    )
                )
                self._auto_id += 1
            elif child.tag == "camera":
                attrs = dict(child.attrib)
                body.cameras.append(
                    Camera(
                        name=attrs.get("name", f"cam_{self._auto_id}"),
                        pos=_fl(attrs.get("pos", "0 0 0"), 3),
                        quat=self._quat_from(attrs),
                        mode=attrs.get("mode", "fixed"),
                        target=attrs.get("target"),
                        fovy=float(attrs.get("fovy", "45")),
                    )
                )
                self._auto_id += 1
            elif child.tag == "light":
                pass  # lighting handled by the renderer's fixed lights
            else:
                pass


def _normed(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def _euler_xyz_to_quat(e: np.ndarray) -> np.ndarray:
    """MJCF default eulerseq 'xyz' (extrinsic): R = Rz @ Ry @ Rx (numpy,
    build-time; mirrors ops.quat.from_euler_xyz)."""

    def axis_quat(axis, angle):
        q = np.zeros(4)
        q[0] = math.cos(angle / 2)
        q[1 + axis] = math.sin(angle / 2)
        return q

    def qmul(a, b):
        w1, x1, y1, z1 = a
        w2, x2, y2, z2 = b
        return np.array(
            [
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ]
        )

    qx, qy, qz = axis_quat(0, e[0]), axis_quat(1, e[1]), axis_quat(2, e[2])
    return qmul(qz, qmul(qy, qx))


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), numpy, build-time only."""
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q / np.linalg.norm(q)


def parse_mjcf(path: str) -> MjcfDoc:
    """Parse an MJCF file (with includes) into the intermediate representation."""
    return _Parser(path).parse(path)
