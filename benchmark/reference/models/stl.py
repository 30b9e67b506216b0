"""Minimal mesh loaders (binary/ASCII STL + Wavefront OBJ), numpy only.

Used at model-build time to load the SO-ARM100 collision/visual meshes that the
scene references from MJCF (gym_so100_tpu/assets/trs_so_arm100/so_arm100.xml)
and the Panda meshes (franka_emika_panda/assets/*.obj).  The port's own copy
of `gym_so100_tpu/models/stl.py`.  Returns unique vertices and triangle indices; vertex welding
matches what a physics engine needs (support functions and rendering), not any
particular CAD tool's output.
"""

from __future__ import annotations

import struct

import numpy as np


def load_mesh(path: str, scale=(1.0, 1.0, 1.0)):
    """Load a mesh by extension (.stl or .obj)."""
    if path.lower().endswith(".obj"):
        return load_obj(path, scale)
    return load_stl(path, scale)


def load_obj(path: str, scale=(1.0, 1.0, 1.0)):
    """Wavefront OBJ: v/f records only (normals/uv/materials ignored);
    polygon faces are fan-triangulated.  Returns (verts (V,3) f64,
    faces (F,3) i32)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float64) * np.asarray(scale, np.float64)
    return v, np.asarray(faces, np.int32)


def load_stl(path: str, scale=(1.0, 1.0, 1.0)):
    """Load an STL file.

    Returns:
      verts: (V, 3) float64 unique vertices (scaled).
      faces: (F, 3) int32 triangle indices into verts.
    """
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            # Could still be binary with a name starting "solid"; sniff size.
            data = f.read()
            if _looks_binary(data):
                tris = _parse_binary(data)
            else:
                tris = _parse_ascii(data.decode("ascii", errors="ignore"))
        else:
            tris = _parse_binary(f.read())

    tris = tris * np.asarray(scale, dtype=np.float64)
    flat = tris.reshape(-1, 3)
    # Weld identical vertices (exact bit match is fine for STL output).
    verts, inverse = np.unique(flat, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    return verts.astype(np.float64), faces


def _looks_binary(data: bytes) -> bool:
    if len(data) < 84:
        return False
    (ntri,) = struct.unpack_from("<I", data, 80)
    return len(data) == 84 + 50 * ntri


def _parse_binary(data: bytes) -> np.ndarray:
    (ntri,) = struct.unpack_from("<I", data, 80)
    raw = np.frombuffer(data, dtype=np.uint8, count=50 * ntri, offset=84)
    raw = raw.reshape(ntri, 50)
    # Each record: normal (3f), 3 vertices (9f), attribute (uint16).
    floats = raw[:, :48].copy().view("<f4").reshape(ntri, 12)
    return floats[:, 3:12].astype(np.float64).reshape(ntri, 3, 3)


def _parse_ascii(text: str) -> np.ndarray:
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    arr = np.asarray(verts, dtype=np.float64)
    if arr.size == 0 or len(arr) % 3 != 0:
        raise ValueError("malformed ASCII STL")
    return arr.reshape(-1, 3, 3)
