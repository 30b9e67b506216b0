"""Convex-hull face polygons for contact-manifold generation.

MuJoCo compiles, for every collidable mesh, the convex hull's faces as
coplanar-merged polygons (mjModel.mesh_poly*) and its native convex
collider expands GJK/EPA results into multi-point contact manifolds by
clipping the aligned face polygons (observed behavior of mj_collision on
mesh pairs; see ops/collision/manifold.py).  This module computes the same
structure from raw mesh vertices at build time:

    hull_polygons(verts) -> (hull_vert_positions, polys)

where each poly is (normal (3,), ordered vertex index list into the
returned vertex array, CCW seen from outside).

The merge rule — group hull triangles into maximal edge-connected coplanar
regions — is validated against the oracle's mesh_poly* tables in
tests/test_manifold.py (polygon count and vertex-set equality per face).
The port's own copy of `gym_so100_tpu/models/hullpoly.py`.
"""

from __future__ import annotations

import numpy as np


def box_polygons(half: np.ndarray):
    """Exact-hull data for an analytic box geom: 8 corners and 6 CCW quads
    (the convex prim equivalent MuJoCo's native collider uses when a box
    meets a mesh)."""
    hx, hy, hz = [float(v) for v in half]
    verts = np.array(
        [[sx * hx, sy * hy, sz * hz]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        dtype=np.float64,
    )
    # vertex index = (sx>0)*4 + (sy>0)*2 + (sz>0); quads wound CCW seen from
    # outside along each outward axis
    polys = [
        (np.array([1.0, 0, 0]), [4, 6, 7, 5]),
        (np.array([-1.0, 0, 0]), [0, 1, 3, 2]),
        (np.array([0, 1.0, 0]), [2, 3, 7, 6]),
        (np.array([0, -1.0, 0]), [0, 4, 5, 1]),
        (np.array([0, 0, 1.0]), [1, 5, 7, 3]),
        (np.array([0, 0, -1.0]), [0, 2, 6, 4]),
    ]
    return verts, polys


def _hull_triangles(verts: np.ndarray):
    """Outward-oriented hull triangles + the hull vertex subset."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    tris = hull.simplices.astype(np.int64)
    eqs = hull.equations  # (F, 4): n.x + off = 0, n outward
    # reorient each triangle CCW seen from outside (scipy does not guarantee)
    v = verts
    for i, t in enumerate(tris):
        n = np.cross(v[t[1]] - v[t[0]], v[t[2]] - v[t[0]])
        if np.dot(n, eqs[i, :3]) < 0:
            tris[i] = tris[i][::-1]
    return tris, eqs


def _merge_coplanar(tris, eqs, verts, angle_tol):
    """Union-find triangles into edge-connected near-coplanar groups.

    Two edge-adjacent hull triangles merge when their outward normals agree
    within `angle_tol` radians.  The threshold (default 5e-3) was fit
    against MuJoCo's compiled mesh_poly* tables for the SO100 scene meshes:
    it reproduces the polygon sets exactly for the contact-critical small
    meshes (tabletop, gripper-pad collision meshes) and to ~96-98% polygon
    count on the large decimated-CAD arm hulls (where the residual
    differences sit on curved regions that fail the runtime face-alignment
    test anyway — see ops/collision/manifold.py)."""
    F = len(tris)
    parent = list(range(F))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    cos_tol = np.cos(angle_tol)
    # map undirected edge -> adjacent faces
    edge_faces = {}
    for f, t in enumerate(tris):
        for k in range(3):
            e = (min(t[k], t[(k + 1) % 3]), max(t[k], t[(k + 1) % 3]))
            edge_faces.setdefault(e, []).append(f)
    for e, fs in edge_faces.items():
        for a in fs[1:]:
            f0 = fs[0]
            if np.dot(eqs[f0, :3], eqs[a, :3]) >= cos_tol:
                ra, rb = find(f0), find(a)
                if ra != rb:
                    parent[rb] = ra
    groups = {}
    for f in range(F):
        groups.setdefault(find(f), []).append(f)
    return list(groups.values())


def _boundary_loop(tri_group, tris):
    """Ordered boundary vertex loop of an edge-connected triangle patch.

    Interior (shared) edges appear twice with opposite orientation; the
    boundary is the directed edges appearing once, chained head-to-tail."""
    count = {}
    for f in tri_group:
        t = tris[f]
        for k in range(3):
            a, b = int(t[k]), int(t[(k + 1) % 3])
            count[(a, b)] = count.get((a, b), 0) + 1
    nxt = {}
    for (a, b), c in count.items():
        if c == 1 and count.get((b, a), 0) == 0:
            nxt[a] = b
    if not nxt:
        return None
    start = next(iter(nxt))
    loop = [start]
    cur = nxt[start]
    for _ in range(len(nxt)):
        if cur == start:
            break
        loop.append(cur)
        cur = nxt.get(cur)
        if cur is None:
            return None
    else:
        return None
    return loop


def _drop_collinear(loop, verts, sin_tol=1e-10):
    """Remove vertices collinear with their loop neighbours (MuJoCo's
    polygons keep only corner vertices)."""
    n = len(loop)
    if n < 4:
        return loop
    keep = []
    for i in range(n):
        a, b, c = verts[loop[i - 1]], verts[loop[i]], verts[loop[(i + 1) % n]]
        u, w = b - a, c - b
        lu, lw = np.linalg.norm(u), np.linalg.norm(w)
        if lu == 0 or lw == 0:
            continue
        if np.linalg.norm(np.cross(u, w)) > sin_tol * lu * lw:
            keep.append(loop[i])
    return keep if len(keep) >= 3 else loop


def hull_polygons(verts: np.ndarray, angle_tol=5e-3):
    """Coplanar-merged convex hull face polygons.

    Returns (hull_verts (H,3) float64, polys) with polys a list of
    (normal (3,), [ordered indices into hull_verts]).  `angle_tol` is the
    normal-agreement merge threshold in radians (fit against the oracle's
    mesh_poly* tables; see _merge_coplanar and tests/test_manifold.py).
    """
    verts = np.asarray(verts, dtype=np.float64)
    tris, eqs = _hull_triangles(verts)
    groups = _merge_coplanar(tris, eqs, verts, angle_tol)
    polys = []
    used = set()
    for g in groups:
        loop = _boundary_loop(g, tris)
        if loop is None:  # non-disc patch: fall back to per-triangle faces
            for f in g:
                t = [int(x) for x in tris[f]]
                n = eqs[f, :3] / np.linalg.norm(eqs[f, :3])
                polys.append((n, t))
                used.update(t)
            continue
        loop = _drop_collinear(loop, verts)
        # area-weighted mean normal of the patch
        n = np.zeros(3)
        for f in g:
            t = tris[f]
            n += np.cross(verts[t[1]] - verts[t[0]], verts[t[2]] - verts[t[0]])
        n /= max(np.linalg.norm(n), 1e-300)
        polys.append((n, loop))
        used.update(loop)
    # compact to hull-vertex indexing
    order = sorted(used)
    remap = {v: i for i, v in enumerate(order)}
    hull_verts = verts[order]
    polys = [(n, [remap[i] for i in loop]) for n, loop in polys]
    return hull_verts, polys
