"""Triangle rasterizer for pixel observations, in plain PyTorch.

The port of `gym_so100_tpu/render/rasterizer.py`: flat-shaded frames from
the model's cameras, rendered on the device of the model.  The scene is a
triangle soup packed once (visual meshes decimated by vertex clustering,
with a body id per vertex); a render poses the vertices by forward
kinematics, projects them through a look-at pinhole camera and runs a
z-buffered edge-function pass over the triangles in chunks.

Every numeric choice of the JAX renderer is kept: the render is float32
whatever the model's dtype, the C terms of the edge functions are formed
difference-first, triangles under 1e-2 px^2 or behind the 0.01 near plane
are culled, a pixel takes the nearest covering triangle (the first one on
ties), and colours are clipped and truncated to uint8.

Where XLA fuses the per-chunk (triangles x pixels) tensors, eager PyTorch
materialises them, so a render walks over blocks of (envs x triangles x
pixels) of at most `chunk_elems` elements: memory stays bounded at any
batch size and resolution.  Each pixel's result depends on its own column
only, so the blocking changes no pixel: a batched render equals the
per-env renders exactly.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..models.scene import Model, State
from ..ops import quat
from ..ops import smooth_lanes
from ..profiling import annotate

TRI_CHUNK = 1024
CHUNK_ELEMS = 1 << 24     # elements of one (envs x triangles x pixels) block
NEAR = 0.01
SKY = (0.72, 0.8, 0.89)


def _quat_rot_np(q, v):
    w, x, y, z = q
    t = 2 * np.cross([x, y, z], v)
    return v + w * t + np.cross([x, y, z], t)


def _decimate(verts, faces, target):
    """Vertex-clustering decimation to <= target triangles."""
    if len(faces) <= target:
        return verts, faces
    lo_, hi_ = verts.min(0), verts.max(0)
    diag = np.linalg.norm(hi_ - lo_) + 1e-9
    cell = diag / 64
    for _ in range(24):
        snapped = np.round(verts / cell)
        uniq, inv = np.unique(snapped, axis=0, return_inverse=True)
        f = inv[faces]
        ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        f = f[ok]
        # drop duplicate triangles regardless of winding order
        key = np.sort(f, axis=1)
        _, first = np.unique(key, axis=0, return_index=True)
        f = f[np.sort(first)]
        if len(f) <= target:
            # new vertex positions: mean of clustered verts
            nv = np.zeros((len(uniq), 3))
            cnt = np.zeros(len(uniq))
            np.add.at(nv, inv, verts)
            np.add.at(cnt, inv, 1)
            nv /= cnt[:, None]
            return nv, f
        cell *= 1.5
    return nv, f  # pragma: no cover


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _soup(aux: dict, max_tris_per_mesh):
    """The scene's triangle soup as numpy arrays (verts (V, 3) in body
    frames, vbody (V,), faces (F, 3), fcol (F, 3)), unpadded."""
    verts_l, vbody_l, faces_l, fcol_l = [], [], [], []
    voff = 0
    for g in aux["render_geoms"]:
        rgba = np.asarray(g["rgba"], dtype=np.float64)
        if g.get("group", 0) not in (0, 1, 2) or rgba[3] <= 0.1:
            continue
        if g["type"] == "mesh":
            mesh = aux["meshes"][g["mesh"]]
            v, f = _decimate(np.asarray(mesh.verts), np.asarray(mesh.faces),
                             max_tris_per_mesh)
        elif g["type"] == "box":
            s = np.asarray(g["size"])
            v = np.array(
                [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            ) * s
            f = np.array(
                [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                 [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                 [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]
            )
        else:
            # fail loudly: silently skipping a geom type renders half-empty
            # frames on scenes beyond the vendored ones
            raise NotImplementedError(
                f"rasterizer: unsupported geom type {g['type']!r} "
                f"(body {g['body']}); supported: mesh, box")
        # place in geom frame within the body
        q = np.asarray(g["quat"], dtype=np.float64)
        v = np.stack([_quat_rot_np(q, vv) for vv in v]) + np.asarray(g["pos"])
        verts_l.append(v)
        vbody_l.append(np.full(len(v), g["body"], np.int32))
        faces_l.append(np.asarray(f, np.int32) + voff)
        fcol_l.append(np.tile(rgba[:3], (len(f), 1)))
        voff += len(v)
    return (np.concatenate(verts_l), np.concatenate(vbody_l),
            np.concatenate(faces_l), np.concatenate(fcol_l))


class Renderer:
    """Flat-shaded rasterizer bound to a Model, on the Model's device.

    The triangle count is padded to a multiple of `tri_chunk` with
    degenerate triangles (which are culled), and the per-pixel pass takes
    `tri_chunk` triangles at a time, in blocks of at most `chunk_elems`
    (envs x triangles x pixels) elements."""

    def __init__(self, m: Model, aux: dict, max_tris_per_mesh=700,
                 tri_chunk=TRI_CHUNK):
        self.m = m
        self.tri_chunk = tri_chunk
        self.chunk_elems = CHUNK_ELEMS
        verts, vbody, faces, fcol = _soup(aux, max_tris_per_mesh)
        # pad triangle count to a chunk multiple with degenerate tris
        pad = (-len(faces)) % tri_chunk
        if pad:
            faces = np.concatenate([faces, np.zeros((pad, 3), np.int32)])
            fcol = np.concatenate([fcol, np.zeros((pad, 3))])
        self.npad_valid = len(faces) - pad
        dev = m.qpos0.device
        self.verts = torch.as_tensor(verts, dtype=torch.float32, device=dev)
        self.vbody = torch.as_tensor(vbody, dtype=torch.long, device=dev)
        self.faces = torch.as_tensor(faces, dtype=torch.long, device=dev)
        self.fcol = torch.as_tensor(fcol, dtype=torch.float32, device=dev)
        self.cam = {name: i for i, name in enumerate(m.names_cam)}

    def to(self, device) -> "Renderer":
        """A copy of this renderer (its model too) on `device`."""
        r = copy.copy(self)
        r.m = self.m.to(device)
        for name in ("verts", "vbody", "faces", "fcol"):
            setattr(r, name, getattr(self, name).to(device))
        return r

    # -- camera pose --------------------------------------------------------

    def camera(self, xpos, xquat, cam_id):
        """World position and (right, up, forward) axes of camera `cam_id`
        for body poses xpos (B, NB, 3), xquat (B, NB, 4): each (B, 3)."""
        m = self.m
        f32 = torch.float32
        b = m.cam_bodyid[cam_id]
        cpos = xpos[:, b] + quat.rotate(xquat[:, b], m.cam_pos[cam_id].to(f32))
        if m.cam_mode[cam_id] == "targetbody":
            fwd = xpos[:, m.cam_targetbodyid[cam_id]] - cpos
            fwd = fwd / torch.clamp(_norm(fwd), min=1e-9)[:, None]
            # degenerate straight-down view: fall back to +y up
            degen = fwd[:, 2].abs() > 0.999
            up_w = torch.zeros_like(fwd)
            up_w[:, 1] = degen.to(f32)
            up_w[:, 2] = (~degen).to(f32)
            right = _cross(fwd, up_w)
            right = right / torch.clamp(_norm(right), min=1e-9)[:, None]
            up = _cross(right, fwd)
        else:
            R = quat.to_mat(quat.mul(xquat[:, b], m.cam_quat[cam_id].to(f32)))
            # a MuJoCo camera looks along -z of its frame, x right, y up
            right, up, fwd = R[..., 0], R[..., 1], -R[..., 2]
        return cpos, right, up, fwd

    def _view(self, xpos, xquat, points, height, width, cam_id):
        """Pixel coordinates px, py and depth cz, each (B, N), of world points
        (B, N, 3) in camera `cam_id`, and the camera's forward axis."""
        f32 = torch.float32
        cpos, right, up, fwd = self.camera(xpos, xquat, cam_id)
        rel = points - cpos[:, None]
        cx = _dot(rel, right[:, None])
        cy = _dot(rel, up[:, None])
        cz = _dot(rel, fwd[:, None])           # depth along view dir (>0 front)
        fovy = torch.deg2rad(self.m.cam_fovy[cam_id].to(f32))
        fscale = 1.0 / torch.tan(fovy / 2)
        aspect = width / height
        safe_z = torch.clamp(cz, min=NEAR)
        sx = (cx / safe_z) * fscale / aspect
        sy = (cy / safe_z) * fscale
        px = (sx * 0.5 + 0.5) * width
        py = (1.0 - (sy * 0.5 + 0.5)) * height
        return px, py, cz, fwd

    def project(self, s: State, points, height, width, camera="top"):
        """Where world points (B, N, 3) land in the frames of the batched
        State `s`: pixel coordinates (x, y), each (B, N)."""
        cam_id = self.cam[camera] if isinstance(camera, str) else camera
        d = smooth_lanes.kinematics(self.m, s)
        f32 = torch.float32
        px, py, _, _ = self._view(d.xpos.to(f32), d.xquat.to(f32), points.to(f32),
                                  height, width, cam_id)
        return px, py

    # -- rendering ----------------------------------------------------------

    def render_batch(self, s: State, height=48, width=64, camera="top") -> torch.Tensor:
        """(B, height, width, 3) uint8 frames of the batched State `s`."""
        cam_id = self.cam[camera] if isinstance(camera, str) else camera
        with annotate("render"):
            d = smooth_lanes.kinematics(self.m, s)
            return self.render_poses(d.xpos, d.xquat, height, width, cam_id)

    def render(self, s: State, height=480, width=640, camera="top") -> torch.Tensor:
        """(height, width, 3) uint8 frame of one env's (unbatched) State."""
        return self.render_batch(s.index(None), height, width, camera)[0]

    def render_poses(self, xpos, xquat, height, width, cam_id) -> torch.Tensor:
        """Frames from body poses xpos (B, NB, 3) and xquat (B, NB, 4)."""
        f32 = torch.float32
        xpos, xquat = xpos.to(f32), xquat.to(f32)
        B = xpos.shape[0]

        # pose all verts
        vw = xpos[:, self.vbody] + quat.rotate(xquat[:, self.vbody], self.verts)
        px, py, cz, fwd = self._view(xpos, xquat, vw, height, width, cam_id)

        # per-triangle affine coefficients (B, F), computed once: the edge
        # function e0 = A0 gx + B0 gy + C0, the edge sum e0 + e1 + e2 = twice
        # the signed area, and the interpolated depth An gx + Bn gy + Cn
        f0, f1, f2 = self.faces.unbind(1)
        ax, ay, az = px[:, f0], py[:, f0], cz[:, f0]
        bx, by, bz = px[:, f1], py[:, f1], cz[:, f1]
        qx, qy, qz = px[:, f2], py[:, f2], cz[:, f2]
        # C terms difference-first: a degenerate triangle (the chunk padding
        # has all three vertices equal) multiplies by an exact zero and so
        # gets an exact zero area, which the cull removes
        A0, B0, C0 = ay - by, bx - ax, ax * (by - ay) - (bx - ax) * ay
        A1, B1, C1 = by - qy, qx - bx, bx * (qy - by) - (qx - bx) * by
        A2, B2, C2 = qy - ay, ax - qx, qx * (ay - qy) - (ax - qx) * qy
        area2 = C0 + C1 + C2                   # 2 * signed area
        # normalise orientation so inside == (all edges >= 0), two-sided
        flip = torch.ones_like(area2).masked_fill_(area2 < 0, -1.0)
        A0, B0, C0 = A0 * flip, B0 * flip, C0 * flip
        A1, B1, C1 = A1 * flip, B1 * flip, C1 * flip
        A2, B2, C2 = A2 * flip, B2 * flip, C2 * flip
        area_n = area2 * flip                  # |2 area|
        # area cull at 1e-2 px^2: float32 rounding of the C terms is about
        # coordinate^2 * 2^-24, and a smaller triangle cannot cover a pixel
        # centre of an observation-sized frame anyway
        keep = (area_n > 1e-2) & (az > NEAR) & (bz > NEAR) & (qz > NEAR)
        inv_area = 1.0 / torch.where(keep, area_n, torch.ones_like(area_n))
        # depth as an affine form, the area folded in (all three vertices in
        # front of the near plane, so no per-pixel near test is needed)
        An = (az * A1 + bz * A2 + qz * A0) * inv_area
        Bn = (az * B1 + bz * B2 + qz * B0) * inv_area
        Cn = (az * C1 + bz * C2 + qz * C0) * inv_area
        # culled triangles (degenerate, behind the near plane, padding) can
        # never win: edge 0 hugely negative
        C0 = C0.masked_fill(~keep, -1e30)

        # flat shading from world-space normals, two-sided headlight
        a3 = vw[:, f0]
        n3 = _cross(vw[:, f1] - a3, vw[:, f2] - a3)
        n3 = n3 / torch.clamp(_norm(n3), min=1e-12)[..., None]
        lambert = _dot(n3, fwd[:, None]).abs()
        rgb = self.fcol * (0.35 + 0.65 * lambert)[..., None]     # (B, F, 3)

        coef = torch.stack([A0, B0, C0, A1, B1, C1, An, Bn, Cn, area_n])   # (10, B, F)
        P = height * width
        dev = xpos.device
        gx = (torch.arange(width, dtype=f32, device=dev) + 0.5).repeat(height)
        gy = (torch.arange(height, dtype=f32, device=dev) + 0.5).repeat_interleave(width)
        sky = torch.tensor(SKY, dtype=f32, device=dev)
        cbuf = torch.empty(B, P, 3, dtype=f32, device=dev)
        TC = self.tri_chunk
        nchunks = self.faces.shape[0] // TC
        if TC * P <= self.chunk_elems:
            env_block, px_block = max(1, self.chunk_elems // (TC * P)), P
        else:
            env_block, px_block = 1, max(1, self.chunk_elems // TC)
        for e_lo in range(0, B, env_block):
            es = slice(e_lo, min(e_lo + env_block, B))
            for p_lo in range(0, P, px_block):
                ps = slice(p_lo, min(p_lo + px_block, P))
                cbuf[es, ps] = self._pass(coef[:, es], rgb[es], gx[ps], gy[ps], sky,
                                          TC, nchunks)
        img = torch.clamp(cbuf.reshape(B, height, width, 3), 0.0, 1.0)
        return (img * 255).to(torch.uint8)

    @staticmethod
    def _pass(coef, rgb, gx, gy, sky, TC, nchunks):
        """Colours (E, N, 3) of N pixels at (gx, gy) for E envs: the nearest
        covering triangle of each pixel, over `nchunks` chunks of TC
        triangles (first minimum within a chunk, strict < between chunks)."""
        E, N = rgb.shape[0], gx.shape[0]
        zbuf = torch.full((E, N), float("inf"), dtype=gx.dtype, device=gx.device)
        cbuf = sky.expand(E, N, 3).clone()

        def affine(a, b, c):
            out = a[..., None] * gx
            out += b[..., None] * gy
            out += c[..., None]
            return out

        for ci in range(nchunks):
            A0, B0, C0, A1, B1, C1, An, Bn, Cn, area_n = coef[:, :, ci * TC:(ci + 1) * TC]
            e0 = affine(A0, B0, C0)            # (E, TC, N)
            e1 = affine(A1, B1, C1)
            e2 = area_n[..., None] - e0 - e1   # the edge sum is constant
            emin = torch.minimum(e0, e1)
            del e0, e1
            torch.minimum(emin, e2, out=emin)
            del e2
            zmask = affine(An, Bn, Cn).masked_fill_(~(emin >= 0), float("inf"))
            del emin
            # best triangle in this chunk per pixel
            best = torch.argmin(zmask, dim=1)                      # (E, N)
            bestz = torch.gather(zmask, 1, best[:, None])[:, 0]
            del zmask
            bestc = torch.gather(rgb[:, ci * TC:(ci + 1) * TC], 1,
                                 best[..., None].expand(E, N, 3))
            better = bestz < zbuf
            zbuf = torch.where(better, bestz, zbuf)
            cbuf = torch.where(better[..., None], bestc, cbuf)
        return cbuf
