"""Quaternion utilities, batch-first (MuJoCo conventions: quats are (w, x, y, z)).

The port of `gym_so100_tpu/ops/quat.py`: every function takes (..., 4)
quaternions and (..., 3) vectors, broadcast over the leading axes, and
uses the same arithmetic as the JAX module.
"""

from __future__ import annotations

import torch


def mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q * p for (..., 4) quaternions (w, x, y, z)."""
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack([
        qw * pw - qx * px - qy * py - qz * pz,
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py - qx * pz + qy * pw + qz * px,
        qw * pz + qx * py - qy * px + qz * pw,
    ], dim=-1)


def conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (w, -x, -y, -z) of (..., 4) quaternions."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by unit quaternion(s) q (..., 4), in the
    expanded 15-multiply form."""
    w, x, y, z = q.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    # t = 2 * cross(q.xyz, v)
    tx = 2.0 * (y * vz - z * vy)
    ty = 2.0 * (z * vx - x * vz)
    tz = 2.0 * (x * vy - y * vx)
    # v + w*t + cross(q.xyz, t)
    return torch.stack([
        vx + w * tx + (y * tz - z * ty),
        vy + w * ty + (z * tx - x * tz),
        vz + w * tz + (x * ty - y * tx),
    ], dim=-1)


def rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by the inverse of unit quaternion(s) q."""
    return rotate(conj(q), v)


def to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4), branchless
    Shepperd's method (select among the four stable cases)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-30)) / 2
    q0 = torch.stack([
        w0,
        (R[..., 2, 1] - R[..., 1, 2]) / (4 * w0),
        (R[..., 0, 2] - R[..., 2, 0]) / (4 * w0),
        (R[..., 1, 0] - R[..., 0, 1]) / (4 * w0),
    ], -1)

    def cand(i, j, k):
        s = torch.sqrt(torch.clamp(
            1.0 + R[..., i, i] - R[..., j, j] - R[..., k, k], min=1e-30)) * 2
        vec = [(R[..., k, j] - R[..., j, k]) / s, None, None, None]
        vec[i + 1] = s / 4
        vec[j + 1] = (R[..., j, i] + R[..., i, j]) / s
        vec[k + 1] = (R[..., k, i] + R[..., i, k]) / s
        return torch.stack(vec, -1)

    d0, d1, d2 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    q = torch.where(
        (tr > 0)[..., None], q0,
        torch.where(((d0 >= d1) & (d0 >= d2))[..., None], cand(0, 1, 2),
                    torch.where((d1 >= d2)[..., None], cand(1, 2, 0), cand(2, 0, 1))))
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of (..., 3) tensors, written out per component."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit quaternion from rotation axis (..., 3) and angle (...,)."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Rotate q by the body-local angular velocity omega over dt with the
    exact exponential map, q * exp(omega dt / 2) (mju_quatIntegrate)."""
    angle = torch.linalg.vector_norm(omega, dim=-1)
    safe = torch.where(angle > 0, angle, 1.0)
    return mul(q, from_axis_angle(omega / safe[..., None], angle * dt))


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Quaternion(s) scaled to unit length."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def from_euler_xyz(euler: torch.Tensor) -> torch.Tensor:
    """MJCF "euler" angles (..., 3) (eulerseq "xyz", extrinsic) -> unit
    quaternions (..., 4): R = Rz(ez) Ry(ey) Rx(ex), as MuJoCo composes them."""
    ex, ey, ez = euler.unbind(-1)
    zero, one = torch.zeros_like(ex), torch.ones_like(ex)
    qx = from_axis_angle(torch.stack([one, zero, zero], -1), ex)
    qy = from_axis_angle(torch.stack([zero, one, zero], -1), ey)
    qz = from_axis_angle(torch.stack([zero, zero, one], -1), ez)
    return mul(qz, mul(qy, qx))


def sub_quat(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """MuJoCo's mju_subQuat: the rotation vector (..., 3) v with
    integrate(qb, v, 1) = qa, v = 2 log(qb^-1 qa), along the shortest arc."""
    qd = mul(conj(qb), qa)
    qd = torch.where(qd[..., :1] < 0, -qd, qd)
    vn = torch.linalg.vector_norm(qd[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vn, qd[..., :1])
    return qd[..., 1:] / torch.clamp(vn, min=1e-15) * angle
