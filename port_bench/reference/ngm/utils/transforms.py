"""Rigid-transform and quaternion math in PyTorch (port of
neural_graph_mapping_tpu.utils.transforms).

Quaternions are real-first (w, x, y, z). Functions broadcast over leading
dimensions and run on the device of their inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two quaternions. Shapes broadcast; last dim 4."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (conjugate). Shape (..., 4)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate 3D points by unit quaternions. Broadcasts; point shape (..., 3)."""
    w = q[..., :1]
    v = q[..., 1:]
    v, point = torch.broadcast_tensors(v, point)
    t = 2.0 * torch.linalg.cross(v, point)
    return point + w * t + torch.linalg.cross(v, t)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Convert unit quaternions (..., 4) to rotation matrices (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def complex_invert(c: torch.Tensor) -> torch.Tensor:
    """Conjugate of real-first complex numbers (..., 2): the inverse of a
    unit-modulus 2D rotation."""
    return c * torch.tensor([1.0, -1.0], dtype=c.dtype, device=c.device)


def complex_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of real-first complex numbers (..., 2); broadcasts."""
    ar, ai = a.unbind(-1)
    br, bi = b.unbind(-1)
    return torch.stack([ar * br - ai * bi, ar * bi + br * ai], dim=-1)


def complex_apply(c: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate 2D points (..., 2) by complex rotations (..., 2); broadcasts."""
    return complex_multiply(c, point)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Convert rotation matrices (..., 3, 3) to real-first unit quaternions
    (branch-free: all four candidates, pick the best-conditioned one)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))
    quat_w = torch.stack([q_abs_sq[..., 0], m21 - m12, m02 - m20, m10 - m01], -1)
    quat_x = torch.stack([m21 - m12, q_abs_sq[..., 1], m10 + m01, m02 + m20], -1)
    quat_y = torch.stack([m02 - m20, m10 + m01, q_abs_sq[..., 2], m12 + m21], -1)
    quat_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs_sq[..., 3]], -1)
    candidates = torch.stack([quat_w, quat_x, quat_y, quat_z], dim=-2)
    candidates = candidates / (2.0 * torch.clamp(q_abs, min=1e-12))[..., None]
    best = torch.argmax(q_abs_sq, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    quat = torch.gather(candidates, -2, idx)[..., 0, :]
    return torch.where(quat[..., :1] < 0, -quat, quat)


def transform_points(
    points: torch.Tensor, transforms: torch.Tensor, inv: bool = False
) -> torch.Tensor:
    """Apply (or inverse-apply) rigid 4x4 transforms to 3D points.

    Args:
        points: (..., 3).
        transforms: (..., 4, 4), broadcastable against points' leading dims.
        inv: apply the inverse transform (rigid: R^T).
    """
    rot = transforms[..., :3, :3]
    trans = transforms[..., :3, 3]
    if inv:
        return torch.einsum("...kd,...k->...d", rot, points - trans)
    return torch.einsum("...dk,...k->...d", rot, points) + trans


def transform_quaternions(quaternions: torch.Tensor, transforms: torch.Tensor) -> torch.Tensor:
    """Rotate orientations (real-first quats) by the rotation of 4x4 transforms."""
    return quaternion_multiply(matrix_to_quaternion(transforms[..., :3, :3]), quaternions)


def invert_rigid(transforms: torch.Tensor) -> torch.Tensor:
    """Invert rigid 4x4 transforms without a general solve."""
    rot_t = transforms[..., :3, :3].transpose(-1, -2)
    new_trans = -torch.einsum("...dk,...k->...d", rot_t, transforms[..., :3, 3])
    out = torch.zeros_like(transforms)
    out[..., :3, :3] = rot_t
    out[..., :3, 3] = new_trans
    out[..., 3, 3] = 1.0
    return out


def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last dimension."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def to_inhomogeneous(x: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """Drop the last element of the trailing dim, optionally dividing by it
    first."""
    if normalize:
        x = x / x[..., -1:]
    return x[..., :-1]


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False) -> np.ndarray:
    """Least-squares rigid alignment dst ~= T @ src (Umeyama 1991), numpy."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_src = src.mean(axis=0)
    mu_dst = dst.mean(axis=0)
    src_c = src - mu_src
    dst_c = dst - mu_dst
    cov = dst_c.T @ src_c / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    rot = u @ s @ vt
    scale = np.trace(np.diag(d) @ s) / ((src_c**2).sum() / len(src)) if with_scale else 1.0
    out = np.eye(4)
    out[:3, :3] = scale * rot
    out[:3, 3] = mu_dst - scale * rot @ mu_src
    return out
