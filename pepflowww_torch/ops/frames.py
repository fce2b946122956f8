"""Rigid-frame algebra on (R, t) pairs: R (..., 3, 3) column-basis matrices,
t (..., 3).

Includes the math of the JAX package's plane-form module (``rot9``): the
backbone update and the geodesic are written here on ordinary (..., 3, 3)
tensors (the geodesic is :func:`pepflowww_torch.ops.so3.geodesic_t`).
"""

from __future__ import annotations

import torch


def safe_normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """v / (|v| + eps), with a norm whose gradient is finite at 0."""
    n = torch.sqrt(torch.sum(v * v, dim, keepdim=True) + 1e-24)
    return v / (n + eps)


def project_v2v(v: torch.Tensor, e: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Project `v` onto the unit vector `e`."""
    return torch.sum(e * v, dim, keepdim=True) * e


def construct_3d_basis(center, p1, p2) -> torch.Tensor:
    """Gram–Schmidt frame from (CA, C, N): columns [e1, e2, e3]."""
    e1 = safe_normalize(p1 - center)
    v2 = p2 - center
    e2 = safe_normalize(v2 - project_v2v(v2, e1))
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], -1)


def _points(x: torch.Tensor, frame_ndim: int) -> torch.Tensor:
    return x.reshape(x.shape[:frame_ndim] + (-1, 3))


def global_to_local(R, t, q) -> torch.Tensor:
    """p = Rᵀ (q - t)."""
    qf = _points(q, R.dim() - 2) - t[..., None, :]
    return (qf @ R).reshape(q.shape)


def compose(R1, t1, R2, t2):
    """(R1 R2, R1 t2 + t1)."""
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def compose_chain(Ts):
    """Right-fold composition of a list of (R, t) frames."""
    Ts = list(Ts)
    while len(Ts) >= 2:
        (R1, t1), (R2, t2) = Ts[-2], Ts[-1]
        Ts = Ts[:-2] + [compose(R1, t1, R2, t2)]
    return Ts[0]


def quat_1ijk_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of the normalized quaternion (1, b, c, d)."""
    b, c, d = q.unbind(-1)
    s = torch.sqrt(1.0 + b * b + c * c + d * d)
    a, b, c, d = 1.0 / s, b / s, c / s, d / s
    return torch.stack([
        torch.stack([a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c], -1),
        torch.stack([2 * b * c + 2 * a * d, a * a - b * b + c * c - d * d, 2 * c * d - 2 * a * b], -1),
        torch.stack([2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a - b * b - c * c + d * d], -1),
    ], -2)


def compose_q_update(R, t, update, update_mask=None):
    """Apply a 6-D backbone update [(1,x,y,z) quaternion | translation]:
    R' = R · R((1, x, y, z)), t' = t + R · t_vec; rows with mask 0 keep R
    and t."""
    R_upd = R @ quat_1ijk_to_rotmat(update[..., :3])
    t_upd = (R @ update[..., 3:, None])[..., 0]
    if update_mask is None:
        return R_upd, t + t_upd
    m = update_mask[..., None]
    R_new = torch.where((m > 0.5)[..., None], R_upd, R)
    return R_new, t + t_upd * m


def kabsch_align(pos_1: torch.Tensor, pos_2: torch.Tensor, weights: torch.Tensor):
    """Weighted Kabsch: the rigid motion taking `pos_1` (..., N, 3) onto
    `pos_2`, points weighted by `weights` (..., N) (zero excludes a point).
    Returns (pos_1 @ Rᵀ + t, R, t), R a proper rotation (the last singular
    vector flipped where the determinant is negative)."""
    w = weights.to(pos_1.dtype)[..., None]
    wsum = w.sum(-2, keepdim=True) + 1e-8
    mu1 = (pos_1 * w).sum(-2, keepdim=True) / wsum
    mu2 = (pos_2 * w).sum(-2, keepdim=True) / wsum
    S = ((pos_1 - mu1) * w).mT @ ((pos_2 - mu2) * w)
    u, _, vt = torch.linalg.svd(S, full_matrices=False)
    det = torch.linalg.det(vt.mT @ u.mT)
    flip = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = vt.mT @ (u * flip[..., None, :]).mT
    t = mu2 - mu1 @ R.mT
    return pos_1 @ R.mT + t, R, t
