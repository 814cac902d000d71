"""Quaternion algebra on tensors (w, x, y, z convention), the ops that the
BVH reader and writer and the T2G loss need (reference
`utils/Quaternions_torch.py`, as the JAX package's `ops/quaternions.py`
carries them): the product, the rotation of vectors, sign continuity along
time and the Euler angles in each of the six orders. The JAX package's
other ops (`qinv`, `euler_to_quaternion`, `expmap_to_quaternion`) wait for
their first caller.

Every function works over any leading dimensions and computes in the
input's dtype; the JAX package computes them in float32.
"""

from __future__ import annotations

import torch


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q * r of (..., 4) quaternions."""
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    return torch.stack((
        qw * rw - qx * rx - qy * ry - qz * rz,
        qw * rx + qx * rw + qy * rz - qz * ry,
        qw * ry - qx * rz + qy * rw + qz * rx,
        qw * rz + qx * ry - qy * rx + qz * rw,
    ), dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Vectors v (..., 3) rotated by the quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qeuler(q: torch.Tensor, order: str, epsilon: float = 0.0) -> torch.Tensor:
    """Quaternions -> Euler angles (..., 3) as (x, y, z) in one of the six
    orders (ref utils/Quaternions_torch.py:56-100); the arcsin's input is
    clamped to [-1 + epsilon, 1 - epsilon]."""
    q0, q1, q2, q3 = q.unbind(-1)

    def asin(x):
        return torch.asin(torch.clamp(x, -1.0 + epsilon, 1.0 - epsilon))

    if order == "xyz":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = asin(2 * (q1 * q3 + q0 * q2))
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    elif order == "yzx":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = asin(2 * (q1 * q2 + q0 * q3))
    elif order == "zxy":
        x = asin(2 * (q0 * q1 + q2 * q3))
        y = torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "xzy":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = torch.atan2(2 * (q0 * q2 + q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = asin(2 * (q0 * q3 - q1 * q2))
    elif order == "yxz":
        x = asin(2 * (q0 * q1 - q2 * q3))
        y = torch.atan2(2 * (q1 * q3 + q0 * q2), 1 - 2 * (q1 * q1 + q2 * q2))
        z = torch.atan2(2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "zyx":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = asin(2 * (q0 * q2 - q1 * q3))
        z = torch.atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    else:
        raise ValueError("order must be one of xyz, yzx, zxy, xzy, yxz, zyx")
    return torch.stack((x, y, z), dim=-1)


def qfix(q: torch.Tensor) -> torch.Tensor:
    """Sign continuity along the first axis (time): a frame whose dot
    product with the previous frame is negative flips, and the flips carry
    on by their cumulative parity (ref utils/Quaternions_torch.py:144-187)."""
    dots = (q[1:] * q[:-1]).sum(-1)
    flips = torch.cumsum((dots < 0).to(torch.int64), dim=0) % 2
    sign = torch.cat([torch.ones((1,) + tuple(flips.shape[1:]), dtype=q.dtype, device=q.device),
                      1.0 - 2.0 * flips.to(q.dtype)], dim=0)
    return q * sign[..., None]
