"""Full numpy quaternion algebra (host-side pose/mocap tooling).

Same public surface and semantics as the reference's ``utils/Quaternions.py``
(:24-555) — the Holden-style array-of-quaternions class used by the BVH /
mocap pipelines: Hamilton products, vector rotation, slerp scaling,
exp/log maps, six Euler orders, angle-axis, rotation-matrix round-trips,
eigenvector averaging, and axis-constrained projection. Implemented
independently and vectorized with einsum (the reference's ``average`` relies
on ``numpy.core.umath_tests``, removed from modern numpy).

Layout: (..., 4) arrays in (w, x, y, z) order.

Known upstream quirks preserved or fixed (documented here):
- ``reshape`` upstream is a no-op bug (``utils/Quaternions.py:230-232``
  never assigns); here it really reshapes the batch dims.
- ``constrained`` keeps the upstream selection quirk (both branches write
  from ``top``/``bot`` after seeding ``ret = top.copy()``).
"""

from __future__ import annotations

import numpy as np

_POLE = np.array([1.0, 0.0, 0.0, 0.0])


def _hamilton(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """q ⊗ r for (..., 4) wxyz arrays (ref __mul__, :79-122)."""
    w = q[..., 0] * r[..., 0] - np.einsum("...i,...i->...",
                                          q[..., 1:], r[..., 1:])
    xyz = (q[..., :1] * r[..., 1:] + r[..., :1] * q[..., 1:]
           + np.cross(q[..., 1:], r[..., 1:]))
    return np.concatenate([w[..., None], xyz], axis=-1)


class Quaternions:
    """Array of quaternions with numpy-style broadcasting."""

    def __init__(self, qs):
        if isinstance(qs, Quaternions):
            self.qs = qs.qs
        elif isinstance(qs, np.ndarray):
            self.qs = qs[None] if qs.ndim == 1 else qs
        else:
            raise TypeError(
                f"Quaternions must be constructed from ndarray or "
                f"Quaternions, not {type(qs)}"
            )

    def __str__(self):
        return f"Quaternions({self.qs})"

    def __repr__(self):
        return f"Quaternions({self.qs!r})"

    # -------------------------------------------------------- broadcasting
    @classmethod
    def _broadcast(cls, sqs, oqs, scalar=False):
        """Mutual numpy broadcast; `scalar=True` broadcasts oqs against the
        batch dims only (ref :45-71: equal ndim required, size-1 dims
        repeated)."""
        if isinstance(oqs, float):
            return sqs, oqs * np.ones(sqs.shape[:-1])
        ss = sqs.shape[:-1] if scalar else sqs.shape
        if len(ss) != oqs.ndim:
            raise TypeError(
                f"Quaternions cannot broadcast shapes {sqs.shape} and "
                f"{oqs.shape}"
            )
        if ss == oqs.shape:
            return sqs, oqs
        try:
            shape = np.broadcast_shapes(ss, oqs.shape)
        except ValueError:
            raise TypeError(
                f"Quaternions cannot broadcast shapes {sqs.shape} and "
                f"{oqs.shape}"
            )
        sqs_b = np.broadcast_to(
            sqs, shape + ((sqs.shape[-1],) if scalar else ())
        ).copy()
        oqs_b = np.broadcast_to(oqs, shape).copy()
        return sqs_b, oqs_b

    # ---------------------------------------------------------- operators
    def __add__(self, other):
        return self * other  # addition is defined as composition (:73)

    def __sub__(self, other):
        return self / other

    def __mul__(self, other):
        if isinstance(other, Quaternions):
            sqs, oqs = Quaternions._broadcast(self.qs, other.qs)
            return Quaternions(_hamilton(sqs, oqs))
        if isinstance(other, np.ndarray) and other.shape[-1] == 3:
            # rotate vectors: q ⊗ (0, v) ⊗ q̄ (ref :124-127; the conjugate is
            # unnormalized, so non-unit quaternions scale by |q|^2 as there)
            vs = np.concatenate(
                [np.zeros(other.shape[:-1] + (1,)), other], axis=-1
            )
            rotated = self * (Quaternions(vs) * -self)
            return rotated.imaginaries
        if isinstance(other, (np.ndarray, float)):
            # scale the rotation: slerp from identity (ref :129-131)
            return Quaternions.slerp(Quaternions.id_like(self), self, other)
        raise TypeError(
            f"Cannot multiply/add Quaternions with type {type(other)}"
        )

    def __div__(self, other):
        if isinstance(other, Quaternions):
            return self * (-other)
        if isinstance(other, (np.ndarray, float)):
            return self * (1.0 / other)
        raise TypeError(
            f"Cannot divide/subtract Quaternions with type {type(other)}"
        )

    __truediv__ = __div__

    def __eq__(self, other):
        return self.qs == other.qs

    def __ne__(self, other):
        return self.qs != other.qs

    def __neg__(self):
        """Conjugate (inverse for unit quaternions)."""
        return Quaternions(self.qs * np.array([1.0, -1.0, -1.0, -1.0]))

    def __abs__(self):
        """Normalize and flip every quaternion to the w >= 0 pole."""
        out = self.normalized().copy()
        flip = np.sum(out.qs * _POLE, axis=-1) < np.sum(-out.qs * _POLE,
                                                        axis=-1)
        out.qs[flip] = -out.qs[flip]
        return out

    def __iter__(self):
        return iter(self.qs)

    def __len__(self):
        return len(self.qs)

    def __getitem__(self, k):
        return Quaternions(self.qs[k])

    def __setitem__(self, k, v):
        self.qs[k] = v.qs

    # ---------------------------------------------------------- properties
    @property
    def lengths(self):
        return np.linalg.norm(self.qs, axis=-1)

    @property
    def reals(self):
        return self.qs[..., 0]

    @property
    def imaginaries(self):
        return self.qs[..., 1:4]

    @property
    def shape(self):
        return self.qs.shape[:-1]

    # ------------------------------------------------------------- methods
    def repeat(self, n, **kwargs):
        return Quaternions(self.qs.repeat(n, **kwargs))

    def normalized(self):
        return Quaternions(self.qs / self.lengths[..., None])

    def log(self):
        """Rotation-vector (half-angle-scaled axis) log map (ref :196-201)."""
        pole = abs(self)
        imag = pole.imaginaries
        norms = np.linalg.norm(imag, axis=-1)
        scale = np.arctan2(norms, pole.reals) / (norms + 1e-10)
        return imag * scale[..., None]

    def constrained(self, axis):
        """Closest rotation about a fixed axis (ref :203-218, including the
        upstream top/bot selection quirk)."""
        rl = self.reals
        im = np.sum(axis * self.imaginaries, axis=-1)
        t1 = -2 * np.arctan2(rl, im) + np.pi
        t2 = -2 * np.arctan2(rl, im) - np.pi
        top = Quaternions.exp(axis[None] * (t1[:, None] / 2.0))
        bot = Quaternions.exp(axis[None] * (t2[:, None] / 2.0))
        pick_top = self.dot(top) > self.dot(bot)
        out = top.copy()
        out[pick_top] = top[pick_top]
        out[~pick_top] = bot[~pick_top]
        return out

    def constrained_x(self):
        return self.constrained(np.array([1.0, 0.0, 0.0]))

    def constrained_y(self):
        return self.constrained(np.array([0.0, 1.0, 0.0]))

    def constrained_z(self):
        return self.constrained(np.array([0.0, 0.0, 1.0]))

    def dot(self, q):
        return np.sum(self.qs * q.qs, axis=-1)

    def copy(self):
        return Quaternions(self.qs.copy())

    def reshape(self, s):
        # upstream's reshape is a silent no-op (utils/Quaternions.py:230-232
        # never assigns the result); implemented correctly here
        self.qs = self.qs.reshape(tuple(np.atleast_1d(s)) + (4,))
        return self

    def interpolate(self, ws):
        return Quaternions.exp(np.average(abs(self).log(), axis=0, weights=ws))

    def euler(self, order="xyz", epsilon=0):
        """Euler angles, matching the reference's six order conventions
        (ref :237-247)."""
        q = self.normalized().qs
        w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

        def atan(a, b):
            return np.arctan2(a, b)

        def asin(v):
            return np.arcsin(np.clip(v, -1 + epsilon, 1 - epsilon))

        if order == "xyz":
            es = (atan(2 * (w * x - y * z), 1 - 2 * (x * x + y * y)),
                  asin(2 * (x * z + w * y)),
                  atan(2 * (w * z - x * y), 1 - 2 * (y * y + z * z)))
        elif order == "yzx":
            es = (atan(2 * (w * x - y * z), 1 - 2 * (x * x + z * z)),
                  atan(2 * (w * y - x * z), 1 - 2 * (y * y + z * z)),
                  asin(2 * (x * y + w * z)))
        elif order == "zxy":
            es = (asin(2 * (w * x + y * z)),
                  atan(2 * (w * y - x * z), 1 - 2 * (x * x + y * y)),
                  atan(2 * (w * z - x * y), 1 - 2 * (x * x + z * z)))
        elif order == "xzy":
            es = (atan(2 * (w * x + y * z), 1 - 2 * (x * x + z * z)),
                  atan(2 * (w * y + x * z), 1 - 2 * (y * y + z * z)),
                  asin(2 * (w * z - x * y)))
        elif order == "yxz":
            es = (asin(2 * (w * x - y * z)),
                  atan(2 * (x * z + w * y), 1 - 2 * (x * x + y * y)),
                  atan(2 * (x * y + w * z), 1 - 2 * (x * x + z * z)))
        elif order == "zyx":
            es = (atan(2 * (w * x + y * z), 1 - 2 * (x * x + y * y)),
                  asin(2 * (w * y - x * z)),
                  atan(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)))
        else:
            raise ValueError(
                "Order must be one of xyz, yzx, zxy, xzy, yxz, zyx."
            )
        return np.stack(es, axis=-1)

    def average(self):
        """Eigenvector quaternion average (ref :324-336, reimplemented with
        einsum — the upstream umath_tests import is dead in modern numpy)."""
        if len(self.shape) != 1:
            raise NotImplementedError(
                "Cannot average multi-dimensional Quaternions"
            )
        system = np.einsum("ni,nj->ij", self.qs, self.qs)
        _, vecs = np.linalg.eigh(system)
        proj = np.einsum("ni,ij->nj", self.qs, vecs)
        best = np.argmin((1.0 - proj**2).sum(axis=0))
        return Quaternions(vecs[:, best])

    def angle_axis(self):
        norm = self.normalized()
        s = np.sqrt(np.maximum(1 - norm.reals**2, 0.0))
        s = np.where(s == 0, 0.001, s)
        angles = 2.0 * np.arccos(np.clip(norm.reals, -1.0, 1.0))
        axis = norm.imaginaries / s[..., None]
        return angles, axis

    def transforms(self):
        """(..., 3, 3) rotation matrices (ref :349-383)."""
        w, x, y, z = (self.qs[..., 0], self.qs[..., 1],
                      self.qs[..., 2], self.qs[..., 3])
        xx, yy, zz = 2 * x * x, 2 * y * y, 2 * z * z
        xy, yz, xz = 2 * x * y, 2 * y * z, 2 * x * z
        wx, wy, wz = 2 * w * x, 2 * w * y, 2 * w * z
        row0 = np.stack([1 - yy - zz, xy - wz, xz + wy], axis=-1)
        row1 = np.stack([xy + wz, 1 - xx - zz, yz - wx], axis=-1)
        row2 = np.stack([xz - wy, yz + wx, 1 - xx - yy], axis=-1)
        return np.stack([row0, row1, row2], axis=-2)

    def ravel(self):
        return self.qs.ravel()

    # -------------------------------------------------------- constructors
    @classmethod
    def id(cls, n):
        if isinstance(n, tuple):
            return cls(np.broadcast_to(_POLE, n + (4,)).copy())
        if isinstance(n, int):
            return cls(np.broadcast_to(_POLE, (n, 4)).copy())
        raise TypeError(f"Cannot construct Quaternion from {type(n)}")

    @classmethod
    def id_like(cls, a):
        return cls(np.broadcast_to(_POLE, a.shape + (4,)).copy())

    @classmethod
    def exp(cls, ws):
        """Inverse of log: rotation vector -> unit quaternion (ref :410-423,
        including the 0.001 zero-angle guard)."""
        ts = np.linalg.norm(ws, axis=-1)
        ts = np.where(ts == 0, 0.001, ts)
        sinc = np.sin(ts) / ts
        qs = np.concatenate(
            [np.cos(ts)[..., None], ws * sinc[..., None]], axis=-1
        )
        return cls(qs).normalized()

    @classmethod
    def slerp(cls, q0s, q1s, a):
        fst, snd = cls._broadcast(q0s.qs, q1s.qs)
        fst, a = cls._broadcast(fst, a, scalar=True)
        snd, a = cls._broadcast(snd, a, scalar=True)

        cos_omega = np.sum(fst * snd, axis=-1)
        neg = cos_omega < 0.0
        cos_omega = np.where(neg, -cos_omega, cos_omega)
        snd = np.where(neg[..., None], -snd, snd)

        w0 = np.empty_like(a)
        w1 = np.empty_like(a)
        linear = (1.0 - cos_omega) < 0.01
        omega = np.arccos(np.clip(cos_omega[~linear], -1.0, 1.0))
        sin_omega = np.sin(omega)
        w0[linear] = 1.0 - a[linear]
        w1[linear] = a[linear]
        w0[~linear] = np.sin((1.0 - a[~linear]) * omega) / sin_omega
        w1[~linear] = np.sin(a[~linear] * omega) / sin_omega
        return cls(w0[..., None] * fst + w1[..., None] * snd)

    @classmethod
    def between(cls, v0s, v1s):
        """Minimal rotations mapping v0s onto v1s (ref :460-472, with the
        parallel-vector identity fallback)."""
        axis = np.cross(v0s, v1s)
        axis_norm = np.linalg.norm(axis, axis=-1)
        parallel = np.argwhere(axis_norm < 1e-6)[..., 0]
        axis = axis / axis_norm[..., None]
        u0 = v0s / np.linalg.norm(v0s, axis=-1)[..., None]
        u1 = v1s / np.linalg.norm(v1s, axis=-1)[..., None]
        angles = np.arccos(np.einsum("...i,...i->...", u0, u1))
        q = cls.from_angle_axis(angles, axis)
        if len(parallel) > 0:
            q[parallel] = cls.id(len(parallel))
        return q

    @classmethod
    def from_angle_axis(cls, angles, axis):
        axis = axis / (np.linalg.norm(axis, axis=-1) + 1e-10)[..., None]
        half = np.asarray(angles) / 2.0
        return cls(np.concatenate(
            [np.cos(half)[..., None], axis * np.sin(half)[..., None]],
            axis=-1,
        ))

    @classmethod
    def from_euler(cls, es, order="xyz", world=False):
        basis = {"x": np.array([1.0, 0.0, 0.0]),
                 "y": np.array([0.0, 1.0, 0.0]),
                 "z": np.array([0.0, 0.0, 1.0])}
        q0 = cls.from_angle_axis(es[..., 0], basis[order[0]])
        q1 = cls.from_angle_axis(es[..., 1], basis[order[1]])
        q2 = cls.from_angle_axis(es[..., 2], basis[order[2]])
        return (q2 * (q1 * q0)) if world else (q0 * (q1 * q2))

    @classmethod
    def from_transforms(cls, ts):
        """Rotation matrices -> quaternions, Shepperd-style branch selection
        (ref :514-555)."""
        d0, d1, d2 = ts[..., 0, 0], ts[..., 1, 1], ts[..., 2, 2]
        q = np.stack([
            (d0 + d1 + d2 + 1.0) / 4.0,
            (d0 - d1 - d2 + 1.0) / 4.0,
            (-d0 + d1 - d2 + 1.0) / 4.0,
            (-d0 - d1 + d2 + 1.0) / 4.0,
        ], axis=-1)
        q = np.sqrt(np.clip(q, 0.0, None))
        q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]

        c0 = (q0 >= q1) & (q0 >= q2) & (q0 >= q3)
        c1 = ~c0 & (q1 >= q0) & (q1 >= q2) & (q1 >= q3)
        c2 = ~c0 & ~c1 & (q2 >= q0) & (q2 >= q1) & (q2 >= q3)
        c3 = ~c0 & ~c1 & ~c2

        m = ts
        s21, s02, s10 = (m[..., 2, 1] - m[..., 1, 2],
                         m[..., 0, 2] - m[..., 2, 0],
                         m[..., 1, 0] - m[..., 0, 1])
        a10, a02, a21 = (m[..., 1, 0] + m[..., 0, 1],
                         m[..., 0, 2] + m[..., 2, 0],
                         m[..., 2, 1] + m[..., 1, 2])

        q1 = np.where(c0, q1 * np.sign(s21), q1)
        q2 = np.where(c0, q2 * np.sign(s02), q2)
        q3 = np.where(c0, q3 * np.sign(s10), q3)

        q0 = np.where(c1, q0 * np.sign(s21), q0)
        q2 = np.where(c1, q2 * np.sign(a10), q2)
        q3 = np.where(c1, q3 * np.sign(a02), q3)

        q0 = np.where(c2, q0 * np.sign(s02), q0)
        q1 = np.where(c2, q1 * np.sign(a10), q1)
        q3 = np.where(c2, q3 * np.sign(a21), q3)

        q0 = np.where(c3, q0 * np.sign(s10), q0)
        q1 = np.where(c3, q1 * np.sign(a02), q1)
        q2 = np.where(c3, q2 * np.sign(a21), q2)

        return cls(np.stack([q0, q1, q2, q3], axis=-1))
