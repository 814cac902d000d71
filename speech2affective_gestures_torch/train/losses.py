"""Loss stack of the s2ag GAN (reference `processor_v2.py:793-937` and
`utils/losses.py`):

- ns-GAN D loss: -mean(log D(real) + log(1 - D(fake))), eps 1e-8;
- ns-GAN G term: -mean(log D(fake));
- scaled Huber: smooth_l1(x/beta, y/beta) * beta with beta = 0.1;
- speaker-embedding KLD;
- speaker diversity regularizer: -pose_l1/(z_l1 + 1e-5) clamped at -1000;
- L1, and a running mean for logging;
- the T2G quaternion objective (ref utils/losses.py:29-45): a wrap-around
  Euler L1 and a drift term.
"""

from __future__ import annotations

import math

import torch

from ..ops.quaternions import qeuler

_EPS = 1e-8


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (torch beta=1)."""
    d = x - y
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def scaled_huber(x: torch.Tensor, y: torch.Tensor, beta: float) -> torch.Tensor:
    """mean(smooth_l1(x/beta, y/beta)) * beta (ref processor_v2.py:893-894)."""
    return smooth_l1(x / beta, y / beta).mean() * beta


def dis_ns_gan(d_real: torch.Tensor, d_fake: torch.Tensor) -> torch.Tensor:
    """ref processor_v2.py:811."""
    return -torch.mean(torch.log(d_real + _EPS) + torch.log(1.0 - d_fake + _EPS))


def gen_ns_gan(d_fake: torch.Tensor) -> torch.Tensor:
    """ref processor_v2.py:896."""
    return -torch.mean(torch.log(d_fake + _EPS))


def kld_speaker(z_mu: torch.Tensor, z_log_var: torch.Tensor) -> torch.Tensor:
    """ref processor_v2.py:926."""
    return -0.5 * torch.mean(1.0 + z_log_var - z_mu ** 2 - torch.exp(z_log_var))


def diversity_regularizer(out: torch.Tensor, out_rand: torch.Tensor,
                          z: torch.Tensor, z_rand: torch.Tensor) -> torch.Tensor:
    """Speaker-diversity term (ref processor_v2.py:908-922). out_rand, z and
    z_rand are constants (the reference `.detach()`es them); the gradient
    flows only through `out`."""
    out_rand, z, z_rand = out_rand.detach(), z.detach(), z_rand.detach()
    beta = 0.05
    pose_l1 = (smooth_l1(out / beta, out_rand / beta) * beta).sum(dim=(1, 2))
    z_l1 = (z - z_rand).abs().reshape(z.shape[0], -1).mean(dim=1)
    div = -(pose_l1 / (z_l1 + 1.0e-5))
    return torch.clamp(div, min=-1000.0).mean()


def l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def quat_angle_loss(quats_pred: torch.Tensor, quats_target: torch.Tensor,
                    num_joints: int, dims: int = 4, lower_body_start: int = 15,
                    upper_body_weights: float = 1.0, drift_len: int = 20):
    """(angle, drift) of (B, T, num_joints * dims) quaternion sequences (ref
    utils/losses.py:29-45, JAX `train/losses.py:82-102`): Euler angles in
    order yzx (epsilon 1e-6); angle is the mean |wrap(pred - target)| over
    frames 1.., wrapped into [-pi, pi); drift the mean of |sum over offsets
    1..drift_len-1 of the offset differences of pred less those of target|,
    each offset's differences added from the first frame on. Joints below
    `lower_body_start` are weighted by `upper_body_weights`."""
    qp = quats_pred.reshape(-1, quats_pred.shape[1], num_joints, dims)
    qt = quats_target.reshape(-1, quats_target.shape[1], num_joints, dims)
    ep = qeuler(qp, "yzx", epsilon=1e-6)
    et = qeuler(qt, "yzx", epsilon=1e-6)
    dist = torch.remainder(ep[:, 1:] - et[:, 1:] + math.pi, 2 * math.pi) - math.pi
    weights = torch.ones(num_joints, 1, dtype=dist.dtype, device=dist.device)
    weights[:lower_body_start] = upper_body_weights
    drift = torch.zeros_like(dist)
    for idx in range(1, min(drift_len, ep.shape[1])):   # longer offsets add nothing
        upd = ep[:, idx:] - ep[:, :-idx] - et[:, idx:] + et[:, :-idx]
        drift = drift + torch.nn.functional.pad(upd, (0, 0, 0, 0, idx - 1, 0))
    return (dist * weights).abs().mean(), (drift * weights).abs().mean()


class AverageMeter:
    """Running mean (ref utils/average_meter.py)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        fmt_str = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmt_str.format(**self.__dict__)
