"""The gesture-embedding autoencoder of the FGD evaluator (reference
`net/embedding_net.py`, as the JAX package's `models/embedding_net.py`
rebuilt it): `EmbeddingNet(mode="pose")`, a conv pose encoder to a 32-d
latent with VAE heads and a conv decoder back to poses.

Module names are the reference's state-dict keys, so the reference's
`outputs/embedding_net.pth.tar` loads with `strict=True`. Torch is
channel-first, so the encoder's flatten in (C, T') order and the decoder's
`view(B, 4, T')` are the natural ones. The reference's `nn.LeakyReLU(True)`
has slope 1.0, the identity: those sites are `nn.Identity`, which keeps the
Sequential indices. The other modes (speech, random; `PoseDecoderFC`,
`PoseDecoderGRU`, `ContextEncoder`) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from .generator import re_parametrize


def conv_norm_relu(in_channels: int, out_channels: int, down_sample: bool = False,
                   padding: int = 0) -> nn.Sequential:
    """Conv1d (kernel 3, or 4 with stride 2 to down-sample) + BatchNorm1d +
    LeakyReLU(0.2); ref net/embedding_net.py:16-39."""
    k, s = (4, 2) if down_sample else (3, 1)
    return nn.Sequential(nn.Conv1d(in_channels, out_channels, k, stride=s, padding=padding),
                         nn.BatchNorm1d(out_channels), nn.LeakyReLU(0.2))


class PoseEncoderConv(nn.Module):
    """Poses (B, T, dim) -> 32-d (z, mu, log_var); ref net/embedding_net.py
    :42-82 (T = 34 flattens to 32 x 12 = 384)."""

    def __init__(self, length: int = C.N_POSES, dim: int = C.POSE_DIM):
        super().__init__()
        self.net = nn.Sequential(
            conv_norm_relu(dim, 32), conv_norm_relu(32, 64),
            conv_norm_relu(64, 64, down_sample=True), nn.Conv1d(64, 32, 3))
        t = ((length - 4) - 4) // 2 + 1 - 2
        self.out_net = nn.Sequential(
            nn.Linear(32 * t, 256), nn.BatchNorm1d(256), nn.Identity(),
            nn.Linear(256, 128), nn.BatchNorm1d(128), nn.Identity(),
            nn.Linear(128, 32))
        self.fc_mu = nn.Linear(32, 32)
        self.fc_log_var = nn.Linear(32, 32)

    def forward(self, poses: torch.Tensor, eps: torch.Tensor | None = None):
        """With `eps` (the reparametrization's noise, (B, 32)) z is drawn
        from the latent; without it z = mu."""
        x = self.out_net(self.net(poses.transpose(1, 2)).flatten(1))
        mu, log_var = self.fc_mu(x), self.fc_log_var(x)
        z = mu if eps is None else re_parametrize(mu, log_var, eps)
        return z, mu, log_var


class PoseDecoderConv(nn.Module):
    """32-d latent -> poses (B, T, dim); ref net/embedding_net.py:165-217."""

    def __init__(self, length: int = C.N_POSES, dim: int = C.POSE_DIM):
        super().__init__()
        sizes = {34: (64, 136), 64: (128, 256)}.get(length)
        if sizes is None:
            raise ValueError("PoseDecoderConv supports length 34 or 64")
        self.pre_net = nn.Sequential(
            nn.Linear(32, sizes[0]), nn.BatchNorm1d(sizes[0]), nn.Identity(),
            nn.Linear(sizes[0], sizes[1]))
        self.net = nn.Sequential(
            nn.ConvTranspose1d(4, 32, 3), nn.BatchNorm1d(32), nn.LeakyReLU(0.2),
            nn.ConvTranspose1d(32, 32, 3), nn.BatchNorm1d(32), nn.LeakyReLU(0.2),
            nn.Conv1d(32, 32, 3), nn.Conv1d(32, dim, 3))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = self.pre_net(feat).view(feat.shape[0], 4, -1)
        return self.net(x).transpose(1, 2)


class EmbeddingNet(nn.Module):
    """The autoencoder in mode 'pose' (the FGD configuration; ref
    net/embedding_net.py:262-308)."""

    def __init__(self, pose_dim: int = C.POSE_DIM, n_frames: int = C.N_POSES,
                 mode: str = "pose"):
        super().__init__()
        if mode != "pose":
            raise NotImplementedError(
                f"EmbeddingNet mode {mode!r}: only 'pose' (the FGD embedding) is "
                "ported yet (ROADMAP.md, queue 1)")
        self.pose_encoder = PoseEncoderConv(n_frames, pose_dim)
        self.decoder = PoseDecoderConv(n_frames, pose_dim)

    def forward(self, poses: torch.Tensor, eps: torch.Tensor | None = None):
        """poses (B, T, dim) -> (feat, mu, log_var, reconstruction (B, T,
        dim)); feat = mu unless `eps` is given (variational encoding)."""
        feat, mu, log_var = self.pose_encoder(poses, eps)
        return feat, mu, log_var, self.decoder(feat)
