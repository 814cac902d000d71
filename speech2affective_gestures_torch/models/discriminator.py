"""The discriminators (reference net/multimodal_context_net_v2.py):

- `AffDiscriminator`, the s2ag D (:549-585): ST-GCN AffEncoder -> 4-layer
  bi-GRU(64) with summed directions -> per-frame Linear -> Linear(T -> 1)
  -> sigmoid;
- `ConvDiscriminatorTriModal` (:390-435), which is also the abl_aff
  ablation's `ConvDiscriminator` (net/multimodal_context_net_v2_abl_aff.py
  :394-439): three unpadded Conv1d (T -> T - 6) -> the same bi-GRU and
  heads, the last over T - 6 frames.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from . import layers as L
from .encoders import AffEncoder


class AffDiscriminator(nn.Module):
    """poses (B, T, pose_dim) -> (B, 1) in (0, 1). The reference hard-codes
    the GRU's dropout at 0.3; `dropout_prob` lets tests set it to zero."""

    def __init__(self, n_poses: int = C.N_POSES, hidden_size: int = 64,
                 dropout_prob: float = 0.3):
        super().__init__()
        self.hidden_size = hidden_size
        self.aff_encoder = AffEncoder()
        self.gru = L.GRU(8, hidden_size, num_layers=4, bidirectional=True,
                         dropout=dropout_prob)
        self.out = nn.Linear(hidden_size, 1)
        self.out2 = nn.Linear(n_poses, 1)

    def forward(self, poses: torch.Tensor, in_text=None) -> torch.Tensor:
        out, _ = self.gru(self.aff_encoder(poses))            # (T, B, 2H)
        out = self.out(L.sum_bidirectional(out, self.hidden_size))[..., 0]
        return torch.sigmoid(self.out2(out.t()))              # (B, 1)


class ConvDiscriminatorTriModal(nn.Module):
    """poses (B, T, pose_dim) -> (B, 1) in (0, 1). `pre_conv` under the
    reference's Sequential indices: Conv1d(pose_dim -> 16, 3) at 0,
    BatchNorm at 1, nn.LeakyReLU(True) at 2 (slope 1.0: the identity),
    Conv1d(16 -> 8, 3) at 3, BatchNorm at 4, the identity at 5, Conv1d(8 ->
    8, 3) at 6; the convs are unpadded, so the GRU sees T - 6 frames. The
    batch norms are `layers.BatchNorm1d` (float32 statistics at bf16)."""

    def __init__(self, n_poses: int = C.N_POSES, hidden_size: int = 64,
                 dropout_prob: float = 0.3, pose_dim: int = C.POSE_DIM):
        super().__init__()
        self.hidden_size = hidden_size
        self.pre_conv = nn.Sequential(
            nn.Conv1d(pose_dim, 16, 3), L.BatchNorm1d(16), nn.Identity(),
            nn.Conv1d(16, 8, 3), L.BatchNorm1d(8), nn.Identity(),
            nn.Conv1d(8, 8, 3))
        self.gru = L.GRU(8, hidden_size, num_layers=4, bidirectional=True,
                         dropout=dropout_prob)
        self.out = nn.Linear(hidden_size, 1)
        self.out2 = nn.Linear(n_poses - 6, 1)

    def forward(self, poses: torch.Tensor, in_text=None) -> torch.Tensor:
        x = self.pre_conv(poses.transpose(1, 2))              # (B, 8, T - 6)
        out, _ = self.gru(x.transpose(1, 2))                  # (T - 6, B, 2H)
        out = self.out(L.sum_bidirectional(out, self.hidden_size))[..., 0]
        return torch.sigmoid(self.out2(out.t()))              # (B, 1)


# The abl_aff ablation's discriminator is the same network
# (net/multimodal_context_net_v2_abl_aff.py:394-439).
ConvDiscriminator = ConvDiscriminatorTriModal
