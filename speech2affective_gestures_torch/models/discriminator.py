"""The s2ag discriminator (reference net/multimodal_context_net_v2.py
:549-585): ST-GCN AffEncoder -> 4-layer bi-GRU(64) with summed directions
-> per-frame Linear -> Linear(T -> 1) -> sigmoid."""

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
