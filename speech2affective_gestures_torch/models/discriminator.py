"""The discriminators (reference net/multimodal_context_net_v2.py):

- `AffDiscriminator`, the s2ag D (:549-585): ST-GCN AffEncoder -> 4-layer
  bi-GRU(64) with summed directions -> per-frame Linear -> Linear(T -> 1)
  -> sigmoid;
- `ConvDiscriminatorTriModal` (:390-435), which is also the abl_aff
  ablation's `ConvDiscriminator` (net/multimodal_context_net_v2_abl_aff.py
  :394-439): three unpadded Conv1d (T -> T - 6) -> the same bi-GRU and
  heads, the last over T - 6 frames;
- `AffDiscriminatorV1`, the v1 pipeline's emotion-conditioned D
  (net/multimodal_context_net_v1.py:363-463);
- `DiscriminatorTriModal` (:346-387): the poses, with the text's features
  a frame when given, through a 4-layer bi-GRU(300) with summed
  directions -> per-frame Linear -> Linear(T -> 1) -> sigmoid.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from . import layers as L
from .encoders import AffEncoder, bone_graphs, channel_major, regroup_body_parts
from .stgcn import STGraphConv


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


class DiscriminatorTriModal(nn.Module):
    """poses (B, T, pose_dim), text_feat (B, T, text_size) or None -> (B, 1)
    in (0, 1) (JAX `models/discriminator.py:123-144`): `text_size` is the
    width of the text features concatenated to the poses (0 for none). The
    reference's GRU dropout is `dropout_prob`, 0.3."""

    def __init__(self, pose_dim: int = C.POSE_DIM, n_poses: int = C.N_POSES,
                 hidden_size: int = 300, n_layers: int = 4, dropout_prob: float = 0.3,
                 text_size: int = 0):
        super().__init__()
        self.hidden_size, self.text_size = hidden_size, text_size
        self.gru = L.GRU(pose_dim + text_size, hidden_size, num_layers=n_layers,
                         bidirectional=True, dropout=dropout_prob)
        self.out = nn.Linear(hidden_size, 1)
        self.out2 = nn.Linear(n_poses, 1)

    def forward(self, poses: torch.Tensor, text_feat: torch.Tensor | None = None):
        if (text_feat is None) != (self.text_size == 0):
            raise ValueError(f"DiscriminatorTriModal(text_size={self.text_size}) takes "
                             f"{'no ' if self.text_size == 0 else ''}text_feat")
        x = poses if text_feat is None else torch.cat([poses, text_feat.to(poses)], dim=-1)
        out, _ = self.gru(x)                                  # (T, B, 2H)
        out = self.out(L.sum_bidirectional(out, self.hidden_size))[..., 0]
        return torch.sigmoid(self.out2(out.t()))              # (B, 1)


# The abl_aff ablation's discriminator is the same network
# (net/multimodal_context_net_v2_abl_aff.py:394-439).
ConvDiscriminator = ConvDiscriminatorTriModal


class AffDiscriminatorV1(nn.Module):
    """poses (B, T, pose_dim), in_emo_labels (B, num_emotions) -> (B, 1) in
    (0, 1) (JAX `models/discriminator.py:77-120`): the AffEncoder's two
    ST-GCN blocks without its per-node batch norms, conv1 / batch_norm1 /
    ReLU and conv2 / batch_norm2 / ReLU over T, the emotion one-hot
    concatenated to every frame, a 4-layer bi-GRU with summed directions,
    the per-frame Linear and Linear(T -> 1), sigmoid. The reference fixes
    the GRU's dropout at 0.3; `dropout_prob` lets tests set it to zero."""

    def __init__(self, num_emotions: int = 7, n_poses: int = C.N_POSES,
                 hidden_size: int = 64, dropout_prob: float = 0.3, coords: int = 3):
        super().__init__()
        self.hidden_size, self.coords = hidden_size, coords
        a1, a2 = bone_graphs()
        self.register_buffer("a1", a1, persistent=False)
        self.register_buffer("a2", a2, persistent=False)
        n_parts = len(C.BODY_PARTS_EDGE_IDX)
        part = len(C.BODY_PARTS_EDGE_IDX[0])
        self.st_gcn1 = STGraphConv(coords, 16, a1.shape[0], (9, 5), padding=(4, 2))
        self.st_gcn2 = STGraphConv(16 * part, 16, a2.shape[0], (9, 3), padding=(4, 1))
        self.conv1 = nn.Conv1d(16 * n_parts, 16, 5, padding=2)
        self.batch_norm1 = L.BatchNorm1d(16)
        self.conv2 = nn.Conv1d(16, 8, 3, padding=1)
        self.batch_norm2 = L.BatchNorm1d(8)
        self.gru = L.GRU(8 + num_emotions, hidden_size, num_layers=4, bidirectional=True,
                         dropout=dropout_prob)
        self.out = nn.Linear(hidden_size, 1)
        self.out2 = nn.Linear(n_poses, 1)

    def forward(self, poses: torch.Tensor, in_emo_labels: torch.Tensor,
                in_text=None) -> torch.Tensor:
        b, t, jc = poses.shape
        x = poses.view(b, t, jc // self.coords, self.coords).permute(0, 3, 1, 2)
        feat1 = self.st_gcn1(x.contiguous(), self.a1)               # (B, 16, T, 9)
        feat2 = self.st_gcn2(regroup_body_parts(feat1), self.a2)    # (B, 16, T, 3)
        y = torch.relu(self.batch_norm1(self.conv1(channel_major(feat2))))
        y = torch.relu(self.batch_norm2(self.conv2(y)))             # (B, 8, T)
        emo = in_emo_labels.to(y)[:, :, None].expand(-1, -1, t)
        out, _ = self.gru(torch.cat([y, emo], dim=1).transpose(1, 2))  # (T, B, 2H)
        out = self.out(L.sum_bidirectional(out, self.hidden_size))[..., 0]
        return torch.sigmoid(self.out2(out.t()))                    # (B, 1)
