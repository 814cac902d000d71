"""Modality encoders of the s2ag models (reference
`net/multimodal_context_net_v2.py:14-175`): WavEncoder, MFCCEncoder,
TextEncoderTCN and the two-stage ST-GCN AffEncoder. Module names follow the
reference's state dict keys."""

from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from ..ops import graph as graph_ops
from .layers import Dropout, leaky_relu
from .stgcn import STGraphConv
from .tcn import TemporalConvNet


class WavEncoder(nn.Module):
    """Raw-waveform conv stack: (B, L) -> (B, 34, 32) for the 36267-sample
    window (ref net/multimodal_context_net_v2.py:14-33)."""

    def __init__(self):
        super().__init__()
        self.feat_extractor = nn.Sequential(
            nn.Conv1d(1, 16, 15, stride=5, padding=1600),
            nn.BatchNorm1d(16), nn.LeakyReLU(0.3),
            nn.Conv1d(16, 32, 15, stride=6),
            nn.BatchNorm1d(32), nn.LeakyReLU(0.3),
            nn.Conv1d(32, 64, 15, stride=6),
            nn.BatchNorm1d(64), nn.LeakyReLU(0.3),
            nn.Conv1d(64, 32, 15, stride=6),
        )

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.feat_extractor(wav[:, None]).transpose(1, 2)


class MFCCEncoder(nn.Module):
    """MFCC conv stack: (B, 37 coefficients, 71 frames) -> (B, time_steps, 32).

    The convs run over the 37-coefficient axis with the 71 frames as
    channels (the reference permutes to that layout, :53), so the input is
    transposed to torch's (B, C=71, W=37); conv4 emits time_steps channels,
    and a per-step Linear(37 -> 32) follows."""

    def __init__(self, mfcc_length: int = C.MFCC_LENGTH,
                 num_mfcc: int = C.NUM_MFCC_COMBINED, time_steps: int = C.N_POSES):
        super().__init__()
        self.conv1 = nn.Conv1d(mfcc_length, 64, 5, padding=2)
        self.batch_norm1 = nn.BatchNorm1d(64)
        self.conv2 = nn.Conv1d(64, 64, 5, padding=2)
        self.batch_norm2 = nn.BatchNorm1d(64)
        self.conv3 = nn.Conv1d(64, 48, 3, padding=1)
        self.batch_norm3 = nn.BatchNorm1d(48)
        self.conv4 = nn.Conv1d(48, time_steps, 3, padding=1)
        self.batch_norm4 = nn.BatchNorm1d(time_steps)
        self.linear1 = nn.Linear(num_mfcc, 32)

    def forward(self, mfcc: torch.Tensor) -> torch.Tensor:
        x = mfcc.transpose(1, 2)                         # (B, 71, 37)
        for i in range(1, 5):
            conv = getattr(self, f"conv{i}")
            bn = getattr(self, f"batch_norm{i}")
            x = leaky_relu(bn(conv(x)), 0.3)
        # (B, time_steps, 37): per-step linear over the coefficient axis
        return leaky_relu(self.linear1(x), 0.3)


class TextEncoderTCN(nn.Module):
    """Word ids (B, T) -> (B, T, 32): embedding, dropout, dilated causal TCN,
    Linear (ref net/multimodal_context_net_v2.py:61-91). `word_embeddings`
    (n_words, embed_size), when given, is the embedding's initial table
    (the vocabulary's word vectors); `freeze_embedding` keeps it fixed."""

    def __init__(self, n_words: int, embed_size: int = 300, hidden_size: int = 300,
                 n_layers: int = 4, kernel_size: int = 2, dropout: float = 0.3,
                 emb_dropout: float = 0.1, word_embeddings=None,
                 freeze_embedding: bool = False):
        super().__init__()
        self.embedding = nn.Embedding(n_words, embed_size)
        if word_embeddings is not None:
            with torch.no_grad():
                self.embedding.weight.copy_(torch.as_tensor(word_embeddings))
        self.embedding.weight.requires_grad_(not freeze_embedding)
        self.emb_drop = Dropout(emb_dropout)
        self.tcn = TemporalConvNet(embed_size, (hidden_size,) * n_layers,
                                   kernel_size, dropout)
        self.decoder = nn.Linear(hidden_size, 32)
        nn.init.normal_(self.decoder.weight, 0.0, 0.01)   # ref :83-85
        nn.init.zeros_(self.decoder.bias)

    def forward(self, ids: torch.Tensor):
        emb = self.emb_drop(self.embedding(ids))          # (B, T, E)
        y = self.tcn(emb.transpose(1, 2))                 # (B, H, T)
        return self.decoder(y.transpose(1, 2)), 0


def _per_node_batchnorm(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """BatchNorm1d(C*V) over flattened (channel, node) pairs, index
    ch*V + node (ref net/multimodal_context_net_v2.py:159-160)."""
    b, c, t, v = x.shape
    return bn(_channel_major(x)).view(b, c, v, t).permute(0, 1, 3, 2)


def _channel_major(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, V) -> (B, C*V, T) with index ch*V + node."""
    b, c, t, v = x.shape
    return x.permute(0, 1, 3, 2).reshape(b, c * v, t)


class AffEncoder(nn.Module):
    """Two-stage ST-GCN pose encoder: (B, T, 27) -> (B, T, 8).

    Stage 1 over the 9-bone graph, regroup into 3 body parts (channel-major
    flatten of each part's 3 bones), stage 2 over the body-part graph, then
    two temporal convs (ref net/multimodal_context_net_v2.py:94-175)."""

    def __init__(self, coords: int = 3):
        super().__init__()
        self.coords = coords
        a1 = graph_ops.build_adjacency(C.NUM_BONES, list(C.DIR_EDGE_PAIRS),
                                       "spatial", max_hop=2)
        a2 = graph_ops.build_adjacency(len(C.BODY_PARTS_EDGE_IDX),
                                       list(C.BODY_PARTS_EDGE_PAIRS),
                                       "spatial", max_hop=2)
        # constants, not state: kept out of the state dict
        self.register_buffer("a1", torch.tensor(a1, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("a2", torch.tensor(a2, dtype=torch.float32),
                             persistent=False)
        n_parts = len(C.BODY_PARTS_EDGE_IDX)
        part = len(C.BODY_PARTS_EDGE_IDX[0])
        self.st_gcn1 = STGraphConv(coords, 16, a1.shape[0], (9, 5), padding=(4, 2))
        self.st_gcn2 = STGraphConv(16 * part, 16, a2.shape[0], (9, 3), padding=(4, 1))
        self.batch_norm1 = nn.BatchNorm1d(16 * C.NUM_BONES)
        self.batch_norm2 = nn.BatchNorm1d(16 * n_parts)
        self.conv3 = nn.Conv1d(16 * n_parts, 16, 5, padding=2)
        self.batch_norm3 = nn.BatchNorm1d(16)
        self.conv4 = nn.Conv1d(16, 8, 3, padding=1)
        self.batch_norm4 = nn.BatchNorm1d(8)

    def forward(self, poses: torch.Tensor) -> torch.Tensor:
        b, t, jc = poses.shape
        # contiguous: the permuted view is channels-last in memory, so the
        # residual's 1x1 conv would emit channels-last output, and torch's
        # CPU batch norm sums a channels-last input in per-thread partials
        # whose order follows the thread count. The seed poses are zero at
        # 30 of 34 frames, so that batch norm's mean is large against its
        # deviation and the order moved its output by up to 4e-5 of its
        # largest value; in NCHW the statistics do not depend on threads.
        x = poses.view(b, t, jc // self.coords, self.coords).permute(0, 3, 1, 2)
        feat1 = self.st_gcn1(x.contiguous(), self.a1)           # (B, 16, T, 9)
        feat1 = _per_node_batchnorm(feat1, self.batch_norm1)
        # body parts: (B, 16*3, T, 3), channel index ch*3 + bone-in-part
        feat2_in = torch.stack(
            [_channel_major(feat1[..., list(idx)]) for idx in C.BODY_PARTS_EDGE_IDX],
            dim=-1)
        feat2 = self.st_gcn2(feat2_in, self.a2)                 # (B, 16, T, 3)
        feat2 = _per_node_batchnorm(feat2, self.batch_norm2)
        y = leaky_relu(self.batch_norm3(self.conv3(_channel_major(feat2))), 0.01)
        y = leaky_relu(self.batch_norm4(self.conv4(y)), 0.01)
        return y.transpose(1, 2)                                # (B, T, 8)
