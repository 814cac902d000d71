"""The gesture-embedding autoencoder (reference `net/embedding_net.py`, as
the JAX package's `models/embedding_net.py` rebuilt it):

- `EmbeddingNet(mode="pose")`, the FGD evaluator's: a conv pose encoder to
  a 32-d latent with VAE heads and a conv decoder back to poses;
- `EmbeddingNet(mode="speech")` and `mode="random"`: a `ContextEncoder`
  (the text TCN and the raw-audio WavEncoder, a 2-layer GRU of 256, its
  last frame through 128 -> BN -> 32 to VAE heads) beside the pose
  encoder, and `PoseDecoderGRU` (the seed poses and the latent through a
  4-layer bi-GRU of 300) as the decoder; speech decodes the context's
  latent, random the context's or the poses' with even odds;
- `PoseDecoderFC`, the reference's other decoder, with and without seed
  poses.

Module names are the reference's state-dict keys, so the reference's
`outputs/embedding_net.pth.tar` loads with `strict=True`. Torch is
channel-first, so the encoder's flatten in (C, T') order and the decoder's
`view(B, 4, T')` are the natural ones. The reference's `nn.LeakyReLU(True)`
has slope 1.0, the identity: those sites are `nn.Identity`, which keeps the
Sequential indices. The reparametrization's noise and the random mode's
pick are handed in or drawn from an explicit `torch.Generator`; the GRUs
run `ops/gru_cuda.py`'s kernels on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from . import layers as L
from .encoders import TextEncoderTCN, WavEncoder
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


def _draw_device(generator: torch.Generator | None, like: torch.Tensor | None):
    """Where a draw from `generator` is made: its own device; without one,
    `like`'s (the CPU without either)."""
    if generator is not None:
        return generator.device
    return None if like is None else like.device


def _pre_pose_net(pose_dim: int) -> nn.Sequential:
    """The seed poses (B, 4, pose_dim), flattened, -> 32 (ref :97-102)."""
    return nn.Sequential(nn.Linear(pose_dim * 4, 32), nn.BatchNorm1d(32), nn.ReLU(),
                         nn.Linear(32, 32))


class PoseDecoderFC(nn.Module):
    """32-d latent (and with `use_pre_poses` the seed poses) -> poses (B,
    gen_length, pose_dim) through Linear/BN/ReLU blocks of 128, 128, 256
    and 512 (ref net/embedding_net.py:85-127)."""

    def __init__(self, gen_length: int, pose_dim: int, use_pre_poses: bool = False):
        super().__init__()
        self.gen_length, self.pose_dim = gen_length, pose_dim
        self.pre_pose_net = _pre_pose_net(pose_dim) if use_pre_poses else None
        blocks, width = [], 32 + 32 * use_pre_poses
        for out in (128, 128, 256, 512):
            blocks += [nn.Linear(width, out), nn.BatchNorm1d(out), nn.ReLU()]
            width = out
        self.net = nn.Sequential(*blocks, nn.Linear(width, gen_length * pose_dim))

    def forward(self, latent: torch.Tensor, pre_poses: torch.Tensor | None = None):
        feat = latent
        if self.pre_pose_net is not None:
            feat = torch.cat([self.pre_pose_net(pre_poses.flatten(1)), latent], dim=1)
        return self.net(feat).view(-1, self.gen_length, self.pose_dim)


class PoseDecoderGRU(nn.Module):
    """32-d latent and the seed poses -> poses (B, gen_length, pose_dim):
    the seed poses' 32 features and the latent on every frame, a 4-layer
    bi-GRU of `hidden_size` (dropout 0.3) with summed directions, Linear
    300 -> 150, the identity (`nn.LeakyReLU(True)`), Linear 150 -> pose_dim
    (ref net/embedding_net.py:130-162)."""

    def __init__(self, gen_length: int = C.N_POSES, pose_dim: int = C.POSE_DIM,
                 hidden_size: int = 300):
        super().__init__()
        self.gen_length, self.hidden_size = gen_length, hidden_size
        self.pre_pose_net = _pre_pose_net(pose_dim)
        self.gru = L.GRU(64, hidden_size, num_layers=4, bidirectional=True, dropout=0.3)
        self.out = nn.Sequential(nn.Linear(hidden_size, hidden_size // 2), nn.Identity(),
                                 nn.Linear(hidden_size // 2, pose_dim))

    def forward(self, latent: torch.Tensor, pre_poses: torch.Tensor) -> torch.Tensor:
        feat = torch.cat([self.pre_pose_net(pre_poses.flatten(1)), latent], dim=1)
        out, _ = self.gru(feat[:, None, :].expand(-1, self.gen_length, -1))  # (T, B, 2H)
        return self.out(L.sum_bidirectional(out, self.hidden_size)).transpose(0, 1)


class ContextEncoder(nn.Module):
    """Word ids (B, T) and the raw audio window (B, L) -> 32-d (z, mu,
    log_var) (ref net/embedding_net.py:220-259): the WavEncoder's and the
    text TCN's 32 features a frame, a 2-layer GRU of 256, its last frame
    through Linear 128 -> BN -> ReLU -> Linear 32, the VAE heads, z drawn
    with `eps` (B, 32) or from `generator`."""

    def __init__(self, n_words: int, word_embed_size: int = 300, hidden_size: int = 300,
                 n_layers: int = 4, word_embeddings=None):
        super().__init__()
        self.text_encoder = TextEncoderTCN(n_words, word_embed_size, hidden_size, n_layers,
                                           word_embeddings=word_embeddings)
        self.audio_encoder = WavEncoder()
        self.gru = L.GRU(64, 256, num_layers=2)
        self.out = nn.Sequential(nn.Linear(256, 128), nn.BatchNorm1d(128), nn.ReLU(),
                                 nn.Linear(128, 32))
        self.fc_mu = nn.Linear(32, 32)
        self.fc_log_var = nn.Linear(32, 32)

    def forward(self, in_text: torch.Tensor, in_audio: torch.Tensor,
                eps: torch.Tensor | None = None, generator: torch.Generator | None = None):
        text_feat, _ = self.text_encoder(in_text)
        x = torch.cat([self.audio_encoder(in_audio), text_feat], dim=-1)
        out, _ = self.gru(x)                                  # (T, B, 256)
        h = self.out(out[-1])
        mu, log_var = self.fc_mu(h), self.fc_log_var(h)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator, device=_draw_device(generator, mu))
        return re_parametrize(mu, log_var, eps.to(mu)), mu, log_var


MODES = ("pose", "speech", "random")


class EmbeddingNet(nn.Module):
    """The autoencoder (ref net/embedding_net.py:262-308). mode "pose", the
    FGD configuration: the pose encoder and the conv decoder. "speech" and
    "random": the context encoder beside the pose encoder, and the GRU
    decoder."""

    def __init__(self, pose_dim: int = C.POSE_DIM, n_frames: int = C.N_POSES,
                 mode: str = "pose", n_words: int = 1000, word_embed_size: int = 300,
                 word_embeddings=None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode={mode!r}: expected one of {MODES}")
        self.mode = mode
        self.context_encoder = None
        if mode != "pose":
            self.context_encoder = ContextEncoder(n_words, word_embed_size,
                                                  word_embeddings=word_embeddings)
        self.pose_encoder = PoseEncoderConv(n_frames, pose_dim)
        self.decoder = (PoseDecoderConv(n_frames, pose_dim) if mode == "pose"
                        else PoseDecoderGRU(n_frames, pose_dim))

    def forward(self, poses: torch.Tensor | None, eps: torch.Tensor | None = None, *,
                in_text: torch.Tensor | None = None, in_audio: torch.Tensor | None = None,
                pre_poses: torch.Tensor | None = None, input_mode: str | None = None,
                context_eps: torch.Tensor | None = None, pick_speech: bool | None = None,
                generator: torch.Generator | None = None):
        """Mode "pose": poses (B, T, dim) -> (feat, mu, log_var,
        reconstruction (B, T, dim)); feat = mu unless `eps` is given
        (variational encoding).

        Modes "speech" and "random" (JAX's contract): -> (context z, mu,
        log_var, poses' feat, mu, log_var, decoded poses (B, T, dim)), the
        context's z drawn with `context_eps` or from `generator`, the pose
        encoder's parts None without `poses`. `input_mode` overrides which
        latent is decoded ("speech", "pose" or "random"); under "random" the
        context's with probability 1/2, `pick_speech` or a draw from
        `generator`."""
        if self.mode == "pose":
            feat, mu, log_var = self.pose_encoder(poses, eps)
            return feat, mu, log_var, self.decoder(feat)
        context = (None, None, None)
        if in_text is not None and in_audio is not None:
            context = self.context_encoder(in_text, in_audio, context_eps, generator)
        pose = (None, None, None)
        if poses is not None:
            pose = self.pose_encoder(poses, eps)
        mode = input_mode or self.mode
        if mode == "random":
            if pick_speech is None:
                draw = torch.rand((), generator=generator, device=_draw_device(generator, None))
                pick_speech = bool(draw < 0.5)
            mode = "speech" if pick_speech else "pose"
        latent = context[0] if mode == "speech" else pose[0]
        return (*context, *pose, self.decoder(latent, pre_poses))
