"""Pose generators (reference net/multimodal_context_net_v2.py:247-546).

The s2ag generator: AffEncoder(seed poses) + MFCCEncoder + TextEncoderTCN +
speaker z -> 4-layer bi-GRU(300) with summed directions -> Linear 300 ->
150 -> pose_dim. The TriModal baseline, the frozen comparator of training:
the seed poses + WavEncoder + TextEncoderTCN + speaker z through the same
GRU and head.

The speaker z is mu + eps * exp(0.5 log_var). The forward takes `eps`
(B, z_size) so that a caller can hand in noise drawn elsewhere (the tests
hand in the JAX package's); without it, eps is drawn from the passed
`torch.Generator`.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from ..config import ModelConfig
from ..device import resolve_device
from . import layers as L
from .encoders import AffEncoder, MFCCEncoder, TextEncoderTCN, WavEncoder


def re_parametrize(mu: torch.Tensor, log_var: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + eps * exp(0.5 log_var); ref net/embedding_net.py:10-13."""
    return mu + eps * torch.exp(0.5 * log_var)


class _SpeakerGRUGenerator(nn.Module):
    """What both generators share: the text encoder, the speaker z, the
    bi-GRU with summed directions and the per-frame head, under the
    reference's state dict names. Subclasses build the other encoders and
    `features(...)`, the per-frame inputs ahead of z."""

    def __init__(self, feat_size: int, pose_dim: int, n_words: int,
                 word_embed_size: int, hidden_size: int, n_layers: int,
                 dropout_prob: float, emb_dropout: float, n_speakers: int,
                 z_size: int, head_slope: float, word_embeddings=None,
                 freeze_embedding: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.z_size = z_size
        self.text_encoder = TextEncoderTCN(
            n_words, word_embed_size, hidden_size, n_layers,
            dropout=dropout_prob, emb_dropout=emb_dropout,
            word_embeddings=word_embeddings, freeze_embedding=freeze_embedding)
        # the reference's speaker z modules, under its state dict names
        self.speaker_embedding = nn.Sequential(
            nn.Embedding(n_speakers, z_size), nn.Linear(z_size, z_size))
        self.speaker_mu = nn.Linear(z_size, z_size)
        self.speaker_log_var = nn.Linear(z_size, z_size)
        self.gru = L.GRU(feat_size + 32 + z_size, hidden_size, num_layers=n_layers,
                         bidirectional=True, dropout=dropout_prob)
        self.out = nn.Sequential(
            nn.Linear(hidden_size, hidden_size // 2),
            nn.Identity() if head_slope == 1.0 else nn.LeakyReLU(head_slope),
            nn.Linear(hidden_size // 2, pose_dim))

    def speaker_z(self, vid_indices: torch.Tensor, eps: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
        """Speaker latent (ref :465-477, 509-522): (z, mu, log_var). Without
        `eps`, it is drawn from `generator` on the generator's own device."""
        h = self.speaker_embedding(vid_indices)
        mu = self.speaker_mu(h)
        log_var = self.speaker_log_var(h)
        if eps is None:
            gen_device = generator.device if generator is not None else mu.device
            eps = torch.randn(mu.shape, generator=generator, device=gen_device)
        # at mu's dtype: bf16 under mixed precision, where JAX draws the
        # noise in mu's dtype (generator.py:31)
        return re_parametrize(mu, log_var, eps.to(mu)), mu, log_var

    def features(self, pre_seq, in_audio) -> list[torch.Tensor]:
        raise NotImplementedError

    def forward(self, pre_seq, in_text, in_audio, vid_indices,
                eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        z, z_mu, z_log_var = self.speaker_z(vid_indices, eps, generator)
        in_data = torch.cat([
            *self.features(pre_seq, in_audio),
            self.text_encoder(in_text)[0],
            z[:, None, :].expand(-1, pre_seq.shape[1], -1),
        ], dim=-1)
        # time-major from the GRU through the per-frame head; only the final
        # (T, B, pose_dim) tensor is transposed back
        out, _ = self.gru(in_data)
        out = self.out(L.sum_bidirectional(out, self.hidden_size))
        return out.transpose(0, 1), z, z_mu, z_log_var


class PoseGenerator(_SpeakerGRUGenerator):
    """The s2ag generator (ref :438-546). forward(pre_seq (B, T,
    pose_dim+1), in_text (B, T) ids, in_mfcc (B, 37, 71), vid_indices (B,),
    eps (B, z_size) or None, generator) -> (out_dir_vec (B, T, pose_dim),
    z, z_mu, z_log_var).

    Both input contexts (audio and text) and the speaker z, the paper's
    configuration; the other `input_context` / `z_type` choices of the JAX
    package are not ported yet."""

    def __init__(self, pose_dim: int = C.POSE_DIM, n_words: int = 1000,
                 word_embed_size: int = 300, mfcc_length: int = C.MFCC_LENGTH,
                 num_mfcc: int = C.NUM_MFCC_COMBINED,
                 time_steps: int = C.N_POSES, hidden_size: int = 300,
                 n_layers: int = 4, dropout_prob: float = 0.3,
                 emb_dropout: float = 0.1, n_speakers: int = 1, z_size: int = 16,
                 word_embeddings=None, freeze_embedding: bool = False):
        # nn.LeakyReLU(inplace=True) in the reference's head: slope 0.01
        super().__init__(8 + 32, pose_dim, n_words, word_embed_size, hidden_size,
                         n_layers, dropout_prob, emb_dropout, n_speakers, z_size,
                         0.01, word_embeddings, freeze_embedding)
        self.aff_encoder = AffEncoder()
        self.audio_encoder = MFCCEncoder(mfcc_length, num_mfcc, time_steps)

    def features(self, pre_seq, in_mfcc):
        return [self.aff_encoder(pre_seq[..., :-1]), self.audio_encoder(in_mfcc)]


class PoseGeneratorTriModal(_SpeakerGRUGenerator):
    """The TriModal baseline (Yoon et al.; ref :247-343), the frozen
    comparator of s2ag training: WavEncoder on the raw audio window, the
    seed poses with their constraint bit fed raw, inputs concatenated as
    (pre_seq, audio, text, z). Its head's nn.LeakyReLU(True) has slope 1.0,
    the identity. forward(pre_seq, in_text, in_audio (B, L), vid_indices,
    eps, generator) -> as PoseGenerator's."""

    def __init__(self, pose_dim: int = C.POSE_DIM, n_words: int = 1000,
                 word_embed_size: int = 300, hidden_size: int = 300,
                 n_layers: int = 4, dropout_prob: float = 0.3,
                 emb_dropout: float = 0.1, n_speakers: int = 1, z_size: int = 16,
                 word_embeddings=None, freeze_embedding: bool = False):
        super().__init__(pose_dim + 1 + 32, pose_dim, n_words, word_embed_size,
                         hidden_size, n_layers, dropout_prob, emb_dropout,
                         n_speakers, z_size, 1.0, word_embeddings,
                         freeze_embedding)
        self.audio_encoder = WavEncoder()

    def features(self, pre_seq, in_audio):
        return [pre_seq, self.audio_encoder(in_audio)]


def build_generator(cfg: ModelConfig, n_words: int, n_speakers: int,
                    device: str | torch.device | None = None,
                    seed: int = 0) -> PoseGenerator:
    """The paper's s2ag generator at the config's widths, with random
    weights drawn from `seed`, in eval mode on `device` (the card unless
    `device="cpu"`)."""
    if cfg.input_context != "both" or cfg.z_type != "speaker":
        raise NotImplementedError(
            f"input_context={cfg.input_context!r}, z_type={cfg.z_type!r}: only "
            "the paper's 'both' / 'speaker' generator is ported")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = PoseGenerator(
            n_words=n_words, word_embed_size=cfg.wordembed_dim,
            mfcc_length=cfg.mfcc_length, num_mfcc=cfg.num_mfcc_combined,
            time_steps=cfg.n_poses, hidden_size=cfg.hidden_size_s2eg,
            n_layers=cfg.n_layers, dropout_prob=cfg.dropout_prob,
            n_speakers=n_speakers)
    return gen.to(dev).eval()
