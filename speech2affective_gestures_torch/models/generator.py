"""Pose generators (reference net/multimodal_context_net_v2.py:247-546 and
the ablations' net/multimodal_context_net_v2_abl_audio.py, ..._abl_aff.py).

The s2ag generator: AffEncoder(seed poses) + MFCCEncoder + TextEncoderTCN +
speaker z -> 4-layer bi-GRU(300) with summed directions -> Linear 300 ->
150 -> pose_dim. Its ablations: `audio_encoder_type="wav"` (abl_audio)
swaps the MFCCEncoder for a WavEncoder on the raw audio window, and
`use_aff_encoder=False` (abl_aff) feeds the seed poses with their
constraint bit raw. The TriModal baseline, the frozen comparator of
training: the seed poses + WavEncoder + TextEncoderTCN + speaker z through
the same GRU and head.

Both take the JAX package's `input_context` (which of the audio and text
encoders run: "both", "audio", "text" or "none") and `z_type` (the latent
appended to every frame: "speaker", "random" or "none"). The per-frame
inputs are concatenated as (seed features, audio, text, z), so the GRU's
input width is the sum of the parts present.

Under `z_type="speaker"`, z = mu + eps * exp(0.5 log_var) from the speaker
embedding; under "random", z is the noise eps itself (mu and log_var are
None); under "none" there is no z. The forward takes `eps` (B, z_size) so
that a caller can hand in noise drawn elsewhere (the tests hand in the JAX
package's); without it, eps is drawn from the passed `torch.Generator`.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import constants as C
from ..config import ModelConfig
from ..device import resolve_device
from . import layers as L
from .encoders import AffEncoder, MFCCEncoder, TextEncoderTCN, WavEncoder

INPUT_CONTEXTS = ("both", "audio", "text", "none")
Z_TYPES = ("speaker", "random", "none")
VARIANTS = ("s2ag", "abl_audio", "abl_aff")


def re_parametrize(mu: torch.Tensor, log_var: torch.Tensor,
                   eps: torch.Tensor) -> torch.Tensor:
    """z = mu + eps * exp(0.5 log_var); ref net/embedding_net.py:10-13."""
    return mu + eps * torch.exp(0.5 * log_var)


def _check_choice(name: str, value: str, choices) -> None:
    if value not in choices:
        raise ValueError(f"{name}={value!r}: expected one of {choices}")


class _GRUGenerator(nn.Module):
    """What both generators share: the text encoder (when the input context
    has text), the speaker z modules (under `z_type="speaker"`), the bi-GRU
    with summed directions and the per-frame head, under the reference's
    state dict names. Subclasses build the seed and audio encoders and
    `features(...)`, the per-frame inputs ahead of the text's; `pre_size`
    is the width of their seed features."""

    def __init__(self, pre_size: int, pose_dim: int, n_words: int,
                 word_embed_size: int, hidden_size: int, n_layers: int,
                 dropout_prob: float, emb_dropout: float, n_speakers: int,
                 z_size: int, head_slope: float, input_context: str, z_type: str,
                 word_embeddings=None, freeze_embedding: bool = False):
        super().__init__()
        _check_choice("input_context", input_context, INPUT_CONTEXTS)
        _check_choice("z_type", z_type, Z_TYPES)
        self.hidden_size = hidden_size
        self.z_size = z_size
        self.input_context, self.z_type = input_context, z_type
        self.uses_audio = input_context in ("both", "audio")
        self.text_encoder = None
        if input_context in ("both", "text"):
            self.text_encoder = TextEncoderTCN(
                n_words, word_embed_size, hidden_size, n_layers,
                dropout=dropout_prob, emb_dropout=emb_dropout,
                word_embeddings=word_embeddings, freeze_embedding=freeze_embedding)
        if z_type == "speaker":
            # the reference's speaker z modules, under its state dict names
            self.speaker_embedding = nn.Sequential(
                nn.Embedding(n_speakers, z_size), nn.Linear(z_size, z_size))
            self.speaker_mu = nn.Linear(z_size, z_size)
            self.speaker_log_var = nn.Linear(z_size, z_size)
        in_size = (pre_size + 32 * self.uses_audio + 32 * (self.text_encoder is not None)
                   + z_size * (z_type != "none"))
        self.gru = L.GRU(in_size, hidden_size, num_layers=n_layers,
                         bidirectional=True, dropout=dropout_prob)
        self.out = nn.Sequential(
            nn.Linear(hidden_size, hidden_size // 2),
            nn.Identity() if head_slope == 1.0 else nn.LeakyReLU(head_slope),
            nn.Linear(hidden_size // 2, pose_dim))

    @property
    def n_speakers(self) -> int | None:
        """The speaker embedding's size; None without one (its ids unused)."""
        if self.z_type != "speaker":
            return None
        return self.speaker_embedding[0].num_embeddings

    @staticmethod
    def _noise(shape, like: torch.Tensor, eps: torch.Tensor | None,
               generator: torch.Generator | None) -> torch.Tensor:
        """eps, or a draw of `shape` from `generator` on the generator's
        own device, at `like`'s dtype and device."""
        if eps is None:
            gen_device = generator.device if generator is not None else like.device
            eps = torch.randn(shape, generator=generator, device=gen_device)
        return eps.to(like)

    def speaker_z(self, vid_indices: torch.Tensor, eps: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
        """Speaker latent (ref :465-477, 509-522): (z, mu, log_var), eps at
        mu's dtype: bf16 under mixed precision, where JAX draws the noise in
        mu's dtype (generator.py:31)."""
        h = self.speaker_embedding(vid_indices)
        mu = self.speaker_mu(h)
        log_var = self.speaker_log_var(h)
        return re_parametrize(mu, log_var, self._noise(mu.shape, mu, eps, generator)), \
            mu, log_var

    def latent(self, feat: torch.Tensor, vid_indices, eps, generator):
        """(z, mu, log_var) by `z_type`: the speaker z; the noise itself
        (JAX draws it from its 'noise' stream, generator.py:124-127) with
        mu and log_var None; or all None."""
        if self.z_type == "speaker":
            return self.speaker_z(vid_indices, eps, generator)
        if self.z_type == "random":
            return self._noise((feat.shape[0], self.z_size), feat, eps, generator), None, None
        return None, None, None

    def features(self, pre_seq, in_audio) -> list[torch.Tensor]:
        raise NotImplementedError

    def forward(self, pre_seq, in_text, in_audio, vid_indices=None,
                eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        feats = self.features(pre_seq, in_audio)
        if self.text_encoder is not None:
            feats.append(self.text_encoder(in_text)[0])
        z, z_mu, z_log_var = self.latent(feats[0], vid_indices, eps, generator)
        if z is not None:
            feats.append(z[:, None, :].expand(-1, pre_seq.shape[1], -1))
        # time-major from the GRU through the per-frame head; only the final
        # (T, B, pose_dim) tensor is transposed back
        out, _ = self.gru(torch.cat(feats, dim=-1))
        out = self.out(L.sum_bidirectional(out, self.hidden_size))
        return out.transpose(0, 1), z, z_mu, z_log_var


class PoseGenerator(_GRUGenerator):
    """The s2ag generator (ref :438-546) and its ablations. forward(pre_seq
    (B, T, pose_dim+1), in_text (B, T) ids, in_audio, vid_indices (B,), eps
    (B, z_size) or None, generator) -> (out_dir_vec (B, T, pose_dim), z,
    z_mu, z_log_var). in_audio is the MFCCs (B, 37, 71), or with
    `audio_encoder_type="wav"` (abl_audio) the raw audio window (B, L).
    With `use_aff_encoder=False` (abl_aff) the seed poses and their
    constraint bit go to the GRU as they are (pose_dim + 1 features, no
    AffEncoder)."""

    def __init__(self, pose_dim: int = C.POSE_DIM, n_words: int = 1000,
                 word_embed_size: int = 300, mfcc_length: int = C.MFCC_LENGTH,
                 num_mfcc: int = C.NUM_MFCC_COMBINED,
                 time_steps: int = C.N_POSES, hidden_size: int = 300,
                 n_layers: int = 4, dropout_prob: float = 0.3,
                 emb_dropout: float = 0.1, n_speakers: int = 1, z_size: int = 16,
                 word_embeddings=None, freeze_embedding: bool = False,
                 input_context: str = "both", z_type: str = "speaker",
                 audio_encoder_type: str = "mfcc", use_aff_encoder: bool = True):
        _check_choice("audio_encoder_type", audio_encoder_type, ("mfcc", "wav"))
        # nn.LeakyReLU(inplace=True) in the reference's head: slope 0.01
        super().__init__(8 if use_aff_encoder else pose_dim + 1, pose_dim, n_words,
                         word_embed_size, hidden_size, n_layers, dropout_prob,
                         emb_dropout, n_speakers, z_size, 0.01, input_context, z_type,
                         word_embeddings, freeze_embedding)
        self.aff_encoder = AffEncoder() if use_aff_encoder else None
        self.audio_encoder = None
        if self.uses_audio:
            self.audio_encoder = (MFCCEncoder(mfcc_length, num_mfcc, time_steps)
                                  if audio_encoder_type == "mfcc" else WavEncoder())

    def features(self, pre_seq, in_audio):
        feats = [pre_seq if self.aff_encoder is None else self.aff_encoder(pre_seq[..., :-1])]
        if self.audio_encoder is not None:
            feats.append(self.audio_encoder(in_audio))
        return feats


class PoseGeneratorTriModal(_GRUGenerator):
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
                 word_embeddings=None, freeze_embedding: bool = False,
                 input_context: str = "both", z_type: str = "speaker"):
        super().__init__(pose_dim + 1, pose_dim, n_words, word_embed_size,
                         hidden_size, n_layers, dropout_prob, emb_dropout,
                         n_speakers, z_size, 1.0, input_context, z_type,
                         word_embeddings, freeze_embedding)
        self.audio_encoder = WavEncoder() if self.uses_audio else None

    def features(self, pre_seq, in_audio):
        feats = [pre_seq]
        if self.audio_encoder is not None:
            feats.append(self.audio_encoder(in_audio))
        return feats


def make_pose_generator(cfg: ModelConfig, n_words: int, n_speakers: int,
                        variant: str = "s2ag", word_embeddings=None) -> PoseGenerator:
    """The generator of `variant` ("s2ag", "abl_audio" or "abl_aff") at the
    config's widths, input context and z type (JAX train/builder.py:22-48),
    with torch's default initialization."""
    _check_choice("variant", variant, VARIANTS)
    return PoseGenerator(
        n_words=n_words, word_embed_size=cfg.wordembed_dim,
        mfcc_length=cfg.mfcc_length, num_mfcc=cfg.num_mfcc_combined,
        time_steps=cfg.n_poses, hidden_size=cfg.hidden_size_s2eg,
        n_layers=cfg.n_layers, dropout_prob=cfg.dropout_prob, n_speakers=n_speakers,
        word_embeddings=word_embeddings, freeze_embedding=cfg.freeze_wordembed,
        input_context=cfg.input_context, z_type=cfg.z_type,
        audio_encoder_type="wav" if variant == "abl_audio" else "mfcc",
        use_aff_encoder=variant != "abl_aff")


def build_generator(cfg: ModelConfig, n_words: int, n_speakers: int,
                    device: str | torch.device | None = None,
                    seed: int = 0, variant: str = "s2ag") -> PoseGenerator:
    """The generator of `variant` at the config's widths
    (`make_pose_generator`), with random weights drawn from `seed`, in eval
    mode on `device` (the card unless `device="cpu"`)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = make_pose_generator(cfg, n_words, n_speakers, variant)
    return gen.to(dev).eval()
