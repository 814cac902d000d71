"""T2GNet, the text-to-gesture transformer (reference `net/T2GNet.py` and
`net/T2GNet_glove.py`, as the JAX package's `models/t2g.py` rebuilt them):
word tokens through a causal post-LN transformer encoder, the clip's tags
(emotion, polarity, acting task, gender, age, handedness, native tongue)
and the skeleton's bone lengths broadcast onto the text latents as the
decoder's memory, a causal post-LN decoder over the quaternion frames, two
convolutions that mix across time at the full length, and each output
quaternion normalized.

The attention is flax's `MultiHeadDotProductAttention` written out in
tensor ops: q, k and v projections with bias, split into heads, the query
scaled by 1/sqrt(head_dim), the boolean mask applied with the dtype's most
negative value, softmax, dropout on the weights with one mask broadcast
over batch and heads (flax's `broadcast_dropout=True`), then the output
projection. LayerNorm's epsilon is flax's 1e-6. Dropout masks come from
the generator that `layers.dropout_rng` sets.

The reference applies its positional encoding over the batch axis (a bug
in code that never runs there); as in the JAX package, it runs over the
sequence axis here.

Parameters start from flax's initializers (`init_flax_like`): the dense
and attention kernels from a truncated normal of variance 1/fan_in, their
biases zero, the time-mixing convolutions torch's U(+-1/sqrt(fan_in)).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L

LAYER_NORM_EPS = 1e-6   # flax's LayerNorm default


def positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """The sinusoidal table (max_len, d_model), float32; odd widths too."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: d_model // 2])
    return pe


def causal_mask(t: int, device=None) -> torch.Tensor:
    """(t, t) bool, True where a query may attend: keys at or before it."""
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


class MultiHeadAttention(nn.Module):
    """flax `MultiHeadDotProductAttention` with qkv and out features
    d_model: `query`, `key`, `value` and `out` are (d_model, d_model)
    linears, their (heads, head_dim) axes flattened in that order."""

    def __init__(self, d_model: int, num_heads: int, dropout: float):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of num_heads {num_heads}")
        self.num_heads, self.dropout = num_heads, dropout
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, kv: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        b, tq, d = x.shape
        heads = self.num_heads
        q = self.query(x).view(b, tq, heads, d // heads)
        k = self.key(kv).view(b, kv.shape[1], heads, d // heads)
        v = self.value(kv).view(b, kv.shape[1], heads, d // heads)
        q = q / math.sqrt(d // heads)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = torch.where(mask, w, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        if self.training and self.dropout > 0.0:
            # one mask for every batch row and head: its keep / keep_prob
            w = w * L.dropout(w.new_ones((1, 1) + w.shape[-2:]), self.dropout, True)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, tq, d))


class EncoderLayer(nn.Module):
    """Post-LN: x = norm1(x + drop(self_attn(x))); then the feed-forward
    linear1 -> relu -> drop -> linear2, x = norm2(x + drop(ff))."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float = 0.5):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.drop = L.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.drop(self.self_attn(x, x, mask)))
        ff = self.linear2(self.drop(torch.relu(self.linear1(x))))
        return self.norm2(x + self.drop(ff))


class DecoderLayer(nn.Module):
    """Post-LN: masked self-attention, cross-attention over the memory (no
    mask), feed-forward, each added back and normalized."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout: float = 0.5):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.drop = L.Dropout(dropout)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.drop(self.self_attn(x, x, mask)))
        x = self.norm2(x + self.drop(self.cross_attn(x, memory)))
        ff = self.linear2(self.drop(torch.relu(self.linear1(x))))
        return self.norm3(x + self.drop(ff))


class T2GNet(nn.Module):
    """forward(text (B, S) ids, tags [(B, d) per tag_dims], quat (B, T,
    quat_dim) teacher frames, offset_lengths (B, offsets_dim)) ->
    (quaternions normalized per group of quat_channels, pre-norm), each (B,
    T, quat_dim). With `embedding_table` (n_words, text_dim) the word table
    is that frozen buffer (T2GNet_glove's `from_pretrained(freeze=True)`),
    else a trained `text_embedding`. The time-mixing convolutions (`smooth`,
    Conv1d(T_max, T_max, 3) with time as the channel axis) run only when
    T == max_time_steps."""

    def __init__(self, num_tokens: int, max_time_steps: int,
                 embedding_table: np.ndarray | None = None, text_dim: int = 64,
                 quat_dim: int = 64, quat_channels: int = 4, offsets_dim: int = 20,
                 tag_dims: tuple[int, ...] = (7, 3, 2, 2, 4, 2, 3),
                 num_heads_enc: int = 4, num_heads_dec: int = 4,
                 num_hidden_units_enc: int = 256, num_hidden_units_dec: int = 256,
                 num_layers_enc: int = 2, num_layers_dec: int = 2, dropout: float = 0.5):
        super().__init__()
        self.max_time_steps, self.quat_channels = max_time_steps, quat_channels
        if embedding_table is not None:
            table = torch.as_tensor(np.asarray(embedding_table, np.float32))
            text_dim = table.shape[1]
            # a constant, as in the JAX net: not a parameter, not saved
            self.register_buffer("embedding_table", table, persistent=False)
            self.text_embedding = None
        else:
            self.embedding_table = None
            self.text_embedding = nn.Embedding(num_tokens, text_dim)
        self.text_dim, self.quat_dim = text_dim, quat_dim
        self.drop = L.Dropout(dropout)
        self.enc = nn.ModuleList(
            EncoderLayer(text_dim, num_heads_enc, num_hidden_units_enc, dropout)
            for _ in range(num_layers_enc))
        intermediate = (text_dim + quat_dim) // 2
        self.text_embed = nn.Linear(text_dim + sum(tag_dims), intermediate)
        self.text_offsets_to_gestures = nn.Linear(intermediate + offsets_dim, quat_dim)
        self.dec = nn.ModuleList(
            DecoderLayer(quat_dim, num_heads_dec, num_hidden_units_dec, dropout)
            for _ in range(num_layers_dec))
        self.smooth = nn.ModuleList(
            nn.Conv1d(max_time_steps, max_time_steps, 3, padding=1) for _ in range(2))
        self._tables: dict = {}

    def _constants(self, t: int, d: int, like: torch.Tensor):
        """The positional table (t, d) and the causal mask (t, t) on `like`'s
        device and dtype, made once per shape."""
        key = (t, d, like.device, like.dtype)
        if key not in self._tables:
            self._tables[key] = (
                torch.from_numpy(positional_encoding(t, d)).to(like.device, like.dtype),
                causal_mask(t, like.device))
        return self._tables[key]

    def forward(self, text: torch.Tensor, tags, quat: torch.Tensor,
                offset_lengths: torch.Tensor):
        s = text.shape[1]
        if self.embedding_table is not None:
            emb = F.embedding(text.long(), self.embedding_table)
        else:
            emb = self.text_embedding(text.long())
        emb = emb * math.sqrt(self.text_dim)
        pe, mask = self._constants(s, self.text_dim, emb)
        x = self.drop(emb + pe)
        for layer in self.enc:
            x = layer(x, mask)
        tag_feats = [t.to(x)[:, None, :].expand(-1, s, -1) for t in tags]
        text_latent = self.text_embed(torch.cat([x] + tag_feats, dim=-1))
        off = offset_lengths.to(x)[:, None, :].expand(-1, s, -1)
        memory = self.text_offsets_to_gestures(torch.cat([text_latent, off], dim=-1))

        t = quat.shape[1]
        pe_q, mask_q = self._constants(t, self.quat_dim, quat)
        q = self.drop(quat + pe_q)
        for layer in self.dec:
            q = layer(q, memory, mask_q)
        pre_norm = q
        if t == self.max_time_steps:
            for conv in self.smooth:
                pre_norm = conv(pre_norm)
        flat = pre_norm.reshape(-1, self.quat_channels)
        normed = flat / flat.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return normed.view(pre_norm.shape), pre_norm


def init_flax_like(net: nn.Module, generator: torch.Generator) -> None:
    """Draw `net`'s parameters from `generator` by flax's initializers for
    the layers the JAX T2GNet uses: Dense and attention kernels from a
    normal of variance 1/fan_in truncated at two standard deviations, their
    biases zero; LayerNorm scale 1, bias 0; the time-mixing convolutions'
    kernel and bias (the JAX package's torch-style `Conv1d`) from
    U(+-1/sqrt(fan_in)); a trained word table from N(0, 1)."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Linear):
                # flax's variance_scaling(1, fan_in, truncated_normal): the
                # normal's standard deviation so that the truncated one's is
                # sqrt(1/fan_in)
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv1d):
                bound = 1.0 / math.sqrt(m.in_channels * m.kernel_size[0])
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)


def t2g_net_glove(embedding_table: np.ndarray, max_time_steps: int, quat_dim: int = 64,
                  quat_channels: int = 4, offsets_dim: int = 20,
                  tag_dims: tuple[int, ...] = (7, 3, 2, 2, 4, 2, 3), num_heads: int = 4,
                  num_hidden_units: int = 256, num_layers: int = 2,
                  dropout: float = 0.5) -> T2GNet:
    """The T2GNet_glove variant (net/T2GNet_glove.py:36-57): a frozen
    pretrained (GloVe) word table and one heads/units/layers setting shared
    by encoder and decoder."""
    table = np.asarray(embedding_table, np.float32)
    return T2GNet(
        num_tokens=table.shape[0], max_time_steps=max_time_steps, embedding_table=table,
        text_dim=table.shape[1], quat_dim=quat_dim, quat_channels=quat_channels,
        offsets_dim=offsets_dim, tag_dims=tag_dims, num_heads_enc=num_heads,
        num_heads_dec=num_heads, num_hidden_units_enc=num_hidden_units,
        num_hidden_units_dec=num_hidden_units, num_layers_enc=num_layers,
        num_layers_dec=num_layers, dropout=dropout)
