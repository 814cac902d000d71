"""The plain reference of the s2ag nets: a frozen copy of the paper's
networks (reference net/multimodal_context_net_v2.py and its abl_aff
ablation, net/multimodal_context_net_v2_abl_aff.py) in plain PyTorch,
float32, with every recurrence a plain time loop.

It imports nothing of the program under test. Module and parameter names
follow the reference's state dict, so one weight dictionary loads into both
sides. Dropout masks and the speaker noise are drawn from an explicit
`torch.Generator` in the nets' call order (each dropout mask batch first,
`torch.rand(shape) >= p`; the noise `torch.randn(B, z)`), so that a
generator seeded alike draws the same values that the program's nets draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# --- skeleton (ref utils/ted_db_utils.py:12-19) ------------------------------
DIR_VEC_PAIRS = ((0, 1, 0.26), (1, 2, 0.18), (2, 3, 0.14), (1, 4, 0.22), (4, 5, 0.36),
                 (5, 6, 0.33), (1, 7, 0.22), (7, 8, 0.36), (8, 9, 0.33))
NUM_JOINTS, NUM_BONES, COORDS = 10, 9, 3
POSE_DIM = NUM_BONES * COORDS
DIR_EDGE_PAIRS = ((0, 1), (1, 2), (0, 3), (3, 4), (4, 5), (0, 6), (6, 7), (7, 8))
BODY_PARTS_EDGE_IDX = ((0, 1, 2), (3, 4, 5), (6, 7, 8))
BODY_PARTS_EDGE_PAIRS = ((0, 1), (0, 2))
# config/multimodal_context_v2.yml: mean_dir_vec
MEAN_DIR_VEC = np.array([
    0.0154009, -0.9690125, -0.0884354, -0.0022264, -0.8655276, 0.4342174,
    -0.0035145, -0.8755367, -0.4121039, -0.9236511, 0.3061306, -0.0012415,
    -0.5155854, 0.8129665, 0.0871897, 0.2348464, 0.1846561, 0.8091402,
    0.9271948, 0.2960011, -0.013189, 0.5233978, 0.8092403, 0.0725451,
    -0.2037076, 0.1924306, 0.8196916], dtype=np.float32)


class Draws:
    """The generator every dropout mask and noise of a forward comes from
    (None: no dropout, as in eval mode)."""
    generator: torch.Generator | None = None


class Precision:
    """`round`, where set, rounds the recurrence's input projections and its
    state at every step to a lower precision (the control's)."""
    round = None


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    if not training or p == 0.0:
        return x
    g = Draws.generator
    keep = torch.rand(tuple(x.shape), generator=g, device=g.device) >= p
    return x * keep.to(x.device) / (1.0 - p)


def noise(shape, like: torch.Tensor) -> torch.Tensor:
    g = Draws.generator
    return torch.randn(tuple(shape), generator=g, device=g.device).to(like)


def leaky_relu(x, slope):
    return x if slope == 1.0 else F.leaky_relu(x, slope)


class Dropout(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.p = p

    def forward(self, x):
        return dropout(x, self.p, self.training)


# --- graph adjacency (ref net/utils/graph.py, spatial partition) ------------
def build_adjacency(num_nodes, links, max_hop=2):
    edges = [(i, i) for i in range(num_nodes)] + list(links)
    adj = np.zeros((num_nodes, num_nodes))
    for i, j in edges:
        adj[i, j] = adj[j, i] = 1
    dist = np.full((num_nodes, num_nodes), np.inf)
    reach = [np.linalg.matrix_power(adj, d) > 0 for d in range(max_hop + 1)]
    for d in range(max_hop, -1, -1):
        dist[reach[d]] = d
    a = np.zeros((num_nodes, num_nodes))
    for hop in range(max_hop + 1):
        a[dist == hop] = 1
    deg = a.sum(axis=0)
    norm = a * np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)[None, :]
    parts = []
    for hop in range(max_hop + 1):
        root, close, far = (np.zeros_like(a) for _ in range(3))
        dj, di = dist[:, 0][:, None], dist[:, 0][None, :]
        on = dist == hop
        root[on & (dj == di)] = norm[on & (dj == di)]
        close[on & (dj > di)] = norm[on & (dj > di)]
        far[on & (dj < di)] = norm[on & (dj < di)]
        parts += [root] if hop == 0 else [root + close, far]
    return torch.tensor(np.stack(parts), dtype=torch.float32)


def bone_graphs():
    return (build_adjacency(NUM_BONES, DIR_EDGE_PAIRS),
            build_adjacency(len(BODY_PARTS_EDGE_IDX), BODY_PARTS_EDGE_PAIRS))


# --- the recurrence ----------------------------------------------------------
class GRU(nn.Module):
    """Multi-layer bidirectional GRU, torch's cell (gates r, z, n;
    n = tanh(x_n + b_in + r * (W_hn h + b_hn))), torch's parameter names,
    each direction a plain loop over time. forward(x (B, T, C)) -> out
    (T, B, 2H), time-major."""

    def __init__(self, input_size, hidden_size, num_layers, dropout):
        super().__init__()
        self.hidden_size, self.num_layers, self.dropout = hidden_size, num_layers, dropout
        bound = 1.0 / math.sqrt(hidden_size)
        for layer in range(num_layers):
            cin = input_size if layer == 0 else 2 * hidden_size
            for sfx in ("", "_reverse"):
                for name, shape in ((f"weight_ih_l{layer}{sfx}", (3 * hidden_size, cin)),
                                    (f"weight_hh_l{layer}{sfx}", (3 * hidden_size, hidden_size)),
                                    (f"bias_ih_l{layer}{sfx}", (3 * hidden_size,)),
                                    (f"bias_hh_l{layer}{sfx}", (3 * hidden_size,))):
                    self.register_parameter(name, nn.Parameter(
                        torch.empty(shape).uniform_(-bound, bound)))

    def _direction(self, x, layer, sfx, reverse):
        H = self.hidden_size
        w_ih, w_hh, b_ih, b_hh = (getattr(self, f"{name}_l{layer}{sfx}") for name in
                                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
        xp = torch.matmul(x, w_ih.t()) + b_ih                # (T, B, 3H)
        rnd = Precision.round or (lambda v: v)
        xs = rnd(xp).unbind(0)    # unbind: its backward stacks the steps' gradients
        h = x.new_zeros(x.shape[1], H)
        steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
        ys = [None] * x.shape[0]
        for t in steps:
            hp = torch.matmul(h, w_hh.t()) + b_hh
            r = torch.sigmoid(xs[t][:, :H] + hp[:, :H])
            z = torch.sigmoid(xs[t][:, H:2 * H] + hp[:, H:2 * H])
            n = torch.tanh(xs[t][:, 2 * H:] + r * hp[:, 2 * H:])
            h = rnd((1.0 - z) * n + z * h)
            ys[t] = h
        return torch.stack(ys)

    def forward(self, x):
        out = x.transpose(0, 1)
        for layer in range(self.num_layers):
            out = torch.cat([self._direction(out, layer, "", False),
                             self._direction(out, layer, "_reverse", True)], dim=-1)
            if layer < self.num_layers - 1:
                out = dropout(out.transpose(0, 1), self.dropout, self.training).transpose(0, 1)
        return out


def sum_bidirectional(out, hidden_size):
    return out[..., :hidden_size] + out[..., hidden_size:]


# --- convolutions --------------------------------------------------------------
class WNConv1d(nn.Module):
    """Weight-normalized Conv1d (weight = v g / ||v||), padding (left, right)."""

    def __init__(self, cin, cout, k, padding, dilation):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(cout, cin, k))
        self.weight_g = nn.Parameter(torch.empty(cout, 1, 1))
        self.bias = nn.Parameter(torch.empty(cout))
        self.padding, self.dilation = padding, dilation

    def forward(self, x):
        norm = self.weight_v.flatten(1).norm(dim=1).clamp_min(1e-12)
        w = self.weight_v * (self.weight_g / norm.view(-1, 1, 1))
        return F.conv1d(F.pad(x, self.padding), w, self.bias, dilation=self.dilation)


class TemporalBlock(nn.Module):
    def __init__(self, cin, cout, k, dilation, p):
        super().__init__()
        pad = (k - 1) * dilation
        self.conv1 = WNConv1d(cin, cout, k, (pad, 0), dilation)
        self.conv2 = WNConv1d(cout, cout, k, (pad, 0), dilation)
        self.net = nn.Sequential(self.conv1, nn.Identity(), nn.ReLU(), Dropout(p),
                                 self.conv2, nn.Identity(), nn.ReLU(), Dropout(p))
        self.downsample = nn.Conv1d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.net(x) + res)


class TextEncoderTCN(nn.Module):
    def __init__(self, n_words, embed, hidden, n_layers, dropout_p, emb_dropout):
        super().__init__()
        self.embedding = nn.Embedding(n_words, embed)
        self.emb_drop = Dropout(emb_dropout)
        blocks = [TemporalBlock(embed if i == 0 else hidden, hidden, 2, 2 ** i, dropout_p)
                  for i in range(n_layers)]
        self.tcn = nn.Module()
        self.tcn.network = nn.Sequential(*blocks)
        self.decoder = nn.Linear(hidden, 32)

    def forward(self, ids):
        emb = self.emb_drop(self.embedding(ids))
        y = self.tcn.network(emb.transpose(1, 2))
        return self.decoder(y.transpose(1, 2))


class WavEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.feat_extractor = nn.Sequential(
            nn.Conv1d(1, 16, 15, stride=5, padding=1600), nn.BatchNorm1d(16), nn.LeakyReLU(0.3),
            nn.Conv1d(16, 32, 15, stride=6), nn.BatchNorm1d(32), nn.LeakyReLU(0.3),
            nn.Conv1d(32, 64, 15, stride=6), nn.BatchNorm1d(64), nn.LeakyReLU(0.3),
            nn.Conv1d(64, 32, 15, stride=6))

    def forward(self, wav):
        return self.feat_extractor(wav[:, None]).transpose(1, 2)


class MFCCEncoder(nn.Module):
    def __init__(self, mfcc_length, num_mfcc, time_steps):
        super().__init__()
        for i, (cin, cout, k) in enumerate(((mfcc_length, 64, 5), (64, 64, 5), (64, 48, 3),
                                            (48, time_steps, 3)), start=1):
            setattr(self, f"conv{i}", nn.Conv1d(cin, cout, k, padding=k // 2))
            setattr(self, f"batch_norm{i}", nn.BatchNorm1d(cout))
        self.linear1 = nn.Linear(num_mfcc, 32)

    def forward(self, mfcc):
        x = mfcc.transpose(1, 2)
        for i in range(1, 5):
            x = leaky_relu(getattr(self, f"batch_norm{i}")(getattr(self, f"conv{i}")(x)), 0.3)
        return leaky_relu(self.linear1(x), 0.3)


# --- ST-GCN ----------------------------------------------------------------------
class ConvTemporalGraphical(nn.Module):
    def __init__(self, cin, cout, k_a, kt, padding):
        super().__init__()
        self.a_channels = k_a
        self.conv = nn.Conv2d(cin, cout * k_a, (kt, 1), padding=(padding, 0))

    def forward(self, x, a):
        y = self.conv(x)
        b, kc, t, v = y.shape
        y = y.view(b, self.a_channels, kc // self.a_channels, t, v)
        return torch.einsum("bkctv,kvw->bctw", y, a)


class STGraphConv(nn.Module):
    def __init__(self, cin, cout, k_a, kernel, padding):
        super().__init__()
        self.gcn = ConvTemporalGraphical(cin, cout, k_a, kernel[0], padding[0])
        self.tcn = nn.Sequential(nn.BatchNorm2d(cout), nn.ReLU(),
                                 nn.Conv2d(cout, cout, kernel, 1, padding),
                                 nn.BatchNorm2d(cout), Dropout(0.0))
        self.residual = nn.Sequential(nn.Conv2d(cin, cout, 1), nn.BatchNorm2d(cout))

    def forward(self, x, a):
        return leaky_relu(self.tcn(self.gcn(x, a)) + self.residual(x), 0.01)


def channel_major(x):
    b, c, t, v = x.shape
    return x.permute(0, 1, 3, 2).reshape(b, c * v, t)


def per_node_batchnorm(x, bn):
    b, c, t, v = x.shape
    return bn(channel_major(x)).view(b, c, v, t).permute(0, 1, 3, 2)


def regroup_body_parts(feat):
    return torch.stack([channel_major(feat[..., p[0]:p[-1] + 1]) for p in BODY_PARTS_EDGE_IDX],
                       dim=-1)


class AffEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        a1, a2 = bone_graphs()
        self.register_buffer("a1", a1, persistent=False)
        self.register_buffer("a2", a2, persistent=False)
        self.st_gcn1 = STGraphConv(3, 16, a1.shape[0], (9, 5), (4, 2))
        self.st_gcn2 = STGraphConv(48, 16, a2.shape[0], (9, 3), (4, 1))
        self.batch_norm1 = nn.BatchNorm1d(16 * NUM_BONES)
        self.batch_norm2 = nn.BatchNorm1d(48)
        self.conv3 = nn.Conv1d(48, 16, 5, padding=2)
        self.batch_norm3 = nn.BatchNorm1d(16)
        self.conv4 = nn.Conv1d(16, 8, 3, padding=1)
        self.batch_norm4 = nn.BatchNorm1d(8)

    def forward(self, poses):
        b, t, jc = poses.shape
        x = poses.view(b, t, jc // 3, 3).permute(0, 3, 1, 2).contiguous()
        f1 = per_node_batchnorm(self.st_gcn1(x, self.a1), self.batch_norm1)
        f2 = per_node_batchnorm(self.st_gcn2(regroup_body_parts(f1), self.a2), self.batch_norm2)
        y = leaky_relu(self.batch_norm3(self.conv3(channel_major(f2))), 0.01)
        y = leaky_relu(self.batch_norm4(self.conv4(y)), 0.01)
        return y.transpose(1, 2)


# --- generators ------------------------------------------------------------------
class Generator(nn.Module):
    """The s2ag PoseGenerator (`aff=True`), its abl_aff ablation (`aff=False`:
    the seed poses and their bit fed raw) and the TriModal comparator
    (`wav=True`: the WavEncoder on the raw audio, the seed poses raw, the
    head's slope 1). forward(pre_seq, text, audio, vids) -> (out (B, T, D),
    z, mu, log_var)."""

    def __init__(self, n_words, n_speakers, hidden, n_layers, dropout_p, embed=300,
                 mfcc_length=71, num_mfcc=37, time_steps=34, aff=True, wav=False,
                 z_size=16, emb_dropout=0.1):
        super().__init__()
        self.hidden_size, self.z_size = hidden, z_size
        self.aff_encoder = AffEncoder() if aff else None
        self.audio_encoder = WavEncoder() if wav else MFCCEncoder(mfcc_length, num_mfcc,
                                                                 time_steps)
        self.text_encoder = TextEncoderTCN(n_words, embed, hidden, n_layers, dropout_p,
                                           emb_dropout)
        self.speaker_embedding = nn.Sequential(nn.Embedding(n_speakers, z_size),
                                               nn.Linear(z_size, z_size))
        self.speaker_mu = nn.Linear(z_size, z_size)
        self.speaker_log_var = nn.Linear(z_size, z_size)
        pre = 8 if aff else POSE_DIM + 1
        self.gru = GRU(pre + 32 + 32 + z_size, hidden, n_layers, dropout_p)
        self.head_slope = 1.0 if wav else 0.01
        self.out = nn.Sequential(nn.Linear(hidden, hidden // 2), nn.Identity(),
                                 nn.Linear(hidden // 2, POSE_DIM))

    def forward(self, pre_seq, text, audio, vids, eps=None):
        feats = [pre_seq if self.aff_encoder is None else self.aff_encoder(pre_seq[..., :-1]),
                 self.audio_encoder(audio), self.text_encoder(text)]
        h = self.speaker_embedding(vids)
        mu, log_var = self.speaker_mu(h), self.speaker_log_var(h)
        eps = noise(mu.shape, mu) if eps is None else eps.to(mu)
        z = mu + eps * torch.exp(0.5 * log_var)
        feats.append(z[:, None, :].expand(-1, pre_seq.shape[1], -1))
        out = self.gru(torch.cat(feats, dim=-1))
        out = sum_bidirectional(out, self.hidden_size)
        out = self.out[2](leaky_relu(self.out[0](out), self.head_slope))
        return out.transpose(0, 1), z, mu, log_var


# --- discriminators ------------------------------------------------------------------
class AffDiscriminator(nn.Module):
    def __init__(self, n_poses=34, hidden=64, dropout_p=0.3):
        super().__init__()
        self.hidden_size = hidden
        self.aff_encoder = AffEncoder()
        self.gru = GRU(8, hidden, 4, dropout_p)
        self.out = nn.Linear(hidden, 1)
        self.out2 = nn.Linear(n_poses, 1)

    def forward(self, poses):
        out = self.out(sum_bidirectional(self.gru(self.aff_encoder(poses)), self.hidden_size))
        return torch.sigmoid(self.out2(out[..., 0].t()))


class ConvDiscriminator(nn.Module):
    def __init__(self, n_poses=34, hidden=64, dropout_p=0.3):
        super().__init__()
        self.hidden_size = hidden
        self.pre_conv = nn.Sequential(
            nn.Conv1d(POSE_DIM, 16, 3), nn.BatchNorm1d(16), nn.Identity(),
            nn.Conv1d(16, 8, 3), nn.BatchNorm1d(8), nn.Identity(), nn.Conv1d(8, 8, 3))
        self.gru = GRU(8, hidden, 4, dropout_p)
        self.out = nn.Linear(hidden, 1)
        self.out2 = nn.Linear(n_poses - 6, 1)

    def forward(self, poses):
        x = self.pre_conv(poses.transpose(1, 2))
        out = self.out(sum_bidirectional(self.gru(x.transpose(1, 2)), self.hidden_size))
        return torch.sigmoid(self.out2(out[..., 0].t()))


def build(m: dict):
    """(generator, discriminator, TriModal comparator) of a configuration's
    model (its "model" and "assumed" sizes in one dict, with the derived
    `mfcc_length`): `variant` "s2ag" or "abl_aff", at its widths."""
    common = dict(n_words=m["n_words"], n_speakers=m["n_speakers"], n_layers=m["n_layers"],
                  dropout_p=m["dropout_prob"], embed=m["wordembed_dim"],
                  time_steps=m["n_poses"])
    gen = Generator(hidden=m["hidden_size_s2eg"], aff=m["variant"] != "abl_aff",
                    mfcc_length=m["mfcc_length"], num_mfcc=3 * m["num_mfcc"] - 5, **common)
    dis = (ConvDiscriminator if m["variant"] == "abl_aff" else AffDiscriminator)(
        n_poses=m["n_poses"], hidden=m["dis_hidden_size"], dropout_p=m["dis_dropout_prob"])
    tri = Generator(hidden=m["hidden_size"], aff=False, wav=True, **common)
    return gen, dis, tri
