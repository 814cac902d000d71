"""Speech emotion recognition (SER) nets of the v1 pipeline (reference
`net/ser_att_conv_rnn_v1.py` and `net/ser_att_conv_rnn_v2.py`, as the JAX
package's `models/ser.py` rebuilt them).

`AttConvRNN`: six (5, 3) convs with a (2, 4) max pool after the first,
Linear + BatchNorm over each row of the conv maps, a bi-LSTM, additive
attention over time, and a two-layer head to the emotion logits, trained
on IEMOCAP log-mel blocks. `AttConvRNNv2`: three convs and the attention,
no LSTM (the reference imports it nowhere; kept for the inventory).

Input: (B, H = block frames, W = mel filters, C = 3), the JAX package's
channel-last blocks (mel, delta, delta-delta), as `data/iemocap.py` writes
them; the nets move it to torch's (B, C, H, W) once, at their input.
Module names are the reference's state-dict keys (the LSTM is its `gru`).

`apply_reference_init` rewrites a fresh net's weights with the reference's
truncated-normal scheme (ser_att_conv_rnn_v1.py:8-13, 50-114).
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers as L


def truncated_normal_(t: torch.Tensor, generator: torch.Generator, mean: float = 0.0,
                      std: float = 0.01, eps: float = 1e-6) -> torch.Tensor:
    """N(mean, std) in place, each value with |w| >= mean + 2 std redrawn
    from U(mean - eps, mean + eps) (ref truncate_param,
    ser_att_conv_rnn_v1.py:8-13; JAX `truncated_normal_init`)."""
    w = mean + std * torch.randn(t.shape, generator=generator)
    redraw = torch.empty(t.shape).uniform_(mean - eps, mean + eps, generator=generator)
    with torch.no_grad():
        t.copy_(torch.where(w.abs() >= mean + 2.0 * std, redraw, w))
    return t


@torch.no_grad()
def apply_reference_init(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's init of a SER net, in place: every conv and linear
    weight truncated N(0, 0.01) and its bias 0.01, the LSTM's forget-gate
    slice [H:2H] of `bias_ih` and `bias_hh` set to 1; the attention keeps
    its own N(0, 0.1) / 0.1 init and BatchNorm its defaults (JAX
    `apply_reference_init`, ser.py:44-82). Returns the net."""
    for name, module in net.named_modules():
        if name.split(".")[0] == "attention":
            continue
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            truncated_normal_(module.weight, generator)
            module.bias.fill_(0.01)
        elif isinstance(module, L.LSTM):
            h = module.hidden_size
            for pname, p in module.named_parameters():
                if pname.startswith("bias_"):
                    p[h:2 * h] = 1.0
    return net


class Attention(nn.Module):
    """Additive attention over time (ref ser_att_conv_rnn_v1.py:16-34):
    x (B, T, F) -> (sum_t alpha_t x_t (B, F), alphas (B, T, 1)), alphas the
    softmax over T of linear2(sigmoid(linear1(x)))."""

    def __init__(self, in_features: int, attention_size: int = 1):
        super().__init__()
        self.linear1 = nn.Linear(in_features, attention_size)
        self.linear2 = nn.Linear(attention_size, 1)
        for lin in (self.linear1, self.linear2):
            nn.init.normal_(lin.weight, 0.0, 0.1)
            nn.init.constant_(lin.bias, 0.1)

    def forward(self, x: torch.Tensor):
        alphas = torch.softmax(self.linear2(torch.sigmoid(self.linear1(x))), dim=-2)
        return (x * alphas).sum(dim=1), alphas


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, (5, 3), padding=(2, 1))


def _rows(y: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B*H, C*W): the reference's `.contiguous().view(-1,
    C*W)` of the NCHW maps. H*W is no multiple of W's rows per channel, so
    a row straddles channels; this byte order is the one the reference
    trains on (ser_att_conv_rnn_v1.py:145)."""
    b, c, h, w = y.shape
    return y.contiguous().view(b * h, c * w)


class _SERBase(nn.Module):
    """What both nets share: the first conv and its pool, the row-wise
    Linear + BatchNorm, the attention and the head."""

    def __init__(self, num_emotions: int, width: int, l1: int, conv_out: int,
                 attention_in: int, attention_size: int, pool_h: int, pool_w: int,
                 f1: int, f2: int, dropout_prob: float):
        super().__init__()
        self.f1, self.dropout_prob = f1, dropout_prob
        self.conv1 = _conv(3, l1)
        self.max_pool = L.MaxPool2d((pool_h, pool_w))
        self.linear1 = nn.Linear(conv_out * (width // pool_w), f1)
        self.batch_norm_linear1 = L.BatchNorm1d(f1)
        self.attention = Attention(attention_in, attention_size)
        self.linear2 = nn.Linear(attention_in, f2)
        self.linear3 = nn.Linear(f2, num_emotions)

    def _act(self, y: torch.Tensor) -> torch.Tensor:
        return L.dropout(L.leaky_relu(y, 1e-2), self.dropout_prob, self.training)

    def _convs(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _sequence(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> logits (B, num_emotions)."""
        y = self.max_pool(self._act(self.conv1(x.permute(0, 3, 1, 2))))
        y = self._convs(y)
        b, h = y.shape[0], y.shape[2]
        y = L.leaky_relu(self.batch_norm_linear1(self.linear1(_rows(y))), 1e-2)
        y, _alphas = self.attention(self._sequence(y.view(b, h, self.f1)))
        return self.linear3(self._act(self.linear2(y)))


class AttConvRNN(_SERBase):
    """The v1 SER net (JAX `models/ser.py:103-149`). The reference's
    dropout default is 1.0 (every activation dropped in train mode);
    `main_v1` builds it at 0.2."""

    def __init__(self, num_emotions: int, width: int = 40, l1: int = 128,
                 l2: int = 256, l3: int = 128, l4: int = 64, lstm_units: int = 128,
                 attention_size: int = 1, pool_h: int = 2, pool_w: int = 4,
                 f1: int = 768, f2: int = 64, bidirectional: bool = True,
                 dropout_prob: float = 1.0):
        n_dir = 2 if bidirectional else 1
        super().__init__(num_emotions, width, l1, l4, n_dir * lstm_units, attention_size,
                         pool_h, pool_w, f1, f2, dropout_prob)
        self.conv2 = _conv(l1, l2)
        self.conv3 = _conv(l2, l2)
        self.conv4 = _conv(l2, l3)
        self.conv5 = _conv(l3, l3)
        self.conv6 = _conv(l3, l4)
        self.gru = L.LSTM(f1, lstm_units, bidirectional=bidirectional)

    def _convs(self, y):
        for i in range(2, 7):
            y = self._act(getattr(self, f"conv{i}")(y))
        return y

    def _sequence(self, y):
        return self.gru(y)[0]


class AttConvRNNv2(_SERBase):
    """The conv-only SER variant (JAX `models/ser.py:152-183`)."""

    def __init__(self, num_emotions: int, width: int = 40, l1: int = 128,
                 l2: int = 256, attention_size: int = 1, pool_h: int = 2,
                 pool_w: int = 4, f1: int = 768, f2: int = 64,
                 dropout_prob: float = 1.0):
        super().__init__(num_emotions, width, l1, l2, f1, attention_size, pool_h, pool_w,
                         f1, f2, dropout_prob)
        self.conv2 = _conv(l1, l2)
        self.conv3 = _conv(l2, l2)

    def _convs(self, y):
        for i in (2, 3):
            y = self._act(getattr(self, f"conv{i}")(y))
        return y
