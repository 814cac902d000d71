"""Causal dilated temporal convolution network (reference `net/tcn.py`,
the locuslab TCN).

The reference pads both sides and slices off the right overhang
(Chomp1d); here the convs pad on the left only, which is the same causal
conv without the slice. Module names follow the reference's state dict:
each TemporalBlock registers its convs both as `conv1`/`conv2` and inside
its `net` Sequential (indices 0 and 4), so both key families load.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Dropout, WNConv1d


class TemporalBlock(nn.Module):
    """conv-relu-dropout twice, with a residual (ref net/tcn.py:16-46)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int, dropout: float = 0.2):
        super().__init__()
        pad = (kernel_size - 1) * dilation
        self.conv1 = WNConv1d(in_channels, out_channels, kernel_size,
                              padding=(pad, 0), dilation=dilation)
        self.conv2 = WNConv1d(out_channels, out_channels, kernel_size,
                              padding=(pad, 0), dilation=dilation)
        # the reference's Sequential: conv, chomp, relu, dropout (x2)
        self.net = nn.Sequential(
            self.conv1, nn.Identity(), nn.ReLU(), Dropout(dropout),
            self.conv2, nn.Identity(), nn.ReLU(), Dropout(dropout),
        )
        # 1x1 residual projection when the widths differ; the reference's
        # N(0, 0.01) re-init of it is effective (unlike on the weight-normed
        # convs, where weight_norm's hook undoes it)
        self.downsample = None
        if in_channels != out_channels:
            self.downsample = nn.Conv1d(in_channels, out_channels, 1)
            nn.init.normal_(self.downsample.weight, 0.0, 0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.net(x) + res)


class TemporalConvNet(nn.Module):
    """Stack of TemporalBlocks with dilation 2**i; (B, C, T) -> (B, C', T)."""

    def __init__(self, num_inputs: int, num_channels, kernel_size: int = 2,
                 dropout: float = 0.2):
        super().__init__()
        blocks = []
        for i, ch in enumerate(num_channels):
            cin = num_inputs if i == 0 else num_channels[i - 1]
            blocks.append(TemporalBlock(cin, ch, kernel_size, 2 ** i, dropout))
        self.network = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.network(x)
