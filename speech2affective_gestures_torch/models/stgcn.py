"""Spatial-temporal graph convolution (reference `net/utils/tgcn.py`,
ST-GCN arXiv:1801.07455) on graph sequences (B, C, T, V).

Residual quirk kept from the reference: it tests `stride == 1` against a
tuple stride (net/utils/tgcn.py:195), which is always False at its call
sites, so the residual is always Conv+BN, never the identity.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm2d, Dropout, leaky_relu


class ConvTemporalGraphical(nn.Module):
    """Temporal conv to K*C channels, then the partitioned adjacency
    contraction: x (B, Cin, T, V), A (K, V, V) -> (B, Cout, T', V)."""

    def __init__(self, in_channels: int, out_channels: int, a_channels: int,
                 temporal_kernel_size: int, temporal_stride: int = 1,
                 temporal_padding: int = 0):
        super().__init__()
        self.a_channels = a_channels
        self.conv = nn.Conv2d(in_channels, out_channels * a_channels,
                              (temporal_kernel_size, 1),
                              stride=(temporal_stride, 1),
                              padding=(temporal_padding, 0))

    def forward(self, x: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        b, kc, t, v = y.shape
        y = y.view(b, self.a_channels, kc // self.a_channels, t, v)
        # the adjacency is a float32 constant; it follows the activations'
        # dtype, as in the JAX package (stgcn.py:52-54)
        return torch.einsum("bkctv,kvw->bctw", y, adjacency.to(y.dtype))


class STGraphConv(nn.Module):
    """GCN + temporal conv + Conv/BN residual (ref net/utils/tgcn.py:133-218).
    kernel_size = (temporal, spatial); the activation slope follows the
    reference's `nn.LeakyReLU(inplace=True)`, i.e. 0.01."""

    def __init__(self, in_channels: int, out_channels: int, a_channels: int,
                 kernel_size: tuple[int, int], stride: tuple[int, int] = (1, 1),
                 padding: tuple[int, int] = (0, 0), dropout: float = 0.0,
                 activation_slope: float = 0.01):
        super().__init__()
        self.activation_slope = activation_slope
        self.gcn = ConvTemporalGraphical(in_channels, out_channels, a_channels,
                                         kernel_size[0], stride[0], padding[0])
        self.tcn = nn.Sequential(
            BatchNorm2d(out_channels),
            nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, kernel_size, stride, padding),
            BatchNorm2d(out_channels),
            Dropout(dropout),
        )
        self.residual = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 1, stride=stride),
            BatchNorm2d(out_channels),
        )

    def forward(self, x: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
        y = self.tcn(self.gcn(x, adjacency))
        return leaky_relu(y + self.residual(x), self.activation_slope)
