"""Skeleton-graph adjacency construction for ST-GCN layers.

Capability parity with reference `net/utils/graph.py` (hop-distance
adjacency, in-degree normalization, uniform/distance/spatial partition
strategies from ST-GCN, arXiv:1801.07455).  Built host-side with numpy and
handed to the models as a constant tensor (a registered buffer, so it
follows the module to its device).
"""

from __future__ import annotations

import numpy as np


def hop_distance(
    num_nodes: int, edges: list[tuple[int, int]], max_hop: int = 1
) -> np.ndarray:
    """Shortest-hop distance matrix, inf beyond max_hop.

    Semantics of reference `net/utils/graph.py:108-120`.
    """
    adj = np.zeros((num_nodes, num_nodes))
    for i, j in edges:
        adj[i, j] = 1
        adj[j, i] = 1
    dist = np.full((num_nodes, num_nodes), np.inf)
    reach = np.stack([np.linalg.matrix_power(adj, d) > 0 for d in range(max_hop + 1)])
    for d in range(max_hop, -1, -1):
        dist[reach[d]] = d
    return dist


def normalize_digraph(adj: np.ndarray) -> np.ndarray:
    """Column-normalize: A @ D^-1 (ref net/utils/graph.py:123-131)."""
    deg = adj.sum(axis=0)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    return adj * inv[None, :]


def normalize_undigraph(adj: np.ndarray) -> np.ndarray:
    """Symmetric normalization D^-1/2 A D^-1/2 (ref net/utils/graph.py:134-142)."""
    deg = adj.sum(axis=0)
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    return inv_sqrt[:, None] * adj * inv_sqrt[None, :]


def build_adjacency(
    num_nodes: int,
    neighbor_links: list[tuple[int, int]],
    strategy: str = "spatial",
    max_hop: int = 1,
    dilation: int = 1,
    center: int = 0,
) -> np.ndarray:
    """Partitioned adjacency tensor (K, V, V) for graph convolution.

    strategy in {'uniform', 'distance', 'spatial'}; spatial partitioning
    splits each hop ring into root/closer/further w.r.t. the center node,
    matching reference `net/utils/graph.py:62-105` (incl. self-links).
    """
    edges = [(i, i) for i in range(num_nodes)] + list(neighbor_links)
    dist = hop_distance(num_nodes, edges, max_hop=max_hop)
    valid_hops = range(0, max_hop + 1, dilation)

    adjacency = np.zeros((num_nodes, num_nodes))
    for hop in valid_hops:
        adjacency[dist == hop] = 1
    norm_adj = normalize_digraph(adjacency)

    if strategy == "uniform":
        return norm_adj[None]

    if strategy == "distance":
        parts = []
        for hop in valid_hops:
            a = np.zeros((num_nodes, num_nodes))
            mask = dist == hop
            a[mask] = norm_adj[mask]
            parts.append(a)
        return np.stack(parts)

    if strategy == "spatial":
        parts = []
        for hop in valid_hops:
            a_root = np.zeros((num_nodes, num_nodes))
            a_close = np.zeros((num_nodes, num_nodes))
            a_further = np.zeros((num_nodes, num_nodes))
            # vectorized over (j, i): bucket by hop distance to the center
            dj = dist[:, center][:, None]  # dist(j, center), broadcast over i
            di = dist[:, center][None, :]  # dist(i, center)
            on_hop = dist == hop
            a_root[on_hop & (dj == di)] = norm_adj[on_hop & (dj == di)]
            a_close[on_hop & (dj > di)] = norm_adj[on_hop & (dj > di)]
            a_further[on_hop & (dj < di)] = norm_adj[on_hop & (dj < di)]
            if hop == 0:
                parts.append(a_root)
            else:
                parts.append(a_root + a_close)
                parts.append(a_further)
        return np.stack(parts)

    raise ValueError(f"unknown partition strategy: {strategy!r}")
