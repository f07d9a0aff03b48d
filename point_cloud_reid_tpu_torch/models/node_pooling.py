"""Gated graph pooling (GGS-NN style readouts).

Port of point_cloud_reid_tpu/models/node_pooling.py (GatedPooling,
EdgeGatedPooling; the reference's trackers/deprecated/node_pooling.py:
23-104). A flat node list pools into one vector a graph by a segment sum
over a static `num_graphs` slots (index_add_): unused slots come back as
zero rows, as JAX's segment_sum and torch_scatter's dim_size give. As in
the JAX package, the reference's htheta_* transforms, which its forward
never applies, are left out. Names are the reference's: hgate_node.0,
hgate_edge.0, poolingLayer.0 (flax: hgate_node_0, ...).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Dense


def segment_sum(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """(n, C) rows summed into (num, C) by their segment ids (n,)."""
    out = x.new_zeros((num,) + tuple(x.shape[1:]))
    return out.index_add_(0, seg.long(), x)


class GatedPooling(nn.Module):
    """Per-graph sum of gate(node) * node, then a Linear."""

    def __init__(self, node_dim: int, pooling_dim: int):
        super().__init__()
        self.hgate_node = nn.Sequential(Dense(node_dim, 1))
        self.poolingLayer = nn.Sequential(Dense(node_dim, pooling_dim))

    def forward(self, node_features: torch.Tensor, batch_list: torch.Tensor,
                num_graphs: int) -> torch.Tensor:
        """(Nn, node_dim), (Nn,) graph ids -> (num_graphs, pooling_dim)."""
        alpha = self.hgate_node(node_features)
        pooled = segment_sum(alpha * node_features, batch_list, num_graphs)
        return self.poolingLayer(pooled)


class EdgeGatedPooling(nn.Module):
    """Node and edge gated readout: the two gated sums side by side, then a
    Linear."""

    def __init__(self, node_dim: int, edge_dim: int, pooling_dim: int):
        super().__init__()
        self.hgate_node = nn.Sequential(Dense(node_dim, 1))
        self.hgate_edge = nn.Sequential(Dense(edge_dim, 1))
        self.poolingLayer = nn.Sequential(Dense(node_dim + edge_dim,
                                                pooling_dim))

    def forward(self, node_features: torch.Tensor,
                edge_features: torch.Tensor, node_batch_list: torch.Tensor,
                edge_batch_list: torch.Tensor, num_graphs: int
                ) -> torch.Tensor:
        """(Nn, node_dim), (Ne, edge_dim) -> (num_graphs, pooling_dim)."""
        na = self.hgate_node(node_features)
        ea = self.hgate_edge(edge_features)
        node_pool = segment_sum(na * node_features, node_batch_list,
                                num_graphs)
        edge_pool = segment_sum(ea * edge_features, edge_batch_list,
                                num_graphs)
        return self.poolingLayer(torch.cat([node_pool, edge_pool], dim=-1))
