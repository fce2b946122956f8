"""Spatial neighbours (counterpart of the JAX package's ``ops/neighbors.py``):
pairwise distances with a safe square root, the K nearest points of each
query, and a gather of their values.

Ties. ``jax.lax.top_k`` puts the lower index first among equal values;
``torch.topk`` promises no order among them, so :func:`knn_points` takes
the first K of a stable ascending sort, which keeps the lower index first.
"""

from __future__ import annotations

from typing import Optional

import torch


def pairwise_distances(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                       return_v: bool = False):
    """(B, N, d) x (B, M, d) -> (B, N, M) distances, the squared distance
    clipped at 1e-8 before the square root; with `return_v` also the
    (B, N, M, d) differences x_i - y_j."""
    if y is None:
        y = x
    v = x[:, :, None, :] - y[:, None, :, :]
    d = torch.sqrt(torch.clamp(v.square().sum(-1), min=1e-8))
    return (d, v) if return_v else d


def knn_points(q: torch.Tensor, p: torch.Tensor, K: int):
    """The K (at most N) nearest points of `p` (B, N, d) to each query of
    `q` (B, M, d): (dist, idx, neighbours) of shapes (B, M, K), (B, M, K)
    and (B, M, K, d), nearest first, the lower index first among equal
    distances."""
    K = min(K, p.shape[1])
    dist, idx = torch.sort(pairwise_distances(q, p), dim=-1, stable=True)
    idx = idx[..., :K]
    return dist[..., :K], idx, knn_gather(idx, p)


def knn_gather(idx: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Gather (B, N, K) indices from (B, M, d) values -> (B, N, K, d)."""
    rows = torch.arange(value.shape[0], device=value.device)[:, None, None]
    return value[rows, idx.long()]
