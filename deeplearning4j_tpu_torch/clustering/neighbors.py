"""Nearest-neighbor search (port of ``clustering/neighbors.py``).

The reference's exact-NN structures (VPTree
``clustering/vptree/VPTree.java:48``, KDTree ``clustering/kdtree/KDTree.java``)
are pointer-chasing trees.  On the GPU the exact kNN is a batched distance
product and ``torch.topk`` (:class:`BruteForceNN`, on the card in plain
torch: the JAX package computes it outside any Pallas kernel too).  The
trees stay host-side numpy, for the serving tier's cheap single-query
exact search.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["BruteForceNN", "VPTree", "KDTree", "pairwise_distance"]


def _norm_rows(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=1e-12)


def pairwise_distance(queries: torch.Tensor, points: torch.Tensor,
                      metric: str = "euclidean") -> torch.Tensor:
    """[Q,D] x [N,D] -> [Q,N] distances: euclidean, cosine, manhattan or
    dot.  Euclidean uses the ||a||^2 - 2ab + ||b||^2 expansion, so the
    cross term is one matrix product instead of a [Q,N,D] broadcast."""
    if metric == "euclidean":
        q2 = torch.sum(queries * queries, dim=-1)[:, None]
        p2 = torch.sum(points * points, dim=-1)[None, :]
        cross = queries @ points.T
        return torch.sqrt(torch.clamp(q2 - 2.0 * cross + p2, min=0.0))
    if metric == "cosine":
        return 1.0 - _norm_rows(queries) @ _norm_rows(points).T
    if metric == "manhattan":
        return torch.sum(torch.abs(queries[:, None, :] - points[None, :, :]),
                         dim=-1)
    if metric == "dot":
        return -(queries @ points.T)
    raise ValueError(f"unknown metric {metric!r}")


class BruteForceNN:
    """Exact kNN on the device: the distance matrix and ``torch.topk``."""

    def __init__(self, points, metric: str = "euclidean", device="cuda"):
        self.device = resolve_device(device)
        self.points = torch.as_tensor(np.asarray(points, np.float32),
                                      device=self.device)
        self.metric = metric

    def __len__(self) -> int:
        return len(self.points)

    @torch.inference_mode()
    def query(self, queries, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Returns host (distances [Q,k], indices [Q,k]), nearest first;
        k is clamped to N."""
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.device)
        d = pairwise_distance(q, self.points, self.metric)
        dist, idx = torch.topk(d, min(int(k), len(self.points)), dim=1,
                               largest=False, sorted=True)
        return dist.cpu().numpy(), idx.cpu().numpy()


def _host_dist(a: np.ndarray, b: np.ndarray, metric: str) -> np.ndarray:
    if metric == "euclidean":
        return np.linalg.norm(a - b, axis=-1)
    if metric == "manhattan":
        return np.sum(np.abs(a - b), axis=-1)
    if metric == "cosine":
        na = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
        nb = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
        return 1.0 - np.sum(na * nb, axis=-1)
    raise ValueError(metric)


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index, threshold, inside, outside):
        self.index = index
        self.threshold = threshold
        self.inside = inside
        self.outside = outside


class VPTree:
    """Vantage-point tree (reference ``clustering/vptree/VPTree.java:48``).

    Host-side exact metric tree for the serving tier; median-split on the
    distance to a randomly chosen vantage point.
    """

    def __init__(self, points, metric: str = "euclidean", seed: int = 0):
        self.points = np.asarray(points, dtype=np.float64)
        self.metric = metric
        self._rng = np.random.default_rng(seed)
        self.root = self._build(np.arange(len(self.points)))

    def _build(self, idx: np.ndarray) -> Optional[_VPNode]:
        if idx.size == 0:
            return None
        vp_pos = self._rng.integers(idx.size)
        vp = idx[vp_pos]
        rest = np.delete(idx, vp_pos)
        if rest.size == 0:
            return _VPNode(vp, 0.0, None, None)
        d = _host_dist(self.points[rest], self.points[vp], self.metric)
        med = float(np.median(d))
        inside = rest[d <= med]
        outside = rest[d > med]
        return _VPNode(vp, med, self._build(inside), self._build(outside))

    def query(self, point, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        point = np.asarray(point, dtype=np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance

        def search(node: Optional[_VPNode]):
            if node is None:
                return
            d = float(_host_dist(self.points[node.index], point, self.metric))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            tau = -heap[0][0] if len(heap) == k else np.inf
            if d < node.threshold:
                search(node.inside)
                if d + tau >= node.threshold:
                    search(node.outside)
            else:
                search(node.outside)
                if d - tau <= node.threshold:
                    search(node.inside)

        search(self.root)
        order = sorted((-nd, i) for nd, i in heap)
        return (np.array([d for d, _ in order]),
                np.array([i for _, i in order], dtype=np.int64))


class _KDNode:
    __slots__ = ("index", "dim", "left", "right")

    def __init__(self, index, dim, left, right):
        self.index = index
        self.dim = dim
        self.left = left
        self.right = right


class KDTree:
    """k-d tree (reference ``clustering/kdtree/KDTree.java``), euclidean."""

    def __init__(self, points):
        self.points = np.asarray(points, dtype=np.float64)
        self.root = self._build(np.arange(len(self.points)), 0)

    def _build(self, idx: np.ndarray, depth: int) -> Optional[_KDNode]:
        if idx.size == 0:
            return None
        dim = depth % self.points.shape[1]
        order = idx[np.argsort(self.points[idx, dim], kind="stable")]
        mid = order.size // 2
        return _KDNode(order[mid], dim,
                       self._build(order[:mid], depth + 1),
                       self._build(order[mid + 1:], depth + 1))

    def query(self, point, k: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        point = np.asarray(point, dtype=np.float64)
        heap: List[Tuple[float, int]] = []

        def search(node: Optional[_KDNode]):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.index] - point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            diff = point[node.dim] - self.points[node.index, node.dim]
            near, far = (node.left, node.right) if diff <= 0 \
                else (node.right, node.left)
            search(near)
            tau = -heap[0][0] if len(heap) == k else np.inf
            if abs(diff) <= tau:
                search(far)

        search(self.root)
        order = sorted((-nd, i) for nd, i in heap)
        return (np.array([d for d, _ in order]),
                np.array([i for _, i in order], dtype=np.int64))
