"""KMeans clustering (port of ``clustering/kmeans.py``; reference
``clustering/kmeans/KMeansClustering.java`` + the strategy machinery in
``clustering/algorithm/BaseClusteringAlgorithm.java``).

One Lloyd iteration is a distance matrix (one matrix product), an argmin
and a one-hot segment sum, on the device; the convergence check and the
empty-cluster reseed (the point farthest from its centroid) run on the
host between steps, as in the JAX package.  The argmin breaks ties at
the first index, as ``jnp.argmin`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .neighbors import pairwise_distance

__all__ = ["KMeans", "ClusterSet", "kmeanspp_init"]


def _assign_refresh(points: torch.Tensor, centers: torch.Tensor,
                    metric: str):
    """Shared Lloyd core (used by KMeans and the strategy framework in
    ``algorithm.py``): distance matrix, argmin assignment, one-hot,
    counts, refreshed centers (old center kept where a cluster went
    empty)."""
    d = pairwise_distance(points, centers, metric)          # [N,K]
    assign = torch.argmin(d, dim=1)                         # [N]
    one_hot = F.one_hot(assign, centers.shape[0]).to(points.dtype)
    counts = one_hot.sum(dim=0)                             # [K]
    sums = one_hot.T @ points                               # [K,D]
    new_centers = sums / torch.clamp(counts, min=1.0)[:, None]
    new_centers = torch.where((counts > 0)[:, None], new_centers, centers)
    return d, assign, one_hot, counts, new_centers


@torch.no_grad()
def _lloyd_step(points: torch.Tensor, centers: torch.Tensor, metric: str
                ) -> Tuple[torch.Tensor, ...]:
    d, assign, _, counts, new_centers = _assign_refresh(points, centers,
                                                        metric)
    mind = torch.min(d, dim=1).values
    cost = torch.sum(mind)
    # farthest point from its own centroid (used for empty-cluster reseed)
    far = torch.argmax(mind)
    return new_centers, assign, counts, cost, far


@torch.no_grad()
def kmeanspp_init(points: np.ndarray, k: int, rng,
                  metric: str = "euclidean", *, device="cuda") -> np.ndarray:
    """Distance-weighted (k-means++) seeding: each next center is sampled
    with probability proportional to its squared distance from the
    nearest chosen center (the reference's initClusters loop,
    ``clustering/algorithm/BaseClusteringAlgorithm.java:145-160``).  The
    distances are computed on ``device``; the draws are ``rng``'s."""
    n = len(points)
    if k > n:
        raise ValueError(
            f"k={k} clusters requested but only {n} points given")
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    centers = [points[rng.integers(n)]]
    d2 = None
    for _ in range(1, k):
        last = torch.as_tensor(np.asarray(centers[-1], np.float32)[None],
                               device=dev)
        cur = (pairwise_distance(pts, last, metric)[:, 0] ** 2).cpu().numpy()
        d2 = cur if d2 is None else np.minimum(d2, cur)
        total = d2.sum()
        if total <= 0.0:  # all points coincide with a center: uniform pick
            centers.append(points[rng.integers(n)])
            continue
        centers.append(points[rng.choice(n, p=d2 / total)])
    return np.stack(centers)


@dataclass
class ClusterSet:
    """Result of clustering: centers + assignment (reference
    ``ClusterSet``), host arrays."""
    centers: np.ndarray
    assignments: np.ndarray
    cost: float
    iterations: int

    @torch.no_grad()
    def nearest_cluster(self, points, metric: str = "euclidean", *,
                        device="cuda") -> np.ndarray:
        dev = resolve_device(device)
        q = torch.as_tensor(np.atleast_2d(np.asarray(points, np.float32)),
                            device=dev)
        c = torch.as_tensor(np.asarray(self.centers, np.float32),
                            device=dev)
        return torch.argmin(pairwise_distance(q, c, metric),
                            dim=1).cpu().numpy()


class KMeans:
    """Lloyd's algorithm with k-means++ init and empty-cluster reseeding,
    on ``device`` (default ``"cuda"``)."""

    def __init__(self, k: int, max_iterations: int = 100,
                 metric: str = "euclidean", tol: float = 1e-4,
                 seed: int = 0, init: str = "kmeans++", device="cuda"):
        self.k = k
        self.max_iterations = max_iterations
        self.metric = metric
        self.tol = tol
        self.seed = seed
        self.init = init
        self.device = resolve_device(device)

    def _init_centers(self, points: np.ndarray, rng) -> np.ndarray:
        if self.init == "random":
            return points[rng.choice(len(points), self.k, replace=False)]
        return kmeanspp_init(points, self.k, rng, self.metric,
                             device=self.device)

    def fit(self, points) -> ClusterSet:
        points_np = np.asarray(points, dtype=np.float32)
        rng = np.random.default_rng(self.seed)
        centers = torch.as_tensor(self._init_centers(points_np, rng),
                                  device=self.device)
        pts = torch.as_tensor(points_np, device=self.device)
        prev_cost = np.inf
        assign = None
        it = 0
        for it in range(1, self.max_iterations + 1):
            centers, assign, counts, cost, far = _lloyd_step(
                pts, centers, self.metric)
            # host decisions: the tol test and the empty-cluster repair
            counts_np = counts.cpu().numpy()
            if (counts_np == 0).any():
                centers = centers.clone()
                centers[int(np.flatnonzero(counts_np == 0)[0])] = \
                    pts[int(far)]
                continue
            cost = float(cost)
            if abs(prev_cost - cost) <= self.tol * max(abs(prev_cost), 1.0):
                prev_cost = cost
                break
            prev_cost = cost
        return ClusterSet(centers.cpu().numpy(),
                          None if assign is None else assign.cpu().numpy(),
                          prev_cost, it)
