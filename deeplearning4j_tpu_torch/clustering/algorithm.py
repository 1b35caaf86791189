"""Generic clustering framework: strategies, termination conditions, iteration
history and cluster splitting.

Reference: ``clustering/algorithm/BaseClusteringAlgorithm.java`` (iterate:
classify points -> refresh centers -> apply strategy until the termination
condition holds), ``clustering/strategy/`` (FixedClusterCountStrategy,
OptimisationStrategy), ``clustering/condition/`` (ConvergenceCondition,
FixedIterationCountCondition, VarianceVariationCondition),
``clustering/optimisation/ClusteringOptimizationType.java``,
``clustering/info/ClusterSetInfo.java``, ``clustering/iteration/``.

Port of ``clustering/algorithm.py``.  The reference classifies points
with a thread pool (``ClusterUtils.classifyPoints`` over an
ExecutorService); here one device step computes the full distance matrix
(one matrix product for euclidean/cosine), the argmin assignment, the
refreshed centers and every per-cluster statistic the strategies need
(counts, mean/max point-to-center distance, distance variance) via one-hot
segment reductions.  Only the strategy decisions (split/terminate) run on
the host between steps — they are O(K) and data-dependent.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .neighbors import pairwise_distance
from .kmeans import ClusterSet, _assign_refresh, kmeanspp_init

__all__ = [
    "ClusteringOptimizationType", "ClusterSetInfo", "IterationInfo",
    "IterationHistory", "ConvergenceCondition", "FixedIterationCountCondition",
    "VarianceVariationCondition", "FixedClusterCountStrategy",
    "OptimisationStrategy", "BaseClusteringAlgorithm", "KMeansClustering",
]


class ClusteringOptimizationType(Enum):
    """``clustering/optimisation/ClusteringOptimizationType.java``."""
    MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE = "avg_to_center"
    MINIMIZE_MAXIMUM_POINT_TO_CENTER_DISTANCE = "max_to_center"
    MINIMIZE_AVERAGE_POINT_TO_POINT_DISTANCE = "avg_to_point"
    MINIMIZE_MAXIMUM_POINT_TO_POINT_DISTANCE = "max_to_point"
    MINIMIZE_PER_CLUSTER_POINT_COUNT = "point_count"


@torch.no_grad()
def _classify_and_refresh(points, centers, prev_assign, metric: str):
    """One full reference iteration (classifyPoints + refreshClustersCenters +
    computeClusterSetInfo) as one device step: the shared Lloyd core
    from ``kmeans.py`` plus the per-cluster statistics the strategies need."""
    d, assign, one_hot, counts, new_centers = \
        _assign_refresh(points, centers, metric)
    mind = torch.min(d, dim=1).values                         # [N]
    safe = torch.clamp(counts, min=1.0)
    # per-cluster point-to-center stats (against the refreshed assignment)
    avg_d = (one_hot.T @ mind[:, None])[:, 0] / safe
    member_d = torch.where(one_hot > 0, d, -torch.inf)
    max_d = torch.amax(member_d, dim=0)
    max_d = torch.where(counts > 0, max_d, 0.0)
    var_d = (one_hot.T @ (mind ** 2)[:, None])[:, 0] / safe - avg_d ** 2
    n_changed = torch.sum(assign != prev_assign)
    # farthest member per cluster — the split point for spread-out clusters
    far_idx = torch.argmax(member_d, dim=0)
    return (new_centers, assign, counts, avg_d, max_d, var_d,
            torch.sum(mind), n_changed, far_idx)


@dataclass
class ClusterSetInfo:
    """Per-iteration cluster statistics (``clustering/info/ClusterSetInfo.java``:
    per-cluster averagePointDistanceFromCenter / maxPointDistanceFromCenter /
    pointDistanceFromCenterVariance, set-level pointLocationChange)."""
    counts: np.ndarray                 # [K] points per cluster
    avg_distance: np.ndarray           # [K] mean point-to-center distance
    max_distance: np.ndarray           # [K] max point-to-center distance
    distance_variance: np.ndarray      # [K] variance of point-to-center dist
    total_cost: float                  # sum of min distances
    point_location_change: int         # points that switched cluster

    @property
    def points_count(self) -> int:
        return int(self.counts.sum())

    def point_distance_from_cluster_variance(self) -> float:
        """Set-level variance used by VarianceVariationCondition."""
        w = self.counts / max(self.counts.sum(), 1)
        return float((w * self.distance_variance).sum())


@dataclass
class IterationInfo:
    """``clustering/iteration/IterationInfo.java``."""
    index: int
    cluster_set_info: ClusterSetInfo
    strategy_applied: bool = False


@dataclass
class IterationHistory:
    """``clustering/iteration/IterationHistory.java``."""
    iterations: Dict[int, IterationInfo] = field(default_factory=dict)

    @property
    def iteration_count(self) -> int:
        return len(self.iterations)

    def most_recent(self) -> Optional[IterationInfo]:
        if not self.iterations:
            return None
        return self.iterations[max(self.iterations)]

    def get(self, index: int) -> IterationInfo:
        return self.iterations[index]


class ConvergenceCondition:
    """Distribution-variation-rate threshold
    (``condition/ConvergenceCondition.java``: fraction of points that changed
    cluster < rate)."""

    def __init__(self, rate: float):
        self.rate = rate

    @classmethod
    def distribution_variation_rate_less_than(cls, rate: float):
        return cls(rate)

    def is_satisfied(self, history: IterationHistory) -> bool:
        if history.iteration_count <= 1:
            return False
        info = history.most_recent().cluster_set_info
        return (info.point_location_change / max(info.points_count, 1)) < self.rate


class FixedIterationCountCondition:
    """``condition/FixedIterationCountCondition.java``."""

    def __init__(self, count: int):
        self.count = count

    @classmethod
    def iteration_count_greater_than(cls, count: int):
        return cls(count)

    def is_satisfied(self, history: IterationHistory) -> bool:
        return history.iteration_count >= self.count


class VarianceVariationCondition:
    """Relative variance change below threshold for ``period`` consecutive
    iterations (``condition/VarianceVariationCondition.java``).

    Intentional deviation from the reference: the threshold applies to the
    ABSOLUTE relative change |(cur-prev)/prev|, whereas the reference's
    LessThan comparison is on the signed change — there any variance
    decrease satisfies the condition immediately.  The absolute form is the
    saner convergence test (a large improvement should not read as
    'converged')."""

    def __init__(self, variation: float, period: int):
        self.variation = variation
        self.period = period

    @classmethod
    def variance_variation_less_than(cls, variation: float, period: int):
        return cls(variation, period)

    def is_satisfied(self, history: IterationHistory) -> bool:
        if history.iteration_count <= self.period:
            return False
        idx = max(history.iterations)
        for i in range(self.period):
            cur = history.get(idx - i).cluster_set_info \
                .point_distance_from_cluster_variance()
            prev = history.get(idx - i - 1).cluster_set_info \
                .point_distance_from_cluster_variance()
            if prev == 0:
                continue
            if abs((cur - prev) / prev) >= self.variation:
                return False
        return True


class _BaseStrategy:
    """``strategy/BaseClusteringStrategy.java``: initial cluster count,
    distance function, empty-cluster policy, termination condition."""

    def __init__(self, initial_cluster_count: int, metric: str = "euclidean",
                 allow_empty_clusters: bool = False):
        self.initial_cluster_count = initial_cluster_count
        self.metric = metric
        self.allow_empty_clusters = allow_empty_clusters
        self.termination_condition = None

    def end_when_iteration_count_equals(self, count: int):
        self.termination_condition = \
            FixedIterationCountCondition.iteration_count_greater_than(count)
        return self

    def end_when_distribution_variation_rate_less_than(self, rate: float):
        self.termination_condition = \
            ConvergenceCondition.distribution_variation_rate_less_than(rate)
        return self


class FixedClusterCountStrategy(_BaseStrategy):
    """K stays fixed; empty clusters are replaced by splitting the most
    spread-out clusters (``strategy/FixedClusterCountStrategy.java``)."""

    @classmethod
    def setup(cls, cluster_count: int, metric: str = "euclidean",
              allow_empty_clusters: bool = False):
        return cls(cluster_count, metric, allow_empty_clusters)


class OptimisationStrategy(_BaseStrategy):
    """Iteratively split clusters violating an optimization target
    (``strategy/OptimisationStrategy.java`` + ``ClusteringOptimization``)."""

    def __init__(self, initial_cluster_count: int, metric: str = "euclidean"):
        super().__init__(initial_cluster_count, metric,
                         allow_empty_clusters=False)
        self.optimization_type: Optional[ClusteringOptimizationType] = None
        self.optimization_value: float = 0.0
        self.optimization_period: int = 1

    @classmethod
    def setup(cls, initial_cluster_count: int, metric: str = "euclidean"):
        return cls(initial_cluster_count, metric)

    def optimize(self, opt_type: ClusteringOptimizationType, value: float):
        self.optimization_type = opt_type
        self.optimization_value = value
        return self

    def optimize_when_iteration_count_multiple_of(self, period: int):
        self.optimization_period = max(1, period)
        return self


class BaseClusteringAlgorithm:
    """Strategy-driven clustering loop
    (``algorithm/BaseClusteringAlgorithm.java``: applyTo = resetState +
    initClusters (k-means++-style distance-weighted seeding, :145-160) +
    iterations; applyClusteringStrategy handles empty-cluster removal,
    splitMostSpreadOutClusters and optimization splits).  The steps run on
    ``device`` (default ``"cuda"``)."""

    def __init__(self, strategy: _BaseStrategy, seed: int = 0,
                 max_iterations: int = 100, device="cuda"):
        self.strategy = strategy
        self.seed = seed
        self.max_iterations = max_iterations
        self.device = resolve_device(device)
        self.history = IterationHistory()

    @classmethod
    def setup(cls, strategy: _BaseStrategy, **kw):
        return cls(strategy, **kw)

    def apply_to(self, points) -> ClusterSet:
        pts_np = np.asarray(points, dtype=np.float32)
        rng = np.random.default_rng(self.seed)
        strat = self.strategy
        dev = self.device
        centers = kmeanspp_init(pts_np, strat.initial_cluster_count, rng,
                                strat.metric, device=dev).astype(np.float32)
        pts = torch.as_tensor(pts_np, device=dev)
        prev_assign = torch.full((len(pts_np),), -1, dtype=torch.int64,
                                 device=dev)
        self.history = IterationHistory()
        cond = strat.termination_condition
        it = 0
        while it < self.max_iterations:
            it += 1
            (c_new, assign, counts, avg_d, max_d, var_d, cost, n_changed,
             far_idx) = _classify_and_refresh(
                pts, torch.as_tensor(centers, device=dev), prev_assign,
                strat.metric)
            prev_assign = assign
            # a host copy: _apply_strategy writes into it
            centers = c_new.cpu().numpy().copy()
            info = ClusterSetInfo(counts.cpu().numpy(), avg_d.cpu().numpy(),
                                  max_d.cpu().numpy(), var_d.cpu().numpy(),
                                  float(cost), int(n_changed))
            self.history.iterations[it] = IterationInfo(it, info)
            applied, centers = self._apply_strategy(
                pts_np, centers, info, far_idx.cpu().numpy(), rng)
            self.history.iterations[it].strategy_applied = applied
            if applied:
                continue
            if cond is not None and cond.is_satisfied(self.history):
                break
            if cond is None and int(n_changed) == 0:
                break
        # final classification against the final centers — a strategy split on
        # the last iteration must not leave assignments/cost referring to the
        # pre-split center set
        with torch.no_grad():
            d = pairwise_distance(pts, torch.as_tensor(centers, device=dev),
                                  strat.metric)
            assign = torch.argmin(d, dim=1)
            cost = torch.sum(torch.min(d, dim=1).values)
        return ClusterSet(np.asarray(centers), assign.cpu().numpy(),
                          float(cost), it)

    # -- strategy application ------------------------------------------------
    def _apply_strategy(self, pts_np, centers, info: ClusterSetInfo,
                        far_idx, rng):
        """Returns (applied, centers)."""
        strat = self.strategy
        applied = False
        if not strat.allow_empty_clusters:
            empties = np.flatnonzero(info.counts == 0)
            if len(empties):
                # replace each empty center by splitting the most spread-out
                # non-empty clusters (ClusterUtils.splitMostSpreadOutClusters);
                # more empties than donor clusters -> distinct random points
                donors = np.flatnonzero(info.counts > 0)
                donors = donors[np.argsort(-info.avg_distance[donors])]
                for i, e in enumerate(empties):
                    if i < len(donors):
                        centers[e] = pts_np[int(far_idx[int(donors[i])])]
                    else:
                        centers[e] = pts_np[rng.integers(len(pts_np))]
                applied = True
        if isinstance(strat, OptimisationStrategy) and strat.optimization_type:
            if self.history.iteration_count % strat.optimization_period == 0:
                new = self._optimization_splits(pts_np, centers, info, far_idx)
                if new is not None:
                    centers = new
                    applied = True
        return applied, centers

    def _optimization_splits(self, pts_np, centers, info: ClusterSetInfo,
                             far_idx) -> Optional[np.ndarray]:
        """Split every cluster violating the optimization target, adding its
        farthest member as a new center (ClusterUtils.applyOptimization)."""
        strat: OptimisationStrategy = self.strategy  # type: ignore
        t, v = strat.optimization_type, strat.optimization_value
        if t is ClusteringOptimizationType.MINIMIZE_AVERAGE_POINT_TO_CENTER_DISTANCE:
            bad = info.avg_distance > v
        elif t is ClusteringOptimizationType.MINIMIZE_MAXIMUM_POINT_TO_CENTER_DISTANCE:
            bad = info.max_distance > v
        elif t is ClusteringOptimizationType.MINIMIZE_AVERAGE_POINT_TO_POINT_DISTANCE:
            # mean pairwise distance ~ 2x mean-to-center for a symmetric cloud
            bad = 2.0 * info.avg_distance > v
        elif t is ClusteringOptimizationType.MINIMIZE_MAXIMUM_POINT_TO_POINT_DISTANCE:
            bad = 2.0 * info.max_distance > v
        else:  # MINIMIZE_PER_CLUSTER_POINT_COUNT
            bad = info.counts > v
        bad &= info.counts > 1
        if not bad.any():
            return None
        extra = [pts_np[int(far_idx[int(c)])] for c in np.flatnonzero(bad)]
        return np.concatenate([centers, np.stack(extra)], axis=0)


class KMeansClustering(BaseClusteringAlgorithm):
    """``clustering/kmeans/KMeansClustering.java`` setup helpers."""

    @classmethod
    def setup(cls, cluster_count: int, max_iterations: int = 100,
              metric: str = "euclidean", seed: int = 0, device="cuda"):
        strat = FixedClusterCountStrategy.setup(cluster_count, metric)
        strat.end_when_iteration_count_equals(max_iterations)
        return cls(strat, seed=seed, max_iterations=max_iterations,
                   device=device)

    @classmethod
    def setup_with_convergence(cls, cluster_count: int, rate: float,
                               metric: str = "euclidean", seed: int = 0,
                               max_iterations: int = 100, device="cuda"):
        strat = FixedClusterCountStrategy.setup(cluster_count, metric)
        strat.end_when_distribution_variation_rate_less_than(rate)
        return cls(strat, seed=seed, max_iterations=max_iterations,
                   device=device)
