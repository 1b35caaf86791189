"""Space-partitioning tree (port of ``clustering/sptree.py``, a copy:
numpy only; reference ``clustering/sptree/SpTree.java`` — the Barnes-Hut
acceleration structure for t-SNE, with ``quadtree/QuadTree.java`` as its
2-D ancestor).

Host-side: the tree is only used by the Barnes-Hut t-SNE variant; the
exact path computes the repulsive forces as a distance matrix product on
the device (see ``tsne.py``).  Supports arbitrary dimensionality d with
2^d children per cell.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["SPTree"]


class _Cell:
    __slots__ = ("center", "half", "cum_center", "count", "point_index",
                 "children", "is_leaf")

    def __init__(self, center: np.ndarray, half: np.ndarray):
        self.center = center
        self.half = half
        self.cum_center = np.zeros_like(center)
        self.count = 0
        self.point_index: Optional[int] = None
        self.children: Optional[List[Optional["_Cell"]]] = None
        self.is_leaf = True


class SPTree:
    """Barnes-Hut tree over points [N,d]; ``compute_non_edge_forces`` returns
    the t-SNE repulsive force term and normalization Z for one query point."""

    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, dtype=np.float64)
        lo, hi = self.points.min(0), self.points.max(0)
        center = (lo + hi) / 2.0
        half = np.maximum((hi - lo) / 2.0, 1e-5) * (1 + 1e-3)
        self.root = _Cell(center, half)
        for i in range(len(self.points)):
            self._insert(self.root, i)

    def _child_for(self, cell: _Cell, p: np.ndarray) -> int:
        idx = 0
        for d in range(len(p)):
            if p[d] > cell.center[d]:
                idx |= 1 << d
        return idx

    def _descend(self, cell: _Cell, i: int):
        idx = self._child_for(cell, self.points[i])
        child = cell.children[idx]
        if child is None:
            d = len(cell.center)
            offset = np.array([(1 if (idx >> j) & 1 else -1) for j in range(d)],
                              dtype=np.float64)
            child = _Cell(cell.center + offset * cell.half / 2.0, cell.half / 2.0)
            cell.children[idx] = child
        self._insert(child, i)

    def _insert(self, cell: _Cell, i: int):
        p = self.points[i]
        cell.cum_center = (cell.cum_center * cell.count + p) / (cell.count + 1)
        cell.count += 1
        if cell.is_leaf:
            if cell.point_index is None:
                cell.point_index = i
                return
            # duplicate-point guard: keep in this leaf's aggregate only
            if np.allclose(self.points[cell.point_index], p, atol=1e-12):
                return
            old = cell.point_index
            cell.point_index = None
            cell.is_leaf = False
            cell.children = [None] * (1 << len(cell.center))
            # old point descends without re-touching this cell's aggregate
            self._descend(cell, old)
            self._descend(cell, i)
        else:
            self._descend(cell, i)

    def compute_non_edge_forces(self, query_index: int, theta: float):
        """Returns (neg_force [d], Z_contribution) for point ``query_index``
        (reference ``SpTree.computeNonEdgeForces``)."""
        q = self.points[query_index]
        neg = np.zeros_like(q)
        z = 0.0
        stack = [self.root]
        while stack:
            cell = stack.pop()
            if cell is None or cell.count == 0:
                continue
            diff = q - cell.cum_center
            d2 = float(diff @ diff)
            width = float(cell.half.max() * 2.0)
            if cell.is_leaf or (d2 > 0 and width / np.sqrt(d2) < theta):
                cnt = cell.count
                if cell.is_leaf and cell.point_index == query_index:
                    cnt -= 1  # exclude self from this leaf's aggregate
                if cnt <= 0:
                    continue
                mult = 1.0 / (1.0 + d2)
                z += cnt * mult
                neg += cnt * mult * mult * diff
            else:
                stack.extend(c for c in cell.children if c is not None)
        return neg, z
