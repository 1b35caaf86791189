"""clustering of the PyTorch port: the nearest-neighbour indexes (the
rest of the JAX package's ``clustering/`` is ROADMAP item 9 e)."""
from .neighbors import BruteForceNN, KDTree, VPTree, pairwise_distance

__all__ = ["BruteForceNN", "VPTree", "KDTree", "pairwise_distance"]
