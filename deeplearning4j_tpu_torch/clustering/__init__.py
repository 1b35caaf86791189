"""clustering of the PyTorch port (port of ``clustering/``; reference
``deeplearning4j-nearestneighbors-parent/nearestneighbor-core`` +
``deeplearning4j-core/.../plot/``): KMeans and the strategy framework,
VPTree/KDTree/brute-force kNN, SPTree, and t-SNE (exact on the device,
Barnes-Hut on the host)."""
from .kmeans import ClusterSet, KMeans
from .neighbors import BruteForceNN, KDTree, VPTree, pairwise_distance
from .sptree import SPTree
from .tsne import BarnesHutTsne, Tsne
from .algorithm import (BaseClusteringAlgorithm, ClusteringOptimizationType,
                        ClusterSetInfo, ConvergenceCondition,
                        FixedClusterCountStrategy,
                        FixedIterationCountCondition, IterationHistory,
                        IterationInfo, KMeansClustering, OptimisationStrategy,
                        VarianceVariationCondition)

__all__ = ["KMeans", "ClusterSet", "BruteForceNN", "VPTree", "KDTree",
           "pairwise_distance", "SPTree", "Tsne", "BarnesHutTsne",
           "BaseClusteringAlgorithm", "ClusteringOptimizationType",
           "ClusterSetInfo", "ConvergenceCondition",
           "FixedClusterCountStrategy", "FixedIterationCountCondition",
           "IterationHistory", "IterationInfo", "KMeansClustering",
           "OptimisationStrategy", "VarianceVariationCondition"]
