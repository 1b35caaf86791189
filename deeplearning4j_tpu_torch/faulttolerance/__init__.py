"""Fault tolerance (port of ``faulttolerance/``): crash-consistent
checkpoints, exact resume, fault injection and lease-based membership.

- :mod:`.atomic` — temp-then-rename commits with fsync + per-file
  checksums: the single write path for durable state (model zips,
  checkpoint directories, flight-recorder dumps).
- :mod:`.checkpoint` — :class:`CheckpointManager` (durable store:
  manifest checksums, background saves, retention, corrupt-checkpoint
  skipping), the ``fit(checkpoint=, resume_from=)`` integration for
  exact preemption-safe resume, and the sharded layout with its
  multi-writer ``ShardBarrier``.  Directories are the JAX package's: each
  package resumes from the other's.
- :mod:`.faults` — :class:`FaultInjector` (seeded, deterministic fault
  harness), :class:`RetryPolicy` (exponential backoff + jitter, per-worker
  seeded streams), and the process-level chaos harness
  (:class:`ChaosSchedule` / :class:`ChaosBroker`).
- :mod:`.cluster` — lease-based membership over a shared directory:
  :class:`FileLeaseStore`, :class:`ClusterMember` heartbeats,
  :class:`ClusterCoordinator` (eviction, round-boundary admission,
  rendezvous generation fencing).
"""
from .atomic import atomic_file, atomic_write_bytes, atomic_write_json
from .checkpoint import (CheckpointConfig, CheckpointManager,
                         CorruptCheckpointError, FitCheckpointer,
                         ShardBarrier, ShardBarrierError, resume_network)
from .cluster import (ClusterCoordinator, ClusterMember, ClusterView,
                      FileLeaseStore, live_ranks, shard_owner)
from .faults import (ChaosBroker, ChaosSchedule, FaultInjector,
                     InjectedWorkerFault, RetryPolicy)

__all__ = ["atomic_file", "atomic_write_bytes", "atomic_write_json",
           "CheckpointConfig", "CheckpointManager", "CorruptCheckpointError",
           "FitCheckpointer", "ShardBarrier", "ShardBarrierError",
           "resume_network",
           "ClusterCoordinator", "ClusterMember", "ClusterView",
           "FileLeaseStore", "live_ranks", "shard_owner",
           "ChaosBroker", "ChaosSchedule",
           "FaultInjector", "InjectedWorkerFault", "RetryPolicy"]
