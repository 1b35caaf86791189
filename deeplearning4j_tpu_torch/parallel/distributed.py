"""Multi-process bootstrap + elastic checkpoint-restart (port of
``parallel/distributed.py``).

The JAX package bootstraps ``jax.distributed``; the port bootstraps
``torch.distributed``: one process per device, NCCL between cards, gloo
on the CPU.  Nothing on the machine tells a process of its cluster, so
the address, world size and rank come from the arguments or the usual
environment variables.

Failure model: recovery is *checkpoint-mediated* — every process restarts
from the latest complete checkpoint and the data iterator fast-forwards.
``ElasticTrainer`` implements that loop for a network, a
``ParallelWrapper`` or a ``ShardedTrainer``.
"""
from __future__ import annotations

import os
from typing import Callable, Iterable, Optional

import torch

from ..observability.clock import monotonic_s
from ..observability.recorder import get_flight_recorder
from .mesh import DATA_AXIS, make_mesh

__all__ = ["initialize_distributed", "global_device_mesh", "ElasticTrainer"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None, backend: Optional[str] = None
                           ) -> bool:
    """``torch.distributed.init_process_group`` from the arguments or the
    environment; a no-op (False) when no coordinator is configured, so
    the same training script runs on one process and on many.

    The address is ``host:port`` (``DL4J_TPU_COORDINATOR``, else
    ``MASTER_ADDR``:``MASTER_PORT``); the world size and rank come from
    ``DL4J_TPU_NPROCS``/``DL4J_TPU_PROC_ID`` or ``WORLD_SIZE``/``RANK``.
    The backend is NCCL when ``device`` is CUDA (the default where CUDA
    is up), else gloo.  With no device and no backend given and no CUDA,
    it raises: a caller who wants gloo on the CPU passes
    ``device="cpu"`` or ``backend="gloo"``."""
    import torch.distributed as dist
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("DL4J_TPU_COORDINATOR")
        if not coordinator_address and env.get("MASTER_ADDR") and \
                env.get("MASTER_PORT"):
            coordinator_address = f"{env['MASTER_ADDR']}:" \
                                  f"{env['MASTER_PORT']}"
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = int(env.get("DL4J_TPU_NPROCS",
                                    env.get("WORLD_SIZE", 1)))
    if process_id is None:
        process_id = int(env.get("DL4J_TPU_PROC_ID", env.get("RANK", 0)))
    if backend is None:
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: pass device='cpu' (or backend='gloo') "
                    "to start the process group on the CPU")
            device = "cuda"
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def global_device_mesh(*, dp: Optional[int] = None, tp: int = 1,
                       sp: int = 1, device=None):
    """A mesh over every process of the default group (after
    ``initialize_distributed``; one process when there is none)."""
    return make_mesh(dp=dp, tp=tp, sp=sp, device=device)


class ElasticTrainer:
    """Checkpoint-restart training loop over the durable
    :class:`~..faulttolerance.checkpoint.CheckpointManager` store.

    ``fit`` consumes ``iterator_factory()`` (a fresh batch iterable per
    call), checkpoints atomically every ``save_freq`` steps through the
    manager, and on (re)start resumes from the newest COMPLETE
    checkpoint: partial or checksum-corrupt directories are skipped,
    restore brings back params + updater + key + the global data cursor,
    and already-consumed batches fast-forward without touching the key
    stream — an interrupted-then-resumed run matches the uninterrupted
    run exactly.  A crash loses at most ``save_freq - 1`` steps.

    **Elastic membership** (optional): pass a ``member``
    (:class:`~..faulttolerance.cluster.ClusterMember`) — and, on exactly
    one host, a ``coordinator`` — and the global batch sequence is
    re-chunked over the CURRENT world size at every round (=
    ``save_freq`` batches) boundary: batch ``i`` belongs to rank ``i %
    world_size`` (``cluster.shard_owner``).  A killed host's lease
    expires, the coordinator evicts it at the next boundary, and the
    survivors' ownership map re-covers its shard; a restarted host
    restores the newest complete checkpoint from the SHARED store and is
    re-admitted at a boundary under a bumped rendezvous generation.

    A ``ShardedTrainer`` puts the trainer in sharded posture: every
    admitted member trains every batch (the sharded step is collective),
    checkpoints go through ``save_sharded`` (all ranks' blocks behind a
    ``ShardBarrier`` built from the cluster view, or a generation-0
    barrier for a static world of several ranks), and a membership change
    rebuilds the mesh over the survivors (``mesh_factory(world_size)``)
    from the boundary's checkpoint.
    """

    def __init__(self, model, checkpoint_dir: str, save_freq: int = 10,
                 keep_last: int = 2, *, manager=None, member=None,
                 coordinator=None, background: bool = False,
                 mesh_factory=None, barrier_timeout_s: float = 30.0):
        from ..faulttolerance.checkpoint import CheckpointManager
        from .sharded import ShardedTrainer
        self.model = model
        # a wrapper trains; its underlying network is what serializes,
        # and after a restore the wrapper lays the state out again
        inner = getattr(model, "model", None)
        self._net = inner if (inner is not None
                              and hasattr(model, "_place")) else model
        self.dir = checkpoint_dir
        self.save_freq = max(1, save_freq)
        self.keep_last = max(1, keep_last)
        self.manager = manager if manager is not None else CheckpointManager(
            checkpoint_dir, keep_last=self.keep_last, background=background)
        self.member = member
        self.coordinator = coordinator
        self.sharded = isinstance(model, ShardedTrainer)
        self.mesh_factory = mesh_factory
        self.barrier_timeout_s = float(barrier_timeout_s)
        self.last_restored_step = 0
        self.last_view = None
        self.trained_steps = 0      # batches THIS member actually fitted
        self.replayed_steps = 0     # of those, orphan re-covers (evictions)
        self.barrier_aborts = 0     # lost barrier rounds (never lost data)
        self.reshard_events = []    # one dict per survivor-mesh rebuild
        self.last_restore_s = 0.0   # wall seconds of the last restore

    # -- checkpoint bookkeeping ------------------------------------------
    def latest_step(self) -> int:
        """Global step of the newest COMPLETE checkpoint (0 = none)."""
        ckpts = self.manager.checkpoints()
        return int(ckpts[-1][2].get("step", ckpts[-1][0])) if ckpts else 0

    def _save(self, step: int, view=None) -> None:
        from ..faulttolerance.checkpoint import (ShardBarrier,
                                                 ShardBarrierError)
        cursor = {"batch_seq": int(step)}
        if view is not None:
            cursor["generation"] = int(view.generation)
        if not self.sharded:
            self.manager.save(self._net, cursor=cursor, step=int(step),
                              blocking=None)
            return
        mesh = self.model.mesh
        if view is None or self.member is None or view.world_size <= 1:
            if mesh.dp <= 1:
                self.manager.save_sharded(self._net, cursor=cursor,
                                          step=int(step), process_index=0,
                                          process_count=1, blocking=None)
                return
            # a static world of several ranks: each writes its blocks
            barrier = ShardBarrier(generation=0,
                                   timeout_s=self.barrier_timeout_s)
            rank, count = int(mesh.rank), int(mesh.dp)
        else:
            rank = view.rank_of(self.member.worker_id)
            if rank is None:
                return          # not (yet) admitted: nothing to contribute
            barrier, count = self._barrier_for(view), view.world_size
        try:
            self.manager.save_sharded(
                self._net, cursor=cursor, step=int(step),
                process_index=rank, process_count=count, barrier=barrier)
        except ShardBarrierError as e:
            # a lost ROUND, never lost training: the previous complete
            # checkpoint still stands and the next boundary retries
            self.barrier_aborts += 1
            rec = get_flight_recorder()
            if rec is not None:
                rec.record("cluster", "barrier_abort", step=int(step),
                           generation=int(barrier.generation),
                           error=str(e))

    def _barrier_for(self, view):
        """The barrier of one multi-writer save round: the view's
        generation fences the staging dir, lease reads supply liveness,
        and a seeded RetryPolicy paces the primary's marker polls."""
        from ..faulttolerance.checkpoint import ShardBarrier
        from ..faulttolerance.cluster import live_ranks
        from ..faulttolerance.faults import RetryPolicy
        store = self.member.store
        return ShardBarrier(
            generation=int(view.generation),
            timeout_s=self.barrier_timeout_s,
            policy=RetryPolicy(backoff_s=0.02, max_backoff_s=0.25,
                               seed=int(view.generation)),
            live_fn=lambda: live_ranks(store, view))

    def restore_latest(self) -> int:
        """Restore the newest complete checkpoint into the model; returns
        its global step (0 = fresh start).  A corrupt newest checkpoint
        is skipped for the previous complete one, and ``.tmp-`` staging
        orphans are swept (under membership only aged ones).  A sharded
        checkpoint reassembles onto the model's CURRENT mesh."""
        self.manager.sweep_orphans(
            min_age_s=2.0 * self.barrier_timeout_s
            if self.member is not None else 0.0)
        t0 = monotonic_s()
        path = self.manager.latest()
        step = 0
        if path is not None:
            _, state = self.manager.restore_any(
                path=path, net=self._net, device=self._net.device)
            cursor = state.get("cursor") or {}
            step = int(cursor.get("batch_seq", state.get("iteration", 0)))
            if self._net is not self.model:
                self.model._place()   # lay the restored state out again
        self.last_restore_s = monotonic_s() - t0
        self.last_restored_step = step
        return step

    def _remesh(self, view, step: int) -> Optional[int]:
        """Membership changed: rebuild the mesh over the survivors
        (``mesh_factory``) from the boundary's just-committed checkpoint
        (params, slots, key and cursor, a pure byte re-placement).  When
        the boundary's save did NOT land (an aborted barrier round) and
        the old mesh is intact (a growth), the LIVE state is laid out
        again instead.  When it did not land and the old mesh LOST a rank,
        that rank's blocks of the live state are gone with it: the
        survivors restore the newest complete checkpoint and the loop
        rewinds to its step (returned; None = no rewind)."""
        if not self.sharded or self.mesh_factory is None or view is None:
            return None
        old_mesh = getattr(self.model, "mesh", None)
        new_mesh = self.mesh_factory(view.world_size)
        if new_mesh is None or new_mesh is old_mesh:
            return None
        t0 = monotonic_s()
        ckpts = self.manager.checkpoints()
        sharded = [c for c in ckpts if c[2].get("sharded")]
        newest = sharded[-1] if sharded else None
        via, rewind = "replace_live", None
        lost = old_mesh is not None and old_mesh.dp > 1 and \
            new_mesh.dp < old_mesh.dp
        if newest is not None and (
                int(newest[2].get("step", newest[0])) == int(step) or lost):
            # the restore replaces every leaf: the live layout is dropped,
            # not gathered (a lost rank's blocks are gone with it)
            self.model.retarget(new_mesh)
            _, state = self.manager.restore_sharded(
                path=newest[1], net=self._net, device=self._net.device)
            via = "restore_sharded"
            at = int((state.get("cursor") or {}).get(
                "batch_seq", state.get("iteration", step)))
            if at != int(step):
                rewind = at
        elif lost:
            raise RuntimeError(
                f"a rank of the {old_mesh.dp}-rank mesh was lost at step "
                f"{step} and no complete sharded checkpoint exists: its "
                "blocks of the live state cannot be recovered")
        self.model.remesh(new_mesh)
        event = {"step": int(step), "world_size": view.world_size,
                 "generation": int(view.generation),
                 "dp": int(new_mesh.shape.get(DATA_AXIS, 1)),
                 "via": via, "rewind_to": rewind,
                 "ms": (monotonic_s() - t0) * 1e3, "t": monotonic_s()}
        self.reshard_events.append(event)
        rec = get_flight_recorder()
        if rec is not None:
            rec.record("cluster", "survivor_remesh", **event)
        return rewind

    # -- membership -------------------------------------------------------
    def _round_view(self, round_index: int):
        if self.coordinator is not None:
            return self.coordinator.begin_round(round_index)
        if self.member is not None:
            return self.member.view()
        return None

    def _owner_of(self, index: int, view) -> Optional[int]:
        if view is None or self.member is None or not view.members:
            return None
        from ..faulttolerance.cluster import shard_owner
        return view.members[shard_owner(index, view.world_size)]

    def _owns(self, index: int, view) -> bool:
        owner = self._owner_of(index, view)
        if owner is None:
            return view is None or self.member is None
        if self.sharded:
            return view.rank_of(self.member.worker_id) is not None
        return owner == self.member.worker_id

    def _writes_checkpoint(self, view) -> bool:
        """Who calls ``_save`` at a boundary: the primary always; under a
        sharded world, EVERY admitted member (each contributes its
        block)."""
        if self._is_primary(view):
            return True
        if self.sharded and (view is None or self.member is None):
            return True
        return (self.sharded and view is not None
                and self.member is not None
                and view.rank_of(self.member.worker_id) is not None)

    def _replay_orphans(self, old_view, new_view, window) -> None:
        """Batches owned by a member evicted between ``old_view`` and
        ``new_view`` were never trained: re-cover the ones the NEW
        ownership map assigns here."""
        if old_view is None or new_view is None or not window:
            return
        lost = set(old_view.members) - set(new_view.members)
        if not lost:
            return
        rec = get_flight_recorder()
        if rec is not None:
            rec.record("cluster", "members_lost", lost=sorted(lost),
                       generation=int(new_view.generation),
                       window=len(window))
        me = self.member.worker_id
        keep = []
        for index, batch, owner, t in window:
            if owner in lost:
                if self._owner_of(index, new_view) == me:
                    self.model.fit_batch(batch)
                    self.trained_steps += 1
                    self.replayed_steps += 1
                continue
            keep.append((index, batch, owner, t))
        window[:] = keep

    def _is_primary(self, view) -> bool:
        if view is None or self.member is None:
            if self.sharded:
                return int(self.model.mesh.rank or 0) == 0
            return True
        return bool(view.members) and view.members[0] == self.member.worker_id

    # -- training loop ----------------------------------------------------
    def fit(self, iterator_factory: Callable[[], Iterable],
            max_steps: Optional[int] = None) -> int:
        """Run (or resume) training; returns the final global step."""
        step = self.restore_latest()
        started_member = (self.member is not None
                          and self.member._thread is None)
        if started_member:
            self.member.start()
        done = 0
        last_saved = step
        self.trained_steps = 0
        self.replayed_steps = 0
        self.barrier_aborts = 0
        self.reshard_events = []
        view = self._round_view(step // self.save_freq)
        self.last_view = view
        window: list = [] if (self.member is not None
                              and not self.sharded) else None
        horizon_s = (2.0 * self.member.lease_ttl_s
                     if self.member is not None else 0.0)
        it = iter(iterator_factory())
        end = object()
        try:
            while True:
                batch = next(it, end)
                if batch is end:
                    break
                if done < step:      # fast-forward batches already trained
                    done += 1
                    continue
                if max_steps is not None and done >= max_steps:
                    break
                if done > last_saved and done % self.save_freq == 0:
                    new_view = self._round_view(done // self.save_freq)
                    self._replay_orphans(view, new_view, window)
                    changed = (view is not None and new_view is not None
                               and new_view.generation != view.generation)
                    view = new_view
                    self.last_view = view
                    if self._writes_checkpoint(view):
                        self._save(done, view)
                    last_saved = done
                    if changed:
                        rewind = self._remesh(view, done)
                        if rewind is not None:
                            # the survivors resume from the checkpoint
                            # they restored: a fresh pass fast-forwards
                            it = iter(iterator_factory())
                            step = last_saved = rewind
                            done = 0
                            continue
                if self._owns(done, view):
                    self.model.fit_batch(batch)
                    self.trained_steps += 1
                    rec = get_flight_recorder()
                    if rec is not None:
                        rec.record("train", "elastic_step", step=done,
                                   worker=(None if self.member is None
                                           else self.member.worker_id))
                elif window is not None:
                    now = monotonic_s()
                    window.append((done, batch,
                                   self._owner_of(done, view), now))
                    while window and now - window[0][3] > horizon_s:
                        window.pop(0)
                done += 1
            if done > last_saved:
                if self.member is not None:
                    new_view = self._round_view(done // self.save_freq)
                    self._replay_orphans(view, new_view, window)
                    view = new_view
                    self.last_view = view
                if self._writes_checkpoint(view):
                    self._save(done, view)
        except Exception as e:
            rec = get_flight_recorder()
            if rec is not None:
                rec.record("train", "elastic_fit_exception",
                           error=f"{type(e).__name__}: {e}", step=done)
                rec.maybe_dump("elastic_fit_exception", directory=self.dir)
            raise
        finally:
            self.manager.wait()
            if started_member:
                self.member.stop()
        return done
