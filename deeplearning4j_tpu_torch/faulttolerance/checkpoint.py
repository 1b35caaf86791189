"""Crash-consistent checkpoint store + exact training resume (port of
``faulttolerance/checkpoint.py``).

**Store layout** — one directory per step, committed atomically::

    <dir>/
      ckpt-00000042/
        manifest.json        step/epoch/iteration/metric + per-file sha256
        model.zip            utils/model_serializer container (params, state,
                             updater, conf) — restorable on its own
        rng.npy              the network's threefry key at snapshot time
                             (the same [2] uint32 data as the JAX package's)
        training_state.json  data-pipeline cursor (fit epoch + batch seq),
                             metric

Writes stage into a ``.tmp-`` sibling, write the manifest (checksums)
last, then commit with ONE ``os.replace`` — discovery (``latest()``)
never sees a partial directory, and a checksum-corrupt committed one is
skipped with a warning instead of crashing the restore path.  The two
packages write and read the same directories.

**Snapshot semantics**: ``save()`` takes owned host copies of the
network's tensors *without* ``clone()`` — clone splits the parent key
stream, so a clone-based snapshot would make a checkpointed run diverge
from an uncheckpointed one.  Checkpointing is an observer: a run with
checkpoints is bitwise equal to one without.  Background saves run on
one worker thread (the snapshot is taken synchronously; at most one
write is in flight; a second save joins the first).

**Resume**: ``CheckpointConfig``/``resume_from=`` on the networks' ``fit``
restore params + updater + key + cursor so an interrupted-then-resumed
run reproduces the uninterrupted run's params exactly.

Training state: the port has no shape policy (it traces nothing, so
padding buys it nothing), so it writes ``shape_policy: null`` and ignores
a JAX checkpoint's ``shape_policy`` on reading: padding changes no
result, only which compiled shapes the JAX package reuses.

**Sharded layout** (``save_sharded``/``restore_sharded``), written by the
data-parallel wrappers (``parallel/sharded.py``): each rank writes only
its blocks, the JAX package's files byte for byte in layout::

    ckpt-00000042/
      manifest.json        as above, plus "sharded": true
      model.zip            the container WITHOUT params or updater
      rng.npy
      training_state.json  as above, plus "sharded": true
      topology.json        process count, mesh shape, per-leaf global
                           shape, dtype and sharded dim (params by
                           "layer/name", updater leaves by optax order)
      shards-pNN.npz       rank NN's blocks (np.savez, uncompressed)
      shards-pNN.json      their index: kind, leaf, dim, start

A restore reassembles the blocks into global leaves at any dp, so
either package restores the other's directory.  Several writers commit
through the two-phase ``ShardBarrier``: each stages its block into one
generation-fenced ``.tmp-barrier-`` directory and posts a
``block-pNN.json`` marker; the primary commits only after every live
writer's marker lands (an eviction or a timeout aborts the round with
``ShardBarrierError``, leaving the store's newest complete checkpoint as
it was).

Metrics (observability registry): ``checkpoint_write_seconds{mode}``,
``checkpoint_bytes``, ``checkpoint_restore_total{result}``.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .atomic import (TMP_PREFIX, atomic_write_json, commit_dir,
                     manifest_for, sha256_file, staging_dir)
from ..observability.clock import monotonic_s
from ..observability.registry import default_registry
from ..observability.tracer import get_tracer
from ..utils.device import resolve_device

__all__ = ["CheckpointManager", "CheckpointConfig", "CorruptCheckpointError",
           "FitCheckpointer", "ShardBarrier", "ShardBarrierError",
           "resume_network"]

log = logging.getLogger("deeplearning4j_tpu_torch.faulttolerance")

_CKPT_RE = re.compile(r"^ckpt-(\d{8,})$")
_MANIFEST_VERSION = 1
# checkpoint write wall times: ms-scale toy nets to minutes-long models
_WRITE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                  30.0, 60.0, 300.0)
# checkpoint sizes: KB-scale tests to multi-GB models
_BYTES_BUCKETS = (1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11)
_SHARD_FILE_RE = re.compile(r"^shards-p(\d{2,})\.npz$")
_BLOCK_MARKER_RE = re.compile(r"^block-p(\d{2,})\.json$")


class CorruptCheckpointError(RuntimeError):
    """A checkpoint directory is partial or fails checksum verification."""

    def __init__(self, path, detail: str):
        self.path = str(path)
        super().__init__(f"corrupt checkpoint {self.path}: {detail}")


class ShardBarrierError(RuntimeError):
    """A multi-writer barrier save round aborted: a writer was evicted
    mid-barrier or its block marker never landed within the budget.  The
    round's shared staging dir is left as a ``.tmp-`` orphan (discovery
    never sees it; ``sweep_orphans`` reclaims it) — the store's newest
    COMPLETE checkpoint is unchanged."""


@dataclass
class ShardBarrier:
    """Coordination contract for one multi-writer ``save_sharded`` round.

    Every rank of a sharded world stages its ``shards-pNN.npz`` block
    into ONE shared staging directory, named from the step and the
    rendezvous ``generation``, so every writer of the same round agrees
    on it and a stale-generation writer (one that missed an
    eviction/admission) stages into a DIFFERENT directory no primary
    will ever commit.  After its block (and index) are durable, each
    writer posts a generation-fenced ``block-pNN.json`` marker; the
    primary commits manifest + rename only once every expected writer's
    marker has landed.

    - ``generation`` — the cluster view's rendezvous generation (0 for a
      static world): the fence tag baked into the staging-dir name and
      validated on every marker.
    - ``timeout_s`` — the primary's bounded barrier wait; expiry aborts
      the round with :class:`ShardBarrierError`.
    - ``policy`` — optional ``faults.RetryPolicy`` whose seeded backoff
      paces the marker polls (``poll_s`` is the flat fallback).
    - ``live_fn`` — optional ``() -> collection of live writer ranks``;
      when a missing writer is no longer live (its lease expired — it
      was evicted mid-barrier) the round aborts immediately instead of
      waiting out the full timeout.
    """

    generation: int = 0
    timeout_s: float = 30.0
    poll_s: float = 0.05
    policy: Optional[Any] = None
    live_fn: Optional[Any] = None


def _rng_to_np(key) -> np.ndarray:
    """The port's key (an int64 tensor of uint32 words) as the JAX
    package's raw ``[2] uint32`` key data."""
    return np.asarray(key.detach().cpu().numpy(), dtype=np.uint32)


class _Snapshot:
    """Owned host copies of a network for one checkpoint write (the
    container's ``HostModel`` plus the key), taken synchronously without
    ``clone()``, so the network's key stream is untouched."""

    def __init__(self, net):
        from ..utils.model_serializer import HostModel
        self.model = HostModel(net)
        self.iteration = self.model.iteration
        self.step = self.iteration      # dir-naming step; save() may override
        self.epoch = self.model.epoch
        self.rng = _rng_to_np(net._rng)


class _ParamlessModel:
    """What ``write_model`` needs for a sharded checkpoint's container:
    configuration, layer state and counters, no params, no updater."""

    def __init__(self, net):
        from ..utils.model_serializer import _host_tree
        self.net_class = type(net).__name__
        self.conf = net.conf
        self.params: Dict[str, Any] = {}
        self.state = _host_tree(net.state)
        self._tx = net._tx
        self.opt_state = None
        self.iteration = int(net.iteration)
        self.epoch = int(net.epoch)


def _leaf_blocks(t, dim: Optional[int], rank: int
                 ) -> Tuple[Optional[int], List[Tuple[int, np.ndarray]]]:
    """``(sharded_dim, [(start, host_block)])`` of the block of one leaf
    this rank holds: a leaf sharded on ``dim`` is this rank's block,
    starting at ``rank`` blocks in; a replicated leaf (``dim`` None) is
    one whole block at 0.  Blocks are owned host copies."""
    from ..utils.model_serializer import _host
    start = 0 if dim is None else rank * int(t.shape[dim])
    return dim, [(start, _host(t))]


def _np_dtype(t) -> str:
    return str(np.dtype(str(t.dtype).replace("torch.", "")))


class _ShardedSnapshot:
    """Host snapshot of a SHARDED network for ``save_sharded``: the model
    container is written param-less; each param / updater leaf is
    captured as this rank's block only (a replicated leaf whole, by the
    primary alone).  The layout is the one a wrapper installed
    (``net._shard_layout``: its exchange and plans); a network outside a
    wrapper saves every leaf whole.  Key-neutral like
    :class:`_Snapshot`."""

    def __init__(self, net, process_index: int, process_count: int,
                 save_updater: bool = True):
        from ..utils.model_serializer import HostModel, updater_layout
        self.model = HostModel(_ParamlessModel(net))
        self.iteration = int(net.iteration)
        self.step = self.iteration
        self.epoch = int(net.epoch)
        self.rng = _rng_to_np(net._rng)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        primary = self.process_index == 0
        layout = getattr(net, "_shard_layout", None)
        if layout is not None:
            ex, p_plan, o_plan = layout
            if getattr(ex, "model_axis", None) is not None and any(
                    d is not None for g in p_plan.values()
                    for d in g.values()):
                raise NotImplementedError(
                    "save_sharded: leaves sharded over the 'model' axis (a "
                    "tensor-parallel param_rule) — the sharded checkpoint "
                    "format indexes one sharded dim per leaf over the "
                    "data-parallel writers; save TP-sharded params through "
                    "the dense path")
            dp, rank = ex.dp, ex.rank
            mesh_desc = {"axes": ["data", "model", "seq"],
                         "shape": [int(dp), 1, 1]}
        else:
            p_plan, o_plan, dp, rank, mesh_desc = {}, {}, 1, 0, None
        spec = net.param_spec()
        topo_params: Dict[str, Any] = {}
        self.blocks: List[Tuple[str, str, Optional[int],
                                List[Tuple[int, np.ndarray]]]] = []
        for layer in sorted(spec):
            for name in sorted(spec[layer], key=lambda n: n.split("/")):
                shape, _ = spec[layer][name]
                leaf = net.params[layer][name]
                dim = p_plan.get(layer, {}).get(name)
                key = f"{layer}/{name}"
                topo_params[key] = {"shape": [int(n) for n in shape],
                                    "dtype": _np_dtype(leaf), "dim": dim}
                if dim is not None or primary:
                    # replicated leaves are identical everywhere: only
                    # the primary writes them
                    self.blocks.append(("param", key,
                                        *_leaf_blocks(leaf, dim, rank)))
        topo_opt: List[Dict[str, Any]] = []
        if net.opt_state is not None and save_updater:
            names = {k: {n: None for n in g} for k, g in spec.items()}
            for i, d in enumerate(updater_layout(net._tx, names)):
                if d[0] == "count":
                    arr = np.asarray(net.opt_state["count"][d[1]], np.int32)
                    topo_opt.append({"shape": [], "dtype": "int32",
                                     "dim": None})
                    if primary:
                        self.blocks.append(("opt", str(i),
                                            *_leaf_blocks(arr, None, 0)))
                    continue
                _, _, layer, name, slot = d
                t = net.opt_state["slots"][layer][name][slot]
                dim = o_plan.get(layer, {}).get(name)
                shape = spec[layer][name][0]
                topo_opt.append({"shape": [int(n) for n in shape],
                                 "dtype": _np_dtype(t), "dim": dim})
                if dim is not None or primary:
                    self.blocks.append(("opt", str(i),
                                        *_leaf_blocks(t, dim, rank)))
        self.topology = {"version": 1,
                         "process_count": self.process_count,
                         "mesh": mesh_desc,
                         "params": topo_params,
                         "opt": topo_opt}


class CheckpointManager:
    """Durable on-disk checkpoint store with atomic commits, checksum
    verification, retention, and background saves.

    Retention knobs compose: the last ``keep_last`` checkpoints are always
    kept; checkpoints whose step is a multiple of ``keep_every_n`` are
    never deleted; with ``keep_best`` > 0, the best ``keep_best`` by
    recorded metric (``metric_mode``: "min" for losses, "max" for
    accuracies) are also pinned.
    """

    def __init__(self, directory: str, *, keep_last: int = 3,
                 keep_every_n: Optional[int] = None, keep_best: int = 0,
                 metric_mode: str = "min", background: bool = True,
                 save_updater: bool = True, registry=None):
        if metric_mode not in ("min", "max"):
            raise ValueError(f"metric_mode must be min|max, got {metric_mode}")
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last = max(1, int(keep_last))
        self.keep_every_n = keep_every_n
        self.keep_best = int(keep_best)
        self.metric_mode = metric_mode
        self.background = background
        self.save_updater = save_updater
        self._registry = registry
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.last_error: Optional[BaseException] = None
        # chaos-harness hook: a faults.ChaosSchedule attached here gets
        # on_commit_stage(step, stage) between staged file writes and may
        # hard-kill the process
        self.chaos = None

    # ------------------------------------------------------------- metrics
    def _reg(self):
        return self._registry if self._registry is not None \
            else default_registry()

    def _observe_write(self, seconds: float, nbytes: int, mode: str) -> None:
        reg = self._reg()
        if not reg.enabled:
            return
        reg.histogram("checkpoint_write_seconds",
                      "Wall time of one committed checkpoint write",
                      ("mode",), buckets=_WRITE_BUCKETS
                      ).labels(mode).observe(seconds)
        reg.histogram("checkpoint_bytes",
                      "Committed bytes per checkpoint",
                      buckets=_BYTES_BUCKETS).observe(nbytes)

    def _count_restore(self, result: str) -> None:
        reg = self._reg()
        if reg.enabled:
            reg.counter("checkpoint_restore_total",
                        "Checkpoint restore attempts by outcome",
                        ("result",)).labels(result).inc()

    # --------------------------------------------------------------- save
    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{int(step):08d}")

    def save(self, net, *, cursor: Optional[Dict[str, int]] = None,
             metric: Optional[float] = None,
             blocking: Optional[bool] = None,
             step: Optional[int] = None) -> str:
        """Checkpoint ``net`` at its current iteration.  The snapshot is
        taken synchronously (host copies; key-neutral); the write runs on
        the background worker unless ``blocking`` (default: the manager's
        ``background`` flag inverted).  At most one write is in flight —
        a new save joins the previous one first.  ``step`` overrides the
        directory's step number.  Returns the directory the checkpoint
        commits to."""
        self.wait()                       # double-buffer: one in flight
        snap = _Snapshot(net)
        if step is not None:
            snap.step = int(step)
        final = self.path_for(snap.step)
        if blocking is None:
            blocking = not self.background
        if blocking:
            self._write(snap, final, cursor, metric, mode="sync")
        else:
            t = threading.Thread(
                target=self._write_guarded,
                args=(snap, final, cursor, metric), daemon=False,
                name="dl4j-torch-ckpt-writer")
            with self._lock:
                self._worker = t
            t.start()
        return final

    def save_sharded(self, net, *, cursor: Optional[Dict[str, int]] = None,
                     metric: Optional[float] = None,
                     blocking: Optional[bool] = None,
                     step: Optional[int] = None,
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None,
                     barrier: Optional[ShardBarrier] = None) -> str:
        """Shard-aware checkpoint of a network a ``ShardedTrainer`` (or a
        ZeRO-1 ``ParallelWrapper``) lays out over its ranks: the model
        container is written WITHOUT params, and every param/updater leaf
        is saved as this rank's block (``shards-pNN.npz`` + index) plus a
        ``topology.json`` manifest (mesh shape, per-leaf sharded dim,
        global shapes/dtypes), the JAX package's layout file for file.
        Restore with :meth:`restore_sharded` — onto ANY dp.

        ``process_index``/``process_count`` default to the wrapper's rank
        and data-axis size (0 and 1 for a network outside a wrapper).  A
        world of several writers MUST pass a :class:`ShardBarrier`: every
        rank stages its block into the round's shared generation-fenced
        staging dir and posts a completion marker; non-primary writers
        return once their block is durable, and the primary commits
        manifest + rename only after every live writer's marker lands.
        Without a barrier a primary-only commit would record
        ``process_count`` shard files but write ONE — a torn checkpoint
        every restore refuses; refuse up front."""
        layout = getattr(net, "_shard_layout", None)
        if process_index is None:
            process_index = layout[0].rank if layout is not None else 0
        if process_count is None:
            process_count = layout[0].dp if layout is not None else 1
        if (process_index != 0 or process_count > 1) and barrier is None:
            raise NotImplementedError(
                "multi-host save_sharded needs a staged-write barrier "
                "(every process's shard file must land before the "
                "primary commits) — pass barrier=ShardBarrier(...) or "
                "route multi-process saves through the elastic "
                "coordinator (ElasticTrainer over a ShardedTrainer)")
        snap = _ShardedSnapshot(net, process_index, process_count,
                                save_updater=self.save_updater)
        if step is not None:
            snap.step = int(step)
        final = self.path_for(snap.step)
        self.wait()                       # one write in flight
        if barrier is not None:
            # barrier rounds are synchronous by construction: a
            # background writer racing the next round's markers would
            # tangle two generations in one staging dir
            self._write_sharded_barrier(snap, final, cursor, metric,
                                        barrier)
            return final
        if blocking is None:
            blocking = not self.background
        if blocking:
            self._write_sharded(snap, final, cursor, metric, mode="sync")
        else:
            t = threading.Thread(
                target=self._write_guarded,
                args=(snap, final, cursor, metric, self._write_sharded),
                daemon=False, name="dl4j-torch-ckpt-writer")
            with self._lock:
                self._worker = t
            t.start()
        return final

    def wait(self) -> None:
        """Block until any in-flight background write commits."""
        with self._lock:
            t, self._worker = self._worker, None
        if t is not None:
            t.join()

    def _write_guarded(self, snap, final, cursor, metric,
                       writer=None) -> None:
        try:
            (writer or self._write)(snap, final, cursor, metric,
                                    mode="async")
        except Exception as e:
            self.last_error = e
            log.exception("background checkpoint to %s failed", final)

    def _write(self, snap: _Snapshot, final: str, cursor, metric,
               mode: str) -> None:
        from ..utils import model_serializer

        t0 = monotonic_s()
        with get_tracer().span("checkpoint.write", step=snap.iteration,
                               mode=mode):
            tmp = staging_dir(final)
            model_serializer.write_model(
                snap.model, os.path.join(tmp, "model.zip"),
                save_updater=self.save_updater)
            if self.chaos is not None:
                self.chaos.on_commit_stage(snap.step, 1)
            np.save(os.path.join(tmp, "rng.npy"), snap.rng)
            if self.chaos is not None:
                self.chaos.on_commit_stage(snap.step, 2)
            nbytes = self._finish_staging(tmp, final, snap, cursor, metric)
        self._observe_write(monotonic_s() - t0, nbytes, mode)
        try:
            self._apply_retention()
        except OSError:
            log.warning("checkpoint retention sweep failed in %s",
                        self.directory, exc_info=True)

    def _finish_staging(self, tmp: str, final: str, snap, cursor,
                        metric, sharded: bool = False,
                        pre_commit=None) -> int:
        """Write training_state.json + the checksum manifest into a staged
        checkpoint dir, then commit it with ONE rename.  Returns committed
        bytes.  Shared by the dense and sharded writers; ``pre_commit``
        (barrier path) runs between the manifest write and the rename."""
        state = {
            "cursor": dict(cursor or {}),
            "iteration": snap.iteration,
            "epoch": snap.epoch,
            "rng_typed": False,
            "shape_policy": None,
            "metric": None if metric is None else float(metric),
        }
        if sharded:
            state["sharded"] = True
        with open(os.path.join(tmp, "training_state.json"), "w",
                  encoding="utf-8") as f:
            json.dump(state, f, sort_keys=True, indent=1)
        files = manifest_for(tmp)
        nbytes = sum(int(v["bytes"]) for v in files.values())
        manifest = {"version": _MANIFEST_VERSION,
                    "step": snap.step, "epoch": snap.epoch,
                    "iteration": snap.iteration,
                    "metric": state["metric"],
                    "wall_time": time.time(),
                    "files": files}
        if sharded:
            manifest["sharded"] = True
        atomic_write_json(os.path.join(tmp, "manifest.json"), manifest)
        if pre_commit is not None:
            pre_commit()
        commit_dir(tmp, final)
        return nbytes

    def _write_sharded(self, snap: "_ShardedSnapshot", final: str, cursor,
                       metric, mode: str) -> None:
        from ..utils import model_serializer

        t0 = monotonic_s()
        with get_tracer().span("checkpoint.write_sharded",
                               step=snap.iteration, mode=mode):
            tmp = staging_dir(final)
            # param-less container: conf + replicated layer state + meta
            model_serializer.write_model(
                snap.model, os.path.join(tmp, "model.zip"),
                save_updater=False)
            np.save(os.path.join(tmp, "rng.npy"), snap.rng)
            atomic_write_json(os.path.join(tmp, "topology.json"),
                              snap.topology)
            if self.chaos is not None:
                self.chaos.on_commit_stage(snap.step, 1)
            self._write_shard_block(tmp, snap)
            if self.chaos is not None:
                self.chaos.on_commit_stage(snap.step, 2)
            nbytes = self._finish_staging(tmp, final, snap, cursor, metric,
                                          sharded=True)
        self._observe_write(monotonic_s() - t0, nbytes, mode)
        try:
            self._apply_retention()
        except OSError:
            log.warning("checkpoint retention sweep failed in %s",
                        self.directory, exc_info=True)

    @staticmethod
    def _write_shard_block(tmp: str, snap: "_ShardedSnapshot") -> None:
        """Write THIS rank's shard blocks (``shards-pNN.npz``, ``np.savez``
        uncompressed) and their index into a staging dir, fsynced — a
        completion marker posted after this returns only ever advertises
        durable bytes."""
        from .atomic import _fsync_path
        arrays: Dict[str, np.ndarray] = {}
        index: List[Dict[str, Any]] = []
        for kind, leaf_key, dim, blocks in snap.blocks:
            for start, block in blocks:
                name = f"b{len(index)}"
                arrays[name] = block
                index.append({"name": name, "kind": kind,
                              "leaf": leaf_key, "dim": dim,
                              "start": int(start)})
        pidx = snap.process_index
        npz = os.path.join(tmp, f"shards-p{pidx:02d}.npz")
        np.savez(npz, **arrays)
        _fsync_path(npz)
        atomic_write_json(os.path.join(tmp, f"shards-p{pidx:02d}.json"),
                          index)

    # ------------------------------------------------- multi-writer barrier
    def barrier_staging(self, final: str, generation: int) -> str:
        """The SHARED staging dir for one barrier round: deterministic
        from (step, generation) so every writer of the round agrees on
        it, ``.tmp-`` prefixed so discovery ignores it and orphan sweep
        reclaims an aborted round, and generation-fenced so a
        stale-generation writer stages into a directory no primary of a
        newer round will ever commit."""
        d, base = os.path.split(os.path.abspath(final))
        return os.path.join(d, f"{TMP_PREFIX}barrier-{base}-"
                               f"g{int(generation):06d}")

    @staticmethod
    def _scan_block_markers(tmp: str, generation: int) -> set:
        """Writer indices whose generation-matching completion marker has
        landed in ``tmp``.  A marker carrying a different generation is
        rejected; a torn/unreadable marker is ignored (markers are
        atomic-rename writes, so this only races a concurrent sweep)."""
        have = set()
        try:
            names = os.listdir(tmp)
        except OSError:
            return have
        for name in names:
            m = _BLOCK_MARKER_RE.match(name)
            if not m:
                continue
            try:
                with open(os.path.join(tmp, name), encoding="utf-8") as f:
                    marker = json.load(f)
            except (OSError, ValueError):
                continue
            if int(marker.get("generation", -1)) != int(generation):
                log.warning("ignoring stale-generation block marker %s "
                            "(gen %s != round gen %d)", name,
                            marker.get("generation"), int(generation))
                continue
            have.add(int(m.group(1)))
        return have

    def _write_sharded_barrier(self, snap: "_ShardedSnapshot", final: str,
                               cursor, metric,
                               barrier: ShardBarrier) -> None:
        """One writer's side of the two-phase multi-writer commit.

        Phase 1 (every writer): stage this rank's shard block into the
        round's shared staging dir, then post the generation-fenced
        ``block-pNN.json`` marker.  Non-primary writers return here.

        Phase 2 (primary only): write the param-less container + key +
        topology, wait — bounded, backoff-paced — for every expected
        writer's marker, then commit manifest + rename.  A writer
        evicted mid-barrier (``live_fn``) or a timeout aborts the round:
        the staging dir is left as a ``.tmp-`` orphan for sweep and
        :class:`ShardBarrierError` is raised — the store's newest
        complete checkpoint is untouched."""
        from ..utils import model_serializer

        t0 = monotonic_s()
        primary = snap.process_index == 0
        mode = "barrier-primary" if primary else "barrier"
        with get_tracer().span("checkpoint.write_sharded_barrier",
                               step=snap.iteration, mode=mode,
                               generation=int(barrier.generation)):
            tmp = self.barrier_staging(final, barrier.generation)
            os.makedirs(tmp, exist_ok=True)
            if primary:
                model_serializer.write_model(
                    snap.model, os.path.join(tmp, "model.zip"),
                    save_updater=False)
                np.save(os.path.join(tmp, "rng.npy"), snap.rng)
                atomic_write_json(os.path.join(tmp, "topology.json"),
                                  snap.topology)
                if self.chaos is not None:
                    self.chaos.on_commit_stage(snap.step, 1)
            self._write_shard_block(tmp, snap)
            if self.chaos is not None:
                # stage 2 = "mid-block": the shard bytes are staged but
                # the completion marker is NOT posted
                self.chaos.on_commit_stage(snap.step, 2)
            atomic_write_json(
                os.path.join(tmp, f"block-p{snap.process_index:02d}.json"),
                {"process_index": int(snap.process_index),
                 "generation": int(barrier.generation),
                 "step": int(snap.step),
                 "complete": True})
            if not primary:
                self._observe_write(monotonic_s() - t0, 0, mode)
                return
            expected = set(range(snap.process_count))
            deadline = monotonic_s() + float(barrier.timeout_s)
            attempt = 0
            while True:
                have = self._scan_block_markers(tmp, barrier.generation)
                missing = sorted(expected - have)
                if not missing:
                    break
                if barrier.live_fn is not None:
                    try:
                        live = set(barrier.live_fn())
                    except Exception:
                        live = expected     # liveness unknown: keep waiting
                    dead = sorted(set(missing) - live)
                    if dead:
                        self._abort_barrier(
                            tmp, f"writer(s) {dead} evicted mid-barrier "
                                 f"(round generation {barrier.generation})")
                if monotonic_s() > deadline:
                    self._abort_barrier(
                        tmp, f"block marker(s) from writer(s) {missing} "
                             f"never landed within {barrier.timeout_s:.1f}s")
                attempt += 1
                if barrier.policy is not None:
                    barrier.policy.sleep(attempt,
                                         worker=snap.process_index)
                else:
                    time.sleep(barrier.poll_s)
            if self.chaos is not None:
                # stage 3 = between barrier and commit
                self.chaos.on_commit_stage(snap.step, 3)
            nbytes = self._finish_staging(
                tmp, final, snap, cursor, metric, sharded=True,
                # stage 4 = after the manifest, before the rename
                pre_commit=(None if self.chaos is None else
                            lambda: self.chaos.on_commit_stage(
                                snap.step, 4)))
        self._observe_write(monotonic_s() - t0, nbytes, mode)
        try:
            self._apply_retention()
        except OSError:
            log.warning("checkpoint retention sweep failed in %s",
                        self.directory, exc_info=True)

    def _abort_barrier(self, tmp: str, detail: str):
        """Abort a barrier round: the shared staging dir stays behind as
        a ``.tmp-`` orphan (never a commit candidate; ``sweep_orphans``
        reclaims it once it ages past any in-flight round)."""
        reg = self._reg()
        if reg.enabled:
            reg.counter("checkpoint_barrier_aborts_total",
                        "Multi-writer sharded save rounds aborted before "
                        "commit").inc()
        log.warning("sharded barrier save aborted: %s (staging %s left "
                    "for orphan sweep)", detail, tmp)
        raise ShardBarrierError(f"sharded barrier save aborted: {detail}")

    # ---------------------------------------------------------- discovery
    @staticmethod
    def validate(path: str) -> Dict[str, Any]:
        """Verify a checkpoint directory: manifest present and parseable,
        every listed file present with a matching SHA-256.  Returns the
        manifest; raises :class:`CorruptCheckpointError` otherwise."""
        mpath = os.path.join(path, "manifest.json")
        if not os.path.isfile(mpath):
            raise CorruptCheckpointError(path, "manifest.json missing "
                                               "(uncommitted or partial)")
        try:
            with open(mpath, encoding="utf-8") as f:
                manifest = json.load(f)
        except ValueError as e:
            raise CorruptCheckpointError(path, f"manifest unreadable: {e}")
        files = manifest.get("files")
        if not isinstance(files, dict) or not files:
            raise CorruptCheckpointError(path, "manifest lists no files")
        for name, want in files.items():
            fpath = os.path.join(path, name)
            if not os.path.isfile(fpath):
                raise CorruptCheckpointError(path, f"{name} missing")
            if os.path.getsize(fpath) != int(want["bytes"]):
                raise CorruptCheckpointError(
                    path, f"{name}: size {os.path.getsize(fpath)} != "
                          f"manifest {want['bytes']}")
            got = sha256_file(fpath)
            if got != want["sha256"]:
                raise CorruptCheckpointError(
                    path, f"{name}: checksum mismatch "
                          f"({got[:12]}… != {want['sha256'][:12]}…)")
        return manifest

    def checkpoints(self, validate: bool = True
                    ) -> List[Tuple[int, str, Dict[str, Any]]]:
        """All valid checkpoints, ascending by step: ``(step, path,
        manifest)``.  Partial/corrupt directories are skipped with a
        warning (and counted) instead of raising."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in sorted(names):
            m = _CKPT_RE.match(name)
            if not m:
                continue
            path = os.path.join(self.directory, name)
            if not os.path.isdir(path):
                continue
            try:
                manifest = self.validate(path) if validate else {}
            except CorruptCheckpointError as e:
                log.warning("skipping corrupt checkpoint: %s", e)
                self._count_restore("skipped")
                continue
            out.append((int(m.group(1)), path, manifest))
        return out

    def latest(self) -> Optional[str]:
        """Path of the newest VALID checkpoint, or None.  ``.tmp-`` staging
        orphans and checksum-corrupt directories are never candidates."""
        ckpts = self.checkpoints()
        return ckpts[-1][1] if ckpts else None

    def latest_complete(self, after_step: int = -1, kind: str = "any"
                        ) -> Optional[Tuple[int, str]]:
        """Newest manifest-verified checkpoint strictly newer than
        ``after_step``: ``(step, path)`` or None (the serving tier's
        train→serve promotion poll).  ``kind`` filters by layout:
        ``"any"``, ``"dense"`` or ``"sharded"``."""
        if kind not in ("any", "dense", "sharded"):
            raise ValueError(f"kind must be any|dense|sharded, got {kind!r}")
        for step, path, manifest in reversed(self.checkpoints()):
            if step <= int(after_step):
                break
            sharded = bool(manifest.get("sharded"))
            if kind == "dense" and sharded:
                continue
            if kind == "sharded" and not sharded:
                continue
            return step, path
        return None

    def sweep_orphans(self, min_age_s: float = 0.0) -> int:
        """Remove ``.tmp-`` staging leftovers from crashed writers."""
        from .atomic import discard_orphans
        return discard_orphans(
            self.directory, min_age_s=min_age_s,
            log_warning=lambda p: log.warning(
                "removing crashed checkpoint staging dir %s", p))

    # ----------------------------------------------------------- restore
    def restore_any(self, path: Optional[str] = None, net=None, *,
                    mesh=None, min_shard_size: Optional[int] = None,
                    load_updater: bool = True, device="cuda"):
        """Restore a checkpoint of EITHER layout: a sharded dir
        (``topology.json`` present) through :meth:`restore_sharded`, a
        dense dir through :meth:`restore` — the one place the store's
        layout sniff lives (serving promotion and elastic restart call
        it)."""
        if path is None:
            path = self.latest()
            if path is None:
                raise FileNotFoundError(
                    f"no valid checkpoint found in {self.directory}")
        if os.path.isfile(os.path.join(path, "topology.json")):
            return self.restore_sharded(
                path=path, net=net, mesh=mesh,
                min_shard_size=min_shard_size, load_updater=load_updater,
                device=device)
        return self.restore(path=path, net=net, load_updater=load_updater,
                            device=device)

    def restore(self, path: Optional[str] = None, net=None,
                load_updater: bool = True, device="cuda"):
        """Restore from ``path`` (default: ``latest()``).  With ``net``
        given, state is loaded INTO it (same topology, on its device);
        otherwise a fresh network is built from the saved configuration
        on ``device``.  Returns ``(net, training_state)`` where
        ``training_state`` carries the resume cursor.  Refuses
        partial/corrupt checkpoints with :class:`CorruptCheckpointError`;
        a sharded one goes through :meth:`restore_sharded`."""
        from ..utils import model_serializer

        if path is None:
            path = self.latest()
            if path is None:
                raise FileNotFoundError(
                    f"no valid checkpoint found in {self.directory}")
        try:
            self.validate(path)
        except CorruptCheckpointError:
            self._count_restore("corrupt")
            raise
        if os.path.isfile(os.path.join(path, "topology.json")):
            raise ValueError(
                f"{path} is a SHARDED checkpoint (its model container "
                "carries no params) — use restore_sharded()")
        if net is None:
            net = model_serializer.restore_model(
                os.path.join(path, "model.zip"), load_updater=load_updater,
                device=device)
        else:
            model_serializer.load_into(
                net, os.path.join(path, "model.zip"),
                load_updater=load_updater)
        state = _read_training_state(path)
        _apply_rng(net, path)
        self._count_restore("ok")
        return net, state

    def restore_sharded(self, path: Optional[str] = None, net=None, *,
                        mesh=None, min_shard_size: Optional[int] = None,
                        load_updater: bool = True, device="cuda"):
        """Restore a :meth:`save_sharded` checkpoint (either package's) at
        ANY dp: the blocks of every shard file are reassembled into
        global leaves (bytes moved, never arithmetic, so the global
        params are bitwise the saved ones) and installed whole in the
        network; a wrapper lays them out again on its mesh
        (``ParallelWrapper._place``, which ``ElasticTrainer`` calls).
        ``mesh`` and ``min_shard_size`` are accepted for the JAX
        package's signature: the layout belongs to the wrapper here.

        With ``net`` given (same topology) the state goes INTO it; if it
        is under a wrapper its old layout is dropped.  Otherwise a fresh
        network is built from the saved configuration on ``device``.
        Returns ``(net, training_state)``.  Everything is staged and
        checked before the network is touched: a mismatch leaves it as it
        was.  Refuses partial/corrupt checkpoints (a shard file failing
        its checksum, a missing one, a block that does not reassemble)
        with :class:`CorruptCheckpointError`."""
        from ..utils import model_serializer

        if path is None:
            path = self.latest()
            if path is None:
                raise FileNotFoundError(
                    f"no valid checkpoint found in {self.directory}")
        try:
            self.validate(path)
        except CorruptCheckpointError:
            self._count_restore("corrupt")
            raise
        tpath = os.path.join(path, "topology.json")
        if not os.path.isfile(tpath):
            raise ValueError(
                f"{path} is not a sharded checkpoint (no topology.json) — "
                "use restore()")
        with open(tpath, encoding="utf-8") as f:
            topo = json.load(f)

        # ---- gather every process's blocks ---------------------------
        shard_files = sorted(n for n in os.listdir(path)
                             if _SHARD_FILE_RE.match(n))
        want = int(topo.get("process_count", 1))
        if len(shard_files) != want:
            self._count_restore("corrupt")
            raise CorruptCheckpointError(
                path, f"expected {want} shard file(s), found "
                      f"{len(shard_files)}")
        blocks: Dict[Tuple[str, str], List[Tuple[int, np.ndarray]]] = {}
        dims: Dict[Tuple[str, str], Optional[int]] = {}
        for fname in shard_files:
            ipath = os.path.join(path, fname[:-len(".npz")] + ".json")
            if not os.path.isfile(ipath):
                self._count_restore("corrupt")
                raise CorruptCheckpointError(path, f"{fname} has no index")
            try:
                with open(ipath, encoding="utf-8") as f:
                    index = json.load(f)
                with np.load(os.path.join(path, fname)) as z:
                    for entry in index:
                        k = (entry["kind"], entry["leaf"])
                        dims[k] = entry["dim"]
                        bl = blocks.setdefault(k, [])
                        start = int(entry["start"])
                        if all(s != start for s, _ in bl):
                            bl.append((start, z[entry["name"]]))
            except (ValueError, KeyError, OSError) as e:
                self._count_restore("corrupt")
                raise CorruptCheckpointError(
                    path, f"{fname} unreadable: {type(e).__name__}: {e}")

        def assemble(kind: str, leaf_key: str, spec: Dict[str, Any]):
            k = (kind, leaf_key)
            if k not in blocks:
                self._count_restore("corrupt")
                raise CorruptCheckpointError(
                    path, f"no shard blocks for {kind} leaf {leaf_key}")
            dim = dims[k]
            parts = sorted(blocks[k], key=lambda sb: sb[0])
            arr = parts[0][1] if dim is None else np.concatenate(
                [b for _, b in parts], axis=dim)
            if list(arr.shape) != list(spec["shape"]):
                self._count_restore("corrupt")
                raise CorruptCheckpointError(
                    path, f"{kind} leaf {leaf_key}: reassembled shape "
                          f"{list(arr.shape)} != manifest {spec['shape']}")
            return arr

        # ---- the target network --------------------------------------
        mzip = os.path.join(path, "model.zip")
        meta, conf_json, _params, state_tree, _ = \
            model_serializer._read_container(mzip, False)
        if net is None:
            conf_cls, net_cls = model_serializer._classes(meta, mzip)
            net = net_cls(conf_cls.from_json(conf_json),
                          device=resolve_device(device))
        elif meta.get("net_class") != type(net).__name__:
            raise ValueError(
                f"saved model is a {meta.get('net_class')}, not a "
                f"{type(net).__name__}")

        # stage EVERYTHING (params and updater) before touching the net
        spec = net.param_spec()
        staged: Dict[str, Dict[str, np.ndarray]] = {}
        saved = topo.get("params", {})
        for key, pspec in saved.items():
            layer, _, name = key.partition("/")
            want_shape = spec.get(layer, {}).get(name, (None,))[0]
            if want_shape is None:
                raise ValueError(
                    f"checkpoint param key {key!r} does not match the "
                    "target network's param tree")
            if list(want_shape) != list(pspec["shape"]):
                raise ValueError(
                    f"checkpoint param {key!r} has shape {pspec['shape']} "
                    f"but the target network's is {list(want_shape)} — "
                    "topology mismatch")
            staged.setdefault(layer, {})[name] = assemble("param", key,
                                                          pspec)
        opt_specs = topo.get("opt") or []
        opt_leaves = None
        if load_updater and opt_specs:
            names = {k: {n: None for n in g} for k, g in spec.items()}
            tx = net._tx
            if tx is None:
                from ..nn._common import build_tx
                tx = build_tx(net._default_updater(), net._hyper_confs(),
                              names)
            need = len(model_serializer.updater_layout(tx, names))
            if need != len(opt_specs):
                raise ValueError(
                    f"updater state mismatch: saved {len(opt_specs)} "
                    f"leaves, model needs {need}")
            opt_leaves = [assemble("opt", str(i), s)
                          for i, s in enumerate(opt_specs)]
        if getattr(net, "_shard_layout", None) is not None:
            # a wrapper's sharded layout is gathered back first (every
            # rank restores together); the wrapper lays it out again
            from ..parallel.wrapper import _unshard
            _unshard(net)
        net.load_params(staged)
        net.load_state(state_tree)
        if opt_leaves is not None or not _slots_fit(net):
            # whole-size slots to install into (a dropped layout leaves
            # blocks behind)
            net._init_updater()
        if opt_leaves is not None:
            model_serializer.updater_state_from_jax(
                net, model_serializer._optax_shaped(
                    net._tx, net._param_tree(), opt_leaves))
        net.iteration = int(meta.get("iteration", 0))
        net.epoch = int(meta.get("epoch", 0))
        net._step = None
        state = _read_training_state(path)
        _apply_rng(net, path)
        self._count_restore("ok")
        return net, state

    # --------------------------------------------------------- retention
    def _apply_retention(self) -> None:
        ckpts = self.checkpoints(validate=False)
        if len(ckpts) <= self.keep_last:
            return
        keep = {step for step, _, _ in ckpts[-self.keep_last:]}
        if self.keep_every_n:
            keep |= {step for step, _, _ in ckpts
                     if step % int(self.keep_every_n) == 0}
        if self.keep_best > 0:
            scored = []
            for step, p, _ in ckpts:
                try:
                    metric = _read_training_state(p).get("metric")
                except (OSError, ValueError):
                    metric = None
                if metric is not None:
                    scored.append((float(metric), step))
            scored.sort(reverse=(self.metric_mode == "max"))
            keep |= {step for _, step in scored[:self.keep_best]}
        for step, p, _ in ckpts:
            if step not in keep:
                shutil.rmtree(p, ignore_errors=True)


def _slots_fit(net) -> bool:
    """Every updater slot has its parameter's shape."""
    if net.opt_state is None:
        return True
    return all(tuple(t.shape) == tuple(net.params[k][n].shape)
               for k, g in net.opt_state["slots"].items()
               for n, sl in g.items() for t in sl.values())


def _read_training_state(path: str) -> Dict[str, Any]:
    sp = os.path.join(path, "training_state.json")
    if not os.path.isfile(sp):
        return {}
    with open(sp, encoding="utf-8") as f:
        return json.load(f)


def _apply_rng(net, path: str) -> None:
    """The saved key into ``net`` (a JAX checkpoint's ``rng.npy`` holds
    the same raw uint32 words)."""
    import torch
    rp = os.path.join(path, "rng.npy")
    if os.path.isfile(rp):
        data = np.asarray(np.load(rp), dtype=np.uint32).astype(np.int64)
        net._rng = torch.tensor(data, device=net._rng.device)


@dataclass
class CheckpointConfig:
    """Declarative checkpointing for ``fit``/``fit_on_device``:

    - ``directory`` or a prebuilt ``manager``;
    - save triggers: every N optimizer iterations and/or every N epochs
      (epoch-boundary saves in ``fit_on_device``'s per-epoch path);
    - retention: ``keep_last`` / ``keep_every_n`` / ``keep_best`` (+
      ``metric_mode``);
    - ``background``: write off-thread (the train loop only pays the host
      snapshot);
    - ``save_on_preempt``: install a SIGTERM hook for the duration of the
      fit — a preemption notice triggers one final synchronous save at the
      next iteration boundary, then fit returns cleanly.
    """

    directory: Optional[str] = None
    manager: Optional[CheckpointManager] = None
    save_every_n_iterations: Optional[int] = None
    save_every_n_epochs: Optional[int] = None
    keep_last: int = 3
    keep_every_n: Optional[int] = None
    keep_best: int = 0
    metric_mode: str = "min"
    background: bool = True
    save_on_preempt: bool = False
    save_updater: bool = True
    _resolved: Optional[CheckpointManager] = field(
        default=None, repr=False, compare=False)

    def resolve(self) -> CheckpointManager:
        if self._resolved is None:
            if self.manager is not None:
                self._resolved = self.manager
            elif self.directory:
                self._resolved = CheckpointManager(
                    self.directory, keep_last=self.keep_last,
                    keep_every_n=self.keep_every_n,
                    keep_best=self.keep_best, metric_mode=self.metric_mode,
                    background=self.background,
                    save_updater=self.save_updater)
            else:
                raise ValueError(
                    "CheckpointConfig needs a directory or a manager")
        return self._resolved


def resume_network(net, resume_from, load_updater: bool = True
                   ) -> Dict[str, Any]:
    """Restore checkpoint state INTO ``net`` (on its own device) and
    return the training state (with the resume cursor).  ``resume_from``
    may be:

    - a :class:`CheckpointManager` or :class:`CheckpointConfig` (latest
      valid checkpoint in its store);
    - a checkpoint directory (``.../ckpt-00000042``);
    - a store directory containing ``ckpt-*`` entries (latest is used);
    - a bare model zip (model only — cursor resets to zero).
    """
    from ..utils import model_serializer

    if isinstance(resume_from, CheckpointConfig):
        resume_from = resume_from.resolve()
    if isinstance(resume_from, CheckpointManager):
        _, state = resume_from.restore(net=net, load_updater=load_updater)
        return state
    path = str(resume_from)
    if os.path.isdir(path):
        if os.path.isfile(os.path.join(path, "manifest.json")):
            mgr = CheckpointManager(os.path.dirname(path) or ".",
                                    background=False)
            _, state = mgr.restore(path=path, net=net,
                                   load_updater=load_updater)
            return state
        mgr = CheckpointManager(path, background=False)
        _, state = mgr.restore(net=net, load_updater=load_updater)
        return state
    # bare model container
    model_serializer.load_into(net, path, load_updater=load_updater)
    return {}


class FitCheckpointer:
    """Drives a :class:`CheckpointConfig` inside a network's fit loop:
    resume-cursor bookkeeping, iteration/epoch save triggers, and the
    optional SIGTERM save-on-preempt hook.  Built by ``fit`` when either
    ``checkpoint=`` or ``resume_from=`` is passed."""

    def __init__(self, net, config: Optional[CheckpointConfig],
                 resume_from=None):
        self.net = net
        self.config = config
        self.manager = config.resolve() if config is not None else None
        state = resume_network(net, resume_from) \
            if resume_from is not None else {}
        cursor = state.get("cursor") or {}
        self.start_epoch = int(cursor.get("fit_epoch", 0))
        self.skip_batches = int(cursor.get("batch_seq", 0))
        self._last_saved_iter = int(net.iteration)
        self._preempted = False
        self._old_handler = None
        self.preempt_saved: Optional[str] = None
        # set by the fit loop's _StepForensics: flushes buffered step
        # records into the flight recorder before a preemption dump
        self.pre_dump = None
        if self.manager is not None and config.save_on_preempt:
            import signal
            try:
                self._old_handler = signal.signal(signal.SIGTERM,
                                                  self._on_sigterm)
            except ValueError:
                # signal handlers only install from the main thread
                self._old_handler = None

    def _on_sigterm(self, signum, frame):
        self._preempted = True

    def _dump_preempt(self) -> None:
        """Commit the flight-recorder window next to the preemption
        checkpoint.  Best-effort — the preemption save itself must never
        be jeopardized by a forensics write."""
        from ..observability.recorder import get_flight_recorder
        rec = get_flight_recorder()
        if rec is None or not rec.enabled:
            return
        try:
            if self.pre_dump is not None:
                self.pre_dump()   # drain buffered step records first
            rec.record("train", "preempted", saved=self.preempt_saved,
                       iteration=int(self.net.iteration))
            rec.dump("preempt", directory=self.manager.directory)
        except Exception:
            log.warning("preemption flight dump failed", exc_info=True)

    def _save(self, fit_epoch: int, batch_seq: int,
              blocking: bool = False) -> str:
        metric = None
        try:
            metric = float(self.net._score)
        except (TypeError, ValueError, RuntimeError):
            pass
        path = self.manager.save(
            self.net, cursor={"fit_epoch": fit_epoch,
                              "batch_seq": batch_seq},
            metric=metric, blocking=True if blocking else None)
        self._last_saved_iter = int(self.net.iteration)
        return path

    def after_batch(self, fit_epoch: int, batch_seq: int) -> bool:
        """Call after each fitted batch (``batch_seq`` = batches consumed
        so far this epoch).  Saves on the iteration trigger; returns True
        when a SIGTERM was received — one final synchronous save has been
        taken and fit should return."""
        if self.manager is None:
            return False
        n = self.config.save_every_n_iterations
        if n and int(self.net.iteration) - self._last_saved_iter >= n:
            self._save(fit_epoch, batch_seq)
        if self._preempted:
            self.preempt_saved = self._save(fit_epoch, batch_seq,
                                            blocking=True)
            self._dump_preempt()
            return True
        return False

    def after_epoch(self, fit_epoch: int) -> bool:
        """Call after each completed epoch; saves on the epoch trigger
        with a cursor pointing at the next epoch's start.  An
        iteration-count trigger also fires here when enough optimizer
        steps accumulated since the last save (``fit_on_device``'s
        iterations advance by a whole epoch at a time)."""
        if self.manager is None:
            return False
        n = self.config.save_every_n_epochs
        ni = self.config.save_every_n_iterations
        if (n and (fit_epoch + 1) % n == 0) or \
                (ni and int(self.net.iteration) - self._last_saved_iter
                 >= ni):
            self._save(fit_epoch + 1, 0)
        if self._preempted:
            self.preempt_saved = self._save(fit_epoch + 1, 0, blocking=True)
            self._dump_preempt()
            return True
        return False

    def close(self) -> None:
        """Restore the SIGTERM handler and join any in-flight write."""
        if self._old_handler is not None:
            import signal
            try:
                signal.signal(signal.SIGTERM, self._old_handler)
            except ValueError:
                pass
            self._old_handler = None
        if self.manager is not None:
            self.manager.wait()
