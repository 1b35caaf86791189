"""Crash-consistent checkpoint store + exact training resume (port of the
single-device part of ``faulttolerance/checkpoint.py``).

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

The sharded layout (``save_sharded``/``restore_sharded`` and its
``ShardBarrier``) belongs with the parallel trainers and is refused here
(ROADMAP queue 1, item 8).

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

from .atomic import (atomic_write_json, commit_dir, manifest_for,
                     sha256_file, staging_dir)
from ..observability.clock import monotonic_s
from ..observability.registry import default_registry
from ..observability.tracer import get_tracer

__all__ = ["CheckpointManager", "CheckpointConfig", "CorruptCheckpointError",
           "FitCheckpointer", "ShardBarrier", "resume_network"]

log = logging.getLogger("deeplearning4j_tpu_torch.faulttolerance")

_CKPT_RE = re.compile(r"^ckpt-(\d{8,})$")
_MANIFEST_VERSION = 1
# checkpoint write wall times: ms-scale toy nets to minutes-long models
_WRITE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                  30.0, 60.0, 300.0)
# checkpoint sizes: KB-scale tests to multi-GB models
_BYTES_BUCKETS = (1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11)
_SHARDED = ("the sharded checkpoint layout is not ported yet "
            "(ROADMAP queue 1, item 8)")


class CorruptCheckpointError(RuntimeError):
    """A checkpoint directory is partial or fails checksum verification."""

    def __init__(self, path, detail: str):
        self.path = str(path)
        super().__init__(f"corrupt checkpoint {self.path}: {detail}")


class ShardBarrier:
    """The multi-writer ``save_sharded`` round's contract: refused."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ShardBarrier: {_SHARDED}")


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

    def save_sharded(self, net, **kw) -> str:
        raise NotImplementedError(f"save_sharded: {_SHARDED}")

    def wait(self) -> None:
        """Block until any in-flight background write commits."""
        with self._lock:
            t, self._worker = self._worker, None
        if t is not None:
            t.join()

    def _write_guarded(self, snap, final, cursor, metric) -> None:
        try:
            self._write(snap, final, cursor, metric, mode="async")
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
                        metric) -> int:
        """Write training_state.json + the checksum manifest into a staged
        checkpoint dir, then commit it with ONE rename.  Returns committed
        bytes."""
        state = {
            "cursor": dict(cursor or {}),
            "iteration": snap.iteration,
            "epoch": snap.epoch,
            "rng_typed": False,
            "shape_policy": None,
            "metric": None if metric is None else float(metric),
        }
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
        atomic_write_json(os.path.join(tmp, "manifest.json"), manifest)
        commit_dir(tmp, final)
        return nbytes

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
    def restore(self, path: Optional[str] = None, net=None,
                load_updater: bool = True, device="cuda"):
        """Restore from ``path`` (default: ``latest()``).  With ``net``
        given, state is loaded INTO it (same topology, on its device);
        otherwise a fresh network is built from the saved configuration
        on ``device``.  Returns ``(net, training_state)`` where
        ``training_state`` carries the resume cursor.  Refuses
        partial/corrupt checkpoints with :class:`CorruptCheckpointError`
        and sharded ones (ROADMAP queue 1, item 8)."""
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
            raise NotImplementedError(f"{path} is a sharded checkpoint: "
                                      f"{_SHARDED}")
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

    def restore_sharded(self, path: Optional[str] = None, net=None, **kw):
        raise NotImplementedError(f"restore_sharded: {_SHARDED}")

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
