"""Compilation reuse (port of ``nn/compile_cache.py``): the shared step
cache, compile observability, the train step captured as a CUDA graph,
and the persistent build cache.

1. **Shared step cache** (``shared_jit``): built step functions are kept
   in a process-global weak-value cache keyed by the network class, a
   value *topology signature* of its configuration and the step's kind.
   ``clone()`` and the replicas a training master makes from it reuse
   the built step instead of building an equal one again.  An entry lives
   as long as some network holds it.

2. **Compile observability** (``InstrumentedJit``): every compile counts
   in ``training_compile_total{fn}``, its wall time lands in
   ``training_compile_seconds{fn}`` (the JAX package's buckets) and the
   tracer gets a ``step.compile`` span.

3. **The captured step** (``StepGraphs``): on a CUDA device a network's
   qualifying train step is captured once per input shapes as a CUDA
   graph and replayed for every later step.  The step's first run for a
   key runs eagerly on the stream the capture will use, which builds the
   kernels and warms cuBLAS and the allocator.  The second run is
   captured (capture records and runs nothing) and then replayed; a host
   read on the step's path fails the capture (``host_sync_check`` runs a
   step with every such read raising, to find one).  Captures of one
   process take turns: a capture synchronizes the device and empties the
   allocator's cache first.  Before each replay the inputs are copied
   into the graph's static buffers; after it the loss and gradient
   statistics are copied out into fresh tensors, since the next replay
   overwrites them.  The graph reads the network's own tensors where
   they were at capture (params, updater slots, layer state, the key
   buffer and the updater scalars), so each entry keeps their
   ``data_ptr`` and captures again when one moved (``set_params``, a
   checkpoint restore, a hot swap, ``init()``, a new updater).  All
   graphs of one network share one memory pool.  A failed capture or
   replay raises; the step never falls back to eager.  The kernel
   wrappers' launch counters tick at capture, not at replay: the
   capture's counts are recorded and added at each replay
   (``ops/launch_count``).

4. **Persistent build cache** (``wire_persistent_cache``): with
   ``DL4J_TPU_COMPILE_CACHE=<dir>`` the kernels' ``nvcc`` builds
   (``utils/kernel_build``) go to, and load from, that directory, so a
   restarted process loads the libraries a previous one built.

What counts as a compile:

* eagerly (on the CPU, and a CUDA step that stays eager): the first call
  of a shared step with a new *abstract key*, the shapes, dtypes and
  devices of its tensor arguments.  JAX traces again on a new shape, so
  the counts equal the JAX package's in the same runs: a ``clone`` adds
  0 (it shares the built step), a ragged last batch adds 1;
* captured (a CUDA step on the graph route): a new graph entry of a
  network (its eager first run and the capture after it count once), and
  every capture again after an invalidation.  A graph is bound to its
  network's tensors, so a clone shares the built step but captures its
  own graph: one compile.

The JAX module's IR-audit hooks (``set_audit_capture``,
``audit_capture_mode`` and ``InstrumentedJit``'s ``audit_*``) serve the
JAX package's jaxpr/HLO auditor and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import weakref
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..observability.clock import monotonic_s
from ..ops import launch_count
from ..observability.registry import default_registry
from ..observability.tracer import get_tracer

__all__ = ["topology_signature", "shared_jit", "InstrumentedJit",
           "StepGraphs", "host_sync_check", "wire_persistent_cache",
           "persistent_cache_status", "trace_cache_size",
           "clear_trace_cache", "iter_trace_cache"]

# compile wall times: sub-100ms CPU toy nets up to minute-long builds
_COMPILE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0, 30.0, 60.0, 120.0, 300.0)


# --------------------------------------------------------------- signature
def _encode(obj: Any, seen: set) -> Any:
    """Canonical, value-based encoding of a configuration object tree.

    Two structurally equal configurations (a ``clone()``'s deepcopy)
    encode alike; anything that cannot be encoded by value falls back to
    an identity token, which disables sharing for that configuration
    rather than risk a false hit."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    oid = id(obj)
    if oid in seen:
        return ["@cycle"]
    if isinstance(obj, (list, tuple)):
        seen = seen | {oid}
        return [_encode(v, seen) for v in obj]
    if isinstance(obj, dict):
        seen = seen | {oid}
        return [["@dict"]] + sorted(
            ([_encode(k, seen), _encode(v, seen)] for k, v in obj.items()),
            key=lambda kv: json.dumps(kv[0], sort_keys=True))
    if isinstance(obj, (set, frozenset)):
        return [["@set"]] + sorted(
            (_encode(v, seen | {oid}) for v in obj),
            key=lambda v: json.dumps(v, sort_keys=True))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        seen = seen | {oid}
        return [["@dc", type(obj).__module__, type(obj).__qualname__]] + [
            [f.name, _encode(getattr(obj, f.name), seen)]
            for f in dataclasses.fields(obj)]
    import numpy as np
    if isinstance(obj, np.dtype):
        return ["@dtype", str(obj)]
    if isinstance(obj, np.generic):
        return _encode(obj.item(), seen)
    if isinstance(obj, np.ndarray):
        return ["@arr", str(obj.dtype), list(obj.shape),
                hashlib.sha256(np.ascontiguousarray(obj).tobytes())
                .hexdigest()]
    if isinstance(obj, type):
        return ["@type", obj.__module__, obj.__qualname__]
    if callable(obj):
        # named functions deepcopy to themselves, so module + qualname is
        # a stable value key; anonymous callables fall through to identity
        mod = getattr(obj, "__module__", None)
        qn = getattr(obj, "__qualname__", None)
        if mod and qn and "<locals>" not in qn and "<lambda>" not in qn:
            return ["@fn", mod, qn]
    # a plain object with a __dict__ (a configuration that is not a
    # dataclass): by value; otherwise an identity token (no sharing)
    d = getattr(obj, "__dict__", None)
    if isinstance(d, dict) and type(obj).__module__ != "builtins":
        seen = seen | {oid}
        return [["@obj", type(obj).__module__, type(obj).__qualname__]] + \
            sorted(([k, _encode(v, seen)] for k, v in d.items()),
                   key=lambda kv: kv[0])
    return ["@id", type(obj).__qualname__, oid]


def topology_signature(conf: Any) -> str:
    """Structural signature of a network configuration: layer and vertex
    configurations, dtypes, the updaters, preprocessors, everything that
    decides the built step, by VALUE.  A deepcopied configuration
    (``clone()``) has the same signature; any edit (fine-tuning, a fold)
    gives another."""
    payload = json.dumps(_encode(conf, set()), sort_keys=True,
                         separators=(",", ":"), default=repr)
    return hashlib.sha256(payload.encode()).hexdigest()


# ------------------------------------------------------------ abstract key
def _abstract(args: Sequence[Any], kwargs: Dict[str, Any]) -> Tuple:
    """The part of a call a new compile hangs on: shape, dtype and device
    of each tensor argument, the value of each plain one.  A dict
    argument (a params, state or updater tree) is fixed by the signature
    and is not walked."""
    import torch

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return ("t", tuple(a.shape), a.dtype, a.device)
        if isinstance(a, dict):
            return ("tree",)
        if isinstance(a, (list, tuple)):
            return tuple(leaf(v) for v in a)
        if a is None or isinstance(a, (bool, int, float, str)):
            return a
        return ("obj", type(a).__qualname__)
    return (tuple(leaf(a) for a in args),
            tuple(sorted((k, leaf(v)) for k, v in kwargs.items())))


# ------------------------------------------------------------ shared cache
class InstrumentedJit:
    """A built step that observes its own compiles (see the module
    docstring for what counts as one).  ``fn`` is the step itself, for a
    caller that counts its compiles its own way (``StepGraphs``)."""

    __slots__ = ("name", "fn", "_tls", "_seen", "_lock", "__weakref__")

    def __init__(self, fun: Callable, name: str):
        self.name = name
        self.fn = fun
        self._tls = threading.local()
        self._seen: set = set()
        self._lock = threading.Lock()

    def note_compile(self, seconds: float) -> None:
        """Count one compile of ``seconds`` (counter, histogram, span)."""
        reg = default_registry()
        if reg.enabled:
            reg.counter("training_compile_total",
                        "Step compiles: a new abstract key of an eager "
                        "step, or a CUDA-graph capture", ("fn",)
                        ).labels(self.name).inc()
            reg.histogram(
                "training_compile_seconds",
                "Wall time of calls that compiled (first run for a new "
                "key, or a capture)", ("fn",),
                buckets=_COMPILE_BUCKETS).labels(self.name).observe(seconds)
        tracer = get_tracer()
        if tracer.enabled:
            # marker span: the compile already happened; `seconds` carries
            # its duration
            with tracer.span("step.compile", fn=self.name,
                             seconds=round(seconds, 4)):
                pass

    def __call__(self, *args, **kwargs):
        key = _abstract(args, kwargs)
        with self._lock:
            new = key not in self._seen
            if new:
                self._seen.add(key)
        self._tls.traced = new
        if not new:
            return self.fn(*args, **kwargs)
        t0 = monotonic_s()
        out = self.fn(*args, **kwargs)
        self.note_compile(monotonic_s() - t0)
        return out

    @property
    def last_call_traced(self) -> bool:
        """Did THIS thread's latest call compile (a new abstract key)?"""
        return bool(getattr(self._tls, "traced", False))


_TRACE_CACHE: "weakref.WeakValueDictionary[Tuple, InstrumentedJit]" = \
    weakref.WeakValueDictionary()
_TRACE_LOCK = threading.RLock()


def shared_jit(key: Tuple, builder: Callable[[], Callable], *,
               name: str) -> InstrumentedJit:
    """Get or build a shared step.

    ``key`` is a hashable structural key (network class, topology
    signature, step kind).  ``builder()`` returns the step function,
    which must close over *configuration* only, never over a network, so
    every network of that signature can run it on its own params, state
    and updater state.  Entries are weakly held: a step stays cached
    while some network holds it."""
    with _TRACE_LOCK:
        entry = _TRACE_CACHE.get(key)
        if entry is not None:
            reg = default_registry()
            if reg.enabled:
                reg.counter("training_trace_cache_hits_total",
                            "Shared step-cache hits (a clone or replica "
                            "reused a built step)", ("fn",)
                            ).labels(name).inc()
            return entry
        entry = InstrumentedJit(builder(), name=name)
        _TRACE_CACHE[key] = entry
        return entry


def trace_cache_size() -> int:
    return len(_TRACE_CACHE)


def iter_trace_cache() -> list:
    """Snapshot of the live shared-cache entries as ``(key, entry)``
    pairs (strong references: drop the list when done)."""
    with _TRACE_LOCK:
        return [(k, v) for k, v in _TRACE_CACHE.items() if v is not None]


def clear_trace_cache() -> None:
    """Drop every shared entry (tests; live networks keep their own)."""
    with _TRACE_LOCK:
        _TRACE_CACHE.clear()


# ------------------------------------------------------------ CUDA graphs
def _clone_tree(out):
    if isinstance(out, dict):
        return {k: _clone_tree(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_clone_tree(v) for v in out)
    return out.clone() if hasattr(out, "clone") else out


# captures take turns across the threads of a process (replicas of a
# training master train in threads)
_CAPTURE_LOCK = threading.Lock()


@contextmanager
def host_sync_check():
    """Every host sync torch can see raises inside (a process-wide
    setting: for one thread's checks): a step that would break its
    capture fails here, with a traceback to the read."""
    import torch
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class _Entry:
    __slots__ = ("graph", "inputs", "outputs", "ptrs", "delta",
                 "capture_s", "captures", "replays")

    def __init__(self):
        self.graph = None
        self.inputs: List[Any] = []
        self.outputs = None
        self.ptrs: Tuple[int, ...] = ()
        self.delta: list = []
        self.capture_s = 0.0
        self.captures = 0
        self.replays = 0


class StepGraphs:
    """One network's captured train steps: one CUDA graph per key (the
    shapes, dtypes and devices of the step's inputs), all in one memory
    pool (see the module docstring)."""

    def __init__(self):
        self.entries: Dict[Tuple, _Entry] = {}
        self._pool = None
        self._stream = None

    @staticmethod
    def key_of(inputs: Sequence[Any]) -> Tuple:
        return tuple(None if t is None else
                     (tuple(t.shape), t.dtype, t.device) for t in inputs)

    def _side(self):
        import torch
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def run(self, jit: InstrumentedJit, body: Callable, inputs: Sequence,
            reads: Callable[[], List[Any]]) -> Tuple[Any, bool]:
        """One step: ``body(*inputs)`` eagerly (a new key), or the key's
        graph replayed (captured first where it has none, or where a
        tensor of ``reads()`` moved since its capture).  Returns
        ``(outputs, built)``, ``built`` True where this step ran eagerly
        or captured; the outputs are the step's own tensors, which no
        later replay overwrites."""
        import torch
        key = self.key_of(inputs)
        e = self.entries.get(key)
        cur = torch.cuda.current_stream()
        side = self._side()
        if e is None:
            t0 = monotonic_s()
            with _CAPTURE_LOCK:
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    out = body(*inputs)
                cur.wait_stream(side)
            self.entries[key] = _Entry()
            jit.note_compile(monotonic_s() - t0)
            return out, True
        ptrs = tuple(t.data_ptr() for t in reads())
        captured = e.graph is None or e.ptrs != ptrs
        if captured:
            again = e.graph is not None
            with _CAPTURE_LOCK:
                self._capture(e, body, inputs)
            e.ptrs = tuple(t.data_ptr() for t in reads())
            if again:
                # a tensor the graph reads moved: a new compile
                jit.note_compile(e.capture_s)
        for s, t in zip(e.inputs, inputs):
            if s is not None:
                s.copy_(t)
        e.graph.replay()
        e.replays += 1
        launch_count.add(e.delta)
        return _clone_tree(e.outputs), captured

    def _capture(self, e: _Entry, body: Callable, inputs: Sequence) -> None:
        import torch
        e.inputs = [None if t is None else t.clone() for t in inputs]
        g = torch.cuda.CUDAGraph()
        side = self._side()
        t0 = monotonic_s()
        try:
            # capture runs no kernel: the wrappers' counts go to the
            # record, which every replay adds
            with launch_count.recording(side) as record, \
                    torch.cuda.graph(g, pool=self._pool, stream=side,
                                     capture_error_mode="thread_local"):
                e.outputs = body(*e.inputs)
        except RuntimeError as err:
            raise RuntimeError(
                f"the train step could not be captured as a CUDA graph "
                f"({err}); a step that reads the device on the host takes "
                "an eager route (host_sync_check finds the read)") from err
        e.capture_s = monotonic_s() - t0
        e.delta = record
        if self._pool is None:
            self._pool = g.pool()
        e.graph = g
        e.captures += 1

    def stats(self) -> Dict[str, Any]:
        """Per key: captures, replays, the latest capture's seconds and
        the launches one replay adds."""
        out = {}
        for k, e in self.entries.items():
            per = {}
            for _, key, n in e.delta:
                per[str(key)] = per.get(str(key), 0) + n
            out[str(k)] = {"captures": e.captures, "replays": e.replays,
                           "capture_s": e.capture_s,
                           "launches_per_replay": per}
        return out


# -------------------------------------------------------- persistent cache
_PERSISTENT_STATUS: Dict[str, Any] = {"enabled": False}
_PERSISTENT_LOCK = threading.Lock()


def _cache_entries(path: str) -> int:
    try:
        return sum(1 for f in os.listdir(path) if f.endswith(".so"))
    except OSError:
        return 0


def wire_persistent_cache(path: Optional[str] = None) -> Dict[str, Any]:
    """Point the kernels' build cache (``utils/kernel_build.BUILD_DIR``)
    at ``path``, default ``$DL4J_TPU_COMPILE_CACHE``; with neither set
    this changes nothing and returns ``{"enabled": False}``.  The status
    counts the libraries a previous process left there
    (``existing_entries`` > 0: the first use of each kernel loads it
    instead of running ``nvcc``)."""
    global _PERSISTENT_STATUS
    if path is None:
        path = os.environ.get("DL4J_TPU_COMPILE_CACHE", "")
    if not path:
        with _PERSISTENT_LOCK:
            _PERSISTENT_STATUS = {"enabled": False}
            return dict(_PERSISTENT_STATUS)
    from pathlib import Path

    from ..utils import kernel_build
    os.makedirs(path, exist_ok=True)
    existing = _cache_entries(path)
    kernel_build.BUILD_DIR = Path(path).resolve()
    status = {"enabled": True, "dir": str(kernel_build.BUILD_DIR),
              "existing_entries": existing,
              "applied": ["kernel_build.BUILD_DIR"]}
    reg = default_registry()
    if reg.enabled:
        reg.gauge("training_persistent_cache_entries",
                  "Kernel libraries found in the persistent build cache "
                  "at wiring time").set(existing)
    with _PERSISTENT_LOCK:
        _PERSISTENT_STATUS = status
        return dict(status)


def persistent_cache_status() -> Dict[str, Any]:
    with _PERSISTENT_LOCK:
        return dict(_PERSISTENT_STATUS)
