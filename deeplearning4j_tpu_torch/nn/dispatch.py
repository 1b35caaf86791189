"""Bounded asynchronous dispatch window for the fit loop (port of
``nn/dispatch.py``).

CUDA launches are asynchronous: a train step returns its loss as a
device scalar while the card still runs it, and the host is free to run
step N+1's work (the next batch, the input copies, listener and
forensics bookkeeping) while step N executes.  Left unbounded, the host
could run arbitrarily far ahead of the card: a failure at step N would
surface many steps late, a checkpoint would capture a state the host
believes exists before the card made it, and the launch queue would
grow with the lead.  This module bounds how far the host may lead.

:class:`DispatchWindow` holds the loss tokens of in-flight steps.  Depth
semantics: at most ``depth`` steps are unmaterialized at the moment a
new step is dispatched.  :meth:`push` appends the fresh token, then
blocks on the oldest until at most ``depth - 1`` remain, so ``depth=1``
is the fully serial loop (one sync per step) and the default ``depth=2``
overlaps one step of host work with the card's execution.

The fit loop owns the drains that keep its contracts:

- epoch ends and checkpoint-due boundaries call :meth:`drain`, so a
  resumed run equals the uninterrupted one;
- exception paths call :meth:`abandon`, which never blocks.

Every drained token is NaN-checked on the host (``v != v``) with the
token's own iteration, so a deferred failure at step N surfaces within
the window bound, attributed to N and not to the step the host was
dispatching when it read it.
"""
from __future__ import annotations

import os
from collections import deque
from typing import Any, Callable, List, Optional, Tuple

from ..observability.clock import monotonic_s

DEFAULT_DEPTH = 2
ENV_VAR = "DL4J_TPU_DISPATCH_DEPTH"


def configured_depth(default: int = DEFAULT_DEPTH) -> int:
    """The in-flight window depth: ``DL4J_TPU_DISPATCH_DEPTH`` (min 1),
    else ``default``.  Read per fit, not per process: tests flip it
    between runs."""
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return default
    try:
        depth = int(raw)
    except ValueError:
        return default
    return max(1, depth)


class DispatchWindow:
    """Bounded in-flight step window (see the module docstring).

    owner: the network whose fit loop pushes here; drained tokens write
    ``owner.last_drained_score`` and ``owner.last_drained_iteration``, so
    listeners can read a finished step's loss without a sync of their own.

    profiler: the fit's ``StepProfiler`` (or None); each drained token
    calls ``profiler.drained(1)``, so the ``training_dispatch_depth``
    gauge tracks the window's real occupancy.

    on_nan: ``(iteration, value)`` callback fired when a drained token is
    not finite: the deferred-failure attribution hook.
    """

    __slots__ = ("depth", "owner", "profiler", "on_nan", "_window")

    def __init__(self, depth: Optional[int] = None, owner: Any = None,
                 profiler: Any = None,
                 on_nan: Optional[Callable[[int, float], None]] = None):
        self.depth = configured_depth() if depth is None \
            else max(1, int(depth))
        self.owner = owner
        self.profiler = profiler
        self.on_nan = on_nan
        self._window: deque = deque()

    def __len__(self) -> int:
        return len(self._window)

    def push(self, token: Any, iteration: int) -> None:
        """Admit one dispatched step's loss token; blocks on the oldest
        in-flight tokens until at most ``depth - 1`` remain (so the NEXT
        dispatch sees at most ``depth`` unmaterialized steps)."""
        self._window.append((token, iteration))
        while len(self._window) > self.depth - 1:
            self._pop_block()

    def drain(self) -> None:
        """Materialize every in-flight token (epoch end, checkpoint-due
        boundary, explicit sync point)."""
        while self._window:
            self._pop_block()

    def drain_timed(self) -> List[Tuple[int, float]]:
        """Drain like :meth:`drain`, returning ``(iteration,
        t_completed)`` per token, oldest first."""
        out = []
        while self._window:
            iteration = self._window[0][1]
            self._pop_block()
            out.append((iteration, monotonic_s()))
        return out

    def abandon(self) -> None:
        """Drop in-flight tokens WITHOUT blocking (exception paths: a
        later ``float`` of the network's score still surfaces a deferred
        failure through the data dependence on the params)."""
        self._window.clear()

    def _pop_block(self) -> float:
        token, iteration = self._window.popleft()
        # float() alone is the sync: reading a device scalar waits for the
        # stream the step was launched on, so the whole step has finished
        value = float(token)
        if self.owner is not None:
            self.owner.last_drained_score = value
            self.owner.last_drained_iteration = iteration
        if self.profiler is not None:
            self.profiler.drained(1)
        if value != value and self.on_nan is not None:
            self.on_nan(iteration, value)
        return value
