"""Model savers (reference ``earlystopping/saver/``; port of the JAX
package's ``InMemoryModelSaver``).  ``LocalFileModelSaver`` needs the port
to write the reference container, which it cannot yet (ROADMAP queue 1,
item 7)."""
from __future__ import annotations


class InMemoryModelSaver:
    """Keep clones in memory (reference ``InMemoryModelSaver.java``).
    ``net.clone()`` splits the network's key stream, as the JAX package's
    does, so a run that saves draws the same dropout as it does there."""

    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score):
        self._best = net.clone()

    def save_latest_model(self, net, score):
        self._latest = net.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest
