"""Model savers (reference ``earlystopping/saver/``; port of the JAX
package's ``earlystopping/savers.py``)."""
from __future__ import annotations

import os

from ..utils import model_serializer


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


class LocalFileModelSaver:
    """Zip checkpoints on disk (reference ``LocalFileModelSaver.java``):
    ``bestModel.zip`` and ``latestModel.zip``, the JAX package's container.

    Writes go through ``model_serializer.write_model``, which commits via
    the atomic temp-then-rename helper: the frequent ``save_latest_model``
    overwrite never leaves a truncated ``latestModel.zip`` behind a crash.
    Saving does not clone, so the network's key stream is untouched.
    ``get_*_model`` restore onto ``device``: by default the device of the
    network last saved (``"cuda"`` before any save)."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _path(self, kind):
        return os.path.join(self.directory, f"{kind}Model.zip")

    def _save(self, net, kind):
        if self.device is None:
            self.device = net.device
        model_serializer.write_model(net, self._path(kind))

    def save_best_model(self, net, score):
        self._save(net, "best")

    def save_latest_model(self, net, score):
        self._save(net, "latest")

    def _get(self, kind):
        p = self._path(kind)
        if not os.path.exists(p):
            return None
        return model_serializer.restore_model(
            p, device=self.device if self.device is not None else "cuda")

    def get_best_model(self):
        return self._get("best")

    def get_latest_model(self):
        return self._get("latest")
