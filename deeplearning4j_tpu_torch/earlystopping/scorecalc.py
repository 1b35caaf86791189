"""Score calculators (reference ``earlystopping/scorecalc/``; copy of
the JAX package's module for the PyTorch port, batches of numpy arrays
or tensors)."""
from __future__ import annotations


class ScoreCalculator:
    """Compute a model score on held-out data; lower is better unless
    ``minimize_score`` is False."""
    minimize_score = True

    def calculate_score(self, net) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over an iterator (reference
    ``scorecalc/DataSetLossCalculator.java``; ``average=True`` weights by
    batch size as the reference does)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total, n = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        for batch in self.iterator:
            x, y, m, lm = net._normalize_batch(batch)
            if isinstance(x, list):  # graph batch
                s = net.score(inputs=x, labels=y)
                bs = int(x[0].shape[0])
            else:
                s = net.score(x=x, y=y)
                bs = int(x.shape[0])
            total += s * bs
            n += bs
        # average=False: summed loss over all examples (reference semantics)
        return total / max(n, 1) if self.average else total


class AccuracyScoreCalculator(ScoreCalculator):
    """Classification accuracy (maximize)."""
    minimize_score = False

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, net) -> float:
        return float(net.evaluate(self.iterator).accuracy())
