"""EarlyStoppingTrainer (reference
``earlystopping/trainer/BaseEarlyStoppingTrainer.java:46`` — one class serves
both MultiLayerNetwork and ComputationGraph since fit/score share a surface).
Copy of the JAX package's module for the PyTorch port, with the
master-driven variant (``EarlyStoppingMasterTrainer``) over the training
masters of ``parallel/master.py``.
"""
from __future__ import annotations

import logging
import math

from .result import EarlyStoppingResult
from .terminations import MaxEpochsTerminationCondition

log = logging.getLogger(__name__)


class EarlyStoppingTrainer:
    def __init__(self, config, net, train_iterator):
        self.config = config
        self.net = net
        self.train_iterator = train_iterator

    def _fit_epoch(self):
        """One training epoch; returns the iteration-termination condition
        that fired, or None.  Overridden by the master-driven variant."""
        conf = self.config
        if hasattr(self.train_iterator, "reset"):
            self.train_iterator.reset()
        for batch in self.train_iterator:
            # fit_batch: no epoch bookkeeping — this loop owns epochs
            last = self.net.fit_batch(batch)
            for c in conf.iteration_terminations:
                if c.terminate(last):
                    return c
        return None

    def fit(self) -> EarlyStoppingResult:
        conf = self.config
        for c in conf.epoch_terminations:
            c.initialize()
        for c in conf.iteration_terminations:
            c.initialize()
        if not self.net.params:
            self.net.init()

        minimize = (conf.score_calculator.minimize_score
                    if conf.score_calculator else True)
        best_score = math.inf if minimize else -math.inf
        best_epoch = -1
        score_vs_epoch = {}
        epoch = 0

        while True:
            # ---- one epoch, with iteration-level termination checks -------
            it_terminated = self._fit_epoch()
            if it_terminated is not None:
                details = type(it_terminated).__name__
                log.info("early stopping: iteration termination %s", details)
                if conf.save_last_model:
                    conf.model_saver.save_latest_model(self.net,
                                                       self.net.get_score())
                return EarlyStoppingResult(
                    termination_reason="IterationTerminationCondition",
                    termination_details=details,
                    score_vs_epoch=score_vs_epoch,
                    best_model_epoch=best_epoch, best_model_score=best_score,
                    total_epochs=epoch + 1,
                    best_model=conf.model_saver.get_best_model())

            # ---- end of epoch: score + save + epoch terminations ----------
            # best-model tracking only on epochs where the held-out score was
            # actually computed — the training loss lives on a different
            # scale and must not compete with calculator scores
            calculated = (conf.score_calculator is None or
                          epoch % conf.evaluate_every_n_epochs == 0)
            if calculated:
                score = (conf.score_calculator.calculate_score(self.net)
                         if conf.score_calculator else self.net.get_score())
                score_vs_epoch[epoch] = score
                improved = (score < best_score if minimize
                            else score > best_score)
                if improved:
                    best_score, best_epoch = score, epoch
                    conf.model_saver.save_best_model(self.net, score)
            else:
                score = best_score  # placeholder; not recorded/compared
            if conf.save_last_model:
                conf.model_saver.save_latest_model(self.net, score)

            for c in conf.epoch_terminations:
                # score-based conditions only fire on evaluated epochs
                if not calculated and not isinstance(
                        c, MaxEpochsTerminationCondition):
                    continue
                if c.terminate(epoch, score, minimize):
                    details = f"{type(c).__name__} at epoch {epoch}"
                    log.info("early stopping: %s", details)
                    return EarlyStoppingResult(
                        termination_reason="EpochTerminationCondition",
                        termination_details=details,
                        score_vs_epoch=score_vs_epoch,
                        best_model_epoch=best_epoch,
                        best_model_score=best_score,
                        total_epochs=epoch + 1,
                        best_model=conf.model_saver.get_best_model())
            epoch += 1


# reference has separate EarlyStoppingTrainer / EarlyStoppingGraphTrainer;
# the graph variant is the same loop here
EarlyStoppingGraphTrainer = EarlyStoppingTrainer

# reference ``EarlyStoppingParallelTrainer`` (scaleout module): the same
# loop driving a ParallelWrapper — the wrapper duck-types the model surface
# (fit_batch/get_score/params/init), so no separate implementation needed.
EarlyStoppingParallelTrainer = EarlyStoppingTrainer


class EarlyStoppingMasterTrainer(EarlyStoppingTrainer):
    """Early stopping where each epoch is one TrainingMaster pass over the
    data (reference ``spark/earlystopping/SparkEarlyStoppingTrainer`` /
    ``BaseSparkEarlyStoppingTrainer``: fit one RDD pass per epoch, score on
    the coordinating process).  Iteration-level terminations don't apply —
    the master owns the inner loop, as the Spark workers do in the
    reference."""

    def __init__(self, config, net, master, train_iterator):
        super().__init__(config, net, train_iterator)
        self.master = master

    def _fit_epoch(self):
        if hasattr(self.train_iterator, "reset"):
            self.train_iterator.reset()
        self.master.fit(self.net, self.train_iterator)
        return None
