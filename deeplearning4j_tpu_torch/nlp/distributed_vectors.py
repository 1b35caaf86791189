"""Distributed embedding training: partitioned corpus → per-worker
SequenceVectors → averaged tables (port of ``nlp/distributed_vectors.py``).

Reference ``dl4j-spark-nlp``: ``SparkWord2Vec``/``SparkSequenceVectors``
build the vocabulary on the coordinating process, map partitions of the sentence RDD
through per-executor SGNS training, and average the resulting word vectors
(``Word2Vec.java:61`` mapPartitions :211).  Here the vocab is built once
(one shared index space), the corpus splits into worker shards trained
through the same bulk NS fast path, and the final tables are averaged —
the same parameter-averaging contract the TrainingMasters use for
networks.

Two worker substrates:

- ``train_word2vec_distributed``: in-process threads (each worker's fit is
  dominated by its own device launches, so threads already prove the
  semantics).
- ``train_word2vec_multiprocess``: workers as OS processes on the
  ``MultiprocessMaster`` substrate (``parallel/master_mp.py``) — the
  reference's executor-JVM topology, with the same task-retry contract
  (a dead worker's shard re-executes on a fresh process).  The job carries
  the model's device: the workers train there (the card unless the model
  was built with ``device="cpu"``).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .word2vec import Word2Vec

__all__ = ["train_word2vec_distributed", "train_word2vec_multiprocess"]


def train_word2vec_distributed(sentences: Sequence[str], num_workers: int = 2,
                               **w2v_kwargs) -> Word2Vec:
    """Train Word2Vec over ``num_workers`` corpus shards and average.

    The returned model owns the shared vocabulary and the averaged
    syn0/syn1neg tables.  Semantics mirror the reference's parameter
    averaging: each shard trains independently from the same initial
    weights, then tables average (weighted equally — the reference's
    counter-weighted variant reduces to this for near-even shards).
    """
    if num_workers < 1:
        raise ValueError("num_workers must be >= 1")
    sentences = list(sentences)  # materialize once; reused by every shard
    master = Word2Vec(sentences=sentences, **w2v_kwargs)
    master.build_vocab()       # one shared vocab (one index space)
    if num_workers == 1:
        master.fit()
        return master

    shards = [sentences[i::num_workers] for i in range(num_workers)]
    workers: List[Word2Vec] = []
    for shard in shards:
        w = Word2Vec(sentences=shard, **w2v_kwargs)
        # share the master's vocab + fresh identically-seeded weights so
        # every worker starts from the same point in the same index space
        w.vocab = master.vocab
        from .lookup_table import InMemoryLookupTable
        w.lookup_table = InMemoryLookupTable(
            master.vocab, master.layer_size, seed=master.seed,
            use_hs=master.use_hs, negative=master.negative,
            device=master.device)
        w.lookup_table.reset_weights()
        workers.append(w)

    errors: List[Exception] = []

    def run(w: Word2Vec):
        try:
            w.fit()
        except Exception as e:   # surface worker crashes to the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(w,)) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

    lt = master.lookup_table
    for name in ("syn0", "syn1", "syn1neg"):
        # one-time table collection AFTER all workers joined — not hot
        parts = [getattr(w.lookup_table, name).cpu().numpy()
                 for w in workers if getattr(w.lookup_table, name) is not None]
        if parts:
            setattr(lt, name, torch.from_numpy(np.mean(parts, axis=0)).to(
                master.device))
    return master


# ------------------------------------------------------------- OS processes
_W2V_FINAL = "w2v.final"


def _table_names(lt) -> List[str]:
    return [n for n in ("syn0", "syn1", "syn1neg")
            if getattr(lt, n) is not None]


def _pack_tables(lt) -> np.ndarray:
    return np.concatenate([getattr(lt, n).cpu().numpy().astype(
        np.float32).ravel() for n in _table_names(lt)])


def _unpack_tables(lt, vec: np.ndarray) -> None:
    off = 0
    for n in _table_names(lt):
        shape = tuple(getattr(lt, n).shape)
        size = int(np.prod(shape))
        setattr(lt, n, torch.from_numpy(
            vec[off:off + size].reshape(shape).copy()).to(lt.device))
        off += size


def _make_w2v_master_cls():
    """Subclass of MultiprocessMaster pointing the worker entry at this
    module and swapping model serialization for the Word2Vec format.
    Built lazily (and cached) so importing nlp does not import the
    parallel package."""
    global _W2VMaster
    if _W2VMaster is None:
        from ..parallel.master_mp import MultiprocessMaster

        class _W2VMasterCls(MultiprocessMaster):
            _WORKER_MODULE = "deeplearning4j_tpu_torch.nlp.distributed_vectors"

            def _write_job(self, model, jobdir):
                from .serializer import write_full_model
                write_full_model(model, os.path.join(jobdir, "w2v.zip"))

            def _load_kernels(self, model):
                pass    # the embedding steps launch no hand-written kernel

        _W2VMaster = _W2VMasterCls
    return _W2VMaster


_W2VMaster = None


class Word2VecProcessMaster:
    """``dl4j-spark-nlp`` ``Word2Vec.java:61`` over OS processes: the master
    builds the shared vocab, workers train corpus shards from identical
    initial tables, the master averages the final tables.  Rides the
    ``MultiprocessMaster`` spawn/retry/collect machinery — a worker that
    dies mid-shard is respawned and its shard re-executed (shards are
    stateless: one round, averaged at the end)."""

    def __init__(self, num_workers: int = 2,
                 worker_env: Optional[Dict[str, str]] = None,
                 timeout: float = 600.0, max_task_retries: int = 2,
                 fault_injection: Optional[Dict[str, object]] = None):
        self._mm_args = dict(
            num_workers=num_workers, worker_env=worker_env,
            timeout=timeout, max_task_retries=max_task_retries,
            fault_injection=fault_injection)
        self._mm = None
        self.num_workers = num_workers

    @property
    def last_results(self):
        return [] if self._mm is None else self._mm.last_results

    @property
    def retried_workers(self):
        return set() if self._mm is None else self._mm.retried_workers

    def fit(self, model: Word2Vec, jobdir: Optional[str] = None) -> Word2Vec:
        import tempfile

        if model.vocab is None:
            model.build_vocab()        # the master's shared index space
        jobdir = jobdir or tempfile.mkdtemp(prefix="dl4j_w2v_mp_")
        os.makedirs(jobdir, exist_ok=True)
        sentences = [s for s in model.sentence_iterator]
        for w in range(self.num_workers):
            with open(os.path.join(jobdir, f"shard_{w}.txt"), "w") as f:
                f.write("\n".join(sentences[w::self.num_workers]))
        # the job's device is the model's: the workers train where the
        # master's tables live
        mm = self._mm = _make_w2v_master_cls()(device=model.device,
                                                **self._mm_args)

        def run(broker, sub):
            frames = mm._collect(sub, self.num_workers, "w2v tables",
                                 jobdir)
            return np.mean([frames[w] for w in sorted(frames)], axis=0)

        vec = mm._run_job(model, jobdir, {"task": "w2v"},
                          lambda broker: broker.subscribe(_W2V_FINAL),
                          run, resume_payload=lambda wid: ({}, None))
        _unpack_tables(model.lookup_table, vec)
        return model


def train_word2vec_multiprocess(sentences: Sequence[str],
                                num_workers: int = 2,
                                worker_env: Optional[Dict[str, str]] = None,
                                jobdir: Optional[str] = None,
                                **w2v_kwargs) -> Word2Vec:
    """Multiprocess counterpart of :func:`train_word2vec_distributed` —
    same averaging semantics, workers as OS processes."""
    model = Word2Vec(sentences=list(sentences), **w2v_kwargs)
    master = Word2VecProcessMaster(num_workers=num_workers,
                                   worker_env=worker_env)
    return master.fit(model, jobdir=jobdir)


def _worker_main(jobdir: str, wid: int, port: int,
                 resume_file: Optional[str] = None) -> None:
    """Worker entry (``python -m
    deeplearning4j_tpu_torch.nlp.distributed_vectors <jobdir> <wid> <port>
    [resume]``): restore the master's model+vocab+initial tables on the
    job's device, train the shard, publish the packed tables."""
    from ..parallel.master_mp import _DONE, _encode_frame
    from ..streaming.broker import TcpMessageBroker
    from .serializer import read_full_model

    resume: Dict[str, object] = {}
    if resume_file is not None:
        with open(resume_file) as f:
            resume = json.load(f)
    broker = TcpMessageBroker(port=port)
    if resume.get("skip_to_done"):
        broker.publish(_DONE, json.dumps(
            {"wid": wid, "steps": 0, "resumed": True,
             "skipped": True}).encode())
        return
    with open(os.path.join(jobdir, "spec.json")) as f:
        spec = json.load(f)
    fault = {} if resume_file is not None else spec.get("fault", {})
    if wid in fault.get("die_at_start", []):
        os._exit(3)
    model = read_full_model(os.path.join(jobdir, "w2v.zip"),
                            device=spec["device"])
    with open(os.path.join(jobdir, f"shard_{wid}.txt")) as f:
        shard = [ln for ln in f.read().splitlines() if ln]
    from .sentence_iterator import CollectionSentenceIterator
    model.sentence_iterator = CollectionSentenceIterator(shard)
    t0 = time.perf_counter()
    model.fit()
    # close the clock on a host fetch: fit() only enqueues device work
    tables = _pack_tables(model.lookup_table)
    dt = max(time.perf_counter() - t0, 1e-9)
    n_words = sum(len(s.split()) for s in shard) * model.epochs
    broker.publish(_W2V_FINAL, _encode_frame(wid, 0, tables))
    broker.publish(_DONE, json.dumps(
        {"wid": wid, "steps": len(shard), "resumed": resume_file is not None,
         "words_per_sec": n_words / dt, "device": str(model.device),
         # the top-level packages this worker loaded, for the caller's
         # check of what the workers import
         "packages": sorted({m.split(".")[0] for m in sys.modules})
         }).encode())


if __name__ == "__main__":
    _worker_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                 sys.argv[4] if len(sys.argv) > 4 else None)
