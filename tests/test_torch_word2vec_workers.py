"""The port's distributed Word2Vec (``nlp/distributed_vectors``) against
the JAX package's, on a corpus made with numpy from a seed, on the CPU:
thread fan-out against the JAX package's threads, two worker processes
(``Word2VecProcessMaster`` on the job's device, here the CPU) against the
port's threads.  Each worker trains its shard as the fits of
``test_torch_word2vec.py`` do, at the default block size (a worker process
cannot see a patched one): averaged tables within 2e-6 (f32 dot products
and duplicate sums in other orders, a few ulps per step)."""
import jax
import numpy as np
import torch

import deeplearning4j_tpu_torch.nlp as tnlp
from deeplearning4j_tpu.nlp import distributed_vectors as jdist
from deeplearning4j_tpu_torch.nlp import distributed_vectors as tdist

TOL_FIT = 2e-6


def zipf_corpus(n=60, seed=7, vocab=40, length=10):
    rng = np.random.default_rng(seed)
    ids = np.clip(rng.zipf(1.3, size=n * length), 1, vocab) - 1
    toks = ["w%d" % i for i in ids]
    return [" ".join(toks[i * length:(i + 1) * length]) for i in range(n)]


def _syn(model, name="syn0"):
    t = getattr(model.lookup_table, name)
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_thread_and_process_workers_average_as_jax_does(tmp_path):
    """Thread fan-out against the JAX package's; two worker processes on
    the CPU (the job's device) against the port's threads.  The workers
    import neither JAX nor the JAX package."""
    sents = zipf_corpus()
    kw = dict(layer_size=16, window=3, negative=5, epochs=1, seed=2,
              batch_size=64)
    # x64 off for the JAX workers too: ``jax.enable_x64`` is thread-local,
    # so the global flag is switched for this call
    jax.config.update("jax_enable_x64", False)
    try:
        jm = jdist.train_word2vec_distributed(sents, num_workers=2, **kw)
        want = _syn(jm)
    finally:
        jax.config.update("jax_enable_x64", True)
    tm = tdist.train_word2vec_distributed(sents, num_workers=2,
                                          device="cpu", **kw)
    np.testing.assert_allclose(_syn(tm), want, rtol=0, atol=TOL_FIT)
    model = tnlp.Word2Vec(sentences=sents, device="cpu", **kw)
    # one OpenMP thread a worker: two workers of small CPU ops
    master = tdist.Word2VecProcessMaster(
        num_workers=2, timeout=120.0, worker_env={"OMP_NUM_THREADS": "1"})
    master.fit(model, jobdir=str(tmp_path))
    np.testing.assert_allclose(_syn(model), _syn(tm), rtol=0, atol=TOL_FIT)
    for r in master.last_results:
        assert r["device"] == "cpu" and r["words_per_sec"] > 0
        assert not {"jax", "jaxlib", "deeplearning4j_tpu"} & set(
            r["packages"])
        assert "deeplearning4j_tpu_torch" in r["packages"]
