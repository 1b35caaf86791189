"""The port's input pipeline (``data/pipeline.py``) against the JAX
package's, on the CPU (``device="cpu"``; the card's stream order is
checked by ``chip_smoke.py`` phase 54).

The device prefetch yields the same batches as the JAX package's, in
order, as torch tensors; both refuse the same misuse; errors of the
producer and of an ETL worker (with its traceback) reach the consumer;
the depth, wait and starved instruments count what happened; nothing is
left running after an early break.  The multiprocess ETL stage equals
the in-process composition (``transform`` drawn from ``(seed, epoch,
seq)``) under a slow consumer, through its slabs and through the inline
fallback.  ``fit`` from the pipeline equals ``fit`` from host batches
bit for bit, and the JAX package's ``fit`` within 2e-5 (f32 products in
another order).  On two gloo ranks, ``ParallelWrapper`` fed by the mesh
prefetcher equals the wrapper fed host batches.

Three tests spawn processes: the ETL test, the worker-error test (which
also has a worker report that it loaded neither torch nor jax) and the
gloo test.
"""
import functools
import multiprocessing
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jd
from deeplearning4j_tpu.data import pipeline as jp
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.multi_layer import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.nn.layers import feedforward as jff
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.data import dataset as td
from deeplearning4j_tpu_torch.data import pipeline as tp
from deeplearning4j_tpu_torch.data.transforms import (ComposeTransform,
                                                      RandomCropTransform,
                                                      RandomFlipTransform)
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.multi_layer import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.observability.registry import MetricsRegistry

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_pipeline_jobs as jobs  # noqa: E402
import torch_ranks  # noqa: E402

# fit vs the JAX package's fit: the same f32 ops, products summed in
# another order by XLA and by torch: 2e-5 of each leaf
TOL_JAX_FIT = 2e-5


def _arrays(n=10, f=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return x, y


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_order_and_content_match_jax(depth):
    x, y = _arrays(11)
    mask = (np.arange(44).reshape(11, 4) % 3 > 0).astype(np.float32)
    make = lambda m: m.INDArrayDataSetIterator(  # noqa: E731
        x, y, 4, features_mask=mask, labels_mask=mask[:, :2])
    want = list(jp.DevicePrefetchIterator(make(jd), depth))
    got = list(tp.DevicePrefetchIterator(make(td), depth, device="cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for f in ("features", "labels", "features_mask", "labels_mask"):
            a = getattr(g, f)
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(w, f)))
    # tuples and a list of arrays (a graph's inputs) place element-wise
    tup = list(tp.DevicePrefetchIterator([(x[:4], y[:4])], device="cpu"))
    assert tup[0].features_mask is None
    np.testing.assert_array_equal(tup[0].features.numpy(), x[:4])
    multi = list(tp.DevicePrefetchIterator(
        [td.DataSet([x[:4], x[4:8]], [y[:4]])], device="cpu"))
    assert [t.shape[0] for t in multi[0].features] == [4, 4]
    # the batch sizes pass through
    assert tp.DevicePrefetchIterator(make(td), device="cpu").batch() == 4


def test_refusals_and_reentrancy_guard():
    with pytest.raises(ValueError, match="AsyncShieldDataSetIterator"):
        tp.DevicePrefetchIterator(
            td.AsyncShieldDataSetIterator(td.ExistingDataSetIterator([])),
            device="cpu")
    with pytest.raises(ValueError, match="prefetch depth must be >= 1"):
        tp.DevicePrefetchIterator([], 0, device="cpu")
    for bad in (dict(num_workers=0), dict(slots_per_worker=0)):
        with pytest.raises(ValueError, match="must be >= 1"):
            tp.MultiprocessETLIterator(jobs.image_source, **bad)
    if not torch.cuda.is_available():
        # the default device is the card: no card, no silent CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tp.DevicePrefetchIterator([])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tp.build_input_pipeline(jobs.image_source, num_workers=0)
    x, y = _arrays(12)
    it = tp.DevicePrefetchIterator(td.INDArrayDataSetIterator(x, y, 4),
                                   device="cpu")
    first = iter(it)
    next(first)
    with pytest.raises(RuntimeError, match="already being iterated"):
        next(iter(it))
    first.close()
    assert len(list(it)) == 3          # free again once the first ended


class _Broken(td.DataSetIterator):
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __iter__(self):
        yield td.DataSet(self.x[:4], self.y[:4])
        raise KeyError("the producer broke")


def test_producer_error_reaches_the_consumer():
    x, y = _arrays(8)
    got = []
    with pytest.raises(KeyError, match="the producer broke"):
        for b in tp.DevicePrefetchIterator(_Broken(x, y), device="cpu"):
            got.append(b)
    # the JAX package's relays it the same way, after the same batch
    with pytest.raises(KeyError, match="the producer broke"):
        list(jp.DevicePrefetchIterator(_Broken(x, y)))
    assert len(got) == 1


class _Slow(td.DataSetIterator):
    def __init__(self, x, y, delay):
        self.x, self.y, self.delay = x, y, delay

    def __iter__(self):
        for i in range(0, len(self.x), 2):
            time.sleep(self.delay)
            yield td.DataSet(self.x[i:i + 2], self.y[i:i + 2])


def test_depth_wait_and_starved_metrics():
    x, y = _arrays(8)
    reg = MetricsRegistry()
    list(tp.DevicePrefetchIterator(_Slow(x, y, 0.05), 2, registry=reg,
                                   device="cpu"))
    h = reg.get("training_etl_seconds")
    counts = {lab[0]: c.count for lab, c in h.samples()}
    assert counts == {"source": 4, "h2d": 4, "wait": 5}
    starved = {lab[0]: c.value for lab, c in
               reg.get("training_pipeline_starved_total").samples()}
    # every get of a batch after the first found the queue empty (a
    # slow producer); the last get, of the end marker, may find it there
    assert set(starved) == {"device"} and 3.0 <= starved["device"] <= 4.0
    assert reg.get("training_pipeline_depth") is not None
    # the JAX package registers the same families, labels and buckets
    from deeplearning4j_tpu.observability.registry import \
        MetricsRegistry as JRegistry
    jreg = JRegistry()
    list(jp.DevicePrefetchIterator(_Slow(x, y, 0.05), 2, registry=jreg))
    assert jreg.get("training_etl_seconds").buckets == h.buckets \
        == tuple(jp.ETL_BUCKETS) == tp.ETL_BUCKETS
    assert {lab[0]: c.count for lab, c in
            jreg.get("training_etl_seconds").samples()} == counts
    # a fast consumer of a ready producer is never starved past warm-up
    reg2 = MetricsRegistry()
    it = iter(tp.DevicePrefetchIterator(_Slow(x, y, 0.0), 4, registry=reg2,
                                        device="cpu"))
    next(it)
    time.sleep(0.2)                    # the producer fills the queue
    list(it)
    assert reg2.get("training_pipeline_starved_total").labels(
        "device").value == 0.0
    # fit records the trainer's own wait, stage "fetch", in one family
    from deeplearning4j_tpu_torch.observability import registry as oreg
    prev = oreg.set_default_registry(reg)
    try:
        net = MultiLayerNetwork(_port_conf(), device="cpu").init()
        net.fit(tp.DevicePrefetchIterator(_Slow(x, y, 0.0), device="cpu"))
    finally:
        oreg.set_default_registry(prev)
    assert h.labels("fetch").count == 4


def test_no_thread_left_after_an_early_break():
    x, y = _arrays(40)
    for _ in range(3):
        for b in tp.DevicePrefetchIterator(
                td.INDArrayDataSetIterator(x, y, 2), 2, device="cpu"):
            break
    assert not [t for t in threading.enumerate()
                if t.name == "device-prefetch" and t.is_alive()]


def _in_process(source, transform, seed, epoch):
    """The composition the multiprocess stage reproduces."""
    for _ in range(epoch):
        source.reset()
    for seq, ds in enumerate(source):
        rng = np.random.default_rng((seed, epoch, seq))
        yield np.ascontiguousarray(
            transform(np.asarray(ds.features), rng)), ds.labels


def test_etl_order_transforms_inline_fallback_and_teardown():
    transform = ComposeTransform([RandomCropTransform(1),
                                  RandomFlipTransform()])
    reg = MetricsRegistry()
    etl = tp.MultiprocessETLIterator(jobs.image_source, transform,
                                     num_workers=2, seed=7, registry=reg)
    etl.reset()                               # epoch 1, as fit starts one
    got = []
    for b in etl:                             # a slow consumer
        time.sleep(0.02)
        got.append((b.features, b.labels))
    want = list(_in_process(jobs.image_source(), transform, 7, 1))
    assert len(got) == len(want) == 6
    for (gf, gl), (wf, wl) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gl, wl)
    counts = {lab[0]: c.count for lab, c in
              reg.get("training_etl_seconds").samples()}
    assert counts["transform"] == 6 and counts["ring"] >= 6
    # a transform that doubles some batches, slabs sized for the plain
    # ones: those go through the pickled inline handoff, in order
    plain = jobs.image_source().data.features[:8].nbytes + \
        jobs.image_source().data.labels[:8].nbytes
    etl2 = tp.MultiprocessETLIterator(
        functools.partial(jobs.image_source, 44, 8, 5), jobs.doubling,
        num_workers=2, seed=1, slot_bytes=plain, copy_out=False)
    got2 = [np.array(b.features) for b in etl2]
    want2 = [f for f, _ in _in_process(jobs.image_source(44, 8, 5),
                                       jobs.doubling, 1, 0)]
    assert [len(g) for g in got2] == [len(w) for w in want2]
    assert max(len(w) for w in want2) == 16 and min(
        len(w) for w in want2) <= 8      # both handoffs were exercised
    for g, w in zip(got2, want2):
        np.testing.assert_array_equal(g, w)
    # an early break, through the device stage: no worker, no thread
    pipe = tp.build_input_pipeline(jobs.image_source, transform,
                                   num_workers=2, depth=2, device="cpu")
    for b in pipe:
        assert isinstance(b.features, torch.Tensor)
        break
    workers = pipe.underlying.workers
    assert workers and not any(p.is_alive() for p in workers)
    assert not multiprocessing.active_children()
    assert not [t for t in threading.enumerate()
                if t.name == "device-prefetch" and t.is_alive()]


def test_worker_error_carries_its_traceback():
    etl = tp.MultiprocessETLIterator(jobs.failing_source, num_workers=2)
    got = []
    with pytest.raises(RuntimeError) as err:
        for b in etl:
            got.append(b)
    msg = str(err.value)
    assert msg.startswith("ETL worker") and "failed:" in msg
    # the worker's own traceback: the frame and the message
    assert "raise_inside_the_source" in msg
    assert "the source broke at batch 3" in msg
    assert len(got) <= 3 and not multiprocessing.active_children()
    # a worker imports the port's data package and never loads torch
    # (nor jax): it cannot make a CUDA context on the training card
    probe = list(tp.MultiprocessETLIterator(jobs.module_probe,
                                            num_workers=1))
    np.testing.assert_array_equal(probe[0].features, [[0.0, 0.0]])


def _mlp_conf():
    return (JNNC.builder().seed(3).updater(JSgd(learning_rate=0.1)).list()
            .layer(jff.DenseLayer(n_out=8, activation="tanh"))
            .layer(jff.OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(JIT.feed_forward(3)).build())


def _port_conf():
    return MultiLayerConfiguration.from_json(_mlp_conf().to_json())


def test_fit_from_the_pipeline_equals_host_fit_and_jax():
    x, y = _arrays(40, seed=4)
    make = lambda: td.INDArrayDataSetIterator(  # noqa: E731
        x, y, 8, shuffle=True, seed=2)
    host = MultiLayerNetwork(_port_conf(), device="cpu").init()
    tree = {k: {n: p.detach().numpy().copy() for n, p in g.items()}
            for k, g in host.params.items()}
    piped = MultiLayerNetwork(_port_conf(), device="cpu").load_params(tree)
    host.fit(make(), epochs=2)
    piped.fit(tp.build_input_pipeline(make, num_workers=0, depth=2,
                                      device="cpu"), epochs=2)
    for k, g in host.params.items():
        for n, p in g.items():
            assert torch.equal(p, piped.params[k][n]), f"{k}/{n}"
    assert host.iteration == piped.iteration == 10
    # the JAX package's fit from the same params on the same batches
    with jax.enable_x64(False):
        jn = JMLN(_mlp_conf())
        jn.params = {k: {n: jnp.asarray(v) for n, v in g.items()}
                     for k, g in tree.items()}
        jn.state = {k: {} for k in tree}
        jn._tx = jn._build_tx()
        jn.opt_state = jn._tx.init(jn.params)
        jn.fit(jp.DevicePrefetchIterator(jd.INDArrayDataSetIterator(
            x, y, 8, shuffle=True, seed=2)), epochs=2)
        for k, g in jn.params.items():
            for n, v in g.items():
                v = np.asarray(v)
                np.testing.assert_allclose(
                    piped.params[k][n].detach().numpy(), v, rtol=0,
                    atol=TOL_JAX_FIT * max(1.0, np.abs(v).max()))


def test_placed_batches_through_graph_output_score_and_evaluate():
    g = (JNNC.builder().seed(5).updater(JSgd(learning_rate=0.1))
         .graph_builder())
    g.add_inputs("a").set_input_types(JIT.feed_forward(3))
    g.add_layer("h", jff.DenseLayer(n_out=6, activation="tanh"), "a")
    g.add_layer("out", jff.OutputLayer(n_out=2, activation="softmax",
                                       loss="mcxent"), "h")
    from deeplearning4j_tpu_torch.nn.conf.computation_graph import \
        ComputationGraphConfiguration
    conf = ComputationGraphConfiguration.from_json(
        g.set_outputs("out").build().to_json())
    x, y = _arrays(24, seed=6)
    a = ComputationGraph(conf, device="cpu").init()
    tree = {k: {n: p.detach().numpy().copy() for n, p in gr.items()}
            for k, gr in a.params.items()}
    b = ComputationGraph(conf, device="cpu").load_params(tree)
    a.fit(td.INDArrayDataSetIterator(x, y, 8))
    b.fit(tp.DevicePrefetchIterator(td.INDArrayDataSetIterator(x, y, 8),
                                    device="cpu"))
    for k, gr in a.params.items():
        for n, p in gr.items():
            assert torch.equal(p, b.params[k][n])
    placed = next(iter(tp.DevicePrefetchIterator(
        td.INDArrayDataSetIterator(x, y, 24), device="cpu")))
    assert torch.equal(a.output(x)[0], b.output(placed.features)[0])
    assert a.score(td.DataSet(x, y)) == b.score(placed)
    ea = a.evaluate(td.INDArrayDataSetIterator(x, y, 8))
    eb = b.evaluate(tp.DevicePrefetchIterator(
        td.INDArrayDataSetIterator(x, y, 8), device="cpu"))
    assert ea.accuracy() == eb.accuracy()
    np.testing.assert_array_equal(ea.confusion.matrix, eb.confusion.matrix)


def test_mesh_prefetcher_on_gloo_ranks_equals_host_batches():
    res = torch_ranks.run_ranks(2, "torch_pipeline_jobs:prefetch_mesh_job",
                                None)
    for r in res:
        assert r["host"]["losses"] == r["prefetch"]["losses"]
        # 11 rows trimmed to 10 at dp 2: the global count, both ways
        assert r["host"]["last_batch_size"] == \
            r["prefetch"]["last_batch_size"] == 10
        for part in ("params", "state"):
            for k, g in r["host"][part].items():
                for n, v in g.items():
                    np.testing.assert_array_equal(
                        v, r["prefetch"][part][k][n], err_msg=f"{k}/{n}")
    # every rank holds the same replica
    for k, g in res[0]["prefetch"]["params"].items():
        for n, v in g.items():
            np.testing.assert_array_equal(v, res[1]["prefetch"]["params"][k][n])
