"""The port's sparse-embedding gradient (``nn/sparse``) against the JAX
package's: ``coalesce``, ``embedding_lookup``'s backward and
``effective_capacity``; sparse against dense training (bitwise for SGD,
as the JAX package pins it; Adam by the lazy semantics, against the JAX
package's sparse run); the same under 2-rank ``ParallelWrapper`` and
``ShardedTrainer`` (one spawn of 2 gloo ranks); invalid ids never
corrupt other rows; an undersized capacity is refused."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import (InputType, MultiLayerNetwork,
                                NeuralNetConfiguration)
from deeplearning4j_tpu.nn import sparse as JS
from deeplearning4j_tpu.nn.conf.updaters import Adam, Sgd
from deeplearning4j_tpu.nn.layers.feedforward import (EmbeddingLayer,
                                                      EmbeddingSequenceLayer,
                                                      OutputLayer)
from deeplearning4j_tpu.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch.nn import sparse as TS
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_dp_scenarios as scen  # noqa: E402

VOCAB, DIM, CLASSES = 48, 8, 4
# Adam: the lazy updater's arithmetic is optax's on the touched rows; the
# port's Adam agrees with optax within f32 rounding (~1e-7 relative over
# 3 steps): 1e-6 of each leaf's scale.
RTOL_ADAM = 1e-6
# 2 ranks against one device: the same global objective summed in
# another order (tests/test_torch_parallel_wrapper.py): 1e-6 of scale.
RTOL_DP = 1e-6


def embed_net(sparse=True, updater=None, vocab=VOCAB, cap=None, seed=7):
    lb = (NeuralNetConfiguration.builder().seed(seed)
          .updater(updater or Sgd(learning_rate=0.1)).list())
    lb.layer(EmbeddingLayer(n_in=vocab, n_out=DIM, sparse_grad=sparse,
                            sparse_grad_capacity=cap))
    lb.layer(OutputLayer(n_out=CLASSES, activation="softmax",
                         loss="mcxent"))
    return MultiLayerNetwork(lb.build()).init()


def seq_net(sparse=True, updater=None, seed=9, timesteps=6, vocab=VOCAB):
    lb = (NeuralNetConfiguration.builder().seed(seed)
          .updater(updater or Sgd(learning_rate=0.1)).list())
    lb.layer(EmbeddingSequenceLayer(n_in=vocab, n_out=DIM,
                                    sparse_grad=sparse))
    lb.layer(RnnOutputLayer(n_out=CLASSES, activation="softmax",
                            loss="mcxent"))
    conf = lb.set_input_type(InputType.recurrent(vocab, timesteps)).build()
    return MultiLayerNetwork(conf).init()


def batch(n=16, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, VOCAB // 3, (n, 1)).astype(np.int32)
    return idx, np.eye(CLASSES, dtype=np.float32)[idx[:, 0] % CLASSES]


def seq_batch(n=8, seed=0, t=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB // 2, (n, t)).astype(np.int32)
    return ids, np.eye(CLASSES, dtype=np.float32)[ids % CLASSES]


def port_of(jn, tmp_path, name):
    path = str(tmp_path / f"{name}.zip")
    write_model(jn, path)
    return load_reference_model(path, device="cpu"), path


# ------------------------------------------------------------- units
@pytest.mark.parametrize("case", ["dupes", "all_unique", "invalid",
                                  "padded", "full_vocab"])
def test_coalesce_equals_jax(case):
    rng = np.random.default_rng(len(case))
    n_rows = 20
    if case == "dupes":
        ids, cap = rng.integers(0, 6, (5, 4)), 20
    elif case == "all_unique":
        ids, cap = rng.permutation(20)[:12].reshape(3, 4), 12
    elif case == "invalid":
        ids, cap = np.array([[-1, 3], [n_rows + 2, 3], [7, 0]]), 6
    elif case == "padded":
        ids, cap = rng.integers(0, 20, (2, 3)), 10
    else:
        ids, cap = rng.integers(0, 20, (8, 8)), 20
    ju, jinv = JS.coalesce(jnp.asarray(ids, jnp.int32), cap, n_rows)
    tu, tinv = TS.coalesce(torch.as_tensor(ids), cap, n_rows)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))


def test_embedding_lookup_backward_equals_jax():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((9, 5)).astype(np.float32)
    idx = rng.integers(0, 9, (4, 7))
    w = rng.standard_normal((4, 7, 5)).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(
        JS.embedding_lookup(t, jnp.asarray(idx, jnp.int32)) * w))(
        jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    (TS.embedding_lookup(t, torch.as_tensor(idx)) * torch.as_tensor(w)) \
        .sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    # the dense gather's gradient, duplicates accumulated
    dense = np.zeros_like(table)
    np.add.at(dense, idx.reshape(-1), w.reshape(-1, 5))
    np.testing.assert_allclose(t.grad.numpy(), dense, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_ids,n_rows,configured",
                         [(10, 48, None), (100, 48, None), (10, 48, 16),
                          (10, 48, 64), (10, 48, 9), (40, 12, 11)])
def test_effective_capacity_equals_jax(n_ids, n_rows, configured):
    try:
        want = JS.effective_capacity(n_ids, n_rows, configured)
    except ValueError as e:
        with pytest.raises(ValueError, match="below the exact"):
            TS.effective_capacity(n_ids, n_rows, configured)
        assert "below the exact" in str(e)
        return
    assert TS.effective_capacity(n_ids, n_rows, configured) == want


def test_sparse_rows_to_dense_and_touched():
    sr = TS.SparseRows(torch.tensor([1, 4, 6, 6]),
                       torch.ones((4, 3)), 6)
    assert int(sr.touched()) == 2 and sr.capacity == 4 and sr.dim == 3
    dense = sr.to_dense()
    assert dense.shape == (6, 3) and dense[[1, 4]].eq(1).all()
    assert dense.sum() == 6


# ------------------------------------------------ training, one device
@pytest.mark.parametrize("build,data", [(embed_net, batch),
                                        (seq_net, seq_batch)],
                         ids=["embedding", "embedding_sequence"])
def test_sparse_matches_dense_bitwise_under_sgd(build, data, tmp_path):
    sparse, _ = port_of(build(sparse=True), tmp_path, "s")
    dense, _ = port_of(build(sparse=False), tmp_path, "d")
    assert sparse.conf.layers[0].sparse_grad
    for seed in range(3):
        x, y = data(seed=seed)
        sparse.fit(x, y)
        dense.fit(x, y)
    for k, g in dense.params.items():
        for n, p in g.items():
            assert torch.equal(p, sparse.params[k][n]), f"{k}/{n}"


def test_lazy_adam_matches_jax_and_leaves_untouched_rows(tmp_path):
    jn = embed_net(sparse=True, updater=Adam(learning_rate=0.05))
    tn, _ = port_of(jn, tmp_path, "adam")
    W0 = tn.params["layer_0"]["W"].detach().clone()
    touched = set()
    for seed in range(3):
        x, y = batch(seed=seed)
        touched |= set(x.reshape(-1).tolist())
        jn.fit(x, y)
        tn.fit(x, y)
        np.testing.assert_allclose(tn.get_score(), float(jn.get_score()),
                                   rtol=1e-6)
    for k, g in jn.params.items():
        for n, a in g.items():
            a = np.asarray(a)
            err = np.max(np.abs(tn.params[k][n].detach().numpy() - a))
            assert err <= RTOL_ADAM * np.max(np.abs(a)), f"{k}/{n}"
    untouched = [r for r in range(VOCAB) if r not in touched]
    W1 = tn.params["layer_0"]["W"].detach()
    assert torch.equal(W1[untouched], W0[untouched])
    slots = tn.opt_state["slots"]["layer_0"]["W"]
    for s in ("mu", "nu"):
        assert slots[s][untouched].eq(0).all()
        assert slots[s][sorted(touched)].ne(0).any()
    assert int(tn._last_grad_stats["embedding_rows_touched"]) == \
        len(set(batch(seed=2)[0].reshape(-1).tolist()))


def test_traced_invalid_ids_never_corrupt_other_rows(tmp_path):
    """Tensor batches skip the host id check, so invalid ids reach the
    step: a negative id must not wrap into the last row, an id >= vocab
    must not misattribute gradient; only validly touched rows change."""
    vocab = 10
    tn, _ = port_of(embed_net(sparse=True, vocab=vocab), tmp_path, "inv")
    W0 = tn.params["layer_0"]["W"].detach().clone()
    ids = torch.tensor([[-1], [vocab + 2], [3]], dtype=torch.int32)
    y = np.eye(CLASSES, dtype=np.float32)[np.zeros(3, np.int64)]
    tn.fit(ids, y)
    W1 = tn.params["layer_0"]["W"].detach()
    changed = [r for r in range(vocab) if not torch.equal(W1[r], W0[r])]
    assert changed == [3]
    assert int(tn._last_grad_stats["embedding_rows_touched"]) == 1


def test_undersized_capacity_is_refused(tmp_path):
    tn, _ = port_of(embed_net(sparse=True, cap=3), tmp_path, "cap")
    x, y = batch()
    with pytest.raises(ValueError, match="below the exact"):
        tn.fit(x, y)


def test_configuration_errors_match_jax(tmp_path):
    from deeplearning4j_tpu_torch.nn import multilayer as tml
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    tn, _ = port_of(embed_net(sparse=True), tmp_path, "conf")
    lc = DenseLayer(n_in=4, n_out=4)
    lc.sparse_grad = True
    lc.name = "dense"
    tn.conf.layers.insert(1, lc)
    with pytest.raises(ValueError, match="must be the first layer|"
                                         "requires the embedding"):
        tml._build_train_step(tn.conf, tn._tx)
    # a one-hot batch rides the dense path: refused, never a fallback
    tn2, _ = port_of(embed_net(sparse=True), tmp_path, "onehot")
    x = np.eye(VOCAB, dtype=np.float32)[:4]
    with pytest.raises(ValueError, match="integer id"):
        tn2.fit(x, np.eye(CLASSES, dtype=np.float32)[:4])


# ------------------------------------------------ two ranks
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sparse_dp")
    jobs, data, zips = [], {}, {}
    for upd in ("sgd", "adam"):
        u = Sgd(learning_rate=0.1) if upd == "sgd" else \
            Adam(learning_rate=0.05)
        path = str(d / f"{upd}.zip")
        write_model(embed_net(sparse=True, updater=u, vocab=VOCAB), path)
        zips[upd] = path
        data[upd] = [batch(seed=s) for s in range(3)]
        for kind in ("pw", "zero3"):
            jobs.append({"fn": "fit", "name": f"{upd}_{kind}", "dp": 2,
                         "kind": kind, "zip": path, "batches": data[upd],
                         "min_shard_size": 64, "slots": True,
                         "bytes": kind == "zero3", "touched": True})
    return scen.run(2, jobs), data, zips


@pytest.mark.parametrize("kind", ["pw", "zero3"])
@pytest.mark.parametrize("upd", ["sgd", "adam"])
def test_two_rank_sparse_matches_one_device(two_ranks, upd, kind):
    port, data, zips = two_ranks
    got = port[f"{upd}_{kind}"]
    one = load_reference_model(zips[upd], device="cpu")
    W0 = one.params["layer_0"]["W"].detach().clone()
    touched = set()
    for x, y in data[upd]:
        one.fit(x, y)
        touched |= set(x.reshape(-1).tolist())
    for k, g in one.params.items():
        for n, p in g.items():
            a = p.detach().numpy()
            err = np.max(np.abs(got["params"][k][n] - a))
            assert err <= RTOL_DP * np.max(np.abs(a)), f"{k}/{n}"
    untouched = [r for r in range(VOCAB) if r not in touched]
    np.testing.assert_array_equal(got["params"]["layer_0"]["W"][untouched],
                                  W0.numpy()[untouched])
    for s, t in got["slots"].items():
        if s.startswith("layer_0/W/"):
            assert not t[untouched].any()
    assert got["touched"] == int(one._last_grad_stats[
        "embedding_rows_touched"])
    if kind == "zero3":
        # the table is the leaf the rule shards: by rows
        assert got["layout"]["layer_0"]["W"] == 0
