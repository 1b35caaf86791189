"""The port's embedding trainers (``nlp/sequence_vectors``, ``word2vec``,
``paragraph_vectors``, ``glove``, ``serializer``)
against the JAX package's, on corpora made with numpy from seeds, on the
CPU (``device="cpu"``).

Tolerances:

* Word2Vec and ParagraphVectors fits, JAX with x64 off (its production
  stream: the negatives' ``randint`` and ``infer_vector``'s init are x64
  dependent): both sides emit the same rows from the same numpy streams,
  draw the same negatives and run the same f32 steps with dot products
  and duplicate sums in other orders, a few f32 ulps per step; over the
  ~100 steps of these fits the tables stay within 2e-6 of each other
  (measured <= 2.4e-7 on entries up to ~1).
* ``infer_vector``: 10 steps on one vector: 1e-6.
* GloVe at f64 (the JAX package's dtype under its tests' x64; the port's
  ``dtype=torch.float64``): ``log(xij)`` and the weight are f32 on both
  sides and may differ by an f32 ulp: 1e-6 of the largest entry
  (measured 2.4e-8).  At f32 both sides: 1e-6 abs.
* Serialized text and binary files: byte for byte; full models: every
  member byte for byte.

The bulk paths pack ~2**17 rows a block (S = 2**17 / B steps), and a
corpus smaller than a block trains one row a step over its tail: a fit of
these corpora would run ~2,000 steps.  The tests shrink the block to 2**11
rows in both packages (``_BULK_PAIRS_PER_DISPATCH``, S = 32 at B = 64);
``test_bulk_fit_at_the_default_block_size_matches_jax`` keeps the
default.
"""
import gzip
import zipfile

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as jnlp
import deeplearning4j_tpu_torch.graph as tgraph
import deeplearning4j_tpu_torch.nlp as tnlp
from deeplearning4j_tpu.nlp import sequence_vectors as jsv
from deeplearning4j_tpu.nlp import serializer as jser
from deeplearning4j_tpu_torch.nlp import distributed_vectors as tdist
from deeplearning4j_tpu_torch.nlp import sequence_vectors as tsv
from deeplearning4j_tpu_torch.nlp import serializer as tser

TOL_FIT = 2e-6
TOL_INFER = 1e-6
TOL_GLOVE_F64 = 1e-6
TOL_GLOVE_F32 = 1e-6


def zipf_corpus(n=60, seed=7, vocab=40, length=10):
    rng = np.random.default_rng(seed)
    ids = np.clip(rng.zipf(1.3, size=n * length), 1, vocab) - 1
    toks = ["w%d" % i for i in ids]
    return [" ".join(toks[i * length:(i + 1) * length]) for i in range(n)]


CORPUS = zipf_corpus()
SMALL_BLOCK = 1 << 11
DEFAULT_BLOCK_TESTS = ("test_bulk_fit_at_the_default_block_size_matches_jax",)


@pytest.fixture(autouse=True)
def small_blocks(request, monkeypatch):
    if request.node.name not in DEFAULT_BLOCK_TESTS:
        for cls in (jsv.SequenceVectors, tsv.SequenceVectors):
            monkeypatch.setattr(cls, "_BULK_PAIRS_PER_DISPATCH", SMALL_BLOCK)


def _syn(model, name="syn0"):
    t = getattr(model.lookup_table, name)
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _w2v_pair(**kw):
    """(jax model, port model), both fitted on CORPUS, JAX with x64 off."""
    with jax.enable_x64(False):
        j = jnlp.Word2Vec(sentences=CORPUS, **kw)
        j.fit()
        j_tabs = {n: _syn(j, n) for n in ("syn0", "syn1", "syn1neg")
                  if getattr(j.lookup_table, n) is not None}
    t = tnlp.Word2Vec(sentences=CORPUS, device="cpu", **kw)
    t.fit()
    return j, j_tabs, t


def _assert_tables(j_tabs, t, tol):
    for name, want in j_tabs.items():
        got = _syn(t, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


# bulk SG/CBOW x NS/HS, and the generic per-sentence path (HS and NS
# together), each with the route it must take
FITS = [("skipgram", 5, False, "bulk_ns"), ("skipgram", 0, True, "bulk_hs"),
        ("cbow", 5, False, "bulk_ns"), ("cbow", 0, True, "bulk_hs"),
        ("skipgram", 3, True, "generic"), ("cbow", 3, True, "generic")]


@pytest.mark.parametrize("algo,negative,hs,route", FITS)
def test_word2vec_fit_matches_jax(algo, negative, hs, route, monkeypatch):
    calls = []
    for name in ("_fit_bulk_sg", "_fit_bulk_cbow"):
        orig = getattr(tsv.SequenceVectors, name)

        def spy(self, mode, *a, _orig=orig, **k):
            calls.append(f"bulk_{mode}")
            return _orig(self, mode, *a, **k)
        monkeypatch.setattr(tsv.SequenceVectors, name, spy)
    j, j_tabs, t = _w2v_pair(layer_size=16, window=3, negative=negative,
                             use_hierarchic_softmax=hs, epochs=2, seed=3,
                             elements_algorithm=algo, batch_size=64)
    assert calls == ([] if route == "generic" else [route])
    _assert_tables(j_tabs, t, TOL_FIT)
    assert t.lookup_table.syn0.dtype == torch.float32


DEFAULT_BLOCK_KW = dict(layer_size=16, window=3, negative=5, epochs=1, seed=2,
                        batch_size=64)


def test_bulk_fit_at_the_default_block_size_matches_jax():
    j, j_tabs, t = _w2v_pair(**DEFAULT_BLOCK_KW)
    assert t._rows_per_step() == 64
    _assert_tables(j_tabs, t, TOL_FIT)


def test_word2vec_subsampled_fit_matches_jax():
    j, j_tabs, t = _w2v_pair(layer_size=16, window=3, negative=5, epochs=2,
                             seed=4, sampling=1e-2)
    _assert_tables(j_tabs, t, TOL_FIT)


class _JLabeled(jsv.SequenceVectors):
    """Labeled sequences with no declared label width: the generic path's
    device-sampling branch (``skipgram_steps_ns`` per flush)."""

    def _sequences(self):
        return iter([s.split() for s in CORPUS])

    def _sequence_labels(self, i):
        return ["L%d" % (i % 3)]

    def build_vocab(self, extra_labels=()):
        super().build_vocab(extra_labels=("L0", "L1", "L2"))


class _TLabeled(tsv.SequenceVectors):
    _sequences = _JLabeled._sequences
    _sequence_labels = _JLabeled._sequence_labels

    def build_vocab(self, extra_labels=()):
        super().build_vocab(extra_labels=("L0", "L1", "L2"))


def test_generic_device_sampling_path_matches_jax():
    kw = dict(layer_size=8, window=2, negative=4, epochs=1, seed=5,
              batch_size=32, scan_steps=2)
    with jax.enable_x64(False):
        j = _JLabeled(**kw)
        j.fit()
        want = _syn(j)
    t = _TLabeled(device="cpu", **kw)
    t.fit()
    assert t._ns_fast_eligible()
    np.testing.assert_allclose(_syn(t), want, rtol=0, atol=TOL_FIT)


def _docs(pkg):
    return [pkg.LabelledDocument(s, ["DOC_%d" % (i % 20)] + (
        ["EVEN"] if i % 2 == 0 else [])) for i, s in enumerate(CORPUS)]


@pytest.mark.parametrize("seq_algo", ["dbow", "dm"])
def test_paragraph_vectors_and_infer_vector_match_jax(seq_algo):
    """DBOW (bulk skip-gram with label->word pairs) and DM (bulk CBOW with
    label columns, up to two labels a document), then ``infer_vector``:
    its init seeds from ``hash(text)``, the same inside this process."""
    kw = dict(layer_size=16, window=3, negative=5, epochs=2, seed=6,
              sequence_algorithm=seq_algo)
    text = CORPUS[3] + " w1 w2 unseen"
    with jax.enable_x64(False):
        j = jnlp.ParagraphVectors(documents=_docs(jnlp), **kw)
        j.fit()
        want, want_v = _syn(j), j.infer_vector(text)
        want_sim = j.similarity_to_label(text, "EVEN")
    t = tnlp.ParagraphVectors(documents=_docs(tnlp), device="cpu", **kw)
    t.fit()
    np.testing.assert_allclose(_syn(t), want, rtol=0, atol=TOL_FIT)
    got_v = t.infer_vector(text)
    assert got_v.dtype == np.float32
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=TOL_INFER)
    assert abs(t.similarity_to_label(text, "EVEN") - want_sim) < TOL_INFER
    np.testing.assert_allclose(t.get_label_vector("DOC_3"),
                               j.get_label_vector("DOC_3"), atol=TOL_FIT)


def test_glove_matches_jax_at_f64_and_f32():
    kw = dict(layer_size=8, window=3, epochs=3, seed=3, batch_size=32)
    j = jnlp.Glove(sentences=CORPUS, **kw)
    j.fit()
    want = _syn(j)
    assert want.dtype == np.float64
    t = tnlp.Glove(sentences=CORPUS, device="cpu", dtype=torch.float64, **kw)
    t.fit()
    got = _syn(t)
    assert got.dtype == np.float64
    assert np.abs(got - want).max() <= TOL_GLOVE_F64 * np.abs(want).max()
    with jax.enable_x64(False):
        j32 = jnlp.Glove(sentences=CORPUS, **kw)
        j32.fit()
    t32 = tnlp.Glove(sentences=CORPUS, device="cpu", **kw)
    t32.fit()
    assert _syn(t32).dtype == np.float32
    np.testing.assert_allclose(_syn(t32), _syn(j32), rtol=0,
                               atol=TOL_GLOVE_F32)
    assert t.count_cooccurrences() == j.count_cooccurrences()


@pytest.fixture(scope="module")
def fitted():
    """One fitted model of each package (HS + NS, so all three tables)."""
    return _w2v_pair(layer_size=8, window=2, negative=3,
                     use_hierarchic_softmax=True, epochs=1, seed=1)


def test_queries_match_jax(fitted):
    j, _, t = fitted
    for a, b in (("w0", "w1"), ("w2", "w7"), ("w0", "nope")):
        ws, ts = j.similarity(a, b), t.similarity(a, b)
        assert (np.isnan(ws) and np.isnan(ts)) or abs(ws - ts) < 1e-5
    assert t.words_nearest("w0", 5) == j.words_nearest("w0", 5)
    assert (t.words_nearest(["w0", "w3"], ["w1"], top_n=4)
            == j.words_nearest(["w0", "w3"], ["w1"], top_n=4))
    assert t.get_word_vector("w5").shape == (8,)
    assert t.word_frequency("w0") == j.word_frequency("w0")


@pytest.mark.parametrize("fmt", ["txt", "txt.gz", "csv", "bin"])
def test_vector_files_are_the_same_bytes_both_ways(fitted, tmp_path, fmt):
    j, _, t = fitted
    write = {"txt": "write_word_vectors", "txt.gz": "write_word_vectors",
             "csv": "write_csv", "bin": "write_binary"}[fmt]
    read = {"txt": "read_word_vectors", "txt.gz": "read_word_vectors",
            "csv": "read_csv", "bin": "read_binary"}[fmt]
    jp, tp = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    # the same table in both packages: the port writes JAX's syn0
    t.lookup_table.syn0 = torch.from_numpy(_syn(j).copy())
    getattr(jser, write)(j, jp)
    getattr(tser, write)(t, tp)
    if fmt == "txt.gz":
        with gzip.open(jp, "rb") as a, gzip.open(tp, "rb") as b:
            assert a.read() == b.read()
    else:
        with open(jp, "rb") as a, open(tp, "rb") as b:
            assert a.read() == b.read()
    from_j = getattr(tser, read)(jp, device="cpu")
    from_t = getattr(jser, read)(tp)
    assert from_j.vocab.words() == from_t.vocab.words() == j.vocab.words()
    np.testing.assert_array_equal(_syn(from_j), np.asarray(_syn(from_t)))
    sniffed = tser.load_static_model(jp, device="cpu")
    np.testing.assert_array_equal(_syn(sniffed), _syn(from_j))


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_full_model_both_ways_and_resume(fitted, tmp_path):
    """A full model written by either package has the same members; each
    package reads the other's, and a port model read from a JAX file
    resumes training as the JAX model read from the same file does."""
    j, _, t = fitted
    for n in ("syn0", "syn1", "syn1neg"):
        setattr(t.lookup_table, n, torch.from_numpy(_syn(j, n).copy()))
    jp, tp = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jser.write_full_model(j, jp)
    tser.write_full_model(t, tp)
    assert _members(jp) == _members(tp)
    back = jser.read_full_model(tp)
    assert back.vocab.word_for("w0").codes == j.vocab.word_for("w0").codes
    more = zipf_corpus(20, seed=9)
    with jax.enable_x64(False):
        jm = jser.read_full_model(jp)
        jm.sentence_iterator = jnlp.CollectionSentenceIterator(more)
        jm.fit()
    tm = tser.read_full_model(jp, device="cpu")
    assert tm.device.type == "cpu"
    tm.sentence_iterator = tnlp.CollectionSentenceIterator(more)
    tm.fit()
    for n in ("syn0", "syn1", "syn1neg"):
        np.testing.assert_allclose(_syn(tm, n), _syn(jm, n), rtol=0,
                                   atol=TOL_FIT, err_msg=n)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "m.zip")
    model = tnlp.Word2Vec(sentences=CORPUS[:5], layer_size=4, device="cpu")
    model.build_vocab()
    tser.write_full_model(model, path)
    tser.write_word_vectors(model, path + ".txt")
    vocab = model.vocab
    entries = [
        lambda d: tnlp.Word2Vec(sentences=CORPUS, **d),
        lambda d: tnlp.ParagraphVectors(documents=_docs(tnlp), **d),
        lambda d: tnlp.Glove(sentences=CORPUS, **d),
        lambda d: tnlp.SequenceVectors(**d),
        lambda d: tnlp.InMemoryLookupTable(vocab, 4, **d),
        lambda d: tgraph.DeepWalk(**d),
        lambda d: tgraph.Node2Vec(**d),
        lambda d: tser.read_full_model(path, **d),
        lambda d: tser.read_word_vectors(path + ".txt", **d),
        lambda d: tser.load_static_model(path, **d),
        lambda d: tdist.train_word2vec_distributed(CORPUS[:4], 1,
                                                   layer_size=4, **d),
    ]
    for make in entries:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make({})
        assert make({"device": "cpu"}) is not None


def test_chip_smoke_trains_the_benchmark_corpus():
    """``chip_smoke.py`` phase 57's corpus is the JAX package's
    ``word2vec_words_per_sec`` corpus, sentence for sentence."""
    import chip_smoke
    from deeplearning4j_tpu.utils.benchmarks import _zipf_sentences
    assert chip_smoke.zipf_sentences(50, 30, 20) == _zipf_sentences(50, 30,
                                                                     20)


def test_chip_smoke_twin_gate_is_k_times_the_f32_floor():
    import chip_smoke
    cpu64 = {"syn0": torch.tensor([[0.5, -2.0]], dtype=torch.float64)}
    cpu32 = {"syn0": torch.tensor([[0.5 + 2.0 ** -20, -2.0]])}
    gate, floor = chip_smoke._floor_gate(cpu32, cpu64)
    assert floor == 2.0 ** -20
    assert gate == pytest.approx(chip_smoke.W2V_FLOOR_K * floor)
    # never below one f32 ulp of the largest entry
    gate, floor = chip_smoke._floor_gate(cpu64, cpu64)
    assert floor == 0.0 and gate == 2.0 ** -23 * 2.0
