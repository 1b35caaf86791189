"""The port's host text pipeline (``nlp/tokenization``,
``sentence_iterator``, ``vocab``, ``vectorizer``, ``inverted_index``,
``moving_window``, ``uima``, ``cjk``), ``data/vectorizer`` and the corpus
indexer (``utils/native.index_corpus``) against the JAX package's, on text
made with numpy from seeds.  Everything here is host code on both sides:
outputs are equal, not close (vectorizer matrices are the same f32
numpy)."""
import numpy as np
import pytest

import deeplearning4j_tpu.data as jdata
import deeplearning4j_tpu.graph as jgraph
import deeplearning4j_tpu.nlp as jnlp
import deeplearning4j_tpu_torch.data as tdata
import deeplearning4j_tpu_torch.graph as tgraph
import deeplearning4j_tpu_torch.nlp as tnlp
from deeplearning4j_tpu.nlp import moving_window as jmw
from deeplearning4j_tpu_torch.nlp import moving_window as tmw
from deeplearning4j_tpu_torch.utils import native


def _text(seed=3, n=40):
    rng = np.random.default_rng(seed)
    words = ["The", "cat", "sat", "on", "a", "mat.", "Dr.", "Smith",
             "ran", "quickly", "home!", "42", "dogs", "eat", "fishes?",
             "running", "jumped", "U.S.", "it's", "tech-savvy"]
    return [" ".join(rng.choice(words, size=int(rng.integers(3, 12))))
            for _ in range(n)]


def test_packages_export_the_jax_names():
    assert tnlp.__all__ == jnlp.__all__
    assert tgraph.__all__ == jgraph.__all__
    for name in tnlp.__all__:
        assert getattr(tnlp, name) is not None, name
    for name in ("Vectorizer", "CallableVectorizer", "TextCorpusVectorizer"):
        assert name in tdata.__all__ and hasattr(tdata, name)


@pytest.mark.parametrize("pre", [None, "CommonPreprocessor",
                                 "LowCasePreProcessor", "EndingPreProcessor"])
def test_tokenizers_give_the_same_tokens(pre):
    for s in _text():
        tf_j = jnlp.DefaultTokenizerFactory(
            getattr(jnlp, pre)() if pre else None)
        tf_t = tnlp.DefaultTokenizerFactory(
            getattr(tnlp, pre)() if pre else None)
        assert tf_t.create(s).get_tokens() == tf_j.create(s).get_tokens()
        ng_j = jnlp.NGramTokenizerFactory(1, 3).create(s).get_tokens()
        assert tnlp.NGramTokenizerFactory(1, 3).create(s).get_tokens() == ng_j


def test_sentence_iterators(tmp_path):
    lines = _text(4, 12)
    (tmp_path / "a.txt").write_text("\n".join(lines[:6]))
    (tmp_path / "b.txt").write_text("\n".join(lines[6:]) + "\n\n")
    for pkg_j, pkg_t in ((jnlp, tnlp),):
        def both(make):
            return list(make(pkg_t)), list(make(pkg_j))
        for make in (
                lambda p: p.BasicLineIterator(str(tmp_path / "a.txt")),
                lambda p: p.LineSentenceIterator(str(tmp_path / "b.txt")),
                lambda p: p.FileSentenceIterator(str(tmp_path)),
                lambda p: p.CollectionSentenceIterator(lines,
                                                       pre_processor=str.upper),
                lambda p: p.MultipleEpochsSentenceIterator(
                    p.CollectionSentenceIterator(lines[:3]), 2),
                lambda p: p.AggregatingSentenceIterator(
                    [p.CollectionSentenceIterator(lines[:2]),
                     p.CollectionSentenceIterator(lines[5:7])])):
            got, want = both(make)
            assert got == want
        conv_t = list(pkg_t.SentenceIteratorConverter(
            pkg_t.CollectionSentenceIterator(lines[:4])))
        conv_j = list(pkg_j.SentenceIteratorConverter(
            pkg_j.CollectionSentenceIterator(lines[:4])))
        assert [(d.content, d.labels) for d in conv_t] == \
            [(d.content, d.labels) for d in conv_j]
    (tmp_path / "lab" / "pos").mkdir(parents=True)
    (tmp_path / "lab" / "neg").mkdir()
    (tmp_path / "lab" / "pos" / "1.txt").write_text(lines[0])
    (tmp_path / "lab" / "neg" / "2.txt").write_text(lines[1])
    got = [(d.content, d.labels) for d in
           tnlp.FileLabelAwareIterator(str(tmp_path / "lab"))]
    want = [(d.content, d.labels) for d in
            jnlp.FileLabelAwareIterator(str(tmp_path / "lab"))]
    assert got == want


def _zipf_tokens(seed, n_sent=50, vocab=300):
    rng = np.random.default_rng(seed)
    return [["w%d" % i for i in np.clip(rng.zipf(1.2, 15), 1, vocab)]
            for _ in range(n_sent)]


@pytest.mark.parametrize("min_freq", [1, 2])
def test_vocab_huffman_unigram_and_subsampling_are_equal(min_freq):
    """Huffman codes and points decide which rows of syn1 train, so the
    heap's (count, tiebreak, id) order must be the JAX package's exactly;
    the unigram table decides the negatives."""
    seqs = _zipf_tokens(min_freq)
    vj = jnlp.VocabConstructor(min_freq).build(seqs, special_labels=["L1"])
    vt = tnlp.VocabConstructor(min_freq).build(seqs, special_labels=["L1"])
    assert vt.words() == vj.words()
    assert vt.total_word_count == vj.total_word_count
    for a, b in zip(vt.vocab_words(), vj.vocab_words()):
        assert (a.word, a.count, a.index, a.codes, a.points, a.is_label) == \
            (b.word, b.count, b.index, b.codes, b.points, b.is_label)
    assert (tnlp.make_unigram_table(vt) == jnlp.make_unigram_table(vj)).all()
    for sample in (0.0, 1e-3, 1e-2):
        np.testing.assert_array_equal(tnlp.subsample_keep_prob(vt, sample),
                                      jnlp.subsample_keep_prob(vj, sample))
    words_t = [tnlp.VocabWord("w%d" % i, count=c) for i, c in
               enumerate([5, 5, 3, 3, 3, 1, 8, 1])]
    words_j = [jnlp.VocabWord("w%d" % i, count=c) for i, c in
               enumerate([5, 5, 3, 3, 3, 1, 8, 1])]
    tnlp.build_huffman(words_t, max_code_length=3)
    jnlp.build_huffman(words_j, max_code_length=3)
    assert [(w.codes, w.points) for w in words_t] == \
        [(w.codes, w.points) for w in words_j]


def test_vectorizers_give_equal_matrices():
    docs = _text(5, 20)
    for cls in ("BagOfWordsVectorizer", "TfidfVectorizer"):
        got = getattr(tnlp, cls)().fit_transform(docs)
        want = getattr(jnlp, cls)().fit_transform(docs)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    labels = [i % 3 for i in range(len(docs))]
    for tfidf in (True, False):
        dt = tdata.TextCorpusVectorizer(docs, labels, 3, tfidf=tfidf)
        dj = jdata.TextCorpusVectorizer(docs, labels, 3, tfidf=tfidf)
        a, b = dt.vectorize(), dj.vectorize()
        np.testing.assert_array_equal(np.asarray(a.features),
                                      np.asarray(b.features))
        np.testing.assert_array_equal(np.asarray(a.labels),
                                      np.asarray(b.labels))
    with pytest.raises(ValueError):
        tdata.TextCorpusVectorizer(docs, labels[:-1], 3)
    with pytest.raises(ValueError):
        tdata.TextCorpusVectorizer(docs[:2], [0, 5], 3)
    fn = lambda: (np.ones((2, 3)), np.eye(2))   # noqa: E731
    a = tdata.CallableVectorizer(fn).vectorize()
    b = jdata.CallableVectorizer(fn).vectorize()
    np.testing.assert_array_equal(np.asarray(a.features),
                                  np.asarray(b.features))


def test_inverted_index_and_keywords_are_equal():
    docs = _text(6, 25)
    ij, it = jnlp.InvertedIndex(), tnlp.InvertedIndex()
    assert it.add_documents(docs) == ij.add_documents(docs)
    for tok in ("cat", "The", "dogs", "missing"):
        assert it.documents(tok) == ij.documents(tok)
        assert it.search(tok) == ij.search(tok)
    assert it.search("cat", "sat") == ij.search("cat", "sat")
    kj, kt = jnlp.KeywordExtractor(ij), tnlp.KeywordExtractor(it)
    for d in (0, 7, 24):
        assert kt.keywords(d, top_n=3) == kj.keywords(d, top_n=3)
    assert kt.corpus_keywords(top_n=5) == kj.corpus_keywords(top_n=5)


class _Vec:
    """A word-vector stand-in for the window converter."""
    vocab = None

    def get_word_vector(self, word):
        return np.full(3, float(len(word)), np.float32)


def test_moving_windows_and_labels_are_equal():
    for s in _text(7, 6):
        wt = tmw.windows(s, window_size=5)
        wj = jmw.windows(s, window_size=5)
        assert [w.words for w in wt] == [w.words for w in wj]
        assert [w.focus_word() for w in wt] == [w.focus_word() for w in wj]
        np.testing.assert_array_equal(
            tmw.WindowConverter.as_example_matrix(wt[0], _Vec()),
            jmw.WindowConverter.as_example_matrix(wj[0], _Vec()))
    s = "I saw <PER> John Smith </PER> in <LOC> Paris </LOC> today"
    assert tnlp.ContextLabelRetriever.string_with_labels(s) == \
        jnlp.ContextLabelRetriever.string_with_labels(s)


def test_uima_segmenter_and_tagger_are_equal():
    text = ("Dr. Smith went to Washington. He arrived at 5 p.m. on Monday! "
            "Was it raining? The U.S. team won 3-2.")
    assert tnlp.SentenceSegmenter().segment(text) == \
        jnlp.SentenceSegmenter().segment(text)
    for s in _text(8, 10):
        assert tnlp.PosTagger().tag(s) == jnlp.PosTagger().tag(s)
    assert list(tnlp.UimaSentenceIterator([text, "One. Two."])) == \
        list(jnlp.UimaSentenceIterator([text, "One. Two."]))


@pytest.mark.parametrize("lang,text", [
    ("Chinese", "我爱北京天安门，研究生命科学的人很多。"),
    ("Japanese", "東京タワーへいく。私は日本語を勉強しています。"),
    ("Korean", "나는 학교에 간다. 김철수가 왔다."),
])
def test_cjk_tokenizers_give_the_same_tokens(lang, text):
    name = f"{lang}TokenizerFactory"
    assert getattr(tnlp, name)().create(text).get_tokens() == \
        getattr(jnlp, name)().create(text).get_tokens()


VOCAB = {"the": 0, "quick": 1, "brown": 2, "fox": 3, "jumps": 4, "over": 5,
         "lazy": 6, "dog": 7, "快": 8}
SENTENCES = ["the quick brown fox", "jumps over  the lazy dog", "", "   ",
             "oov words here the", "\tthe\nquick\r", "the 快 fox\x1cdog"]


def test_index_corpus_native_and_twin_agree():
    assert native.available(), "g++ builds csrc/host_codec.cpp here"
    got = native.index_corpus(SENTENCES, VOCAB)
    twin = native.index_corpus(SENTENCES, VOCAB, use_native=False)
    g = VOCAB.get
    want = [[g(t) for t in s.split() if g(t) is not None] for s in SENTENCES]
    assert [a.tolist() for a in got] == [a.tolist() for a in twin] == want
    assert all(a.dtype == np.int32 for a in got + twin)
    # the gates both paths share
    assert native.index_corpus(SENTENCES, {}) is None
    assert native.index_corpus(["a b"], {"a": 0, "b": 2}) is None
    assert native.index_corpus(["\ud800 a"], VOCAB, use_native=False) is None


def test_index_corpus_bails_on_unicode_whitespace_and_overflow():
    """-2: Unicode whitespace (the native path handles ASCII whitespace
    only; the twin's ``str.split`` handles both); -3: an output buffer too
    small, which the library refuses to write past."""
    for s in ("the　fox", "the fox", "the fox", "the\u0085fox"):
        assert native.index_corpus([s], VOCAB) is None
        assert native.index_corpus([s], VOCAB, use_native=False)[0].tolist() \
            == [0, 3]
    lib = native._load()
    text = b"the quick brown fox"
    offsets = np.array([0, len(text)], np.int64)
    blob = "\n".join(sorted(VOCAB, key=VOCAB.get)).encode()
    out = np.empty(2, np.int32)
    counts = np.zeros(1, np.int64)
    assert lib.dl4j_index_corpus(text, offsets, 1, blob, len(blob), out, 2,
                                 counts) == -3
    uws = "the　fox".encode()
    assert lib.dl4j_index_corpus(uws, np.array([0, len(uws)], np.int64), 1,
                                 blob, len(blob), out, 2, counts) == -2
    out = np.empty(8, np.int32)
    assert lib.dl4j_index_corpus(text, offsets, 1, blob, len(blob), out, 8,
                                 counts) == 4
    assert out[:4].tolist() == [0, 1, 2, 3] and counts.tolist() == [4]


def test_index_corpus_matches_the_jax_indexer():
    from deeplearning4j_tpu.utils import native as jnative
    want = jnative.index_corpus(SENTENCES, VOCAB)
    got = native.index_corpus(SENTENCES, VOCAB)
    assert [a.tolist() for a in got] == [a.tolist() for a in want]
