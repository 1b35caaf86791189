"""Viterbi decoding, the time-series helpers, the simple result holders,
the recursive tree, and the profiling hooks of the port against the JAX
package.

Viterbi: paths equal, log-probabilities within 1e-6 (float32 sums of the
same logs in the same order).  Time series and the host helpers: equal.
"""
import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import recursive as jrec
from deeplearning4j_tpu.nn import simple as jsimple
from deeplearning4j_tpu.utils import time_series as jts
from deeplearning4j_tpu.utils import viterbi as jvit
from deeplearning4j_tpu_torch.nn import recursive as trec
from deeplearning4j_tpu_torch.nn import simple as tsimple
from deeplearning4j_tpu_torch.utils import profiling as tprof
from deeplearning4j_tpu_torch.utils import time_series as tts
from deeplearning4j_tpu_torch.utils import viterbi as tvit

TOL_LOGP = 1e-6


def _hmm(rng, b, t, s):
    e = rng.random((b, t, s)).astype(np.float32) + 0.05
    tr = rng.random((s, s)).astype(np.float32) + 0.05
    return e / e.sum(-1, keepdims=True), tr / tr.sum(-1, keepdims=True)


@pytest.mark.parametrize("prior", [None, "given"])
def test_viterbi_decode_batch_and_single(prior):
    rng = np.random.default_rng(0)
    e, tr = _hmm(rng, 5, 12, 4)
    p = None if prior is None else rng.dirichlet(np.ones(4))
    labels = ["A", "B", "C", "D"]
    jv = jvit.Viterbi(labels, tr, p)
    tv = tvit.Viterbi(labels, tr, p, device="cpu")
    jpaths, jlogp = jv.decode_batch(e)
    tpaths, tlogp = tv.decode_batch(e)
    assert tpaths.dtype == np.int32
    np.testing.assert_array_equal(tpaths, jpaths)
    np.testing.assert_allclose(tlogp, jlogp, atol=TOL_LOGP, rtol=0)
    for i in range(2):
        (jl, jp), (tl, tp) = jv.decode(e[i]), tv.decode(e[i])
        np.testing.assert_array_equal(tl, jl)
        assert abs(tp - jp) <= TOL_LOGP
    # log-space input, the default transitions
    le = np.log(e[0])
    jpath, jlp = jvit.viterbi_decode(le, np.log(tr), log_space=True)
    tpath, tlp = tvit.viterbi_decode(le, np.log(tr), log_space=True,
                                     device="cpu")
    np.testing.assert_array_equal(tpath, jpath)
    assert abs(tlp - jlp) <= TOL_LOGP
    np.testing.assert_array_equal(
        tvit.Viterbi(labels, device="cpu").transitions,
        jvit.Viterbi(labels).transitions)


def test_viterbi_ties_take_the_first_state():
    """Every transition and emission equal: every backpointer is a tie,
    resolved to state 0 by both (argmax's first maximum)."""
    e = np.full((6, 3), 1 / 3, np.float32)
    tr = np.full((3, 3), 1 / 3, np.float32)
    jpath, jlp = jvit.viterbi_decode(e, tr)
    tpath, tlp = tvit.viterbi_decode(e, tr, device="cpu")
    np.testing.assert_array_equal(tpath, jpath)
    assert (tpath == 0).all() and abs(tlp - jlp) <= TOL_LOGP


def test_time_series_helpers():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 2)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                    np.float32)
    for m in (None, mask):
        np.testing.assert_array_equal(
            tts.reverse_time_series(x, m, device="cpu").numpy(),
            np.asarray(jts.reverse_time_series(x, m)))
        np.testing.assert_array_equal(
            tts.get_last_time_step(torch.tensor(x),
                                   None if m is None else torch.tensor(m)
                                   ).numpy(),
            np.asarray(jts.get_last_time_step(x, m)))
    np.testing.assert_array_equal(tts.moving_window_matrix(x[0], 2, 2),
                                  jts.moving_window_matrix(x[0], 2, 2))
    with pytest.raises(ValueError):
        tts.moving_window_matrix(x[0], 9)
    np.testing.assert_array_equal(
        tts.reshape_time_series_mask(mask, 3, device="cpu").numpy(),
        np.asarray(jts.reshape_time_series_mask(mask, 3)))


def test_simple_results_and_recursive_tree():
    probs = [[0.1, 0.7, 0.2], [0.5, 0.2, 0.3]]
    j = jsimple.RankClassificationResult(probs, ["a", "b", "c"])
    t = tsimple.RankClassificationResult(probs, ["a", "b", "c"])
    assert (t.rank(1), t.max_label(0), t.probability(1, "c"),
            t.to_dict()) == (j.rank(1), j.max_label(0), j.probability(1, "c"),
                             j.to_dict())
    assert tsimple.BinaryClassificationResult(0.6).to_dict() == \
        jsimple.BinaryClassificationResult(0.6).to_dict()

    def tree(mod):
        root, a, b = mod.Tree(), mod.Tree(["x"]), mod.Tree()
        c = mod.Tree(["y"])
        b.connect([c])
        root.connect([a, b])
        a.error, c.error, root.label = 0.5, 1.5, "S"
        return root, b, c

    (jr, jb, jc), (tr, tb, tc) = tree(jrec), tree(trec)
    assert (tr.yield_words(), tr.depth(), tr.depth_of(tc), tb.is_pre_terminal(),
            tr.error_sum(), len(tr.get_leaves()), repr(tr.clone())) == \
        (jr.yield_words(), jr.depth(), jr.depth_of(jc), jb.is_pre_terminal(),
         jr.error_sum(), len(jr.get_leaves()), repr(jr.clone()))
    assert tc.ancestor(2, tr) is tr and tc.parent_in(tr) is tb


def test_profiler_listener_traces_its_window_only(tmp_path):
    """A trace of the window only, written when it closes: the work
    between the ``iteration_done`` of iteration 2 (start) and that of 4
    (end), that is iterations 3 and 4, is in it; the rest is not."""
    lst = tprof.ProfilerListener(str(tmp_path), start_iteration=2,
                                 num_iterations=2)
    for it in range(1, 7):
        with tprof.trace_annotation(f"step_{it}"):
            torch.ones(3).sum()
        lst.iteration_done(None, it, 0)
        assert lst.captured == (it >= 4)
    lst.on_epoch_end(None)
    assert lst.trace_path == os.path.join(str(tmp_path), "trace_2-4.json")
    assert os.listdir(tmp_path) == ["trace_2-4.json"]
    with open(lst.trace_path) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    assert {"step_3", "step_4"} <= names
    assert not names & {"step_1", "step_2", "step_5", "step_6"}


def test_device_memory_stats_and_platform():
    assert tprof.device_memory_stats("cpu") is None
    assert tprof.device_platform("cpu") == "cpu"
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats() is None
