"""The gates of ``chip_smoke.py``'s serving-tier phases (33-37), pinned on
the CPU with the phases' own helper functions.

- ``versions_monotonic``: a client's reported versions never go back.
- ``hot_swap_violations``: a response must match the output of the
  version it reports (within the tolerance) and no other version's.
- ``stream_ok``: a ``/generate`` NDJSON stream is one token event per
  index, then exactly one ``done`` event whose tokens are the stream's
  and the reference's.
- ``knn_violations``: neighbour indices against a float64 brute force;
  only a tie within the f32 rounding bound of the distance expansion may
  differ.
"""
import numpy as np
import pytest

import chip_smoke


@pytest.mark.parametrize("records,ok", [
    ([[(1,), (1,), (2,)], [(1,), (2,), (2,)]], True),
    ([[(1,), (2,), (1,)]], False),
    ([[], [(3,)]], True),
    ([[(2,), (2,)], [(2,), (1,)]], False)])
def test_versions_monotonic(records, ok):
    assert chip_smoke.versions_monotonic(records) is ok


def test_hot_swap_violations_hold_each_row_to_its_own_version():
    exp = {1: np.zeros(4, np.float32), 2: np.full(4, 1e-3, np.float32)}
    good = [[(1, exp[1] + 5e-6), (2, exp[2])], [(2, exp[2] - 5e-6)]]
    assert chip_smoke.hot_swap_violations(good, exp, 1e-5) == []
    # a row reporting v1 but computed by v2's weights
    bad = [[(1, exp[2])]]
    (v,) = chip_smoke.hot_swap_violations(bad, exp, 1e-5)
    assert v[:3] == (0, 0, 1) and v[3] > 1e-5
    # versions too close to tell apart fail, whatever the row says
    near = {1: exp[1], 2: exp[1] + 5e-6}
    assert chip_smoke.hot_swap_violations([[(1, exp[1])]], near, 1e-5)
    # an unknown version is a violation
    assert chip_smoke.hot_swap_violations([[(3, exp[1])]], exp, 1e-5)


def _events(tokens, done_tokens=None):
    evs = [{"token": t, "index": i, "model_version": 1}
           for i, t in enumerate(tokens)]
    return evs + [{"done": True, "finish": "length",
                   "tokens": list(tokens if done_tokens is None
                                  else done_tokens),
                   "model_versions": [1] * len(tokens)}]


def test_stream_ok_needs_the_whole_stream():
    assert chip_smoke.stream_ok(_events([3, 1, 4]), [3, 1, 4])
    assert not chip_smoke.stream_ok(_events([3, 1, 4]), [3, 1, 5])
    assert not chip_smoke.stream_ok(_events([3, 1, 4], [3, 1]), [3, 1, 4])
    assert not chip_smoke.stream_ok(_events([3, 1, 4])[:-1], [3, 1, 4])
    dropped = _events([3, 1, 4])
    del dropped[1]
    assert not chip_smoke.stream_ok(dropped, [3, 4])
    two_done = _events([3]) + _events([])[-1:]
    assert not chip_smoke.stream_ok(two_done, [3])
    errored = [{"token": 3, "index": 0, "model_version": 1},
               {"error": "boom"}]
    assert not chip_smoke.stream_ok(errored, [3])


def test_knn_violations_allow_ties_only():
    rng = np.random.default_rng(0)
    points = rng.standard_normal((500, 16)).astype(np.float32)
    queries = rng.standard_normal((8, 16)).astype(np.float32)
    q, p = queries.astype(np.float64), points.astype(np.float64)
    d2 = (q * q).sum(1)[:, None] - 2 * q @ p.T + (p * p).sum(1)[None]
    exact = np.argsort(d2, axis=1)[:, :5]
    assert chip_smoke.knn_violations(exact, queries, points) == (0, 0)
    # swapping ranks 0 and 1 of a query is a mismatch; it is a tie only
    # when their distances agree within the bound
    swapped = exact.copy()
    swapped[0, [0, 1]] = swapped[0, [1, 0]]
    mism, not_ties = chip_smoke.knn_violations(swapped, queries, points)
    assert mism == 2 and not_ties == 2
    tied = points.copy()
    tied[exact[0, 1]] = tied[exact[0, 0]]      # two equal points
    d2t = (q * q).sum(1)[:, None] - 2 * q @ tied.astype(np.float64).T \
        + (tied.astype(np.float64) ** 2).sum(1)[None]
    order = np.argsort(d2t, axis=1, kind="stable")[:, :5]
    flipped = order.copy()
    flipped[0, [0, 1]] = flipped[0, [1, 0]]
    assert chip_smoke.knn_violations(flipped, queries, tied) == (2, 0)
