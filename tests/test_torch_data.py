"""The data stack of the port (``data/dataset``, ``data/normalization``,
``data/transforms``, ``streaming/codec``) against the JAX package's, on
the same numpy data and seeds: every iterator yields the same batches,
the normalizers compute the same statistics and read each other's files,
the transforms draw the same augmentations, and saved DataSets are the
same bytes.  Everything here is numpy on both sides: equal exactly.
"""
import os

import numpy as np
import pytest

from deeplearning4j_tpu.data import dataset as jd
from deeplearning4j_tpu.data import normalization as jn
from deeplearning4j_tpu.data import transforms as jt
from deeplearning4j_tpu_torch.data import dataset as td
from deeplearning4j_tpu_torch.data import normalization as tn
from deeplearning4j_tpu_torch.data import transforms as tt


def _arrays(n=10, f=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return x, y


def _parts(b):
    if isinstance(b, (jd.DataSet, td.DataSet, jd.MultiDataSet,
                      td.MultiDataSet)):
        return [b.features, b.labels, b.features_mask, b.labels_mask]
    return [b]


def _assert_same(a_batches, b_batches):
    a_batches, b_batches = list(a_batches), list(b_batches)
    assert len(a_batches) == len(b_batches)
    for a, b in zip(a_batches, b_batches):
        for pa, pb in zip(_parts(a), _parts(b)):
            if pa is None or pb is None:
                assert pa is None and pb is None
            elif isinstance(pa, list):
                for u, v in zip(pa, pb):
                    np.testing.assert_array_equal(np.asarray(u),
                                                  np.asarray(v))
            else:
                np.testing.assert_array_equal(np.asarray(pa),
                                              np.asarray(pb))


def _iterators(m):
    """The same iterator stack built from either package's module."""
    x, y = _arrays(11)
    mask = (np.arange(11 * 4).reshape(11, 4) % 3 > 0).astype(np.float32)
    imgs = np.random.default_rng(1).random((4, 6, 6, 2)).astype(np.float32)
    base = lambda: m.INDArrayDataSetIterator(x, y, 4)  # noqa: E731
    masked = [m.DataSet(x[i:i + 3], y[i:i + 3], mask[i:i + 3],
                        mask[i:i + 3, :2]) for i in range(0, 9, 3)]
    mds = [m.MultiDataSet([x[:5]], [y[:5]], [mask[:5]], [mask[:5, :2]])]
    return {
        "benchmark": m.BenchmarkDataSetIterator((4, 3), 2, 3, seed=5),
        "early_termination": m.EarlyTerminationDataSetIterator(base(), 2),
        "multiple_epochs": m.MultipleEpochsIterator(3, m.INDArrayDataSetIterator(
            x, y, 4, shuffle=True, seed=2)),
        "sampling": m.SamplingDataSetIterator(m.DataSet(x, y), 3, 4, seed=3),
        "moving_window": m.MovingWindowDataSetIterator(
            m.DataSet(imgs, y[:4]), 5, 3, 2, stride_cols=1),
        "async": m.AsyncDataSetIterator(base(), queue_size=2),
        "preprocessed": m.PreProcessedDataSetIterator(
            base(), m.CombinedPreProcessor(m.DummyPreProcessor())),
        "shield": m.AsyncShieldDataSetIterator(base()),
        "floats": m.FloatsDataSetIterator(list(zip(x, y)), 4),
        "doubles": m.DoublesDataSetIterator(list(zip(x, y)), 4),
        "rebatch": m.IteratorDataSetIterator(iter(masked), 2),
        "multi_wrapper": m.MultiDataSetWrapperIterator(mds),
        "reconstruction": m.ReconstructionDataSetIterator(base()),
        "joint_stop": m.JointParallelDataSetIterator(
            base(), m.INDArrayDataSetIterator(x[:5], y[:5], 2),
            inequality="stop"),
        "joint_pass": m.JointParallelDataSetIterator(
            base(), m.INDArrayDataSetIterator(x[:5], y[:5], 2),
            inequality="pass"),
        "joint_reset": m.JointParallelDataSetIterator(
            base(), m.INDArrayDataSetIterator(x[:5], y[:5], 2),
            inequality="reset"),
    }


@pytest.mark.parametrize("name", sorted(_iterators(td)))
def test_iterator_yields_the_jax_batches(name):
    j, t = _iterators(jd)[name], _iterators(td)[name]
    _assert_same(j, t)
    if name in ("multiple_epochs", "sampling", "early_termination"):
        # a second epoch after reset: new shuffles/draws, the same on both
        j.reset()
        t.reset()
        _assert_same(j, t)
    if hasattr(t, "batch"):
        try:
            want = j.batch()
        except (NotImplementedError, AttributeError, TypeError):
            return
        assert t.batch() == want


def test_async_iterator_guards():
    x, y = _arrays()
    it = td.AsyncDataSetIterator(td.INDArrayDataSetIterator(x, y, 2))
    first = iter(it)
    next(first)
    with pytest.raises(RuntimeError, match="already being iterated"):
        next(iter(it))
    first.close()
    assert len(list(it)) == 5          # sequential re-iteration works
    with pytest.raises(ValueError, match="AsyncShield"):
        td.AsyncDataSetIterator(td.AsyncShieldDataSetIterator(it))
    with pytest.raises(ValueError, match="inconsistent"):
        list(td.IteratorDataSetIterator(
            [td.DataSet(x[:2], y[:2], x[:2]), td.DataSet(x[2:4], y[2:4])], 3))


def test_saved_datasets_are_the_jax_bytes(tmp_path):
    x, y = _arrays()
    mask = np.ones((10, 3), np.float32)
    for ds_args in ((x, y), (x, y, mask, None)):
        pj, pt = tmp_path / "j.bin", tmp_path / "t.bin"
        jd.save_dataset(jd.DataSet(*ds_args), pj)
        td.save_dataset(td.DataSet(*ds_args), pt)
        assert pj.read_bytes() == pt.read_bytes()
        _assert_same([jd.load_dataset(pt)], [td.load_dataset(pj)])
    # export, then the file-split iterators over the directory
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jp = jd.export_dataset_batches(jd.INDArrayDataSetIterator(x, y, 3), jdir)
    tp = td.export_dataset_batches(td.INDArrayDataSetIterator(x, y, 3), tdir)
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    assert all(open(a, "rb").read() == open(b, "rb").read()
               for a, b in zip(jp, tp))
    _assert_same(jd.FileSplitDataSetIterator(jdir, worker=1, num_workers=2),
                 td.FileSplitDataSetIterator(tdir, worker=1, num_workers=2))
    _assert_same(jd.FileSplitParallelDataSetIterator(jdir, n_shards=3),
                 td.FileSplitParallelDataSetIterator(tdir, n_shards=3))

    class Double(td.DataSetCallback):
        def call(self, ds):
            return td.DataSet(ds.features * 2, ds.labels)

    got = list(td.FileSplitDataSetIterator(tp, callback=Double()))
    np.testing.assert_array_equal(got[0].features, 2 * x[:3])
    (tmp_path / "none").mkdir()
    with pytest.raises(FileNotFoundError):
        td.FileSplitParallelDataSetIterator(tmp_path / "none", 2)


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
def test_normalizer_matches_and_reads_the_other_file(kind, tmp_path):
    x, y = _arrays(12, 4, seed=4)
    x = x * 7 + 3
    y = y * 5 - 1

    def make(m):
        if kind == "standardize":
            return m.NormalizerStandardize().fit_label(True)
        if kind == "minmax":
            return m.NormalizerMinMaxScaler(-1.0, 2.0).fit_label(True)
        return m.ImagePreProcessingScaler(0.0, 1.0, 255.0)

    j = make(jn).fit(jd.INDArrayDataSetIterator(x, y, 5))
    t = make(tn).fit(td.INDArrayDataSetIterator(x, y, 5))
    ds_j, ds_t = jd.DataSet(x, y), td.DataSet(x, y)
    _assert_same([j.transform(ds_j), j.revert(j.transform(ds_j))],
                 [t.transform(ds_t), t.revert(t.transform(ds_t))])
    _assert_same(j.wrap(jd.INDArrayDataSetIterator(x, y, 5)),
                 t.wrap(td.INDArrayDataSetIterator(x, y, 5)))
    # each reads the other's file, and transforms as the writer does
    j.save(tmp_path / "j.json")
    t.save(tmp_path / "t.json")
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "t.json").read_text()
    from_j = tn.load_normalizer(tmp_path / "j.json")
    from_t = jn.load_normalizer(tmp_path / "t.json")
    assert type(from_j).__name__ == type(t).__name__
    _assert_same([from_t.transform(ds_j)], [from_j.transform(ds_t)])


def _transforms(m):
    return {"flip": m.RandomFlipTransform(0.5, vertical=True),
            "crop": m.RandomCropTransform(2),
            "cutout": m.CutoutTransform(3, 0.7),
            "compose": m.ComposeTransform([m.RandomFlipTransform(),
                                           m.RandomCropTransform(1),
                                           m.CutoutTransform(2)])}


@pytest.mark.parametrize("name", sorted(_transforms(tt)))
def test_transforms_draw_the_jax_augmentations(name):
    rng = np.random.default_rng(6)
    imgs = rng.random((6, 8, 8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    j = jt.TransformingDataSetIterator(jd.INDArrayDataSetIterator(imgs, y, 4),
                                       _transforms(jt)[name], seed=9)
    t = tt.TransformingDataSetIterator(td.INDArrayDataSetIterator(imgs, y, 4),
                                       _transforms(tt)[name], seed=9)
    for _ in range(2):                      # two epochs: new draws
        _assert_same(j, t)
        j.reset()
        t.reset()
    got = _transforms(tt)[name](imgs, np.random.default_rng(1))
    want = _transforms(jt)[name](imgs, np.random.default_rng(1))
    np.testing.assert_array_equal(got, want)
