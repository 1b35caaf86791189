"""The port's data readers against the JAX package's, on files and
arrays this test writes from seeds: the native decodes (``u8_to_f32``,
``decode_cifar``, ``parse_csv``) against the JAX package's and against
their own NumPy twins, malformed CSV rejected by all of them; the record
readers and their DataSet iterators; the directory formatter; the torch
interop; MNIST/IDX, EMNIST, CIFAR-10 from written files and every
synthetic stand-in.  All of it is host numpy on both sides: equal byte
for byte.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as jdata
import deeplearning4j_tpu_torch.data as tdata
from deeplearning4j_tpu.data import fetchers as jfe
from deeplearning4j_tpu.data import formatter as jfo
from deeplearning4j_tpu.data import interop as ji
from deeplearning4j_tpu.data import mnist as jm
from deeplearning4j_tpu.data import records as jr
from deeplearning4j_tpu.utils import native as jn
from deeplearning4j_tpu_torch.data import fetchers as tfe
from deeplearning4j_tpu_torch.data import formatter as tfo
from deeplearning4j_tpu_torch.data import interop as ti
from deeplearning4j_tpu_torch.data import mnist as tm
from deeplearning4j_tpu_torch.data import records as tr
from deeplearning4j_tpu_torch.utils import native as tn


def _parts(b):
    if hasattr(b, "features"):
        return [b.features, b.labels, getattr(b, "features_mask", None),
                getattr(b, "labels_mask", None)]
    return list(b)


def _same(a_batches, b_batches):
    a_batches, b_batches = list(a_batches), list(b_batches)
    assert len(a_batches) == len(b_batches) > 0
    for a, b in zip(a_batches, b_batches):
        for pa, pb in zip(_parts(a), _parts(b)):
            if pa is None or pb is None:
                assert pa is None and pb is None
            elif isinstance(pa, list):
                for u, v in zip(pa, pb):
                    u, v = np.asarray(u), np.asarray(v)
                    assert u.dtype == v.dtype
                    np.testing.assert_array_equal(u, v)
            else:
                pa, pb = np.asarray(pa), np.asarray(pb)
                assert pa.dtype == pb.dtype and pa.shape == pb.shape
                np.testing.assert_array_equal(pa, pb)


# ----------------------------------------------------------- native decodes
def test_native_library_builds():
    assert tn.available() and jn.available()


def test_u8_to_f32_and_decode_cifar_match_jax_and_twin():
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    want = jn.u8_to_f32(px)
    for kw in ({}, {"use_native": False}):
        got = tn.u8_to_f32(px, **kw)
        assert got.dtype == np.float32 and got.shape == px.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tn.u8_to_f32(px, 0.5), jn.u8_to_f32(px, 0.5))
    raw = rng.integers(0, 256, 7 * 3073, dtype=np.uint8).tobytes()
    wl, wi = jn.decode_cifar(raw)
    for kw in ({}, {"use_native": False}):
        gl, gi = tn.decode_cifar(raw, **kw)
        assert gl.dtype == np.int32 and gi.shape == (7, 32, 32, 3)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gi, wi)
    # channel c of pixel (h, w) comes from byte 1 + c*1024 + h*32 + w
    rec = np.frombuffer(raw, np.uint8)[:3073]
    assert gi[0, 2, 5, 1] == np.float32(rec[1 + 1024 + 2 * 32 + 5]) \
        * np.float32(1 / 255)
    for mod in (tn, jn):
        with pytest.raises(ValueError, match="multiple of 3073"):
            mod.decode_cifar(raw[:-1])


GOOD_CSV = ["1,2,3\n4,5,6\n", "1.5e3, -2 ,\t3\r\n4,5,6\n\n", "7\n8\n",
            "0.1,0.2\n0.3,0.4", "-1e-3;2;3\n", "", "\n\n"]


@pytest.mark.parametrize("text", GOOD_CSV)
def test_parse_csv_matches_jax_and_twin(text):
    delim = ";" if ";" in text else ","
    want = jn.parse_csv(text, delim)
    for kw in ({}, {"use_native": False}):
        got = tn.parse_csv(text.encode(), delim, **kw)
        assert got.dtype == np.float32
        if want.size == 0:
            assert got.size == 0
        else:
            np.testing.assert_array_equal(got, want)


BAD_CSV = ["1,,2\n", "1,2,\n", ",1\n", "1 2\n", "1,2\n3\n", "a,b\n",
           "1,2\n3,x\n", "1;2\n", "1,2 3\n"]


@pytest.mark.parametrize("text", BAD_CSV)
def test_malformed_csv_is_rejected_by_every_path(text):
    for parse in (tn.parse_csv, jn.parse_csv,
                  lambda t: tn.parse_csv(t, use_native=False)):
        with pytest.raises(ValueError):
            parse(text)


# ----------------------------------------------------------- record readers
def _write_csv(path, rows, header=None, quoted=False):
    with open(path, "w") as fh:
        if header:
            fh.write(header + "\n")
        for r in rows:
            vals = [f'"{v}"' if quoted else repr(float(v)) for v in r]
            fh.write(",".join(vals) + "\n")


@pytest.fixture(scope="module")
def csv_rows():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((23, 4)).round(3)
    lab = rng.integers(0, 3, 23)
    return np.concatenate([x, lab[:, None]], axis=1)


@pytest.mark.parametrize("quoted", [False, True], ids=["native", "csv"])
def test_csv_record_reader_iterators_match_jax(tmp_path, csv_rows, quoted):
    path = str(tmp_path / "r.csv")
    _write_csv(path, csv_rows, header="a,b,c,d,label", quoted=quoted)
    reader = tr.CSVRecordReader(path, skip_lines=1)
    assert (reader._parsed() is None) == quoted
    for kw in (dict(label_index=-1, n_classes=3),
               dict(label_index=1, regression=True, label_index_to=2),
               dict(label_index=4, regression=True)):
        _same(tr.RecordReaderDataSetIterator(reader, 5, **kw),
              jr.RecordReaderDataSetIterator(
                  jr.CSVRecordReader(path, skip_lines=1), 5, **kw))
    rows = csv_rows.tolist()
    _same(tr.RecordReaderDataSetIterator(tr.CollectionRecordReader(rows), 7,
                                         n_classes=3),
          jr.RecordReaderDataSetIterator(jr.CollectionRecordReader(rows), 7,
                                         n_classes=3))
    for m in (tr, jr):
        with pytest.raises(ValueError, match="classification needs n_classes"):
            m.RecordReaderDataSetIterator(m.CollectionRecordReader(rows), 4)


def test_sequence_and_multi_readers_match_jax(tmp_path, csv_rows):
    feats, labs = tmp_path / "f", tmp_path / "l"
    feats.mkdir()
    labs.mkdir()
    rng = np.random.default_rng(2)
    for i, t in enumerate((3, 5, 2, 4, 1)):
        seq = rng.standard_normal((t, 3)).round(3)
        seq[:, 2] = rng.integers(0, 4, t)
        _write_csv(feats / f"s{i}.csv", seq)
        _write_csv(labs / f"s{i}.csv", rng.integers(0, 4, (t, 1)))
    for m_kw in (dict(n_classes=4), dict(regression=True)):
        _same(tr.SequenceRecordReaderDataSetIterator(
                  tr.CSVSequenceRecordReader(str(feats)),
                  tr.CSVSequenceRecordReader(str(labs)), 2, **m_kw),
              jr.SequenceRecordReaderDataSetIterator(
                  jr.CSVSequenceRecordReader(str(feats)),
                  jr.CSVSequenceRecordReader(str(labs)), 2, **m_kw))
    _same(tr.SequenceRecordReaderDataSetIterator(
              tr.CSVSequenceRecordReader(str(feats)), None, 3, n_classes=4),
          jr.SequenceRecordReaderDataSetIterator(
              jr.CSVSequenceRecordReader(str(feats)), None, 3, n_classes=4))
    rows = csv_rows.tolist()

    def multi(m):
        return (m.RecordReaderMultiDataSetIterator.builder(6)
                .add_reader("csv", m.CollectionRecordReader(rows))
                .add_reader("again", m.CollectionRecordReader(rows[::-1]))
                .add_input("csv", 0, 1).add_input("again", 2, 3)
                .add_output_one_hot("csv", 4, 3).add_output("again", 0, 0)
                .build())

    got, want = list(multi(tr)), list(multi(jr))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g.features + g.labels, w.features + w.labels):
            np.testing.assert_array_equal(a, b)
    for m in (tr, jr):
        with pytest.raises(ValueError, match="at least one input"):
            m.RecordReaderMultiDataSetIterator.builder(2).build()
        with pytest.raises(ValueError, match="unknown readers"):
            (m.RecordReaderMultiDataSetIterator.builder(2)
             .add_input("x", 0, 1).add_output("x", 2, 2).build())


# ---------------------------------------------------------------- formatter
def test_formatter_splits_like_jax(tmp_path):
    src = tmp_path / "src"
    for label in ("cat", "dog", "eel"):
        (src / label).mkdir(parents=True)
        for i in range(7):
            (src / label / f"{i}.img").write_bytes(bytes([i]) * (i + 1))
    listings = []
    for m, dest in ((tfo, tmp_path / "t"), (jfo, tmp_path / "j")):
        f = m.LocalUnstructuredDataFormatter(dest, src, test_fraction=0.3,
                                             seed=4)
        f.rearrange()
        listings.append(sorted(str(p.relative_to(dest))
                               for p in dest.rglob("*") if p.is_file()))
        assert (f.get_num_examples_total(), f.get_num_test_examples(),
                f.get_num_examples_to_train_on()) == (21, 6, 15)
    assert listings[0] == listings[1]
    for m in (tfo, jfo):
        with pytest.raises(ValueError, match="test_fraction"):
            m.LocalUnstructuredDataFormatter(tmp_path, src, 1.0)
        with pytest.raises(FileNotFoundError):
            m.LocalUnstructuredDataFormatter(tmp_path / "x",
                                             tmp_path / "none").rearrange()


# ------------------------------------------------------------------ interop
def test_torch_interop_matches_jax():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((10, 3, 8, 8)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 5, 10))
    ds = torch.utils.data.TensorDataset(x, y)
    _same(ti.from_torch(ds, batch_size=4, n_classes=5),
          ji.from_torch(ds, batch_size=4, n_classes=5))
    got = next(iter(ti.from_torch(ds, batch_size=4, n_classes=5)))
    assert got.features.shape == (4, 8, 8, 3) and got.labels.shape == (4, 5)
    loader = torch.utils.data.DataLoader(ds, batch_size=3)
    _same(ti.TorchDataSetIterator(loader), ji.TorchDataSetIterator(loader))
    assert ti.TorchDataSetIterator(loader).batch() == 3
    for m in (ti, ji):
        with pytest.raises(ValueError, match="expected \\(features, labels\\)"):
            list(m.TorchDataSetIterator([x[:2]]))
    it = tdata.INDArrayDataSetIterator(rng.standard_normal((6, 2)).astype(
        np.float32), np.eye(2, dtype=np.float32)[[0, 1] * 3], 4)
    got = list(ti.as_torch_dataset(it))
    want = list(ji.as_torch_dataset(it))
    assert len(got) == len(want) == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        assert torch.equal(gx, wx) and torch.equal(gy, wy)


# ------------------------------------------------------------ the fetchers
def _write_idx(path, arr, gz=False):
    header = struct.pack(">I", 0x0800 | arr.ndim) + \
        struct.pack(">" + "I" * arr.ndim, *arr.shape)
    data = header + arr.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as fh:
            fh.write(data)
    else:
        path.write_bytes(data)


def test_mnist_from_idx_files_and_synthetic(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (50, 28, 28))
    labs = rng.integers(0, 10, 50)
    _write_idx(tmp_path / "train-images-idx3-ubyte", imgs)
    _write_idx(tmp_path / "train-labels-idx1-ubyte", labs, gz=True)
    np.testing.assert_array_equal(
        tm._read_idx(tmp_path / "train-labels-idx1-ubyte.gz"), labs)
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    for kw in (dict(), dict(binarize=True, flatten=False, num_examples=30,
                            shuffle=False)):
        t = tm.MnistDataSetIterator(16, **kw)
        assert not t.synthetic and t.total_examples() == kw.get(
            "num_examples", 50)
        _same(t, jm.MnistDataSetIterator(16, **kw))
    monkeypatch.delenv("MNIST_DIR")
    t = tm.MnistDataSetIterator(512, train=False)
    assert t.synthetic
    _same(t, jm.MnistDataSetIterator(512, train=False))
    _same(tm.IrisDataSetIterator(50), jm.IrisDataSetIterator(50))


def test_emnist_cifar_and_synthetic_stand_ins(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    _write_idx(tmp_path / "emnist-letters-train-images-idx3-ubyte",
               rng.integers(0, 256, (40, 28, 28)), gz=True)
    _write_idx(tmp_path / "emnist-letters-train-labels-idx1-ubyte",
               rng.integers(1, 27, 40))
    monkeypatch.setenv("EMNIST_DIR", str(tmp_path))
    t = tfe.EmnistDataSetIterator("letters", 16)
    assert not t.synthetic and t.data.labels.shape == (40, 26)
    _same(t, jfe.EmnistDataSetIterator("letters", 16))
    _same(tfe.EmnistDataSetIterator("digits", 1024),      # no files: synthetic
          jfe.EmnistDataSetIterator("digits", 1024))
    assert tfe.EmnistDataSetIterator.num_labels("byclass") == 62
    for m in (tfe, jfe):
        with pytest.raises(ValueError, match="unknown EMNIST split"):
            m.EmnistDataSetIterator("nope", 4)
    # CIFAR-10: the five training batches and the test batch, 12 records
    # each, in the 3073-byte record format
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
            ["test_batch.bin"]:
        rec = rng.integers(0, 256, (12, 3073), dtype=np.uint8)
        rec[:, 0] %= 10
        (tmp_path / name).write_bytes(rec.tobytes())
    monkeypatch.setenv("CIFAR_DIR", str(tmp_path))
    for kw in (dict(), dict(train=False, shuffle=False),
               dict(num_examples=25)):
        t = tfe.CifarDataSetIterator(8, **kw)
        assert not t.synthetic and t.data.features.dtype == np.float32
        _same(t, jfe.CifarDataSetIterator(8, **kw))
    for var in ("CIFAR_DIR", "EMNIST_DIR"):
        monkeypatch.delenv(var)
    for make in (lambda m: m.CifarDataSetIterator(1024, train=False),
                 lambda m: m.TinyImageNetDataSetIterator(128,
                                                         num_examples=256),
                 lambda m: m.LFWDataSetIterator(128, hw=32,
                                                num_examples=256)):
        t = make(tfe)
        assert t.synthetic
        _same(t, make(jfe))


def test_data_package_exports_the_jax_names():
    skipped = {"ShapePolicy", "default_shape_policy"}
    assert set(tdata.__all__) == set(jdata.__all__) - skipped
    for name in tdata.__all__:
        assert getattr(tdata, name) is not None
