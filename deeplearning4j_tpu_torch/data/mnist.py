"""MNIST and Iris iterators (port of ``data/mnist.py``, a copy: numpy
only, the same bytes from the same files and seeds).

Analogue of ``datasets/fetchers/MnistDataFetcher.java:40`` +
``datasets/iterator/impl/MnistDataSetIterator.java``: reads the standard
IDX binary format from the directory ``$MNIST_DIR`` names (the reference
downloads with a checksum; the port reads only where the user points),
and otherwise generates a deterministic synthetic drop-in with the same
shapes and format, byte for byte the JAX package's.
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .dataset import INDArrayDataSetIterator

__all__ = ["MnistDataSetIterator", "IrisDataSetIterator"]

MNIST_NUM_EXAMPLES = 60000
MNIST_NUM_TEST = 10000


def _read_idx(path: Path) -> np.ndarray:
    """Read an IDX file (the reference's custom MnistDbFile reader,
    ``datasets/mnist/MnistDbFile.java``)."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_mnist_dir() -> Optional[Path]:
    """``$MNIST_DIR`` when it holds the training images (plain or .gz)."""
    cand = os.environ.get("MNIST_DIR")
    if cand is None:
        return None
    p = Path(cand).expanduser()
    if p.is_dir():
        for stem in ("train-images-idx3-ubyte", "train-images.idx3-ubyte"):
            if (p / stem).exists() or (p / (stem + ".gz")).exists():
                return p
    return None


def _load_real(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    d = _find_mnist_dir()
    if d is None:
        return None
    img_stem = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    lbl_stem = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"

    def find(stem):
        for s in (stem, stem.replace("-idx", ".idx")):
            for suffix in ("", ".gz"):
                p = d / (s + suffix)
                if p.exists():
                    return p
        return None

    ip, lp = find(img_stem), find(lbl_stem)
    if ip is None or lp is None:
        return None
    return _read_idx(ip), _read_idx(lp)


def _synthetic(train: bool, seed: int = 123) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped synthetic data: 10 class-dependent blob
    patterns + noise, learnable by LeNet — serves tests and benchmarks when
    the real corpus isn't on disk."""
    n = 8192 if train else 2048
    rng = np.random.default_rng(seed if train else seed + 1)
    labels = rng.integers(0, 10, n)
    # class prototype: a bright 8x8 patch at a class-specific location
    images = (rng.standard_normal((n, 28, 28)) * 16 + 32).clip(0, 255)
    for c in range(10):
        r, col = divmod(c, 4)
        mask = labels == c
        images[mask, 4 + r * 6:12 + r * 6, 2 + col * 6:10 + col * 6] += 160
    return images.clip(0, 255).astype(np.uint8), labels.astype(np.uint8)


class MnistDataSetIterator(INDArrayDataSetIterator):
    """Reference-compatible MNIST iterator: features [batch, 784] in [0,1],
    labels one-hot [batch, 10] (``MnistDataSetIterator.java`` binarize=False
    default).  Batch slicing/shuffling is inherited from
    INDArrayDataSetIterator (partial final batch kept)."""

    def __init__(self, batch_size: int, train: bool = True,
                 num_examples: Optional[int] = None, binarize: bool = False,
                 shuffle: bool = True, seed: int = 6, flatten: bool = True):
        data = _load_real(train)
        self.synthetic = data is None
        if data is None:
            images, labels = _synthetic(train)
        else:
            images, labels = data
        if num_examples is not None:
            images, labels = images[:num_examples], labels[:num_examples]
        feats = images.astype(np.float32) / 255.0
        if binarize:
            feats = (feats > 0.5).astype(np.float32)
        features = feats.reshape(len(feats), -1) if flatten else feats[..., None]
        labels_1hot = np.eye(10, dtype=np.float32)[labels.astype(np.int64)]
        super().__init__(features, labels_1hot, batch_size,
                         shuffle=shuffle, seed=seed)

    def total_examples(self):
        return self.data.num_examples()


class IrisDataSetIterator(INDArrayDataSetIterator):
    """Iris (reference ``datasets/iterator/impl/IrisDataSetIterator.java``).
    The 150-example Fisher iris table is small enough to embed parametrically:
    we regenerate it from the canonical per-class Gaussian stats when the CSV
    isn't on disk (IRIS_CSV env var)."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150, seed: int = 12345):
        path = os.environ.get("IRIS_CSV")
        if path and Path(path).exists():
            raw = np.loadtxt(path, delimiter=",")
            feats, labels = raw[:, :4], raw[:, 4].astype(int)
        else:
            rng = np.random.default_rng(seed)
            means = np.array([[5.01, 3.43, 1.46, 0.25],
                              [5.94, 2.77, 4.26, 1.33],
                              [6.59, 2.97, 5.55, 2.03]])
            stds = np.array([[0.35, 0.38, 0.17, 0.11],
                             [0.52, 0.31, 0.47, 0.20],
                             [0.64, 0.32, 0.55, 0.27]])
            per = num_examples // 3
            feats = np.concatenate([
                means[c] + stds[c] * rng.standard_normal((per, 4))
                for c in range(3)])
            labels = np.repeat(np.arange(3), per)
        order = np.random.default_rng(seed).permutation(len(feats))
        super().__init__(feats[order].astype(np.float32),
                         np.eye(3, dtype=np.float32)[labels[order]],
                         batch_size)
