"""Dataset fetchers (port of ``data/fetchers.py``, a copy: numpy only;
reference ``deeplearning4j-core/.../datasets/fetchers/``:
``EmnistDataFetcher``, ``CifarDataSetIterator``, ``TinyImageNetFetcher``,
``LFWDataFetcher``).

Same gating as MNIST (``mnist.py``): the real corpus is read from the
directory an environment variable names (``EMNIST_DIR``, ``CIFAR_DIR``,
``TINY_IMAGENET_DIR``, ``LFW_DIR``), and otherwise a deterministic
synthetic drop-in with identical shapes, byte for byte the JAX
package's, takes its place.  CIFAR-10's binary batches go through the
native ``decode_cifar`` (``utils/native``); the JPEG corpora need PIL
and fall back to the synthetic set where it is missing.
"""
from __future__ import annotations

import os
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .dataset import INDArrayDataSetIterator
from .mnist import _read_idx

__all__ = ["EmnistDataSetIterator", "CifarDataSetIterator",
           "TinyImageNetDataSetIterator", "LFWDataSetIterator"]

# EMNIST splits -> (n_classes, idx file prefix)
_EMNIST_VARIANTS = {
    "byclass": 62, "bymerge": 47, "balanced": 47, "letters": 26,
    "digits": 10, "mnist": 10,
}


def _synthetic_images(n: int, hw: int, channels: int, n_classes: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-dependent bright patches + noise (learnable, deterministic)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n)
    shape = (n, hw, hw, channels) if channels > 1 else (n, hw, hw)
    images = (rng.standard_normal(shape) * 16 + 32).clip(0, 255)
    cell = max(hw // 8, 2)
    per_row = max(hw // cell - 1, 1)
    for c in range(n_classes):
        r, col = divmod(c % (per_row * per_row), per_row)
        m = labels == c
        sl = (m, slice(r * cell, (r + 2) * cell),
              slice(col * cell, (col + 2) * cell))
        images[sl] += 120 + 40 * ((c // (per_row * per_row)) % 3)
    return images.clip(0, 255).astype(np.uint8), labels.astype(np.int64)


class EmnistDataSetIterator(INDArrayDataSetIterator):
    """EMNIST (reference ``EmnistDataSetIterator.java``): IDX files from
    ``EMNIST_DIR`` (e.g. emnist-letters-train-images-idx3-ubyte) or synthetic.
    ``dataset`` selects the split; labels are 0-based one-hot."""

    def __init__(self, dataset: str, batch_size: int, train: bool = True,
                 shuffle: bool = True, seed: int = 6):
        if dataset not in _EMNIST_VARIANTS:
            raise ValueError(f"unknown EMNIST split '{dataset}'; expected one "
                             f"of {sorted(_EMNIST_VARIANTS)}")
        self.dataset = dataset
        n_classes = _EMNIST_VARIANTS[dataset]
        data = self._load_real(dataset, train)
        self.synthetic = data is None
        if data is None:
            # crc32, not hash(): hash() is salted per process, which would
            # give distributed workers different "deterministic" data
            images, labels = _synthetic_images(
                4096 if train else 1024, 28, 1, n_classes,
                seed=zlib.crc32(dataset.encode()) % 2**31
                + (0 if train else 1))
        else:
            images, labels = data
            labels = labels.astype(np.int64)
            if dataset == "letters" and labels.min() == 1:
                labels = labels - 1  # letters split is 1-based in the corpus
        feats = images.astype(np.float32).reshape(len(images), -1) / 255.0
        onehot = np.eye(n_classes, dtype=np.float32)[labels]
        super().__init__(feats, onehot, batch_size, shuffle=shuffle, seed=seed)

    @staticmethod
    def _load_real(dataset: str, train: bool):
        d = os.environ.get("EMNIST_DIR")
        if not d or not Path(d).expanduser().is_dir():
            return None
        d = Path(d).expanduser()
        part = "train" if train else "test"
        img = d / f"emnist-{dataset}-{part}-images-idx3-ubyte"
        lbl = d / f"emnist-{dataset}-{part}-labels-idx1-ubyte"
        for p in (img, lbl):
            if not (p.exists() or p.with_suffix(p.suffix + ".gz").exists()):
                return None
        gz = lambda p: p if p.exists() else p.with_suffix(p.suffix + ".gz")
        return _read_idx(gz(img)), _read_idx(gz(lbl))

    @staticmethod
    def num_labels(dataset: str) -> int:
        return _EMNIST_VARIANTS[dataset]


class CifarDataSetIterator(INDArrayDataSetIterator):
    """CIFAR-10 (reference ``CifarDataSetIterator.java``): reads the binary
    batches (3073-byte records: label + 3x32x32 CHW) from ``CIFAR_DIR``,
    synthetic otherwise.  Features NHWC [n,32,32,3] in [0,1]."""

    N_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True,
                 num_examples: Optional[int] = None, shuffle: bool = True,
                 seed: int = 6):
        data = self._load_real(train)
        self.synthetic = data is None
        if data is None:
            images, labels = _synthetic_images(
                4096 if train else 1024, 32, 3, self.N_CLASSES,
                seed=99 if train else 100)
        else:
            images, labels = data
        if num_examples is not None:
            images, labels = images[:num_examples], labels[:num_examples]
        if images.dtype == np.float32:  # real corpus: already scaled by decode
            feats = images
        else:
            feats = images.astype(np.float32) / 255.0
        onehot = np.eye(self.N_CLASSES, dtype=np.float32)[labels]
        super().__init__(feats, onehot, batch_size, shuffle=shuffle, seed=seed)

    @staticmethod
    def _load_real(train: bool):
        d = os.environ.get("CIFAR_DIR")
        if not d or not Path(d).expanduser().is_dir():
            return None
        d = Path(d).expanduser()
        files = ([d / f"data_batch_{i}.bin" for i in range(1, 6)]
                 if train else [d / "test_batch.bin"])
        if not all(f.exists() for f in files):
            return None
        from ..utils.native import decode_cifar
        images, labels = [], []
        for f in files:
            # native C++ decode (GIL-free CHW->NHWC transpose + 1/255 scale);
            # already float32 in [0,1], so __init__ skips its own rescale
            lab, img = decode_cifar(f.read_bytes())
            labels.append(lab.astype(np.int64))
            images.append(img)
        return np.concatenate(images), np.concatenate(labels)


class TinyImageNetDataSetIterator(INDArrayDataSetIterator):
    """TinyImageNet-200 (reference ``TinyImageNetFetcher.java``): 64x64x3,
    200 classes, read from the standard extracted layout under
    ``TINY_IMAGENET_DIR`` (train/<wnid>/images/*.JPEG), synthetic otherwise."""

    N_CLASSES = 200
    HW = 64

    def __init__(self, batch_size: int, train: bool = True,
                 num_examples: Optional[int] = None, shuffle: bool = True,
                 seed: int = 6):
        data = self._load_real(train, num_examples)
        self.synthetic = data is None
        if data is None:
            n = num_examples or (2048 if train else 512)
            images, labels = _synthetic_images(
                n, self.HW, 3, self.N_CLASSES, seed=7 if train else 8)
        else:
            images, labels = data
        feats = images.astype(np.float32) / 255.0
        onehot = np.eye(self.N_CLASSES, dtype=np.float32)[labels]
        super().__init__(feats, onehot, batch_size, shuffle=shuffle, seed=seed)

    def _load_real(self, train: bool, num_examples: Optional[int]):
        d = os.environ.get("TINY_IMAGENET_DIR")
        if not d or not (Path(d).expanduser() / "train").is_dir():
            return None
        try:
            from PIL import Image
        except ImportError:
            return None
        root = Path(d).expanduser()
        wnids = sorted(p.name for p in (root / "train").iterdir()
                       if p.is_dir())
        images, labels = [], []
        if train:
            for ci, wnid in enumerate(wnids):
                for jp in sorted((root / "train" / wnid / "images").glob("*.JPEG")):
                    images.append(np.asarray(
                        Image.open(jp).convert("RGB").resize((self.HW, self.HW))))
                    labels.append(ci)
                    if num_examples and len(images) >= num_examples:
                        break
                if num_examples and len(images) >= num_examples:
                    break
        else:
            anno = root / "val" / "val_annotations.txt"
            if not anno.exists():
                return None
            wnid_to_ci = {w: i for i, w in enumerate(wnids)}
            for line in anno.read_text().splitlines():
                parts = line.split("\t")
                if len(parts) < 2:
                    continue
                jp = root / "val" / "images" / parts[0]
                if not jp.exists():
                    continue
                images.append(np.asarray(
                    Image.open(jp).convert("RGB").resize((self.HW, self.HW))))
                labels.append(wnid_to_ci[parts[1]])
                if num_examples and len(images) >= num_examples:
                    break
        if not images:
            return None
        return np.stack(images), np.asarray(labels, np.int64)


class LFWDataSetIterator(INDArrayDataSetIterator):
    """LFW faces (reference ``LFWDataSetIterator.java`` /
    ``LFWDataFetcher``): person-labeled face images read from the standard
    extracted layout under ``LFW_DIR`` (<person_name>/<img>.jpg), synthetic
    otherwise.  Features NHWC [n, hw, hw, 3] in [0,1]; labels one-hot over
    the ``num_labels`` most-photographed people."""

    def __init__(self, batch_size: int, hw: int = 64, num_labels: int = 10,
                 num_examples: Optional[int] = None, shuffle: bool = True,
                 seed: int = 6):
        self.hw = hw
        data = self._load_real(hw, num_labels, num_examples)
        self.synthetic = data is None
        if data is None:
            n = num_examples or 1024
            images, labels = _synthetic_images(n, hw, 3, num_labels, seed=21)
        else:
            images, labels = data
        feats = images.astype(np.float32) / 255.0
        onehot = np.eye(num_labels, dtype=np.float32)[labels]
        super().__init__(feats, onehot, batch_size, shuffle=shuffle, seed=seed)

    @staticmethod
    def _load_real(hw: int, num_labels: int, num_examples: Optional[int]):
        d = os.environ.get("LFW_DIR")
        if not d or not Path(d).expanduser().is_dir():
            return None
        try:
            from PIL import Image
        except ImportError:
            return None
        root = Path(d).expanduser()
        people = [(p, sorted(p.glob("*.jpg")))
                  for p in sorted(root.iterdir()) if p.is_dir()]
        people = [(p, fs) for p, fs in people if fs]
        people.sort(key=lambda t: -len(t[1]))
        people = people[:num_labels]
        images, labels = [], []
        for ci, (_, files) in enumerate(people):
            for jp in files:
                images.append(np.asarray(
                    Image.open(jp).convert("RGB").resize((hw, hw))))
                labels.append(ci)
                if num_examples and len(images) >= num_examples:
                    break
            if num_examples and len(images) >= num_examples:
                break
        if not images:
            return None
        return np.stack(images), np.asarray(labels, np.int64)
