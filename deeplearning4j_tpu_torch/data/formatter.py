"""Raw-directory → train/test split formatter (port of
``data/formatter.py``, a copy: the same split from the same seed).

Reference ``deeplearning4j-core/.../datasets/rearrange/
LocalUnstructuredDataFormatter.java``: takes an unstructured labeled image
dir (``root/<label>/file``) and rearranges it into
``split/train/<label>/…`` + ``split/test/<label>/…`` by a test fraction.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import List

import numpy as np

__all__ = ["LocalUnstructuredDataFormatter"]


class LocalUnstructuredDataFormatter:
    """Deterministic (seeded) per-label split; files are copied (the
    reference moves, copying keeps the source intact — pass move=True for
    parity)."""

    def __init__(self, dest_dir, src_dir, test_fraction: float = 0.2,
                 seed: int = 123, move: bool = False):
        if not 0.0 <= test_fraction < 1.0:
            raise ValueError(f"test_fraction must be in [0,1), got "
                             f"{test_fraction}")
        self.dest = Path(dest_dir)
        self.src = Path(src_dir)
        self.test_fraction = test_fraction
        self.seed = seed
        self.move = move
        self.num_examples_total = 0
        self.num_test = 0

    def rearrange(self) -> None:
        if not self.src.is_dir():
            raise FileNotFoundError(f"source dir {self.src} does not exist")
        rng = np.random.default_rng(self.seed)
        for label_dir in sorted(p for p in self.src.iterdir() if p.is_dir()):
            files: List[Path] = sorted(
                p for p in label_dir.iterdir() if p.is_file())
            if not files:
                continue
            order = rng.permutation(len(files))
            n_test = int(round(len(files) * self.test_fraction))
            test_idx = set(order[:n_test].tolist())
            for i, f in enumerate(files):
                split = "test" if i in test_idx else "train"
                target = self.dest / "split" / split / label_dir.name
                target.mkdir(parents=True, exist_ok=True)
                if self.move:
                    shutil.move(str(f), target / f.name)
                else:
                    shutil.copy2(f, target / f.name)
                self.num_examples_total += 1
                self.num_test += split == "test"

    def get_num_examples_total(self) -> int:
        return self.num_examples_total

    def get_num_examples_to_train_on(self) -> int:
        return self.num_examples_total - self.num_test

    def get_num_test_examples(self) -> int:
        return self.num_test
