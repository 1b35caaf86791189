"""Sentence / document iterators.

Reference ``deeplearning4j-nlp/.../text/sentenceiterator/`` (``SentenceIterator``,
``BasicLineIterator``, ``CollectionSentenceIterator``, ``FileSentenceIterator``,
``AggregatingSentenceIterator``, ``MutipleEpochsSentenceIterator``) and
``text/documentiterator/`` (``LabelAwareIterator``, ``LabelledDocument``,
``LabelsSource``, ``SimpleLabelAwareIterator``, ``FileLabelAwareIterator``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Sequence


class SentenceIterator:
    """Restartable sentence stream (reference ``SentenceIterator.java``)."""

    def __init__(self, pre_processor: Optional[Callable[[str], str]] = None):
        self.pre_processor = pre_processor

    def _raw(self) -> Iterable[str]:
        raise NotImplementedError

    def __iter__(self):
        for s in self._raw():
            yield self.pre_processor(s) if self.pre_processor else s

    # Java-style cursor API kept for parity convenience
    def reset(self) -> None:  # iterators here restart on __iter__
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Sequence[str], **kw):
        super().__init__(**kw)
        self._sentences = list(sentences)

    def _raw(self):
        return iter(self._sentences)


class BasicLineIterator(SentenceIterator):
    """One sentence per line of a file (``BasicLineIterator.java``)."""

    def __init__(self, path: str, **kw):
        super().__init__(**kw)
        self.path = path

    def _raw(self):
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


LineSentenceIterator = BasicLineIterator


class FileSentenceIterator(SentenceIterator):
    """Every file under a directory, one sentence per line
    (``FileSentenceIterator.java``)."""

    def __init__(self, root: str, **kw):
        super().__init__(**kw)
        self.root = root

    def _raw(self):
        for dirpath, _, names in sorted(os.walk(self.root)):
            for name in sorted(names):
                with open(os.path.join(dirpath, name), encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            yield line


class AggregatingSentenceIterator(SentenceIterator):
    def __init__(self, iterators: Sequence[SentenceIterator], **kw):
        super().__init__(**kw)
        self._iterators = list(iterators)

    def _raw(self):
        for it in self._iterators:
            yield from it


class MultipleEpochsSentenceIterator(SentenceIterator):
    """Replays the underlying iterator n times
    (``MutipleEpochsSentenceIterator.java`` — typo is the reference's)."""

    def __init__(self, base: SentenceIterator, n_epochs: int, **kw):
        super().__init__(**kw)
        self.base, self.n_epochs = base, n_epochs

    def _raw(self):
        for _ in range(self.n_epochs):
            yield from self.base


# ---------------------------------------------------------------------------
# label-aware documents (ParagraphVectors input)
# ---------------------------------------------------------------------------

@dataclass
class LabelledDocument:
    """Reference ``text/documentiterator/LabelledDocument.java``."""
    content: str
    labels: List[str] = field(default_factory=list)


class LabelsSource:
    """Generates/stores document labels (``LabelsSource.java``)."""

    def __init__(self, template: str = "DOC_%d"):
        self.template = template
        self._labels: List[str] = []
        self._seen = set()

    def next_label(self) -> str:
        label = self.template % len(self._labels)
        self.store_label(label)
        return label

    def store_label(self, label: str) -> None:
        if label not in self._seen:
            self._seen.add(label)
            self._labels.append(label)

    @property
    def labels(self) -> List[str]:
        return list(self._labels)


class LabelAwareIterator:
    """Restartable LabelledDocument stream (``LabelAwareIterator.java``)."""

    def __iter__(self) -> Iterable[LabelledDocument]:
        raise NotImplementedError

    def get_labels_source(self) -> LabelsSource:
        raise NotImplementedError


class SimpleLabelAwareIterator(LabelAwareIterator):
    def __init__(self, documents: Sequence[LabelledDocument]):
        self._docs = list(documents)
        self._source = LabelsSource()
        for d in self._docs:
            for l in d.labels:
                self._source.store_label(l)

    def __iter__(self):
        return iter(self._docs)

    def get_labels_source(self) -> LabelsSource:
        return self._source


class FileLabelAwareIterator(LabelAwareIterator):
    """Directory-per-label corpus layout (``FileLabelAwareIterator.java``)."""

    def __init__(self, root: str):
        self.root = root
        self._source = LabelsSource()
        for name in sorted(os.listdir(root)):
            if os.path.isdir(os.path.join(root, name)):
                self._source.store_label(name)

    def __iter__(self):
        for label in self._source.labels:
            d = os.path.join(self.root, label)
            for name in sorted(os.listdir(d)):
                with open(os.path.join(d, name), encoding="utf-8") as f:
                    yield LabelledDocument(f.read(), [label])

    def get_labels_source(self) -> LabelsSource:
        return self._source


class SentenceIteratorConverter(LabelAwareIterator):
    """Wrap a plain SentenceIterator, auto-labelling each sentence
    (reference ``interoperability/BasicLabelAwareIterator.java``)."""

    def __init__(self, base: SentenceIterator, template: str = "DOC_%d"):
        self.base = base
        self._source = LabelsSource(template)

    def __iter__(self):
        for s in self.base:
            yield LabelledDocument(s, [self._source.next_label()])

    def get_labels_source(self) -> LabelsSource:
        return self._source
