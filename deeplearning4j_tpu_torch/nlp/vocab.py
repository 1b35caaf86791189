"""Vocabulary construction: VocabWord, VocabCache, Huffman coding, unigram table.

Reference: ``models/word2vec/VocabWord.java``, ``models/word2vec/Huffman.java``,
``models/word2vec/wordstore/inmemory/AbstractCache.java`` (VocabCache),
``models/word2vec/wordstore/VocabConstructor.java``.

The Huffman tree gives each word a binary ``code`` (path bits) and ``points``
(internal-node row indices into syn1) for hierarchical softmax; the unigram
table (counts^0.75) drives negative sampling — both are built once on the
host, then shipped to the device as padded integer tensors (see elements.py).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


@dataclass
class VocabWord:
    """Reference ``models/word2vec/VocabWord.java``."""
    word: str
    count: int = 1
    index: int = -1
    codes: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)
    is_label: bool = False  # ParagraphVectors document labels live in vocab too

    @property
    def code_length(self) -> int:
        return len(self.codes)


class VocabCache:
    """Word ↔ index ↔ frequency store (reference ``AbstractCache.java``)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0

    # -- construction --------------------------------------------------------
    def add_token(self, vw: VocabWord) -> None:
        cur = self._words.get(vw.word)
        if cur is None:
            vw.index = len(self._by_index)
            self._words[vw.word] = vw
            self._by_index.append(vw)
        else:
            cur.count += vw.count

    # -- queries -------------------------------------------------------------
    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def word_at_index(self, index: int) -> str:
        return self._by_index[index].word

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return -1 if vw is None else vw.index

    def index_map(self) -> Dict[str, int]:
        """Plain word→index dict for bulk token indexing (one dict lookup
        per token instead of a method call + VocabWord hop).  Built fresh on
        each call — callers hold it for the duration of one fit."""
        return {vw.word: vw.index for vw in self._by_index}

    def word_frequency(self, word: str) -> int:
        vw = self._words.get(word)
        return 0 if vw is None else vw.count

    def num_words(self) -> int:
        return len(self._by_index)

    def words(self) -> List[str]:
        return [vw.word for vw in self._by_index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def __len__(self) -> int:
        return len(self._by_index)

    # -- derived structures ----------------------------------------------------
    def update_huffman(self) -> None:
        build_huffman(self._by_index)

    def counts_array(self) -> np.ndarray:
        return np.array([vw.count for vw in self._by_index], dtype=np.int64)


def build_huffman(words: Sequence[VocabWord], max_code_length: int = 40) -> None:
    """Assign Huffman ``codes``/``points`` to every word in place.

    Reference ``models/word2vec/Huffman.java`` (same contract as the original
    word2vec C tree): internal node ``i`` (0-based, 0 ≤ i < V-1) is row ``i``
    of syn1; ``points`` is the root→leaf path of internal nodes, ``codes`` the
    corresponding child bits.
    """
    n = len(words)
    if n == 0:
        return
    if n == 1:
        words[0].codes, words[0].points = [0], [0]
        return
    # heap of (count, tiebreak, node_id); leaves 0..n-1, internal n..2n-2
    counts = {i: words[i].count for i in range(n)}
    left: Dict[int, int] = {}
    right: Dict[int, int] = {}
    heap = [(words[i].count, i, i) for i in range(n)]
    heapq.heapify(heap)
    next_id = n
    while len(heap) > 1:
        c1, _, a = heapq.heappop(heap)
        c2, _, b = heapq.heappop(heap)
        left[next_id], right[next_id] = a, b
        counts[next_id] = c1 + c2
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = heap[0][2]
    # DFS assigning codes; internal node id -> syn1 row = id - n
    stack = [(root, [], [])]
    while stack:
        node, code, points = stack.pop()
        if node < n:  # leaf
            words[node].codes = code[-max_code_length:]
            words[node].points = points[-max_code_length:]
            continue
        row = node - n
        stack.append((left[node], code + [0], points + [row]))
        stack.append((right[node], code + [1], points + [row]))


class VocabConstructor:
    """Scan token sequences → pruned, Huffman-coded VocabCache.

    Reference ``models/word2vec/wordstore/VocabConstructor.java`` (scanner
    threads collapsed into one pass — host-side counting is not the
    bottleneck).
    """

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency

    def build(self, sequences: Iterable[Sequence[str]],
              special_labels: Sequence[str] = ()) -> VocabCache:
        counts: Dict[str, int] = {}
        total = 0
        for seq in sequences:
            for tok in seq:
                counts[tok] = counts.get(tok, 0) + 1
                total += 1
        cache = VocabCache()
        # most-frequent-first indexing (reference sorts by frequency desc)
        kept = [(w, c) for w, c in counts.items()
                if c >= self.min_word_frequency]
        kept.sort(key=lambda wc: (-wc[1], wc[0]))
        for w, c in kept:
            cache.add_token(VocabWord(w, count=c))
        for label in special_labels:
            if not cache.contains_word(label):
                cache.add_token(VocabWord(label, count=1, is_label=True))
        cache.total_word_count = sum(c for _, c in kept)
        cache.update_huffman()
        return cache


def make_unigram_table(cache: VocabCache, table_size: int = 100_000,
                       power: float = 0.75) -> np.ndarray:
    """Negative-sampling table: word i occupies a slice ∝ count^0.75.

    Reference ``InMemoryLookupTable.makeTable`` (table default 100M in the C
    original; smaller here — sampling quality is unchanged for our vocab
    sizes and the table lives in HBM).
    """
    counts = cache.counts_array().astype(np.float64)
    if counts.size == 0:
        return np.zeros(0, dtype=np.int32)
    probs = counts ** power
    probs /= probs.sum()
    bounds = np.cumsum(probs) * table_size
    table = np.zeros(table_size, dtype=np.int32)
    idx = 0
    for pos in range(table_size):
        table[pos] = idx
        if pos + 1 > bounds[idx] and idx < len(counts) - 1:
            idx += 1
    return table


def subsample_keep_prob(cache: VocabCache, sample: float) -> np.ndarray:
    """Per-word keep-probability for frequent-word subsampling.

    word2vec formula (reference ``SkipGram.frameSequence``):
    ``ran = (sqrt(f/(sample*total)) + 1) * (sample*total)/f``, clipped to 1.
    """
    counts = cache.counts_array().astype(np.float64)
    if sample <= 0 or counts.size == 0:
        return np.ones_like(counts)
    thresh = sample * max(cache.total_word_count, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ran = (np.sqrt(counts / thresh) + 1.0) * thresh / np.maximum(counts, 1)
    return np.clip(ran, 0.0, 1.0)
