"""Word2Vec: user-facing facade over SequenceVectors (port of
``nlp/word2vec.py``).

Reference ``models/word2vec/Word2Vec.java:32``: wires a SentenceIterator
+ TokenizerFactory into the SequenceVectors engine with SkipGram (the
default) or CBOW element learning.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from .sentence_iterator import CollectionSentenceIterator, SentenceIterator
from .sequence_vectors import SequenceVectors
from .tokenization import DefaultTokenizerFactory, TokenizerFactory


class Word2Vec(SequenceVectors):
    def __init__(self, sentence_iterator: Optional[SentenceIterator] = None,
                 sentences: Optional[Sequence[str]] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **kwargs):
        # every SequenceVectors argument, ``device`` ("cuda" by default)
        # included, passes through kwargs
        kwargs.setdefault("layer_size", 100)
        super().__init__(**kwargs)
        if sentence_iterator is None and sentences is not None:
            sentence_iterator = CollectionSentenceIterator(sentences)
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def _sequences(self) -> Iterable[List[str]]:
        for sentence in self.sentence_iterator:
            toks = self.tokenizer_factory.create(sentence).get_tokens()
            if toks:
                yield toks

    def _raw_sentences(self):
        """Raw sentence strings for the native corpus indexer — only when
        tokenization is exactly ``str.split`` (plain DefaultTokenizerFactory,
        no token or sentence pre-processor), so the native and Python paths
        cannot tokenize differently."""
        it = self.sentence_iterator
        if (type(self.tokenizer_factory) is DefaultTokenizerFactory
                and self.tokenizer_factory._pre is None
                and type(it) is CollectionSentenceIterator
                and it.pre_processor is None):
            return it._sentences
        return None
