"""NLP of the PyTorch port (port of the JAX package's ``nlp``; reference
``deeplearning4j-nlp-parent``): embeddings (Word2Vec, ParagraphVectors,
GloVe), vocab, the text pipeline.

The SequenceVectors engine's native AggregateSkipGram/CBOW hot loop becomes
batched table updates on the device (``elements.py``, plain PyTorch);
tokenization and vocab stay on the host.  The trainers take
``device="cuda"`` by default and raise without a card unless given
``device="cpu"``.
"""
from .cjk import (ChineseTokenizerFactory, JapaneseTokenizerFactory,
                  KoreanTokenizerFactory)
from .glove import Glove
from .inverted_index import InvertedIndex, KeywordExtractor
from .lookup_table import InMemoryLookupTable
from .moving_window import (ContextLabelRetriever, Window, WindowConverter,
                            windows)
from .paragraph_vectors import ParagraphVectors
from .sentence_iterator import (AggregatingSentenceIterator, BasicLineIterator,
                                CollectionSentenceIterator,
                                FileLabelAwareIterator, FileSentenceIterator,
                                LabelAwareIterator, LabelledDocument,
                                LabelsSource, LineSentenceIterator,
                                MultipleEpochsSentenceIterator,
                                SentenceIterator, SentenceIteratorConverter,
                                SimpleLabelAwareIterator)
from .sequence_vectors import SequenceVectors
from .serializer import (read_binary, read_full_model, read_word_vectors,
                         write_binary, write_full_model, write_word_vectors)
from .tokenization import (CommonPreprocessor, DefaultTokenizer,
                           DefaultTokenizerFactory, EndingPreProcessor,
                           LowCasePreProcessor, NGramTokenizer,
                           NGramTokenizerFactory, TokenPreProcess, Tokenizer,
                           TokenizerFactory)
from .uima import PosTagger, SentenceSegmenter, UimaSentenceIterator
from .vectorizer import BagOfWordsVectorizer, TfidfVectorizer
from .vocab import (VocabCache, VocabConstructor, VocabWord, build_huffman,
                    make_unigram_table, subsample_keep_prob)
from .word2vec import Word2Vec
from .word_vectors import WordVectors

__all__ = [
    "Window", "windows", "WindowConverter", "ContextLabelRetriever",
    "PosTagger", "SentenceSegmenter", "UimaSentenceIterator",
    "ChineseTokenizerFactory", "JapaneseTokenizerFactory",
    "KoreanTokenizerFactory", "InvertedIndex", "KeywordExtractor",
    "Glove", "InMemoryLookupTable", "ParagraphVectors", "SequenceVectors",
    "Word2Vec", "WordVectors", "VocabCache", "VocabConstructor", "VocabWord",
    "build_huffman", "make_unigram_table", "subsample_keep_prob",
    "BagOfWordsVectorizer", "TfidfVectorizer",
    "read_binary", "read_full_model", "read_word_vectors", "write_binary",
    "write_full_model", "write_word_vectors",
    "CommonPreprocessor", "DefaultTokenizer", "DefaultTokenizerFactory",
    "EndingPreProcessor", "LowCasePreProcessor", "NGramTokenizer",
    "NGramTokenizerFactory", "TokenPreProcess", "Tokenizer",
    "TokenizerFactory",
    "AggregatingSentenceIterator", "BasicLineIterator",
    "CollectionSentenceIterator", "FileLabelAwareIterator",
    "FileSentenceIterator", "LabelAwareIterator", "LabelledDocument",
    "LabelsSource", "LineSentenceIterator", "MultipleEpochsSentenceIterator",
    "SentenceIterator", "SentenceIteratorConverter", "SimpleLabelAwareIterator",
]
