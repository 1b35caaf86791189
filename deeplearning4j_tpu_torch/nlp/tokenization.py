"""Tokenization pipeline.

Reference ``deeplearning4j-nlp/.../text/tokenization/``: ``Tokenizer`` /
``TokenizerFactory`` interfaces, ``DefaultTokenizer.java``,
``NGramTokenizer.java``, and ``TokenPreProcess`` implementations
(``preprocessor/CommonPreprocessor.java`` lowercase+strip-punct,
``preprocessor/EndingPreProcessor.java`` crude stemmer,
``preprocessor/LowCasePreProcessor.java``).

Host-side text processing — tokens become integer ids before anything
touches the device, so this layer is plain Python by design.
"""
from __future__ import annotations

import re
from typing import List, Optional


class TokenPreProcess:
    """Per-token normalization hook (reference ``TokenPreProcess.java``)."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


_PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip digits/punctuation (``CommonPreprocessor.java``)."""

    def pre_process(self, token: str) -> str:
        return _PUNCT.sub("", token.lower())


class EndingPreProcessor(TokenPreProcess):
    """Crude suffix stemmer (``EndingPreProcessor.java``)."""

    def pre_process(self, token: str) -> str:
        if token.endswith("s") and not token.endswith("ss"):
            token = token[:-1]
        if token.endswith("."):
            token = token[:-1]
        if token.endswith("ly"):
            token = token[:-2]
        if token.endswith("ing"):
            token = token[:-3]
        return token


class Tokenizer:
    """Token stream over one sentence (reference ``Tokenizer.java``)."""

    def __init__(self, tokens: List[str],
                 pre_processor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = pre_processor

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        out = []
        for t in self._tokens:
            if self._pre is not None:
                t = self._pre.pre_process(t)
            if t:
                out.append(t)
        return out

    def __iter__(self):
        return iter(self.get_tokens())


class DefaultTokenizer(Tokenizer):
    """Whitespace tokenizer (``DefaultTokenizer.java`` StringTokenizer)."""

    def __init__(self, sentence: str,
                 pre_processor: Optional[TokenPreProcess] = None):
        super().__init__(sentence.split(), pre_processor)


class NGramTokenizer(Tokenizer):
    """n-gram expansion of an underlying tokenizer (``NGramTokenizer.java``)."""

    def __init__(self, base: Tokenizer, min_n: int, max_n: int):
        words = base.get_tokens()
        tokens: List[str] = []
        if min_n == 1:
            tokens.extend(words)
        for n in range(max(min_n, 2), max_n + 1):
            for i in range(len(words) - n + 1):
                tokens.append(" ".join(words[i:i + n]))
        super().__init__(tokens, None)


class TokenizerFactory:
    """Creates tokenizers per sentence (reference ``TokenizerFactory.java``)."""

    def __init__(self, pre_processor: Optional[TokenPreProcess] = None):
        self._pre = pre_processor

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def create(self, sentence: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    def create(self, sentence: str) -> Tokenizer:
        return DefaultTokenizer(sentence, self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    def __init__(self, min_n: int, max_n: int,
                 pre_processor: Optional[TokenPreProcess] = None):
        super().__init__(pre_processor)
        self.min_n, self.max_n = min_n, max_n

    def create(self, sentence: str) -> Tokenizer:
        return NGramTokenizer(DefaultTokenizer(sentence, self._pre),
                              self.min_n, self.max_n)
