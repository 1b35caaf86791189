"""Autoregressive generation (port of ``generation/``): the paged KV
cache (:mod:`.cache`), the paged prefill and decode programs
(:mod:`.programs`), per-row sampling over a ported threefry stream
(:mod:`.sampling`, on ``utils/_random``) and the continuous-batching engine
(:mod:`.engine`)."""
from .engine import (GenerationConfig, GenerationEngine, GenerationResult,
                     StaticSlotSource)
from .sampling import sample_tokens

__all__ = ["GenerationConfig", "GenerationEngine", "GenerationResult",
           "StaticSlotSource", "sample_tokens"]
