"""streaming of the PyTorch port: the in-process ``LocalMessageBroker``
(the rest of the JAX package's ``streaming/`` is not ported)."""
from .broker import LocalMessageBroker

__all__ = ["LocalMessageBroker"]
