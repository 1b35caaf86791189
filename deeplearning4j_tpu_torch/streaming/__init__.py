"""streaming of the PyTorch port: the in-process ``LocalMessageBroker``
and the ``TcpMessageBroker`` hub and client, whose wire is the JAX
package's (the rest of the JAX package's ``streaming/`` is not ported)."""
from .broker import LocalMessageBroker, TcpMessageBroker

__all__ = ["LocalMessageBroker", "TcpMessageBroker"]
