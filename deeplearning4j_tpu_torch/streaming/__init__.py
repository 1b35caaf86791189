"""Streaming of the PyTorch port: pub/sub of serialized arrays and
DataSets, prediction routes, and the Kafka wire (port of the JAX
package's ``streaming/``, host code throughout).

``LocalMessageBroker`` (in-process topics) and ``TcpMessageBroker`` (a
TCP hub whose wire is the JAX package's), the codec frames,
``NDArrayPublisher``/``NDArrayConsumer`` and ``ServeRoute`` (reference
``dl4j-streaming``'s clients and ``DL4jServeRouteBuilder``);
``kafka_wire`` speaks the Kafka binary protocol (``NDArrayKafkaClient``,
``MiniKafkaBroker``).
"""
from .broker import LocalMessageBroker, TcpMessageBroker
from .codec import (deserialize_array, deserialize_dataset, serialize_array,
                    serialize_dataset)
from .ndarray_client import NDArrayConsumer, NDArrayPublisher
from .routes import ServeRoute

__all__ = ["LocalMessageBroker", "TcpMessageBroker", "NDArrayPublisher",
           "NDArrayConsumer", "ServeRoute", "serialize_array",
           "deserialize_array", "serialize_dataset", "deserialize_dataset"]
