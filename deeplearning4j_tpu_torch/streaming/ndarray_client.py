"""NDArray publisher/consumer over a broker (port of
``streaming/ndarray_client.py``, host code).  The publisher also takes a
torch tensor on any device: ``host_array`` copies it to the host once
before the codec frames it, where the JAX code's ``np.asarray`` reads a
device array.

Reference ``dl4j-streaming/.../kafka/{NDArrayPublisher,NDArrayConsumer,
NDArrayKafkaClient}.java`` — typed array pub/sub riding the codec frames.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .codec import deserialize_array, serialize_array

__all__ = ["NDArrayPublisher", "NDArrayConsumer"]


def host_array(arr) -> np.ndarray:
    """``arr`` as a numpy array: a torch tensor (on the card or not)
    through one device-to-host copy, anything else through
    ``np.asarray``."""
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class NDArrayPublisher:
    def __init__(self, broker, topic: str):
        self.broker = broker
        self.topic = topic

    def publish(self, arr) -> None:
        self.broker.publish(self.topic, serialize_array(host_array(arr)))

    def publish_all(self, arrays) -> None:
        for a in arrays:
            self.publish(a)


class NDArrayConsumer:
    def __init__(self, broker, topic: str):
        self.broker = broker
        self.topic = topic
        self._sub = broker.subscribe(topic)

    def get_array(self, timeout: Optional[float] = 5.0
                  ) -> Optional[np.ndarray]:
        payload = self._sub.poll(timeout=timeout)
        if payload is None:
            return None
        arr, _ = deserialize_array(payload)
        return arr

    def get_arrays(self, n: int, timeout: Optional[float] = 5.0
                   ) -> List[np.ndarray]:
        out = []
        for _ in range(n):
            a = self.get_array(timeout=timeout)
            if a is None:
                break
            out.append(a)
        return out

    def close(self) -> None:
        if hasattr(self._sub, "close"):
            self._sub.close()
        elif hasattr(self.broker, "unsubscribe"):
            self.broker.unsubscribe(self.topic, self._sub)
