"""The port's ``TcpMessageBroker`` against the JAX package's.

* ``_send_frame`` writes the JAX package's bytes for every op (publish,
  subscribe, subscribe with ack), exactly.
* A port client works against a JAX hub, and a JAX client against a port
  hub: publish, subscribe, and the registration ack, both ways; payloads
  come back bit for bit.
* A stale publisher socket is rebuilt under the reconnect policy and
  counted in ``broker_reconnects_total{op}``; an exhausted budget raises
  with the JAX package's words.
* ``RemoteGradientSharing`` runs over a port hub with its client in
  another process: every decoded message equals what was sent, bit for
  bit.

Tolerance: none; every check is exact.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from deeplearning4j_tpu.streaming import broker as jbroker
from deeplearning4j_tpu_torch.faulttolerance.faults import RetryPolicy
from deeplearning4j_tpu_torch.observability.registry import MetricsRegistry
from deeplearning4j_tpu_torch.observability import registry as tregistry
from deeplearning4j_tpu_torch.streaming import broker as tbroker
from deeplearning4j_tpu_torch.streaming import TcpMessageBroker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Capture:
    """A socket stand-in that keeps what ``sendall`` is given."""

    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


@pytest.mark.parametrize("op,topic,payload", [
    (0, "mp.up", b"\x00\x01payload"), (1, "gradients", b""),
    (2, "tépic", b""), (0, "", bytes(range(256)) * 3)])
def test_frame_bytes_equal_the_jax_ones(op, topic, payload):
    mine, theirs = _Capture(), _Capture()
    tbroker._send_frame(mine, op, topic, payload)
    jbroker._send_frame(theirs, op, topic, payload)
    assert mine.data == theirs.data and len(mine.data) == \
        7 + len(topic.encode()) + len(payload)


def _roundtrip(hub_cls, client_cls):
    hub = hub_cls().serve()
    try:
        client = client_cls(port=hub.port)
        sub = client.subscribe("t", ack=True)
        plain = client.subscribe("u")
        msgs = [b"", b"one", bytes(range(256)) * 40]
        for m in msgs:
            client.publish("t", m)
        got = [sub.poll(timeout=10) for _ in msgs]
        # a plain subscription registers before the next frame on the
        # same hub is handled only once the hub has read it: publish
        # until it lands
        for _ in range(200):
            client.publish("u", b"late")
            if plain.poll(timeout=0.05) == b"late":
                break
        else:
            raise AssertionError("plain subscription never registered")
        sub.close()
        plain.close()
        client.shutdown()
        return got, msgs
    finally:
        hub.shutdown()


@pytest.mark.parametrize("hub,client", [("jax", "port"), ("port", "jax")])
def test_clients_and_hubs_of_either_package_interoperate(hub, client):
    cls = {"jax": jbroker.TcpMessageBroker, "port": TcpMessageBroker}
    got, msgs = _roundtrip(cls[hub], cls[client])
    assert got == msgs


def test_publisher_reconnects_and_counts_then_gives_up():
    reg = MetricsRegistry(enabled=True)
    prev = tregistry.set_default_registry(reg)
    try:
        _reconnects(reg)
    finally:
        tregistry.set_default_registry(prev)


def _reconnects(reg):
    hub = TcpMessageBroker().serve()
    client = TcpMessageBroker(port=hub.port, reconnect_policy=RetryPolicy(
        max_retries=3, backoff_s=0.001, max_backoff_s=0.002))
    sub = hub.subscribe("t", ack=True)
    client.publish("t", b"a")
    assert sub.poll(timeout=10) == b"a"
    # the hub restarts on the same port: the client's socket is stale
    port = hub.port
    hub.shutdown()
    hub2 = TcpMessageBroker(port=port).serve()
    try:
        sub2 = hub2.subscribe("t", ack=True)
        got = None
        for _ in range(5):
            client.publish("t", b"b")
            got = sub2.poll(timeout=2)
            if got is not None:
                break
        assert got == b"b"
        counted = reg.counter("broker_reconnects_total", "",
                              ("op",)).labels("publish").value
        assert counted >= 1
    finally:
        hub2.shutdown()
    dead = TcpMessageBroker(port=port, reconnect_policy=RetryPolicy(
        max_retries=2, backoff_s=0.001, max_backoff_s=0.002))
    with pytest.raises(ConnectionError, match=r"broker publish to .* topic "
                       r"'t' failed after 2 reconnect attempts"):
        dead.publish("t", b"c")
    client.shutdown()


_CLIENT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.parallel.accumulation import \\
        EncodingHandler
    from deeplearning4j_tpu_torch.parallel.remote import \\
        RemoteGradientSharing
    from deeplearning4j_tpu_torch.streaming import TcpMessageBroker
    broker = TcpMessageBroker(port=int(sys.argv[1]))
    sharing = RemoteGradientSharing(broker, 7, topic="g", ack=True,
                                    handler=EncodingHandler(1e-3))
    rng = np.random.default_rng(0)
    for i in range(6):
        # sparse updates ride threshold frames, dense ones bitmap frames
        scale = 1e-2 if i % 2 else 4e-4
        g = torch.as_tensor(rng.standard_normal(4096).astype(np.float32)
                            * scale)
        sharing.publish_update(g)
    print(sharing.messages_sent, flush=True)
    broker.shutdown()
""")


def test_gradient_sharing_crosses_processes_over_the_port_hub():
    from deeplearning4j_tpu_torch.parallel.accumulation import (
        EncodingHandler, decode)
    from deeplearning4j_tpu_torch.parallel.remote import \
        decode_message_bytes
    import torch
    hub = TcpMessageBroker(max_queue=0).serve()
    try:
        sub = hub.subscribe("g", ack=True)
        env = dict(os.environ, PYTHONPATH=REPO)
        out = subprocess.run([sys.executable, "-c", _CLIENT, str(hub.port)],
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        frames = []
        while True:
            f = sub.poll(timeout=2)
            if f is None:
                break
            frames.append(f)
    finally:
        hub.shutdown()
    assert len(frames) == int(out.stdout.split()[-1]) == 6
    # the same encoder on the same updates in this process
    handler = EncodingHandler(1e-3)
    rng = np.random.default_rng(0)
    kinds = set()
    for i, frame in enumerate(frames):
        scale = 1e-2 if i % 2 else 4e-4
        g = torch.as_tensor(rng.standard_normal(4096).astype(np.float32)
                            * scale)
        want = handler.encode_update(g)
        sender, seq, msg = decode_message_bytes(frame)
        assert (sender, seq) == (7, i + 1)
        kinds.add(msg["kind"])
        assert msg["kind"] == want["kind"] and msg["size"] == want["size"]
        assert np.float32(msg["threshold"]) == np.float32(want["threshold"])
        assert torch.equal(decode(msg), decode(want))
    assert kinds == {"threshold", "bitmap"}
