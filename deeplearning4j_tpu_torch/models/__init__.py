"""Model zoo of the PyTorch port (reference ``deeplearning4j-zoo``; port
of the JAX package's ``models/``) and ``generate_tokens``.

``available_bench_model`` and ``flagship_entry_model`` are not ported
yet: they belong to the benchmark harness (``utils/benchmarks.py``),
which comes with the port's first benchmark.
"""
import numpy as np

from .zoo import (ALL_MODELS, AlexNet, FaceNetNN4Small2, GoogLeNet,
                  InceptionResNetV1, LeNet, ResNet50, SimpleCNN,
                  ModelSelector, TextGenerationLSTM, TransformerLM, VGG16,
                  VGG19, ZooModel)

__all__ = [
    "ALL_MODELS", "AlexNet", "FaceNetNN4Small2", "GoogLeNet",
    "InceptionResNetV1", "LeNet", "ResNet50", "SimpleCNN",
    "ModelSelector", "TextGenerationLSTM", "TransformerLM", "VGG16",
    "VGG19", "ZooModel", "generate_tokens",
]


def _takes_ids(net) -> bool:
    """True where the first layer reads token ids (an embedding), False
    where it reads feature vectors (the char-LSTM's one-hot rows)."""
    from ..nn.layers.feedforward import EmbeddingLayer, EmbeddingSequenceLayer
    first = net.layer_confs[0] if net.layer_confs else None
    return isinstance(first, (EmbeddingLayer, EmbeddingSequenceLayer))


def generate_tokens(net, prompt_ids, n_tokens: int, temperature: float = 1.0,
                    seed: int = 0):
    """Autoregressive sampling through the KV-cached ``rnn_time_step``
    stream (works for TransformerLM and recurrent LMs alike).
    prompt_ids: [batch, t0] ints.  Returns [batch, t0 + n_tokens].

    The JAX package's function, step for step: numpy's
    ``default_rng(seed)``, greedy at ``temperature <= 0``, otherwise
    ``rng.choice`` over the tempered probabilities; each step's
    last-position probabilities come to the host in one copy.  One
    deliberate difference: a network whose first layer reads feature
    vectors (the zoo ``TextGenerationLSTM``) gets each id as a one-hot
    row of its input width, where the JAX function hands it the ids
    themselves and fails on their width."""
    rng = np.random.default_rng(seed)
    prompt_ids = np.asarray(prompt_ids)
    caches = [c for c in (getattr(l, "max_cache_len", None)
                          for l in net.layer_confs) if c]
    total = prompt_ids.shape[1] + n_tokens
    if caches and total > min(caches):
        raise ValueError(
            f"prompt + n_tokens = {total} exceeds the smallest KV cache "
            f"({min(caches)}); raise max_cache_len on the attention layers")
    if _takes_ids(net):
        def feed(ids):
            return ids
    else:
        eye = np.eye(net.layer_confs[0].n_in, dtype=np.float32)

        def feed(ids):
            return eye[ids]

    def last_probs(ids):
        return net.rnn_time_step(feed(ids))[:, -1].cpu().numpy()

    net.rnn_clear_previous_state()
    probs = last_probs(prompt_ids)                               # [b, v]
    out = [prompt_ids]
    for _ in range(n_tokens):
        if temperature <= 0:
            nxt = probs.argmax(-1)
        else:
            logits = np.log(np.maximum(probs, 1e-9)) / temperature
            p = np.exp(logits - logits.max(-1, keepdims=True))
            p /= p.sum(-1, keepdims=True)
            nxt = np.array([rng.choice(p.shape[-1], p=row) for row in p])
        nxt = nxt.astype(prompt_ids.dtype)[:, None]
        out.append(nxt)
        probs = last_probs(nxt)
    return np.concatenate(out, axis=1)
