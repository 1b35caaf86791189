"""Zoo models (port of ``models/zoo.py``): ``TransformerLM`` so far."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..nn.conf.input_type import InputType
from ..nn.conf.multi_layer import MultiLayerConfiguration
from ..nn.conf.updaters import Adam, UpdaterConf
from ..nn.layers.attention import PositionalEncodingLayer, TransformerBlock
from ..nn.layers.feedforward import EmbeddingSequenceLayer
from ..nn.layers.recurrent import RnnOutputLayer
from ..nn.multilayer import MultiLayerNetwork


@dataclass
class TransformerLM:
    """Decoder-only transformer LM: embedding, positional encoding,
    ``n_layers`` pre-norm causal blocks, softmax head over the
    vocabulary.  Same fields and configuration as the JAX zoo model."""
    vocab_size: int = 256
    seq_len: int = 128
    embed: int = 256
    n_layers: int = 4
    n_heads: int = 8
    attn_impl: str = "auto"
    flash_min_seq: Optional[int] = None
    moe_experts: int = 0
    sparse_labels: bool = False
    seed: int = 123
    updater: Optional[UpdaterConf] = None
    compute_dtype: Optional[str] = None

    def conf(self) -> MultiLayerConfiguration:
        if self.compute_dtype:
            raise NotImplementedError("compute_dtype (precision policies) "
                                      "is not ported yet")
        layers = [EmbeddingSequenceLayer(n_out=self.embed),
                  PositionalEncodingLayer()]
        layers += [TransformerBlock(n_heads=self.n_heads, causal=True,
                                    attn_impl=self.attn_impl,
                                    flash_min_seq=self.flash_min_seq,
                                    moe_experts=self.moe_experts)
                   for _ in range(self.n_layers)]
        loss = "sparse_mcxent" if self.sparse_labels else "mcxent"
        layers.append(RnnOutputLayer(n_out=self.vocab_size,
                                     activation="softmax", loss=loss))
        for i, lc in enumerate(layers):
            lc.name = f"layer{i}"
        return MultiLayerConfiguration(
            layers=layers,
            input_type=InputType.recurrent(self.vocab_size, self.seq_len),
            defaults={"updater": self.updater or Adam(learning_rate=3e-4),
                      "weight_init": "xavier"},
            seed=self.seed)

    def init(self, device="cuda") -> MultiLayerNetwork:
        """The network on ``device`` with fresh seeded parameters."""
        return MultiLayerNetwork(self.conf(), device=device).init()
