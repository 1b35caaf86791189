"""The tolerances of ``chip_smoke.py``'s precision gates, derived on the
CPU from the JAX package's own gap between a bf16 policy and f32 at a
small size: each test measures that gap and pins the gate's constant to
the derivation written beside it in ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.models.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn import precision as jprec
from deeplearning4j_tpu.nn._common import _cast_floats as j_cast_floats
from deeplearning4j_tpu.nn.multilayer import _stack_loss as j_stack_loss


def test_chip_bf16_loss_gate_is_derived_from_the_jax_gap():
    """``chip_smoke.py``'s ``precision_lm`` gate (the bf16 LM's step-0
    loss against its f32 twin, ``TOL_BF16_LM_LOSS``) comes from the JAX
    package's own bf16-vs-f32 gap: at embed 64, 2 layers, seq 64, batch
    8 the gap stays under ``BF16_GAP_SMALL`` over four seeds (measured
    1.9e-4), and the gate scales it by sqrt(depth x width) to the full
    model (8/2 layers x 512/64 wide: x5.7) with a margin of 2.5."""
    import chip_smoke
    gaps = []
    for seed in range(4):
        net = JTransformerLM(vocab_size=256, seq_len=64, embed=64,
                             n_layers=2, n_heads=2, sparse_labels=True,
                             seed=seed).init()
        pol = jprec.resolve({"precision": "bfloat16"})
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, 256, (8, 65))
        x, y = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
        l32, _ = j_stack_loss(net.conf, net.params, net.state, x, y,
                              train=True, key=None)
        pb = {k: j_cast_floats(v, "bfloat16") for k, v in net.params.items()}
        lbf, _ = j_stack_loss(net.conf, pb, net.state, x, y, train=True,
                              key=None, precision=pol)
        gaps.append(abs(float(lbf) - float(l32)) / float(l32))
    assert max(gaps) < chip_smoke.BF16_GAP_SMALL
    assert chip_smoke.TOL_BF16_LM_LOSS == pytest.approx(
        chip_smoke.BF16_GAP_SMALL * (8 / 2 * 512 / 64) ** 0.5 * 2.5)


def test_chip_bf16_resnet_gate_is_derived_from_the_jax_gap():
    """``chip_smoke.py``'s ``resnet_bf16`` gate (the bf16 ResNet50's
    step-0 loss against its f32 twin, ``TOL_BF16_RESNET_LOSS``) comes from
    the JAX package's own bf16-vs-f32 gap at init: at 64x64, batch 8, it
    stays under ``RN_GAP_SMALL`` (measured 4.6e-2), and the gate is twice
    that."""
    import chip_smoke
    from deeplearning4j_tpu.models.zoo import ResNet50 as JResNet50
    from deeplearning4j_tpu.nn import precision as jprec
    from deeplearning4j_tpu.nn._common import _cast_floats
    from deeplearning4j_tpu.nn.computation_graph import _graph_loss
    net = JResNet50(seed=0, input_shape=(64, 64, 3),
                    num_classes=1000).init()
    pol = jprec.resolve({"compute_dtype": "bfloat16"})
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((8, 64, 64, 3)).astype(np.float32))
    y = jnp.asarray(np.eye(1000, dtype=np.float32)[rng.integers(0, 1000,
                                                                 8)])
    l32, _ = _graph_loss(net.conf, net.params, net.state, [x], [y],
                         train=True, key=None)
    low = {k: (_cast_floats(v, "bfloat16") if pol.layer_dtype(
        getattr(net.conf.vertices[k], "layer", None)
        or net.conf.vertices[k]) == "bfloat16" else v)
        for k, v in net.params.items()}
    lb, _ = _graph_loss(net.conf, low, net.state,
                        [x.astype(jnp.bfloat16)], [y], train=True,
                        key=None, precision=pol)
    gap = abs(float(lb) - float(l32)) / float(l32)
    assert 0 < gap < chip_smoke.RN_GAP_SMALL
    assert chip_smoke.TOL_BF16_RESNET_LOSS == 2 * chip_smoke.RN_GAP_SMALL
