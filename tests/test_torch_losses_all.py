"""Every loss name of the JAX package (21, aliases included) in the port:
values and gradients with respect to the pre-output, on a feed-forward
batch with a per-example mask and unit weights, and on a time series
with a ``[batch, time]`` mask."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu_torch.nn import losses as tlosses

# float32 reductions over at most 60 terms, the same formulas in the same
# order; exp/log/log1p may differ by an ulp between XLA and torch
RTOL, ATOL = 1e-5, 1e-7

NAMES = jlosses.names()


def _data(name, shape, rng):
    """(labels, preout) in each loss's domain."""
    pre = rng.standard_normal(shape).astype(np.float32)
    n = shape[-1]
    if name == "sparse_mcxent":
        return rng.integers(0, n, shape[:-1]).astype(np.int32), pre
    if name in ("mcxent", "negativeloglikelihood"):
        return np.eye(n, dtype=np.float32)[rng.integers(0, n, shape[:-1])], \
            pre
    if name in ("kld", "kl_divergence"):
        lab = rng.random(shape).astype(np.float32) + 0.05
        return (lab / lab.sum(-1, keepdims=True)).astype(np.float32), pre
    if name in ("xent", "fmeasure", "hinge", "squared_hinge"):
        return (rng.random(shape) > 0.5).astype(np.float32), pre
    if name in ("mape", "mean_absolute_percentage_error"):
        return (rng.random(shape) + 0.5).astype(np.float32), pre
    if name == "poisson":
        return rng.poisson(2.0, shape).astype(np.float32), \
            np.abs(pre) + 0.1
    return rng.standard_normal(shape).astype(np.float32), pre


@pytest.mark.parametrize("case", ["ff", "ts"])
@pytest.mark.parametrize("name", NAMES)
def test_every_loss_and_gradient_matches_reference(name, case):
    rng = np.random.default_rng(NAMES.index(name) * 2 + (case == "ts"))
    if case == "ff":
        shape, mask = (6, 5), np.array([1, 1, 0, 1, 1, 0], np.float32)
        uw = rng.random(5).astype(np.float32) + 0.5
    else:
        shape, uw = (4, 3, 5), None
        mask = np.ones((4, 3), np.float32)
        mask[0, 2] = mask[2, 1:] = 0
    lab, pre = _data(name, shape, rng)
    jfn, tfn = jlosses.get(name), tlosses.get(name)

    def jloss(p):
        return jfn(jnp.asarray(lab), p, mask=jnp.asarray(mask),
                   unit_weights=None if uw is None else jnp.asarray(uw))

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(pre))
    tp = torch.tensor(pre, requires_grad=True)
    got = tfn(torch.tensor(lab), tp, mask=torch.tensor(mask),
              unit_weights=None if uw is None else torch.tensor(uw))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["mse", "xent", "kld", "cosine_proximity"])
def test_low_precision_preout_reduces_in_float32(name):
    rng = np.random.default_rng(5)
    lab, pre = _data(name, (4, 6), rng)
    got = tlosses.get(name)(torch.tensor(lab),
                            torch.tensor(pre).to(torch.bfloat16))
    want = jlosses.get(name)(jnp.asarray(lab),
                             jnp.asarray(pre).astype(jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
