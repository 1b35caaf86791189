"""Sequence parallelism of the port against the JAX package's: the
online-softmax block helpers, ring and Ulysses attention at 2 and 4 gloo
ranks (causal and not; outputs and input gradients) against the JAX
functions under ``shard_map`` on the conftest's virtual CPU devices,
``MultiHeadAttention(attn_impl='ring'|'ulysses')`` on a time-sharded
input against the JAX layer on the whole sequence, and the refusals (a
key-padding mask, ``h % n``, an axis outside every mesh).

Everything runs in float64: 1e-10.  One spawn of 4 ranks serves every
job; a 2-rank job runs on ranks 0-1.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as JP
try:
    from jax import shard_map
except ImportError:  # jax < 0.5 keeps it in experimental
    from jax.experimental.shard_map import shard_map

from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.ops import attention as jops
from deeplearning4j_tpu.parallel.sequence import (ring_self_attention,
                                                  ulysses_attention)
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.ops import attention as tops
from deeplearning4j_tpu_torch.parallel.mesh import Axis
from deeplearning4j_tpu_torch.parallel.sequence import \
    ulysses_attention as t_ulysses

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_model_axes as axes  # noqa: E402

TOL = 1e-10
WORLD = 4
CASES = [(impl, n, causal) for impl in ("ring", "ulysses")
         for n in (2, 4) for causal in (False, True)]


def _qkv(seed, b=2, h=4, t=16, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)) for _ in range(4)]


def _jax_run(impl, n, causal, q, k, v, do):
    """The JAX function under shard_map over n devices: output and the
    input gradients of sum(o * do)."""
    fn = ring_self_attention if impl == "ring" else ulysses_attention
    mesh = JMesh(np.array(jax.devices()[:n]), ("seq",))
    spec = JP(None, None, "seq", None)
    sm = shard_map(functools.partial(fn, axis_name="seq", causal=causal),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)

    def loss(q_, k_, v_):
        o = sm(q_, k_, v_)
        return jnp.sum(o * do), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(o), [np.asarray(a) for a in g]


MHA_CONF = dict(n_in=16, n_out=16, n_heads=4, causal=True,
                activation="identity")


@pytest.fixture(scope="module")
def runs():
    payload = []
    for i, (impl, n, causal) in enumerate(CASES):
        q, k, v, do = _qkv(i)
        payload.append({"fn": "seq_attention", "name": f"{impl}/{n}/{causal}",
                        "impl": impl, "n": n, "causal": causal,
                        "q": q, "k": k, "v": v, "do": do})
    rng = np.random.default_rng(42)
    params = {n: rng.standard_normal(s) * 0.3 for n, s in
              (("Wq", (16, 16)), ("Wk", (16, 16)), ("Wv", (16, 16)),
               ("Wo", (16, 16)), ("bq", (16,)), ("bk", (16,)),
               ("bv", (16,)), ("bo", (16,)))}
    x = rng.standard_normal((2, 16, 16))
    for impl in ("ring", "ulysses"):
        payload.append({"fn": "seq_mha", "name": f"mha/{impl}", "n": 4,
                        "conf": {**MHA_CONF, "attn_impl": impl},
                        "params": params, "x": x})
    return payload, axes.run(WORLD, payload), params, x


def _joined(results, name, key, n, dim=2):
    shards = sorted((r[name]["index"], r[name][key]) for r in results
                    if name in r)
    assert [i for i, _ in shards] == list(range(n))
    return np.concatenate([s for _, s in shards], axis=dim)


@pytest.mark.parametrize("impl,n,causal", CASES)
def test_seq_parallel_attention_matches_jax_shard_map(runs, impl, n, causal):
    payload, results, _, _ = runs
    job = next(j for j in payload if j["name"] == f"{impl}/{n}/{causal}")
    want_o, want_g = _jax_run(impl, n, causal, job["q"], job["k"], job["v"],
                              job["do"])
    name = job["name"]
    np.testing.assert_allclose(_joined(results, name, "o", n), want_o,
                               atol=TOL, rtol=0)
    for key, want in zip(("dq", "dk", "dv"), want_g):
        np.testing.assert_allclose(_joined(results, name, key, n), want,
                                   atol=TOL, rtol=0, err_msg=key)
    # and the whole-sequence reference attention
    ref = jops.sdpa_reference(*(jnp.asarray(job[a]) for a in "qkv"),
                              causal=causal)
    np.testing.assert_allclose(want_o, np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_mha_layer_on_a_time_sharded_input(runs, impl):
    _, results, params, x = runs
    layer = jatt.MultiHeadAttention(**{**MHA_CONF,
                                       "attn_impl": "reference"})
    layer.apply_global_defaults({})
    want, _ = layer.apply({"params": {k: jnp.asarray(v)
                                      for k, v in params.items()},
                           "state": {}}, jnp.asarray(x))
    got = _joined(results, f"mha/{impl}", "y", 4, dim=1)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_block_helpers_match_jax(causal):
    q, k, v, _ = _qkv(9, t=12)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    # two key blocks; block 2 seen from a query block that precedes it
    # (causal: every score masked) exercises the fully-masked row guard
    parts_t = [tops.attn_block(tq[:, :, :4], tk[:, :, s:s + 6],
                               tv[:, :, s:s + 6], causal=causal, q_offset=0,
                               k_offset=s) for s in (0, 6)]
    parts_j = [jops.attn_block(jq[:, :, :4], jk[:, :, s:s + 6],
                               jv[:, :, s:s + 6], causal=causal, q_offset=0,
                               k_offset=s) for s in (0, 6)]
    for pt, pj in zip(parts_t, parts_j):
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                       rtol=0)
    acc = tops.init_blocks(2, 4, 4, 8, torch.float64)
    jacc = jops.init_blocks(2, 4, 4, 8, jnp.float64)
    for pt, pj in zip(parts_t, parts_j):
        acc = tops.combine_blocks(*acc, *pt)
        jacc = jops.combine_blocks(*jacc, *pj)
    out = tops.finalize_blocks(*acc, torch.float64)
    jout = jops.finalize_blocks(*jacc, jnp.float64)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=0)
    assert bool(torch.isfinite(out).all())
    # a row that saw no key at all is zeros, not NaN
    empty = tops.finalize_blocks(*tops.init_blocks(1, 1, 2, 3), torch.float32)
    assert torch.equal(empty, torch.zeros(1, 1, 2, 3))


def test_refusals_mask_heads_and_unbound_axis():
    q = torch.zeros(1, 4, 8, 4)
    for impl in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="key-padding masks"):
            tatt._run_attention(q, q, q, impl=impl, causal=True,
                                mask=torch.ones(1, 8))
        # outside every mesh the seq axis is unbound, as in JAX
        with pytest.raises(NameError, match="unbound axis name: 'seq'"):
            tatt._run_attention(q, q, q, impl=impl, causal=True)
    with pytest.raises(ValueError, match=r"n_heads \(4\) divisible by the "
                                         r"'seq' axis size \(3\)"):
        t_ulysses(q, q, q, axis_name=Axis("seq", 3, 0))
    # the JAX package refuses both alike
    with pytest.raises(ValueError, match="key-padding"):
        jatt._run_attention(jnp.zeros((1, 4, 8, 4)), jnp.zeros((1, 4, 8, 4)),
                            jnp.zeros((1, 4, 8, 4)), impl="ring",
                            causal=True, mask=jnp.ones((1, 8)),
                            seq_axis="seq")
