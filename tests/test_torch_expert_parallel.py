"""Expert parallelism of the port against the JAX package's:
``make_moe_train_step`` on a (data 2, expert 2) grid of gloo ranks
against the JAX step under ``shard_map`` on the conftest's virtual CPU
devices (loss and every rank's new params, with and without dropped
tokens), and the expert-parallel ``moe_ffn`` forward at (1, 4) and
(2, 2) against the JAX one and, with capacity for every token, against
the single-device computation.  The tiled all-to-all's chunk order
(``[E, C, D]`` -> ``[E/ep, ep*C, D]``, rank j's chunk at place j) is what
makes these agree.

Everything runs in float64: 1e-10.  One spawn of 4 ranks serves every
job.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh, PartitionSpec as JP
try:
    from jax import shard_map
except ImportError:  # jax < 0.5 keeps it in experimental
    from jax.experimental.shard_map import shard_map

from deeplearning4j_tpu.parallel.expert import (init_moe_params,
                                                make_moe_train_step, moe_ffn)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_model_axes as axes  # noqa: E402

TOL = 1e-10
WORLD = 4
EMBED, HIDDEN, EXPERTS = 8, 16, 4
STEP_CASES = [("drops", 2), ("no_drops", 8)]     # (name, capacity)
FWD_CASES = [(1, 4), (2, 2)]


def _params():
    p = init_moe_params(jax.random.PRNGKey(1), EXPERTS, EMBED, HIDDEN)
    return {k: np.asarray(v, np.float64) for k, v in p.items()}


def _data(tokens=32, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tokens, EMBED))
    w = rng.standard_normal((EMBED, EMBED)) * 0.5
    return x, np.tanh(x @ w)


def _mesh(dp, ep):
    return JMesh(np.array(jax.devices()[:dp * ep]).reshape(dp, ep),
                 ("data", "expert"))


PSPEC = {"router": JP(None, None), "w1": JP("expert"), "w2": JP("expert")}
BATCH = JP(("data", "expert"), None)


@pytest.fixture(scope="module")
def runs():
    params = _params()
    x, y = _data()
    payload = [{"fn": "moe", "name": f"step/{name}", "shape": (2, 2),
                "params": params, "x": x, "y": y, "capacity": cap,
                "lr": 0.05} for name, cap in STEP_CASES]
    payload += [{"fn": "moe", "name": f"fwd/{dp}x{ep}", "shape": (dp, ep),
                 "params": params, "x": x, "capacity": 32 // (dp * ep),
                 "forward": True} for dp, ep in FWD_CASES]
    return axes.run(WORLD, payload)


@pytest.mark.parametrize("name,capacity", STEP_CASES)
def test_moe_train_step_dp2_ep2_matches_jax(runs, name, capacity):
    params, (x, y) = _params(), _data()
    fn = jax.jit(shard_map(make_moe_train_step(capacity=capacity, lr=0.05),
                           mesh=_mesh(2, 2), in_specs=(PSPEC, BATCH, BATCH),
                           out_specs=(PSPEC, JP())))
    jnew, jloss = fn({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x), jnp.asarray(y))
    got = [r[f"step/{name}"] for r in runs]
    assert sorted(r["coords"] for r in got) == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    per = EXPERTS // 2
    for r in got:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=TOL)
        e = r["coords"][1]
        np.testing.assert_allclose(r["new"]["router"],
                                   np.asarray(jnew["router"]), atol=TOL,
                                   rtol=0)
        for k in ("w1", "w2"):
            np.testing.assert_allclose(
                r["new"][k], np.asarray(jnew[k])[e * per:(e + 1) * per],
                atol=TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("dp,ep", FWD_CASES)
def test_expert_parallel_forward_matches_jax_and_one_device(runs, dp, ep):
    params, (x, _) = _params(), _data()
    cap = 32 // (dp * ep)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    fn = jax.jit(shard_map(
        lambda p, xx: moe_ffn(p, xx, cap, expert_axis="expert")[0],
        mesh=_mesh(dp, ep), in_specs=(PSPEC, BATCH), out_specs=BATCH))
    want = np.asarray(fn(jparams, jnp.asarray(x)))
    blocks = sorted((r[f"fwd/{dp}x{ep}"]["block"], r[f"fwd/{dp}x{ep}"]["y"])
                    for r in runs if f"fwd/{dp}x{ep}" in r)
    assert [b for b, _ in blocks] == list(range(dp * ep))
    got = np.concatenate([y for _, y in blocks])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # every token has room: the same as one device with all experts
    one, _ = moe_ffn(jparams, jnp.asarray(x), 32)
    np.testing.assert_allclose(got, np.asarray(one), atol=TOL, rtol=0)
