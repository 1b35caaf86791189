"""Pipeline parallelism of the port against the JAX package's: ``gpipe``
at 2 and 4 stages (outputs, and the stages' gradients of ``sum(ys**2)``)
against the JAX ``gpipe`` under ``shard_map`` and the sequential stack,
the refusal of too few microbatches, and the 3D demo step (data 2 x pipe
2 x seq 2: GPipe over ring-attention blocks) on the inputs of the JAX
package's ``test_3d_transformer_training_step``: the loss and every
stage's new params.

Everything runs in float64: 1e-10.  One spawn of 8 gloo ranks serves
every job.
"""
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

from deeplearning4j_tpu.parallel.demo import (build_demo_inputs,
                                              make_pipelined_train_step)
from deeplearning4j_tpu.parallel.pipeline import gpipe as jgpipe
from deeplearning4j_tpu.parallel.pipeline import stack_stage_params
from deeplearning4j_tpu_torch.parallel import demo as tdemo
from deeplearning4j_tpu_torch.parallel.mesh import Axis
from deeplearning4j_tpu_torch.parallel.pipeline import gpipe as tgpipe
from deeplearning4j_tpu_torch.parallel.pipeline import \
    stack_stage_params as t_stack

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
import torch_model_axes as axes  # noqa: E402

TOL = 1e-10
WORLD = 8
GPIPE_CASES = [(2, 2), (2, 5), (4, 4), (4, 6)]     # (stages, microbatches)
DEMO = dict(n_stages=2, embed=8, n_heads=2, seq_len=8, microbatch=4,
            n_micro=2, seed=7)


def _stage_fn(params, x):
    return jnp.tanh(x @ params["W"] + params["b"])


def _stages(n, d, seed):
    rng = np.random.default_rng(seed)
    return [{"W": rng.standard_normal((d, d)) * 0.3,
             "b": rng.standard_normal(d) * 0.1} for _ in range(n)]


def _gpipe_inputs(n, n_micro):
    stacked = {k: np.stack([s[k] for s in _stages(n, 5, n)])
               for k in ("W", "b")}
    xs = np.random.default_rng(n_micro).standard_normal((n_micro, 3, 5))
    return stacked, xs


@pytest.fixture(scope="module")
def runs():
    payload = []
    for n, m in GPIPE_CASES:
        stacked, xs = _gpipe_inputs(n, m)
        payload.append({"fn": "gpipe", "name": f"gpipe/{n}/{m}", "n": n,
                        "stacked": stacked, "xs": xs})
    payload.append({"fn": "demo3d", "name": "demo3d", "shape": (2, 2, 2),
                    "heads": 2, "demo": DEMO})
    payload.append({"fn": "gpipe_other_thread", "name": "other_thread",
                    "heads": 2, "demo": DEMO})
    return axes.run(WORLD, payload)


@pytest.mark.parametrize("n,n_micro", GPIPE_CASES)
def test_gpipe_outputs_and_grads_match_jax(runs, n, n_micro):
    stacked, xs = _gpipe_inputs(n, n_micro)
    mesh = JMesh(np.array(jax.devices()[:n]), ("pipe",))
    jstacked = {k: jnp.asarray(v) for k, v in stacked.items()}

    def pipe_loss(st, x):
        ys = jgpipe(_stage_fn, st, x, axis_name="pipe")
        return jnp.sum(ys ** 2), ys

    fn = jax.jit(shard_map(jax.grad(pipe_loss, has_aux=True), mesh=mesh,
                           in_specs=(JP("pipe"), JP()),
                           out_specs=(JP("pipe"), JP())))
    jg, jys = fn(jstacked, jnp.asarray(xs))

    def seq_loss(st):
        ys = jnp.asarray(xs)
        for i in range(n):
            ys = _stage_fn(jax.tree.map(lambda p: p[i], st), ys)
        return jnp.sum(ys ** 2)

    sg = jax.grad(seq_loss)(jstacked)
    got = sorted((r[f"gpipe/{n}/{n_micro}"]["index"],
                  r[f"gpipe/{n}/{n_micro}"]) for r in runs
                 if f"gpipe/{n}/{n_micro}" in r)
    assert [i for i, _ in got] == list(range(n))
    for _, r in got:      # the outputs are valid on every stage
        np.testing.assert_allclose(r["ys"], np.asarray(jys), atol=TOL,
                                   rtol=0)
    for k in ("W", "b"):
        mine = np.concatenate([r[k] for _, r in got])
        np.testing.assert_allclose(mine, np.asarray(jg[k]), atol=TOL,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(mine, np.asarray(sg[k]), atol=TOL,
                                   rtol=0, err_msg=k)


def test_gpipe_refuses_too_few_microbatches():
    stacked = t_stack([{k: torch.as_tensor(v) for k, v in s.items()}
                       for s in _stages(4, 4, 0)])
    local = {k: v[:1] for k, v in stacked.items()}
    with pytest.raises(ValueError, match=r"needs >= 4 microbatches"):
        tgpipe(lambda p, x: x, local, torch.zeros(2, 2, 4),
               axis_name=Axis("pipe", 4, 0))


def test_demo_inputs_are_the_jax_packages():
    j = build_demo_inputs(dtype=jnp.float64, **DEMO)
    t = tdemo.build_demo_inputs(dtype=torch.float64, **DEMO)
    for k in j[0]:
        np.testing.assert_array_equal(t[0][k].numpy(), np.asarray(j[0][k]))
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert set(stack_stage_params([{"a": 1.0}])) == {"a"}


def test_3d_demo_step_matches_jax(runs):
    stacked, xs, ys = build_demo_inputs(dtype=jnp.float64, **DEMO)
    mesh = JMesh(np.array(jax.devices()).reshape(2, 2, 2),
                 ("data", "pipe", "seq"))
    fn = jax.jit(shard_map(
        make_pipelined_train_step(n_heads=2), mesh=mesh,
        in_specs=(JP("pipe"), JP(None, "data", "seq"),
                  JP(None, "data", "seq")),
        out_specs=(JP(), JP("pipe"))))
    jloss, jnew = fn(stacked, xs, ys)
    got = [r["demo3d"] for r in runs]
    assert sorted(r["coords"] for r in got) == \
        [(d, p, s) for d in range(2) for p in range(2) for s in range(2)]
    for r in got:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=TOL)
        p = r["coords"][1]
        for k, v in r["new"].items():
            np.testing.assert_allclose(v, np.asarray(jnew[k])[p:p + 1],
                                       atol=TOL, rtol=0, err_msg=k)
    # the step moved the params
    assert not np.allclose(np.asarray(jnew["Wq"]), np.asarray(stacked["Wq"]))


def test_gpipe_backward_on_another_thread(runs):
    """On CUDA autograd runs the backward on its own device thread, where
    the caller's axis environment is not entered; ``gpipe``'s backward
    replays the stages (ring attention over ``seq`` here) in the grid the
    forward ran in, so a backward on another thread gives the same
    gradients."""
    got = [r["other_thread"] for r in runs if "other_thread" in r]
    assert len(got) == 4
    for r in got:
        for a, b in zip(r["same"], r["other"]):
            np.testing.assert_array_equal(a, b)
