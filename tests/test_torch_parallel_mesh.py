"""The port's mesh and ZeRO-3 layout rule against the JAX package's:
``zero3_spec`` and the layout plan leaf for leaf over a grid of shapes x
dp in {1, 2, 3, 4, 8} x ``min_size``, ``per_device_param_bytes`` against
the JAX ``ShardedTrainer``'s for the same network at dp 2, 4 and 8, and
the oversubscription error, for ``model``/``seq`` axes too."""
import itertools

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import TransformerLM as JTransformerLM
from deeplearning4j_tpu.parallel import ShardedTrainer as JShardedTrainer
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import shard_params as jshard_params
from deeplearning4j_tpu.parallel import zero3_spec as jzero3_spec
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import (per_device_param_bytes,
                                               param_bytes, shard_params,
                                               zero3_spec)

SHAPES = [(), (1,), (7,), (8,), (1024,), (1023,), (3, 5), (16, 64),
          (64, 16), (6, 1024), (1024, 6), (9, 4096), (4096, 9), (2, 3, 4),
          (5, 8, 32), (24, 1), (8192, 512), (512, 3)]
DPS = [1, 2, 3, 4, 8]
MIN_SIZES = [0, 64, 1024]


def _dim(spec):
    """The sharded dim of a JAX PartitionSpec (None: replicated)."""
    dims = [i for i, a in enumerate(spec) if a is not None]
    assert len(dims) <= 1
    return dims[0] if dims else None


@pytest.mark.parametrize("dp,min_size", list(itertools.product(DPS,
                                                               MIN_SIZES)))
def test_zero3_spec_equals_jax(dp, min_size):
    for shape in SHAPES:
        assert zero3_spec(shape, dp, min_size) == \
            _dim(jzero3_spec(shape, dp, min_size)), shape


@pytest.fixture(scope="module")
def lm_pair():
    kw = dict(vocab_size=96, seq_len=16, embed=48, n_layers=2, n_heads=2)
    return JTransformerLM(**kw).init(), TransformerLM(**kw).init(device="cpu")


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("min_size", MIN_SIZES)
def test_layout_plan_equals_jax_leaf_for_leaf(lm_pair, dp, min_size):
    jn, tn = lm_pair
    plan = shard_params(dp, tn.params, min_size=min_size)
    jplan = jshard_params(jmake_mesh(dp=dp), jn.params, min_size=min_size)
    for k, g in jplan.items():
        for n, sh in g.items():
            assert plan[k][n] == _dim(sh.spec), f"{k}/{n} at dp {dp}"


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_per_device_param_bytes_equals_jax_sharded_trainer(lm_pair, dp):
    jn, tn = lm_pair
    jt = JShardedTrainer(jn, jmake_mesh(dp=dp))
    assert per_device_param_bytes(tn.param_spec(), dp) == \
        jt.per_device_param_bytes()
    assert param_bytes(tn.params) == jt.global_param_bytes() == \
        param_bytes(tn.param_spec())


def test_oversubscription_is_a_clear_error():
    # one process and no process group: a world of one rank
    with pytest.raises(ValueError, match="oversubscribes the 1 available"):
        tmesh.make_mesh(dp=2)
    m = tmesh.make_mesh(device="cpu")
    assert (m.dp, m.rank, m.shape) == (1, 0, {"data": 1, "model": 1,
                                              "seq": 1})


@pytest.mark.parametrize("axis", ["tp", "sp"])
def test_model_and_seq_axes_are_refused_naming_item_8(axis):
    """``model`` and ``seq`` axes are ported: a mesh with one needs the
    ranks for it (one process here), as the JAX ``make_mesh`` needs the
    devices; the multi-rank meshes run in the model-axis tests."""
    with pytest.raises(ValueError, match="oversubscribes the 1 available"):
        tmesh.make_mesh(dp=1, **{axis: 2})
    with pytest.raises(ValueError, match="oversubscribes the 1 available"):
        jmake_mesh(dp=1, devices=jax.devices()[:1], **{axis: 2})
    one = tmesh.make_mesh(device="cpu", **{axis: 1})
    assert one.shape == {"data": 1, "model": 1, "seq": 1}


def test_shard_batch_and_place_sharded_take_this_ranks_block():
    m = tmesh.Mesh(4, 2, device="cpu")
    x = torch.arange(24).reshape(8, 3)
    assert torch.equal(tmesh.shard_batch(m, x), x[4:6])
    w = np.arange(32, dtype=np.float32).reshape(4, 8)
    assert torch.equal(tmesh.place_sharded(w, m, 1),
                       torch.as_tensor(w)[:, 4:6])
    assert torch.equal(tmesh.place_sharded(w, m, None), torch.as_tensor(w))
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch(m, x[:6])
