"""The port's paged KV cache (``generation/cache.PagedKV``) driven by the
same call sequence as the JAX package's: block tables, positions, the
occupancy trail's event kinds and the stats must be equal after every
step.  Plus the allocator rules (lowest free block, trash block refused
as a write target, pool exhaustion reported) and the int8 KV pool's
layout."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.generation.cache import PagedKV as JaxPagedKV
from deeplearning4j_tpu.models import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.precision import PrecisionPolicy as JPrecisionPolicy
from deeplearning4j_tpu_torch.generation.cache import PagedKV
from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy

SMALL = dict(vocab_size=17, seq_len=32, embed=16, n_layers=2, n_heads=2)


@pytest.fixture(scope="module")
def confs():
    return (JTransformerLM(**SMALL).init().conf,
            TransformerLM(**SMALL).init(device="cpu").conf)


def _state(kv):
    return (kv.tables.tolist(), kv.pos.tolist(),
            [t["event"] for t in kv.trail()], kv.stats(),
            kv.free_slots, kv.blocks_free)


def _drive(kv):
    """One scripted life of the cache: admissions with prefix sharing,
    a copy-on-write partial tail, growth across block boundaries,
    vacates that register tails, pool pressure and LRU eviction, and a
    weight-version invalidation.  Returns the state after each step."""
    seen = []
    header = [3, 1, 4, 1, 5, 9, 2, 6]                 # two 4-token blocks
    a = kv.acquire("a")
    assert kv.match_prefix(header + [7]) == ([], None)
    kv.ensure_blocks(a, "a", 9)
    kv.pos[a] = 9
    kv.register_prefix(a, header + [7])
    seen.append(_state(kv))
    b = kv.acquire("b")
    full, partial = kv.match_prefix(header + [8, 2])
    kv.adopt(b, "b", full)
    kv.note_shared_hit(b, "b", len(full) * kv.block_size)
    kv.ensure_blocks(b, "b", 10)
    kv.pos[b] = 10
    kv.register_prefix(b, header + [8, 2])
    kv.check_writable(b)
    seen.append(_state(kv) + (full, partial))
    kv.ensure_blocks(a, "a", 13)                       # crosses a boundary
    kv.pos[a] = 13
    kv.release(a)                                      # registers its tail
    seen.append(_state(kv))
    c = kv.acquire("c")
    full, partial = kv.match_prefix(header + [7, 4, 4])
    kv.adopt(c, "c", full)
    assert partial is not None              # a's tail [7], registered
    dst = kv.cow_begin(c, "c", partial[0])
    kv.ensure_blocks(c, "c", 11)
    kv.cow_end(partial[0])
    seen.append(_state(kv) + (full, partial, dst))
    kv.pos[c] = 11
    kv.register_prefix(c, header + [7, 4, 4])
    for s_ in (b, c):
        kv.release(s_)
    seen.append(_state(kv))
    # pressure: fill every slot to capacity, evicting registered blocks
    slots = [kv.acquire(f"p{i}") for i in range(kv.max_slots)]
    for i, s_ in enumerate(slots):
        seen.append((kv.ensure_blocks(s_, f"p{i}", kv.max_seq),)
                    + _state(kv))
    for s_ in slots:
        kv.release(s_)
    kv.invalidate_shared()
    seen.append(_state(kv))
    return seen


@pytest.mark.parametrize("block_size,n_blocks", [(4, None), (4, 12),
                                                 (8, None)])
def test_call_sequence_matches_jax(confs, block_size, n_blocks):
    jconf, tconf = confs
    kw = dict(max_slots=3, max_seq=24, block_size=block_size,
              n_blocks=n_blocks)
    want = _drive(JaxPagedKV(jconf, **kw))
    got = _drive(PagedKV(tconf, device="cpu", **kw))
    assert got == want
    assert want[-1][3]["cow_copies"] == 1 and want[-1][3]["prefix_hits"] == 1
    if n_blocks is not None:
        assert want[-1][3]["evictions"] > 0
    kv = PagedKV(tconf, device="cpu", **kw)
    ref = JaxPagedKV(jconf, **kw)
    assert kv.cache_bytes == ref.cache_bytes
    assert kv.occupancy_snapshot()["paged"] is True


def test_pools_are_f32_on_the_model_device(confs):
    kv = PagedKV(confs[1], max_slots=2, max_seq=32, block_size=8,
                 device="cpu")
    assert kv.layout == {"layer_1": "pos", "layer_2": "attn",
                         "layer_3": "attn"}
    for name in ("layer_2", "layer_3"):
        pools = kv.caches[name]
        assert set(pools) == {"kp", "vp"}
        assert pools["kp"].shape == (kv.n_blocks, 2, 8, 8)
        assert pools["kp"].dtype == torch.float32
        assert pools["kp"].device.type == "cpu"


def test_lowest_free_alloc_release_and_trail(confs):
    kv = PagedKV(confs[1], max_slots=2, max_seq=32, block_size=8,
                 prefix_sharing=False, device="cpu")
    assert kv.blocks_per_slot == 4
    total_free = kv.blocks_free
    assert total_free == kv.n_blocks - 1      # trash block reserved
    s = kv.acquire("req-a")
    assert all(b == PagedKV.TRASH for b in kv.tables[s])
    assert kv.ensure_blocks(s, "req-a", 1)
    assert kv.tables[s, 0] == 1               # lowest free first
    assert kv.ensure_blocks(s, "req-a", 9)    # spills into 2nd block
    assert kv.tables[s, 1] == 2
    kv.check_writable(s)
    assert kv.blocks_free == total_free - 2
    kv.release(s)
    assert kv.blocks_free == total_free
    events = [t["event"] for t in kv.trail()]
    assert "block_alloc" in events and "block_release" in events


def test_trash_write_target_is_refused(confs):
    kv = PagedKV(confs[1], max_slots=1, max_seq=32, block_size=8,
                 prefix_sharing=False, device="cpu")
    s = kv.acquire("req-a")
    with pytest.raises(RuntimeError, match="trash"):
        kv.check_writable(s)


def test_pool_exhaustion_is_reported_not_silent(confs):
    kv = PagedKV(confs[1], max_slots=2, max_seq=32, block_size=8,
                 n_blocks=5, prefix_sharing=False, device="cpu")
    s0, s1 = kv.acquire("a"), kv.acquire("b")
    assert kv.ensure_blocks(s0, "a", 16)
    assert kv.ensure_blocks(s1, "b", 16)
    assert not kv.ensure_blocks(s1, "b", 17)
    kv.release(s0)
    assert kv.ensure_blocks(s1, "b", 17)
    with pytest.raises(ValueError, match="trash block"):
        PagedKV(confs[1], max_slots=2, max_seq=32, block_size=8,
                n_blocks=4, device="cpu")


def test_recurrent_stack_keeps_dense_rows_and_no_sharing():
    conf = TextGenerationLSTM(num_classes=6, timesteps=8,
                              hidden=16).init(device="cpu").conf
    kv = PagedKV(conf, max_slots=3, max_seq=16, block_size=4, device="cpu")
    assert set(kv.layout.values()) == {"rnn"}
    assert kv.sharing is False
    for carry in kv.caches.values():
        assert carry["h"].shape == (3, 16) and carry["c"].shape == (3, 16)


@pytest.mark.parametrize("policy", [{"kv_dtype": "int8"}, {"kv_dtype":
                                                            "INT8"}])
def test_int8_kv_is_refused_naming_its_queue(confs, policy):
    """The int8 pool is ported (precision and memory slice): a policy
    asking for it, in either spelling, makes int8 K/V pools with f32
    scales per token and head, as the JAX package's PagedKV; an f32
    ``kv_dtype`` keeps the f32 pools."""
    jconf = JTransformerLM(**SMALL).init().conf
    jconf.defaults["precision"] = JPrecisionPolicy(**policy)
    conf = TransformerLM(**SMALL).init(device="cpu").conf
    conf.defaults["precision"] = PrecisionPolicy(**policy)
    kv = PagedKV(conf, max_slots=2, max_seq=32, device="cpu")
    jkv = JaxPagedKV(jconf, max_slots=2, max_seq=32)
    assert kv.kv_dtype == jkv.kv_dtype == "int8"
    assert kv.stats()["kv_dtype"] == jkv.stats()["kv_dtype"] == "int8"
    assert kv.cache_bytes == jkv.cache_bytes
    for name, pool in kv.caches.items():
        assert set(pool) == set(jkv.caches[name]) == {"kp", "vp", "ksc",
                                                      "vsc"}
        for k, t in pool.items():
            assert tuple(t.shape) == tuple(jkv.caches[name][k].shape)
            assert str(t.dtype).split(".")[-1] == \
                str(jkv.caches[name][k].dtype)
    conf.defaults["precision"] = PrecisionPolicy(kv_dtype="float32")
    kv = PagedKV(conf, max_slots=2, max_seq=32, device="cpu")
    assert kv.kv_dtype is None
    assert all(t.dtype == torch.float32 for c in kv.caches.values()
               for t in c.values())


