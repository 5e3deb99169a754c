"""Paged KV pool + prefix cache of the PyTorch port
(ray_tpu_torch/llm/kv_cache.py) against the JAX package's, on the CPU.

The allocator, prefix-hash chain, refcounts, LRU park/evict, COW and
event ring are copies of the JAX pool's: one scripted op sequence is
replayed through both pools and every observable state must be equal
after every op. The device side (in-place block writes and the COW
copy) must hold the same K/V as the JAX pool's functional scatters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.kv_cache import PagedKVCache as JPaged
from ray_tpu.llm.kv_cache import PrefixPool as JPrefix
from ray_tpu.models.gpt import GPTConfig as JCfg
from ray_tpu_torch.llm.kv_cache import PagedKVCache as TPaged
from ray_tpu_torch.llm.kv_cache import PrefixPool as TPrefix
from ray_tpu_torch.models.gpt import GPTConfig as TCfg

torch.set_num_threads(1)

KW = dict(vocab_size=64, max_seq=64, d_model=32, n_layer=2, n_head=2)
JCFG = JCfg(dtype=jnp.float32, **KW)
TCFG = TCfg(dtype=torch.float32, **KW)
BS = 4

A = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]          # 2 full blocks + tail of 2
B = [1, 2, 3, 4, 5, 6, 7, 8, 40, 41, 42]      # shares A's first 2 blocks
C = [30, 31, 32, 33, 34, 35, 36, 37, 38]


def _script(pool):
    """Drive one pool through admission, sharing, registration, COW,
    LRU parking, eviction under pressure, truncation and double-free
    errors; return the observable state after every op."""
    trace = []
    tables = {}

    def snap(tag, result):
        trace.append((tag, result, dict(sorted(pool._ref.items())),
                      list(pool._free), list(pool._lru), pool.num_free,
                      round(pool.hit_rate(), 12), pool.cow_splits,
                      pool.evictions, pool.registrations,
                      pool.shared_blocks(),
                      [(k, a) for _, k, a in pool.events]))

    got = pool.admit(A, len(A) + 1)
    tables["a"] = got[0]
    snap("admit a", got)
    pool.register(A, tables["a"])
    snap("register a", None)
    got = pool.admit(B, len(B) + 1)           # partial hit: 8 tokens
    tables["b"] = got[0]
    snap("admit b", got)
    snap("needs_cow b tail", pool.needs_cow(tables["b"][1], 3))
    snap("needs_cow b fresh", pool.needs_cow(tables["b"][2], 0))
    pool.release(tables["a"], seq=A)          # a's blocks: b still reads 2
    snap("release a", None)
    got = pool.admit(A, len(A) + 1)           # full hit
    tables["a2"] = got[0]
    snap("admit a again", got)
    new = pool.cow(tables["a2"][2])           # split the shared tail
    tables["a2"][2] = new
    snap("cow a2 tail", new)
    extra = pool.truncate(tables["a2"], 6)    # keep 2 blocks
    snap("truncate a2", extra)
    pool.release(tables["b"], seq=B)
    pool.release(tables["a2"], seq=A[:6])
    snap("release b, a2", None)
    got = pool.admit(C, len(C) + 4)           # 4 blocks: evicts parked
    tables["c"] = got[0]
    snap("admit c", got)
    snap("admit too big", pool.admit(list(range(60)), 60))
    snap("alloc all", pool.alloc(pool.num_free))
    with pytest.raises(ValueError):
        pool.release([tables["c"][0]] * 2)
    snap("double free", None)
    return trace


def test_prefix_pool_replays_jax_op_for_op():
    jt = _script(JPrefix(JCFG, num_blocks=12, block_size=BS))
    tt = _script(TPrefix(TCFG, num_blocks=12, block_size=BS, device="cpu"))
    assert len(jt) == len(tt) == 14
    for j, t in zip(jt, tt):
        assert t == j, f"state differs after {j[0]!r}"
    # The script exercised what it claims to.
    last = tt[-1]
    assert last[7] >= 1 and last[8] >= 1      # cow splits, evictions
    kinds = {k for k, _ in last[11]}
    assert kinds == {"share", "register", "cow", "evict"}


def test_paged_allocator_matches_jax():
    jp = JPaged(JCFG, num_blocks=8, block_size=BS)
    tp = TPaged(TCFG, num_blocks=8, block_size=BS, device="cpu")
    for pool in (jp, tp):
        t1 = pool.alloc(3)
        t2 = pool.alloc(2)
        assert pool.alloc(3) is None
        pool.free(t1)
        with pytest.raises(ValueError):
            pool.free([t1[0]])
        with pytest.raises(ValueError):
            pool.free([0])
        pool.truncate(t2, 3)
    assert (tp._free, tp.num_free, tp.utilization()) == \
        (jp._free, jp.num_free, jp.utilization())
    with pytest.raises(ValueError):
        TPaged(TCFG, num_blocks=1, device="cpu")


def test_block_writes_and_cow_hold_the_same_kv():
    """write_prefill (in place) and cow (in-place block copy) leave the
    pool holding what the JAX pool's scatters hold."""
    rng = np.random.default_rng(0)
    T = 10
    shape = (JCFG.n_layer, T, JCFG.kv_heads, JCFG.head_dim)
    k = rng.standard_normal(shape, np.float32)
    v = rng.standard_normal(shape, np.float32)
    jp = JPrefix(JCFG, num_blocks=8, block_size=BS)
    tp = TPrefix(TCFG, num_blocks=8, block_size=BS, device="cpu")
    for pool, conv in ((jp, jnp.asarray), (tp, torch.from_numpy)):
        table, _ = pool.admit(A, T)
        pool.write_prefill(conv(k), conv(v), table)
        pool.register(A, table)
        pool.admit(A, T)                       # a second reader
        dst = pool.cow(table[2])
        assert dst is not None
        kk, vv = pool.gather_tokens(table[:2] + [dst], T)
        np.testing.assert_allclose(np.asarray(kk), k)
        np.testing.assert_allclose(np.asarray(vv), v)
    np.testing.assert_array_equal(tp.k.numpy(), np.asarray(jp.k))
    np.testing.assert_array_equal(tp.v.numpy(), np.asarray(jp.v))
    with pytest.raises(ValueError):
        tp.write_prefill(torch.from_numpy(k), torch.from_numpy(v), [1, 2])
