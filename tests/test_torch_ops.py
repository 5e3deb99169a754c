"""Attention ops of the PyTorch port (ray_tpu_torch/ops) against the
JAX package, on the CPU.

On a CPU tensor each kernel wrapper takes its plain PyTorch version, so
these tests hold those plain versions (the arithmetic the CUDA kernels
repeat, and the CPU path of the port) against the JAX references and,
once at a tiny shape, against the Pallas kernels in interpret mode. The
CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py.

Inputs are made from a numpy seed and handed to both packages as numpy.
Tolerances are the JAX tests' own: f32 atol 2e-5 (one online-softmax
accumulation vs a dense softmax: only rounding differs), bf16 atol 2e-2
for paged decode (tests/test_paged_decode.py) and 3e-2 for flash
(tests/test_pallas_flash.py) — bf16 input quantization, f32 accumulation
on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import causal_attention as jax_causal_attention
from ray_tpu.ops.pallas.flash import flash_attention_pallas
from ray_tpu.ops.pallas.paged_decode import (
    paged_decode_attention as jax_paged_decode,
    paged_decode_attention_reference as jax_paged_decode_ref,
    paged_verify_attention as jax_paged_verify,
    paged_verify_attention_reference as jax_paged_verify_ref,
)
from ray_tpu_torch.ops import flash as t_flash
from ray_tpu_torch.ops import paged_decode as t_paged
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)

ATOL_F32 = 2e-5
ATOL_PAGED_BF16 = 2e-2
ATOL_FLASH_BF16 = 3e-2


def _pair(x, dtype):
    """numpy f32 -> (jax array, torch tensor) of the same dtype (bf16
    rounding is round-to-nearest-even on both sides)."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), \
            torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _paged_case(seed, *, batch, hkv, group, d, num_blocks, block_size,
                max_nb, q_len=None, min_ctx=1):
    """Random pool + tables + context lens, block 0 kept as scratch and
    tables padded with 0 (the layout llm/kv_cache.py produces)."""
    rng = np.random.default_rng(seed)
    qshape = ((batch, hkv, group, d) if q_len is None
              else (batch, q_len, hkv, group, d))
    q = rng.standard_normal(qshape, np.float32)
    pshape = (hkv, num_blocks, block_size, d)
    k_pool = rng.standard_normal(pshape, np.float32)
    v_pool = rng.standard_normal(pshape, np.float32)
    tables = np.zeros((batch, max_nb), np.int32)
    lens = np.zeros((batch,), np.int32)
    avail = list(range(1, num_blocks))
    rng.shuffle(avail)
    for b in range(batch):
        nb = int(rng.integers(1, max_nb + 1))
        lo = max((nb - 1) * block_size + 1, min_ctx)
        lens[b] = int(rng.integers(lo, max(lo, nb * block_size) + 1))
        nb = -(-int(lens[b]) // block_size)
        tables[b, :nb] = [avail.pop() for _ in range(nb)]
    return q, k_pool, v_pool, tables, lens


PAGED = dict(batch=3, hkv=2, d=16, num_blocks=24, block_size=8, max_nb=3)


@pytest.mark.parametrize("dtype,group", [("f32", 1), ("f32", 2),
                                         ("bf16", 1), ("bf16", 4)])
def test_paged_decode_plain_matches_jax_reference(dtype, group):
    q, kp, vp, tables, lens = _paged_case(1, group=group, **PAGED)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kp, dtype)
    jv, tv = _pair(vp, dtype)
    ref = jax_paged_decode_ref(jq, jk, jv, jnp.asarray(tables),
                               jnp.asarray(lens))
    out = t_paged.paged_decode_attention_reference(
        tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lens))
    assert out.dtype == tq.dtype and out.shape == tq.shape
    atol = ATOL_F32 if dtype == "f32" else ATOL_PAGED_BF16
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol)


@pytest.mark.parametrize("dtype,group", [("f32", 1), ("bf16", 2)])
def test_paged_verify_plain_matches_jax_reference(dtype, group):
    q, kp, vp, tables, lens = _paged_case(2, group=group, q_len=4,
                                          min_ctx=4, **PAGED)
    q_lens = np.array([4, 1, 3], np.int32)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kp, dtype)
    jv, tv = _pair(vp, dtype)
    ref = jax_paged_verify_ref(jq, jk, jv, jnp.asarray(tables),
                               jnp.asarray(lens), jnp.asarray(q_lens))
    out = t_paged.paged_verify_attention_reference(
        tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lens),
        torch.from_numpy(q_lens))
    atol = ATOL_F32 if dtype == "f32" else ATOL_PAGED_BF16
    # Rows past q_lens[b] are padding the caller never reads.
    for b, n in enumerate(q_lens):
        np.testing.assert_allclose(_np(out)[b, :n], _np(ref)[b, :n],
                                   atol=atol)


def test_paged_plain_matches_pallas_kernel_interpret():
    """Once at a tiny shape, against the TPU kernel itself (interpret
    mode), decode and verify, GQA."""
    q, kp, vp, tables, lens = _paged_case(3, group=2, **PAGED)
    got = t_paged.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens))
    ker = jax_paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(tables), jnp.asarray(lens),
                           interpret=True)
    np.testing.assert_allclose(_np(got), _np(ker), atol=ATOL_F32)

    q, kp, vp, tables, lens = _paged_case(4, group=2, q_len=3, min_ctx=3,
                                          **PAGED)
    q_lens = np.array([3, 2, 1], np.int32)
    got = t_paged.paged_verify_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens),
        torch.from_numpy(q_lens))
    ker = jax_paged_verify(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(tables), jnp.asarray(lens),
                           jnp.asarray(q_lens), interpret=True)
    for b, n in enumerate(q_lens):
        np.testing.assert_allclose(_np(got)[b, :n], _np(ker)[b, :n],
                                   atol=ATOL_F32)


def test_paged_scratch_block_garbage_is_masked():
    """Padded table slots point at block 0; whatever it holds must not
    reach the output (the JAX pool keeps garbage there too)."""
    q, kp, vp, tables, lens = _paged_case(5, group=1, **PAGED)
    clean = t_paged.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens))
    kp[:, 0] = 1e4
    vp[:, 0] = -1e4
    dirty = t_paged.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens))
    ref = jax_paged_decode_ref(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(tables),
                               jnp.asarray(lens))
    assert torch.equal(clean, dirty)
    np.testing.assert_allclose(_np(dirty), _np(ref), atol=ATOL_F32)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    """On the CPU a wrapper runs the plain version and counts no kernel
    launch."""
    q, kp, vp, tables, lens = _paged_case(6, group=1, **PAGED)
    n_paged, n_flash = t_paged.launches, t_flash.launches
    args = [torch.from_numpy(x) for x in (q, kp, vp, tables, lens)]
    assert torch.equal(t_paged.paged_decode_attention(*args),
                       t_paged.paged_decode_attention_reference(*args))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 20, 2, 16), np.float32))
    assert torch.equal(flash_attention(x, x, x),
                       t_flash.flash_attention_reference(x, x, x))
    assert (t_paged.launches, t_flash.launches) == (n_paged, n_flash)


def _qkv(seed, b, s, h, d, kv_heads=None, sk=None):
    rng = np.random.default_rng(seed)
    hk = kv_heads or h
    sk = sk or s
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, sk, hk, d), np.float32),
            rng.standard_normal((b, sk, hk, d), np.float32))


FLASH_CASES = {
    # name: (seed, b, s, h, d, kv_heads, causal, dtype)
    "causal": (10, 2, 64, 2, 16, None, True, "f32"),
    "dense": (11, 2, 64, 2, 16, None, False, "f32"),
    "ragged_causal": (12, 1, 50, 2, 16, None, True, "f32"),
    "ragged_dense": (13, 1, 50, 2, 16, None, False, "f32"),
    "gqa": (14, 1, 32, 4, 16, 2, True, "f32"),
    "bf16": (15, 1, 64, 2, 32, None, True, "bf16"),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_kernel_interpret(case):
    seed, b, s, h, d, hk, causal, dtype = FLASH_CASES[case]
    q, k, v = _qkv(seed, b, s, h, d, kv_heads=hk)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    ref = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=32,
                                 block_k=32, interpret=True)
    out = flash_attention(tq, tk, tv, causal=causal, block_size=32)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    atol = ATOL_F32 if dtype == "f32" else ATOL_FLASH_BF16
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol,
                               rtol=0 if dtype == "f32" else 3e-2)


def test_flash_bhsd_layout_matches_bshd():
    q, k, v = _qkv(16, 2, 40, 4, 16, kv_heads=2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    bshd = flash_attention(tq, tk, tv, causal=True)
    bhsd = flash_attention(*(t.transpose(1, 2) for t in (tq, tk, tv)),
                           causal=True, layout="bhsd")
    torch.testing.assert_close(bhsd.transpose(1, 2), bshd, atol=ATOL_F32,
                               rtol=0)
    with pytest.raises(ValueError):
        flash_attention(tq, tk, tv, layout="hsbd")


@pytest.mark.parametrize("sq,sk,window,causal", [
    (8, 8, None, True), (5, 12, None, True), (5, 12, 4, True),
    (12, 12, 3, False), (6, 10, None, False)])
def test_causal_attention_matches_jax(sq, sk, window, causal):
    q, _, _ = _qkv(20, 2, sq, 4, 16)
    _, k, v = _qkv(21, 2, sq, 4, 16, kv_heads=2, sk=sk)
    ref = jax_causal_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), window=window, causal=causal)
    out = causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), window=window,
                           causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL_F32)
