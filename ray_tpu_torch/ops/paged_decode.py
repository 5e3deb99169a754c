"""Paged decode attention (port of ray_tpu/ops/pallas/paged_decode.py).

Decode-time attention for continuous batching: each sequence's KV lives
in fixed-size blocks scattered across the pool (llm/kv_cache.py), named
by a per-sequence block table; the kernel gathers K/V blocks through
the table, so the pool is never compacted.

``paged_decode_attention`` (one query token per sequence) and
``paged_verify_attention`` (q_len rows per sequence, causal within the
speculative span) share one CUDA kernel, ops/csrc/paged_decode.cu, as
they share one pallas_call in the JAX package. For a CUDA tensor the
wrappers launch it (or raise); for a CPU tensor they take the plain
versions below, ``paged_decode_attention_reference`` and
``paged_verify_attention_reference``. ``launches`` counts kernel
launches and nothing else.

GQA is native: query heads arrive grouped per KV head as
``[batch, kv_heads, group, head_dim]`` (query head i reads kv head
i // group), so the pool stores only ``kv_heads`` copies.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import NEG_INF

launches = 0   # kernel launches of paged_attention_launch

_TILE_KEYS = 64   # keys staged per tile (rounded to whole blocks)
_MAX_SMEM = 227 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.library("paged_decode")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = i
        err = lib.paged_attention_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib


def _tile_blocks(block_size: int) -> int:
    return max(1, _TILE_KEYS // block_size)


def smem_bytes(rows: int, d: int, block_size: int) -> int:
    """Dynamic shared memory of one CTA (the kernel's layout)."""
    tk = _tile_blocks(block_size) * block_size
    return 4 * (2 * rows * d + tk * (d + 1) + tk * d + rows * tk + 3 * rows)


def _launch(q, k_pool, v_pool, block_tables, context_lens, q_lens, group):
    """q: [b, hkv, rows, d] contiguous; returns the same shape."""
    global launches
    b, hkv, rows, d = q.shape
    hkv_p, num_blocks, block_size, d_p = k_pool.shape
    if (hkv_p, d_p) != (hkv, d):
        raise ValueError(f"pool heads/dim {(hkv_p, d_p)} != query {(hkv, d)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} must match q's dtype and device "
                            f"({t.dtype}, {t.device} vs {q.dtype}, "
                            f"{q.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    vec = 16 // q.element_size()
    if d % vec or d > 256:
        raise ValueError(f"head_dim {d} must be a multiple of {vec} and "
                         f"<= 256 for the paged attention kernel")
    for t in (k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError("pools must be 16-byte aligned")
    smem = smem_bytes(rows, d, block_size)
    if smem > _MAX_SMEM:
        raise ValueError(f"{rows} query rows x head_dim {d} need {smem} "
                         f"bytes of shared memory (> {_MAX_SMEM})")
    dev = q.device
    q = q.contiguous()
    tables = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    qlens = q_lens.to(device=dev, dtype=torch.int32).contiguous()
    if tables.shape[0] != b or lens.shape != (b,) or qlens.shape != (b,):
        raise ValueError("block_tables/context_lens/q_lens must lead with "
                         f"batch {b}")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_launch(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(),
            qlens.data_ptr(), out.data_ptr(), b, hkv, num_blocks, block_size,
            tables.shape[1], rows, group, d, _tile_blocks(block_size),
            float(d ** -0.5), smem, stream)
    _build.check(err, "paged_attention_launch",
                 lib.paged_attention_error_string)
    launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens):
    """Single-token attention over block-paged KV.

    Args:
      q: ``[batch, kv_heads, group, head_dim]`` — one query token per
        sequence, query heads grouped by the KV head they read.
      k_pool / v_pool: ``[kv_heads, num_blocks, block_size, head_dim]``
        — ONE layer's slice of the paged pool.
      block_tables: ``[batch, max_blocks_per_seq]`` int32 — pool block
        ids per sequence, padded with 0 (the reserved scratch block).
      context_lens: ``[batch]`` int32 — tokens in cache per sequence,
        INCLUDING the current token (already written to its slot).

    Returns ``[batch, kv_heads, group, head_dim]`` in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, context_lens)
    b, hkv, group, d = q.shape
    ones = torch.ones((b,), dtype=torch.int32, device=q.device)
    return _launch(q, k_pool, v_pool, block_tables, context_lens, ones,
                   group)


def paged_verify_attention(q, k_pool, v_pool, block_tables, context_lens,
                           q_lens):
    """Multi-row (speculative verify) attention over block-paged KV.

    q: ``[batch, q_len, kv_heads, group, head_dim]`` — query row j of
    lane b sits at absolute position ``context_lens[b] - q_lens[b] + j``.
    context_lens include this step's q_lens[b] real rows; rows past
    q_lens[b] are padding (defined garbage the caller must not read).

    Returns ``[batch, q_len, kv_heads, group, head_dim]`` in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_verify_attention_reference(
            q, k_pool, v_pool, block_tables, context_lens, q_lens)
    b, q_len, hkv, group, d = q.shape
    # Kernel row layout: [q_len, group] flattened, so row r is query
    # token r // group of the lane.
    qf = q.permute(0, 2, 1, 3, 4).reshape(b, hkv, q_len * group, d)
    out = _launch(qf, k_pool, v_pool, block_tables, context_lens, q_lens,
                  group)
    return out.reshape(b, hkv, q_len, group, d).permute(0, 2, 1, 3, 4)


def _gather(pool, block_tables):
    """[hkv, NB, BS, d] gathered by table -> [b, hkv, max_nb * BS, d]."""
    hkv, _, bs, d = pool.shape
    b, max_nb = block_tables.shape
    g = pool[:, block_tables.long()]          # [hkv, b, max_nb, bs, d]
    return g.permute(1, 0, 2, 3, 4).reshape(b, hkv, max_nb * bs, d)


def paged_decode_attention_reference(q, k_pool, v_pool, block_tables,
                                     context_lens):
    """Plain version: materialize the gather, run dense masked softmax
    attention in f32. O(batch x max_ctx) memory."""
    b, hkv, group, d = q.shape
    k = _gather(k_pool, block_tables).float()
    v = _gather(v_pool, block_tables).float()
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k) * (d ** -0.5)
    k_pos = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    ctx = context_lens.to(q.device)[:, None, None, None]
    s = torch.where(k_pos < ctx, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bhkd->bhgd", p, v).to(q.dtype)


def paged_verify_attention_reference(q, k_pool, v_pool, block_tables,
                                     context_lens, q_lens):
    """Plain version of the q_len > 1 verify pass: same gather as the
    decode reference, per-row causal bound
    ``min(ctx, ctx - q_lens + 1 + row)``."""
    b, q_len, hkv, group, d = q.shape
    k = _gather(k_pool, block_tables).float()
    v = _gather(v_pool, block_tables).float()
    s = torch.einsum("bqhgd,bhkd->bhqgk", q.float(), k) * (d ** -0.5)
    dev = q.device
    k_pos = torch.arange(k.shape[2], device=dev)[None, None, None, None, :]
    ctx = context_lens.to(dev)[:, None, None, None, None]
    qi = torch.arange(q_len, device=dev)[None, None, :, None, None]
    bound = torch.minimum(ctx, ctx - q_lens.to(dev)[:, None, None, None, None]
                          + 1 + qi)
    s = torch.where(k_pos < bound, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqgk,bhkd->bqhgd", p, v).to(q.dtype)
