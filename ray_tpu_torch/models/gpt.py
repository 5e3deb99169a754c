"""GPT-2-class decoder-only transformer, inference half (port of
ray_tpu/models/gpt.py).

Params are a plain dict with the JAX tree's names and stacked shapes
(``wq [L, m, h, d]``, ``wo [L, h, d, m]``, tied ``wte [V, m]``), so
weights carry across with models/convert.py. A Python loop over layers
replaces ``lax.scan``. The ``mesh``/``rules`` arguments are gone:
multi-GPU is a later slice.

Numerics follow the JAX model: matmuls in ``cfg.dtype``, layernorm in
f32 with population variance and a scale but no bias, GELU with the
tanh approximation (``jax.nn.gelu``'s default), logits through the tied
embedding.

The inference forwards (continuous-batching engine, llm/engine.py):
``forward_prefill`` runs the whole prompt and exports each layer's K/V
for the paged pool; ``forward_decode`` runs one token per sequence,
writes its K/V into the pool and attends through the paged decode
kernel; ``forward_prefill_chunk`` runs one prompt chunk against the
pool context. ``forward_verify`` and training belong to later slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.attention import NEG_INF, causal_attention


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # GPT-2 BPE padded to a multiple of 128
    max_seq: int = 1024
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: Optional[int] = None
    d_ff: Optional[int] = None  # default 4*d_model
    dtype: Any = torch.bfloat16
    use_flash: bool = False
    # Kept for the JAX signature; the CUDA flash kernel picks its own tile.
    flash_block: int = 512

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    @property
    def ff(self) -> int:
        return self.d_ff or 4 * self.d_model


TINY = GPTConfig(vocab_size=512, max_seq=128, d_model=128, n_layer=2, n_head=4)
GPT2_SMALL = GPTConfig()  # 124M
GPT2_MEDIUM = GPTConfig(d_model=1024, n_layer=24, n_head=16)

# Matmul weights: cast to cfg.dtype for compute. The layernorm scales
# stay f32 (``_layernorm`` multiplies in f32, as the JAX model does).
_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "wi", "wm")


def init(cfg: GPTConfig, generator: Optional[torch.Generator] = None, *,
         device=None) -> dict:
    """Initialize params (f32), GPT-2-style scaled init: the JAX model's
    shapes and standard deviations, drawn from a CPU ``torch.Generator``
    (the numbers differ from ``jax.random``'s; carry JAX weights across
    with models/convert.py). ``device=None`` means the card."""
    dev = resolve_device(device)
    m, d, h, hk, f, L = (cfg.d_model, cfg.head_dim, cfg.n_head, cfg.kv_heads,
                         cfg.ff, cfg.n_layer)
    std = 0.02
    resid_std = std / math.sqrt(2 * L)

    def rnd(shape, s):
        return (torch.randn(shape, generator=generator) * s).to(dev)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    return {
        "wte": rnd((cfg.vocab_size, m), std),
        "wpe": rnd((cfg.max_seq, m), std),
        "blocks": {
            "ln1": ones((L, m)),
            "wq": rnd((L, m, h, d), std),
            "wk": rnd((L, m, hk, d), std),
            "wv": rnd((L, m, hk, d), std),
            "wo": rnd((L, h, d, m), resid_std),
            "ln2": ones((L, m)),
            "wi": rnd((L, m, f), std),
            "wm": rnd((L, f, m), resid_std),
        },
        "ln_f": ones((m,)),
    }


def working_params(params: dict, cfg: GPTConfig, device=None) -> dict:
    """The params in the working dtype, on ``device`` (default: where
    they are), made once for inference. The JAX model casts on every
    call; the cast is the same, so the numbers are the same."""
    def mv(t, dt=None):
        return t.to(device=device if device is not None else t.device,
                    dtype=dt if dt is not None else t.dtype)

    blocks = {k: mv(v, cfg.dtype if k in _MATMUL_KEYS else None)
              for k, v in params["blocks"].items()}
    return {"wte": mv(params["wte"], cfg.dtype),
            "wpe": mv(params["wpe"], cfg.dtype),
            "blocks": blocks, "ln_f": mv(params["ln_f"])}


def _layernorm(x, scale):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + 1e-5) * scale
    return out.to(x.dtype)


def _layer(params: dict, i: int, dt) -> dict:
    """Layer i's slice of the stacked block params, matmul weights cast
    to dt (a no-op for working_params)."""
    return {k: (v[i].to(dt) if k in _MATMUL_KEYS else v[i])
            for k, v in params["blocks"].items()}


def _proj(x, w):
    """x [..., m] times w [m, h, d] -> [..., h, d]."""
    m, h, d = w.shape
    return (x @ w.reshape(m, h * d)).unflatten(-1, (h, d))


def _out_proj(o, w):
    """o [..., h, d] times w [h, d, m] -> [..., m]."""
    h, d, m = w.shape
    return o.flatten(-2) @ w.reshape(h * d, m)


def _mlp(x, p):
    h2 = _layernorm(x, p["ln2"])
    ff = F.gelu(h2 @ p["wi"], approximate="tanh")
    return ff @ p["wm"]


def _block(x, p, cfg: GPTConfig):
    """One transformer block on x [b, s, m]; returns (x, (k, v)) with
    this layer's K/V projections as [b, s, kv_heads, head_dim] — the
    prefill path hands them to the paged KV pool."""
    h = _layernorm(x, p["ln1"])
    q = _proj(h, p["wq"])            # [b, s, h, d]
    kk = _proj(h, p["wk"])
    v = _proj(h, p["wv"])
    if cfg.use_flash:
        from ..ops.flash_attention import flash_attention

        # The kernel reads the [b, s, h, d] projections through their
        # strides (layout "bshd"): no transposes around it.
        o = flash_attention(q, kk, v, causal=True,
                            block_size=cfg.flash_block, layout="bshd")
    else:
        o = causal_attention(q, kk, v)
    x = x + _out_proj(o, p["wo"])
    x = x + _mlp(x, p)
    return x, (kk, v)


def _embed(params, tokens, positions, dt):
    return (params["wte"].to(dt)[tokens.long()]
            + params["wpe"].to(dt)[positions.long()])


def _logits(params, x, dt):
    x = _layernorm(x, params["ln_f"])
    return x @ params["wte"].to(dt).T


@torch.no_grad()
def forward(params, tokens, cfg: GPTConfig):
    """tokens [b, s] int -> logits [b, s, vocab] (cfg.dtype)."""
    return forward_prefill(params, tokens, cfg)[0]


@torch.no_grad()
def forward_prefill(params, tokens, cfg: GPTConfig):
    """Prompt pass that also exports the KV cache.

    tokens [b, s] int -> (logits [b, s, vocab],
                          k [L, b, s, kv_heads, head_dim], v like k).
    """
    dt = cfg.dtype
    s = tokens.shape[1]
    pos = torch.arange(s, device=tokens.device)
    x = _embed(params, tokens, pos, dt)
    ks, vs = [], []
    for i in range(cfg.n_layer):
        x, (k, v) = _block(x, _layer(params, i, dt), cfg)
        ks.append(k)
        vs.append(v)
    return _logits(params, x, dt), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def forward_decode(params, tokens, positions, k_pool, v_pool,
                   block_tables, context_lens, slot_blocks, slot_offsets,
                   cfg: GPTConfig):
    """One decode step for a batch of in-flight sequences.

    Each lane projects its token's K/V, writes them into the paged pool
    at (slot_blocks[lane], slot_offsets[lane]) and THEN attends over its
    block table (context_lens include the new token: write-then-attend).
    The writes are in place: where the JAX model scattered into a
    donated pool functionally, the port updates ``k_pool``/``v_pool``.

    Args:
      tokens / positions: [b] int — last sampled token + its absolute
        position per lane. Padded lanes point at the pool's reserved
        scratch block 0 with context_lens 1; their logits are garbage.
      k_pool / v_pool: [L, kv_heads, num_blocks, block_size, head_dim].
      block_tables: [b, max_nb] int32, 0-padded.
      slot_blocks / slot_offsets: [b] int — the pool block and in-block
        offset of each lane's CURRENT token.

    Returns (logits [b, vocab], k_pool, v_pool) (the same pool tensors).
    """
    from ..ops.paged_decode import paged_decode_attention

    dt = cfg.dtype
    B = tokens.shape[0]
    hkv, group = cfg.kv_heads, cfg.n_head // cfg.kv_heads
    sb, so = slot_blocks.long(), slot_offsets.long()
    x = _embed(params, tokens, positions, dt)              # [b, m]
    for i in range(cfg.n_layer):
        p = _layer(params, i, dt)
        kp, vp = k_pool[i], v_pool[i]
        h = _layernorm(x, p["ln1"])
        q = _proj(h, p["wq"])                               # [b, h, d]
        k_tok = _proj(h, p["wk"])
        v_tok = _proj(h, p["wv"])
        # Cache write at the positional offset, before attending. Lanes
        # have unique slots by construction (padded lanes collide on
        # the scratch block, which is never read unmasked).
        kp[:, sb, so] = k_tok.to(kp.dtype).transpose(0, 1)
        vp[:, sb, so] = v_tok.to(vp.dtype).transpose(0, 1)
        o = paged_decode_attention(
            q.reshape(B, hkv, group, cfg.head_dim), kp, vp,
            block_tables, context_lens)
        x = x + _out_proj(o.reshape(B, cfg.n_head, cfg.head_dim), p["wo"])
        x = x + _mlp(x, p)
    return _logits(params, x, dt), k_pool, v_pool


def _chunk_attention(q, k_tok, v_tok, k_ctx, v_ctx, ctx_len):
    """Attention for one prefill chunk over [pool context ++ chunk].

    q / k_tok / v_tok: [b, c, heads(kv), d] — this chunk's projections.
    k_ctx / v_ctx: [b, S, kv_heads, d] — the sequence's pool slots
    gathered from its block table (only the first ctx_len are real).
    Query i sits at absolute position ctx_len + i: the mask admits pool
    slots < ctx_len and chunk slots j <= i. Same f32-softmax / NEG_INF
    discipline as ops.attention.causal_attention.
    """
    b, c, hq, d = q.shape
    S = k_ctx.shape[1]
    k = torch.cat([k_ctx.to(q.dtype), k_tok], dim=1)
    v = torch.cat([v_ctx.to(q.dtype), v_tok], dim=1)
    hk = k.shape[2]
    if hq != hk:
        k = k.repeat_interleave(hq // hk, dim=2)
        v = v.repeat_interleave(hq // hk, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (d ** -0.5)
    dev = q.device
    qi = torch.arange(c, device=dev)[:, None]
    kp = torch.arange(S + c, device=dev)[None, :]
    mask = torch.where(kp < S, kp < ctx_len, (kp - S) <= qi)
    logits = torch.where(mask[None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@torch.no_grad()
def forward_prefill_chunk(params, tokens, positions, k_pool, v_pool,
                          block_table, ctx_len, cfg: GPTConfig):
    """One chunk of an incremental prefill (chunked admission and
    prefix-cache hits): run ``tokens`` [1, c] whose context already sits
    in the paged pool under ``block_table``.

    Args:
      positions: [c] int absolute positions (ctx_len + arange(c),
        clipped to max_seq - 1 on the padded tail).
      block_table: [max_nb] int32, 0-padded like decode's tables.
      ctx_len: int — tokens already resident in the pool.

    The pools are only read; the chunk's K/V comes back like
    forward_prefill's and the caller writes it into the pool afterwards
    (shared blocks must be COW-split before that write).

    Returns (logits [1, c, vocab], k [L, 1, c, kv_heads, head_dim],
    v like k).
    """
    dt = cfg.dtype
    hkv, hd = cfg.kv_heads, cfg.head_dim
    table = block_table.long()
    x = _embed(params, tokens, positions, dt)
    ks, vs = [], []
    for i in range(cfg.n_layer):
        p = _layer(params, i, dt)
        h = _layernorm(x, p["ln1"])
        q = _proj(h, p["wq"])
        k_tok = _proj(h, p["wk"])
        v_tok = _proj(h, p["wv"])
        # This sequence's pool context: [hkv, max_nb, BS, d] gathered by
        # table, flattened to slot order [1, S, hkv, d].
        k_ctx = k_pool[i][:, table]
        v_ctx = v_pool[i][:, table]
        nb, bs = k_ctx.shape[1], k_ctx.shape[2]
        k_ctx = k_ctx.permute(1, 2, 0, 3).reshape(1, nb * bs, hkv, hd)
        v_ctx = v_ctx.permute(1, 2, 0, 3).reshape(1, nb * bs, hkv, hd)
        o = _chunk_attention(q, k_tok, v_tok, k_ctx, v_ctx, ctx_len)
        x = x + _out_proj(o, p["wo"])
        x = x + _mlp(x, p)
        ks.append(k_tok)
        vs.append(v_tok)
    return _logits(params, x, dt), torch.stack(ks), torch.stack(vs)
