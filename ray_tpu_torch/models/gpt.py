"""GPT-2-class decoder-only transformer (port of ray_tpu/models/gpt.py).

Params are a plain dict with the JAX tree's names and stacked shapes
(``wq [L, m, h, d]``, ``wo [L, h, d, m]``, tied ``wte [V, m]``), so
weights carry across with models/convert.py. A Python loop over layers
replaces ``lax.scan``. The ``mesh``/``rules`` arguments are gone:
multi-GPU is a later slice.

Numerics follow the JAX model: matmuls in ``cfg.dtype``, layernorm in
f32 with population variance and a scale but no bias, GELU with the
tanh approximation (``jax.nn.gelu``'s default), logits through the tied
embedding.

Training: ``forward`` is the grad-enabled forward over f32 master
params, cast to ``cfg.dtype`` inside as the JAX model casts, with the
JAX model's remat policies as ``torch.utils.checkpoint`` regions;
``loss_fn`` is next-token cross-entropy through ``_xent``, whose
backward emits dlogits in the logits' dtype; ``make_train_step`` builds
the ``(state, tokens) -> (state, {"loss"})`` step over an optimizer of
ray_tpu_torch/optim.py.

The inference forwards (continuous-batching engine, llm/engine.py):
``forward_prefill`` runs the whole prompt and exports each layer's K/V
for the paged pool; ``forward_decode`` runs one token per sequence,
writes its K/V into the pool and attends through the paged decode
kernel; ``forward_prefill_chunk`` runs one prompt chunk against the
pool context. They run under ``torch.no_grad()``. ``forward_verify``
belongs to a later slice.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device
from ..ops.attention import NEG_INF, causal_attention
from .._tree import tree_leaves, tree_map
from ..optim import apply_updates


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
    remat: bool = False
    use_flash: bool = False
    # The CUDA flash kernels pick their own 64 x 64 tile; as in the JAX
    # package this sets the padded lengths by which the backward picks
    # the fused or the split kernels.
    flash_block: int = 512
    # Rematerialization policy when remat=True (the JAX model's names):
    #   "dots_no_batch" — keep only the weight matmuls' outputs
    #   "dots"          — keep every matmul output, recompute the
    #       elementwise ops (layernorm, GELU) and the attention
    #   "mlp_only"      — checkpoint only each block's MLP
    #   "dots_flash"    — "dots" plus the flash kernel's o and LSE: the
    #       backward never re-runs the attention forward
    remat_policy: str = "dots_flash"

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


def _attn_in(x, p):
    """The q, k, v projections [b, s, heads, head_dim] of x [b, s, m]."""
    h = _layernorm(x, p["ln1"])
    return _proj(h, p["wq"]), _proj(h, p["wk"]), _proj(h, p["wv"])


def _attend(q, k, v, cfg: GPTConfig):
    if cfg.use_flash:
        from ..ops.flash_attention import flash_attention

        # The kernels read the [b, s, h, d] projections through their
        # strides (layout "bshd"): no transposes around them, and
        # gradients come back in the same layout.
        return flash_attention(q, k, v, causal=True,
                               block_size=cfg.flash_block, layout="bshd")
    return causal_attention(q, k, v)


def _attn_out_mlp(x, o, p):
    x = x + _out_proj(o, p["wo"])
    return x + _mlp(x, p)


def _block(x, p, cfg: GPTConfig):
    """One transformer block on x [b, s, m]; returns (x, (k, v)) with
    this layer's K/V projections as [b, s, kv_heads, head_dim] — the
    prefill path hands them to the paged KV pool."""
    q, kk, v = _attn_in(x, p)
    return _attn_out_mlp(x, _attend(q, kk, v, cfg), p), (kk, v)


def _embed(params, tokens, positions, dt):
    return (params["wte"].to(dt)[tokens.long()]
            + params["wpe"].to(dt)[positions.long()])


def _logits(params, x, dt):
    x = _layernorm(x, params["ln_f"])
    return x @ params["wte"].to(dt).T


def forward(params, tokens, cfg: GPTConfig):
    """tokens [b, s] int -> logits [b, s, vocab] (cfg.dtype).

    The training forward (ray_tpu/models/gpt.py:214-279), grad-enabled:
    ``params`` are the f32 masters, cast to ``cfg.dtype`` inside, so
    gradients land in f32 as the JAX model's do. With ``cfg.remat`` each
    block runs under ``cfg.remat_policy`` (``_train_block``). Called on
    tensors that do not require grad, it is the plain forward (the flash
    attention then takes its primal kernel).
    """
    _remat_policy(cfg)
    dt = cfg.dtype
    s = tokens.shape[1]
    x = _embed(params, tokens, torch.arange(s, device=tokens.device), dt)
    # One cast of each stacked weight, then per-layer views (unbind's
    # backward stacks the layers' gradients in one op).
    layers = {k: (v.to(dt) if k in _MATMUL_KEYS else v).unbind(0)
              for k, v in params["blocks"].items()}
    for i in range(cfg.n_layer):
        x = _train_block(x, {k: v[i] for k, v in layers.items()}, cfg)
    return _logits(params, x, dt)


# Remat policies (ray_tpu/models/gpt.py:236-265). A checkpointed region
# keeps the outputs of the ops its policy names and recomputes everything
# else in the backward (torch.utils.checkpoint's selective checkpointing, the
# counterpart of jax.checkpoint_policies). The weight matmuls are
# aten.mm/addmm (``x @ w`` folds the batch into rows); dense attention's
# score and PV products are aten.bmm, matmuls WITH batch dims, which
# "dots_no_batch" does not keep. "dots_flash" keeps the flash kernel's
# o and LSE by running the attention outside the checkpointed regions,
# so its residuals are saved and the backward never re-runs its forward.
_ATEN = torch.ops.aten
_WEIGHT_DOTS = (_ATEN.mm.default, _ATEN.addmm.default)
_ALL_DOTS = _WEIGHT_DOTS + (_ATEN.bmm.default, _ATEN.baddbmm.default)
_REMAT_SAVE = {"dots_no_batch": _WEIGHT_DOTS, "dots": _ALL_DOTS,
               "dots_flash": _ALL_DOTS}


def _remat_policy(cfg: GPTConfig) -> Optional[str]:
    """The policy a block runs under: None without remat; "dots_flash"
    without flash attention becomes "dots_no_batch", as in the JAX model
    (dense attention would keep O(seq^2) score products)."""
    if not cfg.remat:
        return None
    name = cfg.remat_policy
    if name == "mlp_only":
        return name
    if name not in _REMAT_SAVE:
        raise ValueError(f"remat_policy={name!r}; valid: "
                         f"{sorted(_REMAT_SAVE)} or 'mlp_only'")
    if name == "dots_flash" and not cfg.use_flash:
        return "dots_no_batch"
    return name


def _remat(fn, name, *args):
    """fn(*args) as a checkpointed region keeping the outputs of the ops
    of policy ``name``."""
    keep = _REMAT_SAVE[name]

    def policy(ctx, op, *a, **kw):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return checkpoint(fn, *args, use_reentrant=False, context_fn=functools
                      .partial(create_selective_checkpoint_contexts, policy))


def _train_block(x, p, cfg: GPTConfig):
    """One block of the training forward under cfg's remat policy."""
    name = _remat_policy(cfg)
    if name is None:
        return _block(x, p, cfg)[0]
    if name == "mlp_only":
        # Attention keeps its residuals; the MLP is recomputed whole.
        o = _attend(*_attn_in(x, p), cfg)
        x = x + _out_proj(o, p["wo"])
        return x + checkpoint(_mlp, x, p, use_reentrant=False)
    if name == "dots_flash":
        q, k, v = _remat(_attn_in, name, x, p)
        return _remat(_attn_out_mlp, name, x, _attend(q, k, v, cfg), p)
    return _remat(lambda x, p: _block(x, p, cfg)[0], name, x, p)


class _Xent(torch.autograd.Function):
    """Mean next-token cross-entropy with the JAX model's hand-written
    VJP (ray_tpu/models/gpt.py:551-583): the forward keeps the logits as
    they are (no f32 copy saved for the backward, only the f32
    logsumexp), and the backward emits dlogits = (softmax - onehot)·g/n
    in the LOGITS' dtype (bf16 on the training path), not f32."""

    @staticmethod
    def forward(ctx, logits, targets):
        targets = targets.long()
        logz = torch.logsumexp(logits.float(), dim=-1)
        gold = logits.gather(-1, targets[..., None])[..., 0].float()
        ctx.save_for_backward(logits, targets, logz)
        return (logz - gold).mean()

    @staticmethod
    def backward(ctx, g):
        logits, targets, logz = ctx.saved_tensors
        p = torch.exp(logits.float() - logz[..., None])
        p.scatter_add_(-1, targets[..., None],
                       torch.full_like(logz[..., None], -1.0))
        return (p * (g / logz.numel())).to(logits.dtype), None


def _xent(logits, targets):
    return _Xent.apply(logits, targets)


def loss_fn(params, tokens, cfg: GPTConfig):
    """Next-token cross-entropy (targets = tokens shifted left)."""
    logits = forward(params, tokens[:, :-1], cfg)
    return _xent(logits, tokens[:, 1:])


def loss_and_grads(params, tokens, cfg: GPTConfig):
    """(loss, grads) of ``loss_fn`` at ``params`` — the port's
    ``jax.value_and_grad(loss_fn)``; grads mirror the params tree."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(live, tokens, cfg)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss.detach(), tree_map(lambda _: next(grads), live)


def make_train_step(cfg: GPTConfig, optimizer, mesh=None, rules=None,
                    donate: bool = True):
    """Build the train step: (state, tokens) -> (state, {"loss": loss}),
    state = {"params", "opt_state", "step"}
    (ray_tpu/models/gpt.py:592-618).

    ``optimizer`` has optax's ``update(grads, opt_state, params)``
    (ray_tpu_torch/optim.py ``adamw``). ``donate`` updates the params in
    place, the counterpart of jit's donated buffers. ``mesh`` and
    ``rules`` belong to the multi-GPU slice (ROADMAP.md Queue 1 item 13).
    """
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "ray_tpu_torch: mesh/rules arrive with the multi-GPU slice "
            "(ROADMAP.md Queue 1 item 13)")

    def step(state, tokens):
        loss, grads = loss_and_grads(state["params"], tokens, cfg)
        updates, opt_state = optimizer.update(grads, state["opt_state"],
                                              state["params"])
        params = apply_updates(state["params"], updates, inplace=donate)
        return ({"params": params, "opt_state": opt_state,
                 "step": state["step"] + 1}, {"loss": loss})

    return step


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
