"""Flash (blockwise, online-softmax) attention entry point (port of
ray_tpu/ops/flash_attention.py).

``flash_attention`` dispatches as the JAX package's custom VJP does:
when grad is enabled and an input requires grad, through
``FlashAttention`` (the forward-with-LSE kernel, then the fused or split
backward kernels); otherwise through the primal forward kernel, which
writes no LSE. A CUDA tensor goes to the hand-written kernels
(ops/flash.py, ops/csrc/flash_fwd.cu and flash_bwd.cu), a CPU tensor to
their plain versions. There is no fallback: a kernel that fails to
build or launch raises.
"""

from __future__ import annotations

import torch

from .flash import FlashAttention, _split, flash_attention_fwd

DEFAULT_BLOCK = 512


def flash_attention(q, k, v, *, causal: bool = True,
                    block_size: int = DEFAULT_BLOCK,
                    layout: str = "bshd"):
    """q,k,v: [batch, seq, heads, head_dim] (layout="bshd") or
    [batch, heads, seq, head_dim] (layout="bhsd"); output matches the
    input layout. Softmax statistics are f32; inputs may be bf16.

    ``block_size`` does not choose the CUDA kernels' tiles, which each
    kernel fixes for Hopper (the bf16 forward 128 x 128, the f32
    forward and the backward kernels 64 x 64; ops/flash.py
    ``fwd_geometry``); as in the JAX package it sets the padded lengths
    by which the backward chooses the fused or the split kernels
    (ops/flash.py ``bwd_route``: the reference's ``_fused_bwd_fits`` and
    the fused route's workspace cap).
    """
    _split(layout)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, layout, block_size)
    return flash_attention_fwd(q, k, v, causal=causal, layout=layout)
