"""Attention ops (port of ray_tpu/ops/attention.py).

Plain PyTorch: the dense masked softmax the JAX package leaves to XLA.
The flash kernel (ops/flash_attention.py) and the paged decode kernel
(ops/paged_decode.py) are the hand-written paths.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # bf16-safe large negative (not -inf: avoids NaN via 0*inf)


def causal_attention(q, k, v, *, scale: Optional[float] = None,
                     window: Optional[int] = None, causal: bool = True):
    """(Causal by default) self-attention.

    q,k,v: [batch, seq, heads, head_dim]; kv may have fewer heads (GQA:
    query head i reads kv head i // group, ``repeat_interleave``, the
    ``jnp.repeat`` mapping). Logits and softmax run in f32 whatever the
    input dtype; the probabilities are cast to q's dtype before PV. The
    causal mask is aligned bottom-right (query i of sq sees keys up to
    i + sk - sq).
    """
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    if hq != hk:
        if hq % hk:
            raise ValueError(f"GQA requires heads({hq}) % kv_heads({hk}) == 0")
        rep = hq // hk
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dev = q.device
    q_pos = torch.arange(sq, device=dev)[:, None]
    k_pos = torch.arange(sk, device=dev)[None, :] - (sk - sq)
    if causal:
        mask = q_pos >= k_pos
    else:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if window is not None:
        if causal:
            mask = mask & (q_pos - k_pos < window)
        else:
            mask = mask & ((q_pos - k_pos).abs() < window)  # symmetric
    logits = torch.where(mask[None, None], logits,
                         torch.tensor(NEG_INF, dtype=logits.dtype,
                                      device=dev))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
