"""Flash (blockwise, online-softmax) attention entry point (port of
ray_tpu/ops/flash_attention.py).

``flash_attention`` sends a CUDA tensor to the hand-written kernel
(ops/flash.py, ops/csrc/flash_fwd.cu) and a CPU tensor to its plain
version. There is no fallback: a kernel that fails to build or launch
raises.
"""

from __future__ import annotations

from .flash import flash_attention_fwd

DEFAULT_BLOCK = 512


def flash_attention(q, k, v, *, causal: bool = True,
                    block_size: int = DEFAULT_BLOCK,
                    layout: str = "bshd"):
    """q,k,v: [batch, seq, heads, head_dim] (layout="bshd") or
    [batch, heads, seq, head_dim] (layout="bhsd"); output matches the
    input layout. Softmax statistics are f32; inputs may be bf16.

    ``block_size`` is kept for the JAX signature; it chose the TPU
    kernel's VMEM blocks and does not choose the CUDA kernel's tile,
    which is fixed at 64 x 64 by the shared-memory budget.
    """
    del block_size
    return flash_attention_fwd(q, k, v, causal=causal, layout=layout)
