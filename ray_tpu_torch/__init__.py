"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, slice by slice.

The JAX package (``ray_tpu``) stays the reference; this package keeps
its module layout and public names so each counterpart is easy to find,
and imports neither ``jax`` nor anything of ``ray_tpu`` (a module it
needs that has no JAX in it is copied, not imported).

The slices so far are LLM serving and training on the GPT family:

  * ops/attention.py        — dense causal attention (plain PyTorch)
  * ops/paged_decode.py     — paged decode/verify attention, CUDA kernel
                               in ops/csrc/paged_decode.cu
  * ops/flash.py            — flash attention forward (with and without
                               the LSE, ops/csrc/flash_fwd.cu), fused and
                               split backward (ops/csrc/flash_bwd.cu),
                               the FlashAttention autograd.Function
  * ops/flash_attention.py  — the flash_attention entry point
  * models/gpt.py           — GPTConfig, init, the inference forwards,
                               the training forward, loss and train step
  * models/convert.py       — weights and optimizer state to and from
                               the JAX/optax trees
  * optim.py                — optax's adamw and apply_updates
  * llm/                    — paged KV pool, prefix cache, engine
  * serve/llm.py            — byte tokenizer and the LLMServer handler

Entry points run on the card (``device=None`` means ``"cuda"``) and
raise when there is none; the CPU is used only when a caller asks for
it, as the tests do. On a CPU tensor a kernel wrapper takes the kernel's
plain PyTorch version; on a CUDA tensor it launches the kernel or
raises, never falling back.
"""

from ._device import resolve_device  # noqa: F401
