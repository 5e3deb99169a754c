"""ray_tpu_torch.llm — continuous-batching LLM inference (port of
ray_tpu.llm):

  * llm/kv_cache.py   — paged KV pool + PrefixPool (hash-indexed,
                         ref-counted prefix cache with COW)
  * ops/paged_decode.py — decode attention through block tables, CUDA
                         kernels on the card (plain PyTorch on the CPU)
  * models/gpt.py     — forward_prefill / forward_decode /
                         forward_prefill_chunk
  * llm/engine.py     — Orca-style iteration-level scheduler
  * llm/sampling.py   — (seed, position)-keyed host sampling
"""

from .engine import (  # noqa: F401
    FINISHED,
    PREEMPTED,
    PREFILL,
    RUNNING,
    WAITING,
    LLMEngine,
    Request,
)
from .kv_cache import PagedKVCache, PrefixPool  # noqa: F401
from .sampling import sample  # noqa: F401
