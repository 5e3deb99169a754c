"""ray_tpu_torch.llm — continuous-batching LLM inference (port of
ray_tpu.llm):

  * llm/kv_cache.py   — paged KV pool + PrefixPool (hash-indexed,
                         ref-counted prefix cache with COW)
  * ops/paged_decode.py — decode attention through block tables, CUDA
                         kernels on the card (plain PyTorch on the CPU)
  * models/gpt.py     — forward_prefill / forward_decode /
                         forward_prefill_chunk / forward_verify
  * llm/engine.py     — Orca-style iteration-level scheduler, each step
                         priced by util/perfmodel.py
  * llm/spec.py       — speculative decoding (n-gram / small-draft
                         proposers verified in one paged-attention
                         pass; output bit-identical either way)
  * llm/sampling.py   — (seed, position)-keyed host sampling and the
                         verify samplers
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
from .sampling import rejection_sample, sample, verify_tokens  # noqa: F401
from .spec import (  # noqa: F401
    DraftProposer,
    NgramProposer,
    Proposer,
    SpecConfig,
    SpecDecoder,
)
