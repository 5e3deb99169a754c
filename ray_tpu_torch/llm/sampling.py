"""Deterministic token sampling for the generation engine (a copy of
``sample`` in ray_tpu/llm/sampling.py; the port imports nothing of the
JAX package).

Sampling runs on the host (numpy) over a single token's logits row —
the device step ends at logits, so the engine can preempt/resume a
sequence and REPLAY its sampling exactly: the RNG for a draw is derived
from ``(seed, position)`` alone, never from how many times the engine
has stepped. That is what makes recompute-on-resume bit-identical. The
speculative helpers come with the port of llm/spec.py.
"""

from __future__ import annotations

import numpy as np


def sample(logits, *, temperature: float = 0.0, top_k: int = 0,
           seed: int = 0, position: int = 0) -> int:
    """Draw one token id from a [vocab] logits row.

    temperature 0 (or top_k 1) is greedy argmax. Otherwise softmax at
    ``temperature`` over the ``top_k`` largest logits (0 = all), drawn
    with an RNG keyed by (seed, position) only — see module docstring.
    """
    logits = np.asarray(logits, np.float32)
    if temperature <= 0.0 or top_k == 1:
        return int(logits.argmax())
    if top_k > 0 and top_k < logits.shape[-1]:
        kth = np.partition(logits, -top_k)[-top_k]
        logits = np.where(logits < kth, -np.inf, logits)
    z = (logits - logits.max()) / temperature
    p = np.exp(z)
    p /= p.sum()
    rng = np.random.default_rng((seed * 1000003 + position) & 0xFFFFFFFF)
    return int(rng.choice(logits.shape[-1], p=p))
