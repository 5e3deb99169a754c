"""Deterministic token sampling for the generation engine (a copy of
ray_tpu/llm/sampling.py; the port imports nothing of the JAX package).

Sampling runs on the host (numpy) over a single token's logits row —
the device step ends at logits, so the engine can preempt/resume a
sequence and REPLAY its sampling exactly: the RNG for a draw is derived
from ``(seed, position)`` alone, never from how many times the engine
has stepped. That is what makes recompute-on-resume bit-identical, and
what lets speculative decoding (llm/spec.py) verify a proposal by
replaying the draw (``verify_tokens``).
"""

from __future__ import annotations

from typing import Optional

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


def verify_tokens(rows, proposed, *, temperature: float = 0.0,
                  top_k: int = 0, seed: int = 0, start_pos: int = 0):
    """Speculative verification against the target's keyed draws.

    ``rows`` holds the target logits for positions ``start_pos + j``
    (j = 0..len(proposed)), all scored in ONE verify forward; row j was
    computed with proposals 0..j-1 as input context. Because sample()
    is a pure function of (logits row, seed, position), the token the
    target WOULD emit at position start_pos + j is simply
    ``sample(rows[j], ..., position=start_pos + j)`` — so proposal j is
    accepted iff it equals that draw. The accepted prefix plus the
    first mismatching draw (or, when everything matched, the bonus draw
    from the last row) is EXACTLY the token-for-token output of
    sequential non-speculative decoding: the deterministic collapse of
    the Leviathan rejection rule under replayable keyed randomness
    (rejection_sample below is the stochastic primitive it collapses
    from). That exactness is what survives batch recomposition and
    preempt/resume unchanged.

    Returns ``(n_accepted, emitted)`` where ``emitted`` lists the
    accepted proposals followed by one corrected/bonus token
    (``len(emitted) == n_accepted + 1``; requires
    ``len(rows) >= len(proposed) + 1``).
    """
    proposed = [int(t) for t in proposed]
    if len(rows) < len(proposed) + 1:
        raise ValueError(
            f"need {len(proposed) + 1} logits rows to verify "
            f"{len(proposed)} proposals, got {len(rows)}")
    emitted = []
    n_accepted = 0
    for j, prop in enumerate(proposed):
        tok = sample(rows[j], temperature=temperature, top_k=top_k,
                     seed=seed, position=start_pos + j)
        if tok != prop:
            emitted.append(tok)          # the corrected draw
            return n_accepted, emitted
        n_accepted += 1
        emitted.append(tok)
    # Every proposal matched: the last row scores the position after
    # them — a free bonus token.
    emitted.append(sample(rows[len(proposed)], temperature=temperature,
                          top_k=top_k, seed=seed,
                          position=start_pos + len(proposed)))
    return n_accepted, emitted


def target_probs(logits, *, temperature: float = 0.0,
                 top_k: int = 0) -> np.ndarray:
    """The distribution sample() draws from, as an explicit [vocab]
    probability vector (greedy = a point mass at the argmax)."""
    logits = np.asarray(logits, np.float32)
    V = logits.shape[-1]
    if temperature <= 0.0 or top_k == 1:
        p = np.zeros(V, np.float32)
        p[int(logits.argmax())] = 1.0
        return p
    if top_k > 0 and top_k < V:
        kth = np.partition(logits, -top_k)[-top_k]
        logits = np.where(logits < kth, -np.inf, logits)
    z = (logits - logits.max()) / temperature
    p = np.exp(z)
    return p / p.sum()


def rejection_sample(target_p, draft_p, proposed: int, u: float,
                     resample_u: Optional[float] = None):
    """Textbook speculative rejection step (Leviathan et al., App. A).

    Accept the proposed token x with probability
    ``min(1, target_p[x] / draft_p[x])`` (``u`` is the uniform draw);
    on rejection, resample from the residual distribution
    ``normalize(max(target_p - draft_p, 0))`` by inverse CDF at
    ``resample_u``. Marginally the emitted token is distributed
    exactly per ``target_p`` — the property the unit tests check
    against hand-computed acceptance probabilities. The engine itself
    uses verify_tokens (the deterministic keyed collapse); this is the
    distribution-level primitive it inherits its correctness from.

    Returns ``(accepted: bool, token: int)``.
    """
    target_p = np.asarray(target_p, np.float64)
    draft_p = np.asarray(draft_p, np.float64)
    x = int(proposed)
    q = draft_p[x]
    if q <= 0.0:
        raise ValueError(f"proposed token {x} has draft probability 0")
    if u < min(1.0, target_p[x] / q):
        return True, x
    residual = np.maximum(target_p - draft_p, 0.0)
    tot = residual.sum()
    if tot <= 0.0:
        # target ⊆ draft everywhere it rejected — degenerate only when
        # the distributions coincide; emit the target's own draw.
        residual, tot = target_p, target_p.sum()
    residual = residual / tot
    if resample_u is None:
        resample_u = u
    cdf = np.cumsum(residual)
    return False, int(np.searchsorted(cdf, min(resample_u, cdf[-1] - 1e-12)))
