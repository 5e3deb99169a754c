"""Speculative decoding: proposers + lifecycle accounting (port of
ray_tpu/llm/spec.py).

Reference layer map: the draft-then-verify scheme of Leviathan et al.
("Fast Inference from Transformers via Speculative Decoding") and the
model-free self-speculation of lookahead/prompt-lookup decoding. The
engine emits exactly one token per scheduler step per sequence; a
proposer guesses the next k tokens for (almost) free and ONE verify
forward (models/gpt.py forward_verify, k+1 query rows per sequence
through the paged kernel pair's verify route, ops/paged_decode.py
``paged_verify_attention``) scores them all. The
accepted prefix plus one corrected/bonus token land in a single step —
decode throughput multiplies by the acceptance rate without changing a
single output token.

Exactness: the engine's sampler is keyed by (seed, position) alone
(llm/sampling.py), so the target's draw at every position is a pure
function of the logits row. Verification (sampling.verify_tokens)
accepts a proposal iff it EQUALS that keyed draw — the deterministic
collapse of the Leviathan rejection rule when the proposal distribution
is a point mass and the target draw is replayable. Output is therefore
bit-identical to non-speculative decoding, including across batch
recomposition and preempt/resume (the same property that makes
recompute-on-resume exact). The stochastic primitive itself
(sampling.rejection_sample) is kept for distribution-level tests.

Two proposers ship:

  * ``NgramProposer`` — suffix-match the sequence's own prompt+output
    history and replay the continuation after the most recent earlier
    occurrence (prompt-lookup decoding). Zero model cost; wins on
    repetitive text: summarization quoting its source, multi-turn
    prompts, and greedy decode loops.
  * ``DraftProposer`` — a small GPT run greedily for k tokens (full
    re-forward per token, the port's ``forward`` under no grad on the
    engine's device; a draft this small keeps no KV cache). Wins
    when the text is not self-similar but a cheap model still predicts
    the big one well. Defaults to self-drafting with the target's own
    params (exact for greedy targets, a real proposer for sampled ones).

Lifecycle (every transition emits into ``events``):

    PROPOSE -> VERIFY -> ACCEPT -> ROLLBACK(rejected slots freed)
"""

from __future__ import annotations

import collections
import dataclasses
import time
from dataclasses import dataclass
from typing import Deque, List, Optional, Sequence

import torch

from .._device import resolve_device


class Proposer:
    """Pluggable draft-token source: given the sequence's full token
    history (prompt + output so far), guess up to ``k`` next tokens."""

    name = "base"

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class NgramProposer(Proposer):
    """Prompt-lookup / self-speculation: match the last n tokens
    (longest n in [min_ngram, max_ngram] first) against an earlier
    occurrence in the history and propose what followed it, preferring
    the MOST RECENT match (greedy loops repeat their latest cycle)."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def _match_once(self, toks: List[int], k: int) -> List[int]:
        T = len(toks)
        if k <= 0 or T < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, T - 1), self.min_ngram - 1, -1):
            suffix = toks[T - n:]
            for i in range(T - n - 1, -1, -1):
                if toks[i:i + n] == suffix:
                    cont = toks[i + n:i + n + k]
                    if cont:
                        return cont
        return []

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = list(tokens)
        out: List[int] = []
        # Self-extension: re-match on the speculatively extended
        # sequence until k tokens are filled. The most-recent match in
        # a periodic run sits right at the end of history, so a single
        # match yields only the tail of the cycle — iterating replays
        # whole cycles and fills the full k-token budget.
        while len(out) < k:
            nxt = self._match_once(toks, k - len(out))
            if not nxt:
                break
            out.extend(nxt)
            toks.extend(nxt)
        return out[:k]


class DraftProposer(Proposer):
    """Small-draft speculation: run a (tiny) GPT greedily for k tokens.

    The draft keeps no KV cache — each proposed token re-forwards the
    whole sequence, padded to a power-of-two bucket (at most
    log2(max_seq) shapes). That is only viable because the draft is
    small; the verify pass against the TARGET model is what makes the
    output exact regardless of draft quality. The forward is the port's
    ``forward`` (models/gpt.py) under no grad, on ``device`` (``None``
    means the card): with ``cfg.use_flash`` on the card its attention is
    the primal flash kernel."""

    name = "draft"

    def __init__(self, params, cfg, device=None):
        from ..models.gpt import working_params

        self.device = resolve_device(device)
        # No grad flows here, so remat would only cost time.
        self.cfg = dataclasses.replace(cfg, remat=False)
        # The working-dtype copy on the device; the target's own working
        # params (self-drafting) come through without a copy.
        self.params = working_params(params, cfg, self.device)

    @torch.no_grad()
    def _greedy_next(self, toks: List[int]) -> int:
        """One greedy draft token: pad-to-bucket forward, argmax on the
        device, one scalar pulled to the host."""
        from ..models.gpt import forward

        T = len(toks)
        pad_to = max(8, 1 << (T - 1).bit_length())
        pad_to = min(pad_to, self.cfg.max_seq)
        arr = torch.zeros((1, pad_to), dtype=torch.int32)
        arr[0, :T] = torch.tensor(toks, dtype=torch.int32)
        logits = forward(self.params, arr.to(self.device), self.cfg)
        return int(logits[0, T - 1].argmax())

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = list(tokens)
        out: List[int] = []
        for _ in range(max(0, k)):
            if len(toks) >= self.cfg.max_seq:
                break
            nxt = self._greedy_next(toks)
            out.append(nxt)
            toks.append(nxt)
        return out


@dataclass(frozen=True)
class SpecConfig:
    """Engine-facing speculative-decode knobs (serve/llm.py surfaces
    these as the ``speculative`` dict)."""

    mode: str = "ngram"          # "ngram" | "draft"
    k: int = 4                   # proposed tokens per verify step
    ngram_max: int = 3
    ngram_min: int = 1
    draft_params: Optional[object] = None   # None => target params
    draft_cfg: Optional[object] = None      # None => target cfg


def resolve_spec_config(speculative) -> Optional[SpecConfig]:
    """None | dict | SpecConfig -> SpecConfig (None stays None — the
    engine then keeps the plain one-token decode path, zero overhead)."""
    if speculative is None:
        return None
    if isinstance(speculative, SpecConfig):
        cfg = speculative
    elif isinstance(speculative, dict):
        allowed = {"mode", "k", "ngram_max", "ngram_min",
                   "draft_params", "draft_cfg"}
        bad = set(speculative) - allowed
        if bad:
            raise ValueError(f"unknown speculative knobs: {sorted(bad)}; "
                             f"allowed: {sorted(allowed)}")
        cfg = SpecConfig(**speculative)
    else:
        raise TypeError(f"speculative must be None/dict/SpecConfig, "
                        f"got {type(speculative).__name__}")
    if cfg.mode not in ("ngram", "draft"):
        raise ValueError(f"speculative mode {cfg.mode!r}; "
                         f"valid: 'ngram', 'draft'")
    if cfg.k < 1:
        raise ValueError("speculative k must be >= 1")
    return cfg


class SpecDecoder:
    """Per-engine speculative-decode state: the proposer, the
    PROPOSE/VERIFY/ACCEPT/ROLLBACK event ring, and the accounting the
    telemetry plane publishes (accept rate, emitted tokens per verify
    step). The engine owns scheduling; this class owns lifecycle."""

    def __init__(self, cfg: SpecConfig, proposer: Proposer):
        self.cfg = cfg
        self.k = int(cfg.k)
        self.proposer = proposer
        self.events: Deque[tuple] = collections.deque(maxlen=4096)
        self.proposed = 0            # proposal tokens submitted to verify
        self.accepted = 0            # proposal tokens accepted
        self.emitted = 0             # output tokens from verify steps
        self.verify_steps = 0        # verify dispatches (batched)
        self.verified_lanes = 0      # per-sequence verifications
        self.rolled_back = 0         # rejected+padding slots rolled back

    def _event(self, kind: str, **attrs) -> None:
        self.events.append((time.time(), kind, attrs))

    # -- lifecycle (each site emits through _event) -----------------------

    def propose(self, rid: int, tokens: Sequence[int],
                budget: int) -> List[int]:
        """Up to min(k, budget) draft tokens for one sequence."""
        n = min(self.k, int(budget))
        props = self.proposer.propose(tokens, n) if n > 0 else []
        if len(props) > n:
            props = props[:n]
        self.proposed += len(props)
        self._event("propose", rid=rid, n=len(props),
                    proposer=self.proposer.name)
        return props

    def verify(self, rid: int, n_proposed: int) -> None:
        """One sequence entering the batched verify forward."""
        self.verified_lanes += 1
        self._event("verify", rid=rid, n=n_proposed)

    def accept(self, rid: int, n_accepted: int, n_proposed: int,
               n_emitted: int) -> None:
        """Verification outcome for one sequence: ``n_accepted`` of
        ``n_proposed`` proposals matched the target's keyed draws and
        ``n_emitted`` tokens (accepted + corrected/bonus) went out."""
        self.accepted += n_accepted
        self.emitted += n_emitted
        self._event("accept", rid=rid, accepted=n_accepted,
                    proposed=n_proposed, emitted=n_emitted)

    def rollback(self, rid: int, n_rejected: int,
                 freed_blocks: int) -> None:
        """Rejected (and padding) speculative KV slots discarded; any
        surplus pool blocks were returned via kv.truncate()."""
        self.rolled_back += n_rejected
        self._event("rollback", rid=rid, rejected=n_rejected,
                    freed_blocks=freed_blocks)

    # -- accounting --------------------------------------------------------

    def accept_rate(self) -> float:
        return self.accepted / max(1, self.proposed)

    def tokens_per_step(self) -> float:
        """Mean output tokens per verify step per lane (1.0 = no better
        than plain decode; up to k+1)."""
        return self.emitted / max(1, self.verified_lanes)

    def stats(self) -> dict:
        return {
            "mode": self.cfg.mode,
            "k": self.k,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "emitted": self.emitted,
            "verify_steps": self.verify_steps,
            "rolled_back": self.rolled_back,
            "accept_rate": self.accept_rate(),
            "tokens_per_step": self.tokens_per_step(),
        }


def make_spec(speculative, *, target_params, target_cfg,
              device=None) -> Optional[SpecDecoder]:
    """Build the engine's SpecDecoder (or None when disabled); a draft
    proposer runs on ``device`` (the engine's)."""
    cfg = resolve_spec_config(speculative)
    if cfg is None:
        return None
    if cfg.mode == "ngram":
        proposer: Proposer = NgramProposer(max_ngram=cfg.ngram_max,
                                           min_ngram=cfg.ngram_min)
    else:
        d_params = cfg.draft_params if cfg.draft_params is not None \
            else target_params
        d_cfg = cfg.draft_cfg if cfg.draft_cfg is not None else target_cfg
        if d_cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab {d_cfg.vocab_size} != target vocab "
                f"{target_cfg.vocab_size} — proposals would be "
                f"untranslatable token ids")
        proposer = DraftProposer(d_params, d_cfg, device=device)
    return SpecDecoder(cfg, proposer)
