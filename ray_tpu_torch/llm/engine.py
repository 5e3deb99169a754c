"""Continuous-batching generation engine, iteration-level scheduling
(port of ray_tpu/llm/engine.py).

One engine owns the model params, the paged KV pool (llm/kv_cache.py)
and a step loop; requests stream tokens out through per-request queues,
so N serving threads share ONE device-resident batch.

Scheduling is per STEP, not per request: every step first admits
waiting requests into the in-flight batch (prefill), then runs ONE
decode token for every running sequence. A request that arrives
mid-generation joins the very next step.

Request lifecycle (every transition emits an event):

    WAITING --admit--> PREFILL --activate--> RUNNING --finish--> FINISHED
                          ^                     |
                          '----- PREEMPTED <----'  (pool exhausted)

Preemption is recompute-on-resume: the victim's blocks are freed (its
generated tokens are kept host-side) and on re-admission the engine
re-prefills prompt + generated-so-far. Sampling is keyed by
(seed, position) only (llm/sampling.py), so a resumed sequence produces
bit-identical output — admission beyond pool capacity degrades latency,
never correctness, and never runs out of memory.

Two admission-path optimizations (both on by default for serving):
PREFIX CACHING (``prefix_cache=True``: a PrefixPool whose released
blocks stay hash-indexed, so an equal prefix is re-acquired by refcount
bump instead of recomputed, with copy-on-write on a shared tail) and
CHUNKED PREFILL (``prefill_chunk_tokens=N``: at most N uncached prompt
tokens per step, so running decode streams emit a token every step).

The device work is the model's forwards (models/gpt.py) on
``device``; the decode step runs the paged decode kernel and a
whole-prompt prefill with ``cfg.use_flash`` the flash kernel. Decode
shapes are fixed (``[max_batch]`` lanes, ``[max_batch, max_nb]``
tables), so the step can later be captured as a CUDA graph.

Not ported yet (each listed in ROADMAP.md): speculative decoding
(``speculative`` must be None), the perfmodel step accounting, the
telemetry gauges and request tracing.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.gpt import (GPTConfig, forward_decode, forward_prefill,
                          forward_prefill_chunk, working_params)
from .kv_cache import PagedKVCache, PrefixPool
from .sampling import sample

# Request states (the event vocabulary).
WAITING = "WAITING"
PREFILL = "PREFILL"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"
FINISHED = "FINISHED"


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    stop_tokens: Tuple[int, ...] = ()
    state: str = WAITING
    block_table: List[int] = field(default_factory=list)
    context_len: int = 0          # tokens resident in the KV pool
    prefilled_upto: int = 0       # prompt tokens computed OR cache-hit
    cached_tokens: int = 0        # prefix-cache hit span at admission
    output: List[int] = field(default_factory=list)
    emitted: int = 0              # tokens already pushed to the consumer
    finish_reason: Optional[str] = None
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    preemptions: int = 0
    out_q: "queue.Queue" = field(default_factory=queue.Queue)

    def tokens(self):
        """Blocking generator over this request's output tokens."""
        while True:
            tok = self.out_q.get()
            if tok is None:
                return
            yield tok


class LLMEngine:
    """One model + one KV pool + one step scheduler.

    Thread-safe: add_request() may be called from any thread; step() is
    driven either by the background loop (start()) or manually (tests).
    ``params`` is the port's param dict (models/gpt.py ``init`` or
    models/convert.py); the engine keeps one working-dtype copy on
    ``device`` (``None`` means the card)."""

    def __init__(self, params, cfg: GPTConfig, *, num_blocks: int = 64,
                 block_size: int = 16, max_batch: int = 8,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefix_cache: bool = True,
                 speculative=None,
                 name: str = "llm", device=None):
        if speculative is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet (llm/spec.py)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.name = name
        self.max_batch = int(max_batch)
        pool_cls = PrefixPool if prefix_cache else PagedKVCache
        self.kv = pool_cls(cfg, num_blocks=num_blocks,
                           block_size=block_size, device=self.device)
        self._prefix = prefix_cache
        self.prefill_chunk_tokens = (None if prefill_chunk_tokens is None
                                     else int(prefill_chunk_tokens))
        self.params = working_params(params, cfg, self.device)
        self.max_nb = self.kv.blocks_for_tokens(cfg.max_seq)

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._waiting: Deque[Request] = collections.deque()
        self._active: List[Request] = []      # PREFILL/RUNNING, batch order
        self._requests: Dict[int, Request] = {}
        self._ids = itertools.count(1)
        self._events: Deque[tuple] = collections.deque(maxlen=4096)
        # (step_idx, (rid, ...)) per step — the in-flight composition.
        self.step_log: Deque[tuple] = collections.deque(maxlen=1024)
        self._steps = 0
        self._decode_steps = 0
        self._last_prefill_count = 0
        self._finished_count = 0
        self._token_times: Deque[tuple] = collections.deque()  # (t, n)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._prefill_chunks = 0      # chunk dispatches (whole=1 chunk)
        self._kv_util_peak = 0.0      # high-water pool utilization

    # -- events ------------------------------------------------------------

    def _event(self, req: Request, state: str):
        req.state = state
        self._events.append((time.time(), req.rid, state))

    def events(self) -> List[tuple]:
        return list(self._events)

    # -- submission --------------------------------------------------------

    def add_request(self, prompt: List[int], max_tokens: int = 16, *,
                    temperature: float = 0.0, top_k: int = 0,
                    seed: int = 0, stop_tokens=()) -> Request:
        """Validate + enqueue; returns the Request whose .tokens()
        generator streams the output. Raises if the request could never
        run (so pool exhaustion is always recoverable by preemption)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_tokens > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) "
                f"exceeds max_seq {self.cfg.max_seq}")
        need = self.kv.blocks_for_tokens(len(prompt) + max_tokens)
        if need > self.kv.capacity:
            raise ValueError(
                f"request needs {need} KV blocks; pool capacity is "
                f"{self.kv.capacity} — it could never be admitted")
        req = Request(rid=next(self._ids), prompt=prompt,
                      max_tokens=int(max_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      seed=int(seed),
                      stop_tokens=tuple(int(t) for t in stop_tokens),
                      submit_t=time.time())
        with self._cond:
            self._requests[req.rid] = req
            self._waiting.append(req)
            self._event(req, WAITING)
            self._cond.notify()
        return req

    # -- scheduler ---------------------------------------------------------

    def _admit(self):
        """Move waiting requests into the batch while blocks last.
        FIFO head-of-line: a request that doesn't fit blocks the ones
        behind it."""
        while self._waiting and len(self._active) < self.max_batch:
            req = self._waiting[0]
            seq = req.prompt + req.output
            if self._prefix:
                got = self.kv.admit(seq, len(seq) + 1)
                if got is None:
                    break
                grant, cached = got
                req.block_table = grant
                req.cached_tokens = cached
                if cached >= len(seq):
                    # Full hit: every token is already resident. Hold
                    # the LAST position back — the next decode step
                    # recomputes its logits via write-then-attend
                    # (COW-splitting the shared tail block first).
                    req.context_len = len(seq) - 1
                    req.prefilled_upto = len(seq)
                else:
                    # Cached spans are whole blocks, so the chunked
                    # prefill below resumes block-aligned at `cached`.
                    req.context_len = cached
                    req.prefilled_upto = cached
            else:
                grant = self.kv.alloc(
                    self.kv.blocks_for_tokens(len(seq) + 1))
                if grant is None:
                    break
                req.block_table = grant
                req.cached_tokens = 0
                req.context_len = 0
                req.prefilled_upto = 0
            self._waiting.popleft()
            self._active.append(req)
            self._event(req, PREFILL)

    def _activate(self, req: Request, logits_row):
        """Prefill done: sample the first (or first-since-resume) token
        and enter the decode batch. ``logits_row=None`` marks a FULL
        prefix-cache hit — the same step's decode samples it."""
        self._event(req, RUNNING)
        if logits_row is not None:
            self._sample_into(req, logits_row)

    def _release_blocks(self, req: Request):
        """Return req's blocks to the pool; with the prefix pool the
        resident span is registered first, so a resumed (or identical
        later) request re-acquires those blocks as cache hits."""
        if self._prefix:
            seq = (req.prompt + req.output)[:req.context_len]
            self.kv.release(req.block_table, seq=seq)
        else:
            self.kv.free(req.block_table)

    def _preempt(self, req: Request):
        """Evict req from the batch, release its blocks, requeue at the
        FRONT (resume priority beats fresh admissions)."""
        self._active.remove(req)
        self._release_blocks(req)
        req.block_table = []
        req.context_len = 0
        req.prefilled_upto = 0
        req.cached_tokens = 0
        req.preemptions += 1
        self._waiting.appendleft(req)
        self._event(req, PREEMPTED)

    def _finish(self, req: Request, reason: str):
        if req in self._active:
            self._active.remove(req)
        if req.block_table:
            self._release_blocks(req)
            req.block_table = []
        req.finish_reason = reason
        req.finish_t = time.time()
        self._finished_count += 1
        self._event(req, FINISHED)
        req.out_q.put(None)

    def _sample_into(self, req: Request, logits_row) -> bool:
        """Sample the next token at the request's current absolute
        position; emit it; apply stop conditions. Returns True if the
        request finished."""
        pos = len(req.prompt) + len(req.output)
        tok = sample(logits_row, temperature=req.temperature,
                     top_k=req.top_k, seed=req.seed, position=pos)
        return self._emit_token(req, tok)

    def _emit_token(self, req: Request, tok: int) -> bool:
        tok = int(tok)
        req.output.append(tok)
        now = time.time()
        if req.first_token_t is None:
            req.first_token_t = now
        self._token_times.append((now, 1))
        while req.emitted < len(req.output):
            req.out_q.put(req.output[req.emitted])
            req.emitted += 1
        if tok in req.stop_tokens:
            self._finish(req, "stop")
            return True
        if len(req.output) >= req.max_tokens:
            self._finish(req, "length")
            return True
        return False

    def _tensor(self, arr) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device, non_blocking=True)

    def _run_prefills(self):
        """Prefill newly admitted requests one sequence at a time
        (prompt lengths are ragged, padded to a block multiple). The
        prefix-cached span was skipped at admission; with
        ``prefill_chunk_tokens`` set at most that many uncached tokens
        run per STEP across all prefilling requests."""
        prefills = [r for r in self._active if r.state == PREFILL]
        self._last_prefill_count = len(prefills)
        bs = self.kv.block_size
        budget = self.prefill_chunk_tokens
        for req in prefills:
            seq = req.prompt + req.output
            T = len(seq)
            if req.prefilled_upto >= T:
                # Full prefix-cache hit: zero prefill compute.
                self._activate(req, None)
                continue
            if budget is not None and budget <= 0:
                break       # out of chunk budget; cursor resumes next step
            upto = req.prefilled_upto
            rem = T - upto
            c = rem if budget is None else min(rem, budget)
            if c < rem:
                # Mid-prompt chunks stay block-aligned (write_prefill
                # writes whole blocks); a budget below one block still
                # makes one block of progress.
                c = (c // bs) * bs or min(bs, rem)
            if budget is not None:
                budget -= c
            pad = -c % bs or 0
            if upto == 0 and c == T:
                # Cold whole-prompt prefill: the classic one-shot path.
                toks = np.zeros((1, T + pad), np.int32)
                toks[0, :T] = seq
                logits, k, v = forward_prefill(
                    self.params, self._tensor(toks), self.cfg)
            else:
                # Incremental span [upto, upto+c) attending resident
                # context (earlier chunks and/or prefix-cache hits).
                toks = np.zeros((1, c + pad), np.int32)
                toks[0, :c] = seq[upto:upto + c]
                positions = np.minimum(
                    upto + np.arange(c + pad, dtype=np.int32),
                    self.cfg.max_seq - 1)
                table = np.zeros((self.max_nb,), np.int32)
                table[:len(req.block_table)] = req.block_table
                logits, k, v = forward_prefill_chunk(
                    self.params, self._tensor(toks),
                    self._tensor(positions), self.kv.k, self.kv.v,
                    self._tensor(table), upto, self.cfg)
            # Export the chunk's cache: [L, 1, c, Hkv, d] -> pool blocks
            # upto/bs onward (upto is block-aligned by construction).
            self.kv.write_prefill(
                k[:, 0, :c], v[:, 0, :c],
                req.block_table[upto // bs: upto // bs + (c + pad) // bs])
            req.prefilled_upto = upto + c
            req.context_len = req.prefilled_upto
            self._prefill_chunks += 1
            if req.prefilled_upto >= T:
                # The host sync: the last prompt position's logits row.
                row = logits[0, c - 1].float().cpu().numpy()
                if self._prefix:
                    # Index the prompt's chunks for later arrivals.
                    self.kv.register(seq, req.block_table)
                self._activate(req, row)

    def _preempt_for(self, req: Request) -> bool:
        """Free pool blocks by preempting a LIFO victim; req itself is
        the last resort (returns False then — req left the batch)."""
        victims = [r for r in self._active
                   if r.state == RUNNING and r is not req]
        if victims:
            self._preempt(victims[-1])
            return True
        self._preempt(req)
        return False

    def _ensure_slots(self, req: Request, n: int = 1) -> bool:
        """Guarantee req's next ``n`` tokens have WRITABLE pool slots,
        preempting LIFO victims if the pool is dry. With the prefix
        pool each touched block must also be private (COW-split first).
        Returns False if req itself was preempted."""
        bs = self.kv.block_size
        for j in range(n):
            slot = req.context_len + j
            bi = slot // bs
            while True:
                if bi >= len(req.block_table):
                    grant = self.kv.alloc(1)
                    if grant is None:
                        if not self._preempt_for(req):
                            return False
                        continue
                    req.block_table.extend(grant)
                if self._prefix:
                    bid = req.block_table[bi]
                    if self.kv.needs_cow(bid, slot % bs):
                        nb = self.kv.cow(bid)
                        if nb is None:
                            if not self._preempt_for(req):
                                return False
                            continue
                        req.block_table[bi] = nb
                break
        return True

    def _run_decode(self):
        batch = [r for r in self._active if r.state == RUNNING]
        for req in list(batch):
            if req.state == RUNNING:
                self._ensure_slots(req, 1)
        # An ensure call may have preempted requests anywhere in the
        # batch (LIFO victims) — only still-RUNNING sequences decode.
        batch = [r for r in batch if r.state == RUNNING]
        if not batch:
            return
        B = self.max_batch
        bs = self.kv.block_size
        tokens = np.zeros((B,), np.int32)
        positions = np.zeros((B,), np.int32)
        slot_blocks = np.zeros((B,), np.int32)
        slot_offsets = np.zeros((B,), np.int32)
        # Padded lanes: scratch block 0, context 1 — their logits are
        # never sampled.
        context_lens = np.ones((B,), np.int32)
        tables = np.zeros((B, self.max_nb), np.int32)
        for i, req in enumerate(batch):
            slot = req.context_len
            # Steady-state lanes feed their last sampled token; a FULL
            # prefix-cache hit re-feeds its held-back last position.
            tokens[i] = (req.prompt[slot] if slot < len(req.prompt)
                         else req.output[slot - len(req.prompt)])
            positions[i] = slot
            slot_blocks[i] = req.block_table[slot // bs]
            slot_offsets[i] = slot % bs
            context_lens[i] = slot + 1
            tables[i, :len(req.block_table)] = req.block_table
        logits, _, _ = forward_decode(
            self.params, self._tensor(tokens), self._tensor(positions),
            self.kv.k, self.kv.v, self._tensor(tables),
            self._tensor(context_lens), self._tensor(slot_blocks),
            self._tensor(slot_offsets), self.cfg)
        self._decode_steps += 1
        # The host sync: the live lanes' logits rows.
        rows = logits[:len(batch)].float().cpu().numpy()
        for i, req in enumerate(batch):
            req.context_len += 1
            self._sample_into(req, rows[i])

    def step(self) -> int:
        """One scheduler iteration: admit -> prefill -> decode one token
        for every running sequence. Returns the number of in-flight
        sequences after the step."""
        with self._lock:
            self._admit()
            # High-water utilization INSIDE the step (post-admission and
            # post-decode, before finishes drain it).
            util_hw = self.kv.utilization()
            self._run_prefills()
            self._run_decode()
            self._kv_util_peak = max(self._kv_util_peak, util_hw,
                                     self.kv.utilization())
            self._steps += 1
            self.step_log.append(
                (self._steps, tuple(r.rid for r in self._active)))
            return len(self._active)

    # -- introspection -----------------------------------------------------

    def tokens_per_s(self, window: float = 5.0) -> float:
        now = time.time()
        while self._token_times and self._token_times[0][0] < now - window:
            self._token_times.popleft()
        if not self._token_times:
            return 0.0
        span = max(now - self._token_times[0][0], 1e-3)
        return sum(n for _, n in self._token_times) / span

    def stats(self) -> dict:
        out = {
            "steps": self._steps,
            "decode_steps": self._decode_steps,
            "waiting": len(self._waiting),
            "in_flight": len(self._active),
            "finished": self._finished_count,
            "kv_utilization": self.kv.utilization(),
            "kv_util_peak": self._kv_util_peak,
            "kv_free_blocks": self.kv.num_free,
            "tokens_per_s": self.tokens_per_s(),
            "prefill_chunks": self._prefill_chunks,
        }
        if self._prefix:
            ps = self.kv.prefix_stats()
            out["kv_cache_hit_rate"] = ps["hit_rate"]
            out["kv_shared_blocks"] = ps["shared_blocks"]
            out["prefix"] = ps
        return out

    # -- background loop ---------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"llm-engine-{self.name}")
        self._thread.start()

    def _loop(self):
        while True:
            with self._cond:
                while not self._stop and not self._waiting \
                        and not self._active:
                    self._cond.wait(timeout=0.5)
                if self._stop:
                    return
            self.step()

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # Release any parked consumers.
        with self._lock:
            for req in list(self._active) + list(self._waiting):
                self._finish(req, "aborted")
            self._waiting.clear()
