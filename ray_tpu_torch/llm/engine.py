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

And one decode-path optimization (opt-in, ``speculative=...``):
SPECULATIVE DECODING (llm/spec.py) — a proposer guesses up to k next
tokens per sequence and ONE verify forward (models/gpt.py
``forward_verify``) scores k+1 positions per lane through the paged
kernel pair's verify route; the accepted prefix plus one corrected/bonus
token emit in a single step. Because sampling is keyed by (seed,
position) alone, acceptance is an equality check against the replayed
keyed draw — the output token stream is bit-identical to
non-speculative decoding, preemption and all.

The device work is the model's forwards (models/gpt.py) on
``device``; the decode step runs the paged decode kernel, the verify
step its verify route, and a whole-prompt prefill with ``cfg.use_flash``
the flash kernel. Decode and verify shapes are fixed (``[max_batch]``
or ``[max_batch, k+1]`` rows, ``[max_batch, max_nb]`` tables), so the
step can later be captured as a CUDA graph.

Every step is priced by the cost model (util/perfmodel.py): each
forward's span and its FLOPs and HBM bytes go into a
``StepAccounting``, whose breakdown is ``stats()["last_step"]``. On the
CPU the span is the host clock around the forward, which is its compute
time: the breakdown is the reference's (step, device and host ms, MFU,
HBM utilization, roofline verdict, the peak entry). On the card the
span is CUDA events around the forward's enqueue: from its first kernel
being queued to its last one's end, which on a host-bound step is the
host's dispatch time, not the card's busy time. So there the breakdown
gives it as ``dispatch_to_ready_ms`` with the step's FLOPs and HBM
bytes, and ``device_ms``, ``mfu``, ``hbm_util`` and ``verdict`` are
None: nothing here measures the card's busy time yet.

Not ported yet (ROADMAP.md Queue 1 item 7): the telemetry gauges and
the request-tracing spans.
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
                          forward_prefill_chunk, forward_verify,
                          working_params)
from ..util import perfmodel
from .kv_cache import PagedKVCache, PrefixPool
from .sampling import sample, verify_tokens
from .spec import make_spec

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
    ``device`` (``None`` means the card, resolved before anything else
    is built, a draft proposer included)."""

    def __init__(self, params, cfg: GPTConfig, *, num_blocks: int = 64,
                 block_size: int = 16, max_batch: int = 8,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefix_cache: bool = True,
                 speculative=None,
                 name: str = "llm", device=None):
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
        # Speculative decoding (llm/spec.py): when enabled, decode runs
        # through ONE verify forward scoring k+1 positions per lane
        # (fixed q shape) and the accepted prefix + one corrected/bonus
        # token all land in a single step. None keeps the plain
        # one-token decode path.
        self._spec = make_spec(speculative, target_params=self.params,
                               target_cfg=cfg, device=self.device)

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
        # Device-step accounting: every forward's span and cost, priced
        # by the cost model (util/perfmodel.py); on the card the spans are
        # dispatch-to-ready, not busy time (module docstring). ``_spans``
        # holds this step's (start, end, cost) until the step closes.
        self._step_perf = perfmodel.StepAccounting(
            perfmodel.detect_hardware(self.device),
            busy_spans=self.device.type != "cuda")
        self._spans: List[tuple] = []

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

    def _device_call(self, cost: perfmodel.StepCost, fn, *args):
        """Run one forward and charge its span and ``cost`` to the step.
        On the card: CUDA events recorded on the current stream around
        the forward, read when the step closes (after the logits' host
        copy, which waits for them anyway); no synchronize per layer.
        The first event fires as soon as the stream reaches it, so the
        span is dispatch-to-ready. On the CPU: the host clock around the
        call."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self._spans.append((start, end, cost))
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            self._spans.append((time.perf_counter() - t0, None, cost))
        return out

    def _charge_device(self):
        """Fold this step's device spans into its accounting."""
        for start, end, cost in self._spans:
            if end is None:          # the CPU: seconds on the host clock
                seconds = start
            else:
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            self._step_perf.add_device(seconds, cost)
        self._spans.clear()

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
            # Only the UNCACHED span is priced: ctx_tokens covers what was
            # skipped or ran in earlier chunks, keeping MFU honest.
            cost = perfmodel.prefill_cost(self.cfg, c + pad, ctx_tokens=upto)
            if upto == 0 and c == T:
                # Cold whole-prompt prefill: the classic one-shot path.
                toks = np.zeros((1, T + pad), np.int32)
                toks[0, :T] = seq
                logits, k, v = self._device_call(
                    cost, forward_prefill, self.params, self._tensor(toks),
                    self.cfg)
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
                logits, k, v = self._device_call(
                    cost, forward_prefill_chunk, self.params,
                    self._tensor(toks), self._tensor(positions), self.kv.k,
                    self.kv.v, self._tensor(table), upto, self.cfg)
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
        cost = perfmodel.decode_step_cost(
            self.cfg, [r.context_len + 1 for r in batch])
        logits, _, _ = self._device_call(
            cost, forward_decode, self.params, self._tensor(tokens),
            self._tensor(positions), self.kv.k, self.kv.v,
            self._tensor(tables), self._tensor(context_lens),
            self._tensor(slot_blocks), self._tensor(slot_offsets), self.cfg)
        self._decode_steps += 1
        # The host sync: the live lanes' logits rows.
        rows = logits[:len(batch)].float().cpu().numpy()
        for i, req in enumerate(batch):
            req.context_len += 1
            self._sample_into(req, rows[i])
        # The reference's per-request decode-step spans (tracing.emit)
        # come with the port of util/tracing.py (ROADMAP.md Queue 1
        # item 7).

    def _run_verify(self):
        """Speculative decode step: propose up to k tokens per lane,
        write current + proposals into their pool slots, and score all
        q = k+1 positions in ONE batched forward through the paged
        kernel pair's verify route (models/gpt.py forward_verify).
        verify_tokens then accepts the longest proposal prefix matching
        the target's keyed draws and emits one corrected/bonus token —
        several output tokens per step at exactly the non-speculative
        token stream. Rejected slots are rolled back with kv.truncate();
        the [max_batch, k+1] shapes are fixed, lanes with fewer live rows
        padding onto scratch block 0 exactly like padded decode lanes."""
        batch = [r for r in self._active if r.state == RUNNING]
        if not batch:
            return
        spec = self._spec
        props: Dict[int, List[int]] = {}
        for req in batch:
            # Proposal budget: never past max_tokens (the final token
            # is sampled, not proposed), never past the block span the
            # admission check guaranteed, never past max_seq positions.
            budget = min(
                req.max_tokens - len(req.output) - 1,
                len(req.prompt) + req.max_tokens - req.context_len - 1,
                self.cfg.max_seq - req.context_len - 1)
            props[req.rid] = spec.propose(
                req.rid, req.prompt + req.output, budget)
        for req in list(batch):
            if req.state == RUNNING:
                self._ensure_slots(req, 1 + len(props[req.rid]))
        batch = [r for r in batch if r.state == RUNNING]
        if not batch:
            return
        B = self.max_batch
        Q = spec.k + 1
        bs = self.kv.block_size
        tokens = np.zeros((B, Q), np.int32)
        positions = np.zeros((B, Q), np.int32)
        slot_blocks = np.zeros((B, Q), np.int32)
        slot_offsets = np.zeros((B, Q), np.int32)
        context_lens = np.ones((B,), np.int32)
        q_lens = np.ones((B,), np.int32)
        tables = np.zeros((B, self.max_nb), np.int32)
        for i, req in enumerate(batch):
            slot = req.context_len
            p = props[req.rid]
            n = 1 + len(p)
            # Row 0 feeds the last sampled token (a FULL prefix-cache
            # hit re-feeds its held-back last position — the verify
            # fast start: its FIRST step already carries proposals);
            # rows 1..n-1 feed the proposals. Rows n..Q-1 are padding:
            # scratch block 0, positions clipped in range — their
            # logits are garbage and never read (q_lens masks them in
            # the kernel and the host loop stops at n).
            tokens[i, 0] = (req.prompt[slot] if slot < len(req.prompt)
                            else req.output[slot - len(req.prompt)])
            tokens[i, 1:n] = p
            positions[i] = np.minimum(slot + np.arange(Q, dtype=np.int32),
                                      self.cfg.max_seq - 1)
            # A lane's rows may span two blocks: each row's block comes
            # from its own slot.
            for j in range(n):
                slot_blocks[i, j] = req.block_table[(slot + j) // bs]
                slot_offsets[i, j] = (slot + j) % bs
            context_lens[i] = slot + n
            q_lens[i] = n
            tables[i, :len(req.block_table)] = req.block_table
            spec.verify(req.rid, len(p))
        spec.verify_steps += 1
        # Verify pricing is honest about speculation's bet: k+1 rows of
        # FLOPs are burned regardless of how many tokens are accepted.
        cost = perfmodel.verify_step_cost(
            self.cfg, [int(context_lens[i]) for i in range(len(batch))],
            [int(q_lens[i]) for i in range(len(batch))])
        logits, _, _ = self._device_call(
            cost, forward_verify, self.params, self._tensor(tokens),
            self._tensor(positions), self.kv.k, self.kv.v,
            self._tensor(tables), self._tensor(context_lens),
            self._tensor(q_lens), self._tensor(slot_blocks),
            self._tensor(slot_offsets), self.cfg)
        # The host sync: the live lanes' logits rows.
        rows = logits[:len(batch)].float().cpu().numpy()
        for i, req in enumerate(batch):
            p = props[req.rid]
            n = 1 + len(p)
            slot = req.context_len
            start_pos = len(req.prompt) + len(req.output)
            n_acc, emitted = verify_tokens(
                rows[i, :n], p, temperature=req.temperature,
                top_k=req.top_k, seed=req.seed, start_pos=start_pos)
            spec.accept(req.rid, n_acc, len(p), len(emitted))
            for idx, tok in enumerate(emitted):
                # Bookkeeping BEFORE emitting: an accepted token IS
                # resident (its slot was written this step), the final
                # corrected/bonus token is NOT (its draw replaced a
                # rejected row / was never written) — so a mid-stream
                # finish registers exactly the resident span.
                if idx < n_acc:
                    req.context_len = slot + 2 + idx
                else:
                    req.context_len = slot + 1 + n_acc
                if self._emit_token(req, tok):
                    break
            n_rej = len(p) - n_acc
            if n_rej:
                # Rejected slots past the accept cursor: any whole
                # blocks they spilled into go back to the pool (a
                # finished lane already released everything).
                freed = (self.kv.truncate(req.block_table,
                                          req.context_len)
                         if req.block_table else [])
                spec.rollback(req.rid, n_rej, len(freed))
        # The reference's per-request decode-step spans (tracing.emit)
        # come with the port of util/tracing.py (ROADMAP.md Queue 1
        # item 7).

    def step(self) -> int:
        """One scheduler iteration: admit -> prefill -> decode one token
        for every running sequence (with speculation on, the decode is
        a verify step that may emit several). Returns the number of
        in-flight sequences after the step."""
        with self._lock:
            self._step_perf.begin()
            self._admit()
            # High-water utilization INSIDE the step (post-admission and
            # post-decode, before finishes drain it).
            util_hw = self.kv.utilization()
            self._run_prefills()
            if self._spec is not None:
                self._run_verify()
            else:
                self._run_decode()
            self._kv_util_peak = max(self._kv_util_peak, util_hw,
                                     self.kv.utilization())
            self._steps += 1
            # Close the step's accounting (None on a no-work step) into
            # the process-local device-step ring.
            self._charge_device()
            self._step_perf.finish(
                record_as="llm.step",
                attrs={"deployment": self.name, "step": self._steps})
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
        if self._spec is not None:
            ss = self._spec.stats()
            out["spec_accept_rate"] = ss["accept_rate"]
            out["spec_tokens_per_step"] = ss["tokens_per_step"]
            out["spec"] = ss
        if self._step_perf.last is not None:
            out["last_step"] = dict(self._step_perf.last)
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
