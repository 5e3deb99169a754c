"""Drive the PyTorch port's LLM serving and training paths on one
NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout of the repository and needs one CUDA
card, ``nvcc`` (the kernels are built from ray_tpu_torch/ops/csrc at
first use) and nothing of JAX: it imports ``ray_tpu_torch`` only.
Phases, each asserting what it checks (any failure exits non-zero):

  1. card and build: the card's name and power limit, TF32 off, the
     kernels built with nvcc for sm_90a;
  2. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, bf16 and f32, timed with CUDA events beside
     its bound (and, for flash, beside scaled_dot_product_attention);
     every CUDA-event time holds the stream with a spin kernel while the
     host enqueues the call, so it is the call's device time; the paged
     pair (paged_decode_split_kernel, then paged_decode_combine_kernel)
     also by a profiler trace (each kernel, and the pair's span), at
     other block sizes, head dims and groups, verify, and the edge cases
     (a padded lane on the scratch block, contexts at and one past a
     128-key chunk, a full table, verify with q_lens < q_len and rows
     whose bound ends a chunk early, verify at the speculative engine's
     shape: b 8, 12 kv heads, group 1, 5 rows a lane, with short and
     padded lanes), its output bitwise equal over two calls (decode and
     verify, both dtypes); the flash
     forward also at other layouts, GQA, dense, sq != sk and head dims
     16-128 (48 and 80: the bf16 kernel's padded TMA boxes), causal
     sq > sk, in both dtypes, and a profiler trace shows bf16 launching
     the Hopper kernel (flash_fwd_wgmma_kernel) and f32 the CUDA-core
     one;
  3. slice parity: GPT-2-small f32 prefill + 4 decode steps on the card
     (kernels) against the CPU (plain versions);
  4. serving, engine defaults: GPT-2-small bf16 with use_flash,
     whole-prompt prefill, prefix cache, 8 threaded requests; the launch
     counters show the path went through both kernels, the profiled
     prefill's trace that its forward was the Hopper kernel, and the
     profiled decode steps' trace the paged split and combine kernels
     once per layer a step and paged_attention_kernel never;
  5. serving, handler defaults: LLMServer (chunked prefill, prefix
     cache, a shared system prompt) streaming frames to ``done``; then
     its engine, stepped by hand, profiles one decode step: the paged
     pair once per layer;
  6. preempt and resume: a pool too small for the batch gives the token
     streams of a roomy one;
  7. the training kernels (forward with LSE, fused backward, split dq and
     dk/dv backward) against their plain versions on the card at the
     training shape (b 8, h 12, s 1023, d 64, causal, bf16 and f32), at
     s 1024, head dims 32, 48, 80 and 128, GQA, layout bhsd, dense,
     sq != sk (causal both ways, and dense), in both dtypes, and through
     ``FlashAttention`` with the split path forced (f32 and bf16); bf16
     takes the Hopper kernels (the fused route's flash_bwd_wgmma_kernel,
     the split route's flash_bwd_dq_wgmma_kernel and
     flash_bwd_dkv_wgmma_kernel), f32 the CUDA-core ones; both routes'
     dq, dk and dv bitwise equal over two calls (bf16 and f32, the
     training shape and GQA); each timed beside its bound and its
     library yardstick (SDPA's flash forward and backward): the kernels
     alone from a profiler trace (the fused route as the sum of its two
     kernels, the Hopper kernel or the f32 CUDA-core one and the ordered
     dq sum; the split route's two kernels each), the wrapper and SDPA
     with CUDA events; with the kernels' register, spill and
     shared-memory report from nvcc (the paged pair's instantiations
     too, no spills allowed);
  8. training slice parity: GPT-2-small f32, b 1, s 128, loss and every
     gradient from the card's kernels against the CPU plain versions;
  9. the training path: GPT-2-small bf16 with use_flash, remat
     "dots_flash" and the bench's AdamW (bf16 first moment), 6 steps on
     one [8, 1024] batch: the loss is finite and falls, and each step
     launches the LSE-route forward and the fused backward once per
     layer and nothing else (the profiled step's trace: the Hopper
     forward and the Hopper backward with its dq sum, once per layer,
     and no CUDA-core backward); median step ms, tokens/s and a
     profiled step's device time by kernel group;
 10. the long-sequence training path: GPT-2-small width, 2 layers,
     max_seq 16384, one step on [1, 16384]: the backward takes the split
     kernels, once each per layer by the counters, and a profiled second
     step's trace shows the two Hopper split kernels once per layer and
     no CUDA-core or fused backward; then the three training kernels at
     that shape ([1, 16384, 12, 64] bf16) against their plain versions
     (run two heads at a time), timed as in phase 7, with the peak
     device memory of the checks, and the forward at head dims 48 and
     80 (two heads) at that length;
 11. speculative serving: GPT-2-small bf16 with use_flash, 8 threaded
     requests whose prompts repeat n-grams, through
     ``LLMEngine(speculative={"mode": "ngram", "k": 4})`` and again with
     the target as its own draft (``"draft"``): every decode step is a
     verify step (the paged pair's q_len > 1 route, once per layer by
     the counters), proposals are made and accepted, and
     ``stats()["last_step"]`` names the card and gives its spans as
     dispatch-to-ready, pricing nothing against them; a profiled verify
     step of the engine shows the paged split and combine kernels once
     per layer and paged_attention_kernel never; the accept rate and
     output tokens
     per verify step; a verify step's wall and device ms beside a plain
     decode step's at the same batch and contexts (b 8, contexts 512,
     k + 1 = 5 rows a lane), and the verify route at exactly that step's
     inputs against its plain version (bf16 and f32);
 12. speculative token streams in f32 at GPT-2-small's width: n-gram and
     draft speculation give the spec-off engine's tokens, greedy and
     sampled (a difference fails the phase and prints its first position
     and the target's top-2 logit gap there);
 13. the fused backward's dq workspace cap: at bf16 [2, 8192, 12, 64]
     (3.2 GB of dq workspace in the fused route, over the 256 MiB cap)
     FlashAttention's backward takes the split route by the counters,
     bitwise equal to a direct split call and over two calls, against
     the plain version (two heads at a time), as is the fused kernel's
     one launch; the routed call's peak device memory beside that
     launch's, and both routes' times; the routes ``bwd_route`` names
     at the training shape (bf16 fused, f32 split) and at [32, 10752].

Prints a ``{"serving": ...}`` line, a ``{"speculative": ...}`` line, a
``{"training": ...}`` line, the card line, a ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. Everything measured, the
whole run's wall time included, goes to smoke_out/chip_smoke.json as
well.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device is available\n")
    sys.exit(2)

from ray_tpu_torch import optim  # noqa: E402
from ray_tpu_torch._tree import tree_leaves, tree_map  # noqa: E402
from ray_tpu_torch.llm import LLMEngine  # noqa: E402
from ray_tpu_torch.llm.kv_cache import PagedKVCache  # noqa: E402
from ray_tpu_torch.models import gpt  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import flash as k_flash  # noqa: E402
from ray_tpu_torch.ops import paged_decode as k_paged  # noqa: E402
from ray_tpu_torch.serve.llm import LLMServer  # noqa: E402

DEV = torch.device("cuda")
# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor
# cores, f32 on the CUDA cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Kernel vs plain-version tolerances: those of the JAX package's own
# kernel tests (tests/test_paged_decode.py, tests/test_pallas_flash.py).
TOL = {("paged", torch.float32): 2e-5, ("paged", torch.bfloat16): 2e-2,
       ("flash", torch.float32): 2e-5, ("flash", torch.bfloat16): 3e-2}
# Slice parity (phase 3): the card's cuBLAS and the CPU's BLAS sum the
# 768- and 3072-long f32 reductions in different orders and the kernels
# use an online softmax; over 12 layers of GPT-2-small that stays below
# 1e-3 on logits of magnitude ~1. Phase 8 holds the loss and gradients
# to the same bound (the reference's gradient tolerance).
PARITY_ATOL = 1e-3
# Training kernels vs their plain versions (phase 7): the forward and
# its f32 LSE at the flash tolerances above; f32 gradients at the
# reference's gradient tolerance (tests/test_pallas_flash.py); bf16
# gradients by relative norm error, as the JAX model tests hold bf16.
GRAD_ATOL_F32 = 1e-3
GRAD_RTOL_BF16 = 3e-2
REPORT = {}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def randn(shape, dtype, seed):
    return torch.randn(shape, generator=gen(seed)).to(DEV, dtype)


_FLUSH = None


# Cycles of the spin kernel that holds the stream before each timed
# call (~2 ms at the H100's clock): the host enqueues the whole call
# behind it, so the events time the device's work and not the host's
# dispatch of a many-op call (autograd.grad, a wrapper's PyTorch ops).
HOLD_CYCLES = 4_000_000


def time_ms(fn, iters: int, flush: bool = True) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each call,
    the 50 MB L2 flushed before each so inputs come from HBM as they do
    on the serving path, and the stream held by a spin kernel while the
    host enqueues the call."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        if flush:
            _FLUSH.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def host_us(fn, calls: int = 100, reps: int = 20) -> float:
    """Median host time of one call of ``fn`` in µs: ``calls`` calls
    back to back while a spin kernel (~10 ms) holds the card, so no
    launch waits on the device. On a host-bound step (the decode step)
    this, not the device time, is what a call costs."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(reps):
        torch.cuda._sleep(5 * HOLD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        res.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(res)


# torch.cuda._sleep's kernel, which nothing this script profiles launches
# but device_events' own spin kernels: the preamble's, the hold in front
# of the clock check and the ~1 ms one that checks the window's clock.
SPIN = "spin_kernel"
_PREAMBLE = 8
CAL_CYCLES = HOLD_CYCLES // 2
CAL_TOL = 0.03
WINDOW_TRIES = 5


def device_events(fn, calls: int, flush: bool = False,
                  want: dict | None = None) -> list:
    """The device (CUDA) events of a torch.profiler window in which
    ``fn`` runs ``calls`` times, the 50 MB L2 flushed before each call
    when ``flush``. A complete window has device events and, for each
    kernel name in ``want``, that many events whose name contains it,
    and its clock agrees with CUDA events.

    Two faults of CUPTI's traces show once the process has run for a
    minute or so, whatever ran before. It loses the first few device
    events of a window (the first two to four of twenty in traces of
    phase 10's window), so each window starts with ``_PREAMBLE`` spin
    kernels and a sync. And in some windows the durations come out
    short, by up to half (a dq sum read at twice the card's HBM rate),
    so each window ends with a sync, a hold spin and a spin kernel of
    ``CAL_CYCLES`` between two CUDA events (the hold keeps the host's
    enqueue out of them): a window whose trace gives that spin a
    duration off by more than ``CAL_TOL`` is not complete. No spin
    kernel's event is returned. CUPTI also now and then hands back a
    window with no device event at all, or loses its last events (then
    the clock spin too). An incomplete window is taken again, at most
    ``WINDOW_TRIES`` times in all, and the last one is returned for the
    caller's own checks to fail on (a clock that never agreed is counted
    in the report's ``unchecked_clock_windows``)."""
    from torch.profiler import ProfilerActivity, profile

    global _FLUSH
    if flush and _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(WINDOW_TRIES):
        torch.cuda.synchronize()
        cal = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with warnings.catch_warnings():
            # The profiler warns once that events are cleared per cycle;
            # this window is one cycle.
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(_PREAMBLE):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                for _ in range(calls):
                    if flush:
                        _FLUSH.zero_()
                    fn()
                torch.cuda.synchronize()
                torch.cuda._sleep(HOLD_CYCLES)
                cal[0].record()
                torch.cuda._sleep(CAL_CYCLES)
                cal[1].record()
                torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        events = [e for e in device if SPIN not in e.name]
        spins = [e.time_range for e in device if SPIN in e.name]
        cal_ms = cal[0].elapsed_time(cal[1])
        traced_ms = (max(spins, key=lambda t: t.start).elapsed_us() / 1e3
                     if spins else 0.0)
        clock_ok = abs(traced_ms / cal_ms - 1) <= CAL_TOL
        got = {k: sum(k in e.name for e in events) for k in want or {}}
        if events and clock_ok and all(got[k] == n
                                       for k, n in (want or {}).items()):
            return events
        REPORT["retaken_traces"] = REPORT.get("retaken_traces", 0) + 1
        log(f"[trace] window retaken: {len(events)} device events; want "
            f"{want}, got {got}; clock spin {traced_ms:.4f} ms traced, "
            f"{cal_ms:.4f} ms by CUDA events")
    if not clock_ok:
        REPORT["unchecked_clock_windows"] = REPORT.get(
            "unchecked_clock_windows", 0) + 1
    return events


def bound(flops: float, nbytes: float, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phase 2

# The paged decode/verify pair (ops/csrc/paged_decode.cu): the split
# kernel, then the ordered combine, launched as a programmatic dependent
# of it. The earlier one-kernel design, paged_attention_kernel, is gone:
# no trace may show it.
PAGED_SPLIT = "paged_decode_split_kernel"
PAGED_COMBINE = "paged_decode_combine_kernel"
OLD_PAGED = "paged_attention_kernel"


def paged_case(dtype, *, b, hkv, group, d, bs, max_nb, q_len=None,
               seed=0, max_ctx=None, lens=None):
    """Random pool and tables; ``lens`` fixes the contexts (a context of
    1 keeps the all-zero table of a padded engine lane: its one key is
    key 0 of the scratch block 0), else they are random with one full
    ``max_ctx``."""
    rng = np.random.default_rng(seed)
    num_blocks = b * max_nb + 1
    max_ctx = max_ctx or max_nb * bs
    padded = lens is not None   # a fixed context of 1: a padded lane
    if lens is None:
        lens = rng.integers(max(1, q_len or 1), max_ctx + 1, size=b)
        lens[0] = max_ctx                   # one full-length context
    lens = np.asarray(lens)
    tables = np.zeros((b, max_nb), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    used = 0
    for i, n in enumerate(lens):
        if padded and n == 1:
            continue
        nb = -(-int(n) // bs)
        tables[i, :nb] = perm[used:used + nb]
        used += nb
    qshape = (b, hkv, group, d) if q_len is None else (b, q_len, hkv,
                                                        group, d)
    pshape = (hkv, num_blocks, bs, d)
    return dict(q=randn(qshape, dtype, seed + 1),
                k=randn(pshape, dtype, seed + 2),
                v=randn(pshape, dtype, seed + 3),
                tables=torch.from_numpy(tables).to(DEV),
                lens=torch.from_numpy(lens.astype(np.int32)).to(DEV))


def pair_device_ms(fn, iters: int = 50) -> dict:
    """The paged pair's device times from a torch.profiler CUDA trace of
    ``iters`` calls, the 50 MB L2 flushed before each: the median of each
    kernel's duration and of the span from the split kernel's start to
    the combine's end (the combine is scheduled while the split runs and
    waits for its grid, so its own duration includes that wait; the
    span is the pair's device time)."""
    for _ in range(2):
        fn()
    ev = {}
    for e in device_events(fn, iters, flush=True,
                           want={PAGED_SPLIT: iters, PAGED_COMBINE: iters}):
        for name in (PAGED_SPLIT, PAGED_COMBINE):
            if name in e.name:
                ev.setdefault(name, []).append(e.time_range)
    split = sorted(ev.get(PAGED_SPLIT, []), key=lambda t: t.start)
    comb = sorted(ev.get(PAGED_COMBINE, []), key=lambda t: t.start)
    assert len(split) == len(comb) == iters, (len(split), len(comb))
    return dict(
        split=statistics.median(t.elapsed_us() for t in split) / 1e3,
        combine=statistics.median(t.elapsed_us() for t in comb) / 1e3,
        span=statistics.median(c.end - a.start
                               for a, c in zip(split, comb)) / 1e3)


def paged_check(dtype, what, out, ref, q_lens=None) -> float:
    """Max abs error over the rows a caller reads (verify: the first
    q_lens[b] of lane b), held at the reference's tolerance."""
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype, what
    if q_lens is None:
        err = max_err(out, ref)
        assert torch.isfinite(out.float()).all(), what
    else:
        err = max(max_err(out[i, :n], ref[i, :n])
                  for i, n in enumerate(q_lens.tolist()))
        assert all(torch.isfinite(out[i, :n].float()).all()
                   for i, n in enumerate(q_lens.tolist())), what
    tol = TOL[("paged", dtype)]
    assert err <= tol, f"{what} {dtype}: err {err} > {tol}"
    return err


def check_paged():
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        c = paged_case(dtype, b=8, hkv=12, group=1, d=64, bs=16, max_nb=64,
                       seed=10)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
        out = k_paged.paged_decode_attention(*args)
        ref = k_paged.paged_decode_attention_reference(*args)
        err = paged_check(dtype, "paged decode", out, ref)
        tol = TOL[("paged", dtype)]
        # The combine sums the splits in a fixed order: bitwise repeatable.
        assert torch.equal(out, k_paged.paged_decode_attention(*args)), \
            f"paged decode {dtype}: two calls differ"
        ms = time_ms(lambda: k_paged.paged_decode_attention(*args), 200)
        # Without the flush: the pools are L2-resident (15 MB of 50), so
        # this is the pair's time when HBM is not in the way.
        warm_ms = time_ms(lambda: k_paged.paged_decode_attention(*args),
                          200, flush=False)
        dev = pair_device_ms(lambda: k_paged.paged_decode_attention(*args))
        host = host_us(lambda: k_paged.paged_decode_attention(*args))
        plain_ms = time_ms(
            lambda: k_paged.paged_decode_attention_reference(*args), 20)
        isz = c["q"].element_size()
        ctx = int(c["lens"].sum())
        hkv, d = 12, 64
        nbytes = (2 * ctx * hkv * d * isz          # K and V, read once
                  + 2 * c["q"].numel() * isz        # q in, out
                  + sum(-(-int(n) // 16) for n in c["lens"].tolist()) * 4
                  + 8 * 4)
        flops = 4 * ctx * hkv * d                   # q.k and p.v, 1 row
        b_ms, b_by = bound(flops, nbytes, dtype)
        rows.append(dict(dtype=str(dtype).split(".")[-1], max_abs_err=err,
                         tolerance=tol, ms=ms, warm_ms=warm_ms,
                         kernel_ms=dev["span"], host_us=host,
                         split_ms=dev["split"], combine_ms=dev["combine"],
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         sum_ctx=ctx, repeatable=True,
                         shape="b8 hkv12 group1 d64 bs16 max_nb64"))
        log(f"[2] paged_decode {rows[-1]}")
    # Other block sizes and head dims: bs 8 (a stage of 8 blocks), 128
    # (a block cut in two 64-key stages), 32 with d 16 and GQA 4.
    for (bs, d, group, dtype) in ((8, 64, 2, torch.bfloat16),
                                  (128, 128, 1, torch.float32),
                                  (32, 16, 4, torch.float32)):
        c = paged_case(dtype, b=4, hkv=3, group=group, d=d, bs=bs,
                       max_nb=6, seed=15)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
        err = paged_check(dtype, f"paged decode bs{bs} d{d} group{group}",
                          k_paged.paged_decode_attention(*args),
                          k_paged.paged_decode_attention_reference(*args))
        log(f"[2] paged_decode bs{bs} d{d} group{group} {dtype} err {err:.3g}")
    edges = []
    for dtype in (torch.bfloat16, torch.float32):
        # Verify: group > 1, q_len 4 (one kernel pair serves both).
        c = paged_case(dtype, b=3, hkv=2, group=4, d=64, bs=16, max_nb=8,
                       q_len=4, seed=20)
        q_lens = torch.tensor([4, 2, 1], dtype=torch.int32, device=DEV)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"], q_lens)
        err = paged_check(dtype, "paged verify",
                          k_paged.paged_verify_attention(*args),
                          k_paged.paged_verify_attention_reference(*args),
                          q_lens)
        log(f"[2] paged_verify {dtype} group4 q_len4 err {err:.3g}")
        # Edge cases at the serving block size: a padded lane (context 1
        # on the scratch block), contexts at and one past a split's chunk
        # (128 keys), a full table (1024 keys).
        chunk = 16 * k_paged.decode_geometry(
            5, 2, 2, 64, 16, 64, 5 * 64 + 1, c["q"].element_size()
        ).chunk_blocks
        c = paged_case(dtype, b=5, hkv=2, group=2, d=64, bs=16, max_nb=64,
                       seed=21, lens=[1, chunk, chunk + 1, 1024, 500])
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
        out = k_paged.paged_decode_attention(*args)
        e1 = paged_check(dtype, "paged decode edges", out,
                         k_paged.paged_decode_attention_reference(*args))
        assert torch.equal(out, k_paged.paged_decode_attention(*args))
        # Verify edges: q_lens < q_len, and rows whose bound ends a chunk
        # early (lane 0: token 0 sees keys below 128 of 131; lane 1: 128
        # of 129), so the last split holds no key those rows see.
        c = paged_case(dtype, b=5, hkv=2, group=2, d=64, bs=16, max_nb=64,
                       q_len=4, seed=22, lens=[chunk + 3, chunk + 1, 4, 1024,
                                               1])
        q_lens = torch.tensor([4, 2, 4, 3, 1], dtype=torch.int32,
                              device=DEV)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"], q_lens)
        out = k_paged.paged_verify_attention(*args)
        e2 = paged_check(dtype, "paged verify edges", out,
                         k_paged.paged_verify_attention_reference(*args),
                         q_lens)
        assert torch.equal(out, k_paged.paged_verify_attention(*args))
        # The speculative engine's verify shape (phase 11): b 8, 12 kv
        # heads, group 1, k + 1 = 5 rows a lane (two row tiles of 4, the
        # second holding one row), lanes with every proposal, with fewer,
        # with none, and padded lanes (context 1 on the scratch block,
        # one row), as _run_verify lays them out.
        c = paged_case(dtype, b=8, hkv=12, group=1, d=64, bs=16, max_nb=64,
                       q_len=5, seed=23, lens=[517, 1024, 1, 131, 300, 1,
                                               64, 5])
        q_lens = torch.tensor([5, 5, 1, 3, 1, 1, 4, 2], dtype=torch.int32,
                              device=DEV)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"], q_lens)
        out = k_paged.paged_verify_attention(*args)
        e3 = paged_check(dtype, "paged verify, engine shape", out,
                         k_paged.paged_verify_attention_reference(*args),
                         q_lens)
        assert torch.equal(out, k_paged.paged_verify_attention(*args))
        edges.append(dict(dtype=str(dtype).split(".")[-1], decode_err=e1,
                          verify_err=e2, engine_verify_err=e3,
                          repeatable=True))
        log(f"[2] paged edges {edges[-1]}")
    REPORT["paged_edges"] = edges
    return rows


# The forward's two kernels (ops/csrc/flash_fwd.cu): bf16 takes the
# Hopper kernel (TMA, wgmma), f32 the CUDA-core one.
WGMMA_FWD = "flash_fwd_wgmma_kernel"
SIMT_FWD = "flash_fwd_kernel"
# The backward's kernels (ops/csrc/flash_bwd.cu). The fused route is two
# launches: bf16 the Hopper kernel, f32 the CUDA-core dk/dv kernel's
# fused instantiation, each followed by the ordered dq sum. The split
# route is a dq and a dk/dv kernel: bf16 the two Hopper ones, f32 the
# CUDA-core ones. No name contains another, so a profiler trace matches
# each once a call.
WGMMA_BWD = "flash_bwd_wgmma_kernel"
DQ_SUM = "flash_bwd_dq_sum_kernel"
SIMT_BWD_KV = "flash_bwd_kv_kernel"
SIMT_BWD_DQ = "flash_bwd_dq_kernel"
WGMMA_BWD_DQ = "flash_bwd_dq_wgmma_kernel"
WGMMA_BWD_DKV = "flash_bwd_dkv_wgmma_kernel"
_NAMES = (WGMMA_FWD, SIMT_FWD, WGMMA_BWD, DQ_SUM, SIMT_BWD_KV, SIMT_BWD_DQ,
          WGMMA_BWD_DQ, WGMMA_BWD_DKV, PAGED_SPLIT, PAGED_COMBINE, OLD_PAGED)
assert not any(a in b for a in _NAMES for b in _NAMES if a != b), _NAMES
# The split route's kernels by dtype: (dq, dk/dv).
SPLIT_KERNELS = {torch.bfloat16: (WGMMA_BWD_DQ, WGMMA_BWD_DKV),
                 torch.float32: (SIMT_BWD_DQ, SIMT_BWD_KV)}


def flash_pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def check_flash():
    rows = []
    for s in (1024, 1000):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn((1, 12, s, 64), dtype, 30 + i)
                       for i in range(3))
            out = k_flash.flash_attention_fwd(q, k, v, causal=True,
                                              layout="bhsd")
            ref = k_flash.flash_attention_reference(q, k, v, causal=True,
                                                    layout="bhsd")
            torch.cuda.synchronize()
            err = max_err(out, ref)
            tol = TOL[("flash", dtype)]
            assert torch.isfinite(out.float()).all()
            assert err <= tol, f"flash s{s} {dtype}: err {err} > {tol}"
            ms = time_ms(lambda: k_flash.flash_attention_fwd(
                q, k, v, causal=True, layout="bhsd"), 100)
            plain_ms = time_ms(lambda: k_flash.flash_attention_reference(
                q, k, v, causal=True, layout="bhsd"), 20)
            lib_ms = time_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(
                                 q, k, v, is_causal=True), 100)
            isz = q.element_size()
            nbytes = 4 * q.numel() * isz
            flops = 4 * 12 * 64 * flash_pairs(s, s, True)
            b_ms, b_by = bound(flops, nbytes, dtype)
            rows.append(dict(dtype=str(dtype).split(".")[-1], s=s,
                             max_abs_err=err, tolerance=tol, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             shape=f"b1 h12 s{s} d64 causal bhsd"))
            log(f"[2] flash {rows[-1]}")
    # Beyond the serving shape, in both dtypes (bf16 takes the Hopper
    # kernel, f32 the CUDA-core one): layout bshd through strides, GQA,
    # dense, sq != sk (top-left causal), the smallest and largest head
    # dims, and d 48 and 80, where the bf16 kernel pads the head dim to
    # 64 and 128 inside its TMA boxes.
    for (b, sq, sk, h, hk, d) in ((2, 200, 200, 8, 2, 32),
                                  (1, 100, 300, 4, 4, 128),
                                  (2, 300, 100, 4, 2, 64),
                                  (3, 70, 70, 2, 1, 16),
                                  (2, 333, 333, 8, 2, 48),
                                  (1, 257, 257, 4, 4, 80)):
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q = randn((b, sq, h, d), dtype, 40)
                k = randn((b, sk, hk, d), dtype, 41)
                v = randn((b, sk, hk, d), dtype, 42)
                out = k_flash.flash_attention_fwd(q, k, v, causal=causal)
                ref = k_flash.flash_attention_reference(q, k, v,
                                                        causal=causal)
                err = max_err(out, ref)
                assert err <= TOL[("flash", dtype)], \
                    f"flash bshd sq{sq} sk{sk} d{d} {dtype} " \
                    f"causal={causal}: err {err}"
                log(f"[2] flash bshd b{b} sq{sq} sk{sk} h{h}/{hk} d{d} "
                    f"{dtype} causal={causal} err {err:.3g}")
    # Which kernel each dtype launches, by name in a profiler trace.
    for dtype, want in ((torch.bfloat16, WGMMA_FWD), (torch.float32,
                                                       SIMT_FWD)):
        q, k, v = (randn((1, 4, 256, 64), dtype, 43 + i) for i in range(3))
        names = device_busy(lambda: k_flash.flash_attention_fwd(
            q, k, v, layout="bhsd"), 1, want={want: 1})["fwd_kernels"]
        assert names and all(want in n for n in names), (dtype, names)
        log(f"[2] flash {dtype} launches {names}")
    return rows


# ---------------------------------------------------------------- phase 3

def slice_parity():
    cfg = gpt.GPTConfig(dtype=torch.float32, use_flash=True)
    p_cpu = gpt.init(cfg, gen(1), device="cpu")
    p_gpu = gpt.working_params(p_cpu, cfg, DEV)
    rng = np.random.default_rng(2)
    T, bs, B = 64, 16, 8
    prompt = rng.integers(0, 50257, size=(1, T)).astype(np.int64)
    res = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        toks = torch.from_numpy(prompt).to(dev)
        logits, k, v = gpt.forward_prefill(params, toks, cfg)
        pool = PagedKVCache(cfg, num_blocks=16, block_size=bs, device=dev)
        table = list(range(1, 1 + (T + 4) // bs + 1))
        pool.write_prefill(k[:, 0], v[:, 0], table[:T // bs])
        res[dev] = {"prefill": logits[0].float().cpu(), "pool": pool,
                    "decode": []}
    # Decode 4 steps, greedy on the CPU logits so both sides see the
    # same tokens; lane 0 is live, lanes 1..7 padded onto block 0.
    tok = int(res["cpu"]["prefill"][-1].argmax())
    for step in range(4):
        pos = T + step
        for dev in ("cpu", "cuda"):
            pool = res[dev]["pool"]
            tokens = torch.zeros(B, dtype=torch.int32)
            tokens[0] = tok
            positions = torch.zeros(B, dtype=torch.int32)
            positions[0] = pos
            tables = torch.zeros((B, 64), dtype=torch.int32)
            tables[0, :len(table)] = torch.tensor(table)
            lens = torch.ones(B, dtype=torch.int32)
            lens[0] = pos + 1
            sb = torch.zeros(B, dtype=torch.int32)
            sb[0] = table[pos // bs]
            so = torch.zeros(B, dtype=torch.int32)
            so[0] = pos % bs
            args = [t.to(dev) for t in (tokens, positions)]
            rest = [t.to(dev) for t in (tables, lens, sb, so)]
            logits, _, _ = gpt.forward_decode(
                p_cpu if dev == "cpu" else p_gpu, *args, pool.k, pool.v,
                *rest, cfg)
            res[dev]["decode"].append(logits[0].float().cpu())
        tok = int(res["cpu"]["decode"][-1].argmax())
    errs = {"prefill_logits": max_err(res["cpu"]["prefill"],
                                      res["cuda"]["prefill"])}
    errs["decode_logits"] = max(max_err(a, b) for a, b in zip(
        res["cpu"]["decode"], res["cuda"]["decode"]))
    # Pools: every block but the scratch block 0 (padded lanes write it).
    errs["pools"] = max(
        max_err(getattr(res["cpu"]["pool"], n)[:, :, 1:],
                getattr(res["cuda"]["pool"], n)[:, :, 1:].cpu())
        for n in ("k", "v"))
    for name, e in errs.items():
        assert e <= PARITY_ATOL, f"slice parity {name}: {e} > {PARITY_ATOL}"
    assert all(torch.isfinite(t).all() for t in res["cuda"]["decode"])
    log(f"[3] slice parity GPT-2-small f32 (atol {PARITY_ATOL}): {errs}")
    return errs


# ---------------------------------------------------------------- phase 4

_FLASH_COUNTERS = ("launches", "lse_launches", "bwd_fused_launches",
                   "bwd_dq_launches", "bwd_dkv_launches")


def reset_counts():
    k_paged.launches = 0
    for name in _FLASH_COUNTERS:
        setattr(k_flash, name, 0)


def counts() -> dict:
    out = {"paged": k_paged.launches}
    out.update({n: getattr(k_flash, n) for n in _FLASH_COUNTERS})
    return out


def serve_engine_defaults(params16):
    cfg = gpt.GPTConfig(dtype=torch.bfloat16, use_flash=True)
    eng = LLMEngine(params16, cfg, num_blocks=8 * 64 + 1, block_size=16,
                    max_batch=8, prefill_chunk_tokens=None,
                    prefix_cache=True, device=DEV)
    eng.start()
    try:
        # Warm-up request (cuBLAS handles, first launches): not counted.
        warm = eng.add_request(list(range(1, 40)), max_tokens=4)
        list(warm.tokens())
        rng = np.random.default_rng(4)
        lengths = [64, 150, 260, 380, 512, 700, 850, 960]
        prompts = [rng.integers(0, 50257, size=n).tolist() for n in lengths]
        reqs = [None] * len(prompts)
        done = [None] * len(prompts)

        def client(i):
            r = eng.add_request(prompts[i], max_tokens=64, seed=i,
                                temperature=0.0 if i % 2 else 0.8)
            reqs[i] = r
            done[i] = list(r.tokens())

        before = eng.stats()
        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        flash_n, paged_n = k_flash.launches, k_paged.launches
        seen = counts()
        after = eng.stats()
    finally:
        eng.stop()
    assert not any(t.is_alive() for t in threads), "a client hung"
    for r, toks in zip(reqs, done):
        assert r.finish_reason == "length" and len(r.output) == 64, \
            (r.finish_reason, len(r.output))
        assert toks == r.output
    prefills = after["prefill_chunks"] - before["prefill_chunks"]
    decodes = after["decode_steps"] - before["decode_steps"]
    L = cfg.n_layer
    assert prefills >= len(prompts), prefills
    assert flash_n == L * prefills, (flash_n, prefills)
    assert paged_n == L * decodes, (paged_n, decodes)
    assert flash_n > 0 and paged_n > 0
    # Serving never takes the training routes.
    assert all(seen[n] == 0 for n in _FLASH_COUNTERS[1:]), seen
    ttft = sorted((r.first_token_t - r.submit_t) * 1e3 for r in reqs)
    out = dict(requests=len(reqs), prompt_tokens=sum(lengths),
               generated_tokens=sum(len(r.output) for r in reqs),
               wall_s=wall, tokens_per_s=sum(len(r.output) for r in reqs)
               / wall, ttft_p50_ms=statistics.median(ttft),
               ttft_max_ms=ttft[-1], whole_prefills=prefills,
               decode_steps=decodes, flash_launches=flash_n,
               paged_launches=paged_n,
               preemptions=sum(r.preemptions for r in reqs))
    log(f"[4] serving, engine defaults: {out}")
    return out


def _kernel_group(name: str) -> str:
    if PAGED_SPLIT in name or PAGED_COMBINE in name or OLD_PAGED in name:
        return "paged_decode"
    if "flash_fwd_" in name:
        return "flash_fwd"
    if WGMMA_BWD in name:
        return "flash_bwd_wgmma"
    if WGMMA_BWD_DQ in name:
        return "flash_bwd_dq_wgmma"
    if WGMMA_BWD_DKV in name:
        return "flash_bwd_dkv_wgmma"
    if DQ_SUM in name:
        return "flash_bwd_dq_sum"
    if SIMT_BWD_KV in name:
        return "flash_bwd_kv"
    if SIMT_BWD_DQ in name:
        return "flash_bwd_dq"
    if any(s in name.lower() for s in ("gemm", "gemv", "cutlass", "sm90_",
                                       "xmma", "cublas", "nvjet")):
        return "matmul"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copy"
    return "other"


def device_busy(fn, steps: int, want: dict | None = None):
    """Device busy time per call of ``fn`` in ms, by kernel group, from a
    torch.profiler CUDA trace (kernels on one stream do not overlap, so
    their durations add up to the busy time), under "fwd_kernels" the
    names of the flash forward kernels launched and under "launches" the
    number of kernels of each group in the whole window, under
    "kernel_launches" the number of launches of each kernel named in
    ``_NAMES``. None where the trace has no device events. ``want``: the
    launches of each named kernel a complete window holds (a window
    taken again by ``device_events`` runs ``fn`` again)."""
    groups, names, n, named = {}, {}, {}, {}
    for e in device_events(fn, steps, want=want):
        us = e.time_range.elapsed_us()
        g = _kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + us
        n[g] = n.get(g, 0) + 1
        names[e.name[:80]] = names.get(e.name[:80], 0.0) + us
        for k in _NAMES:
            if k in e.name:
                named[k] = named.get(k, 0) + 1
    if not groups:
        return None
    out = {g: us / 1e3 / steps for g, us in sorted(groups.items())}
    out["total"] = sum(out.values())
    out["fwd_kernels"] = sorted({n for n in names if "flash_fwd_" in n})
    out["launches"] = dict(sorted(n.items()))
    out["kernel_launches"] = dict(sorted(named.items()))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    REPORT.setdefault("top_kernels", []).append(
        [(n, us / 1e3 / steps) for n, us in top])
    return out


def check_paged_trace(busy, want: int, what: str):
    """A decode window's trace shows the split and the combine kernel
    ``want`` times each (once per layer a step) and the earlier design's
    paged_attention_kernel never."""
    n = busy["kernel_launches"]
    assert n.get(PAGED_SPLIT) == want and n.get(PAGED_COMBINE) == want \
        and OLD_PAGED not in n, (what, want, n)


def step_breakdown(params16):
    """Where a serving step's time goes at GPT-2-small bf16: one
    forward_decode at max_batch 8 with contexts of 512 tokens, and one
    whole-prompt flash prefill of 960 tokens. Wall time is the host
    clock around work ending in a sync (unprofiled); device busy time
    and its split by kernel come from a profiled window."""
    cfg = gpt.GPTConfig(dtype=torch.bfloat16)
    bs, B, ctx = 16, 8, 512
    pool = PagedKVCache(cfg, num_blocks=B * 64 + 1, block_size=bs,
                        device=DEV)
    nb = ctx // bs + 1
    tables = torch.zeros((B, 64), dtype=torch.int32)
    for i in range(B):
        tables[i, :nb] = torch.arange(1 + i * 64, 1 + i * 64 + nb)
    tables = tables.to(DEV)
    tokens = torch.arange(B, dtype=torch.int32, device=DEV)
    pos = torch.full((B,), ctx, dtype=torch.int32, device=DEV)
    lens = pos + 1
    sb = tables[:, ctx // bs].contiguous()
    so = torch.full((B,), ctx % bs, dtype=torch.int32, device=DEV)

    def decode():
        logits, _, _ = gpt.forward_decode(params16, tokens, pos, pool.k,
                                          pool.v, tables, lens, sb, so, cfg)
        logits[:B].float().cpu()

    prompt = torch.from_numpy(np.random.default_rng(8).integers(
        0, 50257, size=(1, 960))).to(DEV)
    fcfg = gpt.GPTConfig(dtype=torch.bfloat16, use_flash=True)

    def prefill():
        logits, _, _ = gpt.forward_prefill(params16, prompt, fcfg)
        logits[0, -1].float().cpu()

    out = {}
    for name, fn, n in (("decode", decode, 25), ("prefill", prefill, 12)):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(times[n // 5:])
        per_layer = cfg.n_layer * 5
        busy = device_busy(fn, 5, want=(
            {PAGED_SPLIT: per_layer, PAGED_COMBINE: per_layer}
            if name == "decode" else None))
        assert busy is not None, f"no device events in the {name} trace"
        if name == "prefill":   # bf16: the Hopper forward, nothing else
            assert busy["fwd_kernels"] and all(
                WGMMA_FWD in n for n in busy["fwd_kernels"]), busy
        else:   # the paged pair once per layer a step, the old kernel never
            check_paged_trace(busy, per_layer, "phase 4 decode")
        out[name] = dict(wall_ms=wall, device_ms=busy,
                         device_idle_share=(None if busy is None else
                                            max(0.0, 1 - busy["total"]
                                                / wall)))
    log(f"[4] step breakdown (decode b8 ctx512, prefill 960 flash): {out}")
    return out


# ---------------------------------------------------------------- phase 5

def handler_decode_trace(eng) -> dict:
    """The handler's engine, its loop stopped, steps one more request
    by hand until its prefill is done; the next step, a decode step and
    nothing else, is profiled: the paged pair once per layer, the old
    kernel never. Returns the trace's paged-kernel launches."""
    eng.stop()
    eng.add_request(list(range(1, 40)), max_tokens=8)
    for _ in range(100):
        s0 = eng.stats()
        eng.step()
        if eng.stats()["decode_steps"] > s0["decode_steps"]:
            break
    seen = []

    def one_step():   # a window taken again steps again: check the last
        a = eng.stats()
        eng.step()
        seen.append((a, eng.stats()))

    L = eng.cfg.n_layer
    busy = device_busy(one_step, 1, want={PAGED_SPLIT: L, PAGED_COMBINE: L})
    s0, s1 = seen[-1]
    assert busy is not None, "no device events in the handler's decode step"
    assert s1["decode_steps"] == s0["decode_steps"] + 1 and \
        s1["prefill_chunks"] == s0["prefill_chunks"], (s0, s1)
    check_paged_trace(busy, L, "phase 5 decode step")
    return {k: v for k, v in busy["kernel_launches"].items()
            if k in (PAGED_SPLIT, PAGED_COMBINE)}


def serve_handler_defaults(params16):
    system = ("You are a careful assistant running on a paged KV cache. "
              "Answer briefly, cite the block table when asked, and never "
              "invent numbers that were not measured on the card you "
              "are running on right now, in this very session. ")
    assert len(system) >= 200, len(system)
    srv = LLMServer(gpt.GPTConfig(dtype=torch.bfloat16), params16,
                    system_prompt=system, device=DEV)
    try:
        reset_counts()
        first = list(srv({"prompt": "Hello there.", "seed": 1}))
        results = [None] * 3

        def client(i):
            results[i] = list(srv({"prompt": f"Question {i}: why?",
                                   "seed": 10 + i, "temperature": 0.7}))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        seen = counts()
        stats = srv.engine_stats()
    finally:
        srv.engine.stop()
    assert not any(t.is_alive() for t in threads), "a client hung"
    decode_trace = handler_decode_trace(srv.engine)
    for frames in [first] + results:
        assert frames[-1]["done"] is True, frames[-1]
        toks = [f["token"] for f in frames[:-1]]
        assert len(toks) == frames[-1]["num_tokens"] == 32, frames[-1]
    cached = [r[-1]["cached_tokens"] for r in results]
    assert all(c > 0 for c in cached), cached
    assert seen["paged"] > 0
    assert all(seen[n] == 0 for n in _FLASH_COUNTERS[1:]), seen
    out = dict(cached_tokens=cached, hit_rate=stats["kv_cache_hit_rate"],
               prefill_chunks=stats["prefill_chunks"], launches=seen,
               decode_step_kernels=decode_trace)
    log(f"[5] serving, handler defaults: {out}")
    return out


# ---------------------------------------------------------------- phase 6

def preempt_resume():
    cfg = gpt.GPTConfig(dtype=torch.float32)
    params = gpt.init(cfg, gen(6), device=DEV)
    rng = np.random.default_rng(6)
    reqs = [dict(prompt=rng.integers(0, 50257, size=n).tolist(),
                 max_tokens=40, seed=i, temperature=0.0 if i % 2 else 0.9)
            for i, n in enumerate((10, 12, 14, 9))]

    def run(num_blocks):
        eng = LLMEngine(params, cfg, num_blocks=num_blocks, block_size=16,
                        max_batch=8, device=DEV)
        hs = [eng.add_request(**r) for r in reqs]
        for _ in range(2000):
            s = eng.stats()
            if not s["in_flight"] and not s["waiting"]:
                break
            eng.step()
        assert all(h.finish_reason == "length" for h in hs)
        return [list(h.output) for h in hs], \
            sum(h.preemptions for h in hs), eng.kv.num_free == \
            eng.kv.capacity

    roomy, p0, _ = run(64)
    tight, p1, drained = run(8)     # capacity 7 blocks < 4 x 4 needed
    assert tight == roomy, "preempted streams differ from the roomy pool"
    assert p1 > 0, "the tight pool never preempted"
    assert drained
    out = dict(preemptions_roomy=p0, preemptions_tight=p1,
               tokens=sum(len(t) for t in tight))
    log(f"[6] preempt/resume: {out}")
    return out


# --------------------------------------------------------------- phase 11

SPEC_NGRAM = {"mode": "ngram", "k": 4}
SPEC_DRAFT = {"mode": "draft", "k": 4}


def loopy_prompts(seed: int, lengths) -> list:
    """Prompts that repeat an n-gram: a random 12-token base repeated to
    each length, the text the n-gram proposer finds its proposals in."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        base = rng.integers(0, 50257, size=12).tolist()
        out.append((base * (n // 12 + 1))[:n])
    return out


def threaded_requests(eng, prompts, max_tokens: int, temps) -> tuple:
    """One client thread a prompt against a started engine: (requests,
    the tokens each client streamed, wall seconds)."""
    reqs = [None] * len(prompts)
    done = [None] * len(prompts)

    def client(i):
        r = eng.add_request(prompts[i], max_tokens=max_tokens, seed=i,
                            temperature=temps[i])
        reqs[i] = r
        done[i] = list(r.tokens())

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a client hung"
    return reqs, done, time.perf_counter() - t0


def verify_step_trace(eng) -> dict:
    """The engine, its loop stopped, steps one more request by hand
    until its prefill is done; the next step, a verify step and nothing
    else, is profiled: the paged pair once per layer, the old kernel
    never. Returns the trace's paged launches and the step's own
    accounting (``stats()["last_step"]``)."""
    eng.stop()
    eng.add_request(loopy_prompts(40, [100])[0], max_tokens=128)
    for _ in range(100):
        v0 = eng.stats()["spec"]["verify_steps"]
        eng.step()
        if eng.stats()["spec"]["verify_steps"] > v0:
            break
    seen = []

    def one_step():   # a window taken again steps again: check the last
        a = eng.stats()
        eng.step()
        seen.append((a, eng.stats()))

    L = eng.cfg.n_layer
    busy = device_busy(one_step, 1, want={PAGED_SPLIT: L, PAGED_COMBINE: L})
    s0, s1 = seen[-1]
    eng.stop()
    assert busy is not None, "no device events in the verify step"
    assert s1["spec"]["verify_steps"] == s0["spec"]["verify_steps"] + 1 \
        and s1["prefill_chunks"] == s0["prefill_chunks"] and \
        s1["decode_steps"] == s0["decode_steps"], (s0, s1)
    check_paged_trace(busy, L, "phase 11 verify step")
    return dict(kernels={k: v for k, v in busy["kernel_launches"].items()
                         if k in (PAGED_SPLIT, PAGED_COMBINE)},
                device_ms=busy, last_step=s1["last_step"])


def spec_serving(params16):
    """Phase 11: the engine's speculative path at GPT-2-small bf16."""
    cfg = gpt.GPTConfig(dtype=torch.bfloat16, use_flash=True)
    L = cfg.n_layer
    lengths = [64, 96, 128, 160, 192, 256, 320, 384]
    prompts = loopy_prompts(11, lengths)
    temps = [0.8 if i % 4 == 3 else 0.0 for i in range(len(prompts))]
    card_h100 = "H100" in torch.cuda.get_device_name(0)
    out = {}
    for name, spec, max_tokens in (("ngram", SPEC_NGRAM, 64),
                                   ("draft", SPEC_DRAFT, 16)):
        eng = LLMEngine(params16, cfg, num_blocks=8 * 64 + 1, block_size=16,
                        max_batch=8, speculative=spec, device=DEV)
        eng.start()
        try:
            warm = eng.add_request(list(range(1, 40)), max_tokens=4)
            list(warm.tokens())
            before = eng.stats()
            lanes0 = eng._spec.verified_lanes
            reset_counts()
            reqs, done, wall = threaded_requests(eng, prompts, max_tokens,
                                                 temps)
            seen = counts()
            after = eng.stats()
            lanes = eng._spec.verified_lanes - lanes0
        finally:
            eng.stop()
        for r, toks in zip(reqs, done):
            assert r.finish_reason == "length" and \
                len(r.output) == max_tokens, (r.finish_reason, len(r.output))
            assert toks == r.output
        sb, sa = before["spec"], after["spec"]
        d = {k: sa[k] - sb[k] for k in ("proposed", "accepted", "emitted",
                                        "verify_steps", "rolled_back")}
        prefills = after["prefill_chunks"] - before["prefill_chunks"]
        # Every decode step of a speculative engine is a verify step: the
        # paged pair once per layer each, launched by the wrapper.
        assert after["decode_steps"] == before["decode_steps"], (before,
                                                                 after)
        assert d["verify_steps"] > 0 and seen["paged"] == L * \
            d["verify_steps"], (seen, d)
        if name == "ngram":
            assert seen["launches"] == L * prefills, (seen, prefills)
        else:   # the draft's forwards take the primal flash kernel too
            assert seen["launches"] > L * prefills, (seen, prefills)
        assert all(seen[n] == 0 for n in _FLASH_COUNTERS[1:]), seen
        assert d["proposed"] > 0 and d["accepted"] > 0, d
        last = after["last_step"]
        assert ("H100" in last["hardware"]) == card_h100, last
        # The engine's spans on the card are dispatch-to-ready: nothing
        # is priced against them (llm/engine.py).
        assert last["dispatch_to_ready_ms"] > 0 and all(
            last[k] is None for k in ("device_ms", "mfu", "hbm_util",
                                      "verdict")), last
        row = dict(requests=len(reqs), max_tokens=max_tokens,
                   generated_tokens=sum(len(r.output) for r in reqs),
                   wall_s=wall, tokens_per_s=sum(len(r.output) for r in reqs)
                   / wall, accept_rate=d["accepted"] / d["proposed"],
                   output_tokens_per_verify_step=d["emitted"]
                   / d["verify_steps"], verified_lanes=lanes,
                   output_tokens_per_lane_step=d["emitted"] / lanes, **d,
                   prefills=prefills,
                   paged_launches=seen["paged"],
                   flash_launches=seen["launches"], last_step=last,
                   ttft_p50_ms=statistics.median(
                       (r.first_token_t - r.submit_t) * 1e3 for r in reqs))
        if name == "ngram":
            row["verify_trace"] = verify_step_trace(eng)
            assert ("H100" in row["verify_trace"]["last_step"]["hardware"]) \
                == card_h100
        out[name] = row
        log(f"[11] speculative serving, {name}: {row}")
    out["step_breakdown"] = verify_breakdown(params16)
    return out


def verify_breakdown(params16):
    """A verify step beside a plain decode step at GPT-2-small bf16, the
    same batch (8) and contexts (512 resident tokens a lane): one
    forward_verify of k + 1 = 5 rows a lane, one forward_decode of one.
    Wall time is the host clock around work ending in a sync
    (unprofiled); device busy time and its split by kernel come from a
    profiled window."""
    cfg = gpt.GPTConfig(dtype=torch.bfloat16)
    bs, B, ctx, Q = 16, 8, 512, SPEC_NGRAM["k"] + 1
    pool = PagedKVCache(cfg, num_blocks=B * 64 + 1, block_size=bs,
                        device=DEV)
    nb = (ctx + Q) // bs + 1
    tables = torch.zeros((B, 64), dtype=torch.int32)
    for i in range(B):
        tables[i, :nb] = torch.arange(1 + i * 64, 1 + i * 64 + nb)
    tables = tables.to(DEV)
    tok1 = torch.arange(B, dtype=torch.int32, device=DEV)
    pos1 = torch.full((B,), ctx, dtype=torch.int32, device=DEV)
    sb1 = tables[:, ctx // bs].contiguous()
    so1 = torch.full((B,), ctx % bs, dtype=torch.int32, device=DEV)
    lens1 = pos1 + 1
    rows = torch.arange(Q, device=DEV)
    tokq = torch.arange(B * Q, dtype=torch.int32, device=DEV).view(B, Q)
    posq = (ctx + rows).to(torch.int32).expand(B, Q).contiguous()
    sbq = tables[:, (ctx + rows) // bs].contiguous()
    soq = ((ctx + rows) % bs).to(torch.int32).expand(B, Q).contiguous()
    lensq = torch.full((B,), ctx + Q, dtype=torch.int32, device=DEV)
    qlens = torch.full((B,), Q, dtype=torch.int32, device=DEV)

    def decode():
        logits, _, _ = gpt.forward_decode(params16, tok1, pos1, pool.k,
                                          pool.v, tables, lens1, sb1, so1,
                                          cfg)
        logits[:B].float().cpu()

    def verify():
        logits, _, _ = gpt.forward_verify(params16, tokq, posq, pool.k,
                                          pool.v, tables, lensq, qlens, sbq,
                                          soq, cfg)
        logits[:B].float().cpu()

    out = {}
    L = cfg.n_layer
    for name, fn in (("decode", decode), ("verify", verify)):
        times = []
        for _ in range(25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(times[5:])
        busy = device_busy(fn, 5, want={PAGED_SPLIT: 5 * L,
                                        PAGED_COMBINE: 5 * L})
        assert busy is not None, f"no device events in the {name} trace"
        check_paged_trace(busy, 5 * L, f"phase 11 {name}")
        out[name] = dict(wall_ms=wall, device_ms=busy,
                         device_idle_share=max(0.0, 1 - busy["total"] / wall))
    # The verify route at exactly these inputs (layer 0's pool filled at
    # random, random rows), against its plain version, both dtypes.
    kp, vp = pool.k[0], pool.v[0]
    kp.copy_(randn(kp.shape, kp.dtype, 41))
    vp.copy_(randn(vp.shape, vp.dtype, 42))
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = randn((B, Q, cfg.n_head, 1, cfg.d_model // cfg.n_head), dtype, 43)
        args = (q, kp.to(dtype), vp.to(dtype), tables, lensq, qlens)
        got = k_paged.paged_verify_attention(*args)
        errs[str(dtype).split(".")[-1]] = paged_check(
            dtype, "phase 11 verify inputs", got,
            k_paged.paged_verify_attention_reference(*args), qlens)
        assert torch.equal(got, k_paged.paged_verify_attention(*args))
    out["verify_route_err"] = errs
    out["rows_per_lane"] = {"decode": 1, "verify": Q}
    out["shape"] = f"b{B} contexts {ctx} block {bs}"
    log(f"[11] verify vs decode step (b{B} ctx{ctx}, {Q} rows a lane): {out}")
    return out


# --------------------------------------------------------------- phase 12

def first_difference(a, b) -> int:
    return next(j for j in range(min(len(a), len(b)) + 1)
                if j == min(len(a), len(b)) or a[j] != b[j])


def spec_token_check():
    """Phase 12: GPT-2-small f32 with use_flash, 4 requests (2 greedy, 2
    sampled) whose prompts repeat n-grams: the n-gram and the draft
    engine emit the spec-off engine's tokens."""
    cfg = gpt.GPTConfig(dtype=torch.float32, use_flash=True)
    params = gpt.init(cfg, gen(31), device=DEV)
    prompts = loopy_prompts(32, [40, 70, 100, 130])
    reqs = [dict(prompt=p, max_tokens=24, seed=i,
                 temperature=0.0 if i % 2 == 0 else 0.9)
            for i, p in enumerate(prompts)]

    def run(spec):
        eng = LLMEngine(params, cfg, num_blocks=4 * 64 + 1, block_size=16,
                        max_batch=4, speculative=spec, device=DEV)
        hs = [eng.add_request(**r) for r in reqs]
        for _ in range(1000):
            s = eng.stats()
            if not s["in_flight"] and not s["waiting"]:
                break
            eng.step()
        assert all(h.finish_reason == "length" for h in hs)
        return [list(h.output) for h in hs], eng.stats().get("spec")

    off, _ = run(None)
    out = {}
    for name, spec in (("ngram", SPEC_NGRAM), ("draft", SPEC_DRAFT)):
        got, stats = run(spec)
        for i, (a, b) in enumerate(zip(got, off)):
            if a == b:
                continue
            j = first_difference(a, b)
            seq = reqs[i]["prompt"] + b[:j]
            logits, _, _ = gpt.forward_prefill(
                params, torch.tensor([seq], device=DEV), cfg)
            top = logits[0, -1].float().topk(2).values
            raise AssertionError(
                f"phase 12 {name}: request {i} (temperature "
                f"{reqs[i]['temperature']}) differs from spec-off at output "
                f"position {j} (token {len(seq)}): {a[j:j + 3]} vs "
                f"{b[j:j + 3]}; the target's top-2 logit gap there is "
                f"{float(top[0] - top[1]):.3g}")
        assert stats["proposed"] > 0, stats
        out[name] = dict(equal=True, tokens=sum(len(t) for t in got),
                         spec=stats)
        log(f"[12] speculative tokens f32, {name}: {out[name]}")
    return out


# ---------------------------------------------------------------- phase 7

def kernel_device_ms(fn, labels: dict, iters: int = 20) -> dict:
    """Median device time in ms of each kernel of ``fn`` whose name
    contains ``labels[label]``, from a torch.profiler CUDA trace of
    ``iters`` calls, the 50 MB L2 flushed before each (inputs come from
    HBM, as on the training path)."""
    for _ in range(2):
        fn()
    events = device_events(fn, iters, flush=True,
                           want={sub: iters for sub in labels.values()})
    out = {}
    for label, sub in labels.items():
        us = [e.time_range.elapsed_us() for e in events if sub in e.name]
        assert len(us) == iters, (label, sub, len(us))
        out[label] = statistics.median(us) / 1e3
    return out


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_grads(got, ref, dtype, what):
    """(max abs error, max relative norm error) over dq, dk, dv; f32
    held at GRAD_ATOL_F32 by the first, bf16 at GRAD_RTOL_BF16 by the
    second."""
    errs, rels = [], []
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        assert torch.isfinite(a.float()).all(), (what, name)
        e = max_err(a, b)
        if dtype == torch.float32:
            assert e <= GRAD_ATOL_F32, f"{what} {name}: err {e}"
        else:
            r = rel_err(a, b)
            assert r <= GRAD_RTOL_BF16, f"{what} {name}: rel err {r}"
        errs.append(e)
        rels.append(rel_err(a, b))
    return max(errs), max(rels)


def train_inputs(b, s, h, hk, d, dtype, seed, layout="bshd", sk=None):
    """q, k, v and the output gradient; k and v have sk keys (s if
    None)."""
    def shape(n, length):
        return (b, length, n, d) if layout == "bshd" else (b, n, length, d)

    sk = s if sk is None else sk
    return (randn(shape(h, s), dtype, seed),
            randn(shape(hk, sk), dtype, seed + 1),
            randn(shape(hk, sk), dtype, seed + 2),
            randn(shape(h, s), dtype, seed + 3))


def fused_ms(fn, dtype, iters: int = 20) -> dict:
    """The fused route's device time from a profiler trace: its kernel
    (bf16 the Hopper one, f32 the CUDA-core one) and the ordered dq sum,
    each matched once a call, and their sum under "ms"."""
    t = kernel_device_ms(fn, {
        "kernel": WGMMA_BWD if dtype == torch.bfloat16 else SIMT_BWD_KV,
        "dq_sum": DQ_SUM}, iters)
    return dict(t, ms=t["kernel"] + t["dq_sum"])


def split_ms(fn, dtype, iters: int = 20) -> dict:
    """The split route's two kernels' device times from a profiler trace
    (bf16 the Hopper kernels, f32 the CUDA-core ones), each matched once
    a call."""
    dq, dkv = SPLIT_KERNELS[dtype]
    return kernel_device_ms(fn, {"bwd_dq": dq, "bwd_dkv": dkv}, iters)


def check_repeatable(first, args, kw, what,
                     fn=k_flash.flash_attention_bwd_fused) -> bool:
    """A backward route's dq, dk and dv are bitwise equal over two calls
    on the same inputs (the fused route sums dq in a fixed order; the
    split route writes each gradient once)."""
    again = fn(*args, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), f"{what} {name}: two calls differ"
    REPORT.setdefault("repeatable", []).append(what)
    return True


def check_training_kernels():
    """The training shape: all four kernels against their plain
    versions, timed beside their bounds and SDPA's flash kernels."""
    b, s, h, d = 8, 1023, 12, 64
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = train_inputs(b, s, h, h, d, dtype, 50)
        o, lse = k_flash.flash_attention_fwd_lse(q, k, v)
        o_ref, lse_ref = k_flash.flash_attention_fwd_lse_reference(q, k, v)
        torch.cuda.synchronize()
        assert torch.isfinite(lse).all() and torch.isfinite(o.float()).all()
        fwd_err = max(max_err(o, o_ref), max_err(lse, lse_ref))
        tol = TOL[("flash", dtype)]
        assert max_err(o, o_ref) <= tol, f"fwd_lse {dtype} out"
        assert max_err(lse, lse_ref) <= TOL[("flash", torch.float32)], \
            f"fwd_lse {dtype} lse: {max_err(lse, lse_ref)}"
        ref = k_flash.flash_attention_bwd_reference(q, k, v, o, lse, do)
        fused = k_flash.flash_attention_bwd_fused(q, k, v, o, lse, do)
        split = k_flash.flash_attention_bwd_split(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        fused_err, fused_rel = check_grads(fused, ref, dtype,
                                           f"fused {dtype}")
        check_repeatable(fused, (q, k, v, o, lse, do), {},
                         f"fused b{b} s{s} h{h} d{d} {dtype}")
        check_grads(split, ref, dtype, f"split {dtype}")
        check_repeatable(split, (q, k, v, o, lse, do), {},
                         f"split b{b} s{s} h{h} d{d} {dtype}",
                         k_flash.flash_attention_bwd_split)
        dq_err = max_err(split[0], ref[0])
        dkv_err = max(max_err(split[1], ref[1]), max_err(split[2], ref[2]))
        rels = {"bwd_fused": fused_rel, "bwd_dq": rel_err(split[0], ref[0]),
                "bwd_dkv": max(rel_err(split[1], ref[1]),
                               rel_err(split[2], ref[2])),
                "fwd_lse": rel_err(o, o_ref)}
        del ref, fused, split

        args = (q, k, v, o, lse, do)
        dev_ms = kernel_device_ms(
            lambda: k_flash.flash_attention_fwd_lse(q, k, v),
            {"fwd_lse": WGMMA_FWD if dtype == torch.bfloat16 else SIMT_FWD})
        fused_t = fused_ms(lambda: k_flash.flash_attention_bwd_fused(*args),
                           dtype)
        dev_ms["bwd_fused"] = fused_t["ms"]
        dev_ms.update(split_ms(
            lambda: k_flash.flash_attention_bwd_split(*args), dtype))
        wrapper_ms = {
            "fwd_lse": time_ms(lambda: k_flash.flash_attention_fwd_lse(
                q, k, v), 20),
            "bwd_fused": time_ms(
                lambda: k_flash.flash_attention_bwd_fused(*args), 20),
            "bwd_split": time_ms(
                lambda: k_flash.flash_attention_bwd_split(*args), 20)}
        plain_ms = {
            "fwd_lse": time_ms(
                lambda: k_flash.flash_attention_fwd_lse_reference(q, k, v),
                5),
            "bwd": time_ms(
                lambda: k_flash.flash_attention_bwd_reference(*args), 5)}
        lib_ms = {"fwd_lse": None, "bwd": None}
        if dtype == torch.bfloat16:
            lib_ms = sdpa_times(q, k, v, do)
        bounds = train_bounds(b, s, h, d, dtype)
        key = str(dtype).split(".")[-1]
        errs = {"fwd_lse": fwd_err, "bwd_fused": fused_err,
                "bwd_dq": dq_err, "bwd_dkv": dkv_err}
        rows[key] = {
            name: dict(max_abs_err=errs[name], rel_err=rels[name],
                       **train_tol(name, dtype),
                       ms=dev_ms[name],
                       bound_ms=bounds[name][0], bound_by=bounds[name][1],
                       plain_ms=plain_ms["fwd_lse" if name == "fwd_lse"
                                         else "bwd"],
                       library_ms=lib_ms["fwd_lse" if name == "fwd_lse"
                                         else "bwd"])
            for name in errs}
        rows[key]["bwd_fused"].update(kernel_ms=fused_t["kernel"],
                                      dq_sum_ms=fused_t["dq_sum"])
        rows[key]["wrapper_ms"] = wrapper_ms
        rows[key]["shape"] = f"b{b} s{s} h{h} d{d} causal bshd"
        log(f"[7] training kernels {key}: {rows[key]}")
        del q, k, v, do, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    rows["other_shapes"] = check_training_shapes()
    return rows


def train_tol(name: str, dtype) -> dict:
    """The tolerance a training kernel's result is held to, and on
    what: the forward's output by max abs error (its f32 LSE at the f32
    flash tolerance), f32 gradients by max abs error, bf16 gradients by
    the relative norm error of each of dq, dk and dv."""
    if name == "fwd_lse":
        return dict(tolerance=TOL[("flash", dtype)],
                    tolerance_on="out max abs; lse max abs "
                    f"{TOL[('flash', torch.float32)]}")
    if dtype == torch.float32:
        return dict(tolerance=GRAD_ATOL_F32, tolerance_on="max abs")
    return dict(tolerance=GRAD_RTOL_BF16, tolerance_on="relative norm")


def train_bounds(b, s, h, d, dtype) -> dict:
    """(bound ms, by) of each training kernel at [b, s, h, d], causal.
    Operations: the forward 2 causal matmuls of 2·s²/2·d flops per head;
    the fused backward 5 (2.5x), the split dq kernel 3 (qkᵀ, dO·vᵀ,
    ds·k), the dk/dv kernel 4 (qkᵀ, dO·vᵀ, pᵀ·dO, dsᵀ·q). Bytes: each
    input read once, each output written once."""
    fwd_flops = 4 * b * h * s * s * d / 2
    isz = torch.empty((), dtype=dtype).element_size()
    act = b * s * h * d * isz           # one [b, s, h, d] tensor
    rows_b = b * h * s * 4              # one f32 [b, h, s] row vector
    return {
        "fwd_lse": bound(fwd_flops, 4 * act + rows_b, dtype),
        "bwd_fused": bound(2.5 * fwd_flops, 4 * act + 2 * rows_b + 3 * act,
                           dtype),
        "bwd_dq": bound(1.5 * fwd_flops, 4 * act + 2 * rows_b + act, dtype),
        "bwd_dkv": bound(2.0 * fwd_flops, 4 * act + 2 * rows_b + 2 * act,
                         dtype)}


def sdpa_times(q, k, v, do):
    """The library yardsticks, timed only (the port never calls them):
    SDPA's flash forward, which returns the LSE, and the backward of
    F.scaled_dot_product_attention on the flash backend, at the same
    inputs in SDPA's [b, h, s, d] layout."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qh, kh, vh, doh = (t.transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    fwd = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        qh, kh, vh, 0.0, True), 20)
    qg, kg, vg = (t.detach().requires_grad_() for t in (qh, kh, vh))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=True)
    bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), doh,
                                              retain_graph=True), 20)
    return {"fwd_lse": fwd, "bwd": bwd}


def check_training_shapes():
    """Beyond the training shape: s 1024, head dims 32 and 128, GQA,
    layout bhsd, dense, sq != sk (causal sq > sk and sq < sk, dense
    sq > sk); both routes repeatable at the GQA shape; then
    FlashAttention end to end with the split path forced (budget 0), in
    both dtypes, against the plain versions."""
    out = []
    cases = [(b, sq, sk, h, hk, d, dtype, layout, causal)
             for (b, sq, sk, h, hk, d, layout, causal) in (
                 (2, 1024, 1024, 12, 12, 64, "bshd", True),
                 (2, 1024, 1024, 12, 12, 64, "bhsd", True),
                 (2, 300, 300, 8, 8, 32, "bshd", True),
                 (1, 200, 200, 4, 4, 128, "bshd", False),
                 (2, 333, 333, 8, 2, 64, "bshd", True),
                 (1, 129, 129, 4, 1, 128, "bhsd", False),
                 (2, 333, 333, 8, 2, 48, "bshd", True),
                 (1, 300, 300, 4, 4, 80, "bhsd", True),
                 (1, 300, 100, 4, 4, 64, "bshd", True),
                 (1, 100, 300, 4, 4, 64, "bshd", True),
                 (1, 300, 100, 4, 2, 64, "bhsd", False))
             for dtype in (torch.bfloat16, torch.float32)]
    for (b, sq, sk, h, hk, d, dtype, layout, causal) in cases:
        q, k, v, do = train_inputs(b, sq, h, hk, d, dtype, 60, layout, sk)
        kw = dict(causal=causal, layout=layout)
        o, lse = k_flash.flash_attention_fwd_lse(q, k, v, **kw)
        o_ref, lse_ref = k_flash.flash_attention_fwd_lse_reference(
            q, k, v, **kw)
        assert max_err(o, o_ref) <= TOL[("flash", dtype)]
        assert max_err(lse, lse_ref) <= TOL[("flash", torch.float32)]
        ref = k_flash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                    **kw)
        what = f"b{b} sq{sq} sk{sk} h{h}/{hk} d{d} {layout} causal={causal}"
        fused = k_flash.flash_attention_bwd_fused(q, k, v, o, lse, do, **kw)
        e_f, _ = check_grads(fused, ref, dtype, "fused " + what)
        split = k_flash.flash_attention_bwd_split(q, k, v, o, lse, do, **kw)
        e_s, _ = check_grads(split, ref, dtype, "split " + what)
        if (sq, hk, d) == (333, 2, 64):
            check_repeatable(fused, (q, k, v, o, lse, do), kw,
                             f"fused {what} {dtype}")
            check_repeatable(split, (q, k, v, o, lse, do), kw,
                             f"split {what} {dtype}",
                             k_flash.flash_attention_bwd_split)
        out.append(dict(case=what, dtype=str(dtype).split(".")[-1],
                        fwd_err=max_err(o, o_ref),
                        lse_err=max_err(lse, lse_ref), fused_err=e_f,
                        split_err=e_s))
        log(f"[7] {out[-1]}")
    # FlashAttention through autograd, split path forced.
    from ray_tpu_torch.ops.flash_attention import flash_attention

    for dtype in (torch.float32, torch.bfloat16):
        budget = k_flash._FUSED_BWD_VMEM_BUDGET
        k_flash._FUSED_BWD_VMEM_BUDGET = 0
        try:
            q, k, v, do = train_inputs(2, 1023, 12, 12, 64, dtype, 70)
            reset_counts()
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            flash_attention(*leaves).backward(do)
            seen = counts()
        finally:
            k_flash._FUSED_BWD_VMEM_BUDGET = budget
        o, lse = k_flash.flash_attention_fwd_lse_reference(q, k, v)
        ref = k_flash.flash_attention_bwd_reference(q, k, v, o, lse, do)
        e, r = check_grads([t.grad for t in leaves], ref, dtype,
                           f"FlashAttention split forced {dtype}")
        assert (seen["lse_launches"], seen["bwd_dq_launches"],
                seen["bwd_dkv_launches"], seen["bwd_fused_launches"]) == \
            (1, 1, 1, 0), seen
        out.append(dict(case=f"FlashAttention b2 s1023 h12 d64 "
                        f"{str(dtype).split('.')[-1]}, split forced",
                        grad_err=e, grad_rel_err=r, launches=seen))
        log(f"[7] {out[-1]}")
    return out


def kernel_template(name: str):
    """(kernel, template arguments) of a mangled entry function name,
    e.g. ``..._22flash_bwd_wgmma_kernelILi64EEEv...`` -> (
    "flash_bwd_wgmma_kernel", (64,)): ints and bools as such, float as
    "f32", __nv_bfloat16 as "bf16". (None, ()) for another name."""
    import re

    m = re.search(r"(?<=\d)((?:flash|paged)_[a-z_]+_kernel)I", name)
    if m is None:
        return None, ()
    rest, args = name[m.end():], []
    while rest and rest[0] != "E":
        lit = re.match(r"L([ib])(\d+)E", rest)
        named = re.match(r"(\d+)", rest)
        if lit:
            val = int(lit.group(2))
            args.append(val if lit.group(1) == "i" else bool(val))
            rest = rest[lit.end():]
        elif named:
            n = int(named.group(1))
            typ = rest[named.end():named.end() + n]
            args.append("bf16" if "bfloat16" in typ else typ)
            rest = rest[named.end() + n:]
        elif rest[0] == "f":
            args.append("f32")
            rest = rest[1:]
        else:
            raise ValueError(f"cannot read the template arguments of {name}")
    return m.group(1), tuple(args)


def ptxas_label(kern: str, args: tuple):
    """The report's label of one instantiation, or None for the ones it
    leaves out (the CUDA-core kernels at head dims other than 64)."""
    if kern == PAGED_SPLIT:   # <T, rows a CTA, 16-byte vectors a lane>
        return f"{kern}_rt{args[1]}_nv{args[2]}_{args[0]}"
    if kern == PAGED_COMBINE:
        return f"{kern}_{args[0]}"
    if kern in (WGMMA_FWD, WGMMA_BWD, WGMMA_BWD_DQ, WGMMA_BWD_DKV):
        return f"{kern}_dp{args[0]}_bf16"
    if kern == DQ_SUM:
        return f"{kern}_{args[0]}"
    dtype, d = args[0], args[1]
    if d != 64:
        return None
    if kern == SIMT_BWD_KV:
        return f"{kern}_{'fused' if args[2] else 'split'}_{dtype}"
    return f"{kern}_{dtype}"


def ptxas_report() -> dict:
    """Registers and spills of the kernels, from nvcc's -Xptxas -v report
    of the libraries this run loaded (kept beside each library, so a
    reused build has it too): the Hopper kernels (forward, fused and
    split backward) at both padded head dims, with their dynamic shared
    memory, the ordered dq sum in both dtypes, every CUDA-core flash
    kernel at head dim 64 (float32 only: bf16 takes the Hopper kernels on
    every route), and every instantiation of the paged pair (the split
    kernel at 1 and 4 rows a CTA, with one or, f32 only, two 16-byte
    vectors a lane; the combine), both dtypes. A Hopper kernel's count is
    the launch's (384 threads, 168 a thread); setmaxnreg then moves the
    producer's registers to the consumers. The backward's Hopper kernels
    (fused and split), the dq sum and the paged pair must not spill."""
    import re

    fwd, bwd = k_flash._fwd_lib(), k_flash._bwd_lib()
    smem = {WGMMA_FWD: lambda dp: fwd.flash_fwd_smem_bytes(1, dp),
            WGMMA_BWD: bwd.flash_bwd_smem_bytes,
            WGMMA_BWD_DQ: lambda dp: bwd.flash_bwd_split_smem_bytes(1, dp),
            WGMMA_BWD_DKV: lambda dp: bwd.flash_bwd_split_smem_bytes(2, dp),
            SIMT_FWD: lambda d: fwd.flash_fwd_smem_bytes(0, d)}
    out, warns = {}, []
    for src in ("flash_fwd", "flash_bwd", "paged_decode"):
        text = _build.build_report(src)
        warns += [ln for ln in text.splitlines() if "warning" in ln.lower()]
        for m in re.finditer(
                r"Compiling entry function '(\w+)'.*?\n(.*?)Used (\d+) "
                r"registers", text, re.S):
            name, body, regs = m.group(1), m.group(2), int(m.group(3))
            kern, args = kernel_template(name)
            label = kern and ptxas_label(kern, args)
            if label is None:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", body)
            row = dict(registers=regs,
                       spill_stores=int(spill.group(1)) if spill else None,
                       spill_loads=int(spill.group(2)) if spill else None)
            if kern in smem:
                row["dynamic_smem_bytes"] = smem[kern](
                    args[0] if kern != SIMT_FWD else args[1])
            out[label] = row
    hopper_bwd = {f"{kern}_dp{dp}_bf16" for kern in (
        WGMMA_BWD, WGMMA_BWD_DQ, WGMMA_BWD_DKV) for dp in (64, 128)}
    paged = {f"{PAGED_SPLIT}_rt{rt}_nv{nv}_{t}" for rt in (1, 4)
             for nv, t in ((1, "bf16"), (1, "f32"), (2, "f32"))} | {
        f"{PAGED_COMBINE}_bf16", f"{PAGED_COMBINE}_f32"}
    want = {f"{WGMMA_FWD}_dp64_bf16", f"{WGMMA_FWD}_dp128_bf16",
            f"{SIMT_FWD}_f32", f"{DQ_SUM}_bf16", f"{DQ_SUM}_f32",
            f"{SIMT_BWD_KV}_fused_f32", f"{SIMT_BWD_KV}_split_f32",
            f"{SIMT_BWD_DQ}_f32"} | hopper_bwd | paged
    assert set(out) == want, f"ptxas report: {sorted(out)} != {sorted(want)}"
    for label in sorted(hopper_bwd | paged) + [f"{DQ_SUM}_bf16"]:
        assert out[label]["spill_stores"] in (0, None) and \
            out[label]["spill_loads"] in (0, None), (label, out[label])
    REPORT["ptxas_warnings"] = warns
    log(f"[7] ptxas: {out}; warnings: {warns}")
    return out


# ---------------------------------------------------------------- phase 8

def training_parity():
    """GPT-2-small f32, b 1, s 128: loss and every gradient from the
    card's kernels against the CPU's plain versions."""
    cfg = gpt.GPTConfig(dtype=torch.float32, use_flash=True, remat=True)
    p_cpu = gpt.init(cfg, gen(21), device="cpu")
    p_gpu = tree_map(lambda t: t.to(DEV), p_cpu)
    toks = torch.randint(0, cfg.vocab_size, (1, 129), generator=gen(22))
    l_cpu, g_cpu = gpt.loss_and_grads(p_cpu, toks, cfg)
    reset_counts()
    l_gpu, g_gpu = gpt.loss_and_grads(p_gpu, toks.to(DEV), cfg)
    torch.cuda.synchronize()
    seen = counts()
    errs = {"loss_err": abs(float(l_cpu) - float(l_gpu))}
    errs["grad_err"] = max(max_err(a.cpu(), b) for a, b in zip(
        tree_leaves(g_gpu), tree_leaves(g_cpu)))
    for name, e in errs.items():
        assert e <= PARITY_ATOL, f"training parity {name}: {e}"
    assert seen["lse_launches"] == seen["bwd_fused_launches"] == \
        cfg.n_layer, seen
    out = dict(errs, loss=float(l_gpu), launches=seen)
    log(f"[8] training parity GPT-2-small f32 (atol {PARITY_ATOL}): {out}")
    return out


# ---------------------------------------------------------------- phase 9

def train_path(cfg, tokens, steps: int, seed: int):
    """``steps`` train steps through make_train_step on one fixed batch,
    the bench's AdamW; the counters zeroed before each step and read
    after it. Returns (losses, per-step wall ms, per-step counts, the
    step function and its state)."""
    opt = optim.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1,
                      mu_dtype=torch.bfloat16)
    params = gpt.init(cfg, gen(seed), device=DEV)
    state = {"params": params, "opt_state": opt.init(params), "step": 0}
    step = gpt.make_train_step(cfg, opt)
    losses, wall, seen = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))   # waits for the step
        wall.append((time.perf_counter() - t0) * 1e3)
        seen.append(counts())
    return losses, wall, seen, step, state


def training():
    cfg = gpt.GPTConfig(dtype=torch.bfloat16, use_flash=True, remat=True,
                        remat_policy="dots_flash")
    b, s = 8, 1024
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=gen(12)).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    losses, wall, seen, step, state = train_path(cfg, tokens, 6, 11)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.n_layer
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    for c in seen:
        assert c["lse_launches"] == L and c["bwd_fused_launches"] == L, c
        assert c["launches"] == c["bwd_dq_launches"] == \
            c["bwd_dkv_launches"] == c["paged"] == 0, c
    step_ms = statistics.median(wall[1:])
    holder = [state]

    def one_step():
        holder[0], m = step(holder[0], tokens)
        float(m["loss"])

    busy = device_busy(one_step, 1, want={WGMMA_BWD: L, DQ_SUM: L})
    assert busy is not None, "no device events in the train step trace"
    assert busy["fwd_kernels"] and all(
        WGMMA_FWD in n for n in busy["fwd_kernels"]), busy
    # The backward: the Hopper kernel and its dq sum once per layer, no
    # CUDA-core backward kernel.
    n = busy["launches"]
    assert n.get("flash_bwd_wgmma") == L and n.get("flash_bwd_dq_sum") == L \
        and not {"flash_bwd_kv", "flash_bwd_dq", "flash_bwd_dq_wgmma",
                 "flash_bwd_dkv_wgmma"} & set(n), n
    out = dict(model="GPT-2-small bf16 use_flash remat dots_flash, AdamW "
               "bf16 mu", batch=b, seq=s, losses=losses, step_ms=wall,
               median_step_ms=step_ms,
               tokens_per_s=b * (s - 1) / (step_ms / 1e3),
               peak_memory_gb=peak_gb, device_ms=busy,
               device_idle_share=(None if busy is None else
                                  max(0.0, 1 - busy["total"] / step_ms)),
               lse_launches=sum(c["lse_launches"] for c in seen),
               bwd_fused_launches=sum(c["bwd_fused_launches"]
                                      for c in seen))
    log(f"[9] training path: {out}")
    return out


# --------------------------------------------------------------- phase 10

def long_sequence_training():
    """At 16384 tokens the reference's fused-backward budget no longer
    holds: the same entry points take the split kernels."""
    cfg = gpt.GPTConfig(dtype=torch.bfloat16, use_flash=True, remat=True,
                        n_layer=2, max_seq=16384)
    tokens = torch.randint(0, cfg.vocab_size, (1, 16384),
                           generator=gen(14)).to(DEV)
    losses, wall, seen, step, state = train_path(cfg, tokens, 1, 13)
    c = seen[0]
    L = cfg.n_layer
    assert np.isfinite(losses[0]), losses
    assert (c["lse_launches"], c["bwd_dq_launches"],
            c["bwd_dkv_launches"], c["bwd_fused_launches"],
            c["launches"]) == (L, L, L, 0, 0), c
    holder = [state]

    def one_step():
        holder[0], m = step(holder[0], tokens)
        float(m["loss"])

    # A second step, profiled: the bf16 split route is the two Hopper
    # kernels once per layer, with no CUDA-core or fused backward.
    busy = device_busy(one_step, 1,
                       want={WGMMA_BWD_DQ: L, WGMMA_BWD_DKV: L})
    assert busy is not None, "no device events in the long step's trace"
    n = busy["launches"]
    assert n.get("flash_bwd_dq_wgmma") == L and \
        n.get("flash_bwd_dkv_wgmma") == L and not {
            "flash_bwd_kv", "flash_bwd_dq", "flash_bwd_wgmma",
            "flash_bwd_dq_sum"} & set(n), n
    out = dict(model="GPT-2-small width, 2 layers, bf16, max_seq 16384",
               loss=losses[0], step_ms=wall[0],
               bwd_dq_launches=c["bwd_dq_launches"],
               bwd_dkv_launches=c["bwd_dkv_launches"],
               lse_launches=c["lse_launches"], profiled_step_device_ms=busy)
    log(f"[10] long-sequence training step: {out}")
    return out


def by_head_groups(fn, tensors, width: int = 2):
    """``fn`` over slices of ``width`` heads of [b, s, h, d] tensors (an
    [b, h, s] LSE sliced on its axis 1), its outputs joined again: the
    plain versions hold [b, h, s, s] f32 scores, too large for all heads
    at 16384 tokens."""
    h = tensors[0].shape[2]
    parts = []
    for h0 in range(0, h, width):
        sl = [t[:, h0:h0 + width] if t.dim() == 3 else
              t[:, :, h0:h0 + width] for t in tensors]
        parts.append(fn(*sl))
    return [torch.cat([p[i] for p in parts], dim=1 if parts[0][i].dim() == 3
                      else 2) for i in range(len(parts[0]))]


def check_long_kernels():
    """The long-sequence path's shape, [1, 16384, 12, 64] bf16 causal:
    the forward with LSE, the split backward (what the path takes there)
    and the fused one, each against its plain version over all heads
    (two at a time), timed beside their bounds and SDPA's."""
    b, s, h, d, dtype = 1, 16384, 12, 64, torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    q, k, v, do = train_inputs(b, s, h, h, d, dtype, 80)
    o, lse = k_flash.flash_attention_fwd_lse(q, k, v)
    o_ref, lse_ref = by_head_groups(
        k_flash.flash_attention_fwd_lse_reference, (q, k, v))
    torch.cuda.synchronize()
    assert torch.isfinite(lse).all() and torch.isfinite(o.float()).all()
    out_err, lse_err = max_err(o, o_ref), max_err(lse, lse_ref)
    out_rel = rel_err(o, o_ref)
    assert out_err <= TOL[("flash", dtype)], f"long fwd_lse out {out_err}"
    assert lse_err <= TOL[("flash", torch.float32)], f"long lse {lse_err}"
    del o_ref, lse_ref
    args = (q, k, v, o, lse, do)

    def plain_bwd():
        return by_head_groups(k_flash.flash_attention_bwd_reference, args)

    ref = plain_bwd()
    split = k_flash.flash_attention_bwd_split(*args)
    # The fused route's f32 dq workspace, [128 key tiles, 1, 12, 16384,
    # 64], is the largest allocation of this phase.
    ws_gb = 4 * -(-s // 128) * b * h * s * d / 1e9
    fused = k_flash.flash_attention_bwd_fused(*args)
    torch.cuda.synchronize()
    what = f"b{b} s{s} h{h} d{d} bf16"
    fused_err, fused_rel = check_grads(fused, ref, dtype, "fused " + what)
    check_grads(split, ref, dtype, "split " + what)
    errs = {"fwd_lse": out_err, "bwd_fused": fused_err,
            "bwd_dq": max_err(split[0], ref[0]),
            "bwd_dkv": max(max_err(split[1], ref[1]),
                           max_err(split[2], ref[2]))}
    rels = {"fwd_lse": out_rel, "bwd_fused": fused_rel,
            "bwd_dq": rel_err(split[0], ref[0]),
            "bwd_dkv": max(rel_err(split[1], ref[1]),
                           rel_err(split[2], ref[2]))}
    del ref, split, fused

    dev_ms = kernel_device_ms(
        lambda: k_flash.flash_attention_fwd_lse(q, k, v),
        {"fwd_lse": WGMMA_FWD}, iters=10)
    fused_t = fused_ms(lambda: k_flash.flash_attention_bwd_fused(*args),
                       dtype, iters=10)
    dev_ms["bwd_fused"] = fused_t["ms"]
    dev_ms.update(split_ms(lambda: k_flash.flash_attention_bwd_split(*args),
                           dtype, iters=10))
    wrapper_ms = {
        "fwd_lse": time_ms(lambda: k_flash.flash_attention_fwd_lse(q, k, v),
                           10),
        "bwd_fused": time_ms(
            lambda: k_flash.flash_attention_bwd_fused(*args), 10),
        "bwd_split": time_ms(
            lambda: k_flash.flash_attention_bwd_split(*args), 10)}
    plain_ms = {
        "fwd_lse": time_ms(lambda: by_head_groups(
            k_flash.flash_attention_fwd_lse_reference, (q, k, v)), 3),
        "bwd": time_ms(plain_bwd, 3)}
    lib_ms = sdpa_times(q, k, v, do)
    bounds = train_bounds(b, s, h, d, dtype)
    rows = {
        name: dict(max_abs_err=errs[name], rel_err=rels[name],
                   **train_tol(name, dtype), ms=dev_ms[name],
                   bound_ms=bounds[name][0], bound_by=bounds[name][1],
                   plain_ms=plain_ms["fwd_lse" if name == "fwd_lse"
                                     else "bwd"],
                   library_ms=lib_ms["fwd_lse" if name == "fwd_lse"
                                     else "bwd"])
        for name in errs}
    rows["fwd_lse"]["lse_err"] = lse_err
    rows["bwd_fused"].update(kernel_ms=fused_t["kernel"],
                             dq_sum_ms=fused_t["dq_sum"])
    rows["wrapper_ms"] = wrapper_ms
    rows["shape"] = f"b{b} s{s} h{h} d{d} causal bshd"
    rows["fused_workspace_gb"] = ws_gb
    rows["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[10] long-sequence kernels: {rows}")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    # The padded head dims at this length: the forward with LSE, two
    # heads, against its plain version.
    rows["padded_head_dims"] = []
    for dp in (48, 80):
        q, k, v, _ = train_inputs(1, s, 2, 2, dp, dtype, 90)
        o, lse = k_flash.flash_attention_fwd_lse(q, k, v)
        o_ref, lse_ref = k_flash.flash_attention_fwd_lse_reference(q, k, v)
        errs = (max_err(o, o_ref), max_err(lse, lse_ref))
        assert errs[0] <= TOL[("flash", dtype)], f"long d{dp} out {errs}"
        assert errs[1] <= TOL[("flash", torch.float32)], \
            f"long d{dp} lse {errs}"
        rows["padded_head_dims"].append(dict(
            shape=f"b1 s{s} h2 d{dp} causal bshd", out_err=errs[0],
            lse_err=errs[1]))
        log(f"[10] {rows['padded_head_dims'][-1]}")
        del q, k, v, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 13

def fused_workspace_cap():
    """Phase 13: the fused backward's dq workspace cap. At bf16 [2, 8192,
    12, 64] the reference's rule takes the fused kernel, whose f32 dq
    workspace would be 3.2 GB; over ``_FUSED_BWD_WORKSPACE_BYTES``,
    ``FlashAttention``'s backward (the training path's) takes the split
    route, which needs none: by the counters, bitwise equal to a direct
    split call and over two calls, held against the plain version (two
    heads at a time) at phase 7's tolerance, as is the one fused launch;
    the routed call's peak device memory beside that launch's, and the
    two routes' times. The training shape keeps the fused kernel."""
    b, s, h, d, dtype = 2, 8192, 12, 64, torch.bfloat16
    cap = k_flash._FUSED_BWD_WORKSPACE_BYTES
    ws = k_flash.fused_bwd_workspace_bytes(b, h, s, s, d, dtype)
    assert k_flash._fused_bwd_fits(s, s, d, 2) and ws > cap, (ws, cap)
    routes = {f"{name} b{bb} s{ss}": k_flash.bwd_route(bb, h, ss, ss, d, dt,
                                                       512)
              for name, dt, bb, ss in (("bf16", dtype, b, s),
                                       ("bf16", dtype, 32, 10752),
                                       ("bf16", dtype, 8, 1023),
                                       ("f32", torch.float32, 8, 1023))}
    assert routes == {"bf16 b2 s8192": "split", "bf16 b32 s10752": "split",
                      "bf16 b8 s1023": "fused", "f32 b8 s1023": "split"}, \
        routes
    q, k, v, do = train_inputs(b, s, h, h, d, dtype, 100)

    def measured(fn):
        """(fn's result, the counters, peak bytes above what was held
        before the call)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, counts(), torch.cuda.max_memory_allocated() - base

    def routed():
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        k_flash.FlashAttention.apply(qs, ks, vs, True, "bshd", 512).backward(
            do)
        return qs.grad, ks.grad, vs.grad

    got, seen, extra = measured(routed)
    assert (seen["lse_launches"], seen["bwd_dq_launches"],
            seen["bwd_dkv_launches"], seen["bwd_fused_launches"]) == \
        (1, 1, 1, 0), seen
    # The routed call never holds the fused route's workspace.
    assert extra < ws, (extra, ws)
    o, lse = k_flash.flash_attention_fwd_lse(q, k, v)
    args = (q, k, v, o, lse, do)
    split = k_flash.flash_attention_bwd_split(*args)
    for name, a, w in zip(("dq", "dk", "dv"), got, split):
        assert torch.equal(a, w), f"routed vs split {name} differ"
    what = f"b{b} s{s} h{h} d{d} bf16"
    check_repeatable(split, args, {}, "split " + what,
                     fn=k_flash.flash_attention_bwd_split)
    del got
    fused, _, extra_fused = measured(
        lambda: k_flash.flash_attention_bwd_fused(*args))
    assert extra_fused >= ws, (extra_fused, ws)
    ref = by_head_groups(k_flash.flash_attention_bwd_reference, args)
    err, rel = check_grads(split, ref, dtype, "routed (split) " + what)
    err_f, rel_f = check_grads(fused, ref, dtype, "fused " + what)
    del ref, fused, split
    torch.cuda.empty_cache()
    times = {"split": time_ms(
        lambda: k_flash.flash_attention_bwd_split(*args), 5),
        "fused_one_launch": time_ms(
        lambda: k_flash.flash_attention_bwd_fused(*args), 5)}
    out = dict(shape=f"b{b} s{s} h{h} d{d} causal bshd bf16",
               cap_bytes=cap, fused_workspace_bytes=ws, routes=routes,
               launches=seen, max_abs_err=err, rel_err=rel,
               fused_max_abs_err=err_f, fused_rel_err=rel_f,
               tolerance=GRAD_RTOL_BF16, tolerance_on="relative norm",
               bitwise_equal_split=True,
               peak_above_inputs_bytes=extra,
               fused_peak_above_inputs_bytes=extra_fused,
               wrapper_ms=times)
    log(f"[13] fused backward workspace cap: {out}")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return out


def main():
    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = _build.build_all()
    k_paged._lib()
    k_flash._fwd_lib()
    k_flash._bwd_lib()
    log(f"[1] kernels built in {_build.build_seconds:.1f} s: "
        f"{sorted(p.name for p in libs.values())}")
    REPORT["card"] = card
    REPORT["build_s"] = _build.build_seconds

    REPORT["paged"] = check_paged()
    REPORT["flash"] = check_flash()
    REPORT["parity"] = slice_parity()

    cfg16 = gpt.GPTConfig(dtype=torch.bfloat16)
    params16 = gpt.working_params(gpt.init(cfg16, gen(3), device=DEV),
                                  cfg16)
    REPORT["serve_engine"] = serve_engine_defaults(params16)
    REPORT["breakdown"] = step_breakdown(params16)
    REPORT["serve_handler"] = serve_handler_defaults(params16)
    REPORT["preempt"] = preempt_resume()
    del params16
    torch.cuda.empty_cache()

    REPORT["ptxas"] = ptxas_report()
    REPORT["train_kernels"] = check_training_kernels()
    REPORT["train_parity"] = training_parity()
    REPORT["training"] = training()
    REPORT["long_training"] = long_sequence_training()
    REPORT["long_kernels"] = check_long_kernels()
    # Phases 11-12 run after the training phases, so that the training
    # phases' many profiler windows come early in the process
    # (device_events: CUPTI's faults show as the process ages).
    params16 = gpt.working_params(gpt.init(cfg16, gen(3), device=DEV),
                                  cfg16)
    REPORT["spec_serving"] = spec_serving(params16)
    del params16
    torch.cuda.empty_cache()
    REPORT["spec_tokens"] = spec_token_check()
    torch.cuda.empty_cache()
    REPORT["fused_cap"] = fused_workspace_cap()

    main_paged = REPORT["paged"][0]
    main_flash = REPORT["flash"][0]
    kernels = [
        # ms: the wrapper by CUDA events; kernel_ms: the pair's device
        # span (split start to combine end) from a profiler trace.
        dict(name="paged_decode_attention", route="cuda",
             source="ray_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="ray_tpu/ops/pallas/paged_decode.py:45",
             launches=REPORT["serve_engine"]["paged_launches"],
             max_abs_err=main_paged["max_abs_err"],
             tolerance=main_paged["tolerance"], ms=main_paged["ms"],
             kernel_ms=main_paged["kernel_ms"],
             split_ms=main_paged["split_ms"],
             combine_ms=main_paged["combine_ms"],
             host_us=main_paged["host_us"],
             kernel=[PAGED_SPLIT, PAGED_COMBINE],
             verify_launches=REPORT["spec_serving"]["ngram"][
                 "paged_launches"],
             verify_step_paged_ms=REPORT["spec_serving"]["step_breakdown"][
                 "verify"]["device_ms"]["paged_decode"],
             plain_ms=main_paged["plain_ms"],
             bound_ms=main_paged["bound_ms"],
             bound_by=main_paged["bound_by"], library_ms=None,
             shape=main_paged["shape"] + " bf16"),
        dict(name="flash_attention_fwd", route="cuda",
             source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="ray_tpu/ops/pallas/flash.py:52",
             launches=REPORT["serve_engine"]["flash_launches"],
             max_abs_err=main_flash["max_abs_err"],
             tolerance=main_flash["tolerance"], ms=main_flash["ms"],
             kernel_ms=main_flash["ms"], plain_ms=main_flash["plain_ms"],
             bound_ms=main_flash["bound_ms"],
             bound_by=main_flash["bound_by"],
             library_ms=main_flash["library_ms"],
             shape=main_flash["shape"] + " bf16"),
    ]
    # Each training kernel at the shape of the path that launches it:
    # the forward with LSE and the fused backward at the training step's
    # [8, 1023, 12, 64], the split pair at the long step's [1, 16384,
    # 12, 64]. wrapper_ms: the whole wrapper call (Δ and the fused
    # route's LSE/Δ tiles included), CUDA events as library_ms is timed.
    tk = REPORT["train_kernels"]["bfloat16"]
    lk = REPORT["long_kernels"]
    tr, lt = REPORT["training"], REPORT["long_training"]
    for name, label, src, line, n, at, wrap in (
            ("flash_attention_fwd_lse", "fwd_lse", "flash_fwd.cu", 110,
             tr["lse_launches"], tk, "fwd_lse"),
            ("flash_attention_bwd_fused", "bwd_fused", "flash_bwd.cu", 209,
             tr["bwd_fused_launches"], tk, "bwd_fused"),
            ("flash_attention_bwd_split:dq", "bwd_dq", "flash_bwd.cu", 114,
             lt["bwd_dq_launches"], lk, "bwd_split"),
            ("flash_attention_bwd_split:dkv", "bwd_dkv", "flash_bwd.cu", 157,
             lt["bwd_dkv_launches"], lk, "bwd_split")):
        row = at[label]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"ray_tpu_torch/ops/csrc/{src}",
            replaces=f"ray_tpu/ops/pallas/flash.py:{line}", launches=n,
            max_abs_err=row["max_abs_err"], rel_err=row["rel_err"],
            tolerance=row["tolerance"], tolerance_on=row["tolerance_on"],
            ms=row["ms"], kernel_ms=row.get("kernel_ms", row["ms"]),
            wrapper_ms=at["wrapper_ms"][wrap],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=at["shape"] + " bf16"))
        if label == "bwd_fused":
            # ms is the route's two kernels: the Hopper kernel and the
            # ordered dq sum; kernel_ms the Hopper kernel alone. Over the
            # workspace cap (phase 13) the training path takes the split
            # route: the wrapper times of both routes there and their
            # peak memory.
            fc = REPORT["fused_cap"]
            kernels[-1].update(
                dq_sum_ms=row["dq_sum_ms"], cap_shape=fc["shape"],
                cap_route=fc["routes"]["bf16 b2 s8192"],
                cap_wrapper_ms=fc["wrapper_ms"],
                cap_peak_above_inputs_bytes=dict(
                    split=fc["peak_above_inputs_bytes"],
                    fused_one_launch=fc["fused_peak_above_inputs_bytes"]))
        elif label != "fwd_lse":
            kernels[-1].update(
                kernel=SPLIT_KERNELS[torch.bfloat16][label == "bwd_dkv"])
    se = REPORT["serve_engine"]
    serving = dict(card=card, model="GPT-2-small bf16 use_flash",
                   tokens_per_s=se["tokens_per_s"],
                   ttft_p50_ms=se["ttft_p50_ms"],
                   decode_step_ms=REPORT["breakdown"]["decode"]["wall_ms"])
    ss = REPORT["spec_serving"]
    spec_line = dict(card=card, model="GPT-2-small bf16 use_flash", **{
        name: dict(accept_rate=ss[name]["accept_rate"],
                   output_tokens_per_verify_step=ss[name][
                       "output_tokens_per_verify_step"],
                   output_tokens_per_lane_step=ss[name][
                       "output_tokens_per_lane_step"],
                   tokens_per_s=ss[name]["tokens_per_s"],
                   last_step_hardware=ss[name]["last_step"]["hardware"])
        for name in ("ngram", "draft")},
        verify_step_ms={n: dict(wall=ss["step_breakdown"][n]["wall_ms"],
                                device=ss["step_breakdown"][n]["device_ms"][
                                    "total"])
                        for n in ("decode", "verify")},
        f32_tokens_equal=all(r["equal"]
                             for r in REPORT["spec_tokens"].values()))
    train_line = dict(card=card, model=tr["model"], batch=tr["batch"],
                      seq=tr["seq"], losses=tr["losses"],
                      median_step_ms=tr["median_step_ms"],
                      tokens_per_s=tr["tokens_per_s"],
                      device_idle_share=tr["device_idle_share"])
    REPORT["kernels"] = kernels
    REPORT["wall_s"] = time.perf_counter() - t_start
    log(f"[end] chip_smoke wall time {REPORT['wall_s']:.1f} s")
    os.makedirs("smoke_out", exist_ok=True)
    with open(os.path.join("smoke_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1, default=str)
    print(json.dumps({"serving": serving}))
    print(json.dumps({"speculative": spec_line}))
    print(json.dumps({"training": train_line}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
