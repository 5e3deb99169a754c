"""Drive the PyTorch port's LLM serving path on one NVIDIA card.

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
  3. slice parity: GPT-2-small f32 prefill + 4 decode steps on the card
     (kernels) against the CPU (plain versions);
  4. serving, engine defaults: GPT-2-small bf16 with use_flash,
     whole-prompt prefill, prefix cache, 8 threaded requests; the launch
     counters show the path went through both kernels;
  5. serving, handler defaults: LLMServer (chunked prefill, prefix
     cache, a shared system prompt) streaming frames to ``done``;
  6. preempt and resume: a pool too small for the batch gives the token
     streams of a roomy one.

Prints a ``{"serving": ...}`` line, the card line, a ``{"kernels":
[...]}`` line and, last, ``{"ok": true, "device": {...}}``. Everything
measured goes to smoke_out/chip_smoke.json as well.
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
# 1e-3 on logits of magnitude ~1.
PARITY_ATOL = 1e-3
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


def time_ms(fn, iters: int, flush: bool = True) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each
    launch, the 50 MB L2 flushed before each so inputs come from HBM as
    they do on the serving path."""
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
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound(flops: float, nbytes: float, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phase 2

def paged_case(dtype, *, b, hkv, group, d, bs, max_nb, q_len=None,
               seed=0, max_ctx=None):
    rng = np.random.default_rng(seed)
    num_blocks = b * max_nb + 1
    max_ctx = max_ctx or max_nb * bs
    lens = rng.integers(max(1, q_len or 1), max_ctx + 1, size=b)
    lens[0] = max_ctx                       # one full-length context
    tables = np.zeros((b, max_nb), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    used = 0
    for i, n in enumerate(lens):
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


def check_paged():
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        c = paged_case(dtype, b=8, hkv=12, group=1, d=64, bs=16, max_nb=64,
                       seed=10)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
        out = k_paged.paged_decode_attention(*args)
        ref = k_paged.paged_decode_attention_reference(*args)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = TOL[("paged", dtype)]
        assert out.shape == ref.shape and torch.isfinite(out.float()).all()
        assert err <= tol, f"paged decode {dtype}: err {err} > {tol}"
        ms = time_ms(lambda: k_paged.paged_decode_attention(*args), 200)
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
                         tolerance=tol, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, sum_ctx=ctx,
                         shape="b8 hkv12 group1 d64 bs16 max_nb64"))
        log(f"[2] paged_decode {rows[-1]}")
    # Other block sizes and head dims (the tile holds 64 // bs blocks,
    # or one block when bs >= 64).
    for (bs, d, group, dtype) in ((8, 64, 2, torch.bfloat16),
                                  (128, 128, 1, torch.float32),
                                  (32, 16, 4, torch.float32)):
        c = paged_case(dtype, b=4, hkv=3, group=group, d=d, bs=bs,
                       max_nb=6, seed=15)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"])
        err = max_err(k_paged.paged_decode_attention(*args),
                      k_paged.paged_decode_attention_reference(*args))
        assert err <= TOL[("paged", dtype)], \
            f"paged decode bs{bs} d{d} group{group}: err {err}"
        log(f"[2] paged_decode bs{bs} d{d} group{group} {dtype} err {err:.3g}")
    # Verify: group > 1, q_len 4 (one kernel serves both).
    for dtype in (torch.bfloat16, torch.float32):
        c = paged_case(dtype, b=3, hkv=2, group=4, d=64, bs=16, max_nb=8,
                       q_len=4, seed=20)
        q_lens = torch.tensor([4, 2, 1], dtype=torch.int32, device=DEV)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"], q_lens)
        out = k_paged.paged_verify_attention(*args)
        ref = k_paged.paged_verify_attention_reference(*args)
        torch.cuda.synchronize()
        err = max(max_err(out[i, :n], ref[i, :n])
                  for i, n in enumerate(q_lens.tolist()))
        tol = TOL[("paged", dtype)]
        assert err <= tol, f"paged verify {dtype}: err {err} > {tol}"
        log(f"[2] paged_verify {dtype} group4 q_len4 err {err:.3g}")
    return rows


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
    # Beyond the serving shape: layout bshd through strides, GQA, dense,
    # sq != sk (top-left causal), the smallest and largest head dims.
    for (b, sq, sk, h, hk, d, dtype) in (
            (2, 200, 200, 8, 2, 32, torch.bfloat16),
            (1, 100, 300, 4, 4, 128, torch.float32),
            (3, 70, 70, 2, 1, 16, torch.float32)):
        for causal in (True, False):
            q = randn((b, sq, h, d), dtype, 40)
            k = randn((b, sk, hk, d), dtype, 41)
            v = randn((b, sk, hk, d), dtype, 42)
            out = k_flash.flash_attention_fwd(q, k, v, causal=causal)
            ref = k_flash.flash_attention_reference(q, k, v, causal=causal)
            err = max_err(out, ref)
            assert err <= TOL[("flash", dtype)], \
                f"flash bshd sq{sq} sk{sk} d{d} causal={causal}: err {err}"
            log(f"[2] flash bshd b{b} sq{sq} sk{sk} h{h}/{hk} d{d} {dtype} "
                f"causal={causal} err {err:.3g}")
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

def reset_counts():
    k_paged.launches = 0
    k_flash.launches = 0


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
    if "paged_attention_kernel" in name:
        return "paged_decode"
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if any(s in name.lower() for s in ("gemm", "gemv", "cutlass", "sm90_",
                                       "xmma", "cublas", "nvjet")):
        return "matmul"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "copy"
    return "other"


def device_busy(fn, steps: int):
    """Device busy time per call of ``fn`` in ms, by kernel group, from a
    torch.profiler CUDA trace (kernels on one stream do not overlap, so
    their durations add up to the busy time). None where the trace has
    no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # The profiler warns once that events are cleared per cycle;
        # this window is one cycle.
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
    groups, names = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            g = _kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + us
            names[e.name[:80]] = names.get(e.name[:80], 0.0) + us
    if not groups:
        return None
    out = {g: us / 1e3 / steps for g, us in sorted(groups.items())}
    out["total"] = sum(out.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    REPORT.setdefault("top_kernels", []).append(
        [(n, us / 1e3 / steps) for n, us in top])
    return out


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
        busy = device_busy(fn, 5)
        out[name] = dict(wall_ms=wall, device_ms=busy,
                         device_idle_share=(None if busy is None else
                                            max(0.0, 1 - busy["total"]
                                                / wall)))
    log(f"[4] step breakdown (decode b8 ctx512, prefill 960 flash): {out}")
    return out


# ---------------------------------------------------------------- phase 5

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
        counts = dict(paged=k_paged.launches, flash=k_flash.launches)
        stats = srv.engine_stats()
    finally:
        srv.engine.stop()
    assert not any(t.is_alive() for t in threads), "a client hung"
    for frames in [first] + results:
        assert frames[-1]["done"] is True, frames[-1]
        toks = [f["token"] for f in frames[:-1]]
        assert len(toks) == frames[-1]["num_tokens"] == 32, frames[-1]
    cached = [r[-1]["cached_tokens"] for r in results]
    assert all(c > 0 for c in cached), cached
    assert counts["paged"] > 0
    out = dict(cached_tokens=cached, hit_rate=stats["kv_cache_hit_rate"],
               prefill_chunks=stats["prefill_chunks"], launches=counts)
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


def main():
    card = card_line()
    log(f"[1] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = _build.build_all()
    k_paged._lib()
    k_flash._lib()
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

    main_paged = REPORT["paged"][0]
    main_flash = REPORT["flash"][0]
    kernels = [
        dict(name="paged_decode_attention", route="cuda",
             source="ray_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="ray_tpu/ops/pallas/paged_decode.py:45",
             launches=REPORT["serve_engine"]["paged_launches"],
             max_abs_err=main_paged["max_abs_err"],
             tolerance=main_paged["tolerance"], ms=main_paged["ms"],
             kernel_ms=main_paged["ms"], plain_ms=main_paged["plain_ms"],
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
    se = REPORT["serve_engine"]
    serving = dict(card=card, model="GPT-2-small bf16 use_flash",
                   tokens_per_s=se["tokens_per_s"],
                   ttft_p50_ms=se["ttft_p50_ms"],
                   decode_step_ms=REPORT["breakdown"]["decode"]["wall_ms"])
    REPORT["kernels"] = kernels
    os.makedirs("smoke_out", exist_ok=True)
    with open(os.path.join("smoke_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1, default=str)
    print(json.dumps({"serving": serving}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
