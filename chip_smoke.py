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
     host enqueues the call, so it is the call's device time;
  3. slice parity: GPT-2-small f32 prefill + 4 decode steps on the card
     (kernels) against the CPU (plain versions);
  4. serving, engine defaults: GPT-2-small bf16 with use_flash,
     whole-prompt prefill, prefix cache, 8 threaded requests; the launch
     counters show the path went through both kernels;
  5. serving, handler defaults: LLMServer (chunked prefill, prefix
     cache, a shared system prompt) streaming frames to ``done``;
  6. preempt and resume: a pool too small for the batch gives the token
     streams of a roomy one;
  7. the training kernels (forward with LSE, fused backward, split dq and
     dk/dv backward) against their plain versions on the card at the
     training shape (b 8, h 12, s 1023, d 64, causal, bf16 and f32), at
     s 1024, head dims 32 and 128, GQA, and through ``FlashAttention``
     with the split path forced; each timed beside its bound and its
     library yardstick (SDPA's flash forward and backward): the kernel
     alone from a profiler trace, the wrapper and SDPA with CUDA events;
     with the kernels' register and spill report from nvcc;
  8. training slice parity: GPT-2-small f32, b 1, s 128, loss and every
     gradient from the card's kernels against the CPU plain versions;
  9. the training path: GPT-2-small bf16 with use_flash, remat
     "dots_flash" and the bench's AdamW (bf16 first moment), 6 steps on
     one [8, 1024] batch: the loss is finite and falls, and each step
     launches the LSE-route forward and the fused backward once per
     layer and nothing else; median step ms, tokens/s and a profiled
     step's device time by kernel group;
 10. the long-sequence training path: GPT-2-small width, 2 layers,
     max_seq 16384, one step on [1, 16384]: the backward takes the split
     kernels, once each per layer; then the three training kernels at
     that shape ([1, 16384, 12, 64] bf16) against their plain versions
     (run two heads at a time), timed as in phase 7.

Prints a ``{"serving": ...}`` line, a ``{"training": ...}`` line, the
card line, a ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``. Everything measured goes to
smoke_out/chip_smoke.json as well.
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
    if "paged_attention_kernel" in name:
        return "paged_decode"
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "flash_bwd_kv_kernel" in name:
        return "flash_bwd_kv"
    if "flash_bwd_dq_kernel" in name:
        return "flash_bwd_dq"
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
        seen = counts()
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
    assert seen["paged"] > 0
    assert all(seen[n] == 0 for n in _FLASH_COUNTERS[1:]), seen
    out = dict(cached_tokens=cached, hit_rate=stats["kv_cache_hit_rate"],
               prefill_chunks=stats["prefill_chunks"], launches=seen)
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


# ---------------------------------------------------------------- phase 7

def kernel_device_ms(fn, labels: dict, iters: int = 20) -> dict:
    """Median device time in ms of each kernel of ``fn`` whose name
    contains ``labels[label]``, from a torch.profiler CUDA trace of
    ``iters`` calls, the 50 MB L2 flushed before each (inputs come from
    HBM, as on the training path)."""
    from torch.profiler import ProfilerActivity, profile

    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                _FLUSH.zero_()
                fn()
            torch.cuda.synchronize()
    out = {}
    for label, sub in labels.items():
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and sub in e.name]
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


def train_inputs(b, s, h, hk, d, dtype, seed, layout="bshd"):
    def shape(n):
        return (b, s, n, d) if layout == "bshd" else (b, n, s, d)

    return (randn(shape(h), dtype, seed), randn(shape(hk), dtype, seed + 1),
            randn(shape(hk), dtype, seed + 2), randn(shape(h), dtype,
                                                     seed + 3))


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
        check_grads(split, ref, dtype, f"split {dtype}")
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
            {"fwd_lse": "flash_fwd_kernel"})
        dev_ms.update(kernel_device_ms(
            lambda: k_flash.flash_attention_bwd_fused(*args),
            {"bwd_fused": "flash_bwd_kv_kernel"}))
        dev_ms.update(kernel_device_ms(
            lambda: k_flash.flash_attention_bwd_split(*args),
            {"bwd_dq": "flash_bwd_dq_kernel",
             "bwd_dkv": "flash_bwd_kv_kernel"}))
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
    layout bhsd, dense; then FlashAttention end to end with the split
    path forced (budget 0), against the plain versions."""
    out = []
    for (b, s, h, hk, d, dtype, layout, causal) in (
            (2, 1024, 12, 12, 64, torch.bfloat16, "bshd", True),
            (2, 1024, 12, 12, 64, torch.float32, "bhsd", True),
            (2, 300, 8, 8, 32, torch.float32, "bshd", True),
            (1, 200, 4, 4, 128, torch.bfloat16, "bshd", False),
            (2, 333, 8, 2, 64, torch.float32, "bshd", True),
            (1, 129, 4, 1, 128, torch.float32, "bhsd", False)):
        q, k, v, do = train_inputs(b, s, h, hk, d, dtype, 60, layout)
        kw = dict(causal=causal, layout=layout)
        o, lse = k_flash.flash_attention_fwd_lse(q, k, v, **kw)
        o_ref, lse_ref = k_flash.flash_attention_fwd_lse_reference(
            q, k, v, **kw)
        assert max_err(o, o_ref) <= TOL[("flash", dtype)]
        assert max_err(lse, lse_ref) <= TOL[("flash", torch.float32)]
        ref = k_flash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                    **kw)
        what = f"b{b} s{s} h{h}/{hk} d{d} {layout} causal={causal}"
        e_f, _ = check_grads(k_flash.flash_attention_bwd_fused(
            q, k, v, o, lse, do, **kw), ref, dtype, "fused " + what)
        e_s, _ = check_grads(k_flash.flash_attention_bwd_split(
            q, k, v, o, lse, do, **kw), ref, dtype, "split " + what)
        out.append(dict(case=what, dtype=str(dtype).split(".")[-1],
                        fwd_err=max_err(o, o_ref),
                        lse_err=max_err(lse, lse_ref), fused_err=e_f,
                        split_err=e_s))
        log(f"[7] {out[-1]}")
    # FlashAttention through autograd, split path forced.
    from ray_tpu_torch.ops.flash_attention import flash_attention

    budget = k_flash._FUSED_BWD_VMEM_BUDGET
    k_flash._FUSED_BWD_VMEM_BUDGET = 0
    try:
        q, k, v, do = train_inputs(2, 1023, 12, 12, 64, torch.float32, 70)
        reset_counts()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        flash_attention(*leaves).backward(do)
        seen = counts()
    finally:
        k_flash._FUSED_BWD_VMEM_BUDGET = budget
    o, lse = k_flash.flash_attention_fwd_lse_reference(q, k, v)
    ref = k_flash.flash_attention_bwd_reference(q, k, v, o, lse, do)
    e, _ = check_grads([t.grad for t in leaves], ref, torch.float32,
                       "FlashAttention split forced")
    assert (seen["lse_launches"], seen["bwd_dq_launches"],
            seen["bwd_dkv_launches"], seen["bwd_fused_launches"]) == \
        (1, 1, 1, 0), seen
    out.append(dict(case="FlashAttention b2 s1023 h12 d64 f32, split "
                    "forced", grad_err=e, launches=seen))
    log(f"[7] {out[-1]}")
    return out


def ptxas_report() -> dict:
    """Registers and spills of each kernel of the training sources at
    head dim 64, from nvcc's -Xptxas -v report of the libraries this run
    loaded (kept beside each library, so a reused build has it too)."""
    import re

    out = {}
    for src in ("flash_fwd", "flash_bwd"):
        text = _build.build_report(src)
        for m in re.finditer(
                r"Compiling entry function '(\w+)'.*?\n(.*?)Used (\d+) "
                r"registers", text, re.S):
            name, body, regs = m.group(1), m.group(2), int(m.group(3))
            if "Li64E" not in name:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", body)
            kern = re.search(r"(?<=\d)(flash_[a-z_]+_kernel)I"
                             r"(13__nv_bfloat16|f)Li64E(Lb[01]E)?", name)
            label = (kern.group(1)
                     + ("_fused" if kern.group(3) == "Lb1E" else
                        "_split" if kern.group(3) == "Lb0E" else "")
                     + ("_bf16" if "bfloat16" in kern.group(2) else "_f32"))
            out[label] = dict(registers=regs,
                              spill_stores=int(spill.group(1)) if spill
                              else None,
                              spill_loads=int(spill.group(2)) if spill
                              else None)
    want = {f"{k}_{t}" for t in ("bf16", "f32")
            for k in ("flash_fwd_kernel", "flash_bwd_kv_kernel_fused",
                      "flash_bwd_kv_kernel_split", "flash_bwd_dq_kernel")}
    assert set(out) == want, f"ptxas report: {sorted(out)} != {sorted(want)}"
    log(f"[7] ptxas (d 64): {out}")
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

    busy = device_busy(one_step, 1)
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
    losses, wall, seen, _, _ = train_path(cfg, tokens, 1, 13)
    c = seen[0]
    L = cfg.n_layer
    assert np.isfinite(losses[0]), losses
    assert (c["lse_launches"], c["bwd_dq_launches"],
            c["bwd_dkv_launches"], c["bwd_fused_launches"],
            c["launches"]) == (L, L, L, 0, 0), c
    out = dict(model="GPT-2-small width, 2 layers, bf16, max_seq 16384",
               loss=losses[0], step_ms=wall[0],
               bwd_dq_launches=c["bwd_dq_launches"],
               bwd_dkv_launches=c["bwd_dkv_launches"],
               lse_launches=c["lse_launches"])
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
        {"fwd_lse": "flash_fwd_kernel"}, iters=10)
    dev_ms.update(kernel_device_ms(
        lambda: k_flash.flash_attention_bwd_fused(*args),
        {"bwd_fused": "flash_bwd_kv_kernel"}, iters=10))
    dev_ms.update(kernel_device_ms(
        lambda: k_flash.flash_attention_bwd_split(*args),
        {"bwd_dq": "flash_bwd_dq_kernel", "bwd_dkv": "flash_bwd_kv_kernel"},
        iters=10))
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
    rows["wrapper_ms"] = wrapper_ms
    rows["shape"] = f"b{b} s{s} h{h} d{d} causal bshd"
    log(f"[10] long-sequence kernels: {rows}")
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return rows


def main():
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
    # Each training kernel at the shape of the path that launches it:
    # the forward with LSE and the fused backward at the training step's
    # [8, 1023, 12, 64], the split pair at the long step's [1, 16384,
    # 12, 64]. wrapper_ms: the whole wrapper call (Δ, dq's zeroing and
    # cast included), CUDA events as library_ms is timed.
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
            ms=row["ms"], wrapper_ms=at["wrapper_ms"][wrap],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=at["shape"] + " bf16"))
    se = REPORT["serve_engine"]
    serving = dict(card=card, model="GPT-2-small bf16 use_flash",
                   tokens_per_s=se["tokens_per_s"],
                   ttft_p50_ms=se["ttft_p50_ms"],
                   decode_step_ms=REPORT["breakdown"]["decode"]["wall_ms"])
    train_line = dict(card=card, model=tr["model"], batch=tr["batch"],
                      seq=tr["seq"], losses=tr["losses"],
                      median_step_ms=tr["median_step_ms"],
                      tokens_per_s=tr["tokens_per_s"],
                      device_idle_share=tr["device_idle_share"])
    REPORT["kernels"] = kernels
    os.makedirs("smoke_out", exist_ok=True)
    with open(os.path.join("smoke_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1, default=str)
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": train_line}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
