"""Flash attention's training path in the PyTorch port
(ray_tpu_torch/ops/flash.py: the forward with LSE, the fused and split
backward, ``FlashAttention``) against the JAX package's Pallas kernels,
on the CPU.

On a CPU tensor each kernel wrapper takes its plain PyTorch version, so
these tests hold those plain versions (the arithmetic the CUDA kernels
repeat) against the Pallas kernels in interpret mode, called through the
forward and backward of ``flash_attention_pallas``'s custom VJP
(``_fwd``/``_bwd``), at the reference's own test sizes (b 1, s 41-64, h 2, d 16,
blocks 16; tests/test_pallas_flash.py). The CUDA kernels are held
against the same plain versions on the card by chip_smoke.py.

Inputs and the output cotangent are made from numpy seeds and handed to
both packages as numpy. Tolerances are the reference's own: f32 forward
and LSE atol 2e-5 (an online softmax against a dense one: only rounding
differs), gradients 1e-3, and 2e-3 on the split path and ragged
lengths (tests/test_pallas_flash.py:118-140); bf16 by relative norm
error 3e-2.
"""

import os
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import flash as jax_flash
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.ops import flash as t_flash
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch._tree import tree_map

torch.set_num_threads(1)

ATOL_FWD = 2e-5
ATOL_GRAD = 1e-3
ATOL_GRAD_SPLIT = 2e-3
RTOL_BF16 = 3e-2
BLOCK = 16

CASES = {
    # name: (seed, b, s, h, kv_heads, d, causal, layout, dtype)
    "dense": (2, 1, 64, 2, 2, 16, False, "bshd", "f32"),
    "ragged_causal": (3, 1, 50, 2, 2, 16, True, "bshd", "f32"),
    "ragged_dense": (4, 1, 41, 2, 2, 16, False, "bshd", "f32"),
    "gqa": (5, 1, 48, 4, 2, 16, True, "bshd", "f32"),
    "bhsd": (6, 1, 64, 2, 2, 16, True, "bhsd", "f32"),
    "bf16": (7, 1, 64, 2, 2, 32, True, "bshd", "bf16"),
}


@pytest.fixture(scope="module", autouse=True)
def _two_cores():
    """Run this module's threads (torch's, and the JAX compiler's and
    runtime's, which torch.set_num_threads does not reach) on two cores,
    so that under the suite's parallel workers the timing-sensitive
    tests elsewhere keep the rest of the machine. Every thread's mask is
    restored afterwards."""
    if not hasattr(os, "sched_setaffinity"):
        yield
        return
    full = os.sched_getaffinity(0)
    cpus = sorted(full)
    w = int(os.environ.get("PYTEST_XDIST_WORKER", "gw0").lstrip("gw") or 0)
    cores = {cpus[(2 * w) % len(cpus)], cpus[(2 * w + 1) % len(cpus)]}

    def pin(mask):
        for tid in os.listdir("/proc/self/task"):
            try:
                os.sched_setaffinity(int(tid), mask)
            except OSError:   # the thread ended meanwhile
                pass

    pin(cores)
    try:
        yield
    finally:
        pin(full)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(seed, b, s, h, hk, d, layout):
    rng = np.random.default_rng(seed)

    def shape(heads):
        return (b, s, heads, d) if layout == "bshd" else (b, heads, s, d)

    return [rng.standard_normal(shape(n), np.float32)
            for n in (h, hk, hk, h)]          # q, k, v, output cotangent


def _jax_run(q, k, v, g, causal, layout, dtype):
    """The Pallas kernels (interpret mode) as ``flash_attention_pallas``
    runs them under grad: K/V expanded by ``jnp.repeat`` (GQA), the
    custom VJP's forward ``_fwd`` (out and the LSE residual) and its
    backward ``_bwd``, dk/dv summed back over each group (the transpose
    of the repeat). Returns out, lse [b, h, s] and (dq, dk, dv)."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    h_ax = 2 if layout == "bshd" else 1
    hk = jk.shape[h_ax]
    rep = jq.shape[h_ax] // hk
    ek, ev = (jnp.repeat(x, rep, axis=h_ax) for x in (jk, jv))
    opts = dict(causal=causal, blk_q=BLOCK, blk_k=BLOCK, interpret=True,
                heads_major=layout == "bhsd")
    out, res = jax_flash._fwd(jq, ek, ev, **opts)
    dq, dk, dv = jax_flash._bwd(res, jg, **opts)
    shape = jk.shape[:h_ax] + (hk, rep) + jk.shape[h_ax + 1:]
    dk, dv = (x.reshape(shape).sum(h_ax + 1) for x in (dk, dv))
    s = q.shape[1 if layout == "bshd" else 2]
    lse = np.asarray(res[4])[:, :, :s, 0]
    return out, lse, (dq, dk, dv)


def _torch_run(q, k, v, g, causal, layout, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, block_size=BLOCK,
                          layout=layout)
    out.backward(torch.from_numpy(g).to(tdt))
    _, lse = t_flash.flash_attention_fwd_lse(
        tq.detach(), tk.detach(), tv.detach(), causal=causal, layout=layout)
    return out, lse, (tq.grad, tk.grad, tv.grad)


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """(case, JAX run, port run) on the default (fused) backward; each
    case runs once and is shared by the tests below."""
    seed, b, s, h, hk, d, causal, layout, dt = CASES[request.param]
    x = _inputs(seed, b, s, h, hk, d, layout)
    return (request.param, _jax_run(*x, causal, layout, dt),
            _torch_run(*x, causal, layout, dt))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_forward_and_lse_match_pallas(run):
    case, (jo, jlse, _), (to, tlse, _) = run
    assert to.shape == jo.shape and tlse.dtype == torch.float32
    assert torch.isfinite(tlse).all()
    if CASES[case][-1] == "bf16":
        assert to.dtype == torch.bfloat16
        assert _rel(to, jo) <= RTOL_BF16
        assert _rel(tlse, jlse) <= RTOL_BF16
        return
    np.testing.assert_allclose(_np(to), _np(jo), atol=ATOL_FWD, rtol=0)
    np.testing.assert_allclose(_np(tlse), jlse, atol=ATOL_FWD, rtol=0)


def test_fused_backward_matches_pallas(run):
    case, (_, _, jg), (_, _, tg) = run
    ragged = case.startswith("ragged")
    for name, a, b in zip("qkv", tg, jg):
        assert a.shape == b.shape, name
        if CASES[case][-1] == "bf16":
            assert a.dtype == torch.bfloat16
            assert _rel(a, b) <= RTOL_BF16, name
        else:
            np.testing.assert_allclose(
                _np(a), _np(b), atol=ATOL_GRAD_SPLIT if ragged else
                ATOL_GRAD, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["ragged_dense", "gqa"])
def test_split_backward_matches_pallas(case, monkeypatch):
    """The long-sequence path, forced in BOTH packages by a zero budget
    (as tests/test_pallas_flash.py:118-123 forces the reference's)."""
    monkeypatch.setattr(jax_flash, "_FUSED_BWD_VMEM_BUDGET", 0)
    monkeypatch.setattr(t_flash, "_FUSED_BWD_VMEM_BUDGET", 0)
    calls = []
    split = t_flash.flash_attention_bwd_split
    monkeypatch.setattr(t_flash, "flash_attention_bwd_split",
                        lambda *a, **kw: calls.append(1) or split(*a, **kw))
    seed, b, s, h, hk, d, causal, layout, dt = CASES[case]
    x = _inputs(seed, b, s, h, hk, d, layout)
    _, _, jg = _jax_run(*x, causal, layout, dt)
    _, _, tg = _torch_run(*x, causal, layout, dt)
    assert calls == [1]
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL_GRAD_SPLIT,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("s,d,itemsize,block", [
    (1023, 64, 2, 512), (1024, 64, 4, 512), (16384, 64, 2, 512),
    (8192, 128, 4, 512), (50, 16, 4, 16), (7, 16, 4, 512)])
def test_backward_route_follows_the_reference_rule(s, d, itemsize, block):
    """The same shapes take the fused or the split path in both
    packages: the port's copy of ``_fused_bwd_fits`` at the reference's
    padded lengths."""
    blk = min(block, max(s, 8))
    s_p = jax_flash._pad_seq(jnp.zeros((1, 1, s, 1)), blk).shape[2]
    assert t_flash._padded(s, block) == s_p
    assert t_flash._fused_bwd_fits(s_p, s_p, d, itemsize) == \
        jax_flash._fused_bwd_fits(s_p, s_p, d, itemsize)
    assert t_flash._FUSED_BWD_VMEM_BUDGET == \
        jax_flash._FUSED_BWD_VMEM_BUDGET


def test_fused_route_is_the_default(monkeypatch):
    calls = []
    fused = t_flash.flash_attention_bwd_fused
    monkeypatch.setattr(t_flash, "flash_attention_bwd_fused",
                        lambda *a, **kw: calls.append(1) or fused(*a, **kw))
    q, k, v, g = (torch.from_numpy(x).requires_grad_() for x in
                  _inputs(8, 1, 40, 2, 2, 16, "bshd"))
    flash_attention(q, k, v).backward(g.detach())
    assert calls == [1] and q.grad is not None


def _counting(monkeypatch):
    """Count the plain forwards each route takes on the CPU."""
    seen = {"primal": 0, "lse": 0}
    for route, name in (("primal", "flash_attention_reference"),
                        ("lse", "flash_attention_fwd_lse_reference")):
        real = getattr(t_flash, name)

        def wrap(*a, _real=real, _route=route, **kw):
            seen[_route] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(t_flash, name, wrap)
    return seen


def test_serving_keeps_the_primal_route(monkeypatch):
    """Without grad, flash_attention and the use_flash prefill take the
    primal forward and never the LSE route."""
    seen = _counting(monkeypatch)
    q, k, v, _ = (torch.from_numpy(x) for x in
                  _inputs(9, 1, 24, 2, 2, 16, "bshd"))
    with torch.no_grad():
        flash_attention(q.requires_grad_(), k, v)
    flash_attention(q.detach(), k, v)
    assert seen == {"primal": 2, "lse": 0}
    cfg = tgpt.GPTConfig(vocab_size=64, max_seq=32, d_model=32, n_layer=2,
                         n_head=2, dtype=torch.float32, use_flash=True)
    params = tree_map(lambda t: t.requires_grad_(), tgpt.init(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    toks = torch.arange(12)[None] % 64
    tgpt.forward_prefill(params, toks, cfg)
    assert seen == {"primal": 2 + cfg.n_layer, "lse": 0}
    # With grad, the training forward takes the LSE route.
    tgpt.loss_and_grads(params, toks, cfg)
    assert seen == {"primal": 2 + cfg.n_layer, "lse": cfg.n_layer}


def test_cpu_backward_counts_no_launch():
    before = (t_flash.launches, t_flash.lse_launches,
              t_flash.bwd_fused_launches, t_flash.bwd_dq_launches,
              t_flash.bwd_dkv_launches)
    q, k, v, g = (torch.from_numpy(x).requires_grad_() for x in
                  _inputs(10, 1, 20, 2, 1, 16, "bshd"))
    flash_attention(q, k, v).backward(g.detach())
    after = (t_flash.launches, t_flash.lse_launches,
             t_flash.bwd_fused_launches, t_flash.bwd_dq_launches,
             t_flash.bwd_dkv_launches)
    assert before == after
