"""The PyTorch port's training step (ray_tpu_torch/models/gpt.py
``forward``/``loss_fn``/``_xent``/``make_train_step``,
ray_tpu_torch/optim.py, the optimizer state of models/convert.py)
against the JAX model and optax, on the CPU.

The same weights (the JAX init, carried across as numpy) and the same
numpy tokens go through both packages. Tolerances: the loss at atol 1e-4
and every gradient at 1e-3 in f32 (two BLAS libraries sum the
d_model/d_ff reductions in different orders; the reference's gradient
tolerance, tests/test_pallas_flash.py); bf16 loss at 3e-2 and bf16
gradients by relative norm error 3e-2 (tests/test_models.py).

The optimizer is held on IDENTICAL gradients, not on gradients of two
backends: Adam's first update is lr·m̂/(√v̂+ε), about ±lr whatever the
gradient's size, so a parameter whose true gradient is ~0 moves by up
to 2·lr between packages whose BLAS libraries give it ±1e-10. For the
same reason the whole step is held on its losses, not on the parameters
it leaves.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch import optim
from ray_tpu_torch._tree import tree_leaves, tree_map
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import (opt_state_from_numpy,
                                          opt_state_to_numpy,
                                          params_from_numpy, params_to_numpy)
from ray_tpu_torch.ops import flash as t_flash

torch.set_num_threads(1)

ATOL_LOSS = 1e-4
ATOL_GRAD = 1e-3
TOL_BF16 = 3e-2
LR = 3e-4
TINY = dict(vocab_size=512, max_seq=128, d_model=128, n_layer=2, n_head=4)
CONFIGS = {
    # name: (n_kv_head, JAX use_flash, port use_flash). The JAX model's
    # CPU flash path (_flash_reference) takes no GQA, so the GQA case
    # holds the port's flash path against JAX's dense one (the same
    # function at sq == sk).
    "flash": (None, True, True),
    "gqa_flash": (2, False, True),
}
POLICIES = ("dots_flash", "dots", "dots_no_batch", "mlp_only")


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


def _cfgs(name, dtype="f32", **kw):
    kvh, jflash, tflash = CONFIGS[name]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    both = dict(TINY, n_kv_head=kvh, **kw)
    return (jgpt.GPTConfig(dtype=jdt, use_flash=jflash, **both),
            tgpt.GPTConfig(dtype=tdt, use_flash=tflash, **both))


def _tokens(seed, b=2, s=65):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (b, s)).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(a, b):
    """Relative norm error ‖a − b‖/‖b‖."""
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(_np, tree))


def _models(name, dtype="f32", seed=0, **kw):
    jcfg, tcfg = _cfgs(name, dtype, **kw)
    jparams = jgpt.init(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


_jax_loss_and_grads = jax.jit(jax.value_and_grad(jgpt.loss_fn),
                              static_argnums=2)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def f32_run(request):
    """(name, port cfg, port params, JAX (loss, grads), port (loss,
    grads)) on TINY f32, once per configuration."""
    jcfg, tcfg, jparams, tparams = _models(request.param)
    toks = _tokens(1)
    jl, jg = _jax_loss_and_grads(jparams, jnp.asarray(toks), jcfg)
    tl, tg = tgpt.loss_and_grads(tparams, torch.from_numpy(toks), tcfg)
    return request.param, tcfg, tparams, (jl, jg), (tl, tg)


def test_loss_and_grads_match_jax(f32_run):
    name, tcfg, tparams, (jl, jg), (tl, tg) = f32_run
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL_LOSS, rtol=0)
    want = dict(_leaves(jg))
    got = _leaves(params_to_numpy(tg))
    assert len(got) == len(want) == 11
    for path, g in got:
        assert g.shape == want[path].shape
        np.testing.assert_allclose(g, want[path], atol=ATOL_GRAD, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    # Gradients land in f32 (the master params' dtype), not cfg.dtype.
    assert all(t.dtype == torch.float32 for t in tree_leaves(tg))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policies_give_the_same_loss_and_grads(f32_run, policy):
    name, tcfg, tparams, _, (tl, tg) = f32_run
    cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
    toks = torch.from_numpy(_tokens(1))
    rl, rg = tgpt.loss_and_grads(tparams, toks, cfg)
    np.testing.assert_allclose(float(rl), float(tl), atol=1e-6, rtol=0)
    for a, b in zip(tree_leaves(rg), tree_leaves(tg)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("remat,policy,fwd_per_layer", [
    (False, "dots_flash", 1), (True, "dots_flash", 1),
    (True, "mlp_only", 1), (True, "dots", 2), (True, "dots_no_batch", 2)])
def test_attention_forward_runs_per_policy(remat, policy, fwd_per_layer,
                                           monkeypatch):
    """"dots_flash" keeps the kernel's o and LSE, so a step runs the
    forward-with-LSE route exactly once per layer and the backward never
    re-runs it; "dots"/"dots_no_batch" recompute the attention, as the
    JAX policies do (the Pallas call is no dot)."""
    calls = {"lse": 0, "bwd": 0}
    fwd, bwd = (t_flash.flash_attention_fwd_lse_reference,
                t_flash.flash_attention_bwd_reference)

    def count(key, fn):
        return lambda *a, **kw: calls.__setitem__(key, calls[key] + 1) \
            or fn(*a, **kw)

    monkeypatch.setattr(t_flash, "flash_attention_fwd_lse_reference",
                        count("lse", fwd))
    monkeypatch.setattr(t_flash, "flash_attention_bwd_reference",
                        count("bwd", bwd))
    _, tcfg = _cfgs("flash", n_layer=3, vocab_size=64, d_model=32)
    cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tgpt.loss_and_grads(params, torch.arange(17)[None] % 64, cfg)
    assert calls == {"lse": fwd_per_layer * cfg.n_layer,
                     "bwd": cfg.n_layer}


def test_unknown_remat_policy_raises():
    _, tcfg = _cfgs("flash", remat=True, remat_policy="everything")
    params = tgpt.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        tgpt.loss_fn(params, torch.zeros((1, 5), dtype=torch.long), tcfg)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_xent_matches_jax_and_emits_logits_dtype(dtype):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 7, 40)) * 3).astype(np.float32)
    targets = rng.integers(0, 40, (2, 7)).astype(np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jl, jd = jax.value_and_grad(jgpt._xent)(jnp.asarray(logits, jdt),
                                            jnp.asarray(targets))
    tlog = torch.from_numpy(logits).to(tdt).requires_grad_()
    tl = tgpt._xent(tlog, torch.from_numpy(targets))
    tl.backward()
    tl = tl.detach()
    assert tl.dtype == torch.float32 and tlog.grad.dtype == tdt
    # f32: one logsumexp over 40 logits, a few ulps at magnitude ~3;
    # bf16: dlogits are rounded once from f32 values that agree to ~1e-7.
    tol = 1e-5 if dtype == "f32" else 1e-4
    np.testing.assert_allclose(float(tl), float(jl), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(tlog.grad), _np(jd), atol=tol, rtol=0)


def _opt_case(seed):
    """A param tree shaped like the model's (nested dicts, f32) and three
    steps of gradients spanning magnitudes, ~0 included."""
    rng = np.random.default_rng(seed)
    shapes = {"wte": (16, 8), "blocks": {"ln1": (2, 8), "wq": (2, 8, 2, 4)},
              "ln_f": (8,)}

    def draw(scale_fn):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale_fn(s)).astype(
                np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))

    params = draw(lambda s: 1.0)
    grads = [draw(lambda s: 10.0 ** rng.integers(-10, 1, s))
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("mu_dtype", [None, "bf16"])
def test_adamw_matches_optax_on_identical_gradients(mu_dtype):
    """Three steps from the same numpy gradients: the port's adamw from
    optax's state after step 1 (carried across by opt_state_from_numpy)
    lands on optax's params, moments and count. f32: atol 1e-6. A bf16
    first moment rounds where optax's does, so the same bound holds."""
    params, grads = _opt_case(4)
    jopt = optax.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1,
                       mu_dtype=jnp.bfloat16 if mu_dtype else None)
    topt = optim.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1,
                       mu_dtype=torch.bfloat16 if mu_dtype else None)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp, tstate = None, None
    for i, g in enumerate(grads):
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        upd, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        if i == 0:
            tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
            tstate = opt_state_from_numpy(
                jax.tree_util.tree_map(np.asarray, jstate[0]), device="cpu")
            continue
        tg = params_from_numpy(g, device="cpu")
        tupd, tstate = topt.update(tg, tstate, tp)
        tp = optim.apply_updates(tp, tupd)
    want_mu = jax.tree_util.tree_map(np.asarray, jstate[0].mu)
    assert tree_leaves(tstate.mu)[0].dtype == (
        torch.bfloat16 if mu_dtype else torch.float32)
    count, mu, nu = opt_state_to_numpy(tstate)
    assert int(count) == int(jstate[0].count) == 3
    for got, want in ((params_to_numpy(tp), jp), (mu, want_mu),
                      (nu, jstate[0].nu)):
        want = dict(_leaves(want))
        for path, x in _leaves(got):
            np.testing.assert_allclose(x, want[path], atol=1e-6, rtol=0,
                                       err_msg=jax.tree_util.keystr(path))


def test_adamw_decays_every_leaf():
    """optax's mask=None: a zero gradient still shrinks every param,
    layernorm scales and embeddings included, by lr·wd·p."""
    params, _ = _opt_case(5)
    tp = params_from_numpy(params, device="cpu")
    opt = optim.adamw(LR, weight_decay=0.1)
    zeros = tree_map(torch.zeros_like, tp)
    upd, _ = opt.update(zeros, opt.init(tp), tp)
    for u, p in zip(tree_leaves(upd), tree_leaves(tp)):
        torch.testing.assert_close(u, -LR * 0.1 * p, atol=1e-9, rtol=1e-6)


@pytest.fixture(scope="module")
def step_run():
    """Three make_train_step steps in each package from the same params
    and tokens, with the bench's optimizer (bf16 first moment)."""
    jcfg, tcfg, jparams, tparams = _models("flash", seed=2)
    toks = _tokens(6)
    jopt = optax.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1,
                       mu_dtype=jnp.bfloat16)
    topt = optim.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1,
                       mu_dtype=torch.bfloat16)
    jstep = jgpt.make_train_step(jcfg, jopt)
    tstep = tgpt.make_train_step(tcfg, topt)
    jstate = {"params": jparams, "opt_state": jopt.init(jparams), "step": 0}
    tstate = {"params": tparams, "opt_state": topt.init(tparams), "step": 0}
    first = tree_leaves(tparams)
    jl, tl = [], []
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return jl, tl, tstate, first


def test_train_step_losses_match_jax(step_run):
    jl, tl, tstate, first = step_run
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[2] < tl[0]
    assert tstate["step"] == 3 and int(tstate["opt_state"].count) == 3


def test_train_step_donates_params(step_run):
    """donate=True updates the param tensors in place."""
    _, _, tstate, first = step_run
    now = tree_leaves(tstate["params"])
    assert all(a is b for a, b in zip(now, first))
    assert not any(t.requires_grad for t in now)


def test_make_train_step_leaves_mesh_to_the_multi_gpu_slice():
    _, tcfg = _cfgs("flash")
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        tgpt.make_train_step(tcfg, optim.adamw(LR), mesh=object())


def test_bf16_loss_and_grads_within_bf16_tolerance():
    jcfg, tcfg, jparams, tparams = _models("flash", dtype="bf16", seed=7)
    toks = _tokens(8)
    jl, jg = _jax_loss_and_grads(jparams, jnp.asarray(toks), jcfg)
    tl, tg = tgpt.loss_and_grads(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(float(tl), float(jl), atol=TOL_BF16, rtol=0)
    want = dict(_leaves(jg))
    for path, g in _leaves(params_to_numpy(tg)):
        assert _rel(g, want[path]) <= TOL_BF16, jax.tree_util.keystr(path)
