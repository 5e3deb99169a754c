"""GPT inference forwards of the PyTorch port (ray_tpu_torch/models)
against the JAX model, on the CPU.

The same weights (the JAX init, carried across as numpy through
models/convert.py) and the same numpy inputs go through both packages.
Model-level tolerance is atol 1e-4 in f32: two BLAS libraries sum the
d_model/d_ff reductions in different orders, compounded over the
layers; the op-level tests (test_torch_ops.py) hold 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

ATOL = 1e-4
L, V, S, M, H = 2, 128, 64, 64, 4
CONFIGS = {
    # name: (n_kv_head, JAX use_flash, port use_flash). The JAX model's
    # CPU flash path (_flash_reference) takes no GQA, so the GQA case
    # holds the port's flash path against JAX's dense one: the same
    # function when, as in a prefill, sq == sk.
    "dense": (None, False, False),
    "flash": (None, True, True),
    "gqa_flash": (2, False, True),
}


def _cfgs(name):
    kvh, jflash, tflash = CONFIGS[name]
    kw = dict(vocab_size=V, max_seq=S, d_model=M, n_layer=L, n_head=H,
              n_kv_head=kvh)
    return (jgpt.GPTConfig(dtype=jnp.float32, use_flash=jflash, **kw),
            tgpt.GPTConfig(dtype=torch.float32, use_flash=tflash, **kw))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jgpt.init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_params_round_trip_through_numpy(model):
    jcfg, tcfg, jparams, tparams = model
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = params_to_numpy(tparams)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == 11
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert tparams["blocks"]["wq"].shape == (L, M, H, M // H)
    with pytest.raises(ValueError):
        params_from_numpy(tree, tgpt.GPTConfig(dtype=torch.float32),
                          device="cpu")


def test_forward_and_prefill_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(1).integers(0, V, (2, 24)).astype(np.int32)
    ref = jgpt.forward(jparams, jnp.asarray(toks), jcfg)
    out = tgpt.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL)

    jl, jk, jv = jgpt.forward_prefill(jparams, jnp.asarray(toks), jcfg)
    tl, tk, tv = tgpt.forward_prefill(tparams, torch.from_numpy(toks), tcfg)
    assert tuple(tk.shape) == jk.shape == (L, 2, 24, jcfg.kv_heads,
                                          jcfg.head_dim)
    for a, b in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)


def _pools(cfg, nb, bs, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layer, cfg.kv_heads, nb, bs, cfg.head_dim)
    return (rng.standard_normal(shape, np.float32) * 0.5,
            rng.standard_normal(shape, np.float32) * 0.5)


def test_forward_decode_matches_jax_logits_and_pools(model):
    """Write-then-attend over block tables, padded lanes on scratch
    block 0; logits and every non-scratch pool block agree."""
    jcfg, tcfg, jparams, tparams = model
    bs, nb, B, max_nb = 8, 16, 4, 8
    kp, vp = _pools(jcfg, nb, bs, 2)
    ctx = [13, 1, 24]                       # lane 3 is padding
    tables = np.zeros((B, max_nb), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :1] = [5]
    tables[2, :4] = [1, 9, 12, 2]
    tokens = np.array([5, 9, 100, 0], np.int32)
    positions = np.array([c - 1 for c in ctx] + [0], np.int32)
    lens = np.array(ctx + [1], np.int32)
    slot_b = np.array([tables[i, (c - 1) // bs] for i, c in enumerate(ctx)]
                      + [0], np.int32)
    slot_o = np.array([(c - 1) % bs for c in ctx] + [0], np.int32)
    jl, jk, jv = jgpt.forward_decode(
        jparams, *(jnp.asarray(x) for x in (tokens, positions, kp, vp,
                                            tables, lens, slot_b, slot_o)),
        jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tk2, tv2 = tgpt.forward_decode(
        tparams, torch.from_numpy(tokens), torch.from_numpy(positions), tk,
        tv, *(torch.from_numpy(x) for x in (tables, lens, slot_b, slot_o)),
        tcfg)
    assert tk2 is tk and tv2 is tv          # pools updated in place
    np.testing.assert_allclose(_np(tl)[:3], _np(jl)[:3], atol=ATOL)
    for a, b in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a)[:, :, 1:], _np(b)[:, :, 1:],
                                   atol=ATOL)


def test_forward_prefill_chunk_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    bs, nb, max_nb = 8, 16, 8
    kp, vp = _pools(jcfg, nb, bs, 3)
    table = np.zeros((max_nb,), np.int32)
    table[:4] = [4, 11, 2, 6]
    ctx_len, c = 16, 8
    toks = np.random.default_rng(4).integers(0, V, (1, c)).astype(np.int32)
    positions = (ctx_len + np.arange(c)).astype(np.int32)
    jl, jk, jv = jgpt.forward_prefill_chunk(
        jparams, jnp.asarray(toks), jnp.asarray(positions), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.int32(ctx_len), jcfg)
    tl, tk, tv = tgpt.forward_prefill_chunk(
        tparams, torch.from_numpy(toks), torch.from_numpy(positions),
        torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(table),
        ctx_len, tcfg)
    for a, b in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)


def test_bf16_forward_within_bf16_tolerance():
    """The working dtype end to end (bf16 matmuls, f32 layernorm and
    softmax) stays within the JAX model test's bf16 tolerance."""
    jcfg, tcfg = _cfgs("flash")
    jcfg = jgpt.GPTConfig(**{**jcfg.__dict__, "dtype": jnp.bfloat16})
    tcfg = tgpt.GPTConfig(**{**tcfg.__dict__, "dtype": torch.bfloat16})
    jparams = jgpt.init(jax.random.PRNGKey(5), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    toks = np.random.default_rng(5).integers(0, V, (1, 32)).astype(np.int32)
    ref = jgpt.forward(jparams, jnp.asarray(toks), jcfg)
    wp = tgpt.working_params(tparams, tcfg)
    assert wp["blocks"]["wq"].dtype == torch.bfloat16
    assert wp["blocks"]["ln1"].dtype == torch.float32
    out = tgpt.forward(wp, torch.from_numpy(toks), tcfg)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), atol=3e-2, rtol=3e-2)


def test_init_shapes_and_scales():
    tcfg = _cfgs("gqa_flash")[1]
    p = tgpt.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["blocks"]["wk"].shape == (L, M, 2, M // H)
    assert p["blocks"]["wo"].shape == (L, H, M // H, M)
    assert float(p["wte"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(p["blocks"]["wm"].std()) == pytest.approx(
        0.02 / np.sqrt(2 * L), rel=0.1)
    assert torch.equal(p["ln_f"], torch.ones(M))
    again = tgpt.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["wte"], again["wte"])
