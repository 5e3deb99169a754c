"""The PyTorch port's speculative decoding (ray_tpu_torch.llm.spec, the
engine's verify step, models/gpt.py ``forward_verify`` and the verify
samplers of llm/sampling.py) against the JAX package, on the CPU.

Both packages get the same f32 weights (the JAX init carried across as
numpy by models/convert.py) and the JAX spec tests' tiny configuration
(tests/test_llm_spec.py: vocab 128, 2 layers, ``num_blocks`` 32,
``block_size`` 8, ``max_batch`` 4). What is held:

  * ``forward_verify`` against the JAX one on one seeded batch: lanes
    with q_lens < Q, a lane whose span crosses a block, a padding lane;
    logits of the real rows at f32 atol 1e-4, both pools at 2e-5 (block
    0, the scratch block the padding rows collide on, left out: its
    contents are garbage by contract);
  * ``verify_tokens``, ``target_probs`` and ``rejection_sample`` against
    the JAX functions on identical rows;
  * token streams: spec-on equals spec-off equals the JAX engine with
    speculation on, for the n-gram proposer greedy and sampled, the
    draft proposer, the rejection path, batch recomposition,
    preempt/resume on a tight pool and the full-hit fast start; and the
    spec counters of ``stats()`` equal the JAX engine's;
  * the pool clean after heavy rejection, with and without the prefix
    cache; ``resolve_spec_config``'s validation; the handler streams
    the same frames with speculation on.

f32 keeps argmax and sampling decisions away from rounding ties, so
"the same" means equal token ids. Each scenario runs once per package
and mode (module-scoped fixture).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMEngine as JEngine
from ray_tpu.llm import sampling as jsampling
from ray_tpu.llm.engine import _jit_programs
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.llm import LLMEngine, sampling
from ray_tpu_torch.llm.spec import (DraftProposer, NgramProposer, SpecConfig,
                                    make_spec, resolve_spec_config)
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm import LLMServer

torch.set_num_threads(1)

KW = dict(vocab_size=128, max_seq=64, d_model=64, n_layer=2, n_head=4)
JCFG = jgpt.GPTConfig(dtype=jnp.float32, **KW)
TCFG = tgpt.GPTConfig(dtype=torch.float32, **KW)
JPARAMS = jgpt.init(jax.random.PRNGKey(0), JCFG)
TPARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, JPARAMS),
                            TCFG, device="cpu")

LOGITS_ATOL = 1e-4
POOL_ATOL = 2e-5

# The JAX spec tests' prompts: a repetitive one (the untrained greedy
# model loops, so n-gram proposals are accepted) and one with no
# repeated n-gram (proposals are rare or rejected).
LOOPY = [5, 9, 5, 9, 5, 9, 5]
UNIQ = list(range(30, 42))
NGRAM = {"mode": "ngram", "k": 4}


@pytest.fixture(scope="module", autouse=True)
def _two_cores():
    """Run this module's threads (torch's, and the JAX compiler's and
    runtime's) on two cores, so that under the suite's parallel workers
    the timing-sensitive tests elsewhere keep the rest of the machine.
    Every thread's mask is restored afterwards."""
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


# ------------------------------------------------------------ forward_verify

def _verify_batch():
    """One seeded verify batch, B 4, Q 5, block size 8: lane 0 five rows
    from slot 6 (its span crosses into a second block), lane 1 two rows
    (q_lens < Q), lane 2 one row (a decode lane), lane 3 padding (its
    table all scratch block 0, context 1). Rows past q_lens write to
    block 0, offset 0."""
    rng = np.random.default_rng(7)
    B, Q, bs, nb, max_nb = 4, 5, 8, 32, 8
    L, hkv, d = KW["n_layer"], KW["n_head"], KW["d_model"] // KW["n_head"]
    k_pool = rng.standard_normal((L, hkv, nb, bs, d)).astype(np.float32)
    v_pool = rng.standard_normal((L, hkv, nb, bs, d)).astype(np.float32)
    k_pool[:, :, 0] = v_pool[:, :, 0] = 0.0
    tables = np.zeros((B, max_nb), np.int32)
    tables[0, :3] = [4, 9, 2]
    tables[1, :2] = [11, 5]
    tables[2, :4] = [20, 21, 22, 23]
    starts, q_lens = [6, 9, 30, 0], [5, 2, 1, 1]
    tokens = rng.integers(0, KW["vocab_size"], (B, Q)).astype(np.int32)
    positions = np.zeros((B, Q), np.int32)
    sb = np.zeros((B, Q), np.int32)
    so = np.zeros((B, Q), np.int32)
    ctx = np.ones((B,), np.int32)
    for i in range(3):
        s, n = starts[i], q_lens[i]
        positions[i] = np.minimum(s + np.arange(Q), KW["max_seq"] - 1)
        for j in range(n):
            sb[i, j] = tables[i, (s + j) // bs]
            so[i, j] = (s + j) % bs
        ctx[i] = s + n
    assert sb[0, 1] == 4 and sb[0, 2] == 9   # lane 0 crosses a block
    return dict(tokens=tokens, positions=positions, k_pool=k_pool,
                v_pool=v_pool, block_tables=tables, context_lens=ctx,
                q_lens=np.asarray(q_lens, np.int32), slot_blocks=sb,
                slot_offsets=so)


@pytest.fixture(scope="module")
def verify_runs():
    x = _verify_batch()
    # The JAX engine's own compiled verify program: the batch has the
    # shapes of the engines below (max_batch 4, k 4, 32 blocks of 8), so
    # they reuse this compile.
    fn = _jit_programs(JCFG, None, None)[3]
    jl, jk, jv = fn(JPARAMS, *(jnp.asarray(x[k]) for k in (
        "tokens", "positions", "k_pool", "v_pool", "block_tables",
        "context_lens", "q_lens", "slot_blocks", "slot_offsets")))
    tx = {k: torch.from_numpy(a.copy()) for k, a in x.items()}
    tl, tk, tv = tgpt.forward_verify(TPARAMS, **tx, cfg=TCFG)
    assert tk is tx["k_pool"] and tv is tx["v_pool"]   # written in place
    return x, (np.asarray(jl), np.asarray(jk), np.asarray(jv)), (
        tl.numpy(), tk.numpy(), tv.numpy())


def test_forward_verify_logits_match_jax(verify_runs):
    x, (jl, _, _), (tl, _, _) = verify_runs
    assert tl.shape == jl.shape == (4, 5, KW["vocab_size"])
    for i, n in enumerate(x["q_lens"][:3]):
        np.testing.assert_allclose(tl[i, :n], jl[i, :n], atol=LOGITS_ATOL,
                                   rtol=0)
        assert np.isfinite(tl[i, :n]).all()


def test_forward_verify_pools_match_jax(verify_runs):
    x, (_, jk, jv), (_, tk, tv) = verify_runs
    for name, t, j, before in (("k", tk, jk, x["k_pool"]),
                               ("v", tv, jv, x["v_pool"])):
        np.testing.assert_allclose(t[:, :, 1:], j[:, :, 1:], atol=POOL_ATOL,
                                   rtol=0, err_msg=name)
        # Every real row was written at its site, in every layer.
        for i, n in enumerate(x["q_lens"][:3]):
            for r in range(n):
                b, o = x["slot_blocks"][i, r], x["slot_offsets"][i, r]
                assert not np.array_equal(t[:, :, b, o], before[:, :, b, o])


# ------------------------------------------------------------- samplers

def test_verify_tokens_match_jax():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(5, 32)).astype(np.float32)
    for kw in (dict(), dict(temperature=0.9, top_k=8, seed=13),
               dict(temperature=1.3, seed=2)):
        seq = [sampling.sample(rows[j], position=100 + j, **kw)
               for j in range(5)]
        for props in (seq[:4], seq[:2] + [(seq[2] + 1) % 32], [],
                      [(seq[0] + 3) % 32]):
            got = sampling.verify_tokens(rows, props, start_pos=100, **kw)
            want = jsampling.verify_tokens(rows, props, start_pos=100, **kw)
            assert got == want and len(got[1]) == got[0] + 1
    with pytest.raises(ValueError):
        sampling.verify_tokens(rows[:2], [1, 2])


def test_target_probs_and_rejection_sample_match_jax():
    rng = np.random.default_rng(1)
    row = rng.normal(size=24).astype(np.float32)
    for kw in (dict(), dict(temperature=0.7, top_k=5),
               dict(temperature=1.1)):
        np.testing.assert_array_equal(sampling.target_probs(row, **kw),
                                      jsampling.target_probs(row, **kw))
    target = np.array([0.15, 0.55, 0.30])
    draft = np.array([0.40, 0.40, 0.20])
    for x in range(3):
        for u in (0.1, 0.3, 0.5, 0.9, 0.999):
            for ru in (None, 0.2, 0.74, 0.76):
                assert sampling.rejection_sample(target, draft, x, u, ru) == \
                    jsampling.rejection_sample(target, draft, x, u, ru)
    with pytest.raises(ValueError):
        sampling.rejection_sample([0.5, 0.5], [1.0, 0.0], 1, u=0.5)


# -------------------------------------------------------- token streams

def _drain(eng, max_steps=300):
    for _ in range(max_steps):
        s = eng.stats()
        if not s["in_flight"] and not s["waiting"]:
            return
        eng.step()
    raise AssertionError("engine did not drain")


def _make(pkg, speculative):
    def make(**kw):
        kw = dict(dict(num_blocks=32, block_size=8, max_batch=4), **kw)
        if pkg == "jax":
            return JEngine(JPARAMS, JCFG, speculative=speculative, **kw)
        return LLMEngine(TPARAMS, TCFG, device="cpu",
                         speculative=speculative, **kw)
    return make


def _spec_stats(eng):
    return None if eng._spec is None else eng.stats()["spec"]


def _run(make, reqs, **kw):
    eng = make(**kw)
    hs = [eng.add_request(**r) for r in reqs]
    _drain(eng)
    return eng, dict(outputs=[h.output for h in hs],
                     reasons=[h.finish_reason for h in hs],
                     steps=eng._steps, spec=_spec_stats(eng),
                     drained=eng.kv.num_free == eng.kv.capacity)


def _scn_ngram_greedy(make):
    return _run(make, [dict(prompt=LOOPY, max_tokens=16)])[1]


def _scn_draft(make):
    """Self-drafting (the target is its own draft): greedy proposals
    always match the greedy target. Sequences stay within the draft's
    first bucket of 8 tokens."""
    return _run(make, [dict(prompt=LOOPY[:3], max_tokens=5)])[1]


def _scn_ngram_sampled(make):
    return _run(make, [
        dict(prompt=LOOPY, max_tokens=12, temperature=0.8, seed=11),
        dict(prompt=UNIQ, max_tokens=10, temperature=1.2, seed=3,
             top_k=8)])[1]


def _scn_rejection(make):
    return _run(make, [dict(prompt=UNIQ, max_tokens=14, temperature=1.5,
                            seed=7)])[1]


def _scn_recompose(make):
    """A request joining mid-generation recomposes the batch."""
    eng = make()
    a = eng.add_request(prompt=LOOPY, max_tokens=14, seed=2,
                        temperature=0.7)
    eng.step()
    eng.step()
    mid = len(a.output)
    b = eng.add_request(prompt=UNIQ, max_tokens=10)
    _drain(eng)
    comps = [set(rids) for _, rids in eng.step_log]
    return dict(outputs=[a.output, b.output], mid=mid,
                recomposed={a.rid, b.rid} in comps, spec=_spec_stats(eng))


def _scn_tight(make):
    """Five blocks for three requests: preempt, resume, every block
    back."""
    eng, out = _run(make, [
        dict(prompt=LOOPY, max_tokens=10, seed=2, temperature=0.7),
        dict(prompt=UNIQ, max_tokens=8, seed=5, temperature=0.9),
        dict(prompt=[20, 21, 20, 21, 20], max_tokens=8)], num_blocks=5)
    out["preemptions"] = sum(r.preemptions
                             for r in eng._requests.values())
    return out


def _scn_full_hit(make):
    """A full prefix-cache hit: its first step runs through the verify
    path with proposals from its own prompt."""
    prompt = [5, 9] + [5] * 12
    eng = make()
    a = eng.add_request(list(prompt), max_tokens=8)
    _drain(eng)
    b = eng.add_request(list(prompt), max_tokens=8)
    eng.step()
    first = len(b.output)
    _drain(eng)
    return dict(outputs=[a.output, b.output], cached=b.cached_tokens,
                first_step=first, spec=_spec_stats(eng))


SCENARIOS = {
    "ngram_greedy": (_scn_ngram_greedy, NGRAM),
    "ngram_sampled": (_scn_ngram_sampled, NGRAM),
    "draft": (_scn_draft, {"mode": "draft", "k": 3}),
    "rejection": (_scn_rejection, NGRAM),
    "recompose": (_scn_recompose, NGRAM),
    "tight_pool": (_scn_tight, NGRAM),
    "full_hit": (_scn_full_hit, NGRAM),
}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name, pkg, spec=True):
        key = (name, pkg, spec)
        if key not in cache:
            fn, speculative = SCENARIOS[name]
            cache[key] = fn(_make(pkg, speculative if spec else None))
        return cache[key]
    return get


def _tokens(run):
    return run["outputs"]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_spec_token_streams_equal_spec_off_and_jax(runs, name):
    on, off = runs(name, "torch"), runs(name, "torch", spec=False)
    ref = runs(name, "jax")
    assert _tokens(on) == _tokens(off) == _tokens(ref)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_spec_counters_equal_jax(runs, name):
    on, ref = runs(name, "torch"), runs(name, "jax")
    assert on["spec"] == ref["spec"] and on["spec"]["verify_steps"] > 0


def test_scenarios_exercise_what_they_claim(runs):
    greedy = runs("ngram_greedy", "torch")
    assert greedy["spec"]["accepted"] > 0
    assert greedy["steps"] < len(greedy["outputs"][0])
    assert runs("draft", "torch")["spec"]["accept_rate"] == 1.0
    assert runs("rejection", "torch")["spec"]["rolled_back"] > 0
    rec = runs("recompose", "torch")
    assert rec["recomposed"] and rec["mid"] >= 2
    tight = runs("tight_pool", "torch")
    assert tight["preemptions"] > 0 and tight["drained"]
    assert tight["outputs"] == runs("tight_pool", "torch", spec=False)[
        "outputs"]
    hit = runs("full_hit", "torch")
    assert hit["cached"] == 14 and hit["first_step"] >= 2
    assert hit["outputs"][0] == hit["outputs"][1]
    for name in SCENARIOS:
        assert all(r in (None, "length")
                   for r in runs(name, "torch").get("reasons", [None]))


def test_pool_clean_after_heavy_rejection():
    """A run full of rejections and rollbacks gives every block back,
    on both pool flavors, with the JAX engine's counters."""
    for prefix_cache in (True, False):
        outs = []
        for pkg in ("torch", "jax"):
            eng, out = _run(_make(pkg, NGRAM), [
                dict(prompt=UNIQ, max_tokens=12, temperature=1.5, seed=9)],
                prefix_cache=prefix_cache)
            assert out["drained"], (pkg, prefix_cache)
            outs.append(out)
        assert outs[0] == outs[1]
        assert outs[0]["spec"]["rolled_back"] > 0


def test_spec_stats_surface():
    eng, _ = _run(_make("torch", NGRAM), [dict(prompt=LOOPY,
                                               max_tokens=16)])
    s = eng.stats()
    assert 0.0 <= s["spec_accept_rate"] <= 1.0
    assert s["spec_tokens_per_step"] >= 1.0
    assert s["spec"]["mode"] == "ngram" and s["spec"]["k"] == 4
    assert {"propose", "verify", "accept"} <= {k for _, k, _ in
                                               eng._spec.events}
    assert s["last_step"]["tokens"] >= 1
    off, _ = _run(_make("torch", None), [dict(prompt=LOOPY, max_tokens=4)])
    assert off._spec is None
    assert "spec_accept_rate" not in off.stats()


def test_llm_server_streams_the_same_frames_with_speculation():
    frames = {}
    for spec in (None, NGRAM):
        srv = LLMServer(TCFG, TPARAMS, max_batch=4, speculative=spec,
                        device="cpu")
        try:
            frames[spec is None] = [
                list(srv({"prompt": p, "max_tokens": 10, "seed": i,
                          "temperature": 0.6 * i}))
                for i, p in enumerate(("abababab", "hello"))]
        finally:
            srv.engine.stop()
    assert frames[True] == frames[False]
    assert all(f[-1]["done"] and f[-1]["num_tokens"] == 10
               for f in frames[False])


# --------------------------------------------------------------- config

def test_resolve_spec_config_validation():
    assert resolve_spec_config(None) is None
    cfg = resolve_spec_config({"mode": "ngram", "k": 2})
    assert isinstance(cfg, SpecConfig) and cfg.k == 2
    assert resolve_spec_config(cfg) is cfg
    with pytest.raises(ValueError):
        resolve_spec_config({"mode": "warp"})
    with pytest.raises(ValueError):
        resolve_spec_config({"mode": "ngram", "k": 0})
    with pytest.raises(ValueError):
        resolve_spec_config({"bogus": 1})
    with pytest.raises(TypeError):
        resolve_spec_config(42)
    small = tgpt.GPTConfig(dtype=torch.float32, **dict(KW, vocab_size=64))
    with pytest.raises(ValueError, match="vocab"):
        make_spec({"mode": "draft", "draft_cfg": small},
                  target_params=TPARAMS, target_cfg=TCFG, device="cpu")


def test_ngram_proposer_prefers_most_recent_match():
    p = NgramProposer(max_ngram=3, min_ngram=1)
    assert p.propose([1, 2, 9, 1, 2, 8, 1, 2], 2) == [8, 1]
    assert p.propose([1, 2, 3], 3) == []
    assert p.propose([4], 2) == []
    assert p.propose([5, 5, 5], 4) == [5, 5, 5, 5]    # self-extension
    with pytest.raises(ValueError):
        NgramProposer(max_ngram=1, min_ngram=2)


def test_draft_proposer_needs_a_card_unless_told():
    """The draft proposer follows the device rule: None is the card."""
    d = DraftProposer(TPARAMS, TCFG, device="cpu")
    assert d.params["wte"] is TPARAMS["wte"]    # no copy of f32 params
    assert len(d.propose(LOOPY, 3)) == 3
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DraftProposer(TPARAMS, TCFG)
