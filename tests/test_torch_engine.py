"""The PyTorch port's serving slice (ray_tpu_torch.llm,
ray_tpu_torch.serve.llm) against the JAX package's LLMEngine, on the
CPU, plus the port's package rules.

Both engines get the same f32 weights (the JAX init carried across as
numpy) and the same requests, and must emit the same token streams:
greedy and sampled, prefix cache on and off, chunked prefill, a full
prefix hit, and tight-pool preempt/resume (the scenarios of
tests/test_llm_engine.py). f32 keeps the argmax/sampling decisions away
from rounding ties, so "the same" means equal token ids. Each scenario
runs once per package (module-scoped fixture).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import LLMEngine as JEngine
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.llm import (FINISHED, PREEMPTED, PREFILL, RUNNING,
                               WAITING, LLMEngine)
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm import LLMServer, decode, encode

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KW = dict(vocab_size=128, max_seq=64, d_model=64, n_layer=2, n_head=4)
JCFG = jgpt.GPTConfig(dtype=jnp.float32, **KW)
TCFG = tgpt.GPTConfig(dtype=torch.float32, **KW)
JPARAMS = jgpt.init(jax.random.PRNGKey(0), JCFG)
TPARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, JPARAMS),
                            TCFG, device="cpu")

REQS = [
    dict(prompt=[1, 2, 3, 4, 5], max_tokens=8, seed=11, temperature=0.7),
    dict(prompt=[9, 8, 7], max_tokens=12, seed=5, temperature=0.9),
    dict(prompt=[20, 21], max_tokens=6),   # greedy
]
PREFIX = [7] * 20 + [1, 2, 3]


def _make(pkg):
    def make(**kw):
        if pkg == "jax":
            return JEngine(JPARAMS, JCFG, **kw)
        return LLMEngine(TPARAMS, TCFG, device="cpu", **kw)
    return make


def _drain(eng, max_steps=300):
    for _ in range(max_steps):
        s = eng.stats()
        if not s["in_flight"] and not s["waiting"]:
            return
        eng.step()
    raise AssertionError("engine did not drain")


def _scn_mixed(make):
    """Greedy + sampled in one batch; a late join recomposes the batch;
    a stop token ends a stream at its first occurrence."""
    eng = make(num_blocks=64, block_size=8, max_batch=4)
    hs = [eng.add_request(**r) for r in REQS]
    _drain(eng)
    late = make(num_blocks=64, block_size=8, max_batch=4)
    a = late.add_request(**REQS[0])
    late.step()
    late.step()
    b = late.add_request(**REQS[1])
    _drain(late)
    stop = hs[2].output[2]
    se = make(num_blocks=32, block_size=8)
    st = se.add_request(REQS[2]["prompt"], max_tokens=6, stop_tokens=[stop])
    _drain(se)
    return dict(outputs=[h.output for h in hs],
                reasons=[h.finish_reason for h in hs],
                late=[a.output, b.output],
                comps=[tuple(sorted(r)) for _, r in late.step_log],
                stop=(st.output, st.finish_reason))


def _scn_tight(make):
    """Pool too small for the working set: preempt, resume, identical
    tokens, every block returned."""
    eng = make(num_blocks=4, block_size=8, max_batch=4)
    hs = [eng.add_request(**r) for r in REQS]
    _drain(eng)
    per_rid = {}
    for _, rid, s in eng.events():
        per_rid.setdefault(rid, []).append(s)
    return dict(outputs=[h.output for h in hs],
                preemptions=[h.preemptions for h in hs],
                trace=sorted(per_rid.items()),
                drained=eng.kv.num_free == eng.kv.capacity,
                tables=[h.block_table for h in hs])


def _scn_prefix(make):
    """Cold fill, full hit (zero prefill, COW of the shared tail) and a
    divergent tail sharing a 16-token prefix."""
    cold = make(num_blocks=64, block_size=8, prefix_cache=False)
    c = cold.add_request(list(PREFIX), max_tokens=6, seed=3,
                         temperature=0.8)
    _drain(cold)
    eng = make(num_blocks=64, block_size=8)
    a = eng.add_request(list(PREFIX), max_tokens=6, seed=3, temperature=0.8)
    _drain(eng)
    b = eng.add_request(list(PREFIX), max_tokens=6, seed=3, temperature=0.8)
    _drain(eng)
    t = eng.add_request(PREFIX[:16] + [40, 41, 42], max_tokens=6, seed=9,
                        temperature=0.7)
    _drain(eng)
    s = eng.stats()
    return dict(outputs=[c.output, a.output, b.output, t.output],
                cached=[a.cached_tokens, b.cached_tokens, t.cached_tokens],
                hit_rate=s["kv_cache_hit_rate"],
                cow_splits=s["prefix"]["cow_splits"],
                drained=eng.kv.num_free == eng.kv.capacity)


def _scn_chunked(make):
    """prefill_chunk_tokens=8: a 40-token prompt admits in chunks while
    a running stream emits one token every step."""
    eng = make(num_blocks=64, block_size=8, prefill_chunk_tokens=8,
               prefix_cache=False)
    s = eng.add_request([5, 6, 7], max_tokens=16, seed=1, temperature=0.6)
    eng.step()
    h = eng.add_request(list(range(1, 41)), max_tokens=6)
    deltas = []
    for _ in range(100):
        if h.finish_reason and s.finish_reason:
            break
        before = len(s.output)
        eng.step()
        if s.finish_reason is None or len(s.output) != before:
            deltas.append(len(s.output) - before)
    return dict(outputs=[s.output, h.output], deltas=deltas[:5],
                chunks=eng.stats()["prefill_chunks"])


SCENARIOS = {"mixed": _scn_mixed, "tight": _scn_tight,
             "prefix": _scn_prefix, "chunked": _scn_chunked}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name, pkg):
        if (name, pkg) not in cache:
            cache[(name, pkg)] = SCENARIOS[name](_make(pkg))
        return cache[(name, pkg)]
    return get


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_token_streams_equal_jax_engine(runs, name):
    assert runs(name, "torch") == runs(name, "jax")


def test_scenarios_exercise_what_they_claim(runs):
    mixed = runs("mixed", "torch")
    assert mixed["reasons"] == ["length"] * 3
    assert any(len(c) == 2 for c in mixed["comps"]), "batch recomposed"
    assert mixed["stop"][1] == "stop"
    tight = runs("tight", "torch")
    assert sum(tight["preemptions"]) > 0 and tight["drained"]
    assert tight["outputs"] == mixed["outputs"]
    states = {s for _, trace in tight["trace"] for s in trace}
    assert states == {WAITING, PREFILL, RUNNING, PREEMPTED, FINISHED}
    prefix = runs("prefix", "torch")
    assert prefix["cached"] == [0, len(PREFIX), 16]
    assert prefix["outputs"][0] == prefix["outputs"][1] == \
        prefix["outputs"][2]
    assert prefix["cow_splits"] >= 1 and prefix["drained"]
    chunked = runs("chunked", "torch")
    assert chunked["chunks"] >= 5 and chunked["deltas"] == [1] * 5


def test_llm_server_frames_match_jax_engine():
    """The handler's frames: one {"token"} per generated token, then the
    done frame; the shared system prompt is a prefix-cache hit for the
    second request. Tokens equal the JAX engine's under the handler's
    defaults (chunked prefill 32, prefix cache on)."""
    system = "system: be brief and exact. "
    srv = LLMServer(TCFG, TPARAMS, system_prompt=system, max_batch=4,
                    device="cpu")
    try:
        frames = [list(srv({"prompt": p, "max_tokens": 6, "seed": i,
                            "temperature": 0.5 * i}))
                  for i, p in enumerate(("hello", "world"))]
        stats = srv.engine_stats()
    finally:
        srv.engine.stop()
    ref = JEngine(JPARAMS, JCFG, num_blocks=64, block_size=16, max_batch=4,
                  prefill_chunk_tokens=32, prefix_cache=True)
    want = []
    for i, p in enumerate(("hello", "world")):
        r = ref.add_request(encode(system + p), max_tokens=6, seed=i,
                            temperature=0.5 * i)
        _drain(ref)
        want.append(r.output)
    for fr, w in zip(frames, want):
        assert [f["token"] for f in fr[:-1]] == w
        done = fr[-1]
        assert done["done"] is True and done["finish_reason"] == "length"
        assert done["num_tokens"] == 6 and done["preemptions"] == 0
        assert done["text"] == decode(w)
    assert frames[0][-1]["cached_tokens"] == 0
    assert frames[1][-1]["cached_tokens"] == 16
    assert stats["prefill_chunks"] >= 2
    with pytest.raises(ValueError):
        srv({"prompt": ""})


def test_entry_points_refuse_to_run_without_a_card():
    """device=None means the card; without one the entry points raise
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(TPARAMS, TCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServer(TCFG, TPARAMS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpt.init(TCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(TPARAMS, TCFG, speculative={"k": 2})


def test_import_leaves_jax_and_ray_tpu_out():
    code = ("import sys, ray_tpu_torch.llm, ray_tpu_torch.serve.llm, "
            "ray_tpu_torch.ops.flash_attention, ray_tpu_torch.models.convert,"
            " ray_tpu_torch.llm.spec, ray_tpu_torch.util.perfmodel;"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'ray_tpu' or "
            "m.startswith('ray_tpu.'));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_ray_tpu():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "ray_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
