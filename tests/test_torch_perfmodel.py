"""The port's cost model (ray_tpu_torch/util/perfmodel.py) against the
JAX package's (ray_tpu/util/perfmodel.py), and the engine's step
accounting, on the CPU.

Every cost function must give the reference's FLOPs, HBM bytes and
tokens (rtol 1e-12) on GPT-2-small (124,373,760 params, 6N + 12LMS train
FLOPs per token) and on a GQA configuration; ``roofline`` and
``StepAccounting`` must give the reference's keys and values for the
same device spans; ``detect_hardware`` must name the H100 from
``torch.cuda.get_device_name`` (monkeypatched here: no card) and the CPU
as ``cpu-interpret``; an engine step must leave ``stats()["last_step"]``
priced by the reference's formulas. Only the cost model's module of the
JAX package is imported, and no JAX computation runs.
"""

import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.util import perfmodel as jpm
from ray_tpu_torch.llm import LLMEngine
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.util import perfmodel as pm

torch.set_num_threads(1)

RTOL = 1e-12
N_GPT2_SMALL = 124_373_760
GQA = dict(d_model=768, n_layer=12, n_head=12, n_kv_head=4, max_seq=2048)
CFGS = {"gpt2_small": (tgpt.GPT2_SMALL, jgpt.GPT2_SMALL),
        "gqa": (tgpt.GPTConfig(**GQA), jgpt.GPTConfig(**GQA))}


def _close(a, b):
    assert a == pytest.approx(b, rel=RTOL, abs=0), (a, b)


def _same_cost(got, want):
    _close(got.flops, want.flops)
    _close(got.hbm_bytes, want.hbm_bytes)
    assert got.tokens == want.tokens


def test_gpt2_small_constants():
    t, j = CFGS["gpt2_small"]
    assert t.num_params() == j.num_params() == N_GPT2_SMALL
    want = 6.0 * N_GPT2_SMALL + 12.0 * 12 * 768 * 1024
    _close(pm.train_flops_per_token(t), want)
    _close(t.flops_per_token(), want)
    _close(pm.train_flops_per_token(t, seq=256),
           jpm.train_flops_per_token(j, seq=256))
    for key in ("matmul_weights", "attn_per_ctx", "num_params",
                "kv_bytes_per_token", "m", "L"):
        assert pm._shape(t)[key] == jpm._shape(j)[key], key


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cost_functions_equal_the_reference(name):
    t, j = CFGS[name]
    assert t.num_params() == j.num_params()
    ctx = [100, 200, 300, 1024]
    q = [5, 1, 3, 5]
    for kw in ({}, dict(kv_dtype_bytes=4, param_bytes=2)):
        _same_cost(pm.decode_step_cost(t, ctx, **kw),
                   jpm.decode_step_cost(j, ctx, **kw))
        _same_cost(pm.verify_step_cost(t, ctx, q, **kw),
                   jpm.verify_step_cost(j, ctx, q, **kw))
        for n, c in ((128, 0), (64, 512), (1, 1000)):
            _same_cost(pm.prefill_cost(t, n, ctx_tokens=c, **kw),
                       jpm.prefill_cost(j, n, ctx_tokens=c, **kw))
    for b, s in ((8, 1024), (2, None), (1, 77)):
        _same_cost(pm.train_step_cost(t, b, s),
                   jpm.train_step_cost(j, b, s))
    _same_cost(pm.StepCost(1.0, 2.0, 3) + pm.ZERO_COST,
               jpm.StepCost(1.0, 2.0, 3) + jpm.ZERO_COST)


@pytest.mark.parametrize("device_s,gap_s", [(1e-3, 0.0), (1e-3, 5e-3),
                                            (2.0, 0.1)])
def test_roofline_equals_the_reference(device_s, gap_s):
    t, j = CFGS["gpt2_small"]
    peaks = (pm.HARDWARE_PEAKS["h100-sxm"],
             pm.HARDWARE_PEAKS["cpu-interpret"])
    for cost_args in ((t, [512] * 8), (t, [16])):
        cost = pm.decode_step_cost(*cost_args)
        jcost = jpm.StepCost(cost.flops, cost.hbm_bytes, cost.tokens)
        for hw in peaks:
            jhw = jpm.HardwarePeak(hw.name, hw.flops_per_s,
                                   hw.hbm_bytes_per_s)
            got = pm.roofline(cost, device_s, gap_s, hw=hw, n_chips=1)
            want = jpm.roofline(jcost, device_s, gap_s, hw=jhw, n_chips=1)
            assert got.keys() == want.keys() == {"mfu", "hbm_util",
                                                 "verdict", "hardware"}
            assert got == want


def test_step_accounting_equals_the_reference():
    """Identical spans and costs give identical breakdowns. The device
    spans are large enough that the host clock never sets the wall
    time, so nothing depends on it."""
    t, _ = CFGS["gpt2_small"]
    hw = pm.HARDWARE_PEAKS["h100-sxm"]
    acc = pm.StepAccounting(hw)
    ref = jpm.StepAccounting(jpm.HardwarePeak(hw.name, hw.flops_per_s,
                                              hw.hbm_bytes_per_s))
    costs = [pm.prefill_cost(t, 128), pm.decode_step_cost(t, [129] * 4)]
    jcosts = [jpm.StepCost(c.flops, c.hbm_bytes, c.tokens) for c in costs]
    for a, cs in ((acc, costs), (ref, jcosts)):
        a.begin()
        for sec, c in zip((30.0, 20.0), cs):
            a.add_device(sec, c)
    got, want = acc.finish(), ref.finish()
    assert got.keys() == want.keys() == {
        "step_ms", "device_ms", "host_gap_ms", "mfu", "hbm_util",
        "verdict", "hardware", "tokens"}
    assert got == want and acc.last == got
    assert got["device_ms"] == got["step_ms"] == 50e3
    assert got["hardware"] == "H100-SXM" and got["tokens"] == 128 + 4
    # An idle tick is not a step.
    acc.begin()
    assert acc.finish() is None and acc.last is None


def test_dispatch_spans_are_not_priced():
    """``busy_spans=False`` (the engine on the card, whose spans run from
    a forward's first enqueue to its last kernel's end): the spans are
    reported as dispatch_to_ready_ms beside the step's cost, and no
    device time, MFU, HBM utilization or verdict is derived from them."""
    t, _ = CFGS["gpt2_small"]
    acc = pm.StepAccounting(pm.HARDWARE_PEAKS["h100-sxm"], busy_spans=False)
    cost = pm.decode_step_cost(t, [129] * 4)
    acc.begin()
    acc.add_device(20.0, cost)
    got = acc.finish()
    assert got["dispatch_to_ready_ms"] == got["step_ms"] == 20e3
    assert got["host_gap_ms"] == 0.0
    assert all(got[k] is None
               for k in ("device_ms", "mfu", "hbm_util", "verdict"))
    assert (got["flops"], got["hbm_bytes"], got["tokens"]) == (
        cost.flops, cost.hbm_bytes, cost.tokens)
    assert got["hardware"] == "H100-SXM" and acc.last == got
    acc.begin()
    assert acc.finish() is None and acc.last is None


def test_device_step_ring():
    pm.clear_device_steps()
    acc = pm.StepAccounting(pm.HARDWARE_PEAKS["cpu-interpret"])
    acc.begin()
    acc.add_device(1.0, pm.StepCost(1e9, 1e6, 3))
    out = acc.finish(record_as="llm.step", attrs={"step": 7})
    evs = pm.device_step_events()
    assert len(evs) == 1 and evs[0]["name"] == "llm.step"
    assert evs[0]["step"] == 7 and evs[0]["tokens"] == out["tokens"] == 3
    assert pm.device_step_events(since=evs[0]["t_wall"] + 1.0) == []
    pm.clear_device_steps()
    assert pm.device_step_events() == []


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", ("H100-SXM", 989e12, 3.35e12)),
    ("NVIDIA H100 SXM5 80GB", ("H100-SXM", 989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", ("NVIDIA H100 PCIe", 1e12, 50e9)),
    ("NVIDIA A100-SXM4-80GB", ("NVIDIA A100-SXM4-80GB", 1e12, 50e9))])
def test_detect_hardware_reads_the_cards_name(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: name)
    for dev in ("cuda", torch.device("cuda", 0)):
        hw = pm.detect_hardware(dev)
        assert (hw.name, hw.flops_per_s, hw.hbm_bytes_per_s) == want
    assert (pm.detect_hardware("cuda").name == "H100-SXM") == (
        want[0] == "H100-SXM")


def test_detect_hardware_on_the_cpu_and_never_raises(monkeypatch):
    cpu = pm.HARDWARE_PEAKS["cpu-interpret"]
    assert pm.detect_hardware("cpu") == cpu
    assert pm.detect_hardware(torch.device("cpu")) == cpu
    assert (cpu.flops_per_s, cpu.hbm_bytes_per_s) == (
        jpm.HARDWARE_PEAKS["cpu-interpret"].flops_per_s,
        jpm.HARDWARE_PEAKS["cpu-interpret"].hbm_bytes_per_s)

    def no_card(dev=None):
        raise RuntimeError("no card")

    monkeypatch.setattr(torch.cuda, "get_device_name", no_card)
    assert pm.detect_hardware("cuda") == cpu
    assert pm.detect_hardware("not a device") == cpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pm.detect_hardware() == cpu


def test_engine_step_is_priced_by_the_reference_formulas():
    """The first step of one request prefills its 5-token prompt (padded
    to a block of 8) and decodes its first position: last_step carries
    the reference's prefill + decode cost (read back through MFU and
    HBM utilization), on the CPU's cpu-interpret peaks."""
    kw = dict(vocab_size=128, max_seq=64, d_model=64, n_layer=2, n_head=4)
    cfg = tgpt.GPTConfig(dtype=torch.float32, **kw)
    jcfg = jgpt.GPTConfig(**kw)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = LLMEngine(params, cfg, num_blocks=16, block_size=8, max_batch=2,
                    device="cpu")
    assert "last_step" not in eng.stats()
    eng.add_request([1, 2, 3, 4, 5], max_tokens=3)
    eng.step()
    last = eng.stats()["last_step"]
    cost = jpm.prefill_cost(jcfg, 8) + jpm.decode_step_cost(jcfg, [6])
    hw = jpm.HARDWARE_PEAKS["cpu-interpret"]
    dev_s = last["device_ms"] / 1e3
    assert last["hardware"] == "cpu-interpret" and last["tokens"] == 9
    assert last["mfu"] * dev_s * hw.flops_per_s == pytest.approx(
        cost.flops, rel=1e-9)
    assert last["hbm_util"] * dev_s * hw.hbm_bytes_per_s == pytest.approx(
        cost.hbm_bytes, rel=1e-9)
    assert 0 < last["device_ms"] <= last["step_ms"]
    assert last["host_gap_ms"] == pytest.approx(
        last["step_ms"] - last["device_ms"])
    eng.step()
    assert eng.stats()["last_step"]["tokens"] == 1
