"""Analytic device-step cost model: FLOPs, HBM bytes, MFU, roofline
(a copy of ray_tpu/util/perfmodel.py; the port imports nothing of the
JAX package).

The formulas are the reference's, unchanged, so the port's engine prices
a step exactly as the JAX engine does (the port's tests hold every cost
function to the reference's at rtol 1e-12):

  matmul weights  W  = L*(wq + wk + wv + wo + wi + wm) + unembed
                     = L*(m*h*d + 2*m*hk*d + h*d*m + 2*m*f) + V*m
  forward/token   2*W + 4*m*L*C          (C = attention context length)
  prefill(T)      2*W*T + 2*m*L*T*(T+1)  (causal)
  verify(q rows)  2*W*q + 4*m*L*(q*C - q*(q-1)/2)  per lane
  train/token     6*N + 12*L*m*T         (N = all params)

HBM traffic: a decode or verify step streams the weights once for the
batch, reads each lane's context KV once and writes each new row's KV;
a prefill writes and reads its span's KV; a train step is ~8 passes over
the params plus the saved activations (the reference's approximation).

What differs from the reference is the hardware table's seam:
``detect_hardware`` asks torch for the card's name
(``torch.cuda.get_device_name``) instead of asking JAX for its devices,
and the table has the H100's published peaks. A CPU device gets the
reference's nominal ``cpu-interpret`` entry (1 TFLOP/s, 50 GB/s), and a
card that is not in the table an entry under its own name with those
same nominal figures: a perf model never raises. And ``StepAccounting``
can be told that its spans are not busy time (``busy_spans=False``, the
engine on the card, where a span runs from a forward's first enqueue to
its last kernel's end and so times the host's dispatch on a host-bound
step): it then reports them as ``dispatch_to_ready_ms`` and derives no
device time, MFU, HBM utilization or verdict from them.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

# ---------------------------------------------------------------------------
# Hardware peak table
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwarePeak:
    name: str
    flops_per_s: float       # dense bf16 peak, per chip
    hbm_bytes_per_s: float   # HBM bandwidth, per chip


HARDWARE_PEAKS: Dict[str, HardwarePeak] = {
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense (without
    # sparsity): 989 TFLOP/s bf16 and 3.35 TB/s HBM3, the figures
    # chip_smoke.py bounds every kernel by.
    "h100-sxm": HardwarePeak("H100-SXM", 989e12, 3.35e12),
    # The reference's TPU rows, kept as data (spec-sheet figures, not
    # measurements of the port).
    "v5e": HardwarePeak("v5e", 197e12, 819e9),
    "v5p": HardwarePeak("v5p", 459e12, 2765e9),
    "v4": HardwarePeak("v4", 275e12, 1228e9),
    "v6e": HardwarePeak("v6e", 918e12, 1640e9),
    # CPU: the nominal 1 TFLOP/s and 50 GB/s the reference normalizes
    # against off the accelerator.
    "cpu-interpret": HardwarePeak("cpu-interpret", 1e12, 50e9),
}


def _card_peak(name: str) -> HardwarePeak:
    """The table's entry for a CUDA card's name (the SXM H100 reports
    itself as "NVIDIA H100 80GB HBM3"; the PCIe and NVL parts, whose
    peaks are lower, name themselves), or one under the card's own name
    with the nominal cpu-interpret figures."""
    low = name.lower()
    if "h100" in low and "pcie" not in low and "nvl" not in low:
        return HARDWARE_PEAKS["h100-sxm"]
    base = HARDWARE_PEAKS["cpu-interpret"]
    return HardwarePeak(name, base.flops_per_s, base.hbm_bytes_per_s)


def detect_hardware(device=None) -> HardwarePeak:
    """Peak entry for ``device`` (a torch device or its name; None: the
    card when there is one, else the CPU): a CUDA device by
    ``torch.cuda.get_device_name``, the CPU as ``cpu-interpret``. Never
    raises — a perf model must not take the engine down."""
    try:
        import torch

        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        if dev.type == "cuda":
            return _card_peak(torch.cuda.get_device_name(dev))
    except Exception:  # noqa: BLE001 - no usable backend at all
        pass
    return HARDWARE_PEAKS["cpu-interpret"]


# ---------------------------------------------------------------------------
# Model-shape constants (cached per config — the decode hot path calls
# these every step)
# ---------------------------------------------------------------------------

_shape_cache: Dict[int, dict] = {}


def _shape(cfg) -> dict:
    """Per-config constants: matmul-weight count W, per-layer attention
    coefficient, total params N, KV bytes/token. cfg is any object with
    GPTConfig's shape fields (d_model/n_layer/ff/kv_heads/head_dim/
    n_head/vocab_size/num_params)."""
    key = id(cfg)
    cached = _shape_cache.get(key)
    if cached is not None and cached["cfg"] is cfg:
        return cached
    m, f, L = cfg.d_model, cfg.ff, cfg.n_layer
    h, hk, d = cfg.n_head, cfg.kv_heads, cfg.head_dim
    per_layer = m * h * d + 2 * m * hk * d + h * d * m + 2 * m * f
    out = {
        "cfg": cfg,
        "matmul_weights": L * per_layer + cfg.vocab_size * m,
        "attn_per_ctx": 4.0 * m * L,     # flops per token per context pos
        "num_params": cfg.num_params(),
        "kv_bytes_per_token": 2 * L * hk * d,   # k+v elements per token
        "m": m, "L": L,
    }
    if len(_shape_cache) > 64:
        _shape_cache.clear()
    _shape_cache[key] = out
    return out


# ---------------------------------------------------------------------------
# Step costs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StepCost:
    flops: float
    hbm_bytes: float
    tokens: int = 0

    def __add__(self, other: "StepCost") -> "StepCost":
        return StepCost(self.flops + other.flops,
                        self.hbm_bytes + other.hbm_bytes,
                        self.tokens + other.tokens)


ZERO_COST = StepCost(0.0, 0.0, 0)


def train_flops_per_token(cfg, seq: Optional[int] = None) -> float:
    """fwd+bwd training FLOPs per token: 6*N + 12*L*m*seq (the formula
    GPTConfig.flops_per_token has always used, seq defaulting to the
    config's max_seq)."""
    s = _shape(cfg)
    if seq is None:
        seq = cfg.max_seq
    return 6.0 * s["num_params"] + 12.0 * s["L"] * s["m"] * seq


def decode_step_cost(cfg, context_lens: Sequence[int], *,
                     kv_dtype_bytes: int = 2,
                     param_bytes: int = 4) -> StepCost:
    """One decode step over a batch of lanes with the given attention
    context lengths (tokens resident per sequence INCLUDING the one
    being decoded). Weights stream from HBM once for the whole batch —
    this is why batching lifts decode MFU."""
    s = _shape(cfg)
    total_ctx = float(sum(context_lens))
    n = len(context_lens)
    flops = 2.0 * s["matmul_weights"] * n + s["attn_per_ctx"] * total_ctx
    kvb = s["kv_bytes_per_token"] * kv_dtype_bytes
    hbm = (s["num_params"] * param_bytes          # weight read, once
           + total_ctx * kvb                      # KV read per lane
           + n * kvb)                             # KV write (new token)
    return StepCost(flops, hbm, n)


def verify_step_cost(cfg, context_lens: Sequence[int],
                     q_lens: Sequence[int], *,
                     kv_dtype_bytes: int = 2,
                     param_bytes: int = 4) -> StepCost:
    """One speculative verify step: each lane scores ``q_lens[i]`` rows
    (current token + its proposals) against ``context_lens[i]`` resident
    tokens (INCLUDING those rows). Priced honestly: every scored row
    costs full matmul + attention FLOPs whether its proposal is later
    accepted or rolled back — speculation buys steps, not FLOPs. Row j
    of lane i attends ctx - q + 1 + j keys (causal within the span), so
    the per-lane attention term is q*ctx - q*(q-1)/2 contexts. HBM: one
    weight stream for the batch, one read of each lane's context KV
    (the kernel's block gather serves all rows in a lane), one write
    per scored row."""
    s = _shape(cfg)
    n_rows = float(sum(q_lens))
    attn_ctx = 0.0
    total_ctx = 0.0
    for ctx, q in zip(context_lens, q_lens):
        attn_ctx += q * ctx - q * (q - 1) / 2.0
        total_ctx += ctx
    flops = 2.0 * s["matmul_weights"] * n_rows + s["attn_per_ctx"] * attn_ctx
    kvb = s["kv_bytes_per_token"] * kv_dtype_bytes
    hbm = (s["num_params"] * param_bytes
           + total_ctx * kvb                 # context KV read per lane
           + n_rows * kvb)                   # KV write per scored row
    return StepCost(flops, hbm, int(n_rows))


def prefill_cost(cfg, n_tokens: int, *, ctx_tokens: int = 0,
                 kv_dtype_bytes: int = 2,
                 param_bytes: int = 4) -> StepCost:
    """Prefill of a T-token span whose first ``ctx_tokens`` of context
    already sit in the KV pool (prefix-cache hit or an earlier chunk of
    a chunked prefill — those spans are NOT priced here, so MFU stays
    honest when cached work is skipped).

    Causal attention: span position i attends ctx + i + 1 keys, so the
    attention term is ctx*T + T*(T+1)/2 contexts. HBM adds one read of
    the resident context's KV on top of the span's own write+read."""
    s = _shape(cfg)
    T = int(n_tokens)
    ctx = int(ctx_tokens)
    flops = (2.0 * s["matmul_weights"] * T
             + s["attn_per_ctx"] * (ctx * T + T * (T + 1) / 2.0))
    kvb = s["kv_bytes_per_token"] * kv_dtype_bytes
    hbm = s["num_params"] * param_bytes + (2.0 * T + ctx) * kvb
    return StepCost(flops, hbm, T)


def train_step_cost(cfg, batch: int, seq: Optional[int] = None, *,
                    param_bytes: int = 4,
                    act_bytes: int = 2) -> StepCost:
    """One optimizer step at (batch, seq): 6N-rule FLOPs plus an
    HBM-traffic approximation — 8 full passes over the params (fwd read,
    bwd read, grad write, adam m/v read+write, param write) + saved
    activations (~14*m elements per token per layer)."""
    s = _shape(cfg)
    if seq is None:
        seq = cfg.max_seq
    tokens = int(batch) * int(seq)
    flops = train_flops_per_token(cfg, seq) * tokens
    hbm = (8.0 * s["num_params"] * param_bytes
           + 14.0 * s["m"] * s["L"] * tokens * act_bytes)
    return StepCost(flops, hbm, tokens)


# ---------------------------------------------------------------------------
# Roofline verdicts
# ---------------------------------------------------------------------------


def roofline(cost: StepCost, device_s: float, host_gap_s: float = 0.0,
             *, hw: Optional[HardwarePeak] = None,
             n_chips: int = 1) -> dict:
    """Classify where a step's wall time went.

    mfu       achieved / peak FLOP rate over the DEVICE span
    hbm_util  achieved / peak HBM bandwidth over the device span
    verdict   'host'    if the host gap around the device span exceeds
                        the device span itself (the device idles more
                        than it runs),
              'compute' if mfu >= hbm_util (closer to the compute roof),
              'hbm'     otherwise (bandwidth is the binding roof).
    """
    hw = hw or detect_hardware()
    device_s = max(float(device_s), 1e-9)
    chips = max(int(n_chips), 1)
    mfu = cost.flops / (device_s * hw.flops_per_s * chips)
    hbm_util = cost.hbm_bytes / (device_s * hw.hbm_bytes_per_s * chips)
    if host_gap_s > device_s:
        verdict = "host"
    elif mfu >= hbm_util:
        verdict = "compute"
    else:
        verdict = "hbm"
    return {"mfu": mfu, "hbm_util": hbm_util, "verdict": verdict,
            "hardware": hw.name}


# ---------------------------------------------------------------------------
# Per-step accounting (the engine/train instrumentation hook)
# ---------------------------------------------------------------------------


class StepAccounting:
    """Accumulates one scheduler step's device spans + priced costs and
    folds them into a breakdown dict on finish(). Cheap enough for the
    per-decode-step hot path: a begin/add/finish
    cycle is plain float arithmetic, no locks, no allocation beyond the
    result dict."""

    __slots__ = ("hw", "n_chips", "busy_spans", "_wall0", "_device_s",
                 "_flops", "_hbm_bytes", "_tokens", "last")

    def __init__(self, hw: Optional[HardwarePeak] = None,
                 n_chips: int = 1, busy_spans: bool = True):
        self.hw = hw or detect_hardware()
        self.n_chips = max(int(n_chips), 1)
        self.busy_spans = bool(busy_spans)
        self._wall0 = 0.0
        self._device_s = 0.0
        self._flops = 0.0
        self._hbm_bytes = 0.0
        self._tokens = 0
        self.last: Optional[dict] = None

    def begin(self):
        self._wall0 = time.perf_counter()
        self._device_s = 0.0
        self._flops = 0.0
        self._hbm_bytes = 0.0
        self._tokens = 0

    def add_device(self, seconds: float, cost: StepCost = ZERO_COST):
        self._device_s += seconds
        self._flops += cost.flops
        self._hbm_bytes += cost.hbm_bytes
        self._tokens += cost.tokens

    def finish(self, *, record_as: Optional[str] = None,
               attrs: Optional[dict] = None) -> Optional[dict]:
        """Close the step. Returns None (and records nothing) if no
        device work ran — an idle scheduler tick is not a step."""
        if self._device_s <= 0.0 and self._flops <= 0.0:
            self.last = None
            return None
        wall_s = max(time.perf_counter() - self._wall0, self._device_s)
        host_gap_s = wall_s - self._device_s
        if not self.busy_spans:
            # Dispatch-to-ready spans bound the busy time from above only:
            # nothing is priced against them. The step's cost stays.
            out = {
                "step_ms": wall_s * 1e3,
                "dispatch_to_ready_ms": self._device_s * 1e3,
                "device_ms": None,
                "host_gap_ms": host_gap_s * 1e3,
                "mfu": None,
                "hbm_util": None,
                "verdict": None,
                "hardware": self.hw.name,
                "tokens": self._tokens,
                "flops": self._flops,
                "hbm_bytes": self._hbm_bytes,
            }
            self.last = out
            if record_as is not None:
                record_device_step(record_as, time.time() - wall_s, out,
                                   attrs)
            return out
        rl = roofline(
            StepCost(self._flops, self._hbm_bytes, self._tokens),
            self._device_s, host_gap_s, hw=self.hw, n_chips=self.n_chips)
        out = {
            "step_ms": wall_s * 1e3,
            "device_ms": self._device_s * 1e3,
            "host_gap_ms": host_gap_s * 1e3,
            "mfu": rl["mfu"],
            "hbm_util": rl["hbm_util"],
            "verdict": rl["verdict"],
            "hardware": rl["hardware"],
            "tokens": self._tokens,
        }
        self.last = out
        if record_as is not None:
            record_device_step(record_as, time.time() - wall_s, out,
                              attrs)
        return out


# ---------------------------------------------------------------------------
# Process-local device-step ring: every accounted step lands here, for
# whatever reads this process's steps afterwards
# ---------------------------------------------------------------------------

_ring_lock = threading.Lock()
_STEP_RING: collections.deque = collections.deque(maxlen=4096)


def record_device_step(name: str, t_wall: float, breakdown: dict,
                       attrs: Optional[dict] = None):
    ev = {"name": name, "t_wall": float(t_wall)}
    ev.update(breakdown)
    if attrs:
        ev.update(attrs)
    with _ring_lock:
        _STEP_RING.append(ev)


def device_step_events(since: float = 0.0,
                       limit: int = 4096) -> List[dict]:
    """Recorded device steps with t_wall >= since, oldest first."""
    with _ring_lock:
        evs = [e for e in _STEP_RING if e["t_wall"] >= since]
    return evs[-limit:]


def clear_device_steps():
    with _ring_lock:
        _STEP_RING.clear()
