"""Streaming LLM request handler (port of ray_tpu/serve/llm.py, the
handler class without the Serve deployment around it).

One ``LLMServer`` hosts ONE LLMEngine running its background step loop;
each ``__call__`` registers its request with the shared engine EAGERLY
(so time to first token starts at arrival, not at first stream pull)
and returns a generator of frames: one ``{"token": id}`` per generated
token, then a final ``{"done": True, ...}`` frame. Concurrent callers on
different threads share the engine's in-flight batch.

Tokenization is byte-level (ids 0..255) so the handler runs without an
external vocabulary: string prompts encode to UTF-8 bytes, and the
final frame carries the decoded text when every token is a byte.

The Serve deployment wrapper, HTTP and the TTFT/TPOT SLO phases wait
for the port of the runtime.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .._device import resolve_device


def encode(text: str):
    """Byte-level tokenize (ids 0..255)."""
    return list(text.encode("utf-8"))


def decode(tokens) -> Optional[str]:
    """Inverse of encode(); None if any token is out of byte range."""
    if any(t < 0 or t > 255 for t in tokens):
        return None
    return bytes(tokens).decode("utf-8", errors="replace")


class LLMServer:
    """The generation request handler: the JAX package's serving
    defaults (chunked prefill at 32 tokens, prefix cache on, max_batch
    8) on ``device`` (``None`` means the card)."""

    def __init__(self, cfg=None, params=None, *, seed: int = 0,
                 num_blocks: int = 64, block_size: int = 16,
                 max_batch: int = 8, default_max_tokens: int = 32,
                 prefill_chunk_tokens: Optional[int] = 32,
                 prefix_cache: bool = True,
                 speculative=None,
                 system_prompt=None, device=None):
        from ..llm.engine import LLMEngine
        from ..models.gpt import TINY, init

        dev = resolve_device(device)
        cfg = cfg if cfg is not None else TINY
        if params is None:
            params = init(cfg, torch.Generator().manual_seed(seed),
                          device=dev)
        self.default_max_tokens = int(default_max_tokens)
        # Deployment-wide prefix hint: prepended to every prompt, so
        # with the prefix cache on it is computed once and every later
        # request's cached span covers it.
        if isinstance(system_prompt, str):
            system_prompt = encode(system_prompt)
        self.system_prompt = [int(t) for t in (system_prompt or ())]
        self.engine = LLMEngine(params, cfg, num_blocks=num_blocks,
                                block_size=block_size,
                                max_batch=max_batch,
                                prefill_chunk_tokens=prefill_chunk_tokens,
                                prefix_cache=prefix_cache,
                                speculative=speculative, device=dev)
        self.engine.start()

    def __call__(self, request: Any):
        """request: {"prompt": str | [int], "max_tokens": int?,
        "temperature": float?, "top_k": int?, "seed": int?,
        "stop_tokens": [int]?}. Streams {"token": id} frames, then a
        final {"done": ..., "text": ...} frame."""
        if isinstance(request, str):
            request = {"prompt": request}
        prompt = request.get("prompt")
        if isinstance(prompt, str):
            prompt = encode(prompt)
        if not prompt:
            raise ValueError("request needs a non-empty 'prompt'")
        if self.system_prompt:
            prompt = self.system_prompt + list(prompt)
        # Register with the engine NOW: the request joins the in-flight
        # batch at the next step even though the generator body below
        # only runs when the stream is first pulled.
        req = self.engine.add_request(
            prompt,
            max_tokens=int(request.get("max_tokens",
                                       self.default_max_tokens)),
            temperature=float(request.get("temperature", 0.0)),
            top_k=int(request.get("top_k", 0)),
            seed=int(request.get("seed", 0)),
            stop_tokens=request.get("stop_tokens", ()))

        def gen():
            for tok in req.tokens():
                yield {"token": tok}
            yield {"done": True,
                   "finish_reason": req.finish_reason,
                   "num_tokens": len(req.output),
                   "preemptions": req.preemptions,
                   "cached_tokens": req.cached_tokens,
                   "text": decode(req.output)}

        return gen()

    def engine_stats(self) -> dict:
        return self.engine.stats()

    def __del__(self):
        try:
            self.engine.stop()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
