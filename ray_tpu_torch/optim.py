"""The part of optax the training step uses: ``adamw`` and
``apply_updates`` (port of optax.adamw as ray_tpu's bench and train
step call it, ``bench.py:88-89``).

Params, gradients and moments are trees of nested dicts with tensors at
the leaves, the shape of the model's param tree. The arithmetic is
optax's, step for step, in the same dtypes:

  * ``scale_by_adam``: mu = (1 - b1)·g + b1·mu, nu = (1 - b2)·g² + b2·nu,
    bias-corrected by 1 - b**count in f32, update = mu_hat /
    (sqrt(nu_hat + eps_root) + eps) with eps_root 0 (eps outside the
    root); mu is stored in ``mu_dtype`` after the update is formed;
  * ``add_decayed_weights``: + weight_decay·p on EVERY leaf (optax's
    ``mask=None`` decays layernorm scales and embeddings too);
  * ``scale_by_learning_rate``: × -lr.

One detail follows JAX's type promotion: a Python float times a bf16
moment is computed with the float rounded to bf16 (a weakly typed
scalar takes the array's dtype), so the decay applied to a bf16 first
moment is bf16(b1). Plain tensor ops, no kernel: the update is a few
elementwise passes over the params.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ._tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    """optax's ScaleByAdamState: the step count (int32, on the params'
    device), the first moment (``mu_dtype``) and the second (the
    gradients' dtype)."""
    count: torch.Tensor
    mu: Any
    nu: Any


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """x rounded to ``dtype``, as JAX rounds a weakly typed scalar that
    meets an array of that dtype."""
    return float(torch.tensor(x, dtype=dtype))


class AdamW:
    """``optax.adamw``: ``init(params)`` and ``update(grads, state,
    params) -> (updates, state)``. The state is never updated in place;
    ``apply_updates`` applies the updates."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 mu_dtype: Optional[torch.dtype] = None):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params) -> AdamWState:
        dev = tree_leaves(params)[0].device
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=tree_map(lambda p: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype), params),
            nu=tree_map(torch.zeros_like, params))

    def update(self, grads, state: AdamWState, params):
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        t = count.float()
        # 1 - b**count in f32 (optax's bias_correction).
        bc1 = 1 - torch.tensor(b1, device=t.device) ** t
        bc2 = 1 - torch.tensor(b2, device=t.device) ** t

        def moments(g, mu, nu):
            mu = (1 - b1) * g + _in_dtype(b1, mu.dtype) * mu
            nu = (1 - b2) * (g * g) + _in_dtype(b2, nu.dtype) * nu
            return mu, nu

        both = tree_map(moments, grads, state.mu, state.nu)
        mu = tree_map(lambda m: m[0], both)
        nu = tree_map(lambda m: m[1], both)

        def update(m, v, p):
            u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype))
                                         + self.eps)
            return (u + self.weight_decay * p) * -self.lr

        updates = tree_map(update, mu, nu, params)
        if self.mu_dtype is not None:
            mu = tree_map(lambda m: m.to(self.mu_dtype), mu)
        return updates, AdamWState(count=count, mu=mu, nu=nu)


# optax's name and signature (``eps_root`` 0, ``mask`` None, a constant
# learning rate); the bench calls ``adamw(3e-4, b1=.9, b2=.95,
# weight_decay=.1, mu_dtype=torch.bfloat16)``.
adamw = AdamW


def apply_updates(params, updates, *, inplace: bool = False):
    """params + updates, in each param's dtype (``optax.apply_updates``).
    ``inplace`` adds into the param tensors themselves and returns the
    same tree (the train step's donated params)."""
    if inplace:
        with torch.no_grad():
            tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
        return params
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
