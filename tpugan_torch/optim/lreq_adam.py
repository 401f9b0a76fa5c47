"""LREQAdam (counterpart of ``tpugan/optim/lreq_adam.py``).

Adam with beta1 = 0 (no first moment) and bias correction on the second
moment only, ``step = lr * sqrt(1 - beta2^t)``; each parameter's step is
multiplied by its equalized-LR coefficient
(:func:`tpugan_torch.ops.eq_lr.lreq_coefs`). The update of a parameter p
with gradient g is ``p -= (step * coef) * g / (sqrt(nu) + eps)``.

:meth:`LREQAdam.step` applies the parameters' ``.grad`` or, when it is
handed one, a list of gradients: the case-2 train step takes two gradients
at the same parameters and applies them one after the other.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

import torch

from tpugan_torch.ops.eq_lr import lreq_coefs


class LREQAdam(torch.optim.Optimizer):
    """``params`` and their equalized-LR ``coefs``, in the same order."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, coefs: Sequence[float],
                 beta2: float = 0.99, eps: float = 1e-8):
        params = list(params)
        coefs = [float(c) for c in coefs]
        if len(coefs) != len(params):
            raise ValueError(f"{len(coefs)} coefficients for {len(params)} parameters")
        super().__init__(params, dict(lr=lr, beta2=beta2, eps=eps))
        self.param_groups[0]["coefs"] = coefs

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[Optional[torch.Tensor]]] = None):
        """One update with ``grads`` (one per parameter, in order; None
        counts as zero) or, without them, each parameter's ``.grad``."""
        group = self.param_groups[0]
        params = group["params"]
        if grads is None:
            grads = [p.grad for p in params]
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} parameters")
        lr, beta2, eps = group["lr"], group["beta2"], group["eps"]
        for p, g, coef in zip(params, grads, group["coefs"]):
            state = self.state[p]
            if not state:
                state["step"] = 0
                state["nu"] = torch.zeros_like(p)
            state["step"] += 1
            nu = state["nu"]
            if g is None:
                nu.mul_(beta2)  # a zero gradient: the moment decays, p stays
                continue
            nu.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
            step_size = lr * math.sqrt(1.0 - beta2 ** state["step"])
            p.add_(-(step_size * coef) * g / (nu.sqrt() + eps))


def lreq_adam(module: torch.nn.Module, learning_rate: float, beta2: float = 0.99,
              eps: float = 1e-8) -> LREQAdam:
    """LREQAdam over ``module``'s parameters, each with its equalized-LR
    coefficient (counterpart of ``lreq_adam(lr, coefs=lreq_coef_tree(...))``)."""
    coefs = lreq_coefs(module)
    names, params = zip(*module.named_parameters())
    return LREQAdam(params, learning_rate, [coefs[n] for n in names], beta2=beta2, eps=eps)
