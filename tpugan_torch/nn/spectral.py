"""Spectral-normalised dense layer and its power iteration (counterpart of
``tpugan/nn/spectral.py``).

E_BIG's conditional batch norms scale and shift by spectral-normalised
linears. The forward always reads ``sigma = u . (W v)`` from the stored
``u`` [out] and ``v`` [in] buffers (``tpugan``'s ``sn`` collection), and the
gradient flows through sigma into the weight. Training advances the pair
once per step with :func:`power_iterate`, before the encoder runs, as
``tpugan``'s train step does (``tpugan/train/e_align.py:328``); that is
torch's in-forward buffer update, moved out of the forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.nn.layers import lecun_normal_


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


class SNDense(nn.Module):
    """Dense layer with spectral normalisation; weight [out, in] (the
    transpose of ``tpugan``'s kernel), buffers ``u`` [out] and ``v`` [in]."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 eps: float = 1e-12, generator: torch.Generator | None = None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(lecun_normal_(torch.empty(out_features, in_features), generator))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        u = _l2_normalize(torch.randn(out_features, generator=generator), eps)
        self.register_buffer("u", u)
        self.register_buffer("v", _l2_normalize(self.weight.detach().t() @ u, eps))

    def sigma(self) -> torch.Tensor:
        """The spectral-norm estimate from the stored pair, in fp32."""
        return self.u.float() @ self.weight.float() @ self.v.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight / self.sigma().to(self.weight.dtype)
        return F.linear(x, w, self.bias)


@torch.no_grad()
def power_iterate(module: nn.Module, n_iter: int = 1, eps: float = 1e-12) -> None:
    """Advance the ``u``/``v`` pair of every :class:`SNDense` in ``module``,
    in place and without gradient, by ``n_iter`` power iterations against
    its current weight: ``v = normalize(W^T u)``, then ``u = normalize(W v)``.
    ``eps`` is the normalisation's, as in ``tpugan``."""
    for m in module.modules():
        if isinstance(m, SNDense):
            w, u = m.weight, m.u
            for _ in range(n_iter):
                v = _l2_normalize(w.t() @ u, eps)
                u = _l2_normalize(w @ v, eps)
            m.u.copy_(u)
            m.v.copy_(v)
