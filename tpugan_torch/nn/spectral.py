"""Spectral-normalised dense layer (counterpart of ``tpugan/nn/spectral.py``).

E_BIG's conditional batch norms scale and shift by spectral-normalised
linears. Only the eval forward is ported: ``sigma = u . (W v)`` from the
stored ``u`` [out] and ``v`` [in] buffers (``tpugan``'s ``sn`` collection),
with no power iteration. The training forward, which advances ``u`` and
``v`` once per call, comes with the training slice; until then a module in
training mode raises.
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
        if self.training:
            raise NotImplementedError(
                "SNDense's training forward (one power iteration per call) comes with "
                "ROADMAP slice 5b (E_BIG training); call .eval() to use the stored u and v"
            )
        w = self.weight / self.sigma().to(self.weight.dtype)
        return F.linear(x, w, self.bias)
