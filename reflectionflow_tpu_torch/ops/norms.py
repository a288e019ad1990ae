"""Normalization + AdaLN modulation primitives.

Counterpart of `reflectionflow_tpu/ops/norms.py`: eps 1e-6, statistics in
fp32 whatever the input dtype, result in the input dtype.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free LayerNorm (elementwise_affine=False), fp32 accumulation."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with learned scale (FLUX QK-norm)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * scale.float()).to(x.dtype)


def adaln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift, with per-batch (B, H) shift/scale."""
    return layer_norm(x, eps) * (1.0 + scale[:, None, :]) + shift[:, None, :]
