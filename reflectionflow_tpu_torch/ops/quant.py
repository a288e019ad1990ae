"""Int8 weight quantization for serving: W8A8 and weight-only (w8a16) linears.

Counterpart of `reflectionflow_tpu/ops/quant.py` (int8 only). Weights are
symmetric per output channel: scale = max(amax / 127, 1e-12) and
w_q = clip(round(w / scale), -127, 127), computed in fp32.

  * W8A8: activations are quantized per token (x_scale = max(amax, 1e-12) / 127),
    the product runs int8 x int8 -> int32 (`torch._int_mm`, the library GEMM, as
    the JAX package leaves it to XLA's dot_general), and the rank-1 rescale
    acc * x_scale * w_scale is cast to the activation dtype before the bias is
    added, in the JAX package's rounding order.
  * w8a16: the weight is dequantized to the activation dtype and the product
    runs in that dtype.

`QuantLinear` holds one such linear and plays the part of the int8 branches of
the JAX package's `models.flux.dit.linear`. `quantize_dit_params` swaps, in
place, every `nn.Linear` of a model whose weight in the JAX tree (stacked over
the blocks of its family) has at least `min_size` elements; the model maps its
module names to JAX tree paths (`jax_path`), so `act_quant_exclude` substrings
select the same layers as in the JAX package. NF4 (int4) is ROADMAP item 12.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

NF4_NOT_PORTED = "NF4 (int4) weights are not ported yet: ROADMAP slice 2, item 12"


def quantize_linear(w: torch.Tensor):
    """(out, in) float weight -> (w_q int8 (out, in), w_scale fp32 (out,))."""
    wf = w.float()
    scale = (wf.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    w_q = torch.round(wf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return w_q, scale


def dequantize_weight(w_q: torch.Tensor, w_scale: torch.Tensor, dtype) -> torch.Tensor:
    return (w_q.float() * w_scale[:, None]).to(dtype)


def _int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exact. On CUDA the library
    GEMM wants M > 16 and K, N multiples of 8; short inputs (the modulation
    linears see M = batch) are padded with zero rows, which changes nothing.
    `QuantLinear` keeps K and N on the multiple."""
    M = x_q.shape[0]
    if x_q.is_cuda:
        K, N = x_q.shape[1], w_q.shape[0]
        if K % 8 or N % 8:
            raise ValueError(f"the int8 GEMM takes K, N multiples of 8, got K={K}, N={N}")
        if M <= 16:
            return torch._int_mm(F.pad(x_q, (0, 0, 0, 32 - M)), w_q.t())[:M]
    return torch._int_mm(x_q, w_q.t())


def int8_matmul_pre(x_q, x_scale, w_q, w_scale, bias=None, dtype=torch.bfloat16):
    """W8A8 product of a pre-quantized activation (ops.fused_quant): x_q
    (..., in) int8, x_scale (..., 1) fp32 -> (..., out) in `dtype`, out =
    len(w_scale). w_q may be padded with zeros past (out, in), as
    `QuantLinear` keeps it; x_q is padded to match."""
    lead, k_pad = x_q.shape[:-1], w_q.shape[1] - x_q.shape[-1]
    x2 = x_q.reshape(-1, x_q.shape[-1])
    acc = _int_mm(F.pad(x2, (0, k_pad)) if k_pad else x2, w_q)[:, :w_scale.shape[0]].reshape(*lead, -1)
    out = (acc * x_scale).mul_(w_scale).to(dtype)  # int32 -> fp32 inside the first product
    return out if bias is None else out + bias


def int8_matmul(x, w_q, w_scale):
    """W8A8 with per-token dynamic activation quantization; (..., out) in x.dtype."""
    xf = x.float()
    x_scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    x_q = torch.round(xf / x_scale).to(torch.int8)  # |xf| <= 127 * x_scale: no clip needed
    return int8_matmul_pre(x_q, x_scale, w_q, w_scale, dtype=x.dtype)


class QuantLinear(nn.Module):
    """An int8 linear: weight (out, in) int8, fp32 per-output-channel scale,
    optional bias in the activation dtype. `act_quant` selects W8A8 (True) or
    w8a16 (False). `w_q` is stored padded with zeros to multiples of 8 in both
    dimensions, once, for the CUDA int8 GEMM (Qwen2.5-VL's vision MLP is 3420
    wide); the product pads the activation and drops the padded outputs."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor | None,
                 act_quant: bool):
        super().__init__()
        self.in_features = w_q.shape[1]
        if w_q.shape[0] % 8 or w_q.shape[1] % 8:
            w_q = F.pad(w_q, (0, -w_q.shape[1] % 8, 0, -w_q.shape[0] % 8))
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.act_quant = act_quant

    @classmethod
    def from_linear(cls, lin: nn.Linear, act_quant: bool) -> "QuantLinear":
        w_q, w_scale = quantize_linear(lin.weight.detach())
        bias = None if lin.bias is None else lin.bias.detach()
        return cls(w_q, w_scale, bias, act_quant)

    def extra_repr(self) -> str:
        return (f"in={self.in_features}, out={self.w_scale.shape[0]}, "
                f"mode={'w8a8' if self.act_quant else 'w8a16'}, bias={self.bias is not None}")

    def matmul_pre(self, x_q, x_scale, dtype):
        """W8A8 product of an activation quantized by a fused kernel (K3–K5)."""
        return int8_matmul_pre(x_q, x_scale, self.w_q, self.w_scale, self.bias, dtype)

    def forward(self, x):
        if self.act_quant:
            out = int8_matmul(x, self.w_q, self.w_scale)
        else:
            w_q = self.w_q[: self.w_scale.shape[0], : self.in_features]
            out = x @ dequantize_weight(w_q, self.w_scale, x.dtype).t()
        return out if self.bias is None else out + self.bias


def quantize_dit_params(model: nn.Module, min_size: int = 1 << 20, act_quant: bool = True,
                        act_quant_exclude: tuple[str, ...] = (),
                        int4_paths: tuple[str, ...] = ()) -> nn.Module:
    """Swap, in place, each `nn.Linear` of `model` whose JAX-tree weight
    (elements x blocks stacked in its family) is at least `min_size` for a
    `QuantLinear`; W8A8 unless `act_quant` is False or its JAX path
    (e.g. "double_blocks/img_mod/w") contains an `act_quant_exclude` substring.
    `model` provides `jax_path(name) -> (path, block index, blocks stacked)`."""
    if int4_paths:
        raise NotImplementedError(NF4_NOT_PORTED)
    names = [n for n, m in model.named_modules() if isinstance(m, nn.Linear)]
    for name in names:  # one at a time, so each float weight is freed when replaced
        lin = model.get_submodule(name)
        path, _, n_stack = model.jax_path(name)
        if lin.weight.numel() * n_stack < min_size:
            continue
        aq = act_quant and not any(sub in f"{path}/w" for sub in act_quant_exclude)
        model.set_submodule(name, QuantLinear.from_linear(lin, aq))
        del lin
    return model
