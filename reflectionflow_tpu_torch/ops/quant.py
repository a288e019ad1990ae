"""Weight quantization for serving: int8 W8A8 and weight-only (w8a16)
linears, and packed NF4 (w4a16) linears.

Counterpart of `reflectionflow_tpu/ops/quant.py`. Int8 weights are
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
the JAX package's `models.flux.dit.linear`.

NF4 (QLoRA's 16-level code, w4a16): one absmax scale per (contraction group,
output channel), each weight the index of its nearest code, two indices a
byte. The packed codes and scales keep the JAX package's (in, out) layout,
in its two packings: "pair" (`w_p4`, nibbles of rows 2j and 2j + 1) and
"plane" (`w_p4p`, low nibbles rows [0, in/2), high nibbles the rest).
`NF4Linear` decodes its weight through the 16-entry table into the
activation dtype and multiplies in that dtype, the JAX package's
dequantize-then-matmul (its select-tree decode is a TPU measure).

`quantize_dit_params` swaps, in place, every `nn.Linear` of a model whose
weight in the JAX tree (stacked over the blocks of its family) has at least
`min_size` elements; the model maps its module names to JAX tree paths
(`jax_path`), so `act_quant_exclude` and `int4_paths` substrings select the
same layers as in the JAX package. `quantize_params_int4` packs every such
linear NF4 (the T5 co-residency profile).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

def quantize_linear(w: torch.Tensor, amax: torch.Tensor | None = None):
    """(out, in) float weight -> (w_q int8 (out, in), w_scale fp32 (out,));
    `amax` (out,) replaces each row's max |w| where the row is cut across
    ranks."""
    wf = w.float()
    scale = ((wf.abs().amax(dim=-1) if amax is None else amax) / 127.0).clamp_min(1e-12)
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


def int8_acc(x_q: torch.Tensor, w_q: torch.Tensor, n_out: int) -> torch.Tensor:
    """x_q (..., in) int8 x w_q (out', in') int8 -> (..., n_out) int32, exact.
    w_q may be padded with zeros past (n_out, in), as `QuantLinear` keeps it;
    x_q is padded to match."""
    lead, k_pad = x_q.shape[:-1], w_q.shape[1] - x_q.shape[-1]
    x2 = x_q.reshape(-1, x_q.shape[-1])
    return _int_mm(F.pad(x2, (0, k_pad)) if k_pad else x2, w_q)[:, :n_out].reshape(*lead, -1)


def int8_matmul_pre(x_q, x_scale, w_q, w_scale, bias=None, dtype=torch.bfloat16):
    """W8A8 product of a pre-quantized activation (ops.fused_quant): x_q
    (..., in) int8, x_scale (..., 1) fp32 -> (..., out) in `dtype`, out =
    len(w_scale) (`int8_acc`, then the rank-1 rescale)."""
    acc = int8_acc(x_q, w_q, w_scale.shape[0])
    out = (acc * x_scale).mul_(w_scale).to(dtype)  # int32 -> fp32 inside the first product
    return out if bias is None else out + bias


def quantize_act(x: torch.Tensor, amax: torch.Tensor | None = None):
    """Per-token dynamic int8: -> (x_q int8, x_scale (..., 1) fp32), x_scale =
    max(amax, 1e-12) / 127 with `amax` the row's max |x| (given where it is
    taken over more than `x`, as a row cut across ranks)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    x_scale = amax.clamp_min(1e-12) / 127.0
    return torch.round(xf / x_scale).to(torch.int8), x_scale  # |xf| <= 127 * x_scale: no clip


def int8_matmul(x, w_q, w_scale):
    """W8A8 with per-token dynamic activation quantization; (..., out) in x.dtype."""
    x_q, x_scale = quantize_act(x)
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


# NF4 codebook (QLoRA, Dettmers et al. 2023): the 16 quantile levels of
# N(0, 1) scaled to [-1, 1]; the JAX package's values, bit for bit
NF4_CODE_VALUES = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)


def _nf4_codes(device=None) -> torch.Tensor:
    return torch.tensor(NF4_CODE_VALUES, dtype=torch.float32, device=device)


def _nf4_indices(w: torch.Tensor, group: int):
    """(in, out) float -> (idx (G, group, out) uint8 nearest-code indices,
    scale (G, 1, out) fp32 per-(group, channel) absmax), computed in fp32 as
    the JAX package does (the first midpoint at or above w / scale, side
    "left"). Both packings consume this, so codes and scales agree."""
    w = w.float()
    din, dout = w.shape
    wg = w.reshape(din // group, group, dout)
    scale = wg.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12)
    codes = _nf4_codes(w.device)
    mids = (codes[1:] + codes[:-1]) / 2.0
    idx = torch.searchsorted(mids, (wg / scale).contiguous()).to(torch.uint8)
    return idx, scale


def quantize_linear_int4(w: torch.Tensor, group: int = 128):
    """(out, in) float weight -> (w_p4 (G, group/2, out) uint8 in the pair
    packing, w_scale4 (G, 1, out) fp32), or None when `in` is not a multiple
    of `group` (the caller then falls back to int8 w8a16, as JAX does)."""
    din = w.shape[1]
    if din % group or din < group:
        return None
    idx, scale = _nf4_indices(w.t(), group)
    return idx[:, 0::2] | (idx[:, 1::2] << 4), scale


def quantize_linear_int4_plane(w: torch.Tensor, group: int = 128):
    """(out, in) float weight -> (w_p4p (in/2, out) uint8 in the split-plane
    packing, w_scale4 (G, 1, out) fp32), or None when `in` is not a multiple
    of 2 x `group` (the caller then tries the pair packing, as JAX does)."""
    din = w.shape[1]
    if din % (2 * group) or din < 2 * group:
        return None
    idx, scale = _nf4_indices(w.t(), group)
    flat = idx.reshape(din, -1)
    return flat[: din // 2] | (flat[din // 2:] << 4), scale


def _nf4_decode(packed: torch.Tensor):
    """uint8 codes -> (low-nibble values, high-nibble values), fp32, by
    indexing the 16-entry table."""
    codes = _nf4_codes(packed.device)
    return codes[(packed & 0xF).long()], codes[(packed >> 4).long()]


def int4_matmul(x: torch.Tensor, w_p4: torch.Tensor, w_scale4: torch.Tensor) -> torch.Tensor:
    """W4A16, pair packing: decode, scale per group in fp32, cast to x's dtype,
    one matmul. x (..., in); w_p4 (G, group/2, out); w_scale4 (G, 1, out)."""
    lo, hi = _nf4_decode(w_p4)
    q = torch.stack([lo, hi], dim=-2)  # (G, group/2, 2, out): rows 2j, 2j + 1
    G, half, _, dout = q.shape
    w = (q * w_scale4[:, :, None, :]).to(x.dtype)
    return x @ w.reshape(G * half * 2, dout)


def int4_matmul_plane(x: torch.Tensor, w_p4p: torch.Tensor, w_scale4: torch.Tensor) -> torch.Tensor:
    """W4A16, split-plane packing: both planes decoded and concatenated along
    the contraction, scaled per group. x (..., in); w_p4p (in/2, out)."""
    K2, dout = w_p4p.shape
    G = w_scale4.shape[0]
    lo, hi = _nf4_decode(w_p4p)
    q = torch.cat([lo, hi], dim=0)  # (in, out), rows in their original order
    w = (q.reshape(G, (2 * K2) // G, dout) * w_scale4).to(x.dtype)
    return x @ w.reshape(2 * K2, dout)


class NF4Linear(nn.Module):
    """A packed NF4 linear (w4a16): `w_packed` uint8 in the JAX package's
    (in, out) layout, pair or plane (`layout`), `w_scale4` (G, 1, out) fp32,
    optional bias in the activation dtype; the part of the int4 branches of
    the JAX package's `models.flux.dit.linear`."""

    def __init__(self, w_packed: torch.Tensor, w_scale4: torch.Tensor, bias: torch.Tensor | None,
                 layout: str):
        super().__init__()
        if layout not in ("pair", "plane"):
            raise ValueError(f"NF4 layout must be 'pair' or 'plane', got {layout!r}")
        self.register_buffer("w_packed", w_packed)
        self.register_buffer("w_scale4", w_scale4)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.layout = layout
        G, rows = w_scale4.shape[0], w_packed.shape[-2]
        self.in_features = 2 * rows * (G if layout == "pair" else 1)

    def extra_repr(self) -> str:
        return (f"in={self.in_features}, out={self.w_scale4.shape[-1]}, layout={self.layout}, "
                f"group={self.in_features // self.w_scale4.shape[0]}, bias={self.bias is not None}")

    def forward(self, x):
        mm = int4_matmul_plane if self.layout == "plane" else int4_matmul
        out = mm(x, self.w_packed, self.w_scale4)
        return out if self.bias is None else out + self.bias


def nf4_linear(lin: nn.Linear, group: int = 128, layout: str = "pair") -> nn.Module:
    """An `nn.Linear` -> its `NF4Linear`, with the JAX package's fallbacks: a
    contraction that the plane packing cannot split goes pair, one that no
    group divides goes int8 w8a16 (`QuantLinear`)."""
    w = lin.weight.detach()
    bias = None if lin.bias is None else lin.bias.detach()
    if layout == "plane":
        packed = quantize_linear_int4_plane(w, group)
        if packed is not None:
            return NF4Linear(*packed, bias, "plane")
    packed = quantize_linear_int4(w, group)
    if packed is not None:
        return NF4Linear(*packed, bias, "pair")
    return QuantLinear.from_linear(lin, act_quant=False)


def _swap_linears(model: nn.Module, min_size: int, make) -> nn.Module:
    """Replace, in place, each `nn.Linear` whose JAX-tree weight (elements x
    blocks stacked in its family) is at least `min_size` by `make(lin, path)`,
    `path` its JAX leaf path ("double_blocks/img_mlp/fc1/w"). A linear cut
    over a mesh's "model" axis is sized by its whole weight (`tp_numel`); a
    row-cut one (`parallel.specs.RowParallelLinear`) quantizes its own
    columns (`quantize_shard`)."""
    names = [n for n, m in model.named_modules()
             if isinstance(m, nn.Linear) or hasattr(m, "quantize_shard")]
    for name in names:  # one at a time, so each float weight is freed when replaced
        lin = model.get_submodule(name)
        path, _, n_stack = model.jax_path(name)
        if getattr(lin, "tp_numel", lin.weight.numel()) * n_stack < min_size:
            continue
        if hasattr(lin, "quantize_shard"):
            lin.quantize_shard(lambda stand_in: make(stand_in, f"{path}/w"))
        else:
            new = make(lin, f"{path}/w")
            for attr in ("tp_cut", "tp_numel"):  # a column cut stays recorded
                if hasattr(lin, attr):
                    setattr(new, attr, getattr(lin, attr))
            model.set_submodule(name, new)
        del lin
    return model


def quantize_dit_params(model: nn.Module, min_size: int = 1 << 20, act_quant: bool = True,
                        act_quant_exclude: tuple[str, ...] = (), int4_paths: tuple[str, ...] = (),
                        int4_group: int = 128, int4_layout: str = "pair") -> nn.Module:
    """Swap, in place, each `nn.Linear` of `model` whose JAX-tree weight
    (elements x blocks stacked in its family) is at least `min_size`: for an
    `NF4Linear` (`nf4_linear`, group `int4_group`, packing `int4_layout`)
    when its JAX leaf path contains an `int4_paths` substring, else for a
    `QuantLinear`, W8A8 unless `act_quant` is False or the path (e.g.
    "double_blocks/img_mod/w") contains an `act_quant_exclude` substring.
    `model` provides `jax_path(name) -> (path, block index, blocks stacked)`."""

    def make(lin, path):
        if any(sub in path for sub in int4_paths):
            cut = getattr(lin, "tp_segments", ())  # a row cut: its input spans in the whole row
            if any(b % int4_group for seg in cut for b in seg):
                raise ValueError(f"{path}: the \"model\" axis cuts its input at {cut}, which splits "
                                 f"NF4 groups of {int4_group}")
            return nf4_linear(lin, int4_group, int4_layout)
        aq = act_quant and not any(sub in path for sub in act_quant_exclude)
        return QuantLinear.from_linear(lin, aq)

    return _swap_linears(model, min_size, make)


def quantize_params_int4(model: nn.Module, min_size: int = 1 << 20, group: int = 128,
                         layout: str = "pair") -> nn.Module:
    """NF4-pack, in place, every linear of `model` at least `min_size` big
    (`nf4_linear` and its fallbacks)."""
    return _swap_linears(model, min_size, lambda lin, _path: nf4_linear(lin, group, layout))
