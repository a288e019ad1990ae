"""Load-time weight fusions of the serving layout, as module surgery on `FluxDiT`.

Counterpart of `reflectionflow_tpu/ops/fuse.py`; each function changes the
model in place (the JAX functions return a new tree) and returns it:

  * `fuse_dit_qkv`: each attention's q/k/v linears become one (H -> 3H) panel,
    `attn.qkv` (and `attn.txt_qkv` for the txt stream of double blocks);
  * `fuse_single_block_io`: in single blocks [q|k|v|proj_mlp] become `in_proj`
    (H -> 3H+M) and `proj_out` (H+M -> H) splits into `out_attn` (H -> H, with
    the bias) and `out_mlp` (M -> H), so the (L, H+M) concat is never built;
  * `permute_rope_layout`: the q and k outputs of every head, and the QK-norm
    scales, go to the half-split RoPE order (`rope_split_perm`), after which
    the model runs with `rope_layout="split"`.

Apply them to float weights, before `ops.quant.quantize_dit_params`
(per-output-channel scales survive concatenation and row permutation). The
fused modules take the JAX key names, so `FluxDiT.jax_path` maps them to the
JAX serving tree.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.flux.rope import rope_split_perm
from .quant import NF4Linear, QuantLinear


def _cat_linears(parts: list[nn.Linear]) -> nn.Linear:
    """One linear whose outputs are the parts' outputs side by side; a part
    without a bias contributes zeros (None when no part has one)."""
    w = torch.cat([p.weight for p in parts], dim=0)
    have_bias = any(p.bias is not None for p in parts)
    fused = nn.Linear(w.shape[1], w.shape[0], bias=have_bias, device="meta")
    fused.weight = nn.Parameter(w, requires_grad=False)
    if have_bias:
        fused.bias = nn.Parameter(torch.cat([
            p.bias if p.bias is not None else w.new_zeros(p.weight.shape[0]) for p in parts
        ]), requires_grad=False)
    return fused


def _linear_from(weight: torch.Tensor, bias: torch.Tensor | None) -> nn.Linear:
    lin = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None, device="meta")
    lin.weight = nn.Parameter(weight.contiguous(), requires_grad=False)
    if bias is not None:
        lin.bias = nn.Parameter(bias, requires_grad=False)
    return lin


def _pop(module: nn.Module, *names: str) -> list[nn.Module]:
    out = [getattr(module, n) for n in names]
    for n in names:
        delattr(module, n)
    return out


@torch.no_grad()
def fuse_dit_qkv(dit: nn.Module) -> nn.Module:
    """Fuse the q/k/v projections of every attention into `qkv` / `txt_qkv`."""
    for block in list(dit.transformer_blocks) + list(dit.single_transformer_blocks):
        a = block.attn
        if isinstance(getattr(a, "to_q", None), nn.Linear):
            a.qkv = _cat_linears(_pop(a, "to_q", "to_k", "to_v"))
        if isinstance(getattr(a, "add_q_proj", None), nn.Linear):
            a.txt_qkv = _cat_linears(_pop(a, "add_q_proj", "add_k_proj", "add_v_proj"))
    return dit


@torch.no_grad()
def fuse_single_block_io(dit: nn.Module) -> nn.Module:
    """[q|k|v|proj_mlp] -> `in_proj`; `proj_out` -> `out_attn` + `out_mlp`.
    Leaves a block unchanged when its layout does not match (already fused,
    or quantized)."""
    for block in dit.single_transformer_blocks:
        a = block.attn
        if isinstance(getattr(a, "to_q", None), nn.Linear):
            a.qkv = _cat_linears(_pop(a, "to_q", "to_k", "to_v"))
        if not all(isinstance(getattr(m, n, None), nn.Linear)
                   for m, n in ((a, "qkv"), (block, "proj_mlp"), (block, "proj_out"))):
            continue
        (qkv,) = _pop(a, "qkv")
        mlp_in, out = _pop(block, "proj_mlp", "proj_out")
        block.in_proj = _cat_linears([qkv, mlp_in])
        hidden = qkv.weight.shape[1]
        block.out_attn = _linear_from(out.weight[:, :hidden], out.bias)
        block.out_mlp = _linear_from(out.weight[:, hidden:], None)
    return dit


def _permute_rows(lin: nn.Linear, start: int, stop: int, head_dim: int) -> None:
    """Permute output rows [start, stop) within each head, in place."""
    perm = torch.from_numpy(rope_split_perm(head_dim)).to(lin.weight.device)
    idx = torch.arange(lin.weight.shape[0], device=lin.weight.device)
    n_heads = (stop - start) // head_dim
    idx[start:stop] = (start + torch.arange(n_heads, device=idx.device)[:, None] * head_dim
                       + perm[None, :]).reshape(-1)
    lin.weight.copy_(lin.weight[idx])
    if lin.bias is not None:
        lin.bias.copy_(lin.bias[idx])


@torch.no_grad()
def permute_rope_layout(dit: nn.Module) -> nn.Module:
    """Permute q/k projection outputs and QK-norm scales to the half-split RoPE
    layout and mark the model `rope_layout="split"`. V and the output
    projections are untouched (attention logits are invariant under one
    permutation of q, k, the norm scales and the tables).

    Raises ValueError on a quantized model (the int8 panels can no longer be
    permuted, and skipping them would run split rotation on unpermuted q/k) and
    on a model already permuted."""
    if dit.rope_layout == "split":
        raise ValueError("permute_rope_layout: the model is already in the split layout")
    if any(isinstance(m, (QuantLinear, NF4Linear)) for m in dit.modules()):
        raise ValueError("permute_rope_layout: the model holds quantized linears; "
                         "apply load-time fusions BEFORE quantization")
    D = dit.cfg.head_dim
    H = dit.cfg.num_heads * D
    perm = torch.from_numpy(rope_split_perm(D))
    for block in list(dit.transformer_blocks) + list(dit.single_transformer_blocks):
        a = block.attn
        streams = [("qkv", "to_q", "to_k", "norm_q", "norm_k")]
        if hasattr(a, "norm_added_q"):
            streams.append(("txt_qkv", "add_q_proj", "add_k_proj", "norm_added_q", "norm_added_k"))
        for panel, q_name, k_name, nq, nk in streams:
            if hasattr(a, panel):
                _permute_rows(getattr(a, panel), 0, 2 * H, D)  # the q and k thirds
            elif hasattr(a, q_name):
                _permute_rows(getattr(a, q_name), 0, H, D)
                _permute_rows(getattr(a, k_name), 0, H, D)
            for norm in (getattr(a, nq), getattr(a, nk)):
                norm.weight.copy_(norm.weight[perm.to(norm.weight.device)])
        if hasattr(block, "in_proj"):  # fused single layout: q and k lead the panel
            _permute_rows(block.in_proj, 0, 2 * H, D)
    dit.rope_layout = "split"
    return dit
