"""Tensor-parallel sharding of the FLUX DiT over a mesh's "model" axis.

Counterpart of `reflectionflow_tpu/parallel/specs.py` (`dit_param_spec`,
`shard_dit_params`), Megatron-style: the q/k/v projections and the MLP's
first linear split their output (heads, hidden) across the model group
(COL), the attention out-projections and the MLP's second linear split their
input (ROW), so each attention and each MLP ends in one sum across the
group. Keyed by the port's diffusers names; a torch `nn.Linear.weight` is
(out, in), so COL cuts dim 0 (and its bias) and ROW dim 1 (its bias is
added once, after the sum). Everything else stays whole on every rank
(modulation, embedders, norms, the model's `proj_out`).

One divergence: the single block's `proj_out` (input [attn H | mlp M]) is
cut on its input into the same head and hidden slices as its inputs and
summed across the group (`PAIR`), where JAX leaves `single_blocks/out`
replicated and XLA gathers the two sharded inputs first: the sum is the
same.

`shard_dit_params` cuts the weights in place, so a rank holds only its
shard's bytes, and puts the sum in the model as `RowParallelLinear` modules
(the forward of `models/flux/dit.py` is unchanged: its blocks read the
head count of their shard from `block.cfg`). XLA's SPMD partitioner places
these sums in the JAX package; here they are the port's own
(`parallel/collectives.py::all_reduce_sum`). The fused serving layout
(`FluxPipeline.quantize`) is not sharded: W8A8 under tensor parallelism
needs the per-token int8 scale of a ROW linear's input taken over the whole
row, a cross-rank amax before K3–K5 (ROADMAP slice 7b part 2). FSDP
(`fsdp_param_spec`, `shard_fsdp_params`) is part 2 as well.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from . import collectives

COL, ROW, PAIR = "col", "row", "pair"
_DOUBLE = {
    "attn.to_q": COL, "attn.to_k": COL, "attn.to_v": COL,
    "attn.add_q_proj": COL, "attn.add_k_proj": COL, "attn.add_v_proj": COL,
    "ff.net.0.proj": COL, "ff_context.net.0.proj": COL,
    "attn.to_out.0": ROW, "attn.to_add_out": ROW, "ff.net.2": ROW, "ff_context.net.2": ROW,
}
_SINGLE = {"attn.to_q": COL, "attn.to_k": COL, "attn.to_v": COL, "proj_mlp": COL, "proj_out": PAIR}
_FAMILIES = {"transformer_blocks": _DOUBLE, "single_transformer_blocks": _SINGLE}
TP_QUANTIZE_MSG = (
    "W8A8 / NF4 and the fused serving layout under tensor parallelism are ROADMAP slice 7b part 2 "
    "(a ROW linear's per-token int8 scale needs a cross-rank amax before K3-K5); serve the "
    "quantized profiles over the \"data\" axis alone")


def dit_linear_kind(name: str) -> str | None:
    """A DiT linear's module name -> COL, ROW, PAIR or None (replicated)."""
    family, _, rest = name.partition(".")
    rules = _FAMILIES.get(family)
    if rules is None:
        return None
    _, _, leaf = rest.partition(".")  # drop the block index
    return rules.get(leaf)


def dit_param_spec(name: str) -> int | None:
    """A DiT parameter's name (`state_dict` key) -> the dim of the torch
    tensor that the model axis cuts, or None where it stays whole."""
    module, _, kind_of = name.rpartition(".")
    kind = dit_linear_kind(module)
    if kind == COL:
        return 0
    if kind in (ROW, PAIR) and kind_of == "weight":
        return 1
    return None


class RowParallelLinear(nn.Module):
    """A linear whose input (and weight columns) is cut across the model
    group: y = sum over the group of x_shard @ W_shard^T, then + bias once."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None, group, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.in_features, self.out_features = weight.shape[1], out_features
        self.group = _Group(group)

    def forward(self, x):
        y = collectives.all_reduce_sum(F.linear(x, self.weight), self.group.group)
        return y if self.bias is None else y + self.bias


class _Group:
    """A process-group handle that `copy.deepcopy` (`lora.fold_lora`) shares
    instead of copying."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


def _slices(cfg, tp: int, m: int):
    """Rank m's head columns and MLP-hidden columns."""
    h = cfg.num_heads // tp * cfg.head_dim
    mh = cfg.mlp_hidden // tp
    return slice(m * h, (m + 1) * h), slice(m * mh, (m + 1) * mh)


def _cut(t: torch.Tensor, dim: int, index) -> torch.Tensor:
    """A contiguous copy of `t` along `dim` at `index` (a slice or an index
    tensor), so the full tensor's storage can be freed."""
    if isinstance(index, slice):
        return t.narrow(dim, index.start, index.stop - index.start).clone()
    return t.index_select(dim, index.to(t.device)).contiguous()


@torch.no_grad()
def shard_dit_params(dit: nn.Module, mesh) -> nn.Module:
    """Cut `dit`'s weights in place for this rank of the mesh's "model" axis
    (no-op when the axis is absent or of one rank); returns `dit`. Sets
    `dit.tp` (the model group) / `dit.tp_size` and each block's head count to
    its shard's.
    A quantized or fused (serving-layout) model raises NotImplementedError."""
    tp = mesh.axis_size("model")
    if tp == 1:
        return dit
    if getattr(dit, "tp_size", 1) != 1:
        raise ValueError("shard_dit_params: the model is already sharded")
    cfg = dit.cfg
    if cfg.num_heads % tp or cfg.mlp_hidden % tp:
        raise ValueError(f"model axis {tp} must divide num_heads={cfg.num_heads} and "
                         f"mlp_hidden={cfg.mlp_hidden}")
    if dit.rope_layout != "pair":  # FluxPipeline.quantize fuses and permutes first
        raise NotImplementedError(TP_QUANTIZE_MSG)
    group, m = mesh.group("model"), mesh.coords["model"]
    heads, hidden = _slices(cfg, tp, m)
    H = cfg.hidden_size
    pair = torch.cat([torch.arange(heads.start, heads.stop), H + torch.arange(hidden.start, hidden.stop)])
    local = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp)
    modules = dict(dit.named_modules())
    for name, mod in list(modules.items()):
        kind = dit_linear_kind(name)
        if kind is None:
            continue
        if not isinstance(mod, nn.Linear):
            raise NotImplementedError(f"{name} is a {type(mod).__name__}: {TP_QUANTIZE_MSG}")
        cols = hidden if ".net." in name or name.endswith("proj_mlp") else heads
        if kind == COL:
            mod.weight = nn.Parameter(_cut(mod.weight, 0, cols), requires_grad=False)
            if mod.bias is not None:
                mod.bias = nn.Parameter(_cut(mod.bias, 0, cols), requires_grad=False)
            mod.out_features = mod.weight.shape[0]
            continue
        w = _cut(mod.weight, 1, pair if kind == PAIR else cols)
        row = RowParallelLinear(w, None if mod.bias is None else mod.bias.detach(), group,
                                mod.out_features)
        parent_name, _, leaf = name.rpartition(".")
        parent = modules[parent_name]
        if isinstance(parent, nn.ModuleList):
            parent[int(leaf)] = row
        else:
            setattr(parent, leaf, row)
    for blocks in (dit.transformer_blocks, dit.single_transformer_blocks):
        for block in blocks:
            block.cfg = local
    dit.tp, dit.tp_size = _Group(group), tp
    return dit
