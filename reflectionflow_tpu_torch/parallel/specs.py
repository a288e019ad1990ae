"""Sharding over a mesh of ranks: the FLUX DiT's tensor parallelism over
"model", and FSDP of a frozen base over "data".

Counterpart of `reflectionflow_tpu/parallel/specs.py` (`dit_param_spec`,
`shard_dit_params`, `fsdp_param_spec`, `shard_fsdp_params`).

Tensor parallelism, Megatron-style: the q/k/v projections and the MLP's
first linear split their output (heads, hidden) across the model group
(COL), the attention out-projections and the MLP's second linear split their
input (ROW), so each attention and each MLP ends in one sum across the
group (`collectives.row_sum`); the blocks put `collectives.col_copy` before
the COL linears that share an input, so that a backward pass sums their
input gradients. Keyed by the port's diffusers names; a torch
`nn.Linear.weight` is (out, in), so COL cuts dim 0 (and its bias) and ROW dim
1 (its bias is added once, after the sum). Everything else stays whole on
every rank (modulation, embedders, norms, the model's `proj_out`).

One divergence: the single block's `proj_out` (input [attn H | mlp M]) is
cut on its input into the same head and hidden slices as its inputs and
summed across the group (`PAIR`), where JAX leaves `single_blocks/out`
replicated and XLA gathers the two sharded inputs first: the sum is the
same.

`shard_dit_params` cuts the weights in place, so a rank holds only its
shard's bytes, and puts the sum in the model as `RowParallelLinear` modules
(the forward of `models/flux/dit.py` is unchanged: its blocks read the
head count of their shard from `block.cfg`). Each cut linear records where
it was cut (`tp_cut`, `tp_numel`), so that `lora.lora_init` draws the whole
model's adapters and `LoRALinear` uses this rank's part of them, and
`FluxPipeline.quantize` sizes and quantizes the cut model as the whole: a
COL linear holds whole rows, so its int8 and NF4 codes are the whole's; a
ROW linear takes its per-channel weight amax and its input's per-token amax
over the whole row (`collectives.all_reduce_max`) and sums its int32
accumulators, and its NF4 groups must not straddle two ranks. XLA's SPMD
partitioner places these collectives in the JAX package.

FSDP (`shard_fsdp_params`) keeps 1/n of every tensor of a frozen module
along the dim `fsdp_param_spec` picks, and gathers it on use: a forward
pre-hook on each module whose subtree holds a shard gathers the shards
(`collectives.all_gather_dim`) and its forward hook frees them again, so a
block recomputed in the backward gathers again. JAX expresses the same as
shardings and leaves the gathers to XLA; the port's hooks run under gloo on
the CPU and on a shared card as under NCCL.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QuantLinear, int8_acc, quantize_act, quantize_linear
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
    group: y = sum over the group of x_shard @ W_shard^T, then + bias once.
    `tp_segments` are the spans of the whole input that this rank holds, in
    order; `quant`, once `quantize_shard` ran, is the int8 or NF4 linear over
    those columns."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None, group, out_features: int,
                 index, segments: list[tuple[int, int]], in_full: int):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.in_features, self.out_features = weight.shape[1], out_features
        self.group = _Group(group)
        self.tp_cut = (ROW, index)
        self.tp_segments = segments
        self.tp_numel = in_full * out_features
        self.quant = None

    def forward(self, x, extra: torch.Tensor | None = None):
        """`extra` (B, ..., out), a rank's partial term of a LoRA adapter, joins
        the partial product before the sum."""
        g, q = self.group.group, self.quant
        if q is not None and getattr(q, "act_quant", False):  # W8A8: exact int32 sums, then rescale
            amax = collectives.all_reduce_max(x.float().abs().amax(dim=-1, keepdim=True), g)
            x_q, x_scale = quantize_act(x, amax)
            acc = collectives.all_reduce_sum(int8_acc(x_q, q.w_q, self.out_features), g)
            y = (acc * x_scale).mul_(q.w_scale).to(x.dtype)
            if extra is not None:
                y = y + collectives.row_sum(extra, g)
        else:
            part = F.linear(x, self.weight) if q is None else q(x)
            y = collectives.row_sum(part if extra is None else part + extra, g)
        return y if self.bias is None else y + self.bias

    @torch.no_grad()
    def quantize_shard(self, make) -> None:
        """Quantize this rank's columns in place: `make(lin)` is the
        quantizer of a whole `nn.Linear` (`ops.quant.quantize_dit_params`),
        called on a stand-in over these columns that carries `tp_segments`.
        An int8 result is redone with the whole row's per-channel amax."""
        stand_in = nn.Linear(self.in_features, self.out_features, bias=False, device="meta")
        stand_in.weight = self.weight
        stand_in.tp_segments = self.tp_segments
        q = make(stand_in)
        if isinstance(q, QuantLinear):
            amax = collectives.all_reduce_max(self.weight.float().abs().amax(dim=-1), self.group.group)
            q = QuantLinear(*quantize_linear(self.weight, amax), None, q.act_quant)
        self.quant = q
        self.weight = None


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
    `dit.tp` and each block's `tp` (the model group), `dit.tp_size`, and each
    block's head count to its shard's. Cut it before `FluxPipeline.quantize`:
    a quantized or fused (serving-layout) model raises ValueError."""
    tp = mesh.axis_size("model")
    if tp == 1:
        return dit
    if getattr(dit, "tp_size", 1) != 1:
        raise ValueError("shard_dit_params: the model is already sharded")
    cfg = dit.cfg
    if cfg.num_heads % tp or cfg.mlp_hidden % tp:
        raise ValueError(f"model axis {tp} must divide num_heads={cfg.num_heads} and "
                         f"mlp_hidden={cfg.mlp_hidden}")
    if dit.rope_layout != "pair":
        raise ValueError("shard_dit_params: the DiT is in the fused serving layout; cut it before "
                         "FluxPipeline.quantize (set_mesh first), which then keeps the unfused "
                         "layout, as the JAX package does under a \"model\" axis")
    group, m = mesh.group("model"), mesh.coords["model"]
    heads, hidden = _slices(cfg, tp, m)
    H = cfg.hidden_size
    pair = torch.cat([torch.arange(heads.start, heads.stop), H + torch.arange(hidden.start, hidden.stop)])
    pair_segments = [(heads.start, heads.stop), (H + hidden.start, H + hidden.stop)]
    local = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp)
    modules = dict(dit.named_modules())
    for name, mod in list(modules.items()):
        kind = dit_linear_kind(name)
        if kind is None:
            continue
        if type(mod) is not nn.Linear:
            raise ValueError(f"shard_dit_params: {name} is a {type(mod).__name__}; cut the DiT before "
                             "FluxPipeline.quantize (set_mesh first)")
        cols = hidden if ".net." in name or name.endswith("proj_mlp") else heads
        if kind == COL:
            mod.tp_numel = mod.weight.numel()
            mod.weight = nn.Parameter(_cut(mod.weight, 0, cols), requires_grad=False)
            if mod.bias is not None:
                mod.bias = nn.Parameter(_cut(mod.bias, 0, cols), requires_grad=False)
            mod.out_features = mod.weight.shape[0]
            mod.tp_cut = (COL, cols)
            continue
        index = pair.to(mod.weight.device) if kind == PAIR else cols
        w = _cut(mod.weight, 1, index)
        row = RowParallelLinear(w, None if mod.bias is None else mod.bias.detach(), group,
                                mod.out_features, index,
                                pair_segments if kind == PAIR else [(cols.start, cols.stop)],
                                mod.in_features)
        parent_name, _, leaf = name.rpartition(".")
        parent = modules[parent_name]
        if isinstance(parent, nn.ModuleList):
            parent[int(leaf)] = row
        else:
            setattr(parent, leaf, row)
    for blocks in (dit.transformer_blocks, dit.single_transformer_blocks):
        for block in blocks:
            block.cfg = local
            block.tp = _Group(group)
    dit.tp, dit.tp_size = _Group(group), tp
    return dit


# -- FSDP over "data" (JAX :46-75) -------------------------------------------


def fsdp_param_spec(shape: tuple[int, ...], n_shards: int) -> int | None:
    """The dim FSDP cuts a tensor of `shape` along, over `n_shards` ranks: the
    largest dim that `n_shards` divides, ties going to the trailing dim; None
    (kept whole) when none divides or `n_shards` is 1. JAX's choice: its spec
    names the axis at this dim."""
    if not shape or n_shards <= 1:
        return None
    for d in sorted(range(len(shape)), key=lambda d: (shape[d], d), reverse=True):
        if shape[d] >= n_shards and shape[d] % n_shards == 0:
            return d
    return None


class _FsdpShards:
    """A module's own shards: {name: (dim, is_param)}, the shard tensors
    while it is not gathered, and how many open forwards gathered it."""

    def __init__(self, group, cut: dict, shards: dict):
        self.group, self.cut, self.shards, self.depth = group, cut, shards, 0


def _set_tensor(mod: nn.Module, name: str, t: torch.Tensor, is_param: bool) -> None:
    if is_param:
        mod._parameters[name] = nn.Parameter(t, requires_grad=False)
    else:
        mod._buffers[name] = t


def _gather(owners):
    def hook(_module, _args):
        for mod in owners:
            st = mod._fsdp_shards
            if st.depth == 0:
                for name, (dim, is_param) in st.cut.items():
                    _set_tensor(mod, name, collectives.all_gather_dim(st.shards[name], dim, st.group),
                                is_param)
            st.depth += 1
    return hook


def _free(owners):
    def hook(_module, _args, _out):
        for mod in owners:
            st = mod._fsdp_shards
            st.depth -= 1
            if st.depth == 0:
                for name, (_dim, is_param) in st.cut.items():
                    _set_tensor(mod, name, st.shards[name], is_param)
    return hook


@torch.no_grad()
def shard_fsdp_params(module: nn.Module, mesh, axis: str = "data") -> nn.Module:
    """Keep this rank's 1/n of every parameter and buffer of the frozen
    `module` (float weights, `QuantLinear.w_q` / `w_scale`, the `NF4Linear`
    buffers, embeddings, norms) along `fsdp_param_spec`'s dim, freeing the
    whole tensor; a tensor that no dim divides stays whole. Each module whose
    subtree holds a shard gathers it for its forward and frees it after (a
    `LoRALinear` view's copies of those modules share the hooks). No-op when
    the axis is absent or of one rank; returns `module`. Every rank of the
    axis must run the same forwards in the same order (the gathers are
    collectives)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return module
    if any(hasattr(m, "_fsdp_shards") for m in module.modules()):
        raise ValueError("shard_fsdp_params: the module is already sharded")
    group, i = mesh.group(axis), mesh.coords[axis]
    for mod in module.modules():
        cut, shards = {}, {}
        for store, is_param in ((mod._parameters, True), (mod._buffers, False)):
            for name, t in list(store.items()):
                dim = None if t is None else fsdp_param_spec(tuple(t.shape), n)
                if dim is None:
                    continue
                per = t.shape[dim] // n
                shards[name] = t.detach().narrow(dim, i * per, per).clone()
                cut[name] = (dim, is_param)
                _set_tensor(mod, name, shards[name], is_param)
        if cut:
            mod._fsdp_shards = _FsdpShards(group, cut, shards)
    for mod in module.modules():
        owners = [o for o in mod.modules() if hasattr(o, "_fsdp_shards")]
        if owners:
            mod.register_forward_pre_hook(_gather(owners))
            mod.register_forward_hook(_free(owners))
    return module


def fsdp_local_bytes(module: nn.Module) -> int:
    """Bytes of the parameters and buffers `module` holds now (shards where
    `shard_fsdp_params` cut)."""
    return sum(t.numel() * t.element_size() for t in (*module.parameters(), *module.buffers()))
