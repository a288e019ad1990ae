"""LoRA for the FLUX DiT and the Qwen2.5-VL reward model: adapters, the
low-rank view the cond stream (and the reward trainer) reads, and folding.

Counterpart of `reflectionflow_tpu/lora/lora.py`. The JAX package stacks an
adapter per block family (`{path: {A: (N, in, r), B: (N, r, out)}}`); this
port keeps one per linear, under the diffusers module name and in the
diffusers-peft layout:

    lora = {"_alpha": alpha, "_r": r,
            "adapters": {"transformer_blocks.0.attn.to_q": {"lora_A": (r, in), "lora_B": (out, r)}, ...}}

so that a linear's output gains `scale * alpha / r * x @ A^T @ B^T`.

Two ways to apply an adapter, as in the JAX package:
  * `attach_lora(dit, lora)` -> a view of the DiT that shares every module and
    parameter of `dit` but wraps each adapted linear in `LoRALinear`, which
    adds the low-rank product to the frozen base output. This is the training
    form: W + AB is never materialised, and gradients reach the fp32 adapters
    through the adds;
  * `fold_lora(dit, lora)` -> a copy with W' = W + scale * alpha / r * B A.

`make_dit_param_views` gives the (main, cond) pair `FluxDiT.forward` reads:
the corrector adapter acts on the condition stream only, unless
`latent_lora=True`.

`save_lora_adapter` / `load_lora_adapter` read and write the JAX package's
one-file interchange (an adapter tree keyed by JAX tree paths, stacked per
block family), and `fold_qwen_lora` folds such an adapter into the Qwen2.5-VL
LM's linears: how a finetuned Reflection-Generator or reward-model adapter
reaches the port.

The default target set is the corrector's: x_embedder; in double blocks
the image-side norm1.linear, attn to_q/to_k/to_v/to_out.0 and ff.net.2; in
single blocks norm.linear, attn to_q/to_k/to_v, proj_mlp and proj_out.
Text-side projections are never adapted.

On a DiT cut for tensor parallelism (`parallel.specs.shard_dit_params`) the
adapters stay whole and replicated, as JAX keeps them (`P()`): `lora_init`
draws the whole model's tensors in the same order, so a seed gives every
rank, and every mesh, the same adapters, and `LoRALinear` uses this rank's
part: the rows of `lora_B` of a column-cut linear, the columns of `lora_A`
of a row-cut one, whose rank-r product joins the partial sum before the
group's all-reduce. Each rank's adapter gradients are then its share of the
whole gradient, summed over "model" by the training step. A target names a module with its
block index left out ("transformer_blocks.attn.to_q", "layers.mlp.up_proj"
of a Qwen LM, "blocks.attn.qkv" of its vision tower), so the reward-model
trainer's Qwen target sets go through the same `lora_init`. Its adapters
cross to the JAX package's stacked tree paths through `qwen_adapters_to_jax`
/ `qwen_adapters_from_jax` (checkpoints keep the JAX layout).
"""

from __future__ import annotations

import copy
import re

import numpy as np
import torch
from torch import nn

from ..ops.quant import NF4Linear, QuantLinear
from ..parallel.specs import COL, RowParallelLinear

_DOUBLE = ("norm1.linear", "attn.to_q", "attn.to_k", "attn.to_v", "attn.to_out.0", "ff.net.2")
_SINGLE = ("norm.linear", "attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp", "proj_out")
_LINEARS = (nn.Linear, QuantLinear, NF4Linear, RowParallelLinear)  # what an adapter may sit on
_BLOCK = re.compile(r"(transformer_blocks|single_transformer_blocks|layers|blocks)\.\d+\.(.+)")


def corrector_target_paths() -> tuple[str, ...]:
    """Adapted module names, with the block index left out."""
    return ("x_embedder", *(f"transformer_blocks.{m}" for m in _DOUBLE),
            *(f"single_transformer_blocks.{m}" for m in _SINGLE))


def _is_target(name: str, targets: tuple[str, ...]) -> bool:
    m = _BLOCK.fullmatch(name)
    return (f"{m[1]}.{m[2]}" if m else name) in targets


class LoRALinear(nn.Module):
    """A frozen base linear (`nn.Linear`, or a weight-only `QuantLinear` /
    `NF4Linear`) plus the low-rank add `x @ A^T @ (scaling B)^T`, computed in
    x's dtype (the JAX package's `linear` with `lora_A`/`lora_B`)."""

    def __init__(self, base: nn.Module, lora_A: torch.Tensor, lora_B: torch.Tensor, scaling: float):
        super().__init__()
        self.base, self.lora_A, self.lora_B, self.scaling = base, lora_A, lora_B, scaling

    def forward(self, x):
        B = (self.lora_B * self.scaling).to(x.dtype)
        A = self.lora_A.to(x.dtype)
        cut = getattr(self.base, "tp_cut", None)
        if cut is None:
            return self.base(x) + (x @ A.t()) @ B.t()
        kind, index = cut
        if kind == COL:  # this rank's output rows
            return self.base(x) + (x @ A.t()) @ B[index].t()
        return self.base(x, extra=(x @ A[:, index].t()) @ B.t())  # its input columns, before the sum


def _whole_shape(m: nn.Module) -> tuple[int, int]:
    """(out, in) of a linear as the whole model has it (a tensor-parallel cut
    records its whole size in `tp_numel`)."""
    cut = getattr(m, "tp_cut", None)
    if cut is None:
        return m.out_features, m.in_features
    if cut[0] == COL:
        return m.tp_numel // m.in_features, m.in_features
    return m.out_features, m.tp_numel // m.out_features


def _shard_delta(m: nn.Module, delta: torch.Tensor) -> torch.Tensor:
    """The part of a whole-shape (out, in) weight delta that a cut linear holds."""
    cut = getattr(m, "tp_cut", None)
    if cut is None:
        return delta
    kind, index = cut
    return delta[index] if kind == COL else delta[:, index]


def lora_init(generator: torch.Generator, dit: nn.Module, r: int = 32, alpha: float = 32.0,
              init: str = "gaussian", targets: tuple[str, ...] | None = None) -> dict:
    """A zero-effect adapter (B = 0) for every target linear of `dit`:
    A ~ N(0, (1/r)^2) for init="gaussian" (else 0), fp32 trainable
    parameters on `dit`'s device, drawn from `generator` in module order,
    at the whole model's shapes on a tensor-parallel cut too."""
    targets = targets or corrector_target_paths()
    adapters = {}
    for name, m in dit.named_modules():
        if not (isinstance(m, (nn.Linear, RowParallelLinear)) and _is_target(name, targets)):
            continue
        out_f, in_f = _whole_shape(m)
        A = torch.randn((r, in_f), generator=generator, device=generator.device)
        A = A * (1.0 / r if init == "gaussian" else 0.0)
        adapters[name] = {
            "lora_A": nn.Parameter(A.to(m.weight.device)),
            "lora_B": nn.Parameter(torch.zeros((out_f, r), device=m.weight.device)),
        }
    if not adapters:
        raise ValueError("lora_init: no target linear in the model (fused serving layout?)")
    return {"_alpha": float(alpha), "_r": int(r), "adapters": adapters}


def lora_parameters(lora: dict) -> list[torch.Tensor]:
    """The adapter tensors in a fixed order (A then B of each module)."""
    return [ab[k] for ab in lora["adapters"].values() for k in ("lora_A", "lora_B")]


def lora_param_count(lora: dict) -> int:
    return sum(int(np.prod(x.shape)) for x in lora_parameters(lora))


def _with_modules(root: nn.Module, replacements: dict[str, nn.Module]) -> nn.Module:
    """A copy of `root` that shares every module, parameter and buffer with
    it, except that the modules named in `replacements` are swapped (only the
    modules on the paths to them are copied, shallowly)."""
    new_root = copy.copy(root)
    new_root._modules = dict(root._modules)
    copied = {id(new_root)}
    for name, rep in replacements.items():
        *path, leaf = name.split(".")
        parent = new_root
        for part in path:
            child = parent._modules[part]
            if id(child) not in copied:
                child = copy.copy(child)
                child._modules = dict(child._modules)
                copied.add(id(child))
                parent._modules[part] = child
            parent = child
        if not isinstance(parent._modules.get(leaf), _LINEARS):
            raise KeyError(f"{name} is not a linear of the model")
        parent._modules[leaf] = rep
    return new_root


def attach_lora(dit: nn.Module, lora: dict, scale: float = 1.0) -> nn.Module:
    """A view of `dit` whose adapted linears add the low-rank product; the base
    weights are shared and left untouched."""
    scaling = scale * lora["_alpha"] / lora["_r"]
    modules = dict(dit.named_modules())
    return _with_modules(dit, {
        name: LoRALinear(modules[name], ab["lora_A"], ab["lora_B"], scaling)
        for name, ab in lora["adapters"].items()})


@torch.no_grad()
def fold_lora(dit: nn.Module, lora: dict, scale: float = 1.0) -> nn.Module:
    """A copy of `dit` with W' = W + scale * alpha / r * B A for every adapter
    (the delta in fp32, added in the weight's dtype)."""
    scaling = scale * lora["_alpha"] / lora["_r"]
    out = copy.deepcopy(dit)
    modules = dict(out.named_modules())
    for name, ab in lora["adapters"].items():
        w = modules[name].weight
        delta = _shard_delta(modules[name], scaling * (ab["lora_B"].float() @ ab["lora_A"].float()))
        w.add_(delta.to(w.device, w.dtype))
    return out


def make_dit_param_views(dit: nn.Module, lora: dict | None, latent_lora: bool = False,
                         scale: float = 1.0):
    """-> (main, cond) models for `FluxDiT.forward(..., cond_params=cond)`: the
    cond stream reads the folded model; the main stream reads the base one, or
    the folded one when `latent_lora`."""
    if lora is None:
        return dit, None
    folded = fold_lora(dit, lora, scale)
    return (folded, folded) if latent_lora else (dit, folded)


def convert_diffusers_lora(sd: dict, alpha: float | None = None) -> dict:
    """A diffusers-peft FLUX LoRA state dict (`transformer.<module>.lora_A.weight`
    (r, in), `.lora_B.weight` (out, r); tensors of any float dtype or numpy
    arrays) -> this module's adapter dict (fp32 tensors). `alpha` defaults to
    r, as peft's default."""
    adapters: dict[str, dict] = {}
    r = None
    for key, val in sd.items():
        key = key.removeprefix("transformer.")
        for which in ("lora_A", "lora_B"):
            if f".{which}." in key:
                module = key.split(f".{which}.")[0]
                t = (val.float() if isinstance(val, torch.Tensor)
                     else torch.from_numpy(np.asarray(val, np.float32)))
                adapters.setdefault(module, {})[which] = t
                if which == "lora_A":
                    r = t.shape[0]
    if r is None:
        raise ValueError("no lora_A weights in the state dict")
    return {"_alpha": float(alpha if alpha is not None else r), "_r": int(r), "adapters": adapters}


# JAX tree path of a Qwen LM block linear -> its module under `model.layers.{i}`
_QWEN_LM_LINEARS = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                    "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
                    "down": "mlp.down_proj"}
# the same for the vision tower's blocks (`visual.blocks.{i}`) and its patch merger
_QWEN_VISION_LINEARS = {"qkv": "attn.qkv", "proj": "attn.proj", "gate": "mlp.gate_proj",
                        "up": "mlp.up_proj", "down": "mlp.down_proj"}
_QWEN_MERGER_LINEARS = {"merger/fc1/w": "merger.mlp.0", "merger/fc2/w": "merger.mlp.2"}


def _qwen_layout(tower: bool):
    """(block list name, block linears, unstacked linears) of the Qwen LM or tower."""
    return ("blocks", _QWEN_VISION_LINEARS, _QWEN_MERGER_LINEARS) if tower else ("layers", _QWEN_LM_LINEARS, {})


def qwen_adapters_to_jax(adapters: dict, tower: bool = False) -> dict:
    """Per-module Qwen adapters of `lora_init` over a `QwenLM` (names
    "layers.{i}.self_attn.q_proj", ...) or, with `tower`, a `QwenVisionTower`
    ("blocks.{i}.attn.qkv", "merger.mlp.0", ...) -> the JAX package's tree:
    {"blocks/q/w": {A (N, in, r), B (N, r, out)}, "merger/fc1/w": {A (in, r),
    B (r, out)}, ...}, fp32 CPU tensors (stacked in block order)."""
    blocks, linears, single = _qwen_layout(tower)
    out: dict = {}
    for path, name in single.items():
        if name in adapters:
            ab = adapters[name]
            out[path] = {"A": ab["lora_A"].detach().float().cpu().t(), "B": ab["lora_B"].detach().float().cpu().t()}
    for short, sub in linears.items():
        found = {int(n.split(".")[1]): ab for n, ab in adapters.items()
                 if n.startswith(f"{blocks}.") and n.split(".", 2)[2] == sub}
        if found:
            if sorted(found) != list(range(len(found))):
                raise KeyError(f"adapters of {blocks}.*.{sub} cover blocks {sorted(found)}, not 0..{len(found) - 1}")
            out[f"blocks/{short}/w"] = {
                "A": torch.stack([found[i]["lora_A"].detach().float().cpu().t() for i in range(len(found))]),
                "B": torch.stack([found[i]["lora_B"].detach().float().cpu().t() for i in range(len(found))])}
    if sum(ab["A"].shape[0] if ab["A"].dim() == 3 else 1 for ab in out.values()) != len(adapters):
        raise KeyError(f"adapters {sorted(set(adapters))} name modules outside the Qwen target layout")
    return out


def qwen_adapters_from_jax(tree: dict, tower: bool = False, device=None) -> dict:
    """Inverse of `qwen_adapters_to_jax`: {JAX path: {A, B}} (tensors or
    arrays) -> {module name: {lora_A (r, in), lora_B (out, r)}} as fp32
    parameters on `device`."""
    blocks, linears, single = _qwen_layout(tower)
    out = {}
    for path, ab in tree.items():
        A, B = torch.as_tensor(np.array(ab["A"], np.float32)), torch.as_tensor(np.array(ab["B"], np.float32))
        parts = path.split("/")
        if path in single:
            pairs = [(single[path], A, B)]
        elif len(parts) == 3 and parts[0] == "blocks" and parts[1] in linears and parts[2] == "w":
            pairs = [(f"{blocks}.{i}.{linears[parts[1]]}", A[i], B[i]) for i in range(A.shape[0])]
        else:
            raise KeyError(f"adapter path {path!r} names no Qwen {'vision' if tower else 'LM'} linear")
        for name, a, b in pairs:
            out[name] = {"lora_A": nn.Parameter(a.t().contiguous().to(device)),
                         "lora_B": nn.Parameter(b.t().contiguous().to(device))}
    return out


def save_lora_adapter(path: str, lora: dict) -> None:
    """A JAX-format adapter ({_alpha, _r, adapters: {tree path: {A, B}}}) as one
    safetensors file: keys `{path with "/" as "__"}.A` / `.B` in fp32, and 0-d
    `_alpha` / `_r`; the file `reflectionflow_tpu.lora.lora.load_lora_adapter`
    reads."""
    from ..utils.safetensors_io import save_file

    flat = {"_alpha": torch.tensor(float(lora["_alpha"])), "_r": torch.tensor(float(lora["_r"]))}
    for p, ab in lora["adapters"].items():
        safe = p.replace("/", "__")
        for which in ("A", "B"):
            flat[f"{safe}.{which}"] = torch.as_tensor(np.array(ab[which], np.float32))
    save_file(flat, path)


def load_lora_adapter(path: str) -> dict:
    """Inverse of `save_lora_adapter` (fp32 tensors)."""
    from ..utils.safetensors_io import load_file

    flat = load_file(path)
    adapters: dict = {}
    for k, v in flat.items():
        if k in ("_alpha", "_r"):
            continue
        p, which = k.rsplit(".", 1)
        adapters.setdefault(p.replace("__", "/"), {})[which] = v.float()
    return {"_alpha": float(flat["_alpha"]), "_r": float(flat["_r"]), "adapters": adapters}


@torch.no_grad()
def fold_qwen_lora(model: nn.Module, lora: dict, scale: float = 1.0) -> nn.Module:
    """Fold a JAX-format adapter over the LM's tree paths (`blocks/<q|k|v|o|
    gate|up|down>/w` stacked (N, in, r) / (N, r, out), or `lm_head/w`) into a
    `QwenVLModel` in place: W' = W + scale * alpha / r * (A B)^T, the delta in
    fp32 and added in the weight's dtype."""
    scaling = scale * lora["_alpha"] / lora["_r"]
    layers = model.model.layers
    for path, ab in lora["adapters"].items():
        A, B = torch.as_tensor(ab["A"]).float(), torch.as_tensor(ab["B"]).float()
        parts = path.split("/")
        if len(parts) == 3 and parts[0] == "blocks" and parts[1] in _QWEN_LM_LINEARS and parts[2] == "w":
            targets = [(layers[i].get_submodule(_QWEN_LM_LINEARS[parts[1]]), A[i], B[i]) for i in range(len(layers))]
        elif path == "lm_head/w" and model.lm_head is not None:
            targets = [(model.lm_head, A, B)]
        else:
            raise KeyError(f"adapter path {path!r} names no Qwen LM linear")
        for lin, a, b in targets:
            w = lin.weight
            w.copy_(w + ((a @ b) * scaling).t().to(w.device, w.dtype))
    return model
