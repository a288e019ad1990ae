"""Weight bridge: the JAX package's parameter trees -> this package's state dicts.

The inverse of `reflectionflow_tpu/utils/hf_convert.py`: linear weights go
back from (in, out) to torch's (out, in), per-block stacks are unstacked, and
HWIO convolutions go back to OIHW. Input leaves are numpy arrays (the caller
moves them off JAX); outputs are CPU tensors for `load_state_dict`, whose
keys are the diffusers/transformers names the converters read.

LoRA adapters go both ways (`lora_from_jax`, `lora_to_jax`): the JAX
package stacks them per block family, `{path: {A: (N, in, r), B: (N, r,
out)}}`; the port keeps one per linear in the diffusers-peft layout. The
reward-model trainer's trainable tree (Qwen LM and tower adapters, rm_head,
the special row) goes both ways by `rm_trainable_from_jax` /
`rm_trainable_to_jax`, over `lora.qwen_adapters_from_jax` / `_to_jax`.

Qwen2.5-VL trees (`qwen_lm_init` / `convert_qwen_lm_state`, `qwen_vision_init`
/ `convert_qwen_vision_state`) go to `QwenVLModel`'s transformers names
through `qwen_lm_state_dict` and `qwen_vision_state_dict`; NVILA's
(`siglip_init` / `convert_siglip_state`, `convert_nvila_projector_state`) to
`NvilaModel`'s through `siglip_state_dict`, `nvila_projector_state_dict` and
`nvila_from_jax`.

Quantized trees (`reflectionflow_tpu/ops/quant.py`: int8 nodes {w_q, w_scale,
b, act_q}, NF4 nodes {w_p4 or w_p4p, w_scale4, b}) go by `load_jax_tree_`,
which walks the port model's modules and reads each one's JAX node through
the model's `jax_path`: `serving_dit_from_jax` for the serving DiT (W8A8,
with NF4 MLPs or not), `t5_from_jax` for a float, w8a16 or NF4 T5.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import (CLIPTextConfig, FluxDiTConfig, NvilaConfig, QwenLMConfig, QwenVLVisionConfig,
                      SiglipVisionConfig, T5Config)
from ..models.flux.dit import FluxDiT
from ..models.flux.text import T5Encoder
from ..ops.fuse import fuse_dit_qkv, fuse_single_block_io
from ..ops.quant import NF4Linear, QuantLinear


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a contiguous, writable copy


def _lin(sd: dict, name: str, p: dict, bias: bool = True) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    if bias:
        sd[f"{name}.bias"] = _t(p["b"])


def _block(tree: dict, i: int) -> dict:
    """Slice block i out of a tree of stacked leaves."""
    return {k: _block(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in tree.items()}


def dit_state_dict(params: dict, cfg: FluxDiTConfig) -> dict[str, torch.Tensor]:
    """`flux_dit_init` / `convert_flux_dit_state` tree -> `FluxDiT` state dict."""
    sd: dict[str, torch.Tensor] = {}
    _lin(sd, "x_embedder", params["img_in"])
    _lin(sd, "context_embedder", params["txt_in"])
    embeds = [("timestep_embedder", "time_in"), ("text_embedder", "vector_in")]
    if cfg.guidance_embeds:
        embeds.append(("guidance_embedder", "guidance_in"))
    for ours, theirs in embeds:
        _lin(sd, f"time_text_embed.{ours}.linear_1", params[theirs]["fc1"])
        _lin(sd, f"time_text_embed.{ours}.linear_2", params[theirs]["fc2"])
    _lin(sd, "norm_out.linear", params["final_mod"])
    _lin(sd, "proj_out", params["final_proj"])
    for i in range(cfg.num_double_blocks):
        bp, b = _block(params["double_blocks"], i), f"transformer_blocks.{i}"
        a = bp["attn"]
        _lin(sd, f"{b}.norm1.linear", bp["img_mod"])
        _lin(sd, f"{b}.norm1_context.linear", bp["txt_mod"])
        for ours, theirs in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"),
                             ("add_q_proj", "txt_q"), ("add_k_proj", "txt_k"),
                             ("add_v_proj", "txt_v"), ("to_out.0", "out"),
                             ("to_add_out", "txt_out")):
            _lin(sd, f"{b}.attn.{ours}", a[theirs])
        for ours, theirs in (("norm_q", "q_norm"), ("norm_k", "k_norm"),
                             ("norm_added_q", "txt_q_norm"), ("norm_added_k", "txt_k_norm")):
            sd[f"{b}.attn.{ours}.weight"] = _t(a[theirs]["scale"])
        for ours, theirs in (("ff", "img_mlp"), ("ff_context", "txt_mlp")):
            _lin(sd, f"{b}.{ours}.net.0.proj", bp[theirs]["fc1"])
            _lin(sd, f"{b}.{ours}.net.2", bp[theirs]["fc2"])
    for i in range(cfg.num_single_blocks):
        bp, b = _block(params["single_blocks"], i), f"single_transformer_blocks.{i}"
        a = bp["attn"]
        _lin(sd, f"{b}.norm.linear", bp["mod"])
        for ours, theirs in (("to_q", "q"), ("to_k", "k"), ("to_v", "v")):
            _lin(sd, f"{b}.attn.{ours}", a[theirs])
        sd[f"{b}.attn.norm_q.weight"] = _t(a["q_norm"]["scale"])
        sd[f"{b}.attn.norm_k.weight"] = _t(a["k_norm"]["scale"])
        _lin(sd, f"{b}.proj_mlp", bp["mlp_in"])
        _lin(sd, f"{b}.proj_out", bp["out"])
    return sd


def _node(tree: dict, path: str, index: int | None):
    for part in path.split("/"):
        tree = tree[part]
    if index is None:
        return tree
    return _block(tree, index) if isinstance(tree, dict) else np.asarray(tree)[index]


@torch.no_grad()
def load_jax_tree_(model: nn.Module, params: dict) -> nn.Module:
    """Copy a JAX parameter tree into `model` in place. Each linear takes its
    node's float weight, or becomes a `QuantLinear` for an int8 node (W8A8 when
    the node has the `act_q` marker) or an `NF4Linear` for an NF4 node (its
    packed codes and scales as they are); embeddings and norm scales take their
    leaves."""
    for name, mod in list(model.named_modules()):
        if isinstance(mod, nn.Linear):
            node = _node(params, *model.jax_path(name)[:2])
            packed = next((k for k in ("w_p4", "w_p4p") if k in node), None)
            if packed is not None:
                model.set_submodule(name, NF4Linear(
                    _t(node[packed]), _t(node["w_scale4"]), _t(node["b"]) if "b" in node else None,
                    "pair" if packed == "w_p4" else "plane").to(mod.weight.device))
                continue
            if "w_q" not in node:
                mod.weight.copy_(_t(np.asarray(node["w"]).T))
                if mod.bias is not None:
                    mod.bias.copy_(_t(node["b"]))
                continue
            bias = _t(node["b"]) if "b" in node else None
            model.set_submodule(name, QuantLinear(
                _t(np.asarray(node["w_q"]).T).contiguous(), _t(np.asarray(node["w_scale"]).reshape(-1)),
                bias, act_quant="act_q" in node).to(mod.weight.device))
        elif list(mod.parameters(recurse=False)):  # norm scales, embedding tables
            node = _node(params, *model.jax_path(name)[:2])
            mod.weight.copy_(_t(node["scale"] if isinstance(node, dict) else node))
    return model


def serving_dit_from_jax(params: dict, cfg: FluxDiTConfig) -> FluxDiT:
    """The JAX serving tree, `quantize_dit_params(permute_rope_layout(
    fuse_single_block_io(fuse_dit_qkv(p))))` (with `int4_paths` or not), -> a
    `FluxDiT` in the same fused, split-layout, int8 (and NF4) form."""
    dit = fuse_single_block_io(fuse_dit_qkv(FluxDiT(cfg)))
    dit.rope_layout = "split"  # the tree's q/k are permuted already
    return load_jax_tree_(dit, params).eval()


def t5_from_jax(params: dict, cfg: T5Config) -> T5Encoder:
    """A JAX T5 tree (float, int8 w8a16 from `quantize_dit_params(t5,
    act_quant=False)`, or NF4 from `quantize_params_int4`) -> `T5Encoder`."""
    return load_jax_tree_(T5Encoder(cfg), params).eval()


def t5_state_dict(params: dict, cfg: T5Config) -> dict[str, torch.Tensor]:
    """`t5_encoder_init` / `convert_t5_state` tree -> `T5Encoder` state dict."""
    sd = {
        "shared.weight": _t(params["embed"]),
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": _t(params["rel_bias"]),
        "encoder.final_layer_norm.weight": _t(params["final_ln"]["scale"]),
    }
    for i in range(cfg.num_layers):
        bp, b = _block(params["blocks"], i), f"encoder.block.{i}"
        sd[f"{b}.layer.0.layer_norm.weight"] = _t(bp["ln1"]["scale"])
        for n in ("q", "k", "v", "o"):
            _lin(sd, f"{b}.layer.0.SelfAttention.{n}", bp[n], bias=False)
        sd[f"{b}.layer.1.layer_norm.weight"] = _t(bp["ln2"]["scale"])
        for ours, theirs in (("wi_0", "wi0"), ("wi_1", "wi1"), ("wo", "wo")):
            _lin(sd, f"{b}.layer.1.DenseReluDense.{ours}", bp[theirs], bias=False)
    return sd


def clip_state_dict(params: dict, cfg: CLIPTextConfig) -> dict[str, torch.Tensor]:
    """`clip_text_init` / `convert_clip_text_state` tree -> `CLIPTextEncoder` state dict."""
    pre = "text_model."
    sd = {
        f"{pre}embeddings.token_embedding.weight": _t(params["tok_embed"]),
        f"{pre}embeddings.position_embedding.weight": _t(params["pos_embed"]),
        f"{pre}final_layer_norm.weight": _t(params["final_ln"]["scale"]),
        f"{pre}final_layer_norm.bias": _t(params["final_ln"]["bias"]),
    }
    for i in range(cfg.num_layers):
        bp, b = _block(params["blocks"], i), f"{pre}encoder.layers.{i}"
        for ours, theirs in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
            sd[f"{b}.{ours}.weight"] = _t(bp[theirs]["scale"])
            sd[f"{b}.{ours}.bias"] = _t(bp[theirs]["bias"])
        for ours, theirs in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o")):
            _lin(sd, f"{b}.self_attn.{ours}", bp[theirs])
        _lin(sd, f"{b}.mlp.fc1", bp["fc1"])
        _lin(sd, f"{b}.mlp.fc2", bp["fc2"])
    return sd


def qwen_lm_state_dict(params: dict, cfg: QwenLMConfig) -> dict[str, torch.Tensor]:
    """`qwen_lm_init` / `convert_qwen_lm_state` tree -> the `model.*` and
    `lm_head` entries of a `QwenVLModel` state dict."""
    sd = {"model.embed_tokens.weight": _t(params["embed"]),
          "model.norm.weight": _t(params["final_ln"]["scale"])}
    for i in range(cfg.num_layers):
        bp, b = _block(params["blocks"], i), f"model.layers.{i}"
        sd[f"{b}.input_layernorm.weight"] = _t(bp["ln1"]["scale"])
        sd[f"{b}.post_attention_layernorm.weight"] = _t(bp["ln2"]["scale"])
        for n in ("q", "k", "v"):
            _lin(sd, f"{b}.self_attn.{n}_proj", bp[n])
        _lin(sd, f"{b}.self_attn.o_proj", bp["o"], bias=False)
        for n in ("gate", "up", "down"):
            _lin(sd, f"{b}.mlp.{n}_proj", bp[n], bias=False)
    if "lm_head" in params:
        _lin(sd, "lm_head", params["lm_head"], bias=False)
    return sd


def qwen_vision_state_dict(params: dict, cfg: QwenVLVisionConfig) -> dict[str, torch.Tensor]:
    """`qwen_vision_init` / `convert_qwen_vision_state` tree -> the `visual.*`
    entries of a `QwenVLModel` state dict (the patch embedding back to its
    Conv3d (C, 3, tp, ps, ps))."""
    w = np.asarray(params["patch_embed"]["w"])
    sd = {"visual.patch_embed.proj.weight": _t(w.T.reshape(
              w.shape[1], 3, cfg.temporal_patch_size, cfg.patch_size, cfg.patch_size)),
          "visual.merger.ln_q.weight": _t(params["merger"]["ln_q"]["scale"])}
    _lin(sd, "visual.merger.mlp.0", params["merger"]["fc1"])
    _lin(sd, "visual.merger.mlp.2", params["merger"]["fc2"])
    for i in range(cfg.depth):
        bp, b = _block(params["blocks"], i), f"visual.blocks.{i}"
        sd[f"{b}.norm1.weight"] = _t(bp["ln1"]["scale"])
        sd[f"{b}.norm2.weight"] = _t(bp["ln2"]["scale"])
        _lin(sd, f"{b}.attn.qkv", bp["qkv"])
        _lin(sd, f"{b}.attn.proj", bp["proj"])
        for n in ("gate", "up", "down"):
            _lin(sd, f"{b}.mlp.{n}_proj", bp[n])
    return sd


def _ln(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def siglip_state_dict(params: dict, cfg: SiglipVisionConfig) -> dict[str, torch.Tensor]:
    """`siglip_init` / `convert_siglip_state` tree -> `SiglipVisionModel` state
    dict (the patch matmul back to its Conv2d (H, 3, P, P))."""
    w, P = np.asarray(params["patch_embed"]["w"]), cfg.patch_size
    pre = "vision_model."
    sd = {f"{pre}embeddings.patch_embedding.weight": _t(w.T.reshape(w.shape[1], 3, P, P)),
          f"{pre}embeddings.patch_embedding.bias": _t(params["patch_embed"]["b"]),
          f"{pre}embeddings.position_embedding.weight": _t(params["pos_embed"])}
    _ln(sd, f"{pre}post_layernorm", params["post_ln"])
    for i in range(cfg.num_layers):
        bp, b = _block(params["blocks"], i), f"{pre}encoder.layers.{i}"
        _ln(sd, f"{b}.layer_norm1", bp["ln1"])
        _ln(sd, f"{b}.layer_norm2", bp["ln2"])
        for ours, theirs in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o")):
            _lin(sd, f"{b}.self_attn.{ours}", bp[theirs])
        _lin(sd, f"{b}.mlp.fc1", bp["fc1"])
        _lin(sd, f"{b}.mlp.fc2", bp["fc2"])
    return sd


def nvila_projector_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """`convert_nvila_projector_state` tree -> `NvilaProjector` state dict:
    `layers.{1,2,4}` with the LayerNorm, `layers.{0,2}` without."""
    sd: dict[str, torch.Tensor] = {}
    if "ln" in params:
        _ln(sd, "layers.1", params["ln"])
        _lin(sd, "layers.2", params["fc1"])
        _lin(sd, "layers.4", params["fc2"])
    else:
        _lin(sd, "layers.0", params["fc1"])
        _lin(sd, "layers.2", params["fc2"])
    return sd


def nvila_from_jax(jm) -> "NvilaModel":
    """A JAX `NvilaModel` (float trees) -> the port's, on the CPU in fp32, with
    its configs, template and tokenizer."""
    import dataclasses

    from ..models.nvila.model import NvilaModel

    vis_cfg = SiglipVisionConfig(**dataclasses.asdict(jm.vis_cfg))
    lm_cfg = QwenLMConfig(**dataclasses.asdict(jm.lm_cfg))
    cfg = NvilaConfig(**dataclasses.asdict(jm.cfg))
    model = NvilaModel(vis_cfg, lm_cfg, cfg, norm="ln" in jm.proj_params, tokenizer=jm.tokenizer,
                       template=jm.template)
    model.vision_tower.load_state_dict(siglip_state_dict(jm.vis_params, vis_cfg))
    model.mm_projector.load_state_dict(nvila_projector_state_dict(jm.proj_params))
    model.llm.load_state_dict(qwen_lm_state_dict(jm.lm_params, lm_cfg))
    return model.eval().requires_grad_(False)


def _conv(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
    sd[f"{name}.bias"] = _t(p["b"])


def _resnet(sd: dict, name: str, p: dict) -> None:
    _ln(sd, f"{name}.norm1", p["norm1"])
    _conv(sd, f"{name}.conv1", p["conv1"])
    _ln(sd, f"{name}.norm2", p["norm2"])
    _conv(sd, f"{name}.conv2", p["conv2"])
    if "shortcut" in p:
        _conv(sd, f"{name}.conv_shortcut", p["shortcut"])


def _mid(sd: dict, name: str, mid: dict) -> None:
    _resnet(sd, f"{name}.resnets.0", mid["res1"])
    _resnet(sd, f"{name}.resnets.1", mid["res2"])
    at, a = mid["attn"], f"{name}.attentions.0"
    _ln(sd, f"{a}.group_norm", at["norm"])
    for ours, theirs in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"), ("to_out.0", "out")):
        # 1x1 conv (1, 1, C_in, C_out) -> Linear (C_out, C_in)
        sd[f"{a}.{ours}.weight"] = _t(np.asarray(at[theirs]["w"])[0, 0].T)
        sd[f"{a}.{ours}.bias"] = _t(at[theirs]["b"])


def vae_state_dict(vae: dict) -> dict[str, torch.Tensor]:
    """`vae_init` / `convert_flux_vae_state` tree ({encoder, decoder}) ->
    `FluxVAE` state dict."""
    sd: dict[str, torch.Tensor] = {}
    enc, e = vae["encoder"], "encoder"
    _conv(sd, f"{e}.conv_in", enc["conv_in"])
    for i, block in enumerate(enc["down"]):
        for j, rp in enumerate(block["resnets"]):
            _resnet(sd, f"{e}.down_blocks.{i}.resnets.{j}", rp)
        if "down" in block:
            _conv(sd, f"{e}.down_blocks.{i}.downsamplers.0.conv", block["down"])
    _mid(sd, f"{e}.mid_block", enc["mid"])
    _ln(sd, f"{e}.conv_norm_out", enc["norm_out"])
    _conv(sd, f"{e}.conv_out", enc["conv_out"])
    decoder, d = vae["decoder"], "decoder"
    _conv(sd, f"{d}.conv_in", decoder["conv_in"])
    _mid(sd, f"{d}.mid_block", decoder["mid"])
    for i, block in enumerate(decoder["up"]):
        for j, rp in enumerate(block["resnets"]):
            _resnet(sd, f"{d}.up_blocks.{i}.resnets.{j}", rp)
        if "up" in block:
            _conv(sd, f"{d}.up_blocks.{i}.upsamplers.0.conv", block["up"])
    _ln(sd, f"{d}.conv_norm_out", decoder["norm_out"])
    _conv(sd, f"{d}.conv_out", decoder["conv_out"])
    return sd


def _lora_names(dit: FluxDiT) -> dict[tuple[str, int | None], str]:
    """(JAX weight path, block index) -> port module name, for every linear."""
    out = {}
    for name, m in dit.named_modules():
        if isinstance(m, nn.Linear):
            path, index, _ = dit.jax_path(name)
            out[(f"{path}/w", index)] = name
    return out


def lora_from_jax(lora: dict, dit: FluxDiT) -> dict:
    """A JAX adapter tree ({_alpha, _r, adapters: {path: {A (N, in, r), B (N, r,
    out)}}}) -> the port's per-module dict ({name: {lora_A (r, in), lora_B
    (out, r)}}, fp32 parameters on `dit`'s device)."""
    names = _lora_names(dit)
    device = next(dit.parameters()).device
    adapters = {}
    for path, ab in lora["adapters"].items():
        A, B = np.asarray(ab["A"], np.float32), np.asarray(ab["B"], np.float32)
        stacked = A.ndim == 3
        for i in range(A.shape[0] if stacked else 1):
            a, b = (A[i], B[i]) if stacked else (A, B)
            adapters[names[(path, i if stacked else None)]] = {
                "lora_A": nn.Parameter(_t(a.T).to(device)),
                "lora_B": nn.Parameter(_t(b.T).to(device)),
            }
    return {"_alpha": float(lora["_alpha"]), "_r": int(lora["_r"]), "adapters": adapters}


def lora_to_jax(lora: dict, dit: FluxDiT) -> dict:
    """Inverse of `lora_from_jax`: numpy leaves, blocks stacked per path."""
    paths = {name: key for key, name in _lora_names(dit).items()}
    cfg = dit.cfg
    adapters: dict[str, dict] = {}
    for name, ab in lora["adapters"].items():
        path, index = paths[name]
        A = ab["lora_A"].detach().float().cpu().numpy().T
        B = ab["lora_B"].detach().float().cpu().numpy().T
        if index is None:
            adapters[path] = {"A": A, "B": B}
            continue
        n = cfg.num_double_blocks if path.startswith("double_blocks") else cfg.num_single_blocks
        node = adapters.setdefault(path, {"A": np.zeros((n, *A.shape), np.float32),
                                          "B": np.zeros((n, *B.shape), np.float32)})
        node["A"][index], node["B"][index] = A, B
    return {"_alpha": lora["_alpha"], "_r": lora["_r"], "adapters": adapters}


def rm_trainable_from_jax(trainable: dict, model: nn.Module | None = None) -> dict:
    """A JAX reward-model trainable tree ({"lora": {"blocks/q/w": {A (N, in, r),
    B (N, r, out)}}, "rm_head": (H, out), "special": (H,), "vision_lora": ...};
    numpy leaves) -> the port's (`rm_train/train.py`): adapters per module
    under the `QwenLM` / `QwenVisionTower` names, fp32 on `model`'s device
    (CPU without one)."""
    from ..lora.lora import qwen_adapters_from_jax

    device = next(model.parameters()).device if model is not None else torch.device("cpu")
    out = {}
    for key, value in trainable.items():
        if key in ("lora", "vision_lora"):
            out[key] = qwen_adapters_from_jax(value, tower=key == "vision_lora", device=device)
        else:
            out[key] = _t(np.asarray(value, np.float32)).to(device)
    return out


def rm_trainable_to_jax(trainable: dict) -> dict:
    """Inverse of `rm_trainable_from_jax`: a tree of fp32 numpy arrays."""
    from ..lora.lora import qwen_adapters_to_jax

    out = {}
    for key, value in trainable.items():
        if key in ("lora", "vision_lora"):
            out[key] = {p: {k: v.numpy() for k, v in ab.items()}
                        for p, ab in qwen_adapters_to_jax(value, tower=key == "vision_lora").items()}
        else:
            out[key] = value.detach().float().cpu().numpy()
    return out
