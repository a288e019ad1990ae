"""Image-Verifier (reward model) LoRA training.

Counterpart of `reflectionflow_tpu/rm_train/train.py`: a pairwise A/B
forward through Qwen2.5-VL, a Bradley-Terry-family loss, LoRA on the
language model and optionally on the vision tower, a trainable `rm_head`
and `<|VQ_reward|>` embedding row, and a learning rate per parameter group
(`train/optim.py::multi_transform`).

The trainable dict is {"lora": adapters, "rm_head": (H, out), "special": (H,)}
plus, with vision training, {"vision_lora": adapters}. Adapters are the
port's per-module form (`lora/lora.py::lora_init`: {module name: {lora_A
(r, in), lora_B (out, r)}}), named under the `QwenLM` ("layers.{i}.
self_attn.q_proj", ...) or the `QwenVisionTower` ("blocks.{i}.attn.qkv",
"merger.mlp.0", ...); they are attached as `LoRALinear`s over the frozen
base, whatever that base is (float, or weight-only int8 / NF4 after
`quantize_rm_base`). Checkpoints keep the JAX package's layout (stacked per
block family), so a checkpoint written by either package loads in both
packages' `load_rm_checkpoint` and `QwenRewardVerifier`.

Without vision training the vision embeddings are precomputed per pair by
the collator; with it, the tower runs inside the step on raw patches, one
batched pass for the batch. The LM and the tower recompute each block in
the backward (`remat`), so the dequantized weights of a quantized base are
not saved per block. The optimizer state is saved with `torch.save` (JAX
writes optax leaves to `opt_state.npz`).

`make_rm_train_step(mesh=)` trains over a "data" mesh of ranks, as the JAX
package's FSDP: the frozen LM, and the tower under vision training, keep
1/n of every tensor and gather each on use (`parallel.specs.
shard_fsdp_params`, after `quantize_rm_base`), each rank takes its slice of
the pairwise batch (`pos_*` on dim 1, as JAX's `P(None, "data")`), and the
trainable gradients and the loss are averaged over "data" in one bucket
before the update (`reward_loss` is a plain mean, so equal slices give the
global one); the rewards come back gathered, the global batch's.
"""

from __future__ import annotations

import json
import os

import torch

from ..lora.lora import attach_lora, lora_init, qwen_adapters_to_jax
from ..models.qwen_vl.lm import QwenLM, qwen_lm_apply
from ..models.qwen_vl.reward import pool_hidden
from ..models.qwen_vl.vision import QwenVisionTower, qwen_vision_apply
from ..parallel.collectives import reduce_gradients
from ..parallel.mesh import candidate_sharding, gather_candidates
from ..parallel.specs import shard_fsdp_params
from ..train import optim
from .losses import reward_loss

# the JAX package's RM_LORA_TARGETS (blocks/q|k|v|o|gate|up|down/w) by module name
RM_LORA_TARGETS = ("layers.self_attn.q_proj", "layers.self_attn.k_proj", "layers.self_attn.v_proj",
                   "layers.self_attn.o_proj", "layers.mlp.gate_proj", "layers.mlp.up_proj",
                   "layers.mlp.down_proj")
# RM_VISION_LORA_TARGETS: every linear of the tower's blocks and the patch merger's two
RM_VISION_LORA_TARGETS = ("blocks.attn.qkv", "blocks.attn.proj", "blocks.mlp.gate_proj", "blocks.mlp.up_proj",
                          "blocks.mlp.down_proj", "merger.mlp.0", "merger.mlp.2")


def rm_lora_init(generator: torch.Generator, lm: QwenLM, r: int = 16, alpha: float = 16.0) -> dict:
    """Zero-effect adapters (B = 0) on every decoder-layer linear of `lm`."""
    return lora_init(generator, lm, r=r, alpha=alpha, targets=RM_LORA_TARGETS)


def rm_vision_lora_init(generator: torch.Generator, tower: QwenVisionTower, r: int = 16,
                        alpha: float = 16.0) -> dict:
    """Zero-effect adapters on every block linear of `tower` and its merger."""
    return lora_init(generator, tower, r=r, alpha=alpha, targets=RM_VISION_LORA_TARGETS)


def _attached(module, adapters: dict, alpha: float, r: int):
    return attach_lora(module, {"_alpha": alpha, "_r": r, "adapters": adapters})


def apply_vision_lora_embeds(trainable: dict, tower: QwenVisionTower, embeds: torch.Tensor,
                             patches: torch.Tensor, grid_thw: tuple[int, int, int], alpha: float, r: int,
                             img_token_start: int = 1) -> torch.Tensor:
    """Run the tower with the trainable adapters attached on the raw patches
    (B, Lp, pd), one batched pass on the one grid, and put its embeddings in
    place of the image rows of `embeds` (B, L, H): the static slice
    [img_token_start, img_token_start + n_img), where the collator lays them
    out. The result is a new tensor (not an in-place write), so the gradient
    reaches the tower's adapters."""
    view = _attached(tower, trainable["vision_lora"], alpha, r)
    vis = qwen_vision_apply(view, patches.to(embeds.dtype), grid_thw, remat=True).to(embeds.dtype)
    end = img_token_start + vis.shape[1]
    return torch.cat([embeds[:, :img_token_start], vis, embeds[:, end:]], dim=1)


def rm_forward_rewards(trainable: dict, lm: QwenLM, embeds: torch.Tensor, position_ids: torch.Tensor,
                       attention_mask: torch.Tensor, input_ids: torch.Tensor, pooling: str,
                       special_token_id: int | None, alpha: float, r: int) -> torch.Tensor:
    """(B, L, H) token (+ vision) embeddings -> (B, out_dim) reward logits in
    the activation dtype: the trainable `<|VQ_reward|>` row in place of every
    special token, the LM with its adapters attached (remat), pooling, the
    head."""
    view = _attached(lm, trainable["lora"], alpha, r)
    if special_token_id is not None:
        is_sp = (input_ids == special_token_id)[:, :, None]
        embeds = torch.where(is_sp, trainable["special"].to(embeds.dtype)[None, None, :], embeds)
    hidden, _ = qwen_lm_apply(view, None, embeds, position_ids, attention_mask=attention_mask,
                              return_hidden=True, remat=True)
    pooled = pool_hidden(hidden, attention_mask, pooling, input_ids=input_ids, special_token_id=special_token_id)
    return pooled @ trainable["rm_head"].to(pooled.dtype)


def _quantizable_blocks(module) -> torch.nn.ModuleList:
    if isinstance(module, QwenLM):
        return module.layers
    if isinstance(module, QwenVisionTower):
        return module.blocks
    raise TypeError(f"quantize_rm_base takes a QwenLM or a QwenVisionTower, got {type(module).__name__}")


def quantize_rm_base(module, mode: str, min_size: int = 1 << 18):
    """Quantize the frozen blocks of a `QwenLM` (its `layers`) or a
    `QwenVisionTower` (its `blocks`) in place, weight-only, for LoRA training
    on a quantized base (the reference's bitsandbytes 8-bit / NF4 base):
    "int8" swaps each linear for a w8a16 `QuantLinear`, "nf4" for a
    split-plane `NF4Linear` (`ops.quant.nf4_linear`: plane, else pair, else
    int8 w8a16). The product stays float, so gradients flow through the
    frozen blocks to every adapter and the special row; the W8A8 serving
    layout (`utils.device.quantize_blocks`) rounds the activation and would
    cut them. A linear is swapped when its weight, stacked over the blocks,
    has at least `min_size` elements; embeddings, norms and the merger stay
    as they are. Returns `module`."""
    from ..ops.quant import QuantLinear, nf4_linear

    if mode == "int8":
        def make(lin):
            return QuantLinear.from_linear(lin, act_quant=False)
    elif mode == "nf4":
        def make(lin):
            return nf4_linear(lin, layout="plane")
    else:
        raise ValueError(f"quantize_base must be int8|nf4 (got {mode!r})")
    blocks = _quantizable_blocks(module)
    for block in blocks:
        for name, lin in list(block.named_modules()):
            if isinstance(lin, torch.nn.Linear) and lin.weight.numel() * len(blocks) >= min_size:
                block.set_submodule(name, make(lin))
    return module


def make_rm_train_step(lm: QwenLM, optimizer, loss_type: str = "btt", pooling: str = "special",
                       special_token_id: int | None = None, alpha: float = 16.0, r: int = 16,
                       tower: QwenVisionTower | None = None, grid_thw: tuple[int, int, int] | None = None,
                       img_token_start: int = 1, mesh=None, quantize_base: str | None = None,
                       quantize_min_size: int = 1 << 18):
    """-> step(trainable, opt_state, batch) -> (trainable, opt_state, aux):
    forward A and B, `reward_loss`, the gradient of every trainable tensor,
    the optimizer's update applied in place; aux holds "loss", "rewards_A"
    and "rewards_B" (detached).

    batch: {embeds_A, pos_A, mask_A, ids_A, embeds_B, ..., scores_A (B, N),
    scores_B, chosen_label (B, N)} (`data.collate_rm_batch`); with vision
    training (`tower` and `grid_thw`) also patches_A / patches_B on the one
    grid, and the tower runs inside the step with trainable["vision_lora"].

    `quantize_base` ("int8" | "nf4") quantizes the LM's blocks, and the
    tower's under vision training, in place (`quantize_rm_base`).

    `mesh`: a `RankMesh` of a "data" axis (every rank calls the step on the
    same global batch; see the module docstring). The LM, and the tower
    under vision training, are sharded in place."""
    sharded = mesh is not None and mesh.size > 1
    if sharded and mesh.axis_size("data") != mesh.size:
        raise ValueError(f"the reward trainer shards over \"data\" alone; mesh {mesh.shape}")
    train_vision = tower is not None
    if train_vision and grid_thw is None:
        raise ValueError("vision training needs grid_thw (one grid per batch)")
    if quantize_base is not None:
        quantize_rm_base(lm, quantize_base, quantize_min_size)
        if train_vision:
            quantize_rm_base(tower, quantize_base, quantize_min_size)
    if sharded:
        shard_fsdp_params(lm, mesh)
        if train_vision:
            shard_fsdp_params(tower, mesh)

    def side_rewards(trainable, batch, side):
        embeds = batch[f"embeds_{side}"]
        if train_vision:
            embeds = apply_vision_lora_embeds(trainable, tower, embeds, batch[f"patches_{side}"], grid_thw,
                                              alpha, r, img_token_start)
        return rm_forward_rewards(trainable, lm, embeds, batch[f"pos_{side}"], batch[f"mask_{side}"],
                                  batch[f"ids_{side}"], pooling, special_token_id, alpha, r)

    def local(batch):
        """This rank's rows of the global batch (`pos_*` on dim 1)."""
        out = {}
        for k, v in batch.items():
            dim = 1 if k.startswith("pos_") else 0
            out[k] = v.narrow(dim, candidate_sharding(mesh, v.shape[dim]).start,
                              v.shape[dim] // mesh.axis_size("data"))
        return out

    def step(trainable, opt_state, batch):
        if sharded:
            batch = local(batch)
        flat = optim.flatten_tree(trainable)
        params = list(flat.values())
        for p in params:
            p.requires_grad_(True)
        with torch.enable_grad():
            rw_A = side_rewards(trainable, batch, "A")
            rw_B = side_rewards(trainable, batch, "B")
            loss = reward_loss(rw_A.float(), rw_B.float(), batch["scores_A"], batch["scores_B"],
                               batch["chosen_label"], loss_type)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if sharded:
            grads, (loss,) = reduce_gradients(grads, [False] * len(grads), mesh, [loss.detach()])
            rw_A, rw_B = (gather_candidates(r.detach(), mesh) for r in (rw_A, rw_B))
        grads = dict(zip(flat, grads))
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, flat)
            optim.apply_updates(params, [updates[k] for k in flat])
        return trainable, opt_state, {"loss": loss.detach(), "rewards_A": rw_A.detach(),
                                      "rewards_B": rw_B.detach()}

    return step


def _rm_label(path: str) -> str:
    group = path.split("/", 1)[0]
    if group == "vision_lora":
        return "merger" if path.startswith("vision_lora/merger.") else "vision"
    return {"rm_head": "head", "special": "special"}.get(group, "lora")


def make_rm_optimizer(lr: float = 1e-5, vision_lr: float | None = None, head_lr: float | None = None,
                      special_lr: float | None = None, merger_lr: float | None = None,
                      weight_decay: float = 0.0) -> optim.multi_transform:
    """An AdamW per group: "lora" (the LM adapters), "head", "special", and
    under vision training "vision" (the tower's adapters) and "merger" (the
    merger's, at `merger_lr`, default `vision_lr`); `head_lr`, `special_lr`
    and `vision_lr` default to `lr`. `weight_decay` applies to every group
    but "special", which takes none."""
    head_lr = head_lr if head_lr is not None else lr
    special_lr = special_lr if special_lr is not None else lr
    vision_lr = vision_lr if vision_lr is not None else lr
    merger_lr = merger_lr if merger_lr is not None else vision_lr
    return optim.multi_transform({
        "lora": optim.adamw(lr, weight_decay=weight_decay),
        "head": optim.adamw(head_lr, weight_decay=weight_decay),
        "special": optim.adamw(special_lr, weight_decay=0.0),
        "vision": optim.adamw(vision_lr, weight_decay=weight_decay),
        "merger": optim.adamw(merger_lr, weight_decay=weight_decay),
    }, _rm_label)


def save_rm_checkpoint(path: str, trainable: dict, pooling: str, special_token_id: int | None,
                       vq_mean: float = 0.0, vq_std: float = 1.0, lora_alpha: float = 16.0,
                       lora_r: int = 16) -> None:
    """Write the JAX package's checkpoint: `rm_head.safetensors`
    ("rm_head.weight" (out, H)), `rm_lora.safetensors` (the adapters stacked
    per block family under their JAX tree paths, "blocks__q__w.A" / ".B", the
    tower's with a "vision." prefix, and "special_token_embedding"), all fp32,
    and `model_config.json` with the JAX package's keys."""
    from ..utils.safetensors_io import save_file

    os.makedirs(path, exist_ok=True)
    head = trainable["rm_head"].detach().float().cpu()
    save_file({"rm_head.weight": head.t().contiguous()}, os.path.join(path, "rm_head.safetensors"))
    flat = {}
    for prefix, group, tower in (("", "lora", False), ("vision.", "vision_lora", True)):
        for p, ab in qwen_adapters_to_jax(trainable.get(group, {}), tower=tower).items():
            safe = p.replace("/", "__")
            flat[f"{prefix}{safe}.A"] = ab["A"]
            flat[f"{prefix}{safe}.B"] = ab["B"]
    if "special" in trainable:
        flat["special_token_embedding"] = trainable["special"].detach().float().cpu()
    save_file(flat, os.path.join(path, "rm_lora.safetensors"))
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump({"logits_processing": pooling, "special_token_id": special_token_id, "VQ_mean": vq_mean,
                   "VQ_std": vq_std, "lora_alpha": lora_alpha, "lora_r": lora_r,
                   "output_dim": int(head.shape[1])}, f)


def save_rm_opt_state(path: str, opt_state, trainable: dict) -> None:
    """The optimizer state beside the adapters (`opt_state.pt`, `torch.save`),
    with the trainable paths ("lora/<module>/lora_A", ...) it was made for, so
    training resumes exactly."""
    torch.save({"paths": list(optim.flatten_tree(trainable)), "state": opt_state},
               os.path.join(path, "opt_state.pt"))


def load_rm_opt_state(path: str, opt_state_template, trainable: dict):
    """-> the state saved under `path`, on the trainable's device, or the
    template itself when none was saved. A state saved for other trainable
    paths raises ValueError."""
    fp = os.path.join(path, "opt_state.pt")
    if not os.path.exists(fp):
        return opt_state_template
    flat = optim.flatten_tree(trainable)
    saved = torch.load(fp, map_location=next(iter(flat.values())).device, weights_only=True)
    if saved["paths"] != list(flat):
        raise ValueError(f"{fp}: optimizer state for other trainable tensors (shape mismatch)")
    return saved["state"]


def load_rm_checkpoint(path: str) -> tuple[dict, dict]:
    """A checkpoint directory (`model_config.json`, `rm_head.safetensors`,
    `rm_lora.safetensors`) -> (trainable, model_config): trainable holds
    "rm_head" (hidden, output_dim), "lora" and, when saved, "vision_lora"
    ({tree path: {A, B}}) and "special" (the `<|VQ_reward|>` embedding row),
    as CPU tensors."""
    from ..utils.safetensors_io import load_file

    with open(os.path.join(path, "model_config.json")) as f:
        cfg = json.load(f)
    head = load_file(os.path.join(path, "rm_head.safetensors"))["rm_head.weight"].t()
    lora: dict = {}
    vision_lora: dict = {}
    special: torch.Tensor | None = None
    for k, v in load_file(os.path.join(path, "rm_lora.safetensors")).items():
        if k == "special_token_embedding":
            special = v
            continue
        dest = lora
        if k.startswith("vision."):
            dest, k = vision_lora, k[len("vision."):]
        p, which = k.rsplit(".", 1)
        dest.setdefault(p.replace("__", "/"), {})[which] = v
    trainable = {"lora": lora, "rm_head": head}
    if vision_lora:
        trainable["vision_lora"] = vision_lora
    if special is not None:
        trainable["special"] = special
    return trainable, cfg
