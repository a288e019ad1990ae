"""Reward-model checkpoints.

Only `load_rm_checkpoint` of `reflectionflow_tpu/rm_train/train.py` is
ported: `QwenRewardVerifier` reads a trained reward model through it. The
trainer itself (losses, data, optimizer groups, `save_rm_checkpoint`) is
ROADMAP item 22.
"""

from __future__ import annotations

import json
import os

import torch


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
