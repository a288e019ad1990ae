"""Colocated Qwen2.5-VL Image-Verifier.

Counterpart of `reflectionflow_tpu/verifiers/qwen_verifier.py`: images +
prompts -> z-normalised 'VQ' scores, on the same card as the generator. A
checkpoint directory holds the training run's `model_config.json` (pooling,
special token, score statistics), `rm_head.safetensors` and, when trained,
`rm_lora.safetensors` (folded into the LM at load, with the trained
`<|VQ_reward|>` embedding row installed).

The score of a same-length, same-grid group is one batched vision-tower pass
and one LM forward + pooling + head (`models.qwen_vl.reward.rm_scores`),
eager under `torch.no_grad`. The image resize is the port's copy of PIL's bicubic
(`train/data.py::resize`, bit for bit). A (T, H, W, 3) clip is
sampled and resized by `models/qwen_vl/video.py::fetch_video` and scored with
video pads and the `video_score` template.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from ..models.qwen_vl.model import QwenVLModel, QwenVLSpecialTokens, get_rope_index
from ..models.qwen_vl.reward import QwenRewardModel, RewardHead, rm_scores
from ..models.qwen_vl.vision import image_to_patches, qwen_vision_apply, smart_resize
from .base import Verifier

DEFAULT_TEMPLATE = (
    "You are presented with a generated image and its associated text caption. "
    "Your task is to analyze the image across multiple dimensions in relation to the caption. "
    "Rate the overall quality of the image.\nCaption: {prompt}"
)


class QwenRewardVerifier(Verifier):
    name = "qwen_rm"

    def __init__(self, model_path: str | None = None, model: QwenVLModel | None = None, tokenizer=None,
                 head: RewardHead | None = None, max_pixels: int = 448 * 448, use_norm: bool = True,
                 quantize: str | None = None, quantize_min_size: int = 1 << 18,
                 device_index: int | None = None, device: str | torch.device | None = None, **_):
        """Either `model_path` (a snapshot, loaded on `device`, default cuda, or
        on `cuda:<device_index>`) or a built `model` (scored where it lies)."""
        from ..utils.device import on_device, pin, placement, quantize_blocks

        if model is None and model_path is None:
            raise ValueError("qwen_rm needs a model_path (verifier_args.model_path) or a QwenVLModel")
        dev = placement(device, device_index) if model is None else model.device
        with on_device(dev.index if dev.type == "cuda" else None):
            if model is None:
                from ..utils.hf_loader import load_qwen_vl

                model, tokenizer = load_qwen_vl(model_path, device=dev)
            if head is None and model_path is not None:
                head = self._load_head(model_path)
            if head is None:
                raise ValueError("QwenRewardVerifier needs a RewardHead (or a model_path holding one)")
            if model_path is not None:
                model = self._apply_rm_adapter(model, model_path, head)
            if quantize == "int8":  # after the LoRA fold, so the deltas are captured
                quantize_blocks(model.model.layers, quantize_min_size)
                quantize_blocks(model.visual.blocks, quantize_min_size)
            head.w = pin(dev, head.w)
        self.rm = QwenRewardModel(model, head)
        self.tokenizer = tokenizer
        self.max_pixels = max_pixels
        self.use_norm = use_norm

    @staticmethod
    def _load_head(model_path: str) -> RewardHead:
        """rm_head + pooling config, as the reward trainer saves them."""
        from ..utils.safetensors_io import load_file

        cfg_path = os.path.join(model_path, "model_config.json")
        cfg = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
        head_path = os.path.join(model_path, "rm_head.safetensors")
        if not os.path.exists(head_path):
            raise FileNotFoundError(
                f"{head_path} missing: an all-zero reward head would rank candidates arbitrarily; point "
                "model_path at a checkpoint written by the reward-model trainer")
        return RewardHead(
            w=load_file(head_path)["rm_head.weight"].t().contiguous(),
            pooling=cfg.get("logits_processing", cfg.get("pooling", "last")),
            special_token_id=cfg.get("special_token_id"),
            vq_mean=cfg.get("VQ_mean", 0.0),
            vq_std=cfg.get("VQ_std", 1.0),
        )

    @staticmethod
    @torch.no_grad()
    def _apply_rm_adapter(model: QwenVLModel, model_path: str, head: RewardHead) -> QwenVLModel:
        """Fold the trained LoRA into the LM and install the trained special
        embedding row (vision adapters are not folded, as in the reference)."""
        if not os.path.exists(os.path.join(model_path, "rm_lora.safetensors")):
            return model
        from ..lora.lora import fold_qwen_lora
        from ..rm_train.train import load_rm_checkpoint

        trainable, cfg = load_rm_checkpoint(model_path)
        if trainable["lora"]:
            fold_qwen_lora(model, {"_alpha": cfg.get("lora_alpha", 16.0), "_r": cfg.get("lora_r", 16),
                                   "adapters": trainable["lora"]})
        if "special" in trainable and head.special_token_id is not None:
            embed = model.model.embed_tokens.weight
            embed[head.special_token_id] = trainable["special"].to(embed.device, embed.dtype)
        return model

    # ------------------------------------------------------------------

    def _prepare_ids(self, image: np.ndarray, prompt: str):
        """smart_resize the image (or sample and resize a (T, H, W, 3) clip) and
        build the chat sequence around its image or video pads: (ids, patches,
        grid), patchified once."""
        from ..train.data import resize

        vis_cfg = self.rm.model.vis_cfg
        merge = vis_cfg.spatial_merge_size
        factor = vis_cfg.patch_size * merge
        tokens = QwenVLSpecialTokens()
        if image.ndim == 4:  # a video clip: video pads and the video_score prompt
            from ..models.qwen_vl.video import fetch_video, video_to_patches
            from ..rm_train.prompt_template import build_prompt

            patches, grid = video_to_patches(fetch_video(image, image_factor=factor, max_pixels=self.max_pixels),
                                             vis_cfg)
            pad_id, text = tokens.video_pad, build_prompt(prompt, template_type="video_score")
        else:
            nh, nw = smart_resize(image.shape[0], image.shape[1], factor=factor, max_pixels=self.max_pixels)
            patches, grid = image_to_patches(resize(image, (nw, nh)), vis_cfg)
            pad_id, text = tokens.image_pad, DEFAULT_TEMPLATE.format(prompt=prompt)
        gt, gh, gw = grid
        n_vis = gt * (gh // merge) * (gw // merge)
        return self._assemble_ids(text, n_vis, pad_id, tokens), patches, grid

    def _assemble_ids(self, text: str, n_vis: int, pad_id: int, tokens) -> np.ndarray:
        # Qwen's chat template with the system turn and the generation prompt,
        # so "last" pooling lands where the reward checkpoint was trained
        if self.tokenizer is not None:
            prefix = self.tokenizer.encode(
                "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user\n",
                add_special_tokens=False)
            body = self.tokenizer.encode(text + "<|im_end|>\n<|im_start|>assistant\n", add_special_tokens=False)
        else:  # no tokenizer files: hashed token ids and the structural markers
            from ..utils.tokenizers import HashTokenizer

            ht = HashTokenizer(vocab_size=self.rm.model.lm_cfg.vocab_size, append_eos=False)
            prefix = [tokens.im_start]
            body = [int(x) for x in ht([text], max_length=64)["input_ids"][0] if x != 0]
            body += [tokens.im_end, tokens.im_start]
        ids = np.asarray(prefix + [tokens.vision_start] + [pad_id] * n_vis + [tokens.vision_end] + body, np.int64)
        if self.rm.head.pooling == "special" and self.rm.head.special_token_id is not None:
            ids = np.concatenate([ids, [self.rm.head.special_token_id]])
        return ids

    @torch.no_grad()
    def raw_scores(self, images: Sequence[np.ndarray], prompts: Sequence[str]) -> list[float]:
        """Group by (sequence length, vision grid); each group is one batched
        tower pass and one batched LM forward."""
        prepared = [self._prepare_ids(np.asarray(img), p) for img, p in zip(images, prompts)]
        groups: dict[tuple, list[int]] = {}
        for i, (ids, _patches, grid) in enumerate(prepared):
            groups.setdefault((len(ids), grid), []).append(i)
        out = [0.0] * len(prepared)
        model = self.rm.model
        dev = model.device
        for (_, grid), idxs in groups.items():
            B = len(idxs)
            patches = torch.from_numpy(np.stack([prepared[i][1] for i in idxs])).to(dev, model.dtype)
            vis = qwen_vision_apply(model.visual, patches, grid)
            id_rows = np.stack([prepared[i][0] for i in idxs])
            ids = torch.from_numpy(id_rows).to(dev)
            embeds = model.model.embed_tokens(ids)
            is_pad = (id_rows[0] == model.tokens.image_pad) | (id_rows[0] == model.tokens.video_pad)
            embeds[:, torch.from_numpy(np.nonzero(is_pad)[0]).to(dev)] = vis.to(embeds.dtype)
            pos0 = get_rope_index(id_rows[0], [grid], model.vis_cfg.spatial_merge_size, model.tokens.image_pad,
                                  video_pad_id=model.tokens.video_pad)
            pos = torch.from_numpy(np.array(np.broadcast_to(pos0[:, None, :], (3, B, pos0.shape[1]))))
            raw = rm_scores(model, self.rm.head, embeds, pos.to(dev), ids).float().cpu().numpy()
            for j, i in enumerate(idxs):
                out[i] = float(raw[j, 0])
        return out

    def reward(self, images, prompts, use_norm: bool | None = None) -> list[dict]:
        """The reference's API: -> [{"VQ": score}]."""
        use_norm = self.use_norm if use_norm is None else use_norm
        return [{"VQ": self.rm.normalized(r) if use_norm else r} for r in self.raw_scores(images, prompts)]

    def score(self, images, prompts, tag=None, max_new_tokens=None):
        """Verifier interface: overall_score = the z-normalised VQ."""
        return [{"overall_score": {"score": r["VQ"], "explanation": "qwen_rm VQ"}, "VQ": r["VQ"]}
                for r in self.reward(images, prompts)]
