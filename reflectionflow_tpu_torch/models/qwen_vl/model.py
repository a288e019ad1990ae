"""Qwen2.5-VL: vision embeddings scattered into the token stream, with 3-D
M-RoPE position ids.

Counterpart of `reflectionflow_tpu/models/qwen_vl/model.py`. `QwenVLModel`
is one `nn.Module` whose state dict is a Qwen2.5-VL checkpoint's (after
`utils/hf_loader.py` normalises transformers' two key layouts): `model.*`
(the LM), `visual.*` (the tower) and `lm_head` (absent when the embeddings
are tied). A 4-D (T, H, W, 3) input is a video clip, patched by
`video.py::video_to_patches`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ...config import QwenLMConfig, QwenVLVisionConfig
from .lm import QwenLM, qwen_lm_apply
from .vision import QwenVisionTower, image_to_patches, qwen_vision_apply


@dataclass(frozen=True)
class QwenVLSpecialTokens:
    image_pad: int = 151655
    video_pad: int = 151656
    vision_start: int = 151652
    vision_end: int = 151653
    im_start: int = 151644
    im_end: int = 151645
    endoftext: int = 151643


def get_rope_index(input_ids: np.ndarray, image_grids: list[tuple[int, int, int]], spatial_merge_size: int,
                   image_pad_id: int, video_pad_id: int | None = None, tokens_per_second: float = 2.0,
                   seconds_per_grid: float | list[float] = 1.0) -> np.ndarray:
    """-> (3, L) position ids of one sequence (host-side numpy). Text tokens
    advance the three streams together; each visual's tokens take grid
    positions and the stream resumes after it at its largest position + 1.
    Video pads scale the temporal stream by wall-clock seconds. Two
    transformers conventions are kept: `second_per_grid_t` is cast to int64
    before scaling, and a `seconds_per_grid` list indexes per video, not per
    visual."""
    L = len(input_ids)
    pos = np.zeros((3, L), np.int64)
    img_iter = iter(image_grids)
    pad_ids = {image_pad_id} | ({video_pad_id} if video_pad_id is not None else set())
    spg = seconds_per_grid if isinstance(seconds_per_grid, (list, tuple)) else None
    n_videos = 0
    i = 0
    next_pos = 0
    while i < L:
        if input_ids[i] in pad_ids:
            t, h, w = next(img_iter)
            gh, gw = h // spatial_merge_size, w // spatial_merge_size
            n = t * gh * gw
            is_video = input_ids[i] == video_pad_id
            scale = 1.0
            if is_video:
                scale = int(spg[n_videos] if spg else seconds_per_grid) * tokens_per_second
                n_videos += 1
            t_idx = np.repeat((np.arange(t) * scale).astype(np.int64), gh * gw)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), t)
            w_idx = np.tile(np.arange(gw), t * gh)
            pos[0, i : i + n] = next_pos + t_idx
            pos[1, i : i + n] = next_pos + h_idx
            pos[2, i : i + n] = next_pos + w_idx
            next_pos = next_pos + max(int(t_idx.max()) + 1 if n else 1, gh, gw)
            i += n
        else:
            pos[:, i] = next_pos
            next_pos += 1
            i += 1
    return pos


class QwenVLModel(nn.Module):
    """The combined model (the verifier's and the reflector's base)."""

    def __init__(self, lm_cfg: QwenLMConfig, vis_cfg: QwenVLVisionConfig,
                 tokens: QwenVLSpecialTokens = QwenVLSpecialTokens()):
        super().__init__()
        self.lm_cfg, self.vis_cfg, self.tokens = lm_cfg, vis_cfg, tokens
        self.model = QwenLM(lm_cfg)
        self.visual = QwenVisionTower(vis_cfg)
        self.lm_head = None if lm_cfg.tie_word_embeddings else nn.Linear(lm_cfg.hidden_size, lm_cfg.vocab_size,
                                                                         bias=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.model.embed_tokens.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @classmethod
    def random_init(cls, generator: torch.Generator, lm_cfg: QwenLMConfig | None = None,
                    vis_cfg: QwenVLVisionConfig | None = None, dtype: torch.dtype = torch.float32,
                    device: str | torch.device | None = None,
                    tokens: QwenVLSpecialTokens | None = None) -> "QwenVLModel":
        """Random weights (the JAX package's recipe: linears N(0, 1/fan_in),
        zero biases, unit norms, embeddings N(0, 0.02^2)) made on `device`
        (default: the generator's) from `generator`; default configs tiny."""
        from ...sampler.pipeline import random_init_

        lm_cfg = lm_cfg or QwenLMConfig.tiny()
        vis_cfg = vis_cfg or QwenVLVisionConfig.tiny()
        device = torch.device(device) if device is not None else generator.device
        with torch.device("meta"):
            model = cls(lm_cfg, vis_cfg, tokens or QwenVLSpecialTokens())
        model = model.to(dtype).to_empty(device=device)
        return random_init_(model, generator).eval().requires_grad_(False)

    def vision(self, patches: torch.Tensor, grid) -> torch.Tensor:
        return qwen_vision_apply(self.visual, patches.to(self.device, self.dtype), grid)

    def embed_sequence(self, input_ids: np.ndarray, images: list[np.ndarray], precomputed=None):
        """One sequence -> (embeds (1, L, H), position_ids (3, 1, L)): token
        embeddings with the image-pad positions replaced by vision embeddings.
        `precomputed` = (vision_embeds, grids) from a batched tower pass."""
        if precomputed is not None:
            vision_embeds, grids = precomputed
        else:
            grids, vision_embeds = [], []
            for img in images:
                img = np.asarray(img)
                if img.ndim == 4:  # (T, H, W, 3) video clip
                    from .video import video_to_patches

                    patches, grid = video_to_patches(img, self.vis_cfg)
                else:
                    patches, grid = image_to_patches(img, self.vis_cfg)
                vision_embeds.append(self.vision(torch.from_numpy(np.ascontiguousarray(patches)), grid))
                grids.append(grid)
        ids = torch.from_numpy(np.asarray(input_ids, np.int64)).to(self.device)
        embeds = self.model.embed_tokens(ids)[None]
        if len(vision_embeds):
            vis = torch.cat(list(vision_embeds), dim=0).to(embeds.dtype)
            is_pad = (np.asarray(input_ids) == self.tokens.image_pad) | (np.asarray(input_ids) == self.tokens.video_pad)
            if int(is_pad.sum()) != vis.shape[0]:
                raise ValueError(f"visual token count mismatch: {int(is_pad.sum())} pads vs {vis.shape[0]} embeds")
            embeds[0, torch.from_numpy(np.nonzero(is_pad)[0]).to(self.device)] = vis
        pos = get_rope_index(input_ids, grids, self.vis_cfg.spatial_merge_size, self.tokens.image_pad,
                             video_pad_id=self.tokens.video_pad)
        return embeds, torch.from_numpy(pos[:, None, :]).to(self.device)

    @torch.no_grad()
    def forward_hidden(self, input_ids: np.ndarray, images: list[np.ndarray]) -> torch.Tensor:
        embeds, pos = self.embed_sequence(input_ids, images)
        return qwen_lm_apply(self.model, self.lm_head, embeds, pos, return_hidden=True)[0]

    @torch.no_grad()
    def forward_logits(self, input_ids: np.ndarray, images: list[np.ndarray]) -> torch.Tensor:
        embeds, pos = self.embed_sequence(input_ids, images)
        return qwen_lm_apply(self.model, self.lm_head, embeds, pos)[0]
