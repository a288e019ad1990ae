"""Image-Verifier reward model: Qwen2.5-VL plus an `rm_head` on pooled LM states.

Counterpart of `reflectionflow_tpu/models/qwen_vl/reward.py`: rm_head is a
bias-free linear (hidden, output_dim); pooling "last" (the last valid token),
"mean" (mask-weighted) or "special" (the last `<|VQ_reward|>` position);
scores z-normalised with the checkpoint's saved mean and std.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .lm import qwen_lm_apply
from .model import QwenVLModel


@dataclass
class RewardHead:
    w: torch.Tensor  # (hidden, output_dim)
    pooling: str = "special"  # last | mean | special
    special_token_id: int | None = None
    vq_mean: float = 0.0
    vq_std: float = 1.0

    @classmethod
    def random_init(cls, generator: torch.Generator, hidden: int, output_dim: int = 1, pooling: str = "last",
                    special_token_id: int | None = None) -> "RewardHead":
        w = torch.randn((hidden, output_dim), generator=generator, device=generator.device) * hidden ** -0.5
        return cls(w=w, pooling=pooling, special_token_id=special_token_id)


def pool_hidden(hidden: torch.Tensor, attention_mask: torch.Tensor, pooling: str,
                input_ids: torch.Tensor | None = None, special_token_id: int | None = None) -> torch.Tensor:
    """(B, L, H) -> (B, H) pooled states."""
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    if pooling == "mean":
        m = attention_mask[:, :, None].to(hidden.dtype)
        return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    if pooling == "last":
        return hidden[rows, attention_mask.sum(dim=1).long() - 1]
    if pooling == "special":
        if input_ids is None or special_token_id is None:
            raise ValueError("special pooling needs input_ids and special_token_id")
        is_sp = (input_ids == special_token_id).long()
        idx = torch.argmax(is_sp * torch.arange(1, input_ids.shape[1] + 1, device=input_ids.device)[None], dim=1)
        return hidden[rows, idx]
    raise ValueError(f"unknown pooling {pooling}")


@torch.no_grad()
def rm_scores(model: QwenVLModel, head: RewardHead, embeds: torch.Tensor, pos: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """One LM forward, pooling and the head: (B, L, H) embeddings -> (B, output_dim)."""
    hidden, _ = qwen_lm_apply(model.model, model.lm_head, embeds, pos, return_hidden=True)
    mask = torch.ones(ids.shape, dtype=torch.long, device=ids.device)
    pooled = pool_hidden(hidden, mask, head.pooling, input_ids=ids, special_token_id=head.special_token_id)
    return pooled @ head.w.to(pooled.device, pooled.dtype)


class QwenRewardModel:
    """Scoring API: images + prompts -> z-normalised scalar VQ scores."""

    def __init__(self, model: QwenVLModel, head: RewardHead, prompt_template=None):
        self.model = model
        self.head = head
        self.prompt_template = prompt_template or (
            lambda prompt: f"Rate the quality of the image for the prompt: {prompt}")

    def score_sequence(self, input_ids: np.ndarray, images: list[np.ndarray]) -> float:
        embeds, pos = self.model.embed_sequence(input_ids, images)
        ids = torch.from_numpy(np.asarray(input_ids, np.int64)[None]).to(embeds.device)
        return float(rm_scores(self.model, self.head, embeds, pos, ids)[0, 0])

    def normalized(self, raw: float) -> float:
        return (raw - self.head.vq_mean) / max(self.head.vq_std, 1e-8)
