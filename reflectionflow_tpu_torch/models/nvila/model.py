"""NVILA (VILA family) vision-language model: the NVILA yes/no verifier's model.

Counterpart of `reflectionflow_tpu/models/nvila/model.py`: SigLIP tower ->
token-compressing MLP projector -> Qwen2 LM; the score is the logits the first
generated token sees. `NvilaModel` holds the three parts of a VILA bundle as
`vision_tower` (`SiglipVisionModel`, the `vision_tower/` names), `mm_projector`
(`NvilaProjector`, `mm_projector/`'s `layers.{i}`) and `llm` (`Qwen2CausalLM`,
`llm/`'s `model.*` and `lm_head`), each loadable with `load_state_dict`.

The LM is the port's Qwen2.5 stack (`models/qwen_vl/lm.py`) with
`mrope_section = (head_dim // 2, 0, 0)`: three equal position streams are
plain 1-D rotate-half RoPE. Candidates are one batch: the pre-text is
left-padded and the post-text right-padded, so the image block sits at one
offset; each row's positions are shifted back by its pad count. The
vocabulary projection runs only on each row's last valid position.

The projector's downsample is VILA's `flat_square`: output cell (i, j)
concatenates the k x k input cells row-major, the grid zero-padded on the
bottom and right to a multiple of k (k = 2 "mlp_downsample", 3
"mlp_downsample_3x3_fix", 1 plain "mlp").
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...config import NvilaConfig, QwenLMConfig, SiglipVisionConfig
from ..qwen_vl.lm import QwenLM, qwen_lm_apply
from .siglip import SiglipVisionModel, layer_norm_affine, siglip_apply

PROJECTOR_LN_EPS = 1e-5  # the projector's LayerNorm is built with torch's default eps
TEMPLATE = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
            "<|im_start|>user\n<image>\n{prompt}<|im_end|>\n<|im_start|>assistant\n")


def downsample_tokens(tokens: torch.Tensor, k: int) -> torch.Tensor:
    """(B, g*g, C) -> (B, ceil(g/k)^2, C*k*k), VILA's flat_square."""
    B, L, C = tokens.shape
    g = int(round(L ** 0.5))
    if g * g != L:
        raise ValueError(f"non-square token grid: {L} tokens")
    x = tokens.reshape(B, g, g, C)
    pad = (-g) % k
    if pad:
        x = F.pad(x, (0, 0, 0, pad, 0, pad))
        g += pad
    x = x.reshape(B, g // k, k, g // k, k, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (g // k) ** 2, k * k * C)


class NvilaProjector(nn.Module):
    """VILA's `mm_projector`: Sequential(DownSample, LayerNorm, Linear, GELU,
    Linear) saved as `layers.{1,2,4}`, or plain "mlp" Sequential(Linear, GELU,
    Linear) as `layers.{0,2}`; the parameter-free slots hold placeholders."""

    def __init__(self, vis_hidden: int, lm_hidden: int, downsample: int, norm: bool = True):
        super().__init__()
        self.downsample = downsample
        c = vis_hidden * downsample * downsample
        head = [nn.Identity(), nn.LayerNorm(c, eps=PROJECTOR_LN_EPS)] if norm else []
        self.layers = nn.Sequential(*head, nn.Linear(c, lm_hidden), nn.GELU(), nn.Linear(lm_hidden, lm_hidden))

    @property
    def norm(self) -> nn.LayerNorm | None:
        return self.layers[1] if isinstance(self.layers[1], nn.LayerNorm) else None

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """DownSample(k) -> [LayerNorm] -> Linear -> exact GELU -> Linear."""
        if self.downsample > 1:
            tokens = downsample_tokens(tokens, self.downsample)
        norm = self.norm
        if norm is not None:
            tokens = layer_norm_affine(tokens, norm, PROJECTOR_LN_EPS)
        fc1, fc2 = self.layers[-3], self.layers[-1]
        return fc2(F.gelu(fc1(tokens)))


class Qwen2CausalLM(nn.Module):
    """The `llm/` of a VILA bundle: `model.*` (the decoder) and `lm_head`
    (None when the embeddings are tied)."""

    def __init__(self, cfg: QwenLMConfig):
        super().__init__()
        self.cfg = cfg
        self.model = QwenLM(cfg)
        self.lm_head = None if cfg.tie_word_embeddings else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        return self.lm_head(h) if self.lm_head is not None else h @ self.model.embed_tokens.weight.t()


def preprocess_images(images: Sequence[np.ndarray], size: int) -> np.ndarray:
    """uint8 HWC images -> (B, size, size, 3) float32 in [-1, 1]: square resize
    with the port's copy of PIL's bicubic (bit for bit), then
    (x / 255 - 0.5) / 0.5, SigLIP's processor."""
    from ...train.data import resize

    out = np.empty((len(images), size, size, 3), np.float32)
    for i, img in enumerate(images):
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=2)
        out[i] = (resize(arr[..., :3], (size, size)).astype(np.float32) / 255.0 - 0.5) / 0.5
    return out


def nvila_logits(model: "NvilaModel", pixels: torch.Tensor, pre_ids: torch.Tensor, pre_mask: torch.Tensor,
                 post_ids: torch.Tensor, post_mask: torch.Tensor) -> torch.Tensor:
    """[pre-text | image tokens | post-text] -> (B, vocab) logits at each row's
    last valid position (what the first generated token sees). pre_* (B, Lp)
    are left-padded, post_* (B, Lq) right-padded; masks are 1 where valid."""
    lm = model.llm.model
    B = pixels.shape[0]
    vis = siglip_apply(model.vision_tower, pixels, select_layer=model.cfg.select_layer)
    img = model.mm_projector(vis).to(lm.embed_tokens.weight.dtype)
    n_img = img.shape[1]
    embeds = torch.cat([lm.embed_tokens(pre_ids), img, lm.embed_tokens(post_ids)], dim=1)
    Lp, L = pre_ids.shape[1], embeds.shape[1]
    mask = torch.cat([pre_mask, torch.ones((B, n_img), dtype=pre_mask.dtype, device=pre_mask.device),
                      post_mask], dim=1)
    n_pad = Lp - pre_mask.sum(dim=1)
    pos = (torch.arange(L, device=pixels.device)[None, :] - n_pad[:, None]).clamp_min(0)
    hidden, _ = qwen_lm_apply(lm, None, embeds, pos[None].expand(3, B, L), attention_mask=mask,
                              return_hidden=True)
    last = Lp + n_img + post_mask.sum(dim=1) - 1
    return model.llm.head(hidden[torch.arange(B, device=hidden.device), last])


class NvilaModel(nn.Module):
    """Tower + projector + LM, the chatml template around the media token and
    the bundle's tokenizer; `first_token_logits` scores candidates as one batch."""

    def __init__(self, vis_cfg: SiglipVisionConfig, lm_cfg: QwenLMConfig, cfg: NvilaConfig = NvilaConfig(),
                 norm: bool = True, tokenizer=None, template: str = TEMPLATE):
        super().__init__()
        self.vis_cfg, self.lm_cfg, self.cfg = vis_cfg, lm_cfg, cfg
        self.vision_tower = SiglipVisionModel(vis_cfg)
        self.mm_projector = NvilaProjector(vis_cfg.hidden_size, lm_cfg.hidden_size, cfg.downsample, norm)
        self.llm = Qwen2CausalLM(lm_cfg)
        self.tokenizer = tokenizer
        self.template = template

    @property
    def device(self) -> torch.device:
        return self.llm.model.embed_tokens.weight.device

    @classmethod
    def random_init(cls, generator: torch.Generator, vis_cfg: SiglipVisionConfig, lm_cfg: QwenLMConfig,
                    cfg: NvilaConfig = NvilaConfig(), dtype: torch.dtype = torch.float32,
                    device: str | torch.device | None = None) -> "NvilaModel":
        """Random weights made on `device` (default: the generator's) with the
        JAX package's recipe (linears and the patch conv N(0, 1/fan_in), zero
        biases, unit norms, embeddings N(0, 0.02^2))."""
        from ...sampler.pipeline import random_init_

        device = torch.device(device) if device is not None else generator.device
        with torch.device("meta"):
            model = cls(vis_cfg, lm_cfg, cfg)
        model = model.to(dtype).to_empty(device=device)
        with torch.no_grad():
            for part in (model.vision_tower, model.mm_projector, model.llm):
                random_init_(part, generator)
        return model.eval().requires_grad_(False)

    def _encode(self, text: str) -> tuple[list[int], list[int]]:
        pre, _, post = text.partition(self.cfg.media_token)
        return (self.tokenizer.encode(pre, add_special_tokens=False),
                self.tokenizer.encode(post, add_special_tokens=False))

    def batch(self, images: Sequence[np.ndarray], prompts: Sequence[str]):
        """-> (pixels, pre_ids, pre_mask, post_ids, post_mask) on the model's
        device, the arguments of `nvila_logits`; pad lengths in buckets of
        max(8, ceil(len / 32) * 32)."""
        if len(images) != len(prompts):
            raise ValueError(f"{len(images)} images for {len(prompts)} prompts")
        dev = self.device
        pixels = torch.from_numpy(preprocess_images(images, self.vis_cfg.image_size)).to(dev)
        pre_list, post_list = zip(*(self._encode(self.template.format(prompt=p)) for p in prompts))
        Lp = max(8, -(-max(map(len, pre_list)) // 32) * 32)
        Lq = max(8, -(-max(map(len, post_list)) // 32) * 32)
        B = len(images)
        pre_ids, pre_mask = np.zeros((B, Lp), np.int64), np.zeros((B, Lp), np.int64)
        post_ids, post_mask = np.zeros((B, Lq), np.int64), np.zeros((B, Lq), np.int64)
        for i, (a, b) in enumerate(zip(pre_list, post_list)):
            pre_ids[i, Lp - len(a):], pre_mask[i, Lp - len(a):] = a, 1
            post_ids[i, : len(b)], post_mask[i, : len(b)] = b, 1
        return (pixels, *(torch.from_numpy(a).to(dev) for a in (pre_ids, pre_mask, post_ids, post_mask)))

    @torch.no_grad()
    def first_token_logits(self, images: Sequence[np.ndarray], prompts: Sequence[str]) -> np.ndarray:
        """(B, vocab) fp32 logits of the first generated token of each (image,
        prompt) pair."""
        return nvila_logits(self, *self.batch(images, prompts)).float().cpu().numpy()
