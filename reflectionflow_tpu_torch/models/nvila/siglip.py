"""SigLIP vision tower: the NVILA verifier's image encoder.

Counterpart of `reflectionflow_tpu/models/nvila/siglip.py`, with the names of
transformers' `SiglipVisionModel` (`vision_model.embeddings.patch_embedding`,
`vision_model.encoder.layers.{i}.self_attn.q_proj`, `vision_model.post_layernorm`,
...), so a VILA bundle's `vision_tower/` loads with `load_state_dict`.
Valid-padding patch embed (the Conv2d of stride = kernel applied as one matmul
over `(c, ph, pw)` patches), learned positions and no CLS token, pre-LN blocks
(biased q/k/v/out attention, tanh-GELU MLP), a final post-layernorm.
Attention is PyTorch's SDPA: the JAX package writes it in XLA einsums, not a
Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...config import SiglipVisionConfig


def layer_norm_affine(x: torch.Tensor, ln: nn.LayerNorm, eps: float) -> torch.Tensor:
    """LayerNorm computed in fp32 (weights too), the result in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(), ln.bias.float(), eps).to(x.dtype)


class _Embeddings(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        P = cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, kernel_size=P, stride=P)
        self.position_embedding = nn.Embedding((cfg.image_size // P) ** 2, cfg.hidden_size)


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = _Attention(cfg.hidden_size)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg.num_layers))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class SiglipVisionModel(nn.Module):
    """transformers' `SiglipVisionModel` parameters (without the attention-pooling
    head, which no VILA tap reads)."""

    def __init__(self, cfg: SiglipVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg)


def patchify_images(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, gh*gw, 3*patch*patch) valid patches, features in the
    Conv2d kernel's (c, ph, pw) order."""
    B, H, W, C = pixels.shape
    gh, gw = H // patch, W // patch
    x = pixels.reshape(B, gh, patch, gw, patch, C)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(B, gh * gw, C * patch * patch)


def siglip_apply(tower: SiglipVisionModel, pixels: torch.Tensor, select_layer: int = 0) -> torch.Tensor:
    """(B, S, S, 3) normalized pixels (S = image_size) -> (B, n_patches, H).

    select_layer 0: every block and the post-layernorm (transformers'
    `last_hidden_state`). Negative: VILA's tap into [embeddings, block_1, ...,
    block_N] (-1 the last block's output, -2 the one before): only that prefix
    of blocks runs, and there is no post-layernorm."""
    cfg, vm = tower.cfg, tower.vision_model
    nH = cfg.num_heads
    D = cfg.hidden_size // nH
    n_run = cfg.num_layers if select_layer == 0 else cfg.num_layers + 1 + select_layer
    if not 0 <= n_run <= cfg.num_layers:
        raise ValueError(f"select_layer {select_layer} out of range for {cfg.num_layers} blocks")
    conv = vm.embeddings.patch_embedding
    patches = patchify_images(pixels.to(conv.weight.dtype), cfg.patch_size)
    h = F.linear(patches, conv.weight.flatten(1), conv.bias)
    h = h + vm.embeddings.position_embedding.weight[None].to(h.dtype)
    B, L, H = h.shape
    for layer in vm.encoder.layers[:n_run]:
        a = layer.self_attn
        x = layer_norm_affine(h, layer.layer_norm1, cfg.layer_norm_eps)
        q, k, v = (p(x).view(B, L, nH, D).transpose(1, 2) for p in (a.q_proj, a.k_proj, a.v_proj))
        attn = F.scaled_dot_product_attention(q, k, v)
        h = h + a.out_proj(attn.transpose(1, 2).reshape(B, L, H))
        x = layer_norm_affine(h, layer.layer_norm2, cfg.layer_norm_eps)
        h = h + layer.mlp.fc2(F.gelu(layer.mlp.fc1(x), approximate="tanh"))
    if select_layer == 0:
        h = layer_norm_affine(h, vm.post_layernorm, cfg.layer_norm_eps)
    return h
