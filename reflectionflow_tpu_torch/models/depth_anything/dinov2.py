"""DINOv2 backbone of Depth Anything.

Counterpart of transformers' `Dinov2Backbone`, which the JAX package's
`depth` preprocessor runs through transformers' depth-estimation pipeline,
with its parameter names (`embeddings.patch_embeddings.projection`,
`encoder.layer.{i}.attention.attention.query`, `layer_scale1.lambda1`,
`layernorm`, ...), so a snapshot's `backbone.*` tensors load unchanged.

A Conv2d patch embedding with stride = kernel, a CLS token, learned
positions for the `image_size` grid bicubically interpolated (in fp32, to
the input's grid given as a size) unless the input is that grid and square,
pre-LN layers with LayerScale on both residual branches (exact-GELU MLP),
and the final LayerNorm on the `out_indices` hidden states.
Attention is PyTorch's SDPA: the JAX package runs this model in transformers'
PyTorch, outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...config import Dinov2Config


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        self.projection = nn.Conv2d(cfg.num_channels, cfg.hidden_size, kernel_size=cfg.patch_size,
                                    stride=cfg.patch_size)


class _Embeddings(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        if cfg.use_mask_token:  # read by masked pretraining only; a snapshot carries it
            self.mask_token = nn.Parameter(torch.empty(1, cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg)
        self.position_embeddings = nn.Parameter(torch.empty(1, n + 1, cfg.hidden_size))


class _SelfAttention(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        H = cfg.hidden_size
        self.query = nn.Linear(H, H, bias=cfg.qkv_bias)
        self.key = nn.Linear(H, H, bias=cfg.qkv_bias)
        self.value = nn.Linear(H, H, bias=cfg.qkv_bias)


class _SelfOutput(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)


class _Attention(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        self.attention = _SelfAttention(cfg)
        self.output = _SelfOutput(cfg)


class _LayerScale(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.empty(cfg.hidden_size))


class _MLP(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        hidden = int(cfg.hidden_size * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.hidden_size, hidden)
        self.fc2 = nn.Linear(hidden, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _Layer(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attention = _Attention(cfg)
        self.layer_scale1 = _LayerScale(cfg)
        self.norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)
        self.layer_scale2 = _LayerScale(cfg)


class _Encoder(nn.Module):
    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))


class Dinov2Backbone(nn.Module):
    """transformers' `Dinov2Backbone` parameters and forward."""

    def __init__(self, cfg: Dinov2Config):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def position_embeddings(self, height: int, width: int) -> torch.Tensor:
        """(1, 1 + gh * gw, hidden) positions for an input of height x width
        pixels: transformers' `interpolate_pos_encoding` (the stored grid as
        it is for an input of that many patches that is square, else a bicubic
        resize of the grid to (height // patch, width // patch) in fp32)."""
        cfg, pos = self.cfg, self.embeddings.position_embeddings
        n_pos = pos.shape[1] - 1
        gh, gw = height // cfg.patch_size, width // cfg.patch_size
        if gh * gw == n_pos and height == width:
            return pos
        side = int(n_pos ** 0.5)
        grid = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid.float(), size=(gh, gw), mode="bicubic", align_corners=False).to(pos.dtype)
        return torch.cat((pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)), dim=1)

    def forward(self, pixel_values: torch.Tensor) -> list[torch.Tensor]:
        """(B, C, H, W) normalized pixels -> the `out_indices` hidden states,
        each (B, 1 + gh * gw, hidden) with the CLS row first (after the final
        LayerNorm when `apply_layernorm`)."""
        cfg = self.cfg
        B, _, height, width = pixel_values.shape
        proj = self.embeddings.patch_embeddings.projection
        h = proj(pixel_values.to(proj.weight.dtype)).flatten(2).transpose(1, 2)
        h = torch.cat((self.embeddings.cls_token.expand(B, -1, -1), h), dim=1)
        h = h + self.position_embeddings(height, width)
        nH = cfg.num_heads
        D = cfg.hidden_size // nH
        L = h.shape[1]
        outs = [h] if 0 in cfg.out_indices else []
        for i, layer in enumerate(self.encoder.layer, start=1):
            a = layer.attention.attention
            x = layer.norm1(h)
            q, k, v = (p(x).view(B, L, nH, D).transpose(1, 2) for p in (a.query, a.key, a.value))
            attn = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, L, -1)
            h = layer.attention.output.dense(attn) * layer.layer_scale1.lambda1 + h
            h = layer.mlp(layer.norm2(h)) * layer.layer_scale2.lambda1 + h
            if i in cfg.out_indices:
                outs.append(h)
        return [self.layernorm(o) for o in outs] if cfg.apply_layernorm else outs
