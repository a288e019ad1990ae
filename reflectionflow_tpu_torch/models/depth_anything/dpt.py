"""Depth Anything's DPT neck and depth head.

Counterpart of transformers' `DepthAnythingNeck` and
`DepthAnythingDepthEstimationHead`, with their parameter names
(`reassemble_stage.layers.{i}.projection` / `.resize`, `convs.{i}`,
`fusion_stage.layers.{i}.residual_layer{1,2}.convolution{1,2}`, `head.conv{1,2,3}`):

  * reassemble: each backbone output without its CLS row, as a
    (B, hidden, gh, gw) map, a 1x1 projection, then a resize by factor 4 / 2
    (ConvTranspose2d of kernel = stride = factor), 1 (identity) or 0.5 (3x3
    conv of stride 2, padding 1);
  * the neck's 3x3 convs (no bias) to `fusion_hidden_size`;
  * fusion, from the coarsest map up: pre-activation residual units (ReLU,
    conv, ReLU, conv, plus the input), the skip map added through the first
    unit (bilinearly resized, align_corners=False, if its shape differs),
    the second unit, a bilinear resize with align_corners=True to the next
    map's size (x2 at the last stage), and a 1x1 projection;
  * the head on the last fused map: conv, bilinear (align_corners=True) to
    (patch * gh, patch * gw), conv, ReLU, 1x1 conv, then ReLU ("relative") or
    sigmoid ("metric"), times max_depth.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...config import DepthAnythingConfig


class _ReassembleLayer(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig, channels: int, factor: float):
        super().__init__()
        self.projection = nn.Conv2d(cfg.reassemble_hidden_size, channels, kernel_size=1)
        if factor > 1:
            self.resize = nn.ConvTranspose2d(channels, channels, kernel_size=int(factor), stride=int(factor))
        elif factor == 1:
            self.resize = nn.Identity()
        else:
            self.resize = nn.Conv2d(channels, channels, kernel_size=3, stride=int(1 / factor), padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resize(self.projection(x))


class _ReassembleStage(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        self.layers = nn.ModuleList(_ReassembleLayer(cfg, c, f)
                                    for c, f in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors))


class _PreActResidual(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        C = cfg.fusion_hidden_size
        self.convolution1 = nn.Conv2d(C, C, kernel_size=3, padding=1)
        self.convolution2 = nn.Conv2d(C, C, kernel_size=3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convolution2(F.relu(self.convolution1(F.relu(x)))) + x


class _FusionLayer(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        C = cfg.fusion_hidden_size
        self.projection = nn.Conv2d(C, C, kernel_size=1)
        self.residual_layer1 = _PreActResidual(cfg)  # unused by the first (coarsest) stage
        self.residual_layer2 = _PreActResidual(cfg)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None, size) -> torch.Tensor:
        if skip is not None:
            if skip.shape != x.shape:
                skip = F.interpolate(skip, size=x.shape[2:], mode="bilinear", align_corners=False)
            x = x + self.residual_layer1(skip)
        x = self.residual_layer2(x)
        x = F.interpolate(x, **({"scale_factor": 2} if size is None else {"size": size}), mode="bilinear",
                          align_corners=True)
        return self.projection(x)


class _FusionStage(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        self.layers = nn.ModuleList(_FusionLayer(cfg) for _ in cfg.neck_hidden_sizes)


class DepthAnythingNeck(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        self.cfg = cfg
        self.reassemble_stage = _ReassembleStage(cfg)
        self.convs = nn.ModuleList(nn.Conv2d(c, cfg.fusion_hidden_size, kernel_size=3, padding=1, bias=False)
                                   for c in cfg.neck_hidden_sizes)
        self.fusion_stage = _FusionStage(cfg)

    def forward(self, hidden_states: list[torch.Tensor], gh: int, gw: int) -> list[torch.Tensor]:
        """The backbone's (B, 1 + gh * gw, hidden) outputs -> the fused maps,
        coarsest stage first."""
        maps = []
        for h, layer, conv in zip(hidden_states, self.reassemble_stage.layers, self.convs):
            x = h[:, 1:].reshape(h.shape[0], gh, gw, h.shape[2]).permute(0, 3, 1, 2).contiguous()
            maps.append(conv(layer(x)))
        maps = maps[::-1]
        fused, out = None, []
        for i, (x, layer) in enumerate(zip(maps, self.fusion_stage.layers)):
            size = maps[i + 1].shape[2:] if i + 1 < len(maps) else None
            fused = layer(x, None, size) if fused is None else layer(fused, x, size)
            out.append(fused)
        return out


class DepthAnythingHead(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.fusion_hidden_size
        self.conv1 = nn.Conv2d(C, C // 2, kernel_size=3, padding=1)
        self.conv2 = nn.Conv2d(C // 2, cfg.head_hidden_size, kernel_size=3, padding=1)
        self.conv3 = nn.Conv2d(cfg.head_hidden_size, 1, kernel_size=1)

    def forward(self, fused: list[torch.Tensor], gh: int, gw: int) -> torch.Tensor:
        """-> (B, patch * gh, patch * gw) predicted depth."""
        cfg = self.cfg
        x = self.conv1(fused[cfg.head_in_index])
        x = F.interpolate(x, (gh * cfg.patch_size, gw * cfg.patch_size), mode="bilinear", align_corners=True)
        x = self.conv3(F.relu(self.conv2(x)))
        x = F.relu(x) if cfg.depth_estimation_type == "relative" else torch.sigmoid(x)
        return (x * cfg.max_depth).squeeze(1)
