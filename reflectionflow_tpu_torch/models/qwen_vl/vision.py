"""Qwen2.5-VL vision tower: window attention, 2-D RoPE and the patch merger.

Counterpart of `reflectionflow_tpu/models/qwen_vl/vision.py`, with
transformers' parameter names (`visual.patch_embed.proj`,
`visual.blocks.{i}.attn.qkv`, `visual.merger.mlp.0`, ...). The window
partition and the attention segments of a grid are host-side numpy
(`vision_geometry`); window attention is one SDPA call with a boolean
block-diagonal mask, full attention (`fullatt_block_indexes`) one without a
mask for an image (one segment), per frame for a clip.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...config import QwenVLVisionConfig
from .lm import RMSNorm, _MLP, rotate_half


class _PatchEmbed(nn.Module):
    """A Conv3d of stride = kernel over (tp, ps, ps) patches: a linear map of
    each flattened patch (features channel-major, then t, h, w)."""

    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        k = (cfg.temporal_patch_size, cfg.patch_size, cfg.patch_size)
        self.proj = nn.Conv3d(3, cfg.hidden_size, kernel_size=k, stride=k, bias=False)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return patches @ self.proj.weight.reshape(self.proj.weight.shape[0], -1).t()


class _VisionAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _VisionBlock(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        self.norm1 = RMSNorm(cfg.hidden_size)
        self.attn = _VisionAttention(cfg.hidden_size)
        self.norm2 = RMSNorm(cfg.hidden_size)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size, bias=True)


class _Merger(nn.Module):
    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        merged = cfg.hidden_size * cfg.spatial_merge_size ** 2
        self.ln_q = RMSNorm(cfg.hidden_size)
        self.mlp = nn.Sequential(nn.Linear(merged, merged), nn.GELU(), nn.Linear(merged, cfg.out_hidden_size))


class QwenVisionTower(nn.Module):
    """`visual.*` of a Qwen2.5-VL checkpoint."""

    def __init__(self, cfg: QwenVLVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        self.blocks = nn.ModuleList(_VisionBlock(cfg) for _ in range(cfg.depth))
        self.merger = _Merger(cfg)


@lru_cache(maxsize=32)
def vision_geometry(cfg: QwenVLVisionConfig, t: int, h: int, w: int):
    """(window_index, pos_units, seg_window, seg_full) of one grid, as
    Qwen2.5-VL's get_window_index / rot_pos_emb: tokens regrouped into
    spatial-merge units of merge**2 patches, units tiled into windows of
    window_size // merge // patch units a side (edge windows truncated), and
    attention local to a window or, in the full blocks, to a frame."""
    merge = cfg.spatial_merge_size
    unit = merge * merge
    win = cfg.window_size // merge // cfg.patch_size
    gh, gw = h // merge, w // merge

    index = np.arange(t * gh * gw).reshape(t, gh, gw)
    pad_h, pad_w = (-gh) % win, (-gw) % win
    nwh, nww = (gh + pad_h) // win, (gw + pad_w) // win
    padded = np.pad(index, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=-100)
    padded = padded.reshape(t, nwh, win, nww, win).transpose(0, 1, 3, 2, 4).reshape(t, nwh * nww, win, win)
    seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
    flat = padded.reshape(-1)
    window_index = flat[flat != -100]
    seg_window = np.repeat(np.arange(len(seqlens)), seqlens * unit)
    seg_full = np.repeat(np.repeat(np.arange(t), gh * gw)[window_index], unit)

    hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
    wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))

    def group(x):
        return x.reshape(gh, merge, gw, merge).transpose(0, 2, 1, 3).reshape(-1)

    pos = np.tile(np.stack([group(hpos), group(wpos)], axis=-1), (t, 1))
    pos_units = pos.reshape(-1, unit, 2)[window_index].reshape(-1, 2)
    return window_index, pos_units, seg_window, seg_full


def _segment_mask(seg: np.ndarray, device) -> torch.Tensor | None:
    """Boolean (L, L) mask of same-segment pairs; None for a single segment."""
    if (seg == seg[0]).all():
        return None
    s = torch.from_numpy(seg).to(device)
    return s[:, None] == s[None, :]


def _vision_block(blk: _VisionBlock, x: torch.Tensor, cos, sin, mask, nH: int) -> torch.Tensor:
    B, L, C = x.shape
    D = C // nH
    hs = blk.norm1(x)
    q, k, v = blk.attn.qkv(hs).reshape(B, L, 3, nH, D).unbind(2)
    q = (q.float() * cos + rotate_half(q.float()) * sin).to(x.dtype)
    k = (k.float() * cos + rotate_half(k.float()) * sin).to(x.dtype)
    attn = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          attn_mask=mask)
    x = x + blk.attn.proj(attn.transpose(1, 2).reshape(B, L, nH * D))
    return x + blk.mlp(blk.norm2(x))


def qwen_vision_apply(tower: QwenVisionTower, patches: torch.Tensor,
                      grid_thw: tuple[int, int, int], remat: bool = False) -> torch.Tensor:
    """Patches (L, 3*tp*ps*ps), or a same-grid batch (B, L, ...), -> image
    embeddings (L / merge**2, out_hidden_size), or (B, L / merge**2, ...).
    `remat` (vision-adapter training) recomputes each block in the backward
    (`torch.utils.checkpoint`) instead of saving its activations."""
    cfg = tower.cfg
    single = patches.dim() == 2
    x = patches[None] if single else patches
    B = x.shape[0]
    t, h, w = grid_thw
    L = t * h * w
    if x.shape[1] != L:
        raise ValueError(f"{x.shape[1]} patches for grid {grid_thw}")
    unit = cfg.spatial_merge_size ** 2
    nH = cfg.num_heads
    D = cfg.hidden_size // nH
    dev = x.device
    window_index, pos_units, seg_window, seg_full = vision_geometry(cfg, t, h, w)
    widx = torch.from_numpy(window_index).to(dev)

    x = tower.patch_embed(x)
    x = x.reshape(B, L // unit, unit, -1)[:, widx].reshape(B, L, -1)

    quarter = D // 4
    inv_freq = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) * 2 / (D // 2)))
    ang = np.concatenate([pos_units[:, 0:1] * inv_freq, pos_units[:, 1:2] * inv_freq], axis=-1)
    ang = np.concatenate([ang, ang], axis=-1)
    cos = torch.from_numpy(np.cos(ang)).float().to(dev)[None, :, None, :]
    sin = torch.from_numpy(np.sin(ang)).float().to(dev)[None, :, None, :]
    masks = {False: _segment_mask(seg_window, dev), True: _segment_mask(seg_full, dev)}
    fullatt = set(cfg.fullatt_block_indexes)
    remat = remat and torch.is_grad_enabled()
    for i, blk in enumerate(tower.blocks):
        if remat:
            x = checkpoint(_vision_block, blk, x, cos, sin, masks[i in fullatt], nH, use_reentrant=False)
        else:
            x = _vision_block(blk, x, cos, sin, masks[i in fullatt], nH)

    m = tower.merger.ln_q(x).reshape(B, L // unit, unit * cfg.hidden_size)
    m = tower.merger.mlp(m)
    m = m[:, torch.from_numpy(np.argsort(window_index)).to(dev)]  # undo the window order
    return m[0] if single else m


_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def frames_to_patches(frames: np.ndarray, cfg: QwenVLVisionConfig):
    """(T, H, W, 3) uint8, T a multiple of temporal_patch_size -> flattened
    patches (L, 3*tp*ps*ps) in Qwen's merge-grouped order + grid (T/tp, h, w)."""
    ps, tp, merge = cfg.patch_size, cfg.temporal_patch_size, cfg.spatial_merge_size
    T, H, W, _ = frames.shape
    if T % tp or H % (ps * merge) or W % (ps * merge):
        raise ValueError(f"frames {(T, H, W)} do not tile into {tp} x {ps * merge} x {ps * merge} patches")
    gt, gh, gw = T // tp, H // ps, W // ps
    x = (frames.astype(np.float32) / 255.0 - _CLIP_MEAN) / _CLIP_STD
    x = x.transpose(0, 3, 1, 2)
    x = x.reshape(gt, tp, 3, gh // merge, merge, ps, gw // merge, merge, ps)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gt * gh * gw, 3 * tp * ps * ps), (gt, gh, gw)


def image_to_patches(image: np.ndarray, cfg: QwenVLVisionConfig):
    """(H, W, 3) uint8 (H, W multiples of patch * merge) -> patches + grid
    (1, h, w): the frame repeated to fill one temporal patch."""
    frames = np.broadcast_to(np.asarray(image)[None], (cfg.temporal_patch_size,) + image.shape)
    return frames_to_patches(frames, cfg)


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> tuple[int, int]:
    """Qwen's resolution policy: multiples of `factor`, area within
    [min_pixels, max_pixels]."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio too extreme")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar
