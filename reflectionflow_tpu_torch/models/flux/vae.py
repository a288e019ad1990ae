"""FLUX AutoencoderKL (16-channel): the encoder and the decoder.

Counterpart of `reflectionflow_tpu/models/flux/vae.py::vae_encode` and
`vae_decode`. The public layout is the JAX package's NHWC, in and out;
inside, both halves run NCHW, PyTorch's convolution layout. Parameters carry
diffusers' AutoencoderKL names (`encoder.down_blocks.{i}.resnets.{j}.conv1`,
`decoder.up_blocks.{i}...`), the names
`reflectionflow_tpu/utils/hf_convert.py::convert_flux_vae_state` reads.

`vae_decode_tiled` / `vae_encode_tiled` are diffusers' `enable_vae_tiling`
scheme (overlapping tiles, linear cross-fades over the overlap), as the JAX
package has it: per-tile GroupNorm statistics make a multi-tile result differ
slightly from the untiled one near the seams; a single-tile input takes the
exact untiled path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...config import FluxVAEConfig


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm on NCHW with fp32 statistics, result in x's dtype."""
    B, C, H, W = x.shape
    G = norm.num_groups
    xf = x.float().reshape(B, G, C // G, H, W)
    var, mu = torch.var_mean(xf, dim=(2, 3, 4), keepdim=True, unbiased=False)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    return (xf * norm.weight.float()[:, None, None] + norm.bias.float()[:, None, None]).to(x.dtype)


class _Resnet(nn.Module):
    def __init__(self, c_in: int, c_out: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, c_in)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1)
        if c_in != c_out:
            self.conv_shortcut = nn.Conv2d(c_in, c_out, 1)

    def forward(self, x):
        h = self.conv1(F.silu(group_norm(x, self.norm1)))
        h = self.conv2(F.silu(group_norm(h, self.norm2)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class _MidAttention(nn.Module):
    """Single-head self-attention over the H*W positions; the projections
    are Linear, as current diffusers checkpoints store them."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c)
        self.to_q, self.to_k, self.to_v = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = group_norm(x, self.group_norm).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) / math.sqrt(C)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = self.to_out[0](torch.einsum("bqk,bkc->bqc", probs, v))
        return x + out.transpose(1, 2).reshape(B, C, H, W)


class _MidBlock(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([_Resnet(c, c, groups), _Resnet(c, c, groups)])
        self.attentions = nn.ModuleList([_MidAttention(c, groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _Upsampler(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _UpBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, layers: int, groups: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            _Resnet(c_in if j == 0 else c_out, c_out, groups) for j in range(layers + 1))
        if upsample:
            self.upsamplers = nn.ModuleList([_Upsampler(c_out)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class _Downsampler(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        # asymmetric (0, 1) pad on H and W, then the stride-2 conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, layers: int, groups: int, downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            _Resnet(c_in if j == 0 else c_out, c_out, groups) for j in range(layers))
        if downsample:
            self.downsamplers = nn.ModuleList([_Downsampler(c_out)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class _Encoder(nn.Module):
    def __init__(self, cfg: FluxVAEConfig):
        super().__init__()
        chans = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            _DownBlock(chans[max(i - 1, 0)], c, cfg.layers_per_block, g, i < len(chans) - 1)
            for i, c in enumerate(chans))
        self.mid_block = _MidBlock(chans[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chans[-1])
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)


class _Decoder(nn.Module):
    def __init__(self, cfg: FluxVAEConfig):
        super().__init__()
        chans = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[0], 3, padding=1)
        self.mid_block = _MidBlock(chans[0], g)
        self.up_blocks = nn.ModuleList(
            _UpBlock(chans[max(i - 1, 0)], c, cfg.layers_per_block, g, i < len(chans) - 1)
            for i, c in enumerate(chans))
        self.conv_norm_out = nn.GroupNorm(g, chans[-1])
        self.conv_out = nn.Conv2d(chans[-1], cfg.in_channels, 3, padding=1)


class FluxVAE(nn.Module):
    """The AutoencoderKL's parameters: `encoder` and `decoder`."""

    def __init__(self, cfg: FluxVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Encoder(cfg)
        self.decoder = _Decoder(cfg)


def vae_encode_moments(vae: FluxVAE, images: torch.Tensor) -> torch.Tensor:
    """Images (B, H, W, 3) NHWC in [-1, 1] -> moments (B, h, w, 2 * C_lat),
    mean then logvar."""
    enc = vae.encoder
    x = enc.conv_in(images.permute(0, 3, 1, 2))
    for block in enc.down_blocks:
        x = block(x)
    x = enc.mid_block(x)
    x = F.silu(group_norm(x, enc.conv_norm_out))
    return enc.conv_out(x).permute(0, 2, 3, 1)


def _moments_to_latents(moments: torch.Tensor, cfg: FluxVAEConfig,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    mean, logvar = moments.chunk(2, dim=-1)
    if generator is not None:
        noise = torch.randn(mean.shape, generator=generator, device=generator.device)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        mean = mean + std * noise.to(mean.device, mean.dtype)
    return (mean - cfg.shift_factor) * cfg.scaling_factor


def vae_encode(vae: FluxVAE, images: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Images (B, H, W, 3) in [-1, 1] -> scaled latents (B, h, w, C_lat):
    (mean - shift) * scale, the posterior's mode; with a `generator`, a
    sample mean + exp(logvar / 2) * N(0, 1) (logvar clipped to [-30, 20])."""
    return _moments_to_latents(vae_encode_moments(vae, images), vae.cfg, generator)


def vae_decode(vae: FluxVAE, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents (B, h, w, C_lat) NHWC -> images (B, H, W, 3) in [-1, 1]."""
    cfg, dec = vae.cfg, vae.decoder
    z = latents / cfg.scaling_factor + cfg.shift_factor
    x = dec.conv_in(z.permute(0, 3, 1, 2))
    x = dec.mid_block(x)
    for block in dec.up_blocks:
        x = block(x)
    x = F.silu(group_norm(x, dec.conv_norm_out))
    return dec.conv_out(x).permute(0, 2, 3, 1)


def _blend_v(top: torch.Tensor, bottom: torch.Tensor, extent: int) -> torch.Tensor:
    """Cross-fade `bottom`'s first rows with `top`'s last rows (NHWC)."""
    extent = min(extent, top.shape[1], bottom.shape[1])
    if extent <= 0:
        return bottom
    w = (torch.arange(extent, dtype=torch.float32, device=bottom.device) / extent)[None, :, None, None]
    mixed = top[:, -extent:].float() * (1.0 - w) + bottom[:, :extent].float() * w
    return torch.cat([mixed.to(bottom.dtype), bottom[:, extent:]], dim=1)


def _blend_h(left: torch.Tensor, right: torch.Tensor, extent: int) -> torch.Tensor:
    """Cross-fade `right`'s first columns with `left`'s last columns (NHWC)."""
    extent = min(extent, left.shape[2], right.shape[2])
    if extent <= 0:
        return right
    w = (torch.arange(extent, dtype=torch.float32, device=right.device) / extent)[None, None, :, None]
    mixed = left[:, :, -extent:].float() * (1.0 - w) + right[:, :, :extent].float() * w
    return torch.cat([mixed.to(right.dtype), right[:, :, extent:]], dim=2)


def _tiled_grid(full_fn, x: torch.Tensor, tile: int, overlap_factor: float, tile_out: int) -> torch.Tensor:
    """Split NHWC `x` into `tile`-sized windows at stride tile * (1 - overlap),
    map each through `full_fn` (a `tile` window -> a `tile_out` window), cross-fade
    neighbours over the overlap and crop, so the kept extents add up to x's
    extent * tile_out / tile."""
    _, h, w, _ = x.shape
    stride = int(tile * (1.0 - overlap_factor))
    if not 0 < stride <= tile:
        raise ValueError(f"overlap_factor {overlap_factor} leaves no stride")
    blend = int(tile_out * overlap_factor)
    row_limit = tile_out - blend
    rows = [[full_fn(x[:, i : i + tile, j : j + tile]) for j in range(0, w, stride)]
            for i in range(0, h, stride)]
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, t in enumerate(row):
            if i > 0:
                t = _blend_v(rows[i - 1][j], t, blend)
            if j > 0:
                t = _blend_h(row[j - 1], t, blend)
            out_row.append(t[:, :row_limit, :row_limit])
        out_rows.append(torch.cat(out_row, dim=2))
    return torch.cat(out_rows, dim=1)


def vae_decode_tiled(vae: FluxVAE, latents: torch.Tensor, tile_latent: int = 64,
                     overlap_factor: float = 0.25) -> torch.Tensor:
    """`vae_decode` in overlapping `tile_latent`-sized latent tiles (64 latents =
    512 px, diffusers' default tile). An input of one tile takes the untiled path."""
    _, h, w, _ = latents.shape
    if h <= tile_latent and w <= tile_latent:
        return vae_decode(vae, latents)
    scale = vae.cfg.downscale
    tile_out = tile_latent * scale
    stride, blend = int(tile_latent * (1.0 - overlap_factor)), int(tile_out * overlap_factor)
    # each kept tile extent (tile_out - blend) must be the latent stride upscaled,
    # or the output is silently mis-sized or shifted
    if stride * scale != tile_out - blend:
        raise ValueError(
            f"tile_latent {tile_latent} / overlap {overlap_factor} misalign: kept extent "
            f"{tile_out - blend}px != stride {stride}*{scale}px; pick an overlap where "
            "int(tile*(1-f))*scale == tile*scale - int(tile*scale*f)")
    return _tiled_grid(lambda z: vae_decode(vae, z), latents, tile_latent, overlap_factor, tile_out)


def vae_encode_tiled(vae: FluxVAE, images: torch.Tensor, generator: torch.Generator | None = None,
                     tile_sample: int = 512, overlap_factor: float = 0.25) -> torch.Tensor:
    """`vae_encode` in overlapping `tile_sample`-sized image tiles: the moments
    are blended across the seams (diffusers' `tiled_encode`), then sampled or
    taken at the mode once."""
    _, h, w, _ = images.shape
    if h <= tile_sample and w <= tile_sample:
        return vae_encode(vae, images, generator)
    s = vae.cfg.downscale
    if tile_sample % s or int(tile_sample * (1.0 - overlap_factor)) % s:
        raise ValueError(f"tile_sample {tile_sample} / overlap {overlap_factor} must keep tile and "
                         f"stride multiples of the VAE scale {s} so latent tiles align")
    moments = _tiled_grid(lambda t: vae_encode_moments(vae, t), images, tile_sample, overlap_factor,
                          tile_sample // s)
    return _moments_to_latents(moments, vae.cfg, generator)
