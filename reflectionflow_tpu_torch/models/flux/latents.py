"""Packed-latent layout helpers.

Counterpart of `reflectionflow_tpu/models/flux/latents.py`. FLUX packs the
16-channel VAE latent grid into 2x2 patches: a (B, h, w, C) latent grid (NHWC,
the JAX package's layout) becomes (B, h/2 * w/2, 4C) tokens.
"""

from __future__ import annotations

import torch

from ...utils import threefry


def latent_tokens(height_px: int, width_px: int, vae_downscale: int = 8) -> tuple[int, int]:
    """(tokens_y, tokens_x) of the packed grid for an image size in pixels."""
    return height_px // (vae_downscale * 2), width_px // (vae_downscale * 2)


def pack_latents(lat: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) latent grid -> (B, h/2*w/2, C*4) packed tokens, features
    ordered channel-major, then the 2x2 patch."""
    B, h, w, C = lat.shape
    x = lat.reshape(B, h // 2, 2, w // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, (h // 2) * (w // 2), C * 4)


def unpack_latents(tokens: torch.Tensor, tokens_y: int, tokens_x: int) -> torch.Tensor:
    """(B, L, C*4) -> (B, h, w, C) latent grid (inverse of pack_latents)."""
    B, L, F = tokens.shape
    C = F // 4
    x = tokens.reshape(B, tokens_y, tokens_x, C, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, tokens_y * 2, tokens_x * 2, C)


def draw_packed_noise(
    key: threefry.Key,
    batch: int,
    height_px: int,
    width_px: int,
    channels: int = 16,
    dtype=torch.bfloat16,
    vae_downscale: int = 8,
    device=None,
) -> torch.Tensor:
    """Seeded initial latents, already packed: (B, L, channels*4), the JAX
    package's `jax.random.normal(key, ...)` in fp32 (`utils/threefry.py`),
    drawn on `device`."""
    ty, tx = latent_tokens(height_px, width_px, vae_downscale)
    noise = threefry.normal(key, (batch, ty * 2, tx * 2, channels), device=device)
    return pack_latents(noise).to(dtype)
