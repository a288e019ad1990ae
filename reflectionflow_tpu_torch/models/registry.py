"""Generator-family latent-preparation registry.

Counterpart of `reflectionflow_tpu/models/registry.py`: per-family latent
channels, VAE downscale and packing (FLUX packed 2x2 / SD / SDXL / SD3). FLUX
is the only family with a pipeline; the seam lets a new family plug in with
one entry.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils import threefry
from .flux.latents import latent_tokens, pack_latents


@dataclass(frozen=True)
class LatentSpec:
    channels: int
    vae_downscale: int
    packed: bool  # FLUX-style 2x2 token packing

    def prepare(self, key: threefry.Key, batch: int, height: int, width: int,
                dtype=torch.bfloat16, device=None) -> torch.Tensor:
        """Initial noise on `device`, the JAX package's `jax.random.normal(key,
        ...)` in fp32: (B, L, 4C) packed tokens for a packed family, else the
        (B, h, w, C) grid."""
        h = height // self.vae_downscale
        w = width // self.vae_downscale
        noise = threefry.normal(key, (batch, h, w, self.channels), device=device)
        if self.packed:
            return pack_latents(noise).to(dtype)
        return noise.to(dtype)

    def seq_len(self, height: int, width: int) -> int:
        if self.packed:
            ty, tx = latent_tokens(height, width, self.vae_downscale)
            return ty * tx
        return (height // self.vae_downscale) * (width // self.vae_downscale)


LATENT_SPECS: dict[str, LatentSpec] = {
    "flux": LatentSpec(channels=16, vae_downscale=8, packed=True),
    "sd": LatentSpec(channels=4, vae_downscale=8, packed=False),
    "sdxl": LatentSpec(channels=4, vae_downscale=8, packed=False),
    "sd3": LatentSpec(channels=16, vae_downscale=8, packed=False),
}

# model name (hub id substring) -> family, first match wins
MODEL_FAMILY_MAP = {
    "FLUX": "flux",
    "stable-diffusion-3": "sd3",
    "stable-diffusion-xl": "sdxl",
    "stable-diffusion": "sd",
}


def family_for_model(name: str) -> str:
    for needle, family in MODEL_FAMILY_MAP.items():
        if needle.lower() in name.lower():
            return family
    return "flux"


def register_family(name: str, spec: LatentSpec) -> None:
    LATENT_SPECS[name] = spec


def get_latent_spec(family: str) -> LatentSpec:
    return LATENT_SPECS[family]
