"""Deterministic candidate seeding.

Counterpart of `reflectionflow_tpu/search/seeds.py`. `candidate_seeds` is the
same numpy PCG64 function, so both packages name the same seeds; the noise a
seed turns into differs, because `torch.Generator` is not `jax.random`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.flux.latents import draw_packed_noise


def candidate_seeds(run_seed: int, prompt_idx: int, round_idx: int, n: int) -> list[int]:
    rng = np.random.Generator(np.random.PCG64([run_seed, prompt_idx, round_idx]))
    return [int(s) for s in rng.integers(0, 2**31 - 1, size=n)]


def seeds_to_latents(seeds, height, width, channels, dtype, vae_downscale=8, device="cpu"):
    """One packed-noise latent per seed, concatenated on the batch axis."""
    lats = [
        draw_packed_noise(torch.Generator(device=device).manual_seed(s), 1, height, width,
                          channels, dtype, vae_downscale)
        for s in seeds
    ]
    return torch.cat(lats, dim=0)
