"""Condition stream encoding ("cot" conditioning, OminiControl style).

Counterpart of `reflectionflow_tpu/sampler/condition.py`: a conditioning
image is VAE-encoded (the posterior's mode), packed into 2x2 latent tokens
and given RoPE ids offset by `position_delta` (ReflectionFlow uses
`(0, -condition_size // 16)`). `empty=True` encodes one black image and
broadcasts it, the unconditional branch of image CFG.

The identity preprocessors are ported. The ones that need OpenCV or a depth
model (`canny`, `coloring`, `deblurring`, `depth`) raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..models.flux.latents import pack_latents
from ..models.flux.rope import make_image_ids
from ..models.flux.vae import FluxVAE, vae_encode, vae_encode_tiled

# condition_type -> type id, as the JAX package
CONDITION_TYPE_IDS = {
    "depth": 0,
    "canny": 1,
    "subject": 4,
    "coloring": 6,
    "deblurring": 7,
    "depth_pred": 8,
    "fill": 9,
    "sr": 10,
    "cartoon": 11,
    "cot": 12,
}


def _not_ported(name: str) -> Callable[[np.ndarray], np.ndarray]:
    def fn(img: np.ndarray) -> np.ndarray:
        raise NotImplementedError(
            f"the {name!r} condition preprocessor needs OpenCV or a depth model, which the "
            "port's machine lacks: ROADMAP queue 1 (condition preprocessors)")
    return fn


# preprocessors: image (H, W, 3) uint8 -> image (H, W, 3) uint8
PREPROCESSORS: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "cot": lambda img: img,
    "subject": lambda img: img,
    "fill": lambda img: img,
    "sr": lambda img: img,
    "cartoon": lambda img: img,
    "depth_pred": lambda img: img,  # precomputed depth map passed through
    **{name: _not_ported(name) for name in ("depth", "canny", "coloring", "deblurring")},
}


@dataclass
class Condition:
    """A conditioning image and its token-grid placement."""

    condition_type: str = "cot"
    image: np.ndarray | None = None  # (H, W, 3) uint8
    position_delta: tuple[int, int] = (0, 0)

    @property
    def type_id(self) -> int:
        return CONDITION_TYPE_IDS[self.condition_type]

    def preprocess(self) -> np.ndarray:
        return PREPROCESSORS[self.condition_type](self.image)


def encode_conditions(conditions: list[Condition], vae: FluxVAE, dtype=torch.bfloat16,
                      empty: bool = False, tiled: bool = False):
    """Batch-encode one condition per candidate -> (cond tokens (B, L_c, 4 C),
    cond ids (L_c, 3)) on the VAE's device. All conditions share size and
    position_delta. `tiled` encodes through `vae_encode_tiled` (diffusers'
    enable_vae_tiling covers encode too; a no-op at conditions of <= 512 px)."""
    encode = vae_encode_tiled if tiled else vae_encode
    device = next(vae.parameters()).device
    if empty:
        # black image: encode one frame and broadcast it (an all-identical batch)
        H, W = conditions[0].preprocess().shape[:2]
        x = torch.full((1, H, W, 3), -1.0, dtype=dtype, device=device)
        latents = encode(vae, x)
        latents = latents.expand(len(conditions), *latents.shape[1:])
    else:
        imgs = np.stack([c.preprocess() for c in conditions])  # (B, H, W, 3) uint8
        x = torch.from_numpy(imgs.astype(np.float32) / 127.5 - 1.0).to(device, dtype)
        latents = encode(vae, x)  # deterministic (mode)
    ids = make_image_ids(latents.shape[1] // 2, latents.shape[2] // 2,
                         position_delta=conditions[0].position_delta)
    return pack_latents(latents).to(dtype), torch.from_numpy(ids).to(device)


def cot_position_delta(condition_size: int) -> tuple[int, int]:
    """ReflectionFlow's delta for the 'cot' condition."""
    return (0, -condition_size // 16)
