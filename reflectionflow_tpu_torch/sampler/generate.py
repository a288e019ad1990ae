"""The FLUX sampling loop.

Counterpart of `reflectionflow_tpu/sampler/generate.py::denoise`, dense
text-to-image branch: a Python loop over the precomputed sigma schedule
where the reference has a `lax.scan`. The velocity-cache modes (ROADMAP slice
5) and image CFG with a cond stream (slice 3) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.flux.dit import FluxDiT
from .scheduler import FlowMatchSchedule


@torch.no_grad()
def denoise(
    dit: FluxDiT,
    latents: torch.Tensor,  # (B, L_img, C) packed noise
    txt: torch.Tensor,  # (B, L_txt, text_dim)
    pooled: torch.Tensor,  # (B, pooled_dim)
    img_ids: torch.Tensor,  # (L_img, 3)
    txt_ids: torch.Tensor,  # (L_txt, 3)
    sigmas: torch.Tensor,  # (num_steps + 1,) fp32
    guidance_scale: float,
    num_steps: int,
    attn_impl: str = "xla",
    rope_layout: str = "pair",
) -> torch.Tensor:
    """Run the Euler loop; returns the final packed latents (B, L_img, C).

    As the reference: the timestep is cast to the latent dtype, the
    guidance is in the latent dtype, and the update runs in fp32."""
    B = latents.shape[0]
    dtype, device = latents.dtype, latents.device
    guidance = torch.full((B,), guidance_scale, dtype=dtype, device=device)
    sig = sigmas.detach().cpu().numpy().astype(np.float32)
    for i in range(num_steps):
        timestep = torch.full((B,), float(sig[i]), dtype=dtype, device=device)
        v = dit(latents, txt, pooled, timestep, img_ids, txt_ids,
                guidance=guidance if dit.cfg.guidance_embeds else None, attn_impl=attn_impl,
                rope_layout=rope_layout)
        delta = float(sig[i + 1] - sig[i])  # fp32 difference, as the reference
        latents = (latents.float() + delta * v.float()).to(dtype)
    return latents


def make_schedule(num_steps: int, image_seq_len: int) -> torch.Tensor:
    """Dynamic-shifted sigma array (host-precomputed, fp32, on the CPU)."""
    return torch.from_numpy(FlowMatchSchedule.create(num_steps, image_seq_len).sigmas)
