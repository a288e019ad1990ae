"""The FLUX sampling loop.

Counterpart of `reflectionflow_tpu/sampler/generate.py::denoise`, dense
branch: a Python loop over the precomputed sigma schedule where the reference
has a `lax.scan`, with the optional condition stream and image CFG (the
conditional and black-condition branches as one doubled batch). The
velocity-cache modes (ROADMAP slice 5) are not ported yet.
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
    cond: torch.Tensor | None = None,  # (B, L_c, C)
    cond_ids: torch.Tensor | None = None,  # (L_c, 3)
    cond_empty: torch.Tensor | None = None,  # (B, L_c, C) black-image tokens
    cond_dit_params: FluxDiT | None = None,  # the cond stream's (LoRA-folded) model
    image_guidance_scale: float = 1.0,
    c_factor: float | None = None,
    union_cond_attn: bool = True,
    add_cond_attn: bool = False,
    attn_impl: str = "xla",
    rope_layout: str = "pair",
) -> torch.Tensor:
    """Run the Euler loop; returns the final packed latents (B, L_img, C).

    As the reference: the timestep is cast to the latent dtype, the
    guidance is in the latent dtype, and the update runs in fp32. With
    `cond_empty` (image CFG) each step is one forward over the doubled batch
    [cond | cond_empty] with guidance [g | 1], combined as
    v_unc + image_guidance_scale * (v_cond - v_unc)."""
    B = latents.shape[0]
    dtype, device = latents.dtype, latents.device
    guidance = torch.full((B,), guidance_scale, dtype=dtype, device=device)
    image_cfg = cond_empty is not None
    if image_cfg:
        guidance = torch.cat([guidance, torch.ones_like(guidance)])
        cond = torch.cat([cond, cond_empty])
        txt, pooled = torch.cat([txt, txt]), torch.cat([pooled, pooled])
    cond_kw = {}
    if cond is not None:
        cond_kw = dict(cond=cond, cond_ids=cond_ids, c_factor=c_factor,
                       union_cond_attn=union_cond_attn, add_cond_attn=add_cond_attn,
                       cond_params=cond_dit_params)
    sig = sigmas.detach().cpu().numpy().astype(np.float32)
    for i in range(num_steps):
        lat = torch.cat([latents, latents]) if image_cfg else latents
        timestep = torch.full((lat.shape[0],), float(sig[i]), dtype=dtype, device=device)
        v = dit(lat, txt, pooled, timestep, img_ids, txt_ids,
                guidance=guidance if dit.cfg.guidance_embeds else None, attn_impl=attn_impl,
                rope_layout=rope_layout, **cond_kw)
        if image_cfg:
            v_cond, v_unc = v[:B], v[B:]
            v = v_unc + torch.tensor(image_guidance_scale, dtype=v.dtype) * (v_cond - v_unc)
        delta = float(sig[i + 1] - sig[i])  # fp32 difference, as the reference
        latents = (latents.float() + delta * v.float()).to(dtype)
    return latents


def make_schedule(num_steps: int, image_seq_len: int) -> torch.Tensor:
    """Dynamic-shifted sigma array (host-precomputed, fp32, on the CPU)."""
    return torch.from_numpy(FlowMatchSchedule.create(num_steps, image_seq_len).sigmas)
