"""FLUX 3-axis rotary position embedding.

Counterpart of `reflectionflow_tpu/models/flux/rope.py`. Position ids are
(L, 3) = (type, y, x); each axis gets its own frequency band of size
`axes_dims[i]` (FLUX.1: 16/56/56 summing to head_dim 128). The cos/sin tables
are fp32 with each frequency repeated twice, and the rotation acts on
interleaved (even, odd) element pairs, the convention of the published
weights. The serving layout ("split") permutes each head to evens-then-odds
(`rope_split_perm`), so the rotation partner of element i is i + D/2.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_tables(ids: torch.Tensor, axes_dims: tuple[int, ...], theta: float = 10000.0):
    """(L, 3) positions -> (cos, sin), each (L, head_dim) float32."""
    ids = ids.to(torch.float32)
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes_dims):
        exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device) / dim
        freqs = 1.0 / (theta ** exponent)
        angles = ids[:, axis : axis + 1] * freqs[None, :]
        angles = torch.repeat_interleave(angles, 2, dim=-1)  # [f0, f0, f1, f1, ...]
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, L, H, D) by (L, D) tables in fp32: pairs (x_even, x_odd) ->
    (x_even*cos - x_odd*sin, x_odd*cos + x_even*sin)."""
    xf = x.float()
    pairs = xf.unflatten(-1, (-1, 2))
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return (xf * c + rotated * s).to(x.dtype)


def rope_split_perm(head_dim: int) -> np.ndarray:
    """Permutation old -> new ordering of a head: evens, then odds."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def apply_rope_split(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, L, H, D) in the half-split layout by tables permuted with
    `rope_split_perm`. fp32 tables rotate in fp32; tables in x's dtype (bf16 on
    the serving path) select the all-bf16 rotation, as the JAX package."""
    xf = x if cos.dtype == x.dtype else x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return (xf * c + rotated * s).to(x.dtype)


def make_image_ids(height_tokens: int, width_tokens: int, position_delta=(0, 0)) -> np.ndarray:
    """(h*w, 3) grid ids for packed 2x2 latents: (0, y+dy, x+dx)."""
    ys, xs = np.meshgrid(np.arange(height_tokens), np.arange(width_tokens), indexing="ij")
    ids = np.zeros((height_tokens * width_tokens, 3), dtype=np.float32)
    ids[:, 1] = ys.reshape(-1) + position_delta[0]
    ids[:, 2] = xs.reshape(-1) + position_delta[1]
    return ids


def make_text_ids(seq_len: int) -> np.ndarray:
    """Text tokens sit at the origin: all-zero ids."""
    return np.zeros((seq_len, 3), dtype=np.float32)
