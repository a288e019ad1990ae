"""Qwen2.5 decoder LM with multimodal 3-D RoPE (M-RoPE) and a KV cache.

Counterpart of `reflectionflow_tpu/models/qwen_vl/lm.py`: GQA with q/k/v
biases, SiLU-gated MLP, RMSNorm and rotate-half RoPE whose frequency axis is
split into (t, h, w) sections. Parameters carry transformers' names
(`model.layers.{i}.self_attn.q_proj`, `model.norm`, ...), so a Qwen2.5-VL
snapshot loads with `load_state_dict`.

Attention is PyTorch's SDPA (GQA through `enable_gqa`) with the JAX package's
additive mask: 0 where a key is visible, -1e9 where it is not, so a row that
sees no key (a left-pad query) gets finite uniform weights as in the
reference, never NaN.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...config import QwenLMConfig

MASKED = -1e9  # the reference's additive bias on a hidden key


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, in fp32, result in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


class _Attention(nn.Module):
    def __init__(self, cfg: QwenLMConfig):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(H, cfg.num_heads * D)
        self.k_proj = nn.Linear(H, cfg.num_kv_heads * D)
        self.v_proj = nn.Linear(H, cfg.num_kv_heads * D)
        self.o_proj = nn.Linear(cfg.num_heads * D, H, bias=False)


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, bias: bool):
        super().__init__()
        self.gate_proj = nn.Linear(dim, hidden, bias=bias)
        self.up_proj = nn.Linear(dim, hidden, bias=bias)
        self.down_proj = nn.Linear(hidden, dim, bias=bias)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: QwenLMConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = _Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = _MLP(cfg.hidden_size, cfg.intermediate_size, bias=False)


class QwenLM(nn.Module):
    """`model.*` of a Qwen2.5-VL checkpoint: embeddings, decoder layers, final norm."""

    def __init__(self, cfg: QwenLMConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(_DecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


def mrope_tables(position_ids: torch.Tensor, cfg: QwenLMConfig):
    """position_ids (3, B, L) [t, h, w] -> (cos, sin), each (B, L, D) fp32.
    Section s of `mrope_section` takes its angles from stream s; the full-dim
    tables are the half tables twice (rotate-half layout)."""
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, half, dtype=torch.float32,
                                                       device=position_ids.device) / half))
    angles = position_ids.float()[..., None] * inv_freq  # (3, B, L, half)
    sections = np.cumsum(np.asarray(cfg.mrope_section))
    if sections[-1] != half:
        raise ValueError(f"mrope_section {cfg.mrope_section} must sum to head_dim // 2 = {half}")
    parts, start = [], 0
    for stream, end in enumerate(sections):
        parts.append(angles[stream, :, :, start:end])
        start = int(end)
    ang = torch.cat(parts, dim=-1)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope_rh(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in fp32: x (B, L, H, D), tables (B, L, D)."""
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.float()
    return (xf * c + rotate_half(xf) * s).to(x.dtype)


def init_kv_cache(cfg: QwenLMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device: torch.device | str = "cpu") -> dict:
    """{"k", "v": (layers, B, max_len, kv_heads, D) zeros, "len": 0}; the caller
    may add "pad" (B,) left-pad counts, whose slots stay masked."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}


def _attention_bias(B: int, L: int, attention_mask, kv_cache, device) -> torch.Tensor:
    """The additive bias (B or 1, 1, L, S) of the reference's two paths."""
    if kv_cache is not None:
        S, offset = kv_cache["k"].shape[2], kv_cache["len"]
        kpos = torch.arange(S, device=device)[None, :]
        qpos = offset + torch.arange(L, device=device)[:, None]
        mask = (kpos <= qpos) & (kpos < offset + L)  # (L, S)
        mask = mask[None, None]
        if "pad" in kv_cache:  # left-padded batched decode: pad slots stay hidden
            notpad = kpos >= kv_cache["pad"][:, None]  # (B, S)
            mask = mask & notpad[:, None, None, :]
        return torch.where(mask, 0.0, MASKED)
    causal = torch.ones(L, L, dtype=torch.bool, device=device).tril()
    bias = torch.where(causal, 0.0, MASKED)[None, None]
    if attention_mask is not None:
        pad = torch.where(attention_mask[:, None, None, :].bool(), 0.0, MASKED)
        bias = bias + pad
    return bias


def _decoder_layer(layer: _DecoderLayer, cfg: QwenLMConfig, h: torch.Tensor, cos, sin, bias,
                   cache=None) -> torch.Tensor:
    """One decoder layer. `cache` = (k slots, v slots, offset) of this layer:
    the new positions are written at `offset` in place and attend to every
    slot."""
    nH, nKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a = layer.self_attn
    x = layer.input_layernorm(h)
    q = apply_rope_rh(a.q_proj(x).unflatten(-1, (nH, D)), cos, sin)
    k = apply_rope_rh(a.k_proj(x).unflatten(-1, (nKV, D)), cos, sin)
    v = a.v_proj(x).unflatten(-1, (nKV, D))
    if cache is not None:
        k_slots, v_slots, offset = cache
        k_slots[:, offset : offset + h.shape[1]] = k
        v_slots[:, offset : offset + h.shape[1]] = v
        k, v = k_slots, v_slots
    attn = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          attn_mask=bias, enable_gqa=nH != nKV)
    h = h + a.o_proj(attn.transpose(1, 2).flatten(2))
    return h + layer.mlp(layer.post_attention_layernorm(h))


def qwen_lm_apply(lm: QwenLM, lm_head: nn.Module | None, inputs_embeds: torch.Tensor,
                  position_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                  kv_cache: dict | None = None, return_hidden: bool = False, remat: bool = False):
    """-> (logits, or the final-norm hidden states with `return_hidden`, cache).

    Without a cache: causal self-attention over L, `attention_mask` (B, L) 1 =
    valid. With a cache: the L new positions are written at `cache["len"]` in
    place and attend to every filled slot; the cache comes back with "len"
    advanced. `lm_head` None ties the output projection to the embeddings.
    `remat` (the training path; no cache) recomputes each layer in the
    backward instead of saving its activations (`torch.utils.checkpoint`), so a
    quantized base's dequantized weights are not kept for the backward."""
    cfg = lm.cfg
    B, L, _ = inputs_embeds.shape
    cos, sin = mrope_tables(position_ids, cfg)
    h = inputs_embeds
    bias = _attention_bias(B, L, attention_mask, kv_cache, h.device).to(h.dtype)
    offset = kv_cache["len"] if kv_cache is not None else 0
    remat = remat and kv_cache is None and torch.is_grad_enabled()
    for i, layer in enumerate(lm.layers):
        if remat:
            h = checkpoint(_decoder_layer, layer, cfg, h, cos, sin, bias, use_reentrant=False)
        else:
            cache = None if kv_cache is None else (kv_cache["k"][i], kv_cache["v"][i], offset)
            h = _decoder_layer(layer, cfg, h, cos, sin, bias, cache)
    if kv_cache is not None:
        kv_cache["len"] = offset + L
    h = lm.norm(h)
    if return_hidden:
        return h, kv_cache
    logits = lm_head(h) if lm_head is not None else h @ lm.embed_tokens.weight.t()
    return logits, kv_cache
