"""FLUX text encoders: T5 v1.1 encoder (sequence states) + CLIP-L (pooled).

Counterpart of `reflectionflow_tpu/models/flux/text.py`. The modules hold
parameters under transformers' names (`encoder.block.{i}.layer.0.SelfAttention.q`,
`text_model.encoder.layers.{i}.self_attn.q_proj`, ...), the names
`reflectionflow_tpu/utils/hf_convert.py::convert_t5_state` and
`convert_clip_text_state` read; `t5_encode` and `clip_text_encode` compute.
T5's linears may be `ops.quant.QuantLinear`s (the w8a16 serving profile) or
`ops.quant.NF4Linear`s (the NF4 co-residency profile, `quantize_params_int4`),
as the JAX T5 runs its matmuls through `dit.linear`.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...config import CLIPTextConfig, T5Config

# ---------------------------------------------------------------------------
# T5 v1.1 encoder
# ---------------------------------------------------------------------------


class _T5Norm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))


def _t5_ln(x: torch.Tensor, norm: _T5Norm, eps: float) -> torch.Tensor:
    """T5 LayerNorm: RMS only, no mean subtraction, no bias."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * norm.weight


class _T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)


class _T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer_norm = _T5Norm(cfg.d_model)
        self.SelfAttention = _T5SelfAttention(cfg, has_bias)


class _T5DenseGated(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class _T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.layer_norm = _T5Norm(cfg.d_model)
        self.DenseReluDense = _T5DenseGated(cfg)


class _T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_T5LayerSelfAttention(cfg, has_bias), _T5LayerFF(cfg)])


class _T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        # only block 0 owns the relative-position bias table; all layers share it
        self.block = nn.ModuleList(_T5Block(cfg, i == 0) for i in range(cfg.num_layers))
        self.final_layer_norm = _T5Norm(cfg.d_model)


# port module name -> JAX tree path (`t5_encoder_init`), outside and inside the blocks
_T5_TOP_PATHS = {
    "shared": "embed", "encoder.final_layer_norm": "final_ln",
    "encoder.block.0.layer.0.SelfAttention.relative_attention_bias": "rel_bias",
}
_T5_BLOCK_PATHS = {
    "layer.0.layer_norm": "ln1", "layer.1.layer_norm": "ln2",
    **{f"layer.0.SelfAttention.{n}": n for n in ("q", "k", "v", "o")},
    "layer.1.DenseReluDense.wi_0": "wi0", "layer.1.DenseReluDense.wi_1": "wi1",
    "layer.1.DenseReluDense.wo": "wo",
}


class T5Encoder(nn.Module):
    """Parameters of a T5 v1.1 encoder (T5EncoderModel names)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _T5Stack(cfg)

    def jax_path(self, name: str):
        """Module name -> (JAX tree path, block index or None, blocks stacked)."""
        if name in _T5_TOP_PATHS:
            return _T5_TOP_PATHS[name], None, 1
        m = re.fullmatch(r"encoder\.block\.(\d+)\.(.+)", name)
        return f"blocks/{_T5_BLOCK_PATHS[m[2]]}", int(m[1]), self.cfg.num_layers


def _t5_relative_buckets(rel_pos: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional relative-position bucketing (T5 convention)."""
    num_buckets //= 2
    ret = (rel_pos > 0).astype(np.int64) * num_buckets
    n = np.abs(rel_pos)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, n, large)


def t5_position_bias(t5: T5Encoder, seq_len: int) -> torch.Tensor:
    """(1, heads, L, L) additive bias shared by all layers."""
    cfg = t5.cfg
    pos = np.arange(seq_len, dtype=np.int64)
    buckets = _t5_relative_buckets(pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
                                   cfg.relative_attention_max_distance)
    table = t5.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
    bias = table[torch.from_numpy(buckets).to(table.device)]  # (L, L, heads)
    return bias.permute(2, 0, 1)[None]


def t5_encode(t5: T5Encoder, input_ids: torch.Tensor,
              attention_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, L) token ids -> (B, L, d_model) final hidden states. Attention is
    unscaled (T5 folds 1/sqrt(d) into its init); the FFN is gated tanh-GELU."""
    cfg = t5.cfg
    B, L = input_ids.shape
    eps = cfg.layer_norm_epsilon
    h = t5.shared.weight[input_ids]
    bias = t5_position_bias(t5, L).float()
    if attention_mask is not None:
        bias = bias + torch.where(attention_mask[:, None, None, :].bool(), 0.0, -1e9)
    for blk in t5.encoder.block:
        sa, ff = blk.layer[0], blk.layer[1]
        att = sa.SelfAttention
        x = _t5_ln(h, sa.layer_norm, eps)
        q = att.q(x).unflatten(-1, (cfg.num_heads, cfg.d_kv))
        k = att.k(x).unflatten(-1, (cfg.num_heads, cfg.d_kv))
        v = att.v(x).unflatten(-1, (cfg.num_heads, cfg.d_kv))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
        probs = torch.softmax(logits, dim=-1).to(h.dtype)
        h = h + att.o(torch.einsum("bhqk,bkhd->bqhd", probs, v).flatten(2))
        x = _t5_ln(h, ff.layer_norm, eps)
        d = ff.DenseReluDense
        h = h + d.wo(F.gelu(d.wi_0(x), approximate="tanh") * d.wi_1(x))
    return _t5_ln(h, t5.encoder.final_layer_norm, eps)


# ---------------------------------------------------------------------------
# CLIP text encoder (pooled output)
# ---------------------------------------------------------------------------


class _CLIPAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)


class _CLIPMLP(nn.Module):
    def __init__(self, d: int, m: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, m), nn.Linear(m, d)


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d)
        self.self_attn = _CLIPAttention(d)
        self.layer_norm2 = nn.LayerNorm(d)
        self.mlp = _CLIPMLP(d, cfg.intermediate_size)


class _CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(_CLIPLayer(cfg) for _ in range(cfg.num_layers))


class _CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _CLIPEmbeddings(cfg)
        self.encoder = _CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size)


class CLIPTextEncoder(nn.Module):
    """Parameters of a CLIP text tower (CLIPTextModel names)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _CLIPTextTransformer(cfg)


def _ln(x: torch.Tensor, norm: nn.LayerNorm, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * norm.weight + norm.bias


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def clip_text_encode(clip: CLIPTextEncoder, input_ids: torch.Tensor):
    """(B, L) -> (last_hidden (B, L, d), pooled (B, d)); pooled is the
    final-LN hidden state at the first EOS position."""
    cfg, tm = clip.cfg, clip.text_model
    B, L = input_ids.shape
    nH = cfg.num_heads
    D = cfg.hidden_size // nH
    eps = cfg.layer_norm_eps
    emb = tm.embeddings
    h = emb.token_embedding.weight[input_ids] + emb.position_embedding.weight[:L][None]
    causal = torch.triu(torch.full((L, L), -math.inf, device=h.device), diagonal=1)[None, None]
    for layer in tm.encoder.layers:
        a = layer.self_attn
        x = _ln(h, layer.layer_norm1, eps)
        q = a.q_proj(x).unflatten(-1, (nH, D))
        k = a.k_proj(x).unflatten(-1, (nH, D))
        v = a.v_proj(x).unflatten(-1, (nH, D))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5) + causal
        probs = torch.softmax(logits, dim=-1).to(h.dtype)
        h = h + a.out_proj(torch.einsum("bhqk,bkhd->bqhd", probs, v).flatten(2))
        x = _ln(h, layer.layer_norm2, eps)
        h = h + layer.mlp.fc2(quick_gelu(layer.mlp.fc1(x)))
    h = _ln(h, tm.final_layer_norm, eps)
    if cfg.eos_token_id == 2:
        # legacy CLIP pooling (published CLIP configs store eos=2): the
        # highest token id is the first end-of-text token
        eos_pos = torch.argmax(input_ids, dim=1)
    else:
        eos_pos = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=1)
    pooled = h[torch.arange(B, device=h.device), eos_pos]
    return h, pooled
