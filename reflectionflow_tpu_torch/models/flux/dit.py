"""FLUX.1 rectified-flow DiT in PyTorch: the plain text-to-image forward.

Counterpart of `reflectionflow_tpu/models/flux/dit.py::flux_dit_apply` with no
cond stream, unfused q/k/v and the interleaved-pair RoPE layout: 19 double-
stream blocks, 38 single-stream blocks (FLUX.1-dev), AdaLN-Zero modulation
from the (timestep, guidance, pooled CLIP) embedding, and attention through
`ops.attention.joint_attention`, whose "pallas" impl is kernel K1.

Parameter names follow diffusers' FluxTransformer2DModel
(`transformer_blocks.{i}.attn.to_q`, `norm1.linear`, ...), the names
`reflectionflow_tpu/utils/hf_convert.py::convert_flux_dit_state` reads, so a
`state_dict()` of this module feeds that converter unchanged and published
checkpoints load by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...config import FluxDiTConfig
from ...ops.attention import joint_attention
from ...ops.norms import adaln_modulate, layer_norm, rms_norm
from .rope import apply_rope, rope_tables


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal features, cos first. t: (B,) already scaled by 1000."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class _MLPEmbed(nn.Module):
    """linear_2(silu(linear_1(x))): diffusers TimestepEmbedding naming."""

    def __init__(self, d_in: int, d_hidden: int):
        super().__init__()
        self.linear_1 = nn.Linear(d_in, d_hidden)
        self.linear_2 = nn.Linear(d_hidden, d_hidden)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _TimeTextEmbed(nn.Module):
    def __init__(self, cfg: FluxDiTConfig):
        super().__init__()
        H = cfg.hidden_size
        self.timestep_embedder = _MLPEmbed(cfg.time_freq_dim, H)
        self.text_embedder = _MLPEmbed(cfg.pooled_dim, H)
        if cfg.guidance_embeds:
            self.guidance_embedder = _MLPEmbed(cfg.time_freq_dim, H)


class _Modulation(nn.Module):
    """`norm.linear`: the AdaLN projection of silu(temb) into n chunks."""

    def __init__(self, hidden: int, n: int):
        super().__init__()
        self.n = n
        self.linear = nn.Linear(hidden, n * hidden)

    def forward(self, temb):
        return self.linear(F.silu(temb)).chunk(self.n, dim=-1)


class _RMSScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class _Attention(nn.Module):
    """Per-stream q/k/v projections and QK-norm scales (diffusers names);
    `dual` adds the txt-stream projections and both out projections."""

    def __init__(self, cfg: FluxDiTConfig, dual: bool):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        self.to_q, self.to_k, self.to_v = nn.Linear(H, H), nn.Linear(H, H), nn.Linear(H, H)
        self.norm_q, self.norm_k = _RMSScale(D), _RMSScale(D)
        if dual:
            self.add_q_proj = nn.Linear(H, H)
            self.add_k_proj = nn.Linear(H, H)
            self.add_v_proj = nn.Linear(H, H)
            self.norm_added_q, self.norm_added_k = _RMSScale(D), _RMSScale(D)
            self.to_out = nn.ModuleList([nn.Linear(H, H)])
            self.to_add_out = nn.Linear(H, H)


class _GELUProj(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out)

    def forward(self, x):
        return gelu_tanh(self.proj(x))


class _FeedForward(nn.Module):
    """`ff.net.0.proj` -> tanh-GELU -> `ff.net.2` (net.1 is diffusers' dropout slot)."""

    def __init__(self, hidden: int, mlp_hidden: int):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(hidden, mlp_hidden), nn.Identity(),
                                  nn.Linear(mlp_hidden, hidden)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


def _heads(cfg: FluxDiTConfig, x: torch.Tensor) -> torch.Tensor:
    return x.unflatten(-1, (cfg.num_heads, cfg.head_dim))


def _qkv(cfg, to_q, to_k, to_v, norm_q, norm_k, x):
    q = rms_norm(_heads(cfg, to_q(x)), norm_q.weight)
    k = rms_norm(_heads(cfg, to_k(x)), norm_k.weight)
    return q, k, _heads(cfg, to_v(x))


class DoubleBlock(nn.Module):
    def __init__(self, cfg: FluxDiTConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _Modulation(cfg.hidden_size, 6)
        self.norm1_context = _Modulation(cfg.hidden_size, 6)
        self.attn = _Attention(cfg, dual=True)
        self.ff = _FeedForward(cfg.hidden_size, cfg.mlp_hidden)
        self.ff_context = _FeedForward(cfg.hidden_size, cfg.mlp_hidden)

    def forward(self, img, txt, temb, cos, sin, attn_impl):
        cfg, a = self.cfg, self.attn
        # modulation order: shift, scale, gate for attention, then for the MLP
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.norm1(temb)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.norm1_context(temb)
        img_q, img_k, img_v = _qkv(cfg, a.to_q, a.to_k, a.to_v, a.norm_q, a.norm_k,
                                   adaln_modulate(img, i_sh1, i_sc1))
        txt_q, txt_k, txt_v = _qkv(cfg, a.add_q_proj, a.add_k_proj, a.add_v_proj,
                                   a.norm_added_q, a.norm_added_k,
                                   adaln_modulate(txt, t_sh1, t_sc1))
        # RoPE covers [txt | img] jointly
        q = apply_rope(torch.cat([txt_q, img_q], dim=1), cos, sin)
        k = apply_rope(torch.cat([txt_k, img_k], dim=1), cos, sin)
        v = torch.cat([txt_v, img_v], dim=1)
        (joint,) = joint_attention([q], [k], [v], impl=attn_impl)
        Lt = txt.shape[1]
        txt_attn = a.to_add_out(joint[:, :Lt].flatten(2))
        img_attn = a.to_out[0](joint[:, Lt:].flatten(2))
        img = img + i_g1[:, None, :] * img_attn
        txt = txt + t_g1[:, None, :] * txt_attn
        img = img + i_g2[:, None, :] * self.ff(adaln_modulate(img, i_sh2, i_sc2))
        txt = txt + t_g2[:, None, :] * self.ff_context(adaln_modulate(txt, t_sh2, t_sc2))
        return img, txt


class SingleBlock(nn.Module):
    def __init__(self, cfg: FluxDiTConfig):
        super().__init__()
        self.cfg = cfg
        H, M = cfg.hidden_size, cfg.mlp_hidden
        self.norm = _Modulation(H, 3)
        self.attn = _Attention(cfg, dual=False)
        self.proj_mlp = nn.Linear(H, M)
        # proj_out consumes concat([attn_out, gelu(mlp)], -1)
        self.proj_out = nn.Linear(H + M, H)

    def forward(self, hidden, temb, cos, sin, attn_impl):
        a = self.attn
        sh, sc, gate = self.norm(temb)
        h_n = adaln_modulate(hidden, sh, sc)
        mlp = gelu_tanh(self.proj_mlp(h_n))
        q, k, v = _qkv(self.cfg, a.to_q, a.to_k, a.to_v, a.norm_q, a.norm_k, h_n)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        (attn,) = joint_attention([q], [k], [v], impl=attn_impl)
        out = self.proj_out(torch.cat([attn.flatten(2), mlp], dim=-1))
        return hidden + gate[:, None, :] * out


class FluxDiT(nn.Module):
    """FLUX.1 DiT. Defaults of `FluxDiTConfig` are FLUX.1-dev."""

    def __init__(self, cfg: FluxDiTConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.x_embedder = nn.Linear(cfg.in_channels, H)
        self.context_embedder = nn.Linear(cfg.text_dim, H)
        self.time_text_embed = _TimeTextEmbed(cfg)
        self.transformer_blocks = nn.ModuleList(DoubleBlock(cfg) for _ in range(cfg.num_double_blocks))
        self.single_transformer_blocks = nn.ModuleList(
            SingleBlock(cfg) for _ in range(cfg.num_single_blocks))
        self.norm_out = _Modulation(H, 2)
        self.proj_out = nn.Linear(H, cfg.in_channels)

    def time_text_embed_apply(self, pooled, timestep, guidance, dtype):
        """timestep + pooled-text (+ guidance) MLP embeddings (t x 1000)."""
        cfg, e = self.cfg, self.time_text_embed
        t_feat = timestep_embedding(timestep * 1000.0, cfg.time_freq_dim)
        temb = e.timestep_embedder(t_feat.to(dtype)) + e.text_embedder(pooled.to(dtype))
        if cfg.guidance_embeds and guidance is not None:
            g_feat = timestep_embedding(guidance * 1000.0, cfg.time_freq_dim)
            temb = temb + e.guidance_embedder(g_feat.to(dtype))
        return temb

    def forward(
        self,
        img: torch.Tensor,  # (B, L_img, in_channels) packed latents
        txt: torch.Tensor,  # (B, L_txt, text_dim) T5 states
        pooled: torch.Tensor,  # (B, pooled_dim) CLIP pooled
        timestep: torch.Tensor,  # (B,) in [0, 1]
        img_ids: torch.Tensor,  # (L_img, 3)
        txt_ids: torch.Tensor,  # (L_txt, 3)
        guidance: torch.Tensor | None = None,  # (B,) distilled-guidance scale
        attn_impl: str = "xla",
        rope_layout: str = "pair",
        cond: torch.Tensor | None = None,
        controlnet_block_samples=None,
        controlnet_single_block_samples=None,
        return_img_residual: bool = False,
        module_cache=None,
        return_module_outs: bool = False,
    ) -> torch.Tensor:
        """Predict the rectified-flow velocity (B, L_img, in_channels).

        Quantized and LoRA weights are not modes of this module: the pipeline
        and CLI reject them (ROADMAP slices 2 and 3)."""
        if return_img_residual or module_cache is not None or return_module_outs:
            raise NotImplementedError("velocity-cache modes are ROADMAP slice 5, item 20")
        if cond is not None:
            raise NotImplementedError("the cond stream is ROADMAP slice 3, item 14")
        if controlnet_block_samples is not None or controlnet_single_block_samples is not None:
            raise NotImplementedError("ControlNet residuals are ROADMAP slice 3, item 14")
        if rope_layout != "pair":
            raise NotImplementedError("the split RoPE serving layout is ROADMAP slice 2, item 10")
        cfg = self.cfg
        if cfg.guidance_embeds and guidance is None:
            raise ValueError("FLUX.1-dev requires a guidance scale")
        dtype = img.dtype
        img = self.x_embedder(img)
        txt = self.context_embedder(txt)
        temb = self.time_text_embed_apply(pooled, timestep, guidance, dtype)
        cos, sin = rope_tables(torch.cat([txt_ids, img_ids], dim=0), cfg.axes_dims_rope,
                               cfg.rope_theta)
        for block in self.transformer_blocks:
            img, txt = block(img, txt, temb, cos, sin, attn_impl)
        hidden = torch.cat([txt, img], dim=1)
        for block in self.single_transformer_blocks:
            hidden = block(hidden, temb, cos, sin, attn_impl)
        img = hidden[:, txt.shape[1]:]
        # final AdaLN: scale first, then shift
        sc, sh = self.norm_out(temb)
        img = layer_norm(img) * (1.0 + sc[:, None, :]) + sh[:, None, :]
        return self.proj_out(img)
