"""FLUX.1 rectified-flow DiT in PyTorch: the forward with its optional
condition stream, in the published layout and in the W8A8 serving layout.

Counterpart of `reflectionflow_tpu/models/flux/dit.py::flux_dit_apply`:
19 double-stream blocks, 38 single-stream blocks (FLUX.1-dev), AdaLN-Zero
modulation from the (timestep, guidance, pooled CLIP) embedding, the cond
token stream that shares the image-stream weights (optionally through a LoRA
view, `lora/lora.py`), per-block recomputation for training (`remat`), and
attention through `ops.attention.joint_attention`, whose "pallas" impl is
kernel K1 forward and K6a/K6b backward and whose "pallas_int8" impl is K8.

The velocity cache's hooks (`sampler/generate.py`) live here too: the skip
signal `flux_mod_signal`, the TeaCache skip step `flux_residual_decode` over
the image-stream residual that `forward(return_img_residual=True)` returns,
and the TaylorSeer module cache: `forward(return_module_outs=True)` returns
every block's pre-gate module outputs, and `forward(module_cache=...)` runs
the glue only (fresh AdaLN gates, residual adds, output head) on forecast
ones, no attention or MLP.

Parameter names follow diffusers' FluxTransformer2DModel
(`transformer_blocks.{i}.attn.to_q`, `norm1.linear`, ...), the names
`reflectionflow_tpu/utils/hf_convert.py::convert_flux_dit_state` reads, so a
`state_dict()` of this module feeds that converter unchanged and published
checkpoints load by name.

The serving layout is made by module surgery (`ops/fuse.py`): fused q/k/v
panels under the JAX key names (`attn.qkv`, `attn.txt_qkv`, and in single
blocks `in_proj`, `out_attn`, `out_mlp`), q/k permuted to the half-split RoPE
layout (`rope_layout="split"`), then int8 linears (`ops.quant.QuantLinear`).
The forward dispatches on what the modules hold, as the JAX forward dispatches
on its parameter keys. With a pallas attention impl ("pallas", "pallas_nr",
"pallas_int8") and W8A8 linears, each W8A8 linear is fed by a fused kernel
(`ops/fused_quant.py`) at any sequence length: K3 modulate+quant for qkv,
`in_proj` and fc1, K4 gelu+quant for fc2 and `out_mlp`, K5 quant for the
attention out-projection. The q and k panels get K2 QK-norm+RoPE, except under
"pallas_nr", where the raw q/k go to K9 (`ops/flash_attention_nr.py`), which
norms and rotates them inside the attention. (The JAX gates also ask for
L % 8 == 0, the TPU kernels' row tiling; at other lengths it runs the unfused
chain.)

Under tensor parallelism (`parallel/specs.py::shard_dit_params`) the same
forward runs on each rank of the mesh's "model" axis: its blocks hold their
shard's heads and MLP hidden (`block.cfg.num_heads` is the shard's), and the
attention out-projections, the MLP's second linears and the single blocks'
`proj_out` are `RowParallelLinear`s that sum across the group. The
modulated input of the COL linears (q/k/v of each stream, the MLPs' first
linears, the single blocks' `proj_mlp`) passes `collectives.col_copy` once
(`_col_in`), so that a training backward sums its gradient over the group.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...config import FluxDiTConfig
from ...ops.attention import (PALLAS_IMPLS, RING_IMPLS, check_impl, cond_attention_bias,
                              joint_attention)
from ...ops.flash_attention_nr import flash_attention_nr
from ...ops.fused_quant import adaln_quant, gelu_quant, norm_rope, rowquant
from ...ops.norms import adaln_modulate, layer_norm, rms_norm
from ...ops.quant import QuantLinear
from ...parallel.collectives import col_copy
from .rope import apply_rope, apply_rope_split, rope_split_perm, rope_tables


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
    `dual` adds the txt-stream projections and both out projections. After
    `ops.fuse.fuse_dit_qkv` the projections are the panels `qkv`/`txt_qkv`."""

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

    def img_proj(self):
        """The img (or single) stream's projection: the fused panel or (q, k, v)."""
        return self.qkv if hasattr(self, "qkv") else (self.to_q, self.to_k, self.to_v)

    def txt_proj(self):
        if hasattr(self, "txt_qkv"):
            return self.txt_qkv
        return self.add_q_proj, self.add_k_proj, self.add_v_proj


class _GELUProj(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out)


class _FeedForward(nn.Module):
    """`ff.net.0.proj` -> tanh-GELU -> `ff.net.2` (net.1 is diffusers' dropout slot)."""

    def __init__(self, hidden: int, mlp_hidden: int):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(hidden, mlp_hidden), nn.Identity(),
                                  nn.Linear(mlp_hidden, hidden)])


# ---------------------------------------------------------------------------
# forward pieces (JAX `dit.py` names)
# ---------------------------------------------------------------------------


def _heads(cfg: FluxDiTConfig, x: torch.Tensor) -> torch.Tensor:
    return x.unflatten(-1, (cfg.num_heads, cfg.head_dim))


def _rms_fast(x, scale, eps: float = 1e-6):
    """Serving QK-norm: fp32 only for the per-row reduce; the elementwise
    stays in the storage dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps).to(x.dtype) * scale.to(x.dtype)


def _adaln_fast(x, shift, scale, eps: float = 1e-6):
    """Serving AdaLN-Zero modulate: fp32 only for the per-row mean/var; the
    (L, H) elementwise runs in the storage dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mu * mu
    r = torch.rsqrt(var.clamp_min(0.0) + eps)
    a, b = r.to(x.dtype), (-mu * r).to(x.dtype)
    return (x * a + b) * (1.0 + scale[:, None, :].to(x.dtype)) + shift[:, None, :].to(x.dtype)


def _modulate(x, shift, scale, fast):
    return _adaln_fast(x, shift, scale) if fast else adaln_modulate(x, shift, scale)


def _qk_norm(x, scale, fast):
    return _rms_fast(x, scale) if fast else rms_norm(x, scale)


def _col_in(block, x):
    """The shared input of a block's column-cut linears under tensor
    parallelism (`block.tp`, set by `parallel.specs.shard_dit_params`)."""
    tp = getattr(block, "tp", None)
    return x if tp is None else col_copy(x, tp.group)


def _is_w8a8(m) -> bool:
    return isinstance(m, QuantLinear) and m.act_quant


def _use_fused_quant(flags, attn_impl, m) -> bool:
    """Gate for the fused act-quant kernels: serving layout, a W8A8 linear and
    a pallas attention impl. Unlike the JAX gate there is no L % 8 == 0
    condition: that is the TPU kernels' row tiling, and K3–K5 take any length."""
    return flags["fast_qk"] and attn_impl in PALLAS_IMPLS and _is_w8a8(m)


def _nr_gate(flags, attn_impl, tables) -> bool:
    """Use the fused QK-norm+RoPE kernel (K2)? Split tables and a pallas
    attention impl, at any length (no JAX L % 8 == 0 condition, as in
    `_use_fused_quant`). The callers ask `_nr_attn_gate` first."""
    return flags["fast_qk"] and tables[2] and attn_impl in PALLAS_IMPLS


def _nr_attn_gate(flags, attn_impl, *tables) -> bool:
    """QK-norm and split RoPE inside the attention kernel (K9)? "pallas_nr" in
    the serving layout with split tables for every present stream; the q/k
    panels then stay raw (`_qkv_split(..., rope="raw")`)."""
    return attn_impl == "pallas_nr" and flags["fast_qk"] and all(t[2] for t in tables)


def _nr_tables(rope, rope_cond):
    """K9's (cos, sin) over the whole joint sequence: the cond stream's tables
    follow the main ones. Built once per forward for every block."""
    if rope_cond is None:
        return rope[0], rope[1]
    return torch.cat([rope[0], rope_cond[0]]), torch.cat([rope[1], rope_cond[1]])


def _nr_attention(streams, scale_q, scale_k, nr_rope, txt_len, attn_kw):
    """K9 over the concatenated RAW per-stream q/k/v (`streams` = [qs, ks,
    vs]) with the joint tables `nr_rope` (`_nr_tables`); per-stream outputs,
    as `joint_attention`. Norm-scale row 0 serves joint positions below
    `txt_len`, row 1 the rest; the cond stream shares the image stream's norms
    (a LoRA view adapts linears only)."""
    lens = [x.shape[1] for x in streams[0]]
    q, k, v = (torch.cat(xs, dim=1) if len(xs) > 1 else xs[0] for xs in streams)
    cos, sin = nr_rope
    out = flash_attention_nr(q, k, v, cos, sin, scale_q, scale_k, txt_len=txt_len,
                             main_len=q.shape[1] - attn_kw.get("cond_len", 0),
                             cross_bias=attn_kw.get("cross_bias", 0.0))
    return list(torch.split(out, lens, dim=1))


def _adaln_quant_matmul(x, shift, scale, m, dtype):
    xq, xs = adaln_quant(x, shift, scale)
    return m.matmul_pre(xq, xs, dtype)


def _gelu_quant_matmul(x_pre, m, dtype):
    xq, xs = gelu_quant(x_pre)
    return m.matmul_pre(xq, xs, dtype)


def _rowquant_matmul(x, m, dtype):
    xq, xs = rowquant(x)
    return m.matmul_pre(xq, xs, dtype)


def _qkv_split(cfg, qkv, norm_q, norm_k, fast, rope=None):
    """Split a (B, L, 3H[+extra]) panel into normed per-head q/k/v. With
    `rope=(cos, sin)` the QK-norm and the split rotation run as K2 on each of
    the q and k panel slices (the caller then skips `_rope_qk`); with
    `rope="raw"` q and k stay raw for K9."""
    H = cfg.num_heads * cfg.head_dim
    q_r, k_r, v_r = qkv[..., :H], qkv[..., H:2 * H], qkv[..., 2 * H:3 * H]
    if rope == "raw":
        return _heads(cfg, q_r), _heads(cfg, k_r), _heads(cfg, v_r)
    if rope is not None:
        cos, sin = rope
        q = _heads(cfg, norm_rope(q_r, norm_q.weight, cos, sin))
        k = _heads(cfg, norm_rope(k_r, norm_k.weight, cos, sin))
        return q, k, _heads(cfg, v_r)
    q = _qk_norm(_heads(cfg, q_r), norm_q.weight, fast)
    k = _qk_norm(_heads(cfg, k_r), norm_k.weight, fast)
    return q, k, _heads(cfg, v_r)


def _qkv(cfg, proj, norm_q, norm_k, x, fast, rope=None):
    """q/k/v of one stream; `proj` is a fused panel or the (q, k, v) linears."""
    if not isinstance(proj, tuple):
        return _qkv_split(cfg, proj(x), norm_q, norm_k, fast, rope)
    if rope is not None:  # K2 and K9 take the panel layout
        return _qkv_split(cfg, torch.cat([p(x) for p in proj], dim=-1), norm_q, norm_k, fast, rope)
    to_q, to_k, to_v = proj
    q = _qk_norm(_heads(cfg, to_q(x)), norm_q.weight, fast)
    k = _qk_norm(_heads(cfg, to_k(x)), norm_k.weight, fast)
    return q, k, _heads(cfg, to_v(x))


def _rope_qk(q, k, tables):
    cos, sin, split = tables
    fn = apply_rope_split if split else apply_rope
    return fn(q, cos, sin), fn(k, cos, sin)


def _proj(m, x, flags, attn_impl):
    """Attention out-projection: K5 + the int8 GEMM on the serving path."""
    if _use_fused_quant(flags, attn_impl, m):
        return _rowquant_matmul(x, m, x.dtype)
    return m(x)


def _mlp_apply(ff: _FeedForward, x, sh2, sc2, flags, attn_impl, fast, block=None):
    """modulate -> fc1 -> gelu -> fc2; K3 and K4 feed both W8A8 GEMMs on the
    serving path. `block` holds the tensor-parallel group, if any."""
    fc1, fc2 = ff.net[0].proj, ff.net[2]
    if _use_fused_quant(flags, attn_impl, fc1) and _is_w8a8(fc2):
        pre = _adaln_quant_matmul(x, sh2, sc2, fc1, x.dtype)
        return _gelu_quant_matmul(pre, fc2, x.dtype)
    return fc2(gelu_tanh(fc1(_col_in(block, _modulate(x, sh2, sc2, fast)))))


class DoubleBlock(nn.Module):
    def __init__(self, cfg: FluxDiTConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _Modulation(cfg.hidden_size, 6)
        self.norm1_context = _Modulation(cfg.hidden_size, 6)
        self.attn = _Attention(cfg, dual=True)
        self.ff = _FeedForward(cfg.hidden_size, cfg.mlp_hidden)
        self.ff_context = _FeedForward(cfg.hidden_size, cfg.mlp_hidden)

    def forward(self, img, txt, temb, rope, flags, attn_impl, cond=None, cond_temb=None,
                rope_cond=None, attn_kw=None, bc=None, nr_rope=None, modules=None,
                return_modules=False):
        """One block; with `cond` the cond stream runs beside [txt | img] in the
        joint attention, reading block `bc` (this block, or its LoRA view).
        `nr_rope` (the joint tables, when `_nr_attn_gate` holds) takes the K9
        route. `modules` (img_attn, txt_attn, img_mlp, txt_mlp), forecast
        pre-gate outputs, make a TaylorSeer skip step: only the gates from this
        `temb` and the residual adds run. `return_modules` also returns the
        four pre-gate outputs of a full step."""
        cfg, a = self.cfg, self.attn
        fast = flags["fast_qk"]
        # modulation order: shift, scale, gate for attention, then for the MLP
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.norm1(temb)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.norm1_context(temb)
        if modules is not None:
            ia, ta, im, tm = modules
            dt = img.dtype
            img = img + i_g1[:, None, :] * ia.to(dt) + i_g2[:, None, :] * im.to(dt)
            txt = txt + t_g1[:, None, :] * ta.to(dt) + t_g2[:, None, :] * tm.to(dt)
            return img, txt, cond
        Lt = txt.shape[1]
        nr_fuse = nr_rope is not None
        nr = not nr_fuse and _nr_gate(flags, attn_impl, rope)
        cos, sin, _ = rope
        if nr_fuse:
            rope_img = rope_txt = "raw"
        else:
            rope_img = (cos[Lt:], sin[Lt:]) if nr else None
            rope_txt = (cos[:Lt], sin[:Lt]) if nr else None

        def stream_qkv(proj, norm_q, norm_k, x, sh, sc, r):
            if not isinstance(proj, tuple) and _use_fused_quant(flags, attn_impl, proj):
                panel = _adaln_quant_matmul(x, sh, sc, proj, x.dtype)
                return _qkv_split(cfg, panel, norm_q, norm_k, True, r)
            return _qkv(cfg, proj, norm_q, norm_k, _col_in(self, _modulate(x, sh, sc, fast)), fast, r)

        img_q, img_k, img_v = stream_qkv(a.img_proj(), a.norm_q, a.norm_k, img, i_sh1, i_sc1,
                                         rope_img)
        txt_q, txt_k, txt_v = stream_qkv(a.txt_proj(), a.norm_added_q, a.norm_added_k, txt,
                                         t_sh1, t_sc1, rope_txt)
        # RoPE covers [txt | img] jointly; the cond stream has its own tables
        q = torch.cat([txt_q, img_q], dim=1)
        k = torch.cat([txt_k, img_k], dim=1)
        if not (nr or nr_fuse):
            q, k = _rope_qk(q, k, rope)
        v = torch.cat([txt_v, img_v], dim=1)
        streams = [[q], [k], [v]]
        if cond is not None:
            ca = bc.attn
            c_sh1, c_sc1, c_g1, c_sh2, c_sc2, c_g2 = bc.norm1(cond_temb)
            nr_c = not nr_fuse and _nr_gate(flags, attn_impl, rope_cond)
            cq, ck, cv = stream_qkv(ca.img_proj(), ca.norm_q, ca.norm_k, cond, c_sh1, c_sc1,
                                    "raw" if nr_fuse else (rope_cond[:2] if nr_c else None))
            if not (nr_c or nr_fuse):
                cq, ck = _rope_qk(cq, ck, rope_cond)
            for lst, x in zip(streams, (cq, ck, cv)):
                lst.append(x)
        if nr_fuse:  # scale rows: txt projections' norms, then the img (and cond) ones
            outs = _nr_attention(streams, torch.stack([a.norm_added_q.weight, a.norm_q.weight]),
                                 torch.stack([a.norm_added_k.weight, a.norm_k.weight]), nr_rope,
                                 Lt, attn_kw or {})
        else:
            outs = joint_attention(*streams, impl=attn_impl, **(attn_kw or {}))
        joint = outs[0]
        txt_attn = _proj(a.to_add_out, joint[:, :Lt].flatten(2), flags, attn_impl)
        img_attn = _proj(a.to_out[0], joint[:, Lt:].flatten(2), flags, attn_impl)
        img = img + i_g1[:, None, :] * img_attn
        txt = txt + t_g1[:, None, :] * txt_attn
        if cond is not None:
            gated = c_g1[:, None, :] * _proj(ca.to_out[0], outs[1].flatten(2), flags, attn_impl)
            cond = cond + gated
            if flags["add_cond_attn"]:
                if cond.shape[1] != img.shape[1]:
                    raise ValueError("add_cond_attn requires L_cond == L_img")
                img = img + gated
        img_mlp = _mlp_apply(self.ff, img, i_sh2, i_sc2, flags, attn_impl, fast, self)
        txt_mlp = _mlp_apply(self.ff_context, txt, t_sh2, t_sc2, flags, attn_impl, fast, self)
        img = img + i_g2[:, None, :] * img_mlp
        txt = txt + t_g2[:, None, :] * txt_mlp
        if cond is not None:
            cond = cond + c_g2[:, None, :] * _mlp_apply(bc.ff, cond, c_sh2, c_sc2, flags,
                                                        attn_impl, fast, bc)
        if return_modules:
            return img, txt, cond, (img_attn, txt_attn, img_mlp, txt_mlp)
        return img, txt, cond


class SingleBlock(nn.Module):
    """Published layout: `proj_mlp` beside the attention's q/k/v and
    `proj_out` over concat([attn, mlp]). Serving layout (`ops.fuse.
    fuse_single_block_io`): `in_proj` = [q|k|v|mlp_in] and `out_attn` +
    `out_mlp`, so the (L, H+M) concat is never built."""

    def __init__(self, cfg: FluxDiTConfig):
        super().__init__()
        self.cfg = cfg
        H, M = cfg.hidden_size, cfg.mlp_hidden
        self.norm = _Modulation(H, 3)
        self.attn = _Attention(cfg, dual=False)
        self.proj_mlp = nn.Linear(H, M)
        self.proj_out = nn.Linear(H + M, H)

    def _stream_in(self, x, sh, sc, flags, attn_impl, rope):
        """q/k/v and the MLP context: ("pre", pre-GELU values) when K3 fed the
        fused `in_proj` GEMM, else ("gelu", activated values)."""
        cfg, a = self.cfg, self.attn
        fast = flags["fast_qk"]
        H3 = 3 * cfg.num_heads * cfg.head_dim
        fused = hasattr(self, "in_proj")
        if fused and _use_fused_quant(flags, attn_impl, self.in_proj):
            panel = _adaln_quant_matmul(x, sh, sc, self.in_proj, x.dtype)
            q, k, v = _qkv_split(cfg, panel, a.norm_q, a.norm_k, True, rope)
            return q, k, v, ("pre", panel[..., H3:])
        h_n = _col_in(self, _modulate(x, sh, sc, fast))
        if fused:
            panel = self.in_proj(h_n)
            q, k, v = _qkv_split(cfg, panel, a.norm_q, a.norm_k, fast, rope)
            return q, k, v, ("gelu", gelu_tanh(panel[..., H3:]))
        q, k, v = _qkv(cfg, a.img_proj(), a.norm_q, a.norm_k, h_n, fast, rope)
        return q, k, v, ("gelu", gelu_tanh(self.proj_mlp(h_n)))

    def _stream_out(self, attn_out, mlp_ctx, flags, attn_impl):
        kind, val = mlp_ctx
        if kind == "pre":
            if _is_w8a8(self.out_mlp):
                return (_proj(self.out_attn, attn_out, flags, attn_impl)
                        + _gelu_quant_matmul(val, self.out_mlp, attn_out.dtype))
            val = gelu_tanh(val)
        if hasattr(self, "out_attn"):
            return self.out_attn(attn_out) + self.out_mlp(val)
        return self.proj_out(torch.cat([attn_out, val], dim=-1))

    def forward(self, hidden, temb, rope, flags, attn_impl, cond=None, cond_temb=None,
                rope_cond=None, attn_kw=None, bc=None, nr_rope=None, modules=None,
                return_modules=False):
        """One block; `modules` (the forecast pre-gate output) makes a
        TaylorSeer skip step, `return_modules` also returns the pre-gate
        output, as in `DoubleBlock`."""
        sh, sc, gate = self.norm(temb)
        if modules is not None:
            return hidden + gate[:, None, :] * modules.to(hidden.dtype), cond
        nr_fuse = nr_rope is not None
        nr = not nr_fuse and _nr_gate(flags, attn_impl, rope)
        q, k, v, mlp_ctx = self._stream_in(hidden, sh, sc, flags, attn_impl,
                                           "raw" if nr_fuse else (rope[:2] if nr else None))
        if not (nr or nr_fuse):
            q, k = _rope_qk(q, k, rope)
        streams = [[q], [k], [v]]
        if cond is not None:
            c_sh, c_sc, c_gate = bc.norm(cond_temb)
            nr_c = not nr_fuse and _nr_gate(flags, attn_impl, rope_cond)
            cq, ck, cv, c_ctx = bc._stream_in(cond, c_sh, c_sc, flags, attn_impl,
                                              "raw" if nr_fuse else (rope_cond[:2] if nr_c else None))
            if not (nr_c or nr_fuse):
                cq, ck = _rope_qk(cq, ck, rope_cond)
            for lst, x in zip(streams, (cq, ck, cv)):
                lst.append(x)
        if nr_fuse:  # one projection per single block: its norm in both scale rows, txt_len 0
            a = self.attn
            outs = _nr_attention(streams, torch.stack([a.norm_q.weight] * 2),
                                 torch.stack([a.norm_k.weight] * 2), nr_rope, 0, attn_kw or {})
        else:
            outs = joint_attention(*streams, impl=attn_impl, **(attn_kw or {}))
        out = self._stream_out(outs[0].flatten(2), mlp_ctx, flags, attn_impl)
        hidden = hidden + gate[:, None, :] * out
        if cond is not None:
            cond = cond + c_gate[:, None, :] * bc._stream_out(outs[1].flatten(2), c_ctx, flags,
                                                              attn_impl)
        if return_modules:
            return hidden, cond, out
        return hidden, cond


# port module name -> JAX tree path, outside the blocks and per block family
_TOP_PATHS = {
    "x_embedder": "img_in", "context_embedder": "txt_in", "norm_out.linear": "final_mod",
    "proj_out": "final_proj",
    **{f"time_text_embed.{ours}.linear_{i}": f"{theirs}/fc{i}"
       for ours, theirs in (("timestep_embedder", "time_in"), ("text_embedder", "vector_in"),
                            ("guidance_embedder", "guidance_in")) for i in (1, 2)},
}
_ATTN_PATHS = {"attn.to_q": "attn/q", "attn.to_k": "attn/k", "attn.to_v": "attn/v",
               "attn.qkv": "attn/qkv", "attn.norm_q": "attn/q_norm", "attn.norm_k": "attn/k_norm"}
_BLOCK_PATHS = {
    "double_blocks": {
        **_ATTN_PATHS, "norm1.linear": "img_mod", "norm1_context.linear": "txt_mod",
        "attn.add_q_proj": "attn/txt_q", "attn.add_k_proj": "attn/txt_k",
        "attn.add_v_proj": "attn/txt_v", "attn.txt_qkv": "attn/txt_qkv",
        "attn.norm_added_q": "attn/txt_q_norm", "attn.norm_added_k": "attn/txt_k_norm",
        "attn.to_out.0": "attn/out", "attn.to_add_out": "attn/txt_out",
        "ff.net.0.proj": "img_mlp/fc1", "ff.net.2": "img_mlp/fc2",
        "ff_context.net.0.proj": "txt_mlp/fc1", "ff_context.net.2": "txt_mlp/fc2",
    },
    "single_blocks": {
        **_ATTN_PATHS, "norm.linear": "mod", "proj_mlp": "mlp_in", "proj_out": "out",
        "in_proj": "in_proj", "out_attn": "out_attn", "out_mlp": "out_mlp",
    },
}
_FAMILY = {"transformer_blocks": "double_blocks", "single_transformer_blocks": "single_blocks"}


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
        # "split" once ops.fuse.permute_rope_layout has permuted q/k
        self.rope_layout = "pair"

    def jax_path(self, name: str):
        """Module name -> (JAX tree path, block index or None, blocks stacked in
        that path's leaves): `transformer_blocks.3.attn.qkv` ->
        ("double_blocks/attn/qkv", 3, 19)."""
        m = re.fullmatch(r"(transformer_blocks|single_transformer_blocks)\.(\d+)\.(.+)", name)
        if m is None:
            return _TOP_PATHS[name], None, 1
        family = _FAMILY[m[1]]
        n = self.cfg.num_double_blocks if family == "double_blocks" else self.cfg.num_single_blocks
        return f"{family}/{_BLOCK_PATHS[family][m[3]]}", int(m[2]), n

    def time_text_embed_apply(self, pooled, timestep, guidance, dtype):
        """timestep + pooled-text (+ guidance) MLP embeddings (t x 1000)."""
        cfg, e = self.cfg, self.time_text_embed
        t_feat = timestep_embedding(timestep * 1000.0, cfg.time_freq_dim)
        temb = e.timestep_embedder(t_feat.to(dtype)) + e.text_embedder(pooled.to(dtype))
        if cfg.guidance_embeds and guidance is not None:
            g_feat = timestep_embedding(guidance * 1000.0, cfg.time_freq_dim)
            temb = temb + e.guidance_embedder(g_feat.to(dtype))
        return temb

    def rope(self, ids: torch.Tensor, split: bool, dtype: torch.dtype):
        """(cos, sin, split) tables for (L, 3) ids; the split layout permutes
        them and keeps them in the activation dtype (the all-bf16 rotation)."""
        cfg = self.cfg
        cos, sin = rope_tables(ids, cfg.axes_dims_rope, cfg.rope_theta)
        if split:
            perm = torch.from_numpy(rope_split_perm(cfg.head_dim)).to(cos.device)
            cos, sin = cos[:, perm].to(dtype), sin[:, perm].to(dtype)
        return cos, sin, split

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
        cond: torch.Tensor | None = None,  # (B, L_cond, in_channels)
        cond_ids: torch.Tensor | None = None,  # (L_cond, 3)
        c_t: float = 0.0,
        union_cond_attn: bool = True,
        add_cond_attn: bool = False,
        c_factor: float | None = None,
        remat: bool = False,
        cond_params: "FluxDiT | None" = None,
        controlnet_block_samples=None,
        controlnet_single_block_samples=None,
        return_img_residual: bool = False,
        module_cache: dict | None = None,  # skip step: forecast module outputs per block
        return_module_outs: bool = False,  # full step: also return the module outputs
    ):
        """Predict the rectified-flow velocity (B, L_img, in_channels).

        `cond` adds the condition token stream: it shares the image-stream
        weights, read from `cond_params` (this model, or a LoRA view of it from
        `lora.attach_lora` / `make_dit_param_views`), gets its own timestep
        embedding at `c_t` with guidance 1.0 and its own RoPE ids. Its coupling
        to the main tokens is the union mask (`union_cond_attn=False` masks
        it) or log(`c_factor`), which takes precedence: a dense bias on "xla",
        the structural (cond_len, cross_bias) form on the pallas and ring impls.
        `add_cond_attn` also adds the cond stream's gated attention output to
        the image stream.

        `remat=True` recomputes each block in the backward pass
        (`torch.utils.checkpoint`), as `jax.checkpoint` wraps each scan body.

        `controlnet_block_samples` / `controlnet_single_block_samples`:
        stacked ControlNet residuals (n_hooks, B, L_img, hidden), cast to the
        model dtype. Hook i serves blocks [i k, (i + 1) k) with k =
        ceil(n_blocks / n_hooks); its residual is added to the image stream
        after each double block, and to the image rows after each single
        block.

        `rope_layout="split"` is the serving layout: it needs q/k permuted by
        `ops.fuse.permute_rope_layout` and runs the storage-dtype QK-norm,
        AdaLN and RoPE of the JAX package's serving forward.

        `return_img_residual=True` also returns the image-stream residual
        across the blocks (post-blocks hidden minus the `img_in` embedding,
        (B, L_img, hidden), model dtype): TeaCache's cached quantity, which
        `flux_residual_decode` consumes on skipped steps.

        `return_module_outs=True` also returns the TaylorSeer cache, every
        block's pre-gate module outputs, stacked per block:
        {"double": (img_attn, txt_attn, img_mlp, txt_mlp) each (Nd, B, L, H),
        "single": (Ns, B, L_txt + L_img, H)}. `module_cache=` takes the same
        structure, whose leaves may be any objects that give block i's
        outputs at `[i]` (the sampler forecasts one block at a time), and
        runs the glue only. Module mode is plain t2i: it raises ValueError with
        the cond stream, ControlNet residuals, `return_img_residual` or
        `remat` (the JAX package drops `remat` there without a word).

        Returns (B, L_img, in_channels), with the residual or the module
        cache as a second value when asked."""
        module_mode = return_module_outs or module_cache is not None
        if module_mode and (cond is not None or controlnet_block_samples is not None
                            or controlnet_single_block_samples is not None or return_img_residual):
            raise ValueError("module cache covers the plain t2i path (no cond/controlnet streams, "
                             "not combinable with return_img_residual)")
        if module_mode and remat:
            raise ValueError("module cache is a serving path: remat=True does not apply to it")
        check_impl(attn_impl)
        if rope_layout != self.rope_layout:
            raise ValueError(
                f"rope_layout={rope_layout!r}, but this model's q/k weights are in the "
                f"{self.rope_layout!r} layout (ops.fuse.permute_rope_layout makes 'split')")
        cfg = self.cfg
        if cfg.guidance_embeds and guidance is None:
            raise ValueError("FLUX.1-dev requires a guidance scale")
        use_cond = cond is not None
        if use_cond and cond_ids is None:
            raise ValueError("a cond stream needs its RoPE ids (cond_ids)")
        cp = self if cond_params is None else cond_params
        if use_cond and cp.rope_layout != rope_layout:
            raise ValueError(f"cond_params are in the {cp.rope_layout!r} layout, the forward in "
                             f"{rope_layout!r} (FluxPipeline.quantize transforms both)")
        split = rope_layout == "split"
        flags = {"fast_qk": split, "add_cond_attn": add_cond_attn}
        dtype = img.dtype
        img = self.x_embedder(img)
        img_embed = img if return_img_residual else None
        txt = self.context_embedder(txt)
        temb = self.time_text_embed_apply(pooled, timestep, guidance, dtype)
        rope = self.rope(torch.cat([txt_ids, img_ids], dim=0), split, dtype)
        cond_h = cond_temb = rope_cond = None
        attn_kw = {}
        if use_cond:
            cond_h = cp.x_embedder(cond)
            # the cond stream: t fixed at c_t, guidance forced to 1.0
            cond_temb = self.time_text_embed_apply(
                pooled, torch.full_like(timestep, c_t),
                torch.ones_like(timestep) if cfg.guidance_embeds else None, dtype)
            rope_cond = self.rope(cond_ids, split, dtype)
            L_main, L_cond = img.shape[1] + txt.shape[1], cond_h.shape[1]
            if attn_impl in PALLAS_IMPLS or attn_impl in RING_IMPLS:
                # structural form (the ring rebuilds global positions from its
                # topology); c_factor takes precedence over the union mask
                if c_factor is not None:
                    cross = float(np.log(np.float32(c_factor)))
                else:
                    cross = 0.0 if union_cond_attn else -1e30
                attn_kw = {"cond_len": L_cond, "cross_bias": cross}
            else:
                attn_kw = {"bias": cond_attention_bias(L_main + L_cond, L_cond, union_cond_attn,
                                                       c_factor, device=img.device)}

        nr_rope = None
        if _nr_attn_gate(flags, attn_impl, rope, *(() if rope_cond is None else (rope_cond,))):
            nr_rope = _nr_tables(rope, rope_cond)

        def run(block, *args):
            if remat:
                return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
            return block(*args)

        tail = (cond_temb, rope_cond, attn_kw)

        def hooks(samples, n_blocks):
            """Block i's ControlNet residual, or None for every block."""
            if samples is None:
                return [None] * n_blocks
            samples = samples.to(dtype)
            interval = -(-n_blocks // samples.shape[0])
            return [samples[i // interval] for i in range(n_blocks)]

        ctrl_d = hooks(controlnet_block_samples, len(self.transformer_blocks))
        ctrl_s = hooks(controlnet_single_block_samples, len(self.single_transformer_blocks))
        if return_module_outs:  # block i's pre-gate outputs land in slice i
            Nd, Ns = len(self.transformer_blocks), len(self.single_transformer_blocks)
            d_mods = tuple(x.new_empty((Nd, *x.shape)) for x in (img, txt, img, txt))
            s_mods = img.new_empty((Ns, img.shape[0], txt.shape[1] + img.shape[1], img.shape[2]))
        for i, block in enumerate(self.transformer_blocks):
            if module_cache is not None:
                img, txt, _ = block(img, txt, temb, rope, flags, attn_impl,
                                    modules=tuple(a[i] for a in module_cache["double"]))
            elif return_module_outs:
                img, txt, _, mods = block(img, txt, temb, rope, flags, attn_impl, nr_rope=nr_rope,
                                          return_modules=True)
                for buf, m in zip(d_mods, mods):
                    buf[i] = m
            else:
                bc = cp.transformer_blocks[i] if use_cond else None
                img, txt, cond_h = run(block, img, txt, temb, rope, flags, attn_impl, cond_h, *tail,
                                       bc, nr_rope)
                if ctrl_d[i] is not None:
                    img = img + ctrl_d[i]
        hidden = torch.cat([txt, img], dim=1)
        Lt = txt.shape[1]
        for i, block in enumerate(self.single_transformer_blocks):
            if module_cache is not None:
                hidden, _ = block(hidden, temb, rope, flags, attn_impl,
                                  modules=module_cache["single"][i])
            elif return_module_outs:
                hidden, _, s_mods[i] = block(hidden, temb, rope, flags, attn_impl, nr_rope=nr_rope,
                                             return_modules=True)
            else:
                bc = cp.single_transformer_blocks[i] if use_cond else None
                hidden, cond_h = run(block, hidden, temb, rope, flags, attn_impl, cond_h, *tail, bc,
                                     nr_rope)
                if ctrl_s[i] is not None:
                    hidden = torch.cat([hidden[:, :Lt], hidden[:, Lt:] + ctrl_s[i]], dim=1)
        img = hidden[:, Lt:]
        resid = img - img_embed if return_img_residual else None
        # final AdaLN: scale first, then shift
        sc, sh = self.norm_out(temb)
        img = layer_norm(img) * (1.0 + sc[:, None, :]) + sh[:, None, :]
        out = self.proj_out(img)
        if return_module_outs:
            return out, {"double": d_mods, "single": s_mods}
        return (out, resid) if return_img_residual else out


def flux_mod_signal(dit: FluxDiT, img, pooled, timestep, guidance=None) -> torch.Tensor:
    """The velocity cache's skip signal: block 0's AdaLN-modulated image-stream
    input (TeaCache, arXiv 2411.19108, applied to FLUX), (B, L_img, hidden).
    `img_in`, the conditioning embedding, block 0's `img_mod` shift and scale,
    and the plain (non-serving) modulate, in any layout; it runs on whatever
    linears the model holds (float, W8A8, NF4)."""
    dtype = img.dtype
    h = dit.x_embedder(img)
    temb = dit.time_text_embed_apply(pooled, timestep, guidance, dtype)
    sh1, sc1 = dit.transformer_blocks[0].norm1(temb)[:2]
    return _modulate(h, sh1, sc1, fast=False)


def flux_residual_decode(dit: FluxDiT, img, resid, pooled, timestep, guidance=None) -> torch.Tensor:
    """TeaCache's skip step: a fresh `img_in` embedding of the current latents
    plus the cached image-stream residual, then the live final AdaLN and
    projection. (B, L_img, in_channels)."""
    dtype = img.dtype
    h = dit.x_embedder(img) + resid.to(dtype)
    temb = dit.time_text_embed_apply(pooled, timestep, guidance, dtype)
    sc, sh = dit.norm_out(temb)
    h = layer_norm(h) * (1.0 + sc[:, None, :]) + sh[:, None, :]
    return dit.proj_out(h)
