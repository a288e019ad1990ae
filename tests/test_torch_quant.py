"""Int8 quantization and the serving-layout surgery of the PyTorch port against
the JAX package.

Weights are seeded numpy arrays loaded into the port's FluxDiT and carried to
a JAX tree by the JAX package's own converter (`numpy_models`); the port runs
`ops.fuse` + `ops.quant` in place, the JAX package runs `ops.fuse` +
`quantize_dit_params` on its tree. Held to: int8 weights bit-identical, fp32
scales within rtol 1e-6, the same set of W8A8 and w8a16 linears, float
weights equal. The same holds for the JAX serving tree carried by the bridge.
Products: int8 GEMMs are exact, so W8A8 / w8a16 linears agree with JAX in fp32
within 1e-5 of the output scale, and the w8a16 T5 encode within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from reflectionflow_tpu.config import T5Config
from reflectionflow_tpu.models.flux.dit import linear as jax_linear
from reflectionflow_tpu.models.flux.text import t5_encode as jax_t5_encode
from reflectionflow_tpu.models.flux.text import t5_encoder_init
from reflectionflow_tpu.ops import fuse as jfuse
from reflectionflow_tpu.ops import quant as jquant
from reflectionflow_tpu.utils.hf_convert import convert_flux_dit_state
from reflectionflow_tpu_torch.config import T5Config as TT5Config
from reflectionflow_tpu_torch.models.flux.text import T5Encoder, t5_encode
from reflectionflow_tpu_torch.models.flux.dit import FluxDiT
from reflectionflow_tpu_torch.ops import quant
from reflectionflow_tpu_torch.ops.fuse import fuse_dit_qkv, fuse_single_block_io, permute_rope_layout
from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline
from reflectionflow_tpu_torch.utils import jax_bridge

from test_torch_flux_dit import _cfg, perturbed

torch.set_num_threads(1)


def numpy_models(seed=0, **cfg_kw):
    """(JAX config, JAX DiT tree, port FluxDiT) holding the same seeded numpy
    weights: N(0, 1/fan_in) matrices, small biases, norm scales near 1. The JAX
    tree comes from the JAX package's diffusers converter, so no JAX init runs."""
    jcfg, tcfg = _cfg(**cfg_kw)
    dit = FluxDiT(tcfg)
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in dit.state_dict().items():
        if p.dim() == 2:
            v = rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[1])
        elif name.endswith("bias"):
            v = 0.02 * rng.standard_normal(tuple(p.shape))
        else:
            v = 1.0 + 0.1 * rng.standard_normal(tuple(p.shape))
        sd[name] = v.astype(np.float32)
    dit.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return jcfg, convert_flux_dit_state(sd, jcfg), dit.eval()


def _weight(rng, d_in, d_out):
    w = (rng.standard_normal((d_in, d_out)) * 0.1).astype(np.float32)
    w[:, 3] *= 20.0  # an outlier channel
    w[:, 5] = 0.0  # an all-zero channel takes the 1e-12 floor
    return w


def test_quantize_linear_matches_jax():
    rng = np.random.default_rng(0)
    w = _weight(rng, 96, 40)
    want = jquant.quantize_linear({"w": jnp.asarray(w)})
    w_q, w_scale = quant.quantize_linear(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(w_q.numpy().T, np.asarray(want["w_q"]))
    np.testing.assert_allclose(w_scale.numpy(), np.asarray(want["w_scale"])[0], rtol=1e-6)
    np.testing.assert_array_equal(quant.dequantize_weight(w_q, w_scale, torch.float32).numpy().T,
                                  np.asarray(jquant.dequantize_weight(want, jnp.float32)))


def _check_quant_linear(act_quant, d_in, d_out):
    rng = np.random.default_rng(1)
    w, b = _weight(rng, d_in, d_out), rng.standard_normal(d_out).astype(np.float32)
    x = (rng.standard_normal((2, 5, d_in)) * 3).astype(np.float32)
    jp = jquant.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, act_quant=act_quant)
    lin = nn.Linear(d_in, d_out)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    ql = quant.QuantLinear.from_linear(lin, act_quant)
    want = np.asarray(jax_linear(jp, jnp.asarray(x)))
    got = ql(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    if act_quant:
        xs = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-12) / np.float32(127.0)
        xq = np.round(x / xs).astype(np.int8)
        want_pre = np.asarray(jquant.int8_matmul_pre(jnp.asarray(xq), jnp.asarray(xs), jp, jnp.float32))
        got_pre = ql.matmul_pre(torch.from_numpy(xq), torch.from_numpy(xs), torch.float32).numpy()
        np.testing.assert_allclose(got_pre, want_pre, atol=1e-5 * np.abs(want_pre).max(), rtol=0)
    return ql, jp


@pytest.mark.parametrize("act_quant", [True, False], ids=["w8a8", "w8a16"])
def test_quant_linear_matches_jax_linear(act_quant):
    """QuantLinear against the int8 branches of the JAX `linear`, and the
    pre-quantized W8A8 product against `int8_matmul_pre`."""
    _check_quant_linear(act_quant, 64, 48)


@pytest.mark.parametrize("act_quant", [True, False], ids=["w8a8", "w8a16"])
def test_quant_linear_pads_widths_off_eight(act_quant):
    """Widths off a multiple of 8 (Qwen2.5-VL's vision MLP is 3420 wide): the
    weight is stored once with zero rows and columns up to (48, 64), the
    CUDA int8 GEMM's rule, and the products still match the JAX package."""
    ql, jp = _check_quant_linear(act_quant, 60, 42)
    assert ql.w_q.shape == (48, 64) and ql.in_features == 60 and ql.w_scale.shape == (42,)
    np.testing.assert_array_equal(ql.w_q[:42, :60].numpy().T, np.asarray(jp["w_q"]))
    assert not ql.w_q[42:].any() and not ql.w_q[:, 60:].any()
    assert "in=60, out=42" in repr(ql)


def _jax_serving(params, cfg, min_size, exclude):
    tree = jax.tree.map(jnp.asarray, params)
    tree = jfuse.permute_rope_layout(jfuse.fuse_single_block_io(jfuse.fuse_dit_qkv(tree)), cfg.head_dim)
    return jquant.quantize_dit_params(tree, min_size=min_size, act_quant_exclude=exclude)


def _port_serving(dit, min_size, exclude):
    permute_rope_layout(fuse_single_block_io(fuse_dit_qkv(dit)))
    return quant.quantize_dit_params(dit, min_size=min_size, act_quant_exclude=exclude)


def _assert_same_as_tree(dit, tree):
    """Every linear of the port model holds what its JAX node holds; returns
    the path sets by kind: W8A8, w8a16, NF4 in the plane or pair packing
    (codes and scales bitwise)."""
    modes = {"w8a8": set(), "w8a16": set(), "nf4_plane": set(), "nf4_pair": set()}
    tree = jax.tree.map(np.asarray, tree)
    for name, m in dit.named_modules():
        if not isinstance(m, (nn.Linear, quant.QuantLinear, quant.NF4Linear)):
            continue
        path, idx, _ = dit.jax_path(name)
        node = jax_bridge._node(tree, path, idx)
        if isinstance(m, nn.Linear):
            assert "w" in node, name
            np.testing.assert_array_equal(m.weight.detach().numpy().T, node["w"])
            continue
        if isinstance(m, quant.NF4Linear):
            key = "w_p4p" if m.layout == "plane" else "w_p4"
            assert key in node, name
            np.testing.assert_array_equal(m.w_packed.numpy(), node[key])
            np.testing.assert_array_equal(m.w_scale4.numpy(), node["w_scale4"])
            if m.bias is not None:
                np.testing.assert_array_equal(m.bias.detach().numpy(), node["b"])
            modes[f"nf4_{m.layout}"].add(path)
            continue
        assert "w_q" in node, name
        np.testing.assert_array_equal(m.w_q.numpy().T, node["w_q"])
        np.testing.assert_allclose(m.w_scale.numpy(), node["w_scale"].reshape(-1), rtol=1e-6)
        assert m.act_quant == ("act_q" in node), name
        if m.bias is not None:
            np.testing.assert_array_equal(m.bias.detach().numpy(), node["b"])
        modes["w8a8" if m.act_quant else "w8a16"].add(path)
    return modes


@pytest.mark.parametrize("min_size", [4096, 16384])
def test_serving_surgery_matches_jax(min_size):
    """fuse + permute + quantize in place, with act_quant_exclude=("_mod",):
    the same int8 weights and the same W8A8 / w8a16 sets as JAX. At 16384 the
    qkv panels (12288 per block) are quantized only because JAX counts the
    stacked blocks; the out projections (8192 stacked) stay float."""
    jcfg, params, dit = numpy_models()
    tree = _jax_serving(params, jcfg, min_size, ("_mod",))
    modes = _assert_same_as_tree(_port_serving(dit, min_size, ("_mod",)), tree)
    assert "double_blocks/attn/qkv" in modes["w8a8"] and "single_blocks/in_proj" in modes["w8a8"]
    assert {"double_blocks/img_mod", "double_blocks/txt_mod"} <= modes["w8a16"]
    assert "single_blocks/mod" in modes["w8a8"]  # "single_blocks/mod/w" holds no "_mod"
    small = min_size == 4096
    assert ("double_blocks/attn/out" in modes["w8a8"]) == ("final_mod" in modes["w8a16"]) == small
    assert dit.rope_layout == "split"
    # the norm scales are permuted as the JAX tree's
    a = dit.transformer_blocks[1].attn
    np.testing.assert_array_equal(a.norm_added_k.weight.detach().numpy(),
                                  np.asarray(tree["double_blocks"]["attn"]["txt_k_norm"]["scale"][1]))


def test_bridge_carries_the_serving_tree():
    """The JAX serving tree through `serving_dit_from_jax` is the model the
    port's own surgery makes from the same float weights."""
    jcfg, params, dit = numpy_models()
    tree = _jax_serving(params, jcfg, 4096, ("_mod",))
    carried = jax_bridge.serving_dit_from_jax(jax.tree.map(np.asarray, tree), dit.cfg)
    _assert_same_as_tree(carried, tree)
    own = _port_serving(dit, 4096, ("_mod",))
    for (n1, t1), (n2, t2) in zip(carried.state_dict().items(), own.state_dict().items()):
        assert n1 == n2
        torch.testing.assert_close(t1, t2, rtol=0, atol=0)
    assert [type(m) for m in carried.modules()] == [type(m) for m in own.modules()]


def test_surgery_guards_and_nf4_raise():
    """The layout guards hold, NF4 linears included; the NF4 surgery and the
    bridge's NF4 nodes, refused before, now make what JAX makes
    (`tests/test_torch_nf4.py` holds them bitwise)."""
    jcfg, params, dit = numpy_models()
    _port_serving(dit, 4096, ())
    quantized_unpermuted = quant.quantize_dit_params(numpy_models()[2], min_size=4096)
    with pytest.raises(ValueError, match="BEFORE quantization"):
        permute_rope_layout(quantized_unpermuted)
    with pytest.raises(ValueError, match="already"):
        permute_rope_layout(dit)
    nf4_unpermuted = quant.quantize_dit_params(numpy_models()[2], min_size=4096, int4_paths=("img_mlp",),
                                               int4_group=32)
    assert isinstance(nf4_unpermuted.transformer_blocks[0].ff.net[2], quant.NF4Linear)
    with pytest.raises(ValueError, match="BEFORE quantization"):
        permute_rope_layout(nf4_unpermuted)
    nf4 = jfuse.fuse_single_block_io(jfuse.fuse_dit_qkv(jax.tree.map(jnp.asarray, params)))
    nf4 = jquant.quantize_dit_params(nf4, min_size=4096, int4_paths=("img_mlp",), int4_group=32)
    carried = jax_bridge.serving_dit_from_jax(jax.tree.map(np.asarray, nf4), dit.cfg)
    modes = _assert_same_as_tree(carried, nf4)
    assert modes["nf4_pair"] == {"double_blocks/img_mlp/fc1", "double_blocks/img_mlp/fc2"}


def test_pipeline_quantize_rejects_nf4_profiles():
    """`FluxPipeline.quantize` takes JAX's NF4 knobs: its default int4=("t5",)
    and dit_int4_mlp make the layers JAX's `quantize` makes on the same
    weights; a model that is not there still raises. `fuse_qkv=False` (JAX's
    flag, which the port takes since quantized serving under tensor
    parallelism keeps the unfused layout) makes JAX's unfused tree."""
    from reflectionflow_tpu.sampler.pipeline import FluxPipeline as JaxFluxPipeline

    jcfg, params, dit = numpy_models(seed=1)
    t5cfg = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=256, num_layers=1, num_heads=4)
    t5_params = perturbed(t5_encoder_init(jax.random.PRNGKey(1), t5cfg), seed=3)
    t5 = T5Encoder(TT5Config(**{f: getattr(t5cfg, f) for f in t5cfg.__dataclass_fields__}))
    t5.load_state_dict(jax_bridge.t5_state_dict(t5_params, t5cfg))
    pipe = FluxPipeline(dit_cfg=dit.cfg, vae_cfg=None, t5_cfg=t5.cfg, clip_cfg=None, dit=dit, vae=None, t5=t5,
                        clip=None, t5_tokenizer=None, clip_tokenizer=None, dtype=torch.float32)
    with pytest.raises((TypeError, ValueError)):
        pipe.quantize(int4=("vae",))
    assert pipe.rope_layout == "pair"  # nothing changed before the refusal
    kw = dict(dit_int4_mlp=True, int4_group=64, min_size=4096)
    pipe.quantize(**kw)  # the JAX default int4=("t5",): NF4 T5
    jpipe = JaxFluxPipeline(dit_cfg=jcfg, vae_cfg=None, t5_cfg=t5cfg, clip_cfg=None, t5_tokenizer=None,
                            clip_tokenizer=None,
                            params=jax.tree.map(jnp.asarray, {"dit": params, "t5": t5_params}))
    jpipe.quantize(**kw)
    assert pipe.rope_layout == jpipe.rope_layout == "split"
    dit_modes = _assert_same_as_tree(pipe.dit, jpipe.params["dit"])
    assert dit_modes["nf4_pair"] and dit_modes["nf4_plane"]
    t5_modes = _assert_same_as_tree(pipe.t5, jpipe.params["t5"])
    assert t5_modes["nf4_plane"] == {"blocks/wo"} and t5_modes["w8a16"]

    _, _, unfused = numpy_models(seed=1)
    upipe = FluxPipeline(dit_cfg=unfused.cfg, vae_cfg=None, t5_cfg=t5.cfg, clip_cfg=None, dit=unfused, vae=None,
                         t5=None, clip=None, t5_tokenizer=None, clip_tokenizer=None, dtype=torch.float32)
    upipe.quantize(fuse_qkv=False, int4=(), **kw)
    jpipe = JaxFluxPipeline(dit_cfg=jcfg, vae_cfg=None, t5_cfg=t5cfg, clip_cfg=None, t5_tokenizer=None,
                            clip_tokenizer=None, params={"dit": jax.tree.map(jnp.asarray, params)})
    jpipe.quantize(fuse_qkv=False, int4=(), **kw)
    assert upipe.rope_layout == jpipe.rope_layout == "pair"
    unfused_modes = _assert_same_as_tree(upipe.dit, jpipe.params["dit"])
    assert unfused_modes["nf4_plane"] and unfused_modes["w8a8"]


@pytest.mark.parametrize("route", ["port_quantize", "bridge"])
def test_w8a16_t5_encode_matches_jax(route):
    """T5 in the w8a16 profile (weight_only=("t5",)): quantized by the port
    from shared float weights, or carried from the JAX int8 tree."""
    jcfg = T5Config.tiny()
    params = perturbed(t5_encoder_init(jax.random.PRNGKey(0), jcfg), seed=2)
    q_tree = jquant.quantize_dit_params(jax.tree.map(jnp.asarray, params), min_size=16, act_quant=False)
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jax_t5_encode(q_tree, jcfg, jnp.asarray(ids)))
    tcfg = TT5Config(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    if route == "bridge":
        t5 = jax_bridge.t5_from_jax(jax.tree.map(np.asarray, q_tree), tcfg)
    else:
        t5 = T5Encoder(tcfg)
        t5.load_state_dict(jax_bridge.t5_state_dict(params, jcfg))
        quant.quantize_dit_params(t5, min_size=16, act_quant=False)
    n_q = sum(isinstance(m, quant.QuantLinear) and not m.act_quant for m in t5.modules())
    assert n_q == 7 * jcfg.num_layers
    with torch.no_grad():
        got = t5_encode(t5, torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
