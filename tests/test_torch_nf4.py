"""NF4 (packed 4-bit, w4a16) weights of the PyTorch port against the JAX package.

Codes and scales are bit-identical to JAX's in both packings (pair and
plane), with the same fallbacks (plane to pair, pair to int8 w8a16); the
products agree within 1e-5 of the output scale in fp32. The DiT serving
surgery with `int4_paths` makes the same NF4 / int8 / float layers as JAX's
`quantize_dit_params`; the bridge carries JAX's NF4 nodes; an NF4 T5 encodes
within 1e-4 of JAX's; the co-residency profile (`quantize(dit_int4_mlp=True,
int4=("t5",))`) generates the same latents as JAX's profile at
`test_torch_serving_dit.py`'s fp32 bound (cosine >= 0.9999).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from reflectionflow_tpu.config import T5Config
from reflectionflow_tpu.models.flux.dit import flux_dit_apply
from reflectionflow_tpu.models.flux.dit import linear as jax_linear
from reflectionflow_tpu.models.flux.text import t5_encode as jax_t5_encode
from reflectionflow_tpu.models.flux.text import t5_encoder_init
from reflectionflow_tpu.ops import fuse as jfuse
from reflectionflow_tpu.ops import quant as jquant
from reflectionflow_tpu_torch.config import T5Config as TT5Config
from reflectionflow_tpu_torch.models.flux.text import T5Encoder, t5_encode
from reflectionflow_tpu_torch.ops import quant
from reflectionflow_tpu_torch.ops.fuse import fuse_dit_qkv, fuse_single_block_io, permute_rope_layout
from reflectionflow_tpu_torch.utils import jax_bridge

from test_torch_flux_dit import perturbed
from test_torch_quant import _assert_same_as_tree, _weight, numpy_models

torch.set_num_threads(1)
INT4_PATHS = ("img_mlp", "txt_mlp", "out_mlp", "mlp_in", "single_blocks/out/")


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("layout", ["pair", "plane"])
def test_codes_and_scales_match_jax(layout):
    rng = np.random.default_rng(0)
    w = _weight(rng, 128, 40)
    want = (jquant.quantize_linear_int4_plane if layout == "plane" else jquant.quantize_linear_int4)(
        {"w": jnp.asarray(w)}, group=32)
    fn = quant.quantize_linear_int4_plane if layout == "plane" else quant.quantize_linear_int4
    packed, scale = fn(torch.from_numpy(w.T.copy()), 32)
    key = "w_p4p" if layout == "plane" else "w_p4"
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["w_scale4"]))
    np.testing.assert_array_equal(quant._nf4_codes().numpy(), np.asarray(jquant._nf4_codes()))


@pytest.mark.parametrize("d_in,layout,kind", [(128, "plane", "w_p4p"), (96, "plane", "w_p4"),
                                              (48, "pair", "w_q"), (64, "pair", "w_p4")])
def test_nf4_linear_and_fallbacks_match_jax(d_in, layout, kind):
    """`nf4_linear` against the JAX quantizers at group 32: the packing (or
    the w8a16 fallback) JAX picks for that contraction, and the product of
    the JAX `linear` within 1e-5 of its scale."""
    rng = np.random.default_rng(1)
    w, b = _weight(rng, d_in, 40), rng.standard_normal(40).astype(np.float32)
    x = (rng.standard_normal((2, 5, d_in)) * 3).astype(np.float32)
    jfn = jquant.quantize_linear_int4_plane if layout == "plane" else jquant.quantize_linear_int4
    node = jfn({"w": jnp.asarray(w), "b": jnp.asarray(b)}, group=32)
    assert kind in node
    lin = nn.Linear(d_in, 40)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    m = quant.nf4_linear(lin, 32, layout)
    if kind == "w_q":
        assert isinstance(m, quant.QuantLinear) and not m.act_quant
    else:
        assert isinstance(m, quant.NF4Linear) and m.layout == ("plane" if kind == "w_p4p" else "pair")
        np.testing.assert_array_equal(m.w_packed.numpy(), np.asarray(node[kind]))
        assert m.in_features == d_in and f"in={d_in}, out=40" in repr(m)
    want = np.asarray(jax_linear(node, jnp.asarray(x)))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    if kind == "w_p4p":  # the raw products, both packings of the same codes
        pair = jquant.quantize_linear_int4({"w": jnp.asarray(w)}, group=32)
        np.testing.assert_allclose(
            quant.int4_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(pair["w_p4"])),
                              torch.from_numpy(np.asarray(pair["w_scale4"]))).numpy(),
            np.asarray(jquant.int4_matmul(jnp.asarray(x), pair["w_p4"], pair["w_scale4"])),
            atol=1e-5 * np.abs(want).max(), rtol=0)
        np.testing.assert_allclose(
            quant.int4_matmul_plane(torch.from_numpy(x), m.w_packed, m.w_scale4).numpy(),
            np.asarray(jquant.int4_matmul_plane(jnp.asarray(x), node["w_p4p"], node["w_scale4"])),
            atol=1e-5 * np.abs(want).max(), rtol=0)


def _jax_nf4_serving(params, cfg, group, min_size=4096):
    tree = jax.tree.map(jnp.asarray, params)
    tree = jfuse.permute_rope_layout(jfuse.fuse_single_block_io(jfuse.fuse_dit_qkv(tree)), cfg.head_dim)
    return jquant.quantize_dit_params(tree, min_size=min_size, int4_paths=INT4_PATHS, int4_group=group,
                                      int4_layout="plane")


def _port_nf4_serving(dit, group, min_size=4096):
    permute_rope_layout(fuse_single_block_io(fuse_dit_qkv(dit)))
    return quant.quantize_dit_params(dit, min_size=min_size, int4_paths=INT4_PATHS, int4_group=group,
                                     int4_layout="plane")


@pytest.mark.parametrize("group", [32, 64, 128])
def test_dit_nf4_layers_match_jax(group):
    """The co-residency surgery: the same NF4 (plane, pair), int8 and float
    layers as JAX's, codes and scales bitwise. Hidden 64, MLP 256: at group
    32 every MLP linear goes plane, at 64 fc1 (in 64) falls back to pair, at
    128 fc1 to int8 w8a16."""
    jcfg, params, dit = numpy_models()
    tree = _jax_nf4_serving(params, jcfg, group)
    modes = _assert_same_as_tree(_port_nf4_serving(dit, group), tree)
    fc1 = {32: "nf4_plane", 64: "nf4_pair", 128: "w8a16"}[group]
    assert "double_blocks/img_mlp/fc1" in modes[fc1] and "double_blocks/txt_mlp/fc1" in modes[fc1]
    assert {"double_blocks/img_mlp/fc2", "single_blocks/out_mlp"} <= modes["nf4_plane"]
    assert {"double_blocks/attn/qkv", "single_blocks/in_proj", "single_blocks/out_attn"} <= modes["w8a8"]


def test_bridge_carries_nf4_nodes():
    """JAX's NF4 serving tree through `serving_dit_from_jax` is the model the
    port's own surgery makes; its forward agrees with JAX's, whose "pallas"
    route sends NF4 MLPs down the unfused chain as the port does."""
    jcfg, params, dit = numpy_models(seed=2)
    tree = _jax_nf4_serving(params, jcfg, 32)
    carried = jax_bridge.serving_dit_from_jax(jax.tree.map(np.asarray, tree), dit.cfg)
    _assert_same_as_tree(carried, tree)
    own = _port_nf4_serving(dit, 32)
    for (n1, t1), (n2, t2) in zip(carried.state_dict().items(), own.state_dict().items()):
        assert n1 == n2
        torch.testing.assert_close(t1, t2, rtol=0, atol=0)
    assert [type(m) for m in carried.modules()] == [type(m) for m in own.modules()]

    from test_torch_serving_dit import _inputs
    x = _inputs(jcfg, lt=8, seed=4)
    g = np.asarray([3.5, 3.5], np.float32)
    want = flux_dit_apply(tree, jcfg, **{k: jnp.asarray(v) for k, v in x.items()}, guidance=jnp.asarray(g),
                          rope_layout="split", attn_impl="pallas_interpret")
    with torch.no_grad():
        got = own(**{k: torch.from_numpy(v) for k, v in x.items()}, guidance=torch.from_numpy(g),
                  attn_impl="pallas", rope_layout="split")
    assert _cos(got.numpy(), np.asarray(want)) >= 0.9999


@pytest.fixture(scope="module")
def t5_case():
    """The JAX NF4 T5 (group 16, plane) and its encode, once for both routes."""
    jcfg = T5Config.tiny()
    params = perturbed(t5_encoder_init(jax.random.PRNGKey(0), jcfg), seed=2)
    q_tree = jquant.quantize_params_int4(jax.tree.map(jnp.asarray, params), min_size=16, group=16,
                                         layout="plane")
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    return jcfg, params, q_tree, ids, np.asarray(jax_t5_encode(q_tree, jcfg, jnp.asarray(ids)))


@pytest.mark.parametrize("route", ["port_quantize", "bridge"])
def test_nf4_t5_encode_matches_jax(t5_case, route):
    """T5 with NF4 linears (`quantize_params_int4`, group 16: every linear
    packs, q/k/v/o/wi in the plane layout), from the port's quantizer or
    carried from JAX's tree."""
    jcfg, params, q_tree, ids, want = t5_case
    tcfg = TT5Config(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    if route == "bridge":
        t5 = jax_bridge.t5_from_jax(jax.tree.map(np.asarray, q_tree), tcfg)
    else:
        t5 = T5Encoder(tcfg)
        t5.load_state_dict(jax_bridge.t5_state_dict(params, jcfg))
        quant.quantize_params_int4(t5, min_size=16, group=16, layout="plane")
    assert sum(isinstance(m, quant.NF4Linear) and m.layout == "plane" for m in t5.modules()) == 7 * jcfg.num_layers
    with torch.no_grad():
        got = t5_encode(t5, torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_co_profile_generate_matches_jax():
    """`FluxPipeline.quantize(dit_int4_mlp=True, int4=("t5",), int4_group=32)`
    on both packages' pipelines holding the same seeded DiT and T5 (T5 at
    the DiT's text width; no VAE or CLIP: latents and pooled are injected):
    the same layer kinds in both models, the NF4 T5 encodes within 1e-4, and
    `generate` from those encodings ends on the same latents."""
    from reflectionflow_tpu.config import FluxVAEConfig
    from reflectionflow_tpu.sampler.pipeline import FluxPipeline as JaxFluxPipeline
    from reflectionflow_tpu.utils.hf_convert import convert_t5_state
    from reflectionflow_tpu_torch import config as tconfig
    from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline

    jcfg, params, dit = numpy_models(seed=3)
    t5_kw = dict(vocab_size=64, d_model=jcfg.text_dim, d_kv=8, d_ff=256, num_layers=2, num_heads=4)
    j5cfg, t5 = T5Config(**t5_kw), T5Encoder(TT5Config(**t5_kw))
    rng = np.random.default_rng(4)
    sd = {k: (rng.standard_normal(tuple(v.shape)) / (np.sqrt(v.shape[1]) if v.dim() == 2 else 10) + (v.dim() == 1))
          .astype(np.float32) for k, v in t5.state_dict().items()}
    t5.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    vae = FluxVAEConfig.tiny()
    jpipe = JaxFluxPipeline(dit_cfg=jcfg, vae_cfg=vae, t5_cfg=j5cfg, clip_cfg=None, t5_tokenizer=None,
                            clip_tokenizer=None, dtype=jnp.float32,
                            params={"dit": jax.tree.map(jnp.asarray, params),
                                    "t5": jax.tree.map(jnp.asarray, convert_t5_state(sd, j5cfg))})
    tpipe = FluxPipeline(dit_cfg=dit.cfg, vae_cfg=tconfig.FluxVAEConfig.tiny(), t5_cfg=t5.cfg, clip_cfg=None,
                         dit=dit, vae=None, t5=t5, clip=None, t5_tokenizer=None, clip_tokenizer=None,
                         dtype=torch.float32)
    kw = dict(dit_int4_mlp=True, int4=("t5",), int4_group=32, min_size=4096)
    jpipe.quantize(**kw)
    tpipe.quantize(**kw)
    modes = _assert_same_as_tree(tpipe.dit, jpipe.params["dit"])
    assert modes["nf4_plane"] and modes["w8a8"] and tpipe.rope_layout == jpipe.rope_layout == "split"
    t5_modes = _assert_same_as_tree(tpipe.t5, jpipe.params["t5"])
    assert t5_modes["nf4_plane"] and t5_modes["w8a16"]  # wo (in 256) packs; in 48 falls back to int8

    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    j_txt = jax_t5_encode(jpipe.params["t5"], j5cfg, jnp.asarray(ids))
    with torch.no_grad():
        t_txt = t5_encode(tpipe.t5, torch.from_numpy(ids).long())
    np.testing.assert_allclose(t_txt.numpy(), np.asarray(j_txt), atol=1e-4, rtol=1e-4)
    pooled = rng.standard_normal((2, jcfg.pooled_dim)).astype(np.float32)
    lat = rng.standard_normal((2, 64, jcfg.in_channels)).astype(np.float32)
    g_kw = dict(height=32, width=32, num_inference_steps=3, output_type="latent")
    want = jpipe.generate(["a", "b"], latents=jnp.asarray(lat), txt=j_txt, pooled=jnp.asarray(pooled), **g_kw)
    got = tpipe.generate(["a", "b"], latents=lat, txt=t_txt, pooled=torch.from_numpy(pooled), **g_kw)
    assert _cos(got.numpy(), np.asarray(want)) >= 0.9999


def test_nf4_dispatch_counts(monkeypatch):
    """Which linears K2–K5 feed in the NF4 serving DiT, counted through their
    plain versions on the CPU: NF4 MLPs take the unfused chain (no K3 before
    fc1, no K4), and so do the single blocks' out projections (no K5 before
    `out_attn`), as in JAX; `chip_smoke.nf4_counts`, which the card's phase 12
    holds its launch counts to, gives the same numbers."""
    from types import SimpleNamespace

    import chip_smoke
    from reflectionflow_tpu_torch.ops import fused_quant as fq
    from test_torch_serving_dit import _inputs

    calls = {n: 0 for n in ("norm_rope_ref", "adaln_quant_ref", "gelu_quant_ref", "rowquant_ref")}
    for name in calls:
        fn = getattr(fq, name)
        monkeypatch.setattr(fq, name, lambda *a, _n=name, _f=fn, **k: (calls.__setitem__(_n, calls[_n] + 1),
                                                                        _f(*a, **k))[1])
    jcfg, _, dit = numpy_models(seed=6)
    _port_nf4_serving(dit, 32)
    with torch.no_grad():
        dit(**{k: torch.from_numpy(v) for k, v in _inputs(jcfg, lt=8).items()}, guidance=torch.full((2,), 3.5),
            attn_impl="pallas", rope_layout="split")
    want = chip_smoke.nf4_counts(SimpleNamespace(dit_cfg=jcfg))
    assert calls == {"norm_rope_ref": want["norm_rope"], "adaln_quant_ref": want["adaln_quant"],
                     "gelu_quant_ref": 0, "rowquant_ref": want["rowquant"]}, calls


def test_co_preset_loads(tmp_path):
    """configs/flux.1_dev_qwenscore_v5e_co.json (dit_quant int8_int4mlp,
    t5_quant int4) loads through the port's `load_pipeline`."""
    from argparse import Namespace

    from reflectionflow_tpu_torch.cli.common import load_config, load_pipeline

    args = Namespace(pipeline_config_path="configs/flux.1_dev_qwenscore_v5e_co.json", output_dir=None,
                     synthetic_weights=True, attn_impl=None, quantize=None, phase_swap=False, act_quant_exclude=[],
                     device="cpu")
    cfg = load_config(args)
    assert (cfg.pipeline_args.dit_quant, cfg.pipeline_args.t5_quant) == ("int8_int4mlp", "int4")
    pipe = load_pipeline(cfg, args)
    assert pipe.rope_layout == "split" and pipe.attn_impl == "pallas" and pipe._embed_cache is not None
